"""The initial HPF state, drawn on the device from the seed.

The distributions of the hgaprec reference's HGAPRec::initialize()
(hgaprec.cc:153-204, gpbase.hh:292-340, 909-918), drawn with a
`torch.Generator` in a few large calls instead of the host:

  * xi [N] and eta [M]: shape = a' + 0.01 U, rate = b' + K;
  * theta [N, K] and beta [M, K]: shape = a + 0.01 U, rate = b + 0.1 U
    (one row, broadcast to every row), and expectations from fresh
    per-entry rates b + 0.1 U, which the reference draws apart;
  * the prior rates in effect: copies of the scales' expectations.

Both the program and the reference start from this state; neither draws
its own. Plain torch only.
"""

from __future__ import annotations

from typing import Dict

import torch

from hpfbench.refs.hpf import expectations


def hpf_initial_state(n: int, m: int, k: int, priors: Dict[str, float],
                      gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Leaf name -> float32 tensor on `device` (names as refs/hpf.py)."""
    p = priors

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=device,
                          dtype=torch.float32)

    st: Dict[str, torch.Tensor] = {}
    for name, rows, sp, rp in (("theta_rate", n, p["ap"], p["bp"]),
                               ("beta_rate", m, p["cp"], p["dp"])):
        shape = sp + 0.01 * uniform(rows)
        rate = torch.full((rows,), rp + k, device=device)
        e, elog = expectations(shape, rate)
        st.update({f"{name}.shape": shape, f"{name}.rate": rate,
                   f"{name}.e": e, f"{name}.elog": elog})
    for name, rows, sp, rp in (("beta", m, p["c"], p["d"]),
                               ("theta", n, p["a"], p["b"])):
        shape = sp + 0.01 * uniform(rows, k)
        rate = (rp + 0.1 * uniform(k)).expand(rows, k).contiguous()
        e, elog = expectations(shape, rp + 0.1 * uniform(rows, k))
        st.update({f"{name}.shape": shape, f"{name}.rate": rate,
                   f"{name}.e": e, f"{name}.elog": elog})
    for side, scale in (("theta", "theta_rate"), ("beta", "beta_rate")):
        st[f"{side}_prior_e"] = st[f"{scale}.e"].clone()
        st[f"{side}_prior_elog"] = st[f"{scale}.elog"].clone()
    return st
