"""The port's CAVI step under the CSR sweep (`segment-chunked`, "highest")
against the benchmark's plain float64 reference (`hpfbench/refs/hpf.py`),
on the CPU: at K = 300, past the sparse passes' 256-value narrow lanes,
and at K = 100, each under the limits of its benchmark cell.

A small seeded power-law COO (the EchoNest configurations' generator and
laws, counts 1-4) and the benchmark's seeded initial state; three steps,
each step's worst-leaf gap (`hpfbench/compare.py`) at or under the cell's
limit for that step."""

import pytest
import torch

from hgaprec_tpu_torch.models.step import _resolve_mode, cavi_step
from hpfbench import compare, data, manifest, program
from hpfbench.refs import hpf
from hpfbench.state_init import hpf_initial_state

USERS, ITEMS, NNZ = 400, 300, 4000
SEED = 2**31 + 26


@pytest.mark.parametrize("cell", ["echonest-hpf-k100.segment",
                                  "echonest-hpf-k300.segment"])
def test_segment_step_holds_to_the_reference(cell):
    bench = manifest.load()
    wl = manifest.workload(bench, cell)
    cfg = manifest.config(bench, wl["config"])
    # the catalog kept sparse, as the EchoNest counts keep it
    cfg = {**cfg, "users": USERS, "items": ITEMS, "nnz": NNZ,
           "layout": {**cfg["layout"],
                      "dense_limit_bytes": USERS * ITEMS - 1}}
    k, priors = cfg["k"], cfg["priors"]
    traffic = manifest.traffic(wl["traffic"])
    limits = manifest.limits(cell)
    gen = torch.Generator().manual_seed(SEED)
    coo = data.make_coo(cfg, gen, "cpu")
    assert coo.nnz == NNZ and set(coo.y.unique().tolist()) <= {1, 2, 3, 4}
    st0 = hpf_initial_state(coo.n, coo.m, k, priors, gen, "cpu")
    mcfg = program.model_config(cfg, traffic, coo.n, coo.m)
    dd, _, _ = program.layout(mcfg, coo.u.numpy(), coo.i.numpy(),
                              coo.y.numpy(), "cpu")
    assert _resolve_mode(mcfg, dd) == "segment-chunked"
    state = program.model_state({n: v.clone() for n, v in st0.items()})
    exact = {n: v.double() for n, v in st0.items()}
    for s in range(1, len(limits) + 1):
        cavi_step(state, dd, mcfg)
        exact = hpf.hpf_step(exact, coo.u, coo.i, coo.y, k, priors)
        gaps = compare.state_gaps(program.leaves(state), exact)
        name = compare.step_name(s)
        assert max(gaps.values()) <= limits[name], (name, gaps)
