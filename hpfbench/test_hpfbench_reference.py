"""The plain reference at a tiny size against a step worked out by hand
in plain Python, and its TF32 rounding."""

import math

import pytest
import torch

from hpfbench.refs import hpf

PRIORS = {"a": 0.3, "b": 0.3, "c": 0.3, "d": 0.3,
          "ap": 0.3, "bp": 0.3, "cp": 0.3, "dp": 0.3}


def digamma(x):
    r = 0.0
    while x < 20.0:
        r -= 1.0 / x
        x += 1.0
    f = 1.0 / (x * x)
    return r + math.log(x) - 0.5 / x - f * (1 / 12 - f * (1 / 120 - f / 252))


def hand_step(st, nonzeros, k, p):
    """One vb_hier iteration with Python floats and loops."""
    n, m = len(st["xi_e"]), len(st["eta_e"])
    A = [[math.exp(v) for v in row] for row in st["theta_elog"]]
    B = [[math.exp(v) for v in row] for row in st["beta_elog"]]
    acc_a = [[0.0] * k for _ in range(n)]
    acc_b = [[0.0] * k for _ in range(m)]
    for u, i, y in nonzeros:
        terms = [A[u][j] * B[i][j] for j in range(k)]
        s = sum(terms)
        for j in range(k):
            acc_a[u][j] += y * terms[j] / s
            acc_b[i][j] += y * terms[j] / s
    beta_colsum = [sum(st["beta_e"][i][j] for i in range(m))
                   for j in range(k)]
    out = {}
    th_shape = [[p["a"] + acc_a[u][j] for j in range(k)] for u in range(n)]
    th_rate = [[st["xi_e"][u] + beta_colsum[j] for j in range(k)]
               for u in range(n)]
    th_e = [[th_shape[u][j] / th_rate[u][j] for j in range(k)]
            for u in range(n)]
    out["theta.shape"], out["theta.rate"], out["theta.e"] = \
        th_shape, th_rate, th_e
    out["theta.elog"] = [[digamma(th_shape[u][j]) - math.log(th_rate[u][j])
                          for j in range(k)] for u in range(n)]
    theta_colsum = [sum(th_e[u][j] for u in range(n)) for j in range(k)]
    be_shape = [[p["c"] + acc_b[i][j] for j in range(k)] for i in range(m)]
    be_rate = [[st["eta_e"][i] + theta_colsum[j] for j in range(k)]
               for i in range(m)]
    be_e = [[be_shape[i][j] / be_rate[i][j] for j in range(k)]
            for i in range(m)]
    out["beta.shape"], out["beta.rate"], out["beta.e"] = \
        be_shape, be_rate, be_e
    xi_rate = [p["bp"] + sum(th_e[u]) for u in range(n)]
    eta_rate = [p["dp"] + sum(be_e[i]) for i in range(m)]
    out["theta_rate.rate"], out["beta_rate.rate"] = xi_rate, eta_rate
    xi_shape = p["ap"] + k * p["ap"]
    out["theta_rate.e"] = [xi_shape / r for r in xi_rate]
    out["theta_rate.elog"] = [digamma(xi_shape) - math.log(r)
                              for r in xi_rate]
    out["theta_prior_e"] = list(st["xi_e"])
    return out


def test_step_against_hand_worked():
    k = 2
    st_py = {"theta_elog": [[-1.2, 0.3], [0.1, -0.4]],
             "beta_elog": [[0.5, -2.0], [-0.7, 0.2], [0.0, 0.0]],
             "beta_e": [[1.5, 0.2], [0.6, 1.1], [0.9, 0.9]],
             "xi_e": [0.8, 1.3], "eta_e": [0.4, 2.2, 0.7]}
    nonzeros = [(0, 0, 2.0), (0, 1, 1.0), (1, 1, 3.0), (1, 2, 4.0)]
    want = hand_step(st_py, nonzeros, k, PRIORS)

    t = lambda x: torch.tensor(x, dtype=torch.float64)  # noqa: E731
    st = {"theta.elog": t(st_py["theta_elog"]),
          "beta.elog": t(st_py["beta_elog"]), "beta.e": t(st_py["beta_e"]),
          "theta_rate.e": t(st_py["xi_e"]),
          "theta_rate.elog": t([0.0, 0.0]),
          "beta_rate.e": t(st_py["eta_e"]),
          "beta_rate.elog": t([0.0, 0.0, 0.0])}
    u = torch.tensor([z[0] for z in nonzeros], dtype=torch.int32)
    i = torch.tensor([z[1] for z in nonzeros], dtype=torch.int32)
    y = torch.tensor([z[2] for z in nonzeros], dtype=torch.float32)
    got = hpf.hpf_step(st, u, i, y, k, PRIORS, chunk=3)
    for name, w in want.items():
        assert torch.allclose(got[name], t(w), rtol=1e-12, atol=1e-12), name
    assert set(got) == set(hpf.LEAVES)
    # the step leaves its input alone
    assert torch.equal(st["beta.e"], t(st_py["beta_e"]))


def test_tf32_rounding():
    one = 1.0
    ulp = 2.0 ** -10                      # TF32's unit in the last place
    x = torch.tensor([one + ulp / 2,      # a tie: to even, down
                      one + 3 * ulp / 2,  # a tie: to even, up
                      one + ulp / 4,      # below half: down
                      one + 3 * ulp / 4,  # above half: up
                      -(one + 3 * ulp / 4), 0.0], dtype=torch.float32)
    want = [one, one + 2 * ulp, one, one + ulp, -(one + ulp), 0.0]
    assert hpf.to_tf32(x).tolist() == want


def test_fp8_rounding():
    # one row: scaled by 2**-3 so that its largest, 3000, is within 448;
    # E4M3 keeps 3 explicit mantissa bits (ties to even), normals from
    # 2**-6 and subnormals in steps of 2**-9, here times 2**3
    x = torch.tensor([[3000.0, 1.0 + 2.0 ** -4, 1.0 + 3 * 2.0 ** -4,
                       1.0 + 2.0 ** -3, 2.0 ** -10, -9.5]])
    want = [[3072.0, 1.0, 1.25, 1.125, 0.0, -10.0]]
    assert hpf.to_fp8(x).tolist() == want
    # rows are scaled apart: a small row keeps its own bits
    y = torch.tensor([[1e-3, 1.1e-3], [5.0, 300.0]])
    assert torch.allclose(hpf.to_fp8(y), y, rtol=2.0 ** -4)
    assert hpf.BELOW == {"highest": "tf32", "default": "fp8"}


@pytest.mark.parametrize("low", [None, "tf32", "fp8"])
def test_chunks_do_not_change_the_sums(low):
    gen = torch.Generator().manual_seed(0)
    a = torch.rand((30, 4), generator=gen) + 0.1
    b = torch.rand((20, 4), generator=gen) + 0.1
    u = torch.sort(torch.randint(0, 30, (200,), generator=gen))[0].int()
    i = torch.randint(0, 20, (200,), generator=gen).int()
    y = torch.randint(1, 5, (200,), generator=gen).float()
    whole = hpf.sweep(a.double(), b.double(), u, i, y, low, chunk=1 << 20)
    parts = hpf.sweep(a.double(), b.double(), u, i, y, low, chunk=7)
    for x, z in zip(whole, parts):
        assert torch.allclose(x, z, rtol=1e-12)
