"""The f32 route's split products, on the CPU.

The f32 route's wgmma kernel (`dense_split_kernel` of
`hgaprec_tpu_torch/csrc/dense_wgmma.cu`) multiplies three bf16 pieces of
each f32 factor (`ops/dense_fused.py::split_pieces`) in six bf16 products.
Here the construction is pinned without a card:

  * the pieces reconstruct x within 2^-27 |x| over the factors' range;
  * the six products of two split values, summed in f64, are within
    2^-20 relative of the f64 product (an f32 sum of K = 100 terms may
    carry up to 6.0e-6);
  * an f64 emulation of the whole split sweep (S from the six products,
    W = Y / max(S, 1e-30) in f32 and split again, the contraction from
    six more) is within the f32 bound tests/test_dense_pallas.py pins
    (rtol=2e-4, atol=1e-5) of the port's plain version and of the JAX
    fused kernel in f32 (`hgaprec_tpu.ops.dense_pallas.fused_dense_sweep`,
    the interpreter), at two small shapes, with and without bias.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hgaprec_tpu.ops.dense_pallas import fused_dense_sweep as j_fused
from hgaprec_tpu_torch.ops import dense_fused as df

F32 = dict(rtol=2e-4, atol=1e-5)
# the kernel's six (X or W piece, Z piece) pairs, 0-based, in its order
PAIRS = [(1, 1), (2, 0), (0, 2), (1, 0), (0, 1), (0, 0)]


def _values(seed, shape):
    """Positive f32 values over the factors' range (exp of Elog: 1e-12 to
    1e12 and more), log-uniform."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        (10.0 ** rng.uniform(-15, 15, shape)).astype(np.float32))


def test_pieces_reconstruct_within_2_pow_27():
    x = _values(0, (4096,))
    pieces = df.split_pieces(x)
    assert pieces.dtype == torch.bfloat16 and pieces.shape == (3, 4096)
    x64 = x.double()
    rel = ((pieces.double().sum(0) - x64).abs() / x64).max().item()
    assert rel <= 2.0 ** -27
    # each piece is the rounding of what the ones before it left
    assert torch.equal(pieces[0], x.to(torch.bfloat16))
    rest = x - pieces[0].float()
    assert torch.equal(pieces[1], rest.to(torch.bfloat16))
    # the packed rows' constant columns split exactly
    ones = df.split_pieces(torch.ones(3))
    assert ones[0].float().eq(1).all() and not ones[1:].float().any()


def test_six_products_within_2_pow_20():
    x, z = _values(1, (8192,)), _values(2, (8192,))
    px, pz = (df.split_pieces(v).double() for v in (x, z))
    six = sum(px[i] * pz[j] for i, j in PAIRS)
    exact = x.double() * z.double()
    assert ((six - exact).abs() / exact).max().item() <= 2.0 ** -20
    # the terms left out, (2, 3), (3, 2) and (3, 3) 1-based, are tiny
    rest = px[1] * pz[2] + px[2] * pz[1] + px[2] * pz[2]
    assert (rest / exact).max().item() <= 2.0 ** -24


def _split_sweep_f64(a_lin, b_lin, y, ba_lin=None, bb_lin=None):
    """The split kernel's function emulated in f64: both roles' S from the
    six products of the packed factors' pieces, S and W rounded to f32 where
    the kernel holds them, W split, and the contractions from six products
    each, summed exactly."""
    k = a_lin.shape[1]
    a, b = df._pack(a_lin, b_lin, ba_lin, bb_lin)
    pa, pb = (df.split_pieces(x).double() for x in (a, b))
    yf = y[:a.shape[0], :b.shape[0]].float()
    out = []
    for px, pz, yy in ((pa, pb, yf), (pb, pa, yf.T)):
        s = sum(px[i] @ pz[j].T for i, j in PAIRS).float()
        w = yy / torch.clamp_min(s, 1e-30)
        pw = df.split_pieces(w).double()
        out.append(sum(pw[i] @ pz[j] for i, j in PAIRS).float())
    return df._unpack(out[0], out[1], k, ba_lin is not None)


@pytest.mark.parametrize("n,m,k", [(40, 30, 3), (70, 33, 100)])
@pytest.mark.parametrize("bias", [False, True])
def test_split_sweep_matches_plain_and_jax(n, m, k, bias):
    rng = np.random.default_rng(n + k + bias)
    shapes = [(n, k), (m, k)] + ([(n,), (m,)] if bias else [])
    lin = [np.exp(rng.normal(size=s) * 0.3).astype(np.float32)
           for s in shapes]
    y = ((rng.random((n, m)) < 0.3) * rng.integers(1, 6, (n, m))).astype(
        np.uint8)
    t_lin = [torch.from_numpy(x) for x in lin]
    t_y = torch.from_numpy(y)
    got = _split_sweep_f64(*t_lin[:2], t_y, *t_lin[2:])
    plain = df.fused_dense_sweep_reference(*t_lin[:2], t_y, *t_lin[2:])
    jax_out = j_fused(*[jnp.asarray(x) for x in lin[:2]], jnp.asarray(y),
                      *[jnp.asarray(x) for x in lin[2:]], bf16=False,
                      tile_u=8, tile_c=16, interpret=True)
    assert len(got) == len(plain) == len(jax_out) == (4 if bias else 2)
    for g, p, j in zip(got, plain, jax_out):
        torch.testing.assert_close(g, p, **F32)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), **F32)
