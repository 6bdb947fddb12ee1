"""The banded DIA SpMV of the PyTorch port (kernels/spmv.py) against the JAX
package's Pallas kernel (``kernels.spmv``) in interpret mode.

On a CPU tensor ``spmv_packed`` takes its plain PyTorch version, so these
tests pin that version, which chip_smoke.py then holds the CUDA kernel
against on the card. The packing is the JAX package's layout, so the
packed arrays are compared like with like: the packing must be equal to
the bit. The SpMV cases are JAX's own (1D n = 1023, 4097; 2D n = 31, 63,
100), a 2D n = 300 (R = 704 rows, more than one 512-row Pallas tile) and 3D
n = 15 and 20, in float64 at rtol 1e-12 (atol 1e-12 of the largest value:
both sum d_k x_k in offsets order; the Pallas kernel rotates lanes), and
one float32 case at JAX's tolerance (rtol 1e-5, atol 1e-4 / h). Inputs are
made with numpy from a seed and given to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigridcmt_tpu.kernels import spmv as jspmv
from multigridcmt_tpu.ops import sparse as jsparse
from multigridcmt_tpu_torch import convert
from multigridcmt_tpu_torch.kernels import spmv
from multigridcmt_tpu_torch.ops import sparse

CASES = [(1023, 1), (4097, 1), (31, 2), (63, 2), (100, 2), (300, 2),
         (15, 3), (20, 3)]


def _both(n, ndim, dtype=torch.float64):
    h = 1.0 / (n + 1)
    jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
    return (sparse.laplacian_dia(n, ndim, h, dtype, device="cpu"),
            jsparse.laplacian_dia(n, ndim, h, jdtype), h)


def _x(size, seed, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal(size).astype(dtype)


@pytest.mark.parametrize("n,ndim", CASES)
def test_packing_matches_jax(n, ndim):
    a, ja, _ = _both(n, ndim)
    pk, jpk = spmv.pack_dia(a), jspmv.pack_dia(ja)
    assert pk.offsets == jpk.offsets and pk.n == jpk.n
    assert pk.halo == jpk.halo and pk.nnz == jpk.nnz
    np.testing.assert_array_equal(pk.diags.numpy(), np.asarray(jpk.diags))
    assert pk.offset_tensor.dtype == torch.int64
    assert pk.offset_tensor.tolist() == list(pk.offsets)
    x = _x(a.shape[0], seed=n)
    xp = spmv.pack_x(torch.from_numpy(x), pk.halo)
    jxp = np.asarray(jspmv.pack_x(jnp.asarray(x), jpk.halo))
    np.testing.assert_array_equal(xp.numpy(), jxp)
    np.testing.assert_array_equal(
        spmv.unpack_y(xp, pk.n, pk.halo).numpy(), x)
    # The converter carries JAX's packed matrix across unchanged.
    cpk = convert.packed_dia_from_jax(jpk, device="cpu")
    assert cpk.offsets == pk.offsets and cpk.n == pk.n
    assert torch.equal(cpk.diags, pk.diags)
    assert torch.equal(cpk.offset_tensor, pk.offset_tensor)


@pytest.mark.parametrize("n,ndim", CASES)
def test_spmv_packed_matches_pallas(n, ndim):
    a, ja, _ = _both(n, ndim)
    pk, jpk = spmv.pack_dia(a), jspmv.pack_dia(ja)
    x = _x(a.shape[0], seed=100 + n)
    xp = spmv.pack_x(torch.from_numpy(x), pk.halo)
    got = spmv.spmv_packed(pk, xp)
    want = np.asarray(jspmv.spmv_packed(jpk, jspmv.pack_x(jnp.asarray(x),
                                                         jpk.halo)))
    assert got.shape == want.shape and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    assert torch.equal(spmv.spmv_packed_plain(pk, xp), got)
    # The (N,) entry point packs, applies and unpacks.
    np.testing.assert_allclose(
        spmv.spmv_dia(a, torch.from_numpy(x)).numpy(),
        np.asarray(jsparse.spmv_dia(ja, jnp.asarray(x))), rtol=1e-12,
        atol=1e-12 * np.abs(want).max())
    assert spmv.launches == 0


def test_spmv_float32_matches_pallas():
    n, ndim = 63, 2
    a, ja, h = _both(n, ndim, torch.float32)
    x = _x(a.shape[0], seed=7, dtype=np.float32)
    got = spmv.spmv_dia(a, torch.from_numpy(x))
    assert got.dtype == torch.float32
    want = np.asarray(jspmv.spmv_dia(ja, jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4 / h)


@pytest.mark.parametrize("n,ndim", [(63, 2), (100, 2), (15, 3)])
def test_spmv_packed_chains(n, ndim):
    """y = A(A x) without leaving the packed layout equals two JAX Pallas
    applies; the skirts and the rows past N stay zero."""
    a, ja, _ = _both(n, ndim)
    pk, jpk = spmv.pack_dia(a), jspmv.pack_dia(ja)
    x = _x(a.shape[0], seed=3)
    y2 = spmv.spmv_packed(pk, spmv.spmv_packed(pk, spmv.pack_x(
        torch.from_numpy(x), pk.halo)))
    jxp = jspmv.pack_x(jnp.asarray(x), jpk.halo)
    want = np.asarray(jspmv.spmv_packed(jpk, jspmv.spmv_packed(jpk, jxp)))
    np.testing.assert_allclose(y2.numpy(), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    flat = y2.reshape(-1)
    base = pk.halo * spmv.LANES
    assert not flat[:base].any()                    # top skirt
    assert not flat[base + pk.n:].any()             # rows >= N, bottom skirt
    assert bool(torch.isfinite(flat).all())


def test_rows_past_n_are_zero_because_the_packing_pads_zeros():
    """The kernel has no masks: rows i >= N come out 0 only because
    pack_dia zero-pads the diagonals past N. A diagonal with values there
    would leak them into y."""
    n = 100                                          # N = 100, R*128 = 1024
    a, _, _ = _both(n, 1)
    pk = spmv.pack_dia(a)
    flat = pk.diags.reshape(len(pk.offsets), -1)
    assert not flat[:, n:].any()
    xp = spmv.pack_x(torch.ones(n, dtype=torch.float64), pk.halo)
    xp.reshape(-1)[pk.halo * spmv.LANES + n:] = 1.0   # garbage past N
    y = spmv.spmv_packed(pk, xp).reshape(-1)[pk.halo * spmv.LANES:]
    assert not y[n:].any()
    leaky = spmv.PackedDIA(diags=torch.ones_like(pk.diags),
                           offsets=pk.offsets, n=pk.n)
    y = spmv.spmv_packed(leaky, xp).reshape(-1)[pk.halo * spmv.LANES:]
    assert y[n: pk.diags.shape[1] * spmv.LANES].abs().min() > 0


def test_pack_roundtrip():
    x = torch.from_numpy(_x(1000, seed=1))
    for halo in (8, 16):
        xp = spmv.pack_x(x, halo)
        assert xp.shape == (2 * halo + spmv.rows_for(1000), spmv.LANES)
        assert torch.equal(spmv.unpack_y(xp, 1000, halo), x)
    assert spmv.rows_for(1000) == 8 and spmv.halo_rows((-1, 0, 1)) == 8
    assert spmv.halo_rows((-4095, 4095)) == 32      # 4095 // 128 + 1 -> 32
