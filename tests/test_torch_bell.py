"""The blocked-ELL SpMM of the PyTorch port (kernels/bell.py) against the
JAX package's Pallas kernel (``kernels.bell``) in interpret mode and
against SciPy.

On a CPU tensor ``spmm`` takes its plain PyTorch version, so these tests
pin that version, which chip_smoke.py then holds the CUDA kernel against
on the card. ``bell_from_scipy`` runs the same host code in both packages,
so its blocks and block columns must be equal to the bit. The SpMM cases
are tests/test_bell_kernel.py's (m = 16): float32 at rtol 1e-5 and atol
1e-4 (sums of up to 640 products in another order than the Pallas
kernel's), float64 at rtol 1e-12 and atol 1e-12 with a float64 output
(an accumulator narrowed to float32 would miss by ~1e-7). Inputs are made
with numpy from a seed and given to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from multigridcmt_tpu.kernels import bell as jbell
from multigridcmt_tpu_torch import convert
from multigridcmt_tpu_torch.kernels import bell
from multigridcmt_tpu_torch.ops import sparse


def _block_random(nbr, nbc, density, seed, n_r=None, n_c=None):
    """Random matrix whose nonzeros cluster into dense 128x128 blocks (as
    tests/test_bell_kernel.py makes them)."""
    rng = np.random.default_rng(seed)
    mask = rng.random((nbr, nbc)) < density
    mask[rng.integers(nbr), rng.integers(nbc)] = True
    dense = np.zeros((nbr * 128, nbc * 128), np.float32)
    for i, j in zip(*np.nonzero(mask)):
        dense[i * 128:(i + 1) * 128, j * 128:(j + 1) * 128] = (
            rng.standard_normal((128, 128)))
    return sp.csr_matrix(dense[:n_r or nbr * 128, :n_c or nbc * 128])


CASES = [
    (2, 2, 1.0, None, None),      # fully block-dense
    (4, 3, 0.4, None, None),      # rectangular, ragged block rows
    (3, 3, 0.3, 300, 310),        # logical shape not a block multiple
    (1, 5, 0.6, None, None),      # single block row
]


def _xt(a_sp, m, seed, dtype):
    """(Xt zero-padded to whole blocks, X) for m vectors."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((a_sp.shape[1], m)).astype(dtype)
    xt = np.zeros((m, -(-a_sp.shape[1] // 128) * 128), dtype)
    xt[:, :a_sp.shape[1]] = x.T
    return xt, x


@pytest.mark.parametrize("nbr,nbc,density,n_r,n_c", CASES)
def test_bell_from_scipy_matches_jax(nbr, nbc, density, n_r, n_c):
    a_sp = _block_random(nbr, nbc, density, nbr * 31 + nbc, n_r, n_c)
    a = bell.bell_from_scipy(a_sp, device="cpu")
    ja = jbell.bell_from_scipy(a_sp)
    assert a.shape == tuple(ja.shape) and a.nnz_scalar == ja.nnz_scalar
    assert (a.nbr, a.kmax, a.block_shape, a.n_stored) == (
        ja.nbr, ja.kmax, tuple(ja.block_shape), ja.n_stored)
    assert a.data.dtype == torch.float32 and a.cols.dtype == torch.int32
    np.testing.assert_array_equal(a.data.numpy(), np.asarray(ja.data))
    np.testing.assert_array_equal(a.cols.numpy(), np.asarray(ja.cols))
    c = convert.bell_from_jax(ja, device="cpu")
    assert torch.equal(c.data, a.data) and torch.equal(c.cols, a.cols)
    assert (c.shape, c.nnz_scalar) == (a.shape, a.nnz_scalar)


@pytest.mark.parametrize("nbr,nbc,density,n_r,n_c", CASES)
def test_spmm_matches_pallas(nbr, nbc, density, n_r, n_c):
    a_sp = _block_random(nbr, nbc, density, nbr * 31 + nbc, n_r, n_c)
    a, ja = bell.bell_from_scipy(a_sp, device="cpu"), jbell.bell_from_scipy(
        a_sp)
    xt, x = _xt(a_sp, 16, 7, np.float32)
    got = bell.spmm(a, torch.from_numpy(xt))
    want = np.asarray(jbell.spmm(ja, jnp.asarray(xt)))
    assert got.shape == want.shape == (16, a.nbr * 128)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got.numpy()[:, :a_sp.shape[0]],
                               (a_sp @ x).T, rtol=1e-5, atol=1e-4)
    # Output columns past the logical row count are zero.
    assert not got[:, a_sp.shape[0]:].any()
    assert bell.launches == 0


def test_spmm_float64_accumulates_at_float64():
    a_sp = _block_random(4, 3, 0.6, seed=17).astype(np.float64)
    a = bell.bell_from_scipy(a_sp, dtype=torch.float64, device="cpu")
    ja = jbell.bell_from_scipy(a_sp, dtype=jnp.float64)
    assert a.data.dtype == torch.float64
    xt, x = _xt(a_sp, 16, 23, np.float64)
    got = bell.spmm(a, torch.from_numpy(xt))
    assert got.dtype == torch.float64
    want = np.asarray(jbell.spmm(ja, jnp.asarray(xt)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got.numpy()[:, :a_sp.shape[0]], (a_sp @ x).T,
                               rtol=1e-12, atol=1e-12)


def test_spmv_carrier_matches_pallas():
    a_sp = _block_random(3, 4, 0.5, seed=11, n_r=333, n_c=420)
    a, ja = bell.bell_from_scipy(a_sp, device="cpu"), jbell.bell_from_scipy(
        a_sp)
    x = np.random.default_rng(3).standard_normal(420).astype(np.float32)
    got = bell.spmv(a, torch.from_numpy(x))
    assert got.shape == (333,)
    want = np.asarray(jbell.spmv(ja, jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), a_sp @ x, rtol=1e-5, atol=1e-4)


def test_explicit_kmax_padding():
    a_sp = _block_random(3, 3, 0.3, seed=5)
    tight = bell.bell_from_scipy(a_sp, device="cpu")
    padded = bell.bell_from_scipy(a_sp, kmax=tight.kmax + 3, device="cpu")
    jpadded = jbell.bell_from_scipy(a_sp, kmax=tight.kmax + 3)
    np.testing.assert_array_equal(padded.cols.numpy(),
                                  np.asarray(jpadded.cols))
    # Padding blocks sit at block column 0 and are zero.
    assert not padded.data[:, tight.kmax:].any()
    assert not padded.cols[:, tight.kmax:].any()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (8, a_sp.shape[1])).astype(np.float32))
    np.testing.assert_allclose(bell.spmm(tight, x).numpy(),
                               bell.spmm(padded, x).numpy(), rtol=1e-6,
                               atol=1e-6)


def test_kmax_too_small_raises():
    a_sp = _block_random(2, 4, 1.0, seed=9)
    with pytest.raises(ValueError, match="kmax"):
        bell.bell_from_scipy(a_sp, kmax=1, device="cpu")


@pytest.mark.parametrize("m", [4, 12])
def test_m_not_a_multiple_of_8_raises(m):
    a = bell.bell_from_scipy(_block_random(2, 2, 1.0, seed=2), device="cpu")
    with pytest.raises(ValueError, match="multiple of 8"):
        bell.spmm(a, torch.zeros((m, 256)))


def test_laplacian_roundtrip():
    """The framework's own 2D operator through the general-sparse path."""
    n, h = 30, 1.0 / 31
    a_sp = sparse.csr_to_scipy(sparse.laplacian_csr(n, 2, h, torch.float32,
                                                    device="cpu"))
    a = bell.bell_from_scipy(a_sp, device="cpu")
    x = np.random.default_rng(2).standard_normal(n * n).astype(np.float32)
    got = bell.spmv(a, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), a_sp @ x, rtol=1e-4,
                               atol=1e-2 / h)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jbell.spmv(jbell.bell_from_scipy(a_sp),
                                           jnp.asarray(x))),
        rtol=1e-5, atol=1e-4 / h)
