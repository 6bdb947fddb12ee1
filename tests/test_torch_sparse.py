"""The sparse formats of the PyTorch port (ops/sparse.py) against the JAX
package's ``ops.sparse`` and against SciPy.

Assembly is NumPy on the host in both packages, so the arrays must be
equal, index dtypes included. The SpMVs are plain PyTorch here and XLA in
JAX; both sum in another order than SciPy, so they are held to rtol 1e-12
(float64). The transfer matrices and Galerkin operators come from the same
SciPy products in both packages and are held to 1e-13. Sizes are JAX's own
test sizes (n = 31 in 1D, 15 in 2D, 7 in 3D). Inputs are made with numpy
from a seed and given to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import multigridcmt_tpu as jmg
import multigridcmt_tpu_torch as mt
from multigridcmt_tpu.ops import sparse as jsparse
from multigridcmt_tpu_torch import convert
from multigridcmt_tpu_torch.ops import sparse

from reference_impl import laplacian_matrix

SIZES = [(1, 31), (2, 15), (3, 7)]
JAX_DTYPE = {torch.float64: jnp.float64, torch.float32: jnp.float32}


def _reference(n, ndim, h):
    """SciPy's operator: reference_impl's in 1D/2D; in 3D the Kronecker sum
    of reference_impl's 1D operator."""
    if ndim < 3:
        return laplacian_matrix(n, ndim, h)
    t = laplacian_matrix(n, 1, h)
    eye = sp.identity(n, format="csr")
    return (sp.kron(sp.kron(t, eye), eye) + sp.kron(sp.kron(eye, t), eye)
            + sp.kron(sp.kron(eye, eye), t)).tocsr()


def _equal(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.device.type == "cpu"
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


def _rand(n, seed):
    return np.random.default_rng(seed).standard_normal(n)


@pytest.mark.parametrize("fmt", ["coo", "csr", "dia"])
@pytest.mark.parametrize("ndim,n", SIZES)
def test_laplacian_assembly_matches_jax(fmt, ndim, n):
    h = 1.0 / (n + 1)
    got = getattr(sparse, f"laplacian_{fmt}")(n, ndim, h, torch.float64,
                                              device="cpu")
    want = getattr(jsparse, f"laplacian_{fmt}")(n, ndim, h, jnp.float64)
    assert got.shape == tuple(want.shape)
    if fmt == "coo":
        for f in ("data", "row", "col"):
            _equal(getattr(got, f), getattr(want, f))
    elif fmt == "csr":
        for f in ("data", "indices", "indptr", "row_ids"):
            _equal(getattr(got, f), getattr(want, f))
        assert (sparse.csr_to_scipy(got) != _reference(n, ndim, h)).nnz == 0
    else:
        assert got.offsets == want.offsets
        assert all(type(o) is int for o in got.offsets)
        _equal(got.diags, want.diags)
        # nnz bookkeeping is SciPy's count.
        assert got.nnz == want.nnz == _reference(n, ndim, h).nnz


@pytest.mark.parametrize("kind", ["csr", "coo", "dia"])
@pytest.mark.parametrize("ndim,n", SIZES)
def test_spmv_matches_jax(kind, ndim, n):
    h = 1.0 / (n + 1)
    x = _rand(n ** ndim, seed=10 * ndim + n)
    a = getattr(sparse, f"laplacian_{kind}")(n, ndim, h, torch.float64,
                                             device="cpu")
    ja = getattr(jsparse, f"laplacian_{kind}")(n, ndim, h, jnp.float64)
    fn = {"csr": "spmv", "coo": "spmv_coo", "dia": "spmv_dia"}[kind]
    got = getattr(sparse, fn)(a, torch.from_numpy(x))
    want = np.asarray(getattr(jsparse, fn)(ja, jnp.asarray(x)))
    assert got.dtype == torch.float64 and got.shape == (n ** ndim,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    np.testing.assert_allclose(got.numpy(), _reference(n, ndim, h) @ x,
                               rtol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_assembly_rounds_to_dtype_as_jax(dtype):
    """Values are rounded once from float64, as jnp.asarray rounds them."""
    n, h = 15, 1.0 / 7.0          # 1/h^2 not exact in float32
    for fmt in ("coo", "csr", "dia"):
        got = getattr(sparse, f"laplacian_{fmt}")(n, 2, h, dtype,
                                                  device="cpu")
        want = getattr(jsparse, f"laplacian_{fmt}")(n, 2, h,
                                                    JAX_DTYPE[dtype])
        field = "diags" if fmt == "dia" else "data"
        _equal(getattr(got, field), getattr(want, field))


def test_coo_to_csr_roundtrip():
    n, h = 15, 1.0 / 16
    coo = sparse.laplacian_coo(n, 2, h, torch.float64, device="cpu")
    # Shuffle the triplets: coo_to_csr sorts them again.
    perm = torch.from_numpy(np.random.default_rng(4).permutation(coo.nnz))
    shuffled = sparse.COO(data=coo.data[perm], row=coo.row[perm],
                          col=coo.col[perm], shape=coo.shape)
    csr = sparse.coo_to_csr(shuffled)
    want = jsparse.coo_to_csr(jsparse.laplacian_coo(n, 2, h, jnp.float64))
    for f in ("data", "indices", "indptr", "row_ids"):
        _equal(getattr(csr, f), getattr(want, f))
    assert (sparse.csr_to_scipy(csr) != laplacian_matrix(n, 2, h)).nnz == 0


@pytest.mark.parametrize("ndim,n", SIZES)
def test_scipy_roundtrip(ndim, n):
    h = 1.0 / (n + 1)
    a = sparse.laplacian_csr(n, ndim, h, torch.float64, device="cpu")
    back = sparse.scipy_to_csr(sparse.csr_to_scipy(a), torch.float64,
                               device="cpu")
    for f in ("data", "indices", "indptr", "row_ids"):
        assert torch.equal(getattr(back, f), getattr(a, f))
    # Duplicates are summed and the triplets sorted, as in JAX.
    rng = np.random.default_rng(5)
    row, col = rng.integers(0, 9, 40), rng.integers(0, 7, 40)
    m = sp.coo_matrix((rng.standard_normal(40), (row, col)), shape=(9, 7))
    got = sparse.scipy_to_csr(m, torch.float64, device="cpu")
    want = jsparse.scipy_to_csr(m, jnp.float64)
    for f in ("data", "indices", "indptr", "row_ids"):
        _equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("ndim", [1, 2])
def test_transfer_matrices_match_jax(ndim):
    nc = 7
    for name in ("prolongation_csr", "restriction_csr"):
        got = getattr(sparse, name)(nc, ndim, torch.float64, device="cpu")
        want = getattr(jsparse, name)(nc, ndim, jnp.float64)
        assert got.shape == tuple(want.shape)
        for f in ("indices", "indptr", "row_ids"):
            _equal(getattr(got, f), getattr(want, f))
        np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                                   rtol=0, atol=1e-13)
    p = sparse.csr_to_scipy(sparse.prolongation_csr(nc, ndim, torch.float64,
                                                    device="cpu")).toarray()
    r = sparse.csr_to_scipy(sparse.restriction_csr(nc, ndim, torch.float64,
                                                   device="cpu")).toarray()
    np.testing.assert_allclose(p, 2.0 ** ndim * r.T, atol=1e-14)


def test_galerkin_1d_exact():
    """R A_f P is the re-discretised tridiagonal on the coarse grid."""
    nc, nf = 31, 63
    hf = 1.0 / (nf + 1)
    af = sparse.laplacian_csr(nf, 1, hf, torch.float64, device="cpu")
    ac = sparse.galerkin_coarse(af, nc, 1)
    want = sparse.laplacian_csr(nc, 1, 2 * hf, torch.float64, device="cpu")
    np.testing.assert_allclose(sparse.csr_to_scipy(ac).toarray(),
                               sparse.csr_to_scipy(want).toarray(),
                               atol=1e-9)
    jac = jsparse.galerkin_coarse(
        jsparse.laplacian_csr(nf, 1, hf, jnp.float64), nc, 1)
    np.testing.assert_allclose(ac.data.numpy(), np.asarray(jac.data),
                               rtol=1e-13)


@pytest.mark.parametrize("drop_tol", [0.0, 1.0])
def test_galerkin_2d_matches_jax(drop_tol):
    nc, nf = 15, 31
    hf = 1.0 / (nf + 1)
    ac = sparse.galerkin_coarse(
        sparse.laplacian_csr(nf, 2, hf, torch.float64, device="cpu"), nc, 2,
        drop_tol=drop_tol)
    jac = jsparse.galerkin_coarse(
        jsparse.laplacian_csr(nf, 2, hf, jnp.float64), nc, 2,
        drop_tol=drop_tol)
    for f in ("indices", "indptr", "row_ids"):
        _equal(getattr(ac, f), getattr(jac, f))
    np.testing.assert_allclose(ac.data.numpy(), np.asarray(jac.data),
                               rtol=1e-13)
    v = _rand(nc * nc, seed=6)
    np.testing.assert_allclose(
        sparse.spmv(ac, torch.from_numpy(v)).numpy(),
        np.asarray(jsparse.spmv(jac, jnp.asarray(v))), rtol=1e-12,
        atol=1e-12 * np.abs(np.asarray(jac.data)).max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ndim,k", [(1, 5), (2, 4), (3, 3)])
def test_as_csr_as_coo_match_jax(ndim, k, dtype):
    prob = mt.poisson(k=k, ndim=ndim, dtype=dtype, device="cpu")
    solver = mt.MultigridSolver(prob)
    jsolver = jmg.MultigridSolver(jmg.poisson(k=k, ndim=ndim,
                                              dtype=JAX_DTYPE[dtype]))
    csr, jcsr = solver.as_csr(), jsolver.as_csr()
    coo, jcoo = solver.as_coo(), jsolver.as_coo()
    assert csr.shape == tuple(jcsr.shape) and coo.shape == tuple(jcoo.shape)
    # The converters carry JAX's matrices across unchanged.
    ccsr = convert.csr_from_jax(jcsr, device="cpu")
    ccoo = convert.coo_from_jax(jcoo, device="cpu")
    for f in ("data", "indices", "indptr", "row_ids"):
        _equal(getattr(csr, f), getattr(jcsr, f))
        assert torch.equal(getattr(ccsr, f), getattr(csr, f))
    for f in ("data", "row", "col"):
        _equal(getattr(coo, f), getattr(jcoo, f))
        assert torch.equal(getattr(ccoo, f), getattr(coo, f))


def test_dia_from_jax_and_nnz():
    n, h = 15, 1.0 / 16
    ja = jsparse.laplacian_dia(n, 2, h, jnp.float64)
    a = convert.dia_from_jax(ja, device="cpu")
    assert a.offsets == ja.offsets and a.shape == tuple(ja.shape)
    _equal(a.diags, ja.diags)
    # 5 n^2 - 4 n structural nonzeros in 2D.
    assert a.nnz == 5 * n * n - 4 * n
