"""The PyTorch port's plain tier (multigridcmt_tpu_torch.ops, grids, config,
convert) against the JAX package on the same float64 inputs, made with
numpy from a seed. Tolerance: rtol 1e-12 and atol 1e-12 * max|ref| (the two
packages evaluate the same formulas; only rounding may differ, and the
atol covers entries that cancel to near zero)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigridcmt_tpu import grids as jgrids
from multigridcmt_tpu.config import SolverConfig as JaxConfig
from multigridcmt_tpu.ops import laplacian as jlap
from multigridcmt_tpu.ops import smoothers as jsm
from multigridcmt_tpu.ops import transfer as jtr
from multigridcmt_tpu_torch import convert, grids
from multigridcmt_tpu_torch.config import SolverConfig
from multigridcmt_tpu_torch.ops import laplacian, smoothers, transfer

RTOL = 1e-12


def _padded(rng, n, ndim):
    a = np.zeros((n + 2,) * ndim)
    a[(slice(1, -1),) * ndim] = rng.standard_normal((n,) * ndim)
    return a


def _inputs(n, ndim, seed, k=2):
    rng = np.random.default_rng(seed)
    return [_padded(rng, n, ndim) for _ in range(k)]


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


CASES = [(ndim, n) for ndim in (1, 2) for n in (7, 63)] + [(3, 7)]


@pytest.mark.parametrize("ndim,n", CASES)
@pytest.mark.parametrize("sigma", [0.0, 11.5])
def test_residual_and_apply_match_jax(ndim, n, sigma):
    u, b = _inputs(n, ndim, seed=n + ndim)
    h = 1.0 / (n + 1)
    _close(laplacian.residual(torch.from_numpy(u), torch.from_numpy(b), h,
                              sigma=sigma),
           jlap.residual(jnp.asarray(u), jnp.asarray(b), h, sigma=sigma))
    _close(laplacian.apply_poisson(torch.from_numpy(u), h, sigma=sigma),
           jlap.apply_poisson(jnp.asarray(u), h, sigma=sigma))


@pytest.mark.parametrize("ndim,n", CASES)
@pytest.mark.parametrize("sigma", [0.0, 11.5])
def test_smoothers_match_jax(ndim, n, sigma):
    u, b = _inputs(n, ndim, seed=10 * n + ndim)
    h = 1.0 / (n + 1)
    tu, tb = torch.from_numpy(u), torch.from_numpy(b)
    ju, jb = jnp.asarray(u), jnp.asarray(b)
    omega = SolverConfig(ndim=ndim).effective_omega()
    _close(smoothers.rbgs(tu, tb, h, sigma=sigma),
           jsm.rbgs(ju, jb, h, sigma=sigma))
    _close(smoothers.rbgs_half_sweep(tu, tb, h, parity=1, row_offset=1,
                                     sigma=sigma),
           jsm.rbgs_half_sweep(ju, jb, h, parity=1, row_offset=1,
                               sigma=sigma))
    _close(smoothers.jacobi(tu, tb, h, omega, sigma=sigma),
           jsm.jacobi(ju, jb, h, omega, sigma=sigma))
    for kind in ("rbgs", "jacobi"):
        _close(smoothers.smooth(tu, tb, h, kind=kind, omega=omega, sweeps=3,
                                sigma=sigma),
               jsm.smooth(ju, jb, h, kind=kind, omega=omega, sweeps=3,
                          sigma=sigma))


@pytest.mark.parametrize("ndim,n", CASES)
def test_transfers_match_jax(ndim, n):
    (r,) = _inputs(n, ndim, seed=n * ndim, k=1)
    nc = (n - 1) // 2
    (e,) = _inputs(nc, ndim, seed=n * ndim + 1, k=1)
    got_r = transfer.restrict(torch.from_numpy(r))
    got_p = transfer.prolong(torch.from_numpy(e))
    _close(got_r, jtr.restrict(jnp.asarray(r)))
    _close(got_p, jtr.prolong(jnp.asarray(e)))
    # The CUDA kernels take contiguous grids, and the transfers feed them.
    assert got_r.is_contiguous() and got_p.is_contiguous()


def test_dense_operator_and_eigenvalues_match_jax():
    for ndim in (1, 2, 3):
        np.testing.assert_array_equal(laplacian.dense_operator(5, ndim, 0.1),
                                      jlap.dense_operator(5, ndim, 0.1))
        assert laplacian.diag_value(ndim, 0.1, 2.0) == jlap.diag_value(
            ndim, 0.1, 2.0)
    h = 1.0 / 64
    assert laplacian.eigenvalue_1d(3, 63, h) == jlap.eigenvalue_1d(3, 63, h)
    assert laplacian.eigenvalue_2d(1, 2, 63, h) == jlap.eigenvalue_2d(
        1, 2, 63, h)
    assert laplacian.eigenvalue_3d(1, 2, 3, 63, h) == jlap.eigenvalue_3d(
        1, 2, 3, 63, h)


@pytest.mark.parametrize("ndim,k", [(1, 8), (2, 6), (3, 4)])
def test_hierarchy_from_jax_equals_build_hierarchy(ndim, k):
    jcfg = JaxConfig(ndim=ndim, k=k, dtype=jnp.float64, smoother="rbgs")
    cfg = convert.config_from_jax(jcfg)
    assert cfg.dtype == torch.float64 and cfg.ndim == ndim and cfg.k == k
    assert cfg.level_sizes() == jcfg.level_sizes()
    mine = grids.build_hierarchy(cfg, device="cpu")
    theirs = convert.hierarchy_from_jax(jgrids.build_hierarchy(jcfg),
                                        device="cpu")
    assert mine.levels == theirs.levels
    assert mine.ndim == theirs.ndim
    for a, b in ((mine.coarse_inv, theirs.coarse_inv),
                 (mine.coarse_dense, theirs.coarse_dense)):
        assert a.dtype == b.dtype == torch.float64
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_config_from_jax_maps_every_field():
    jcfg = JaxConfig(ndim=2, k=5, dtype=jnp.float32, nu1=1, nu2=3,
                     smoother="jacobi", omega=0.7, cycle="w", tol=1e-6,
                     max_iters=7, use_pallas=True, agglom_rows=8,
                     precond_dtype=jnp.bfloat16, fmg_prolong="cubic")
    cfg = convert.config_from_jax(jcfg)
    assert cfg.dtype == torch.float32
    assert cfg.precond_dtype == torch.bfloat16
    assert cfg.use_kernels is True
    same = {f.name for f in dataclasses.fields(SolverConfig)} - {
        "dtype", "precond_dtype", "use_kernels"}
    for name in same:
        assert getattr(cfg, name) == getattr(jcfg, name), name
    assert (cfg.n, cfg.h, cfg.effective_omega()) == (
        jcfg.n, jcfg.h, jcfg.effective_omega())


def test_config_validation():
    for bad in ({"ndim": 4}, {"k": 1}, {"smoother": "sor"}, {"cycle": "f"},
                {"fmg_prolong": "quintic"}):
        with pytest.raises(ValueError):
            SolverConfig(**bad)
    with pytest.raises(TypeError):
        SolverConfig(dtype=np.float32)
