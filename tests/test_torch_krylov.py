"""MG-preconditioned CG of the PyTorch port (solvers/krylov.py) against the
JAX package's solve_pcg on the same problems, mirroring
tests/test_krylov.py, with the SciPy direct solve as the oracle in 1D and
2D.

Inputs are float64. Pass conditions: equal iteration counts; residual
histories at rtol 1e-9 down to the float64 rounding floor of the residual
(~1e-14 of ||b||, hence atol 1e-13, as in test_torch_solve.py), since the
two packages round the same recurrence in other orders; iterates at rtol
1e-10; and the SciPy solution at rtol 1e-7 and atol 1e-9, as in
tests/test_krylov.py (the solve stops at tol = 1e-10 of ||b||). The Pallas
kernels of the kernel routes run in interpret mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import scipy.sparse.linalg
import torch

import multigridcmt_tpu as jmg
import multigridcmt_tpu_torch as mt
from multigridcmt_tpu import kernels as jkernels
from multigridcmt_tpu.config import SolverConfig as JConfig
from multigridcmt_tpu.solvers import krylov as jkrylov
from multigridcmt_tpu_torch import convert, kernels
from multigridcmt_tpu_torch.grids import interior, pad_interior
from multigridcmt_tpu_torch.kernels import packed2d, stencil2d, stencil3d
from multigridcmt_tpu_torch.solvers import krylov


def _scipy_solution(prob):
    c = prob.config
    n, h = c.n, c.h
    lap1 = scipy.sparse.diags([-1.0, 2.0, -1.0], [-1, 0, 1],
                              shape=(n, n)) / (h * h)
    b = interior(prob.b).numpy()
    if c.ndim == 1:
        return scipy.sparse.linalg.spsolve(lap1.tocsr(), b)
    eye = scipy.sparse.identity(n)
    a = (scipy.sparse.kron(lap1, eye) + scipy.sparse.kron(eye, lap1)).tocsr()
    return scipy.sparse.linalg.spsolve(a, b.reshape(-1)).reshape(n, n)


def _both(jprob, x0=None):
    """(JAX result, port problem, port result) of solve_pcg from x0."""
    want = jmg.solve_pcg(jprob.hierarchy, jprob.b, jprob.config,
                         x0=None if x0 is None else jnp.asarray(x0))
    prob = convert.problem_from_jax(jprob, device="cpu")
    got = krylov.solve_pcg(prob.hierarchy, prob.b, prob.config,
                           x0=None if x0 is None else torch.from_numpy(x0))
    return want, prob, got


def _agree(got, want):
    iters = int(want.iters)
    assert got.iters == iters and got.converged == bool(want.converged)
    np.testing.assert_allclose(got.res_history.numpy(),
                               np.asarray(want.res_history),
                               rtol=1e-9, atol=1e-13)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x),
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("ndim,k,smoother", [
    (1, 9, "jacobi"),
    (2, 5, "jacobi"),
    (2, 6, "rbgs"),
])
def test_pcg_plain_route_matches_jax_and_scipy(ndim, k, smoother):
    jprob = jmg.poisson(k=k, ndim=ndim, dtype=jnp.float64, smoother=smoother,
                        tol=1e-10)
    want, prob, got = _both(jprob)
    _agree(got, want)
    assert got.converged
    np.testing.assert_allclose(interior(got.x).numpy(),
                               _scipy_solution(prob), rtol=1e-7, atol=1e-9)
    hist = got.res_history.numpy()
    assert np.isclose(hist[0], 1.0)            # x0 = 0: r0 = b
    np.testing.assert_array_equal(hist[got.iters:], hist[got.iters])


def test_pcg_nonzero_initial_guess():
    jprob = jmg.poisson2d(k=5, dtype=jnp.float64, tol=1e-9)
    rng = np.random.default_rng(0)
    x0 = np.zeros((33, 33))
    x0[1:-1, 1:-1] = rng.standard_normal((31, 31))
    want, prob, got = _both(jprob, x0=x0)
    _agree(got, want)
    np.testing.assert_allclose(interior(got.x).numpy(),
                               _scipy_solution(prob), rtol=1e-7, atol=1e-9)


def _spy(monkeypatch, mod, name, calls):
    def spy(u, *a, _f=getattr(mod, name), **kw):
        calls.append(a[1])                     # the level's n
        return _f(u, *a, **kw)
    monkeypatch.setattr(mod, name, spy)


def test_pcg_packed_tier_matches_jax(monkeypatch):
    """k=6 with PACK_MIN_N lowered in both packages, as
    test_torch_packed.py does: the 63 level is packed, so CG's operator
    apply and first residual run packed2d.residual (1 + iters calls) and
    each preconditioning cycle the packed legs; 31 runs fused2d."""
    monkeypatch.setattr(jkernels, "PALLAS_MIN_N", 20)
    monkeypatch.setattr(jkernels, "PACK_MIN_N", 40)
    monkeypatch.setattr(kernels, "KERNEL_MIN_N", 20)
    monkeypatch.setattr(kernels, "PACK_MIN_N", 40)
    jprob = jmg.poisson2d(k=6, dtype=jnp.float64, smoother="rbgs", tol=1e-9,
                          use_pallas=True)
    residual, legs, other = [], [], []
    _spy(monkeypatch, packed2d, "residual", residual)
    _spy(monkeypatch, packed2d, "smooth_residual_restrict", legs)
    _spy(monkeypatch, packed2d, "residual_norm_sq", other)
    _spy(monkeypatch, stencil2d, "residual", other)
    want, _, got = _both(jprob)
    _agree(got, want)
    assert residual == [63] * (1 + got.iters)
    assert legs == [63] * (1 + got.iters)
    assert other == []


def test_pcg_3d_kernel_route_matches_jax(monkeypatch):
    """3D k=4 RB-GS with the kernel threshold lowered in both packages:
    the 15 level runs stencil3d, whose residual CG calls 1 + iters times
    on the fine level (and each cycle once more there)."""
    monkeypatch.setattr(jkernels, "PALLAS3_MIN_N", 10)
    monkeypatch.setattr(kernels, "KERNEL3_MIN_N", 10)
    jprob = jmg.poisson3d(k=4, dtype=jnp.float64, smoother="rbgs", tol=1e-9,
                          use_pallas=True)
    residual, sweeps = [], []
    _spy(monkeypatch, stencil3d, "residual", residual)
    _spy(monkeypatch, stencil3d, "rbgs_sweep", sweeps)
    want, _, got = _both(jprob)
    _agree(got, want)
    assert residual == [15] * (1 + got.iters + (1 + got.iters))
    assert sweeps == [15] * (2 * (1 + got.iters))


def test_method_dispatch():
    prob = mt.poisson1d(k=8, dtype=torch.float64, tol=1e-9, device="cpu")
    solver = mt.MultigridSolver(prob)
    res = solver.solve(method="pcg")
    stat = solver.solve()
    assert res.converged and res.iters <= stat.iters
    want = krylov.solve_pcg(prob.hierarchy, prob.b, prob.config)
    assert res.iters == want.iters and torch.equal(res.x, want.x)
    x0 = pad_interior(torch.ones(prob.config.n, dtype=torch.float64))
    assert torch.equal(solver.solve(x0=x0, method="pcg").x,
                       krylov.solve_pcg(prob.hierarchy, prob.b, prob.config,
                                        x0=x0).x)
    with pytest.raises(ValueError):
        solver.solve(method="gmres")


# (ndim, k, smoother, use_kernels, precond_dtype): each route of JAX's
# mixed_cycle_dtype, which casts on the packed 2D tier and on 3D RB-GS on
# the kernel tier while the plane ring fits its VMEM budget (k <= 10).
MIXED_CASES = [
    (2, 12, "rbgs", True, "bfloat16"),
    (2, 12, "rbgs", True, None),
    (2, 12, "rbgs", True, "float32"),
    (2, 12, "rbgs", False, "bfloat16"),
    (2, 11, "rbgs", True, "bfloat16"),
    (3, 9, "rbgs", True, "bfloat16"),
    (3, 10, "rbgs", True, "bfloat16"),
    (3, 11, "rbgs", True, "bfloat16"),
    (3, 9, "jacobi", True, "bfloat16"),
    (3, 6, "rbgs", True, "bfloat16"),
    (3, 9, "rbgs", True, "float16"),
    (1, 12, "jacobi", True, "bfloat16"),
]


@pytest.mark.parametrize("ndim,k,smoother,use_kernels,pd", MIXED_CASES)
def test_mixed_cycle_dtype_raises_where_jax_casts(ndim, k, smoother,
                                                  use_kernels, pd):
    """Where JAX casts a cycle (the packed 2D tier, 3D RB-GS on its kernel
    tier) the port casts it to the same dtype, or raises naming the dtype
    where its kernels do not store it (float16); elsewhere both return
    None."""
    jcfg = JConfig(ndim=ndim, k=k, dtype=jnp.float32, smoother=smoother,
                   use_pallas=use_kernels,
                   precond_dtype=None if pd is None else jnp.dtype(pd))
    cfg = convert.config_from_jax(jcfg)
    want = jkrylov.mixed_cycle_dtype(jcfg)
    if want is None:
        assert krylov.mixed_cycle_dtype(cfg) is None
    elif pd == "float16":
        with pytest.raises(NotImplementedError, match="float16"):
            krylov.mixed_cycle_dtype(cfg)
    else:
        assert krylov.mixed_cycle_dtype(cfg) == getattr(
            torch, jnp.dtype(want).name)
