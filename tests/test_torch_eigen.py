"""The port's eigensolvers (solvers/eigen.py: block inverse iteration, RQI,
LOBPCG; MultigridSolver.eigensolve) on the CPU in float64, against the JAX
package: each run starts from JAX's own start block (``v0``), so both
iterate from the same vectors, and is held to JAX's eigenvalues (rtol
1e-10), iteration count, residual history (rtol 1e-6, atol 1e-12) and
eigenvectors (up to sign, or by subspace for a block); the SciPy eigsh
oracle; the kernel route with the thresholds lowered; the cumulative
divergence guard; and mixed precision still raising."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multigridcmt_tpu as jmg
import multigridcmt_tpu_torch as mt
import reference_impl as ref
from multigridcmt_tpu.solvers import eigen as jeigen
from multigridcmt_tpu_torch import convert, kernels
from multigridcmt_tpu_torch.kernels import fused2d, packed2d, stencil2d
from multigridcmt_tpu_torch.ops import laplacian
from multigridcmt_tpu_torch.solvers import cycles, eigen


def _flat(v):
    v = np.asarray(v)
    core = v[(slice(None),) + (slice(1, -1),) * (v.ndim - 1)]
    return core.reshape(core.shape[0], -1)


def _same_vectors(got, want, atol):
    """Each row equal up to sign (k = 1), or the rows spanning the same
    subspace: the projection of each onto the other's span loses nothing
    (the Ritz rotation inside a degenerate pair is the LAPACK build's)."""
    g, w = _flat(got), _flat(want)
    if g.shape[0] == 1:
        sign = np.sign(np.vdot(g[0], w[0]))
        np.testing.assert_allclose(sign * g[0], w[0], rtol=0, atol=atol)
        return
    qg, _ = np.linalg.qr(g.T)
    qw, _ = np.linalg.qr(w.T)
    s = np.linalg.svd(qg.T @ qw, compute_uv=False)
    np.testing.assert_allclose(s, np.ones_like(s), rtol=0, atol=atol)


def _jax_problem(ndim, kgrid, **kw):
    return jmg.poisson(kgrid, ndim=ndim, dtype=jnp.float64, **kw)


@pytest.mark.parametrize("ndim,kgrid,k", [(1, 7, 2), (2, 5, 1), (2, 5, 3),
                                          (3, 4, 1), (3, 4, 4)])
def test_coarse_init_matches_jax(ndim, kgrid, k):
    """The nested-iteration start block: the coarsest level's eigenvectors
    prolonged up, per vector up to sign at k=1, by subspace otherwise
    (eigh's signs and its basis of a degenerate eigenspace are LAPACK's;
    each k ends on a whole eigenspace: 2D lambda(1,2) = lambda(2,1), 3D the
    threefold lambda(1,1,2))."""
    jprob = _jax_problem(ndim, kgrid)
    prob = convert.problem_from_jax(jprob, device="cpu")
    want = np.asarray(jeigen.coarse_init(jprob.hierarchy, k, jnp.float64))
    got = eigen.coarse_init(prob.hierarchy, k, torch.float64).numpy()
    assert got.shape == want.shape
    if k == 1:
        # The prolonged vector's norm is the prolongation's, not 1.
        scale = np.abs(want).max()
        _same_vectors(got / scale, want / scale, atol=1e-12)
    else:
        _same_vectors(got, want, atol=1e-12)


# (ndim, grid k, block k, method, max_iters); rqi with k=3 at 2D k=5 is the
# divergence stop: its residual oscillates by 10x and the cumulative guard
# ends it unconverged, in JAX as in the port.
EIGEN_CASES = [
    (2, 5, 1, "ii", 100), (2, 5, 3, "ii", 200),
    (2, 5, 1, "rqi", 100), (2, 5, 3, "rqi", 100),
    (2, 5, 1, "lobpcg", 100), (2, 5, 3, "lobpcg", 100),
    (1, 7, 2, "ii", 100), (1, 7, 2, "lobpcg", 100),
    (3, 4, 1, "rqi", 100), (3, 4, 1, "lobpcg", 100),
]


@pytest.mark.parametrize("ndim,kgrid,k,method,max_iters", EIGEN_CASES,
                         ids=[f"{d}d-k{g}-block{k}-{m}"
                              for d, g, k, m, _ in EIGEN_CASES])
def test_eigensolve_matches_jax(ndim, kgrid, k, method, max_iters):
    """The port from JAX's start block against JAX's solve from its own:
    iteration counts equal, eigenvalues rtol 1e-10, histories rtol 1e-6
    (atol 1e-12), eigenvectors up to sign or by subspace."""
    smoother = "jacobi" if ndim == 1 else "rbgs"
    jprob = _jax_problem(ndim, kgrid, smoother=smoother)
    want = jmg.MultigridSolver(jprob).eigensolve(
        k=k, method=method, tol=1e-9, max_iters=max_iters)
    v0 = np.array(jeigen.coarse_init(jprob.hierarchy, k, jnp.float64))
    prob = convert.problem_from_jax(jprob, device="cpu")
    got = mt.MultigridSolver(prob).eigensolve(
        k=k, method=method, tol=1e-9, max_iters=max_iters,
        v0=torch.from_numpy(v0))
    assert isinstance(got, eigen.EigenResult)
    assert got.iters == int(want.iters)
    assert got.converged == bool(want.converged)
    np.testing.assert_allclose(got.eigenvalues.numpy(),
                               np.asarray(want.eigenvalues), rtol=1e-10)
    assert got.res_history.shape == (max_iters + 1,)
    np.testing.assert_allclose(got.res_history.numpy(),
                               np.asarray(want.res_history), rtol=1e-6,
                               atol=1e-12)
    if got.converged:
        _same_vectors(got.eigenvectors.numpy(),
                      np.asarray(want.eigenvectors), atol=1e-7)
    # Ghosts stay zero.
    ghosts = got.eigenvectors.clone()
    ghosts[(slice(None),) + (slice(1, -1),) * ndim] = 0
    assert not ghosts.any()


def test_rqi_divergence_stop():
    """The cumulative guard: RQI with a block of 3 at 2D k=5 oscillates by
    more than DIVERGE_FACTOR four times (never twice in a row) and stops
    unconverged after EIGEN_DIVERGE_TOTAL growths, well before max_iters."""
    prob = mt.poisson2d(k=5, dtype=torch.float64, smoother="rbgs",
                        device="cpu")
    res = mt.MultigridSolver(prob).eigensolve(k=3, method="rqi", tol=1e-9,
                                              max_iters=100)
    hist = res.res_history[: res.iters + 1].tolist()
    growths = sum(b > cycles.DIVERGE_FACTOR * a for a, b in zip(hist,
                                                               hist[1:]))
    assert not res.converged and res.iters < 100
    assert growths == cycles.EIGEN_DIVERGE_TOTAL
    assert torch.all(res.res_history[res.iters:] == hist[-1])


def test_eigen_guard_counts_cumulatively():
    div = 0
    for new, old in ((11.0, 1.0), (1.0, 11.0), (10.0, 1.0), (200.0, 10.0)):
        div = cycles.eigen_guard(new, old, div)
    assert div == 2 and cycles.EIGEN_DIVERGE_TOTAL == 4


def test_ii_loop_stops_on_the_guard():
    """ii_loop with injected primitives whose residual grows tenfold every
    other step stops after EIGEN_DIVERGE_TOTAL growths."""
    seq = iter([1.0, 20.0, 2.0, 40.0, 4.0, 80.0, 8.0, 160.0, 1.0, 1.0])

    def rayleigh(v):
        return torch.ones(1, dtype=torch.float64), torch.tensor(
            next(seq), dtype=torch.float64)

    v, lam, iters, hist, res = eigen.ii_loop(
        torch.zeros(1, 3), rayleigh=rayleigh,
        inner_solve=lambda v, s: v, ritz=lambda w: (w, None), method="ii",
        tol=1e-9, max_iters=20)
    assert iters == 7 and res == 160.0
    assert hist.shape == (21,) and torch.all(hist[7:] == 160.0)


def test_rqi_shifts_are_python_floats(monkeypatch):
    """RQI's shifts reach the cycles as Python floats: lam * RQI_BACKOFF
    while RQI_POLISH_TOL < res < RQI_ACTIVE_TOL, else 0.0 (the unshifted
    route)."""
    seen = []
    orig = cycles.v_cycle

    def spy(*a, sigma=0.0, **kw):
        if kw.get("level", 0) == 0:
            seen.append(sigma)
        return orig(*a, sigma=sigma, **kw)

    monkeypatch.setattr(cycles, "v_cycle", spy)
    prob = mt.poisson2d(k=5, dtype=torch.float64, smoother="rbgs",
                        device="cpu")
    res = mt.MultigridSolver(prob).eigensolve(k=1, method="rqi", tol=1e-9)
    assert res.converged
    assert all(type(s) is float for s in seen)
    shifted = [s for s in seen if s != 0.0]
    lam = res.eigenvalues.item()
    assert shifted and all(abs(s / eigen.RQI_BACKOFF - lam) < 1e-2 * lam
                           for s in shifted)
    assert seen[0] == 0.0 and seen[-1] == 0.0


def test_eigenvalue_matches_eigsh():
    prob = mt.poisson2d(k=5, dtype=torch.float64, device="cpu")
    res = mt.MultigridSolver(prob).eigensolve(k=1, tol=1e-9)
    want = ref.eigsh_oracle(prob.config.n, 2, prob.config.h, k=1)
    np.testing.assert_allclose(res.eigenvalues.numpy(), want, rtol=1e-7)


def test_lobpcg_k3_exact_spectrum():
    """LOBPCG resolves the degenerate pair lambda(1,2) = lambda(2,1), in
    ascending order, with orthonormal eigenvectors."""
    prob = mt.poisson2d(k=5, dtype=torch.float64, smoother="rbgs",
                        device="cpu")
    res = mt.MultigridSolver(prob).eigensolve(k=3, method="lobpcg",
                                              tol=1e-9)
    n, h = prob.config.n, prob.config.h
    want = sorted(laplacian.eigenvalue_2d(a, b, n, h)
                  for a, b in ((1, 1), (1, 2), (2, 1)))
    assert res.converged
    np.testing.assert_allclose(res.eigenvalues.numpy(), want, rtol=1e-8)
    v = _flat(res.eigenvectors.numpy())
    np.testing.assert_allclose(v @ v.T, np.eye(3), atol=1e-9)


@pytest.mark.parametrize("method", ["ii", "rqi", "lobpcg"])
@pytest.mark.parametrize("pack_min_n", [3000, 40],
                         ids=["unpacked", "packed"])
def test_kernel_route_matches_plain(method, pack_min_n, monkeypatch):
    """2D k=6 with KERNEL_MIN_N lowered to 20 (63 and 31 on the kernel tier;
    with PACK_MIN_N 40, 63 packed): the inner cycles run the fused legs (or
    the packed ones) and the inner check the residual wrapper of the fine
    level's tier; the eigenvalues equal the plain route's (rtol 1e-10) and
    JAX's, in as many steps."""
    monkeypatch.setattr(kernels, "KERNEL_MIN_N", 20)
    monkeypatch.setattr(kernels, "PACK_MIN_N", pack_min_n)
    calls = {"legs": 0, "residual": 0}
    legs = (packed2d if pack_min_n <= 63 else fused2d,
            "smooth_residual_restrict")
    res_mod = packed2d if pack_min_n <= 63 else stencil2d
    for (mod, name), key in ((legs, "legs"), ((res_mod, "residual"),
                                               "residual")):
        def spy(*a, _f=getattr(mod, name), _k=key, **kw):
            calls[_k] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(mod, name, spy)
    jprob = _jax_problem(2, 6, smoother="rbgs")
    v0 = torch.from_numpy(np.array(jeigen.coarse_init(jprob.hierarchy, 1,
                                                      jnp.float64)))
    out = {}
    for use in (True, False):
        prob = mt.poisson2d(k=6, dtype=torch.float64, smoother="rbgs",
                            use_kernels=use, device="cpu")
        out[use] = mt.MultigridSolver(prob).eigensolve(
            k=1, method=method, tol=1e-9, v0=v0)
    want = jmg.MultigridSolver(jprob).eigensolve(k=1, method=method,
                                                 tol=1e-9)
    got = out[True]
    assert got.converged and got.iters == out[False].iters == int(want.iters)
    np.testing.assert_allclose(got.eigenvalues.numpy(),
                               out[False].eigenvalues.numpy(), rtol=1e-10)
    np.testing.assert_allclose(got.eigenvalues.numpy(),
                               np.asarray(want.eigenvalues), rtol=1e-10)
    assert calls["legs"] > 0
    assert (calls["residual"] > 0) == (method != "lobpcg")


@pytest.mark.parametrize("method", ["ii", "lobpcg"])
def test_mixed_precision_still_raises(method, monkeypatch):
    """precond_dtype where JAX casts a 3D RB-GS cycle on its kernel tier,
    in a dtype the kernels do not store (float16): the eigensolvers raise
    naming themselves and the dtype. (Mixed precision in bfloat16 is
    ported on the packed 2D tier and on the 3D stencil3d tier:
    tests/test_torch_mixed.py, tests/test_torch_mixed3d.py.)"""
    monkeypatch.setattr(kernels, "KERNEL3_MIN_N", 7)
    solver = mt.MultigridSolver(mt.poisson(
        k=3, ndim=3, dtype=torch.float64, smoother="rbgs", use_kernels=True,
        precond_dtype=torch.float16, device="cpu"))
    with pytest.raises(NotImplementedError,
                       match=r"eigensolver.*float16"):
        solver.eigensolve(k=1, method=method)


def test_unknown_method_raises():
    solver = mt.MultigridSolver(mt.poisson2d(k=3, dtype=torch.float64,
                                             device="cpu"))
    with pytest.raises(ValueError, match="eigensolver method"):
        solver.eigensolve(k=1, method="arnoldi")


def test_v0_ghosts_are_stripped():
    """A warm start's ghosts are zeroed before it is used: a converged
    block with junk ghosts converges at once to the same eigenvalue."""
    prob = mt.poisson2d(k=5, dtype=torch.float64, smoother="rbgs",
                        device="cpu")
    solver = mt.MultigridSolver(prob)
    first = solver.eigensolve(k=1, tol=1e-9)
    v0 = first.eigenvectors + 3.0
    v0[(slice(None),) + (slice(1, -1),) * 2] = first.eigenvectors[
        (slice(None),) + (slice(1, -1),) * 2]
    again = solver.eigensolve(k=1, tol=1e-9, v0=v0)
    assert again.iters == 0 and again.converged
    assert again.eigenvalues.item() == pytest.approx(
        first.eigenvalues.item(), rel=1e-12)
