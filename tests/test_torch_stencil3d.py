"""The 3D kernels of the PyTorch port (kernels/stencil3d.py) against the JAX
package's stencil3d Pallas kernel in interpret mode, called as
tests/test_stencil3d.py calls it (logical grids embedded in the aligned3
layout and cut back out), and the 3D RB-GS solve on the kernel route
against JAX's.

On a CPU tensor each wrapper takes its plain PyTorch version, so these
tests pin that version, which chip_smoke.py then holds the CUDA kernel
against on the card. Inputs are float64, made with numpy from a seed.
Tolerance: max |port - JAX| <= 1e-12 * max|JAX|. Both evaluate the same
formulas in the same order, but the Pallas kernel multiplies by masks where
the port selects, and XLA may contract a product and a sum into one
rounding; 1e-12 leaves a few thousand ulp of room for that and no more.
k=5 (33 planes) runs the kernel's plane-block ring through many
wrap-arounds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multigridcmt_tpu as jmg
import multigridcmt_tpu_torch as mt
from multigridcmt_tpu import kernels as jkernels
from multigridcmt_tpu.grids import from_aligned3, to_aligned3
from multigridcmt_tpu.kernels import stencil3d as jstencil3d
from multigridcmt_tpu_torch import convert, kernels
from multigridcmt_tpu_torch.grids import interior
from multigridcmt_tpu_torch.ops import laplacian, smoothers
from multigridcmt_tpu_torch.solvers import cycles
from multigridcmt_tpu_torch.kernels import stencil3d

SIGMA = 11.5
OMEGA = 6.0 / 7.0      # the default 3D Jacobi weight (config.effective_omega)


def _rand_pair(n, seed):
    rng = np.random.default_rng(seed)
    u = np.zeros((n + 2,) * 3)
    u[1:-1, 1:-1, 1:-1] = rng.standard_normal((n,) * 3)
    b = np.zeros_like(u)
    b[1:-1, 1:-1, 1:-1] = rng.standard_normal((n,) * 3)
    return u, b


def _counts():
    return (stencil3d.residual_launches, stencil3d.jacobi_launches,
            stencil3d.rbgs_launches)


def _close(got: torch.Tensor, want: np.ndarray) -> None:
    assert tuple(got.shape) == want.shape
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-12 * np.abs(want).max(), err


def _call_both(mode, u, b, n, h, **kw):
    """(port result, JAX result on the logical grid) of one mode."""
    jfn, tfn = getattr(jstencil3d, mode), getattr(stencil3d, mode)
    want = np.asarray(from_aligned3(
        jfn(to_aligned3(jnp.asarray(u)), to_aligned3(jnp.asarray(b)), n, h,
            **kw), n))
    before = _counts()
    got = tfn(torch.from_numpy(u), torch.from_numpy(b), n, h, **kw)
    assert _counts() == before                 # CPU: the plain version
    return got, want


def _cases():
    cases = [("residual", 4, {}), ("residual", 5, {})]
    for sigma in (0.0, SIGMA):
        cases.append(("residual", 4, dict(sigma=sigma)))
        for sweeps in (1, 2):
            cases.append(("jacobi_sweep", 4,
                          dict(omega=OMEGA, sigma=sigma, sweeps=sweeps)))
            cases.append(("rbgs_sweep", 4, dict(sigma=sigma, sweeps=sweeps)))
    cases += [("jacobi_sweep", 5, dict(omega=OMEGA)),
              ("rbgs_sweep", 5, dict(sweeps=1))]
    return cases


@pytest.mark.parametrize("mode,k,kw", _cases())
def test_matches_pallas(mode, k, kw):
    n = 2 ** k - 1
    u, b = _rand_pair(n, seed=100 * k + len(kw))
    got, want = _call_both(mode, u, b, n, 1.0 / (n + 1), **kw)
    _close(got, want)
    ghosts = got.numpy().copy()
    ghosts[1:-1, 1:-1, 1:-1] = 0.0
    assert np.abs(ghosts).max() == 0.0


@pytest.mark.parametrize("mode,kw", [
    ("residual", dict(sigma=SIGMA)),
    ("jacobi_sweep", dict(omega=OMEGA, sweeps=2)),
    ("rbgs_sweep", dict(sigma=SIGMA, sweeps=2)),
])
def test_plane_stack_with_offsets_matches_pallas(mode, kw):
    """A slab-and-pencil stack: planes 11..18 and rows -2..21 of the n=15
    grid (goff=11, roff=-2), so the stack holds the global ghost plane 16
    inside it and pads past it, and its first and last rows lie outside
    the grid (where the TPU kernel's in-plane rolls wrap around, the port
    leaves the stack's edge rows alone; rows outside [1, n] are not updated
    by either). JAX's stack is 8 x 24 x 128 (its tiling); the port's takes
    the n + 2 = 17 columns."""
    n, goff, roff, p, r = 15, 11, -2, 8, 24
    u, b = _rand_pair(n, seed=7)
    stacks = []
    for g in (u, b):
        s = np.zeros((p, r, 128))
        planes = g[goff:goff + p]                  # planes past 16: zero
        s[:planes.shape[0], -roff:-roff + n + 2, :n + 2] = planes
        stacks.append(s)
    h = 1.0 / (n + 1)
    jfn, tfn = getattr(jstencil3d, mode), getattr(stencil3d, mode)
    want = np.asarray(jfn(jnp.asarray(stacks[0]), jnp.asarray(stacks[1]),
                          n, h, goff=goff, roff=roff, **kw))
    got = tfn(torch.from_numpy(stacks[0][..., :n + 2].copy()),
              torch.from_numpy(stacks[1][..., :n + 2].copy()), n, h,
              goff=goff, roff=roff, **kw)
    assert np.abs(want[..., n + 2:]).max() == 0.0
    _close(got, want[..., :n + 2])
    # Planes outside [1, n] and the stack's edge planes are zero.
    assert np.abs(got.numpy()[[0, 5, 6, 7]]).max() == 0.0


def _spy_levels(monkeypatch):
    calls = {key: [] for key in ("rbgs", "jacobi", "residual")}
    for name, key in (("rbgs_sweep", "rbgs"), ("jacobi_sweep", "jacobi"),
                      ("residual", "residual")):
        def spy(u, b, n, *a, _f=getattr(stencil3d, name), _k=key, **kw):
            calls[_k].append(n)
            return _f(u, b, n, *a, **kw)
        monkeypatch.setattr(stencil3d, name, spy)
    return calls


@pytest.mark.parametrize("k,min_n", [(4, 7), (5, 15)])
def test_kernel_route_solve_matches_jax_pallas(k, min_n, monkeypatch):
    """float64 V(2,2) RB-GS with the 3D kernel threshold lowered in both
    packages, so the finest two levels run the stencil3d kernels: equal
    iteration counts; histories at rtol 1e-9 down to the float64 rounding
    floor of the residual (~1e-14 of ||b||, hence atol 1e-13, as in
    test_torch_solve.py); and the result solves the 3D operator: the
    port's dense operator at k=4 (at k=5 it would take 7 GB), its
    matrix-free residual at k=5."""
    monkeypatch.setattr(jkernels, "PALLAS3_MIN_N", min_n)
    monkeypatch.setattr(kernels, "KERNEL3_MIN_N", min_n)
    jprob = jmg.poisson3d(k=k, dtype=jnp.float64, smoother="rbgs", tol=1e-9,
                          use_pallas=True)
    want = jmg.MultigridSolver(jprob).solve()
    prob = convert.problem_from_jax(jprob, device="cpu")
    assert prob.config.use_kernels and prob.config.ndim == 3
    calls = _spy_levels(monkeypatch)
    got = mt.MultigridSolver(prob).solve()

    iters = int(want.iters)
    assert got.iters == iters and got.converged
    np.testing.assert_allclose(got.res_history.numpy(),
                               np.asarray(want.res_history),
                               rtol=1e-9, atol=1e-13)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x),
                               rtol=1e-10, atol=1e-12)
    tier = [2 ** j - 1 for j in range(k, 1, -1) if 2 ** j - 1 >= min_n]
    # Per cycle: nu1 then nu2 sweeps on each kernel level (one call each,
    # down then up); the down leg's residual; the solve's check.
    assert calls["rbgs"] == (tier + tier[::-1]) * iters
    assert sorted(calls["residual"]) == sorted(tier * iters
                                               + [tier[0]] * (iters + 1))
    assert calls["jacobi"] == []

    n, h = prob.config.n, prob.config.h
    if k == 4:
        a = torch.from_numpy(laplacian.dense_operator(n, 3, h))
        r = interior(prob.b).reshape(-1) - a @ interior(got.x).reshape(-1)
    else:
        r = laplacian.residual(got.x, prob.b, h)
    assert (torch.linalg.vector_norm(r)
            < 1e-9 * torch.linalg.vector_norm(interior(prob.b)))


def test_jacobi_3d_takes_the_plain_route():
    """JAX's rule: with kernels on, a 3D cycle that is not RB-GS runs the
    plain stencils; 2D Jacobi and 3D RB-GS take the kernel backend."""
    from multigridcmt_tpu_torch.config import SolverConfig

    def backend(**kw):
        return cycles.get_backend(SolverConfig(use_kernels=True, **kw))

    assert backend(ndim=3, k=9, smoother="jacobi") is cycles.PLAIN_BACKEND
    assert backend(ndim=3, k=9, smoother="rbgs") is kernels.KERNEL_BACKEND
    assert backend(ndim=2, k=9, smoother="jacobi") is kernels.KERNEL_BACKEND


def test_jacobi_3d_solve_runs_no_kernel(monkeypatch):
    monkeypatch.setattr(kernels, "KERNEL3_MIN_N", 7)
    calls = _spy_levels(monkeypatch)
    prob = mt.poisson3d(k=4, dtype=torch.float64, smoother="jacobi",
                        use_kernels=True, device="cpu", max_iters=3)
    mt.MultigridSolver(prob).solve()
    assert calls == {"rbgs": [], "jacobi": [], "residual": []}


def test_kernel_backend_smooths_3d_kernel_levels(monkeypatch):
    """On a 3D kernel-tier level the backend's smooth runs the stencil3d
    sweep of its kind, and Chebyshev its residual applies (as JAX keeps
    it, though a 3D Chebyshev cycle takes the plain backend); a smaller
    level takes the plain smoothers."""
    monkeypatch.setattr(kernels, "KERNEL3_MIN_N", 15)
    calls = _spy_levels(monkeypatch)
    bk = kernels.KERNEL_BACKEND
    for n in (15, 7):
        u, b = (torch.from_numpy(a) for a in _rand_pair(n, seed=n))
        h = 1.0 / (n + 1)
        for kind in ("rbgs", "jacobi", "chebyshev"):
            got = bk.smooth(u, b, n, h, kind=kind, omega=OMEGA, sweeps=2)
            want = smoothers.smooth(u, b, h, kind=kind, omega=OMEGA,
                                    sweeps=2)
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       rtol=1e-12, atol=1e-12)
    assert calls == {"rbgs": [15], "jacobi": [15], "residual": [15, 15]}
