"""The PyTorch port's solve end to end on the CPU: the kernel-tier route
against the JAX package's Pallas route (interpret mode), and the plain
route against the SciPy mini-reference (tests/reference_impl.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multigridcmt_tpu as jmg
import multigridcmt_tpu_torch as mt
from multigridcmt_tpu import kernels as jkernels
from multigridcmt_tpu_torch import convert, kernels
from multigridcmt_tpu_torch.grids import interior
from multigridcmt_tpu_torch.kernels import fused2d, stencil2d

import reference_impl as ref


def _launch_counts():
    return (fused2d.down_launches, fused2d.up_launches, stencil2d.launches)


def test_kernel_tier_solve_matches_jax_pallas(monkeypatch):
    """k=6, float64, RB-GS: with both thresholds at 20, levels 63 and 31 run
    the fused legs (JAX: fused2d in interpret mode; port: the kernel
    wrappers, which take their plain versions on CPU tensors) and the
    convergence check runs the residual kernel's route."""
    monkeypatch.setattr(jkernels, "PALLAS_MIN_N", 20)
    monkeypatch.setattr(kernels, "KERNEL_MIN_N", 20)
    jprob = jmg.poisson2d(k=6, dtype=jnp.float64, smoother="rbgs", tol=1e-9,
                          use_pallas=True)
    want = jmg.MultigridSolver(jprob).solve()

    prob = convert.problem_from_jax(jprob, device="cpu")
    assert prob.config.use_kernels and prob.b.dtype == torch.float64
    calls = {"down": [], "up": [], "residual": []}
    # (module, wrapper, key, position of the fine n among its arguments)
    for mod, name, key, pos in (
            (fused2d, "smooth_residual_restrict", "down", 2),
            (fused2d, "prolong_add_smooth", "up", 3),
            (stencil2d, "residual", "residual", 2)):
        def spy(*a, _f=getattr(mod, name), _k=key, _p=pos, **kw):
            calls[_k].append(a[_p])
            return _f(*a, **kw)
        monkeypatch.setattr(mod, name, spy)
    before = _launch_counts()
    got = mt.MultigridSolver(prob).solve()

    iters = int(want.iters)
    assert got.iters == iters and got.converged
    # The histories agree to rtol 1e-9 down to the float64 rounding floor
    # of the residual at this h (~eps * 4/h^2 * |u| / |b|, about 1e-14 of
    # ||b||), which the two routes reach by different rounding orders.
    np.testing.assert_allclose(got.res_history.numpy(),
                               np.asarray(want.res_history),
                               rtol=1e-9, atol=1e-13)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x),
                               rtol=1e-10, atol=1e-12)
    # Route: each cycle runs both fused legs on levels 63 and 31; the
    # residual wrapper serves the initial check and one per cycle.
    assert calls["down"] == [63, 31] * iters
    assert calls["up"] == [31, 63] * iters
    assert calls["residual"] == [63] * (iters + 1)
    # CPU tensors never launch a CUDA kernel.
    assert _launch_counts() == before


@pytest.mark.parametrize("use_kernels", [False, True])
def test_rbgs_history_matches_scipy_reference_2d(use_kernels, monkeypatch):
    """V(2,2) RB-GS, k=5, at the tolerances of tests/test_cycles.py."""
    monkeypatch.setattr(kernels, "KERNEL_MIN_N", 20)
    prob = mt.poisson2d(k=5, dtype=torch.float64, smoother="rbgs", tol=1e-8,
                        use_kernels=use_kernels, device="cpu")
    res = mt.MultigridSolver(prob).solve()
    _, hist_ref = ref.solve(interior(prob.b).numpy(), prob.config.h,
                            kind="rbgs", tol=1e-8,
                            min_coarse=prob.config.min_coarse)
    assert res.iters == len(hist_ref) - 1 and res.converged
    np.testing.assert_allclose(res.res_history[: res.iters + 1].numpy(),
                               hist_ref, rtol=1e-6, atol=1e-11)
    assert mt.convergence_factor(res) < 0.15


def test_jacobi_history_matches_scipy_reference_1d():
    """V(2,2) weighted Jacobi in 1D, k=8 (1D stays on the plain route)."""
    prob = mt.poisson1d(k=8, dtype=torch.float64, smoother="jacobi",
                        tol=1e-8, use_kernels=True, device="cpu")
    res = mt.MultigridSolver(prob).solve()
    _, hist_ref = ref.solve(interior(prob.b).numpy(), prob.config.h,
                            kind="jacobi", tol=1e-8,
                            min_coarse=prob.config.min_coarse)
    assert res.iters == len(hist_ref) - 1
    np.testing.assert_allclose(res.res_history[: res.iters + 1].numpy(),
                               hist_ref, rtol=1e-6, atol=1e-11)
    err = (interior(res.x) - interior(prob.u_exact)).abs().max().item()
    assert err < 1e-4


def test_w_cycle_matches_jax():
    """W-cycle (gamma = 2) on the plain route against the JAX jnp route."""
    jprob = jmg.poisson2d(k=5, dtype=jnp.float64, smoother="jacobi",
                          cycle="w", tol=1e-10)
    want = jmg.MultigridSolver(jprob).solve()
    got = mt.MultigridSolver(
        convert.problem_from_jax(jprob, device="cpu")).solve()
    assert got.iters == int(want.iters)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x),
                               rtol=1e-10, atol=1e-12)
    # Padded history: entries past iters repeat the final value.
    assert got.res_history.shape == (jprob.config.max_iters + 1,)
    assert bool((got.res_history[got.iters:] == got.res_history[-1]).all())


def test_guards_stop_a_stalled_solve():
    """float32 at k=7 stalls at its rounding floor; the stall guard ends the
    loop long before max_iters, with converged False."""
    prob = mt.poisson2d(k=7, dtype=torch.float32, smoother="rbgs",
                        tol=1e-12, device="cpu")
    res = mt.MultigridSolver(prob).solve()
    assert not res.converged and res.iters < prob.config.max_iters
    err = mt.MultigridSolver(prob).discrete_l2_error(res.x).item()
    assert np.isfinite(err) and err < 1e-3


def test_step_guards():
    from multigridcmt_tpu.solvers import cycles as jcycles
    from multigridcmt_tpu_torch.solvers import cycles

    for new, old in ((1.0, 1.0), (0.5, 1.0), (20.0, 1.0), (0.95, 1.0)):
        got = cycles.step_guards(new, old, 1, 1)
        want = jcycles.step_guards(jnp.float64(new), jnp.float64(old), 1, 1)
        assert got == tuple(int(w) for w in want)
    assert cycles.guards_ok(2, 1) and not cycles.guards_ok(3, 0)
    assert not cycles.guards_ok(0, 2)
