"""The port's full multigrid (solvers/cycles.py: fmg, solve with
cycle="fmg"; ops/transfer.py: fmg_prolong) on the CPU in float64, against
the JAX package: the plain route, and the kernel route (the port's wrappers
take their plain versions on CPU tensors) against JAX's Pallas route in
interpret mode with the thresholds lowered; config 3's accuracy at CPU
size; and the SciPy mini-reference (tests/reference_impl.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multigridcmt_tpu as jmg
import multigridcmt_tpu_torch as mt
import reference_impl as ref
from multigridcmt_tpu import kernels as jkernels
from multigridcmt_tpu.grids import pad_interior as jpad
from multigridcmt_tpu.ops import transfer as jtransfer
from multigridcmt_tpu.solvers import cycles as jcycles
from multigridcmt_tpu_torch import convert, kernels
from multigridcmt_tpu_torch.grids import interior
from multigridcmt_tpu_torch.kernels import fused2d, packed2d
from multigridcmt_tpu_torch.ops import transfer
from multigridcmt_tpu_torch.solvers import cycles

# Kernel-route thresholds: levels 63 and 31 on the kernel tier at k=6; with
# PACK_MIN_N 40 the 63 level packs and 31 stays unpacked.
KERNEL_MIN_N = 20
PACK_MIN_N = 40


@pytest.mark.parametrize("ndim,nc", [(1, 1), (1, 15), (2, 3), (2, 7),
                                     (3, 3), (3, 7)])
def test_fmg_prolong_matches_jax(ndim, nc):
    """The cubic walk on random padded grids, bit for bit up to rtol 1e-15;
    in 3D its passes run in ascending axis order, where prolong runs minor
    first (a 3D grid with no symmetry pins the order)."""
    rng = np.random.default_rng(10 * ndim + nc)
    c = np.asarray(jpad(jnp.asarray(rng.standard_normal((nc,) * ndim))))
    want = np.asarray(jtransfer.fmg_prolong(jnp.asarray(c)))
    got = transfer.fmg_prolong(torch.from_numpy(c))
    assert tuple(got.shape) == want.shape == (2 * nc + 3,) * ndim
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-15, atol=0)
    assert got.is_contiguous()


def test_fmg_prolong_is_fourth_order():
    """It interpolates sin(pi x) at fourth order: the error ratio between
    successive grids is ~16 (linear prolongation: ~4)."""
    errs = []
    for k in (5, 6, 7):
        nc = 2 ** k - 1
        xc = torch.arange(1, nc + 1, dtype=torch.float64) / (nc + 1)
        xf = torch.arange(1, 2 * nc + 2, dtype=torch.float64) / (2 * nc + 2)
        fine = transfer.fmg_prolong(mt.pad_interior(torch.sin(torch.pi * xc)))
        errs.append((interior(fine) - torch.sin(torch.pi * xf)).abs().max())
    assert errs[0] / errs[1] > 12.0 and errs[1] / errs[2] > 12.0


def _problems(k, ndim, monkeypatch, route, **kw):
    """(JAX problem, port problem) on ``route``: "plain", "kernel"
    (KERNEL_MIN_N and PALLAS_MIN_N lowered) or "packed" (PACK_MIN_N too)."""
    if route != "plain":
        monkeypatch.setattr(jkernels, "PALLAS_MIN_N", KERNEL_MIN_N)
        monkeypatch.setattr(kernels, "KERNEL_MIN_N", KERNEL_MIN_N)
    if route == "packed":
        monkeypatch.setattr(jkernels, "PACK_MIN_N", PACK_MIN_N)
        monkeypatch.setattr(kernels, "PACK_MIN_N", PACK_MIN_N)
    jprob = jmg.poisson(k, ndim=ndim, dtype=jnp.float64,
                        use_pallas=route != "plain", **kw)
    return jprob, convert.problem_from_jax(jprob, device="cpu")


def _jax_fmg(jprob, n_vcycles):
    """JAX's MultigridSolver.fmg under one jit (its eager dispatch of the
    unrolled walk takes seconds a level in interpret mode)."""
    bk = jcycles.get_backend(jprob.config)
    n = jprob.config.n
    run = jax.jit(lambda b, hier: bk.decode(jcycles.fmg(
        hier, bk.encode(b), jprob.config, n_vcycles=n_vcycles), n))
    return np.asarray(run(jprob.b, jprob.hierarchy))


# (ndim, k, route, config overrides, n_vcycles)
FMG_CASES = [
    (1, 7, "plain", dict(smoother="rbgs", fmg_prolong="cubic"), 1),
    (2, 6, "plain", dict(smoother="rbgs"), 1),
    (2, 6, "plain", dict(smoother="jacobi", fmg_prolong="cubic", cycle="w"),
     2),
    (3, 4, "plain", dict(smoother="rbgs"), 2),
    (3, 4, "plain", dict(smoother="jacobi", fmg_prolong="cubic"), 2),
    (2, 6, "kernel", dict(smoother="rbgs"), 1),
    (2, 6, "packed", dict(smoother="rbgs"), 1),
    (2, 6, "packed", dict(smoother="rbgs", fmg_prolong="cubic"), 1),
]


@pytest.mark.parametrize("ndim,k,route,kw,nv", FMG_CASES, ids=[
    f"{d}d-k{k}-{r}-{'-'.join(str(v) for v in kw.values())}-nv{nv}"
    for d, k, r, kw, nv in FMG_CASES])
def test_fmg_matches_jax(ndim, k, route, kw, nv, monkeypatch):
    """One FMG pass (MultigridSolver.fmg) against JAX's, iterate rtol 1e-10
    (atol 1e-12): every level's V-cycles (V even for a W config, as JAX's
    walk), the linear or cubic walk, and on the kernel routes the fused
    legs and, packed, the zero-sweep packed legs of b's restriction and of
    the walk onto the packed level."""
    jprob, prob = _problems(k, ndim, monkeypatch, route, **kw)
    want = _jax_fmg(jprob, nv)
    got = mt.MultigridSolver(prob).fmg(n_vcycles=nv)
    assert tuple(got.shape) == want.shape and not packed2d.is_packed(got)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)


def test_fmg_kernel_route_calls(monkeypatch):
    """Packed route at k=6: b's restriction from 63 and the walk's
    prolongation onto 63 are zero-sweep packed legs; each level's V-cycle
    runs the packed legs at 63 and the fused2d legs at 31 where it crosses
    them (the walk's cycles start at 31, then 63)."""
    _, prob = _problems(6, 2, monkeypatch, "packed", smoother="rbgs")
    calls = []
    for mod, name, leg in ((packed2d, "smooth_residual_restrict", "down"),
                           (packed2d, "prolong_add_smooth", "up"),
                           (fused2d, "smooth_residual_restrict", "down"),
                           (fused2d, "prolong_add_smooth", "up")):
        def spy(*a, _f=getattr(mod, name),
                _tag=f"{mod.__name__.rsplit('.', 1)[1]} {leg}", **kw):
            calls.append((_tag, kw["sweeps"]))
            return _f(*a, **kw)
        monkeypatch.setattr(mod, name, spy)
    mt.MultigridSolver(prob).fmg()
    assert calls == [
        ("packed2d down", 0),                         # restrict b: 63 -> 31
        ("fused2d down", 2), ("fused2d up", 2),       # the cycle at 31
        ("packed2d up", 0),                           # prolong 31 -> 63
        ("packed2d down", 2), ("fused2d down", 2),    # the cycle at 63
        ("fused2d up", 2), ("packed2d up", 2)]


@pytest.mark.parametrize("route,kw", [
    ("plain", dict(smoother="jacobi", fmg_prolong="cubic")),
    ("packed", dict(smoother="rbgs")),
], ids=["plain-jacobi-cubic", "packed"])
def test_fmg_solve_matches_jax(route, kw, monkeypatch):
    """solve(cycle="fmg"): FMG once, its residual first in the history,
    then V-cycles to tol: the polishing count equal to JAX's, histories
    rtol 1e-9 (atol 1e-13), iterates rtol 1e-10."""
    jprob, prob = _problems(6, 2, monkeypatch, route, cycle="fmg",
                            tol=1e-10, **kw)
    want = jmg.MultigridSolver(jprob).solve()
    got = mt.MultigridSolver(prob).solve()
    assert got.iters == int(want.iters) and got.iters >= 1
    assert got.converged == bool(want.converged)
    np.testing.assert_allclose(got.res_history.numpy(),
                               np.asarray(want.res_history), rtol=1e-9,
                               atol=1e-13)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-10,
                               atol=1e-12)
    # FMG alone lands at discretisation accuracy, far below the zero
    # start's residual of 1.
    assert got.res_history[0].item() < 1e-2


def test_fmg_solve_ignores_x0():
    """As in JAX, an FMG solve starts from FMG, not from x0."""
    prob = mt.poisson2d(k=5, dtype=torch.float64, smoother="rbgs",
                        cycle="fmg", tol=1e-10, device="cpu")
    solver = mt.MultigridSolver(prob)
    a, b = solver.solve(), solver.solve(x0=torch.ones_like(prob.b))
    assert a.iters == b.iters and torch.equal(a.x, b.x)


@pytest.mark.parametrize("route", ["packed"])
def test_pcg_with_fmg_config_matches_jax(route, monkeypatch):
    """MG-PCG with an FMG config: its preconditioner is one V-cycle (the
    cycle an FMG config takes), as in JAX."""
    jprob, prob = _problems(6, 2, monkeypatch, route, cycle="fmg",
                            smoother="rbgs", tol=1e-10)
    want = jmg.MultigridSolver(jprob).solve(method="pcg")
    got = mt.MultigridSolver(prob).solve(method="pcg")
    assert got.iters == int(want.iters) and got.converged
    np.testing.assert_allclose(got.res_history.numpy(),
                               np.asarray(want.res_history), rtol=1e-9,
                               atol=1e-13)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-10,
                               atol=1e-12)


def test_fmg_cycle_is_a_v_cycle():
    """cycles.cycle with an FMG config is the V-cycle, gamma 1."""
    prob = mt.poisson2d(k=5, dtype=torch.float64, smoother="rbgs",
                        cycle="fmg", device="cpu")
    x = torch.zeros_like(prob.b)
    got = cycles.cycle(prob.hierarchy, x, prob.b, prob.config)
    assert torch.equal(got, cycles.v_cycle(prob.hierarchy, x, prob.b,
                                           prob.config, gamma=1))


@pytest.mark.parametrize("walk", ["linear", "cubic"])
def test_config3_fmg_accuracy(walk):
    """Config 3 at CPU size: one FMG pass reaches the 5-point scheme's
    O(h^2) discrete-L2 error (under 5 h^2) at k = 5, 6, 7, and the error
    falls by about 4 a level (ratio in (3, 5))."""
    errs = []
    for k in (5, 6, 7):
        prob = mt.poisson2d(k=k, dtype=torch.float64, smoother="rbgs",
                            fmg_prolong=walk, device="cpu")
        solver = mt.MultigridSolver(prob)
        err = solver.discrete_l2_error(solver.fmg()).item()
        assert err < 5.0 * prob.config.h ** 2
        errs.append(err)
    for a, b in zip(errs, errs[1:]):
        assert 3.0 < a / b < 5.0


def test_fmg_matches_scipy_reference():
    """Jacobi FMG at k=6 against reference_impl.fmg, rtol 1e-9, as
    tests/test_cycles.py holds JAX's."""
    prob = mt.poisson2d(k=6, dtype=torch.float64, smoother="jacobi",
                        device="cpu")
    x = mt.MultigridSolver(prob).fmg()
    want = ref.fmg(interior(prob.b).numpy(), prob.config.h, kind="jacobi")
    np.testing.assert_allclose(interior(x).numpy(), want, rtol=1e-9,
                               atol=1e-12)
