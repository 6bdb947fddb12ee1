"""The port's utils (multigridcmt_tpu_torch/utils: metrics, checkpoint,
debug, profiling, plots) against the JAX package's on the CPU, float64,
inputs from a seed.

The metrics records of one solve match JAX's field for field; a resume from
JAX's partial iterate follows JAX's resume; the port's resume is bit-equal
to its own uninterrupted solve; a snapshot routes on its explicit kind,
never on its keys (ROADMAP.md, queue 3, F3); debug mode names the first
operation that produced a NaN, a kernel launch included; a trace holds a
range for every level; the plots' pixels equal JAX's. The sharded
checkpoint cases run in a gloo world of 2 (test_torch_sharded.spawn_world;
its ranks import torch and the port only).
"""
import io
import json
import math

import numpy as np
import pytest
import torch

import multigridcmt_tpu_torch as mt
from multigridcmt_tpu_torch import convert
from multigridcmt_tpu_torch.config import SolverConfig
from multigridcmt_tpu_torch.kernels import _build, _wrap
from multigridcmt_tpu_torch.utils import (checkpoint, debug, metrics, plots,
                                          profiling)
from test_torch_sharded import spawn_world

RTOL = 1e-10
FLOOR = 1e-12


def _close(got, want, rtol=RTOL, floor=FLOOR):
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= rtol * np.abs(want) + floor), \
        (got, want)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _records(logger_cls, res, cfg):
    buf = io.StringIO()
    logger_cls(buf).log_solve_result(res, cfg)
    return [json.loads(ln) for ln in buf.getvalue().splitlines()]


def test_metrics_logger_jsonl():
    buf = io.StringIO()
    m = metrics.MetricsLogger(buf)
    m.log("iteration", iter=1,
          residual=torch.tensor(1e-3, dtype=torch.float64),
          rho=np.float32(0.5))
    rec = json.loads(buf.getvalue().strip())
    assert rec["event"] == "iteration" and "t" in rec
    assert rec["residual"] == 1e-3 and rec["rho"] == 0.5


@pytest.mark.parametrize("ndim,k", [(1, 6), (2, 5)])
def test_metrics_records_match_jax(ndim, k):
    """The same solve's records, field for field: events, iters and
    converged equal, the residuals within rtol 1e-10 plus 1e-12; rho and
    mean_rho, ratios of residuals down to ~1e-9, within what that bound on
    their residuals implies (each residual's bound over the residual,
    summed: 1e-12 over 1e-9 is 1e-3 of the ratio, where rounding order
    parts the two packages' histories by ~1e-15)."""
    import jax.numpy as jnp

    import multigridcmt_tpu as jmg
    from multigridcmt_tpu.utils import metrics as jmetrics

    kw = dict(ndim=ndim, smoother="rbgs" if ndim == 2 else "jacobi",
              tol=1e-8)
    jprob = jmg.poisson(k, dtype=jnp.float64, **kw)
    want = _records(jmetrics.MetricsLogger,
                    jmg.MultigridSolver(jprob).solve(), jprob.config)
    prob = mt.poisson(k, dtype=torch.float64, device="cpu", **kw)
    got = _records(metrics.MetricsLogger, mt.MultigridSolver(prob).solve(),
                   prob.config)
    assert [r["event"] for r in got] == [r["event"] for r in want]
    assert sum(r["event"] == "iteration" for r in got) == got[-1]["iters"] + 1
    hist = [r["residual"] for r in want if r["event"] == "iteration"]
    slack = [(RTOL * r + FLOOR) / r for r in hist]   # a residual's, relative
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert {k: v for k, v in g.items() if not isinstance(v, float)} == \
            {k: v for k, v in w.items() if not isinstance(v, float)}
        if g["event"] == "iteration":
            _close(g["residual"], w["residual"])
            it = w["iter"]
            if it > 0:
                _close(g["rho"], w["rho"], rtol=slack[it] + slack[it - 1],
                       floor=0)
        else:
            _close(g["final_residual"], w["final_residual"])
            _close(g["mean_rho"], w["mean_rho"],
                   rtol=(slack[-1] + slack[0]) / max(w["iters"], 1), floor=0)
    assert got[-1]["converged"] is True


@pytest.mark.parametrize("hist,iters,threshold", [
    ([1.0, 0.5, 1.2, 2.9], 3, 1.0),          # JAX's diverging case
    ([1.0, 0.1, 0.01, 0.001], 3, 1.0),       # JAX's converging case
    ([1.0, 2.0], 1, 1.0),                    # too short to tell
    ([1.0, 2.0, 3.0, 3.0], 3, 1.0),          # level is not growth
    ([1.0, 1.5, 2.0, 2.0], 2, 1.4),          # growth under the threshold
    ([1.0, 1.5, 2.5, 2.5], 2, 1.4),
    ([0.0, 0.0, 0.0], 2, 1.0),
])
def test_divergence_guard_matches_jax(hist, iters, threshold):
    from multigridcmt_tpu.utils import metrics as jmetrics

    want = jmetrics.divergence_guard(np.array(hist), iters, threshold)
    assert metrics.divergence_guard(np.array(hist), iters, threshold) == want
    assert metrics.divergence_guard(torch.tensor(hist, dtype=torch.float64),
                                    iters, threshold) == want


def test_nonzero_rank_writes_nothing(monkeypatch):
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
    assert not metrics.is_host0()
    buf = io.StringIO()
    res = mt.MultigridSolver(mt.poisson1d(k=4, dtype=torch.float64,
                                          device="cpu")).solve()
    m = metrics.MetricsLogger(buf)
    m.log("iteration", iter=0, residual=1.0)
    m.log_solve_result(res)
    assert buf.getvalue() == ""


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((33, 33), generator=gen, dtype=torch.float64)
    hist = torch.rand(11, generator=gen, dtype=torch.float64)
    path = str(tmp_path / "snap.pt")
    checkpoint.save_state(path, x, hist, 3, extra={"b": 2 * x,
                                                   "note": np.arange(4)})
    state = checkpoint.load_state(path)
    assert state["kind"] == "solve" and state["iters"] == 3
    assert torch.equal(state["x"], x) and torch.equal(state["b"], 2 * x)
    assert torch.equal(state["res_history"], hist)
    assert torch.equal(state["note"], torch.arange(4))
    with pytest.raises(ValueError, match="kind"):
        checkpoint.save_state(path, x, hist, 3, kind="other")
    with pytest.raises(ValueError, match="replace"):
        checkpoint.save_state(path, x, hist, 3, extra={"x": x})


def test_resume_from_jax_partial_follows_jax(tmp_path):
    """JAX's partial k=5 iterate (max_iters=3), carried across: the port's
    resume takes JAX's resume's cycles with its history within rtol 1e-10
    plus 1e-12, and fewer cycles than a cold solve."""
    import jax.numpy as jnp

    import multigridcmt_tpu as jmg
    from multigridcmt_tpu.utils import checkpoint as jcheckpoint

    kw = dict(k=5, smoother="rbgs")
    jpart = jmg.MultigridSolver(jmg.poisson2d(
        dtype=jnp.float64, tol=1e-10, max_iters=3, **kw)).solve()
    assert not bool(jpart.converged)
    jpath = str(tmp_path / "jax")
    jcheckpoint.save_state(jpath, jpart.x, jpart.res_history, jpart.iters)
    jsolver = jmg.MultigridSolver(jmg.poisson2d(
        dtype=jnp.float64, tol=1e-9, max_iters=50, **kw))
    want = jcheckpoint.resume_solve(jsolver, jpath)

    path = str(tmp_path / "port.pt")
    checkpoint.save_state(path, np.asarray(jpart.x),
                          np.asarray(jpart.res_history), int(jpart.iters))
    solver = mt.MultigridSolver(convert.problem_from_jax(jsolver.problem,
                                                         device="cpu"))
    got = checkpoint.resume_solve(solver, path)
    assert got.converged and got.iters == int(want.iters)
    _close(got.res_history[: got.iters + 1],
           np.asarray(want.res_history)[: got.iters + 1])
    _close(got.x, np.asarray(want.x), rtol=0, floor=1e-12)
    assert got.iters < solver.solve().iters


def test_resume_is_bit_equal_to_the_uninterrupted_solve(tmp_path):
    """Three cycles, a snapshot, the rest: the cold solve's iterate bit for
    bit, in its cycles (a cycle is a fixed-point map)."""
    kw = dict(k=5, smoother="rbgs", dtype=torch.float64, tol=1e-9,
              device="cpu")
    part = mt.MultigridSolver(mt.poisson2d(max_iters=3, **kw)).solve()
    path = str(tmp_path / "snap.pt")
    checkpoint.save_state(path, part.x, part.res_history, part.iters)
    solver = mt.MultigridSolver(mt.poisson2d(**kw))
    resumed = checkpoint.resume_solve(solver, path)
    cold = solver.solve()
    assert resumed.converged and cold.converged
    assert part.iters + resumed.iters == cold.iters
    assert torch.equal(resumed.x, cold.x)


def test_solve_snapshot_with_eigenvalues_resumes_a_solve(tmp_path):
    """F3: JAX routes a snapshot holding an "eigenvalues" key to the
    eigensolver whatever it holds; the port routes on the snapshot's kind,
    so a solve snapshot that carries eigenvalues resumes the solve."""
    import jax.numpy as jnp

    import multigridcmt_tpu as jmg
    from multigridcmt_tpu.utils import checkpoint as jcheckpoint

    kw = dict(k=5, smoother="rbgs", tol=1e-9)
    jprob = jmg.poisson2d(dtype=jnp.float64, max_iters=3, **kw)
    jpart = jmg.MultigridSolver(jprob).solve()
    lam = np.array([19.7])
    jpath = str(tmp_path / "jax")
    jcheckpoint.save_state(jpath, jpart.x, jpart.res_history, jpart.iters,
                           extra={"eigenvalues": lam})
    jsolver = jmg.MultigridSolver(jmg.poisson2d(dtype=jnp.float64, **kw))
    jsolver.eigensolve = lambda **_: "eigensolve"
    assert jcheckpoint.resume_solve(jsolver, jpath) == "eigensolve"   # F3

    path = str(tmp_path / "snap.pt")
    checkpoint.save_state(path, np.asarray(jpart.x),
                          np.asarray(jpart.res_history), int(jpart.iters),
                          extra={"eigenvalues": lam})
    solver = mt.MultigridSolver(mt.poisson2d(dtype=torch.float64,
                                             device="cpu", **kw))
    res = checkpoint.resume_solve(solver, path)
    assert isinstance(res, mt.SolveResult) and res.converged
    assert 3 + res.iters == solver.solve().iters
    # The same snapshot saved as an eigen snapshot resumes the eigensolve.
    eig = solver.eigensolve(k=1, tol=1e-4)
    checkpoint.save_state(path, eig.eigenvectors, eig.res_history,
                          eig.iters, extra={"eigenvalues": eig.eigenvalues},
                          kind="eigen")
    res = checkpoint.resume_solve(solver, path, k=1, tol=1e-9)
    assert isinstance(res, mt.EigenResult) and res.converged


def test_eigensolve_resume_beats_cold():
    """JAX's single-device warm starts: II from the converged block takes at
    most 2 steps, LOBPCG no more than cold."""
    ms = mt.MultigridSolver(mt.poisson2d(k=5, dtype=torch.float64,
                                         smoother="rbgs", device="cpu"))
    cold = ms.eigensolve(k=2, tol=1e-9, max_iters=40)
    warm = ms.eigensolve(k=2, tol=1e-9, max_iters=40, v0=cold.eigenvectors)
    assert warm.converged and warm.iters <= 2
    coldl = ms.eigensolve(k=2, method="lobpcg", tol=1e-8, max_iters=40)
    warml = ms.eigensolve(k=2, method="lobpcg", tol=1e-8, max_iters=40,
                          v0=coldl.eigenvectors)
    assert warml.iters <= coldl.iters


def _checkpoint_case(mesh, kw, b):
    """One rank's sharded checkpoint case (the port only): every rank saves
    (rank 0 writes) and resumes from the same file."""
    from multigridcmt_tpu_torch.parallel import sharded

    path = kw["path"]
    if kw["case"] == "eigen":
        solver = sharded.ShardedSolver(SolverConfig(
            ndim=2, k=6, dtype=torch.float64, smoother="rbgs",
            agglom_rows=8), mesh)
        # inner_cycles=10 takes the default's outer steps at this size.
        cold = solver.eigensolve(k=2, tol=1e-9, max_iters=40,
                                 inner_cycles=10)
        part = solver.eigensolve(k=2, tol=1e-4, max_iters=40,
                                 inner_cycles=10)
        checkpoint.save_state(path, part.eigenvectors, part.res_history,
                              part.iters,
                              extra={"eigenvalues": part.eigenvalues},
                              kind="eigen")
        resumed = checkpoint.resume_solve(solver, path, k=2, tol=1e-9,
                                          max_iters=40, inner_cycles=10)
        return {"cold": (cold.iters, cold.eigenvalues),
                "resumed": (resumed.iters, resumed.converged,
                            resumed.eigenvalues)}
    cfg = dict(ndim=2, k=5, dtype=torch.float64, smoother="rbgs",
               agglom_rows=4)
    part = sharded.ShardedSolver(SolverConfig(tol=1e-10, max_iters=3, **cfg),
                                 mesh).solve(b)
    checkpoint.save_state(path, part.x, part.res_history, part.iters,
                          extra={"b": b})
    solver = sharded.ShardedSolver(SolverConfig(tol=1e-9, max_iters=50,
                                                **cfg), mesh)
    resumed = checkpoint.resume_solve(solver, path)      # b from the file
    cold = solver.solve(b)
    pcg = checkpoint.resume_solve(solver, path, b=b, method="pcg")
    bare = path + ".bare"
    checkpoint.save_state(bare, part.x, part.res_history, part.iters)
    try:
        checkpoint.resume_solve(solver, bare)
        error = None
    except ValueError as exc:
        error = str(exc)
    return {"part": (part.iters, part.converged),
            "resumed": (resumed.iters, resumed.converged),
            "cold": (cold.iters, cold.converged), "pcg": pcg.converged,
            "x": (resumed.x - cold.x).abs().max().item(), "error": error}


def test_sharded_checkpoint_resume(tmp_path):
    """A gloo world of 2: a ShardedSolver resumes a solve with the RHS from
    the snapshot (and by PCG), raises JAX's "needs the RHS" error without
    one, and an eigen snapshot beats a cold sharded eigensolve."""
    b = mt.poisson2d(k=5, dtype=torch.float64, device="cpu").b.numpy()
    cases = {name: {"case": name, "path": str(tmp_path / f"{name}.pt")}
             for name in ("solve", "eigen")}
    ranks, _ = spawn_world((2,), cases, {"solve": b, "eigen": b},
                           lambda: {}, run_case=_checkpoint_case)
    for got in ranks:
        s = got["solve"]
        assert s["part"] == (3, False)
        assert s["resumed"][1] and s["cold"][1] and s["pcg"]
        assert s["resumed"][0] < s["cold"][0]
        assert s["x"] < 1e-8
        assert s["error"] is not None and "needs the RHS" in s["error"]
        e = got["eigen"]
        iters, conv, lam = e["resumed"]
        assert conv and iters < e["cold"][0]
        _close(lam, e["cold"][1], rtol=1e-8, floor=0)


# ---------------------------------------------------------------------------
# debug
# ---------------------------------------------------------------------------

def test_debug_checked_catches_nan():
    def bad(x):
        y = torch.sqrt(x)          # NaN for negative input
        debug.check_finite(y, "y")
        return y

    safe = debug.checked(bad)
    assert float(safe(torch.tensor(4.0))) == 2.0
    with pytest.raises(debug.NumericError, match="torch.sqrt"):
        safe(torch.tensor(-1.0))
    with pytest.raises(debug.NumericError, match="y contains NaN"):
        debug.check_finite(torch.tensor([1.0, math.inf]), "y")


def test_debug_mode_restores_flag():
    before = debug.nans_enabled()
    with debug.debug_mode():
        assert debug.nans_enabled() is True
        assert _wrap.NAN_HOOK is not None
        with debug.debug_mode(nans=False):
            assert not debug.nans_enabled() and _wrap.NAN_HOOK is None
            torch.sqrt(torch.tensor(-1.0))          # not trapped here
        assert debug.nans_enabled()
    assert debug.nans_enabled() == before
    assert _wrap.NAN_HOOK is None


def test_debug_mode_traps_a_planted_nan():
    """A NaN in b of a k=5 solve: debug mode raises at the first operation
    that outputs it (the plain kernel versions run here); outside it the
    solve returns a NaN history, and checked() on a finite b returns the
    unchecked iterate bit for bit."""
    solver = mt.MultigridSolver(mt.poisson2d(k=5, dtype=torch.float64,
                                             smoother="rbgs", device="cpu"))
    b = solver.problem.b.clone()
    b[7, 9] = math.nan
    with pytest.raises(debug.NumericError, match="produced a NaN"):
        with debug.debug_mode():
            solver.solve(b)
    plain = solver.solve(b)            # untrapped: a NaN history, no error
    assert not plain.converged and plain.res_history.isnan().all()
    with pytest.raises(debug.NumericError, match="produced a NaN"):
        debug.checked(lambda: solver.solve(b))()
    want = solver.solve().x
    assert torch.equal(debug.checked(lambda: solver.solve().x)(), want)


def test_debug_mode_names_the_kernel(monkeypatch):
    """A launch hands NAN_HOOK the tensors it wrote: in debug mode a kernel
    whose output holds a NaN is named by its entry point; outside it the
    hook is unset and the launch does nothing more."""
    class _Stream:
        cuda_stream = 0

    def fake_launch(name, out_ptr, stream):
        out.numpy()[:] = math.nan          # the kernel's store

    out = torch.zeros(4)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: _nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: _Stream())
    monkeypatch.setattr(_build, "launch", fake_launch)
    _wrap.launch_on(out, "fake", out.data_ptr(), writes=(out,))
    with pytest.raises(debug.NumericError,
                       match="kernel mg_fake_f32 produced a NaN"):
        with debug.debug_mode():
            _wrap.launch_on(out, "fake", out.data_ptr(), writes=(out,))
    with pytest.raises(debug.NumericError, match="kernel mg_fake_f32"):
        debug.checked(lambda: _wrap.launch_on(out, "fake", out.data_ptr(),
                                              writes=(out,)))()


def test_every_launch_names_what_it_writes():
    """debug_mode sees a kernel's outputs only through launch_on's writes=:
    every launch in the kernel wrappers passes it."""
    import ast
    from pathlib import Path

    import multigridcmt_tpu_torch.kernels as kpkg

    calls = 0
    for path in sorted(Path(kpkg.__file__).parent.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "id", None) == "launch_on"):
                calls += 1
                assert any(kw.arg == "writes" for kw in node.keywords), \
                    f"{path.name}:{node.lineno} launches without writes="
    assert calls >= 20


class _nullcontext:                                         # noqa: N801
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

def test_trace_has_a_range_for_every_level(tmp_path):
    prob = mt.poisson2d(k=5, dtype=torch.float64, smoother="rbgs",
                        device="cpu")
    solver = mt.MultigridSolver(prob)
    with profiling.trace(str(tmp_path)) as prof:
        res = solver.solve()
    assert prof is not None and res.converged
    (path,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    levels = prob.hierarchy.num_levels
    assert {f"mg_level_{i}" for i in range(levels)} <= names
    assert f"mg_level_{levels}" not in names


def test_timer_fence():
    x = torch.arange(10, dtype=torch.float64)
    with profiling.Timer() as t:
        s = profiling.Timer.fence(x)
    assert s == 45.0 and t.elapsed is not None and t.elapsed >= 0


# ---------------------------------------------------------------------------
# plots
# ---------------------------------------------------------------------------

def _pixels(path):
    import matplotlib.image as mpimg

    return mpimg.imread(path)


@pytest.mark.parametrize("which", ["history", "error", "modes1d",
                                   "modes2d"])
def test_plots_match_jax_pixels(which, tmp_path):
    from multigridcmt_tpu.utils import plots as jplots

    rng = np.random.default_rng(7)
    if which == "history":
        hist = np.concatenate([np.logspace(0, -8, 9), [1e-8, 1e-8]])
        args = ({"V(2,2)": hist, "pcg": hist[::2]},)
        port_args = ({"V(2,2)": torch.from_numpy(hist), "pcg": hist[::2]},)
        call, jcall = plots.plot_residual_history, jplots.plot_residual_history
    elif which == "error":
        args = ([255, 511, 1023], [1.6e-5, 4.1e-6, 1.0e-6])
        port_args = (torch.tensor([255, 511, 1023]),
                     torch.tensor([1.6e-5, 4.1e-6, 1.0e-6]))
        call, jcall = (plots.plot_error_convergence,
                       jplots.plot_error_convergence)
    else:
        ndim = 1 if which == "modes1d" else 2
        vecs = rng.standard_normal((4,) + (15,) * ndim)
        lams = rng.random(4) * 100
        args = (vecs, 15, ndim, lams)
        port_args = (torch.from_numpy(vecs), 15, ndim, torch.from_numpy(lams))
        call, jcall = plots.plot_eigenmodes, jplots.plot_eigenmodes
    want = str(tmp_path / "jax.png")
    jcall(*args, want)
    for name, a in (("numpy", args), ("torch", port_args)):
        got = str(tmp_path / f"{name}.png")
        call(*a, got)
        np.testing.assert_array_equal(_pixels(got), _pixels(want))


def test_plot_without_matplotlib_raises(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.split(".")[0] == "matplotlib":
            raise ModuleNotFoundError(f"No module named {name!r}")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    with pytest.raises(ImportError, match="needs matplotlib"):
        plots.plot_error_convergence([1, 2], [1.0, 0.25], "never.png")
