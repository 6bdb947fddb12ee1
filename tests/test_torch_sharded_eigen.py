"""The port's sharded eigensolvers (parallel/sharded.py:
ShardedSolver.eigensolve by inverse iteration and RQI here, LOBPCG in
tests/test_torch_sharded_lobpcg.py, which reuses this file's ranks and
checks) in gloo worlds of CPU processes, a row mesh of 2 and a 2 x 2 block
mesh, float64.

Each case starts from JAX's own nested-iteration block (``v0``, JAX's
``coarse_init``) and is held against
  * JAX's ShardedSolver.eigensolve on as many of the conftest's virtual
    devices: eigenvalues rtol 1e-10, the same outer step count,
    eigenvectors up to sign (by subspace for a block) and the eigen-residual
    histories to rtol 1e-6 above a 1e-12 floor (as the single-device
    eigensolvers are held in tests/test_torch_eigen.py). JAX's interpreted
    Pallas eigensolves take 5-20 s a case, so only some cases run them
    (``ref="jax"``, PALLAS_MIN_N = KERNEL_MIN_N = 30, PACK_MIN_N = 30 for
    the packed case); the others are held against JAX's plain sharded route
    (``ref="jax-plain"``, use_pallas=False: the owned-tile cycle, the same
    mathematics), whose answers agree with the kernel route's to rounding;
  * the port's single-device eigensolve or lobpcg on the same problem (run
    in this process while the ranks run): eigenvalues rtol 1e-10 and the
    same outer step count;
  * the exact discrete spectrum: rtol 1e-9.
The ranks also count their local2d and plocal2d calls, which pins the
route: the II/RQI inner cycles on carried tiles (colour-packed when the
fine level packs) with one residual kernel a cycle as the check, LOBPCG's
preconditioner unpacked at any PACK_MIN_N, one residual a row an apply.

Mixed precision (precond_dtype=torch.bfloat16 on the whole-leg route)
is held against the full-precision run of the same ranks, not JAX's mixed
histories (the port stores the top level in float32): converged, lambda_1
within 1e-7, outer steps at most ceil(1.2 x full) + 3, JAX's own bounds
(tests/test_mixed.py: test_sharded_lobpcg_bf16_precond). A start block
computed on each rank is broadcast from the first, so ranks whose
``coarse_init`` differ (rank 1 flips its signs here, as another LAPACK
build may) still start alike. Spawned by tests/test_torch_sharded.py's
spawn_world; the ranks import torch and the port only.
"""
import math

import numpy as np
import pytest
import torch
import torch.distributed as dist

from multigridcmt_tpu_torch import kernels
from multigridcmt_tpu_torch.config import SolverConfig
from multigridcmt_tpu_torch.parallel import sharded
from test_torch_sharded import KERNEL_MIN_N, PACK_MIN_N, _jax_mesh, \
    spawn_world

TOL = 1e-9
BASE = dict(dtype=torch.float64, agglom_rows=4, use_kernels=True,
            smoother="rbgs")
# world -> (mesh shape, {case: settings}): grid k, method, block (the
# eigenpairs asked for), config overrides (nu1, nu2), and
#   ref: "jax" (JAX's sharded eigensolve, Pallas in interpret mode),
#     "jax-plain" (JAX's plain sharded route) or "single" (the port's
#     single-device solve only);
#   pack: PACK_MIN_N = 30 on both sides (the fine level packs);
#   mixed: the run with precond_dtype=torch.bfloat16 beside the full one;
#   coarse: start from each rank's coarse_init (rank 1's signs flipped)
#     instead of JAX's block;
#   inner: inner_cycles of II (default 30, which at float64 the inner
#     solves always run: 200 eps sits under the residual's rounding floor;
#     10 cycles reach ~1e-10 and take the same outer steps; RQI's shifted
#     inner solves need more, and stall at 15).
WORLDS = {
    "rows2": ((2,), {
        "ii3": dict(k=6, method="ii", block=3, ref="jax-plain", inner=10),
        "rqi1": dict(k=6, method="rqi", block=1),
        # m = 128 rows a rank: the 255 level packs (plocal2d).
        "packed-ii": dict(k=8, method="ii", block=1, pack=True, inner=10),
        # V(4,4) exceeds the legs' sweep caps: the owned-tile route (the
        # local2d sweeps), where precond_dtype is ignored.
        "owned-rqi": dict(k=6, method="rqi", block=1, nu1=4, nu2=4,
                          ref="jax-plain", mixed=True),
        "mixed-ii": dict(k=6, method="ii", block=1, ref="single",
                         mixed=True, inner=10),
    }),
    "block2x2": ((2, 2), {"ii1": dict(k=6, method="ii", block=1,
                                      inner=10)}),
}
SETTINGS = ("k", "method", "block", "ref", "pack", "mixed", "coarse",
            "inner")
COUNTED = ("down_leg", "up_leg", "residual", "rbgs_sweep")


def _config_kw(kw):
    return {k: v for k, v in kw.items() if k not in SETTINGS}


def _inner(kw):
    return {"inner_cycles": kw["inner"]} if "inner" in kw else {}


def _jax_start(kw):
    """JAX's nested-iteration start block of a case."""
    import jax.numpy as jnp

    import multigridcmt_tpu as jmg
    from multigridcmt_tpu.solvers import eigen as jeigen

    prob = jmg.poisson2d(k=kw["k"], dtype=jnp.float64, smoother="rbgs")
    return np.array(jeigen.coarse_init(prob.hierarchy, kw["block"],
                                       jnp.float64))


# ---------------------------------------------------------------------------
# Rank side (torch and the port only)
# ---------------------------------------------------------------------------

def _spy(mod, name, calls):
    fn = getattr(mod, name)

    def wrapper(x, *args, **kwargs):
        calls.append((mod.__name__.split(".")[-1], name, args[1]
                      if name != "up_leg" else args[2], str(x.dtype)))
        return fn(x, *args, **kwargs)
    return wrapper


def _run_case(mesh, kw, v0):
    """The case's sharded eigensolve (and, with ``mixed``, the
    bfloat16-preconditioned one) and the calls of the local2d and plocal2d
    kernels in the full run."""
    from multigridcmt_tpu_torch.kernels import local2d, plocal2d
    from multigridcmt_tpu_torch.solvers import eigen

    saved, saved_init = kernels.PACK_MIN_N, eigen.coarse_init
    if kw.get("pack"):
        kernels.PACK_MIN_N = PACK_MIN_N
    if kw.get("coarse") and dist.get_rank() == 1:
        eigen.coarse_init = lambda *args: -saved_init(*args)
    originals = [(mod, f, getattr(mod, f)) for mod in (local2d, plocal2d)
                 for f in COUNTED if hasattr(mod, f)]
    start = None if kw.get("coarse") else v0
    args = dict(k=kw["block"], method=kw["method"], tol=TOL, v0=start,
                **_inner(kw))
    out = {}
    try:
        for pd in ((None, torch.bfloat16) if kw.get("mixed") else (None,)):
            cfg = SolverConfig(ndim=2, k=kw["k"], precond_dtype=pd, **BASE,
                               **_config_kw(kw))
            s = sharded.ShardedSolver(cfg, mesh)
            calls = []
            for mod, f, fn in originals:
                setattr(mod, f, _spy(mod, f, calls))
            try:
                res = s.eigensolve(**args)
            finally:
                for mod, f, fn in originals:
                    setattr(mod, f, fn)
            out["mixed" if pd is not None else "full"] = {
                "lam": res.eigenvalues, "vecs": res.eigenvectors,
                "iters": res.iters, "hist": res.res_history,
                "converged": res.converged, "calls": calls,
                "n": s.hierarchy.fine.n,
                "pd": sharded.mixed_leg_dtype(cfg, s.decomp),
                "leg0": sharded._leg_level_ok(cfg, s.decomp, 0),
                "pack0": sharded._pack_level_ok(cfg, s.decomp, 0)}
    finally:
        kernels.PACK_MIN_N = saved
        eigen.coarse_init = saved_init
    return out


# ---------------------------------------------------------------------------
# Test side
# ---------------------------------------------------------------------------

def _jax_eigen(shape, kw, v0):
    """JAX's ShardedSolver.eigensolve of one case."""
    import jax.numpy as jnp

    from multigridcmt_tpu import kernels as jkernels
    from multigridcmt_tpu.config import SolverConfig as JConfig
    from multigridcmt_tpu.parallel import sharded as jsharded

    pallas = kw.get("ref", "jax") == "jax"
    cfg = JConfig(ndim=2, k=kw["k"], dtype=jnp.float64, agglom_rows=4,
                  smoother="rbgs", use_pallas=pallas, **_config_kw(kw))
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jkernels, "PALLAS_MIN_N", KERNEL_MIN_N)
        if kw.get("pack"):
            patch.setattr(jkernels, "PACK_MIN_N", PACK_MIN_N)
        solver = jsharded.ShardedSolver(cfg, _jax_mesh(shape))
        assert jsharded._pack_level_ok(cfg, solver.decomp, 0) == (
            pallas and bool(kw.get("pack")))
        return solver.eigensolve(k=kw["block"], method=kw["method"],
                                 tol=TOL, v0=jnp.asarray(v0), **_inner(kw))


def _single(kw, v0):
    """The port's single-device solve of one case, from the start the
    ranks take."""
    import multigridcmt_tpu_torch as mt

    prob = mt.poisson2d(k=kw["k"], device="cpu", **BASE, **_config_kw(kw))
    start = None if kw.get("coarse") else torch.as_tensor(v0)
    return mt.MultigridSolver(prob).eigensolve(
        k=kw["block"], method=kw["method"], tol=TOL, v0=start, **_inner(kw))


def _references(shape, cases, inputs):
    """case -> (JAX's sharded run or None, the port's single-device run)."""
    return {name: (_jax_eigen(shape, kw, inputs[name])
                   if kw.get("ref", "jax") != "single" else None,
                   _single(kw, inputs[name]))
            for name, kw in cases.items()}


def cases_of(worlds):
    return [(w, c) for w, (_, cases) in worlds.items() for c in cases]


def world_getter(worlds):
    """world -> (per-rank results, per-case references), each world of
    ``worlds`` spawned on first use; the references run while the ranks
    do."""
    cache = {}

    def get(world):
        if world not in cache:
            shape, cases = worlds[world]
            inputs = {name: _jax_start(kw) for name, kw in cases.items()}
            cache[world] = spawn_world(
                shape, cases, inputs,
                lambda: _references(shape, cases, inputs),
                run_case=_run_case)
        return cache[world]

    return get


@pytest.fixture(scope="module")
def world_results():
    return world_getter(WORLDS)


def _flat(v):
    v = np.asarray(v)
    return v[:, 1:-1, 1:-1].reshape(v.shape[0], -1)


def _same_vectors(got, want, atol):
    """Rows equal up to sign (one vector), or spanning the same subspace
    (a degenerate pair's basis is the LAPACK build's)."""
    g, w = _flat(got), _flat(want)
    if g.shape[0] == 1:
        sign = np.sign(np.vdot(g[0], w[0]))
        np.testing.assert_allclose(sign * g[0], w[0], rtol=0, atol=atol)
        return
    qg, _ = np.linalg.qr(g.T)
    qw, _ = np.linalg.qr(w.T)
    s = np.linalg.svd(qg.T @ qw, compute_uv=False)
    np.testing.assert_allclose(s, np.ones_like(s), rtol=0, atol=atol)


def _exact(k, block):
    from multigridcmt_tpu_torch.ops import laplacian

    n = 2 ** k - 1
    h = 1.0 / (n + 1)
    return sorted(laplacian.eigenvalue_2d(a, b, n, h)
                  for a, b in ((1, 1), (1, 2), (2, 1)))[:block]


def _check_route(run, kw):
    """The kernels each part of the solve ran, counted on one rank: every
    fine-level call is a residual (the inner check, the applies) or a leg
    (the cycles); no bfloat16 outside a mixed run's fine legs."""
    n, block, it = run["n"], kw["block"], run["iters"]
    calls = [c for c in run["calls"] if c[2] == n]
    count = {key: sum(1 for c in calls if c[:2] == key)
             for key in {c[:2] for c in calls}}
    if kw["method"] == "lobpcg":
        # rq_res: 2 applies a step of k rows, iteration 0 included; rr:
        # 2k rows at iteration 0, 3k at each later step. One
        # preconditioning cycle a row a step, unpacked at any PACK_MIN_N.
        applies = block * (5 * it - 1)
    else:
        # rayleigh before the first step and after each; ritz each step.
        applies = block * (2 * it + 1)
    if not run["leg0"]:
        # The owned-tile route: the local2d sweeps, the residual as the
        # check and the applies (the down leg's residual is the sweeps').
        assert count.get(("local2d", "down_leg"), 0) == 0
        assert count.get(("local2d", "rbgs_sweep"), 0) > 0
        return
    if kw["method"] == "lobpcg":
        cyc = block * it
        assert count.get(("local2d", "down_leg"), 0) == cyc
        assert count.get(("local2d", "up_leg"), 0) == cyc
        assert count.get(("local2d", "residual"), 0) == applies
        assert not any(c[0] == "plocal2d" for c in calls)
        return
    fine = "plocal2d" if run["pack0"] else "local2d"
    cyc = count.get((fine, "down_leg"), 0)
    assert cyc > 0 and count.get((fine, "up_leg"), 0) == cyc
    checks = count.get((fine, "residual"), 0)
    if fine == "plocal2d":
        assert checks == cyc
        assert count.get(("local2d", "residual"), 0) == applies
    else:
        assert checks == cyc + applies


def check_case(ranks, refs, kw, case):
    """A case's ranks against JAX's run and the port's single-device run
    (``refs[case]``), the exact spectrum and, for ``mixed``, the
    full-precision run (module docstring)."""
    got = [r[case]["full"] for r in ranks]
    # Every rank ends with the same eigenpairs and history.
    for g in got[1:]:
        for key in ("lam", "vecs", "hist"):
            assert torch.equal(g[key], got[0][key])
        assert g["iters"] == got[0]["iters"]
    g = got[0]
    assert g["converged"]
    assert g["pack0"] == bool(kw.get("pack"))
    assert g["leg0"] == (kw.get("nu1", 2) <= 3)
    assert g["vecs"].shape == (kw["block"],) + (2 ** kw["k"] + 1,) * 2
    ghosts = g["vecs"].clone()
    ghosts[:, 1:-1, 1:-1] = 0
    assert not ghosts.any()
    _check_route(g, kw)
    lam = g["lam"].numpy()
    np.testing.assert_allclose(lam, _exact(kw["k"], kw["block"]), rtol=1e-9)
    want, one = refs[case]
    assert g["iters"] == one.iters
    np.testing.assert_allclose(lam, one.eigenvalues.numpy(), rtol=1e-10)
    if kw.get("mixed"):
        m = ranks[0][case]["mixed"]
        assert m["converged"]
        assert m["pd"] == (torch.bfloat16 if g["leg0"] else None)
        assert m["iters"] <= math.ceil(1.2 * g["iters"]) + 3
        assert abs(m["lam"][0].item() - lam[0]) / lam[0] < 1e-7
        bf16 = [c for c in m["calls"] if c[3] == "torch.bfloat16"]
        if g["leg0"]:
            # Each cycle's fine level: a bfloat16 down and up leg.
            assert bf16 and all(c[1] in ("down_leg", "up_leg")
                                and c[2] == g["n"] for c in bf16)
        else:
            # precond_dtype is ignored off the whole-leg route.
            assert not bf16
            assert torch.equal(m["lam"], g["lam"])
    if kw.get("coarse"):
        # Rank 1's flipped coarse_init was overridden by rank 0's block:
        # the ranks agree, and with the run from JAX's block (rows2's
        # lobpcg1) up to sign.
        base = ranks[0]["lobpcg1"]["full"]
        np.testing.assert_allclose(lam, base["lam"].numpy(), rtol=1e-12)
        _same_vectors(g["vecs"].numpy(), base["vecs"].numpy(), atol=1e-9)
    if want is None:
        return
    assert g["iters"] == int(want.iters)
    assert g["converged"] == bool(want.converged)
    np.testing.assert_allclose(lam, np.asarray(want.eigenvalues), rtol=1e-10)
    np.testing.assert_allclose(g["hist"].numpy(),
                               np.asarray(want.res_history), rtol=1e-6,
                               atol=1e-12)
    _same_vectors(g["vecs"].numpy(), np.asarray(want.eigenvectors),
                  atol=1e-8)


@pytest.mark.parametrize("world,case", cases_of(WORLDS),
                         ids=[f"{w}-{c}" for w, c in cases_of(WORLDS)])
def test_sharded_eigensolve_matches_jax(world, case, world_results):
    ranks, refs = world_results(world)
    check_case(ranks, refs, WORLDS[world][1][case], case)


def test_unknown_method_raises(tmp_path):
    """Any method but "ii", "rqi" and "lobpcg" raises ValueError."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        s = sharded.ShardedSolver(SolverConfig(ndim=2, k=5, agglom_rows=4),
                                  sharded.make_mesh(device="cpu"))
        with pytest.raises(ValueError, match="unknown eigensolver"):
            s.eigensolve(method="arnoldi")
    finally:
        dist.destroy_process_group()
