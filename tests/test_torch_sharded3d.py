"""The port's sharded 3D solver (ShardedSolver with ndim=3 on slab and pencil
meshes: multigridcmt_tpu_torch/parallel/sharded.py's _slab3d_level and the
stagewise slab route) in gloo worlds of CPU processes, against the JAX
ShardedSolver on as many of the conftest's virtual devices, float64.

The ranks lower KERNEL3_MIN_N to 10, as the JAX package's own slab tests
lower PALLAS3_MIN_N, so the 31 and 63 levels run the stencil3d wrappers
(their plain versions, on CPU tensors). JAX's interpreted slab kernels take
~20 s a solve, so one slab case holds the port against JAX's kernel route
(use_pallas=True) and the others against JAX's plain sharded route, which
equals it to rounding. Tolerances are JAX's own (tests/test_sharded_pallas.py):
iterations equal, histories rtol 1e-6 / atol 1e-11, x rtol 1e-8 / atol
1e-12 (pencils 1e-11). A spy on the stencil3d wrappers records every call:
which ranks called which wrapper with which stack shape, (goff, roff) and
sweeps, held against JAX's formulas (goff = d m + 1 - hz, roff the same on
rows). Spawned by tests/test_torch_sharded.py's spawn_world; the ranks
import torch and the port only.
"""
import collections

import numpy as np
import pytest
import torch

from multigridcmt_tpu_torch import kernels
from multigridcmt_tpu_torch.config import SolverConfig
from multigridcmt_tpu_torch.parallel import sharded
from test_torch_sharded import _jax_mesh, spawn_world

KERNEL3_MIN_N = 10
WRAPPERS = ("residual", "rbgs_sweep", "jacobi_sweep")
SETTINGS = ("method", "ref", "pallas", "chain")
# world -> (mesh shape, {case: settings}). A case's settings are config
# overrides and
#   method: "mg" (default), "pcg" or "eigen" (inverse iteration, k=1);
#   ref: "jax" (default), JAX's ShardedSolver; "exact", the exact discrete
#     eigenvalue (JAX's test_3d_plane_eigensolve);
#   pallas: JAX on its kernel route (use_pallas=True);
#   chain: also two cycles by v_cycles_fn and by v_cycle_fn twice, against
#     JAX's v_cycles_fn.
WORLDS = {
    # m = 4 planes a rank: the stagewise route (the tile is shallower than
    # the level's 5 ghost planes).
    "slab8": ((8,), {"rbgs-k5": dict(k=5, smoother="rbgs", agglom_rows=2,
                                     pallas=True),
                     # No post-smoothing on the stagewise route: JAX's
                     # kernel route takes a neighbour's tile there
                     # (ROADMAP.md queue 3, F6), its plain route does not.
                     "rbgs-v20-k5": dict(k=5, smoother="rbgs", nu1=2, nu2=0,
                                         agglom_rows=2)}),
    "slab4": ((4,), {
        # m = 16, 8: the extended-stack level twice, then 4 (stagewise).
        "rbgs-k6": dict(k=6, smoother="rbgs", agglom_rows=2, chain=True),
        # Jacobi's 3 ghost planes: the extended-stack level on m = 4 too.
        "jacobi-k6": dict(k=6, smoother="jacobi", agglom_rows=2),
        "pcg-k5": dict(k=5, smoother="rbgs", agglom_rows=2, method="pcg"),
        "fmg-k5": dict(k=5, smoother="rbgs", agglom_rows=2, cycle="fmg"),
        "eigen-k4": dict(k=4, smoother="rbgs", agglom_rows=2, method="eigen",
                         ref="exact"),
    }),
    "pencil2x2": ((2, 2), {
        "rbgs-k5": dict(k=5, smoother="rbgs", agglom_rows=4),
        "jacobi-w-k5": dict(k=5, smoother="jacobi", agglom_rows=4,
                            cycle="w"),
    }),
}
CASES = [(w, c) for w, (_, cases) in WORLDS.items() for c in cases]
TOL = 1e-9
EIGEN_TOL = 1e-9


def _config_kw(kw):
    return {k: v for k, v in kw.items() if k not in SETTINGS}


# ---------------------------------------------------------------------------
# Rank side (torch and the port only)
# ---------------------------------------------------------------------------

def _spy(name, fn, calls):
    def wrapper(u, b, n, h, *args, **kwargs):
        calls.append((name, tuple(u.shape), kwargs.get("goff", 0),
                      kwargs.get("roff", 0), kwargs.get("sweeps"),
                      str(u.dtype), str(kwargs.get("out_dtype"))))
        return fn(u, b, n, h, *args, **kwargs)
    return wrapper


def _run_case(mesh, kw, b):
    """One case on the mesh with the stencil3d wrappers spied on, and the
    port's single-device references."""
    import multigridcmt_tpu_torch as mt
    from multigridcmt_tpu_torch.kernels import stencil3d

    cfg_kw = _config_kw(kw)
    method = kw.get("method", "mg")
    saved = kernels.KERNEL3_MIN_N
    originals = {f: getattr(stencil3d, f) for f in WRAPPERS}
    calls = []
    try:
        kernels.KERNEL3_MIN_N = KERNEL3_MIN_N
        for f, fn in originals.items():
            setattr(stencil3d, f, _spy(f, fn, calls))
        cfg = SolverConfig(ndim=3, dtype=torch.float64, tol=TOL,
                           use_kernels=True, **cfg_kw)
        s = sharded.ShardedSolver(cfg, mesh)
        if method == "eigen":
            res = s.eigensolve(k=1, method="ii", tol=EIGEN_TOL)
            got = {"lam": res.eigenvalues, "iters": res.iters,
                   "converged": res.converged, "vec": res.eigenvectors}
        else:
            res = s.solve(b, method=method)
            got = {"x": res.x, "tile": sharded.shard_rhs(res.x, mesh, s.decomp),
                   "hist": res.res_history, "iters": res.iters,
                   "converged": res.converged}
        got["calls"] = list(calls)
        if kw.get("chain"):
            bt = sharded.shard_rhs(b, mesh, s.decomp)
            x0 = torch.zeros_like(bt)
            one = s.v_cycle_fn()
            got["chain"] = (s.v_cycles_fn()(x0, bt, 2),
                            one(one(x0, bt), bt))
        for f, fn in originals.items():
            setattr(stencil3d, f, fn)
        if method == "eigen":
            prob = mt.poisson3d(device="cpu", dtype=torch.float64,
                                use_kernels=True, **cfg_kw)
            ref = mt.MultigridSolver(prob).eigensolve(k=1, method="ii",
                                                      tol=EIGEN_TOL)
            got["single"] = {"lam": ref.eigenvalues, "iters": ref.iters}
    finally:
        for f, fn in originals.items():
            setattr(stencil3d, f, fn)
        kernels.KERNEL3_MIN_N = saved
    return got


# ---------------------------------------------------------------------------
# Test side
# ---------------------------------------------------------------------------

def _jax_rhs(kw):
    import jax.numpy as jnp

    import multigridcmt_tpu as jmg

    return np.asarray(jmg.poisson3d(k=kw["k"], dtype=jnp.float64).b)


def _jax_case(shape, kw, b):
    """JAX's ShardedSolver on the virtual devices: the solve, and for a
    chain case its v_cycles_fn after two cycles from zero."""
    import jax.numpy as jnp

    from multigridcmt_tpu import kernels as jkernels
    from multigridcmt_tpu.config import SolverConfig as JConfig
    from multigridcmt_tpu.parallel import sharded as jsharded

    pallas = bool(kw.get("pallas"))
    cfg = JConfig(ndim=3, dtype=jnp.float64, tol=TOL, use_pallas=pallas,
                  **_config_kw(kw))
    jmesh = _jax_mesh(shape)
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jkernels, "PALLAS3_MIN_N", KERNEL3_MIN_N)
        solver = jsharded.ShardedSolver(cfg, jmesh)
        if pallas:
            xt = jnp.zeros((2 ** cfg.k // shape[0], cfg.n + 2, cfg.n + 2))
            assert jsharded._slab3d_ok(xt, cfg.n, cfg.smoother,
                                       solver.decomp, 4)
        res = solver.solve(b, method=kw.get("method", "mg"))
        chain = None
        if kw.get("chain"):
            bt = jsharded.shard_rhs(b, jmesh)
            chain = np.asarray(solver.v_cycles_fn()(jnp.zeros_like(bt), bt,
                                                    2))
    return res, chain, jmesh


@pytest.fixture(scope="module")
def world_results():
    """world -> (per-rank results, per-case JAX references), each world
    spawned on first use; the JAX runs go while the ranks do."""
    cache = {}

    def get(world):
        if world not in cache:
            shape, cases = WORLDS[world]
            inputs = {name: _jax_rhs(kw) for name, kw in cases.items()}
            cache[world] = spawn_world(
                shape, cases, inputs,
                lambda: {name: _jax_case(shape, kw, inputs[name])
                         for name, kw in cases.items()
                         if kw.get("ref", "jax") == "jax"},
                run_case=_run_case)
        return cache[world]

    return get


def _decomp(shape):
    return sharded.Decomp(ndim=3, axes=tuple(
        (a, f"ax{a}", d) for a, d in enumerate(shape)))


def _stale(kind, sweeps):
    return 2 * sweeps if kind == "rbgs" else sweeps


def _want_calls(kw, shape, coords, iters):
    """The stencil3d calls a V-cycle solve by cycles makes on the rank at
    ``coords``, by JAX's routing and offsets: per kernel level (n >= 10,
    sharded, not the coarsest) the extended-stack level where the tile holds
    hz = max(2 nu1 + 1, 2 nu2) (Jacobi max(nu1 + 1, nu2)) ghost planes (and
    rows on a pencil mesh), goff = d0 m0 + 1 - hz, roff = d1 m1 + 1 - hz
    (0 on slabs); else on slabs the stagewise stacks (smoothing: hz its
    staleness; the down pair: one plane more; the residual: 1 plane, goff
    = d0 m0); on pencils plain. The solve's check is the slab residual
    kernel (1 plane) before the first cycle and after each."""
    k, kind = kw["k"], kw["smoother"]
    nu1, nu2 = kw.get("nu1", 2), kw.get("nu2", 2)
    fn = kind + "_sweep"
    pencil = len(shape) == 2
    want = collections.Counter()
    levels = k - 1                      # the hierarchy's levels are k - 1
    for lv in range(levels - 1):
        n = 2 ** (k - lv) - 1
        rows = 2 ** (k - lv)
        ms = [rows // d for d in shape]
        if (n < KERNEL3_MIN_N
                or any(m < max(kw["agglom_rows"], 2) for m in ms)):
            continue
        m0 = ms[0]
        hz = (max(2 * nu1 + 1, 2 * nu2) if kind == "rbgs"
              else max(nu1 + 1, nu2))
        goff = lambda h: coords[0] * m0 + 1 - h            # noqa: E731
        if m0 >= max(hz, 3) and (not pencil or ms[1] >= hz):
            if pencil:
                stack = (m0 + 2 * hz, ms[1] + 2 * hz, n + 2)
                roff = coords[1] * ms[1] + 1 - hz
            else:
                stack, roff = (m0 + 2 * hz, n + 2, n + 2), 0
            for name, sw in ((fn, nu1), (fn, nu2), ("residual", None)):
                want[(name, stack, goff(hz), roff, sw)] += iters
            continue
        if pencil:
            continue
        h1 = _stale(kind, nu1)
        if m0 >= max(h1 + 1, 3):
            stack = (m0 + 2 * h1 + 2, n + 2, n + 2)
            want[(fn, stack, goff(h1 + 1), 0, nu1)] += iters
            want[("residual", stack, goff(h1 + 1), 0, None)] += iters
        else:
            if m0 >= max(h1, 3):
                want[(fn, (m0 + 2 * h1, n + 2, n + 2), goff(h1), 0, nu1)] \
                    += iters
            if m0 >= 3:
                want[("residual", (m0 + 2, n + 2, n + 2), goff(1), 0,
                      None)] += iters
        h2 = _stale(kind, nu2)
        if nu2 and m0 >= max(h2, 3):
            want[(fn, (m0 + 2 * h2, n + 2, n + 2), goff(h2), 0, nu2)] += iters
    n, m0 = 2 ** k - 1, 2 ** k // shape[0]
    if not pencil and n >= KERNEL3_MIN_N and m0 >= 3:
        want[("residual", (m0 + 2, n + 2, n + 2), coords[0] * m0, 0, None)] \
            += iters + 1
    return want


def _check_route(world, case, ranks):
    shape, cases = WORLDS[world]
    kw = cases[case]
    for r in ranks:
        g = r[case]
        assert g["calls"], "no stencil3d call"
        # float64 throughout, no float32 store.
        assert {c[5:] for c in g["calls"]} == {("torch.float64", "None")}
        got = collections.Counter(c[:5] for c in g["calls"])
        if kw.get("method", "mg") == "mg" and kw.get("cycle", "v") == "v":
            assert got == _want_calls(kw, shape, r["coords"], g["iters"])
        else:
            # Other solve loops visit the levels in other numbers: the same
            # stacks and offsets (the eigensolve's applies, PCG's: the
            # check's slab residual).
            want = set(_want_calls(kw, shape, r["coords"], 1))
            assert set(got) == want


@pytest.mark.parametrize("world,case", CASES,
                         ids=[f"{w}-{c}" for w, c in CASES])
def test_sharded3d_matches_jax(world, case, world_results):
    from multigridcmt_tpu_torch import convert

    ranks, refs = world_results(world)
    shape, cases = WORLDS[world]
    kw = cases[case]
    got = [r[case] for r in ranks]
    _check_route(world, case, ranks)
    if kw.get("method") == "eigen":
        # JAX's test_3d_plane_eigensolve: lambda_1 against the exact
        # discrete value; the same outer steps as the port's single-device
        # eigensolve, every rank the same pair.
        from multigridcmt_tpu_torch.ops import laplacian

        n = 2 ** kw["k"] - 1
        want = laplacian.eigenvalue_3d(1, 1, 1, n, 1.0 / (n + 1))
        for g in got:
            assert g["converged"]
            assert torch.equal(g["lam"], got[0]["lam"])
            assert torch.equal(g["vec"], got[0]["vec"])
            np.testing.assert_allclose(g["lam"][0].item(), want, rtol=1e-9)
        assert got[0]["iters"] == got[0]["single"]["iters"]
        return
    for g in got[1:]:
        assert torch.equal(g["x"], got[0]["x"])
        assert torch.equal(g["hist"], got[0]["hist"])
    g = got[0]
    assert g["converged"]
    want, chain, jmesh = refs[case]
    assert g["iters"] == int(want.iters)
    np.testing.assert_allclose(g["hist"].numpy(),
                               np.asarray(want.res_history), rtol=1e-6,
                               atol=1e-11)
    atol = 1e-11 if len(shape) == 2 else 1e-12
    jx = np.asarray(want.x)
    np.testing.assert_allclose(g["x"].numpy(), jx, rtol=1e-8, atol=atol)
    from multigridcmt_tpu.parallel import sharded as jsharded

    jtiles = jsharded.shard_rhs(jx, jmesh)
    for r in ranks:
        want_tile = convert.tile_from_jax(jtiles, _decomp(shape), r["coords"],
                                          device="cpu")
        np.testing.assert_allclose(r[case]["tile"].numpy(),
                                   want_tile.numpy(), rtol=1e-8, atol=atol)
    if kw.get("chain"):
        for r in ranks:
            many, twice = r[case]["chain"]
            assert torch.equal(many, twice)
            want_tile = convert.tile_from_jax(chain, _decomp(shape),
                                              r["coords"], device="cpu")
            np.testing.assert_allclose(many.numpy(), want_tile.numpy(),
                                       rtol=1e-8, atol=atol)
