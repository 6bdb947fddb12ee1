"""The port's sharded solver (multigridcmt_tpu_torch/parallel/sharded.py) in
gloo worlds of CPU processes, against the JAX ShardedSolver on the same
number of the conftest's virtual devices (Pallas kernels in interpret mode,
PALLAS_MIN_N = 30; the port's ranks set KERNEL_MIN_N = 30 to match, and
their local2d and plocal2d wrappers take the plain versions on CPU
tensors).

Each world is spawned once and runs several cases; its ranks import torch
and the port only (this module imports JAX inside its fixtures). Ranks talk
over the loopback interface, and a world that does not finish in time is
killed and fails its tests.

The packed cases set PACK_MIN_N = 30 on both sides at k = 8, so the 255
level is colour-packed (plocal2d). At m = 128 owned rows the JAX packed
norm counts a window's overlap rows twice (ROADMAP.md queue 3, F1): there
the packed iterates are held against JAX's v_cycles_fn, cycle by cycle,
and the packed solve's history against the port's single-device packed
solve; JAX's packed history is compared only at m = 64.
"""
import os
import pickle
import tempfile
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from multigridcmt_tpu_torch import kernels
from multigridcmt_tpu_torch.config import SolverConfig
from multigridcmt_tpu_torch.kernels import local2d
from multigridcmt_tpu_torch.parallel import sharded

KERNEL_MIN_N = 30
PACK_MIN_N = 30
WORLD_TIMEOUT_S = 300
BASE = dict(dtype=torch.float64, tol=1e-9, agglom_rows=4, use_kernels=True)
LEG_FUNCS = ("down_leg", "up_leg", "rbgs_sweep", "jacobi_sweep", "residual")
PACKED_FUNCS = ("down_leg", "up_leg", "residual", "apply_op",
                "residual_norm_sq")
# Cycles chained by v_cycles_fn in the "chain" cases.
CHAIN = (1, 2, 3)

# world -> (mesh shape, {case: settings}). A case's settings are config
# overrides and
#   pack: PACK_MIN_N on both sides (the fine level packs);
#   method: "mg" (default) or "pcg";
#   ref: what the case is held against: "jax" (default), JAX's
#     ShardedSolver.solve; "single", the port's single-device solve
#     (cycles.solve); "chain", the port's single-device solve and, after
#     each of CHAIN cycles, JAX's v_cycles_fn iterates; "jax-x", JAX's
#     solve without its history (F1 at m = 128) and the port's
#     single-device solve's history.
WORLDS = {
    # m = 32 rows a rank at k=6: one interior boundary.
    "rows2": ((2,), {
        "rbgs": dict(k=6, smoother="rbgs"),
        # m = 128: several plocal2d blocks and JAX windows a tile.
        "packed": dict(k=8, smoother="rbgs", pack=True, ref="chain"),
        "packed-pcg": dict(k=8, smoother="rbgs", pack=True, method="pcg"),
        # PCG on the unpacked extended tiles (local2d).
        "pcg-ext": dict(k=6, smoother="rbgs", method="pcg"),
    }),
    "rows4": ((4,), {
        # The composed route: V(4,4) exceeds the down leg's sweep cap.
        "rbgs-v44": dict(k=6, smoother="rbgs", nu1=4, nu2=4),
        "single-k7": dict(k=7, smoother="rbgs", ref="single"),
        # Two leg levels, so the second visit of level 1 takes stale ghosts
        # (only the first coarse visit is fresh): against JAX, and against
        # the port's single-device W-cycle.
        "rbgs-w": dict(k=6, smoother="rbgs", cycle="w"),
        "single-w": dict(k=6, smoother="rbgs", cycle="w", ref="single"),
        # m = 64: one JAX window, whose packed norm is exact.
        "packed-m64": dict(k=8, smoother="rbgs", pack=True),
        # PCG on owned tiles (the composed route).
        "pcg-owned": dict(k=6, smoother="rbgs", nu1=4, nu2=4,
                          method="pcg"),
    }),
    # m = 8 rows a rank at k=6, the least a leg level takes; level 1 (m=4)
    # runs the owned-tile route and its coarse tile is extended with
    # zero-filled two-hop ghosts.
    "rows8": ((8,), {"rbgs-m8": dict(k=6, smoother="rbgs")}),
    "block2x2": ((2, 2), {
        "rbgs": dict(k=6, smoother="rbgs"),
        "chebyshev": dict(k=6, smoother="chebyshev"),
        # The other packing phase (odd column offset), m = mcol = 128.
        "packed": dict(k=8, smoother="rbgs", pack=True, ref="jax-x"),
        "packed-jacobi-pcg": dict(k=8, smoother="jacobi", pack=True,
                                  method="pcg"),
    }),
    "block4x2": ((4, 2), {"jacobi": dict(k=6, smoother="jacobi")}),
}
# Worlds whose ranks check the packed ghost refresh.
REFRESH_WORLDS = ("rows2", "block2x2")
SETTINGS = ("pack", "method", "ref")


def _config_kw(kw):
    return {k: v for k, v in kw.items() if k not in SETTINGS}


CASES = [(w, c) for w, (_, cases) in WORLDS.items() for c in cases]


# ---------------------------------------------------------------------------
# Rank side (torch and the port only)
# ---------------------------------------------------------------------------

def _counting(module, name, calls):
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        calls[name] += 1
        return fn(*args, **kwargs)
    return wrapper


def _run_case(mesh, kw, b):
    """Solve one case on the mesh (counting the local2d and plocal2d
    calls), with its references on the port's side."""
    import multigridcmt_tpu_torch as mt
    from multigridcmt_tpu_torch.kernels import plocal2d

    cfg_kw = _config_kw(kw)
    ref = kw.get("ref", "jax")
    saved = kernels.PACK_MIN_N
    if kw.get("pack"):
        kernels.PACK_MIN_N = PACK_MIN_N
    counted = [(local2d, LEG_FUNCS, dict.fromkeys(LEG_FUNCS, 0)),
               (plocal2d, PACKED_FUNCS, dict.fromkeys(PACKED_FUNCS, 0))]
    originals = [(mod, f, getattr(mod, f)) for mod, fs, _ in counted
                 for f in fs]
    try:
        for mod, fs, calls in counted:
            for f in fs:
                setattr(mod, f, _counting(mod, f, calls))
        cfg = SolverConfig(ndim=2, **BASE, **cfg_kw)
        s = sharded.ShardedSolver(cfg, mesh)
        res = s.solve(b, method=kw.get("method", "mg"))
        got = {"x": res.x, "tile": sharded.shard_rhs(res.x, mesh, s.decomp),
               "hist": res.res_history, "iters": res.iters,
               "converged": res.converged, "calls": counted[0][2],
               "pcalls": counted[1][2],
               "leg0": sharded._leg_level_ok(cfg, s.decomp, 0),
               "pack0": sharded._pack_level_ok(cfg, s.decomp, 0)}
        if ref in ("single", "chain", "jax-x"):
            prob = mt.poisson2d(device="cpu", **BASE, **cfg_kw)
            one = mt.solve(prob.hierarchy, b, cfg)
            got["single"] = {"x": one.x, "hist": one.res_history,
                             "iters": one.iters}
        if ref == "chain":
            many = s.v_cycles_fn()
            bt = sharded.shard_rhs(b, mesh, s.decomp)
            got["chain"] = {m: many(torch.zeros_like(bt), bt, m)
                            for m in CHAIN}
    finally:
        for mod, f, fn in originals:
            setattr(mod, f, fn)
        kernels.PACK_MIN_N = saved
    return got


def _refresh_check(mesh, grid):
    """(packed refresh, packed form of the unpacked refresh, unpacked
    refresh, the exactly extended tile) of this rank's extended tile of
    ``grid`` whose ghost slabs were overwritten."""
    from multigridcmt_tpu_torch.kernels import plocal2d

    decomp = sharded.decomp_from_mesh(mesh, 2)
    hh = local2d.HALO_ROWS
    u = sharded.shard_rhs(grid, mesh, decomp)
    ue = sharded._ext_tile(u, decomp, hh)
    _, _, owned = sharded._local_offsets(u, decomp, hh)
    junk = ue + 7.0 * (dist.get_rank() + 1)
    junk[owned] = ue[owned]
    ms = tuple(u.shape[a] for a, _, _ in decomp.axes)
    cpar = sharded._cpar(decomp)
    flat = sharded._refresh_ext(junk.clone(), decomp, hh, ms)
    packed = sharded._refresh_ext(plocal2d.pack_ext(junk, cpar), decomp,
                                  hh, ms)
    return packed, plocal2d.pack_ext(flat, cpar), flat, ue


def _run_world(rank, world, init_file, shape, cases, out_dir,
               run_case=None):
    """One rank: solve every case on the mesh (``run_case(mesh, kw, b)``,
    default ``_run_case``) on the inputs spawn_world saved in ``out_dir``,
    and save what it saw."""
    with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    # Small tiles: one thread a rank, so that the ranks and the JAX
    # references do not contend for the cores.
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        kernels.KERNEL_MIN_N = KERNEL_MIN_N
        mesh = (sharded.make_mesh(device="cpu") if len(shape) == 1
                else sharded.make_block_mesh(shape, device="cpu"))
        # A tile whose entries name their rank, extended by its
        # neighbours' edge rows (zeros past the mesh's ends).
        tile = torch.full((4, 3), float(rank + 1), dtype=torch.float64)
        out = {"coords": mesh.coords,
               "halo": (sharded.halo_extend(tile, mesh) if len(shape) == 1
                        else None),
               "refresh": (_refresh_check(mesh, torch.from_numpy(
                   inputs["refresh"])) if "refresh" in inputs else None)}
        for name, kw in cases.items():
            out[name] = (run_case or _run_case)(
                mesh, kw, torch.from_numpy(inputs[name]))
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Test side
# ---------------------------------------------------------------------------

def _jax_mesh(shape):
    import jax

    from multigridcmt_tpu.parallel import sharded as jsharded

    return (jsharded.make_mesh(jax.devices()[:shape[0]]) if len(shape) == 1
            else jsharded.make_block_mesh(shape))


def _jax_rhs(kw):
    import jax.numpy as jnp

    import multigridcmt_tpu as jmg

    return np.asarray(jmg.poisson2d(dtype=jnp.float64, tol=1e-9,
                                    agglom_rows=4, **_config_kw(kw)).b)


def _jax_case(shape, kw, b):
    """(result, JAX mesh) of the JAX ShardedSolver on the virtual devices:
    the solve, or for a "chain" case the v_cycles_fn iterates after each
    of CHAIN cycles."""
    import jax.numpy as jnp

    from multigridcmt_tpu import kernels as jkernels
    from multigridcmt_tpu.config import SolverConfig as JConfig
    from multigridcmt_tpu.parallel import sharded as jsharded

    jmesh = _jax_mesh(shape)
    cfg = JConfig(ndim=2, dtype=jnp.float64, tol=1e-9, agglom_rows=4,
                  use_pallas=True, **_config_kw(kw))
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jkernels, "PALLAS_MIN_N", KERNEL_MIN_N)
        if kw.get("pack"):
            patch.setattr(jkernels, "PACK_MIN_N", PACK_MIN_N)
        solver = jsharded.ShardedSolver(cfg, jmesh)
        if kw.get("pack"):
            assert jsharded._pack_level_ok(cfg, solver.decomp, 0)
        if kw.get("ref") == "chain":
            # One cycle a call, each from the last one's iterate: a
            # refreshed ghost slab holds what a fresh extension holds, so
            # these are the iterates of the chained cycles, at a third of
            # the interpreted kernels' time.
            many = solver.v_cycles_fn()
            x = jnp.zeros_like(jsharded.shard_rhs(b, jmesh))
            bt = jsharded.shard_rhs(b, jmesh)
            res = {}
            for m in CHAIN:
                x = many(x, bt, 1)
                res[m] = np.asarray(x)
        else:
            res = solver.solve(b, method=kw.get("method", "mg"))
    return res, jmesh


def spawn_world(shape, cases, inputs, references, run_case=None):
    """(per-rank results, references()) of a gloo world of mesh
    ``shape`` whose ranks run every case (``_run_world``, with
    ``run_case``); ``references`` runs in this process while the ranks do.
    A world that does not finish in WORLD_TIMEOUT_S is killed and fails the
    test."""
    from multigridcmt_tpu_torch import convert

    # The ranks lay out the JAX mesh's shape.
    assert convert.mesh_shape_from_jax(_jax_mesh(shape)) == shape
    nprocs = int(np.prod(shape))
    with tempfile.TemporaryDirectory() as tmp:
        # Through a file, not the spawn arguments: a process's arguments
        # larger than a pipe's buffer make each start wait for the one
        # before it to import its modules.
        with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
            pickle.dump(inputs, f)
        ctx = mp.start_processes(
            _run_world, args=(nprocs, os.path.join(tmp, "rdv"), shape, cases,
                              tmp, run_case),
            nprocs=nprocs, join=False, start_method="spawn")
        refs = references()
        deadline = time.monotonic() + WORLD_TIMEOUT_S
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                pytest.fail(f"world {shape} did not finish in "
                            f"{WORLD_TIMEOUT_S} s")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(nprocs)]
    return ranks, refs


@pytest.fixture(scope="module")
def world_results():
    """world -> (per-rank results, per-case JAX references), each world
    spawned on first use; the JAX runs go while the ranks do."""
    cache = {}

    def get(world):
        if world in cache:
            return cache[world]
        shape, cases = WORLDS[world]
        inputs = {name: _jax_rhs(kw) for name, kw in cases.items()}
        if world in REFRESH_WORLDS:
            inputs["refresh"] = np.random.default_rng(3).standard_normal(
                (65, 65))
        cache[world] = spawn_world(
            shape, cases, inputs,
            lambda: {name: _jax_case(shape, kw, inputs[name])
                     for name, kw in cases.items()
                     if kw.get("ref", "jax") != "single"})
        return cache[world]

    return get


def _decomp(shape):
    return sharded.Decomp(ndim=2, axes=tuple(
        (a, f"ax{a}", d) for a, d in enumerate(shape)))


def _route(g, kw):
    """The route the case took: whole legs where they fit (the packed
    plocal2d legs on a packed fine level), else the local2d sweeps and
    residual on the kernel-sized owned tiles."""
    nu_fits = kw.get("nu1", 2) <= local2d.max_down_sweeps(kw["smoother"])
    assert g["leg0"] == (kw["smoother"] != "chebyshev" and nu_fits)
    assert g["pack0"] == bool(kw.get("pack"))
    pc = g["pcalls"]
    if g["pack0"]:
        assert pc["down_leg"] > 0 and pc["up_leg"] > 0
        if kw.get("method") == "pcg":
            assert pc["residual"] == 1 and pc["apply_op"] == g["iters"]
            assert pc["residual_norm_sq"] == 0
        else:
            assert pc["residual_norm_sq"] == g["iters"] + 1
            assert pc["residual"] == pc["apply_op"] == 0
    else:
        assert sum(pc.values()) == 0
    if g["leg0"]:
        # The coarse leg levels (127..31 at k=8) stay on local2d.
        assert g["calls"]["down_leg"] > 0 and g["calls"]["up_leg"] > 0
    else:
        assert g["calls"]["residual"] > 0
        assert g["calls"]["down_leg"] == g["calls"]["up_leg"] == 0


@pytest.mark.parametrize("world,case", CASES,
                         ids=[f"{w}-{c}" for w, c in CASES])
def test_sharded_solve_matches_jax(world, case, world_results):
    ranks, refs = world_results(world)
    shape, cases = WORLDS[world]
    kw = cases[case]
    ref = kw.get("ref", "jax")
    got = [r[case] for r in ranks]
    # Every rank ends with the same full solution and history.
    for g in got[1:]:
        assert torch.equal(g["x"], got[0]["x"])
        assert torch.equal(g["hist"], got[0]["hist"])
    g = got[0]
    assert g["converged"]
    _route(g, kw)
    # Histories: rtol 1e-10, down to the float64 rounding floor of the
    # relative residual (~eps * 8/h^2 * max|x| / rms(b), 7e-13 at k=6),
    # where routes that sum in other orders part: the plain versions and
    # the JAX kernels, or the sharded and the single-device route (~1e-14
    # apart).
    if ref != "jax":
        one = g["single"]
        assert g["iters"] == one["iters"]
        np.testing.assert_allclose(g["hist"].numpy(), one["hist"].numpy(),
                                   rtol=1e-10, atol=1e-12)
        scale = one["x"].abs().max().item()
        np.testing.assert_allclose(g["x"].numpy(), one["x"].numpy(), rtol=0,
                                   atol=1e-10 * scale)
    if ref == "single":
        return
    from multigridcmt_tpu.parallel import sharded as jsharded
    from multigridcmt_tpu_torch import convert

    want, jmesh = refs[case]
    if ref == "chain":
        # The packed iterates after 1, 2 and 3 chained cycles, each rank's
        # tile against its tile of JAX's.
        for m in CHAIN:
            scale = np.abs(want[m]).max()
            for r in ranks:
                want_tile = convert.tile_from_jax(want[m], _decomp(shape),
                                                  r["coords"], device="cpu")
                np.testing.assert_allclose(r[case]["chain"][m].numpy(),
                                           want_tile.numpy(), rtol=0,
                                           atol=1e-10 * scale)
        return
    assert g["iters"] == int(want.iters)
    if ref == "jax":
        np.testing.assert_allclose(g["hist"].numpy(),
                                   np.asarray(want.res_history), rtol=1e-10,
                                   atol=1e-12)
    jx = np.asarray(want.x)
    scale = np.abs(jx).max()
    np.testing.assert_allclose(g["x"].numpy(), jx, rtol=0, atol=1e-10 * scale)
    # Each rank's owned tile against its tile of JAX's sharded result.
    jtiles = jsharded.shard_rhs(jx, jmesh)
    for r in ranks:
        want_tile = convert.tile_from_jax(jtiles, _decomp(shape), r["coords"],
                                          device="cpu")
        np.testing.assert_allclose(r[case]["tile"].numpy(),
                                   want_tile.numpy(), rtol=0,
                                   atol=1e-10 * scale)


@pytest.mark.parametrize("world", REFRESH_WORLDS)
def test_packed_refresh_matches_unpacked(world, world_results):
    """A packed extended tile's ghost refresh (rank 3: row slabs on axis 1,
    column slabs as hh/2 lanes of both planes) equals the packed form of
    the unpacked refresh, which restores the exactly extended tile."""
    ranks, _ = world_results(world)
    for r in ranks:
        packed, want, flat, exact = r["refresh"]
        assert packed.ndim == 3
        assert torch.equal(flat, exact)
        assert torch.equal(packed, want)


@pytest.mark.parametrize("world", ["rows2", "rows4", "rows8"])
def test_halo_extend_takes_the_neighbours_rows(world, world_results):
    ranks, _ = world_results(world)
    for r, got in enumerate(ranks):
        want = torch.full((6, 3), float(r + 1), dtype=torch.float64)
        want[0] = r if r > 0 else 0.0
        want[-1] = r + 2 if r + 1 < len(ranks) else 0.0
        assert torch.equal(got["halo"], want)
