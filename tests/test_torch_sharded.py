"""The port's sharded solver (multigridcmt_tpu_torch/parallel/sharded.py) in
gloo worlds of CPU processes, against the JAX ShardedSolver on the same
number of the conftest's virtual devices (Pallas kernels in interpret mode,
PALLAS_MIN_N = 30; the port's ranks set KERNEL_MIN_N = 30 to match, and
their local2d wrappers take the plain versions on CPU tensors).

Each world is spawned once and runs several cases; its ranks import torch
and the port only (this module imports JAX inside its fixtures). Ranks talk
over the loopback interface, and a world that does not finish in time is
killed and fails its tests.
"""
import os
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
WORLD_TIMEOUT_S = 180
BASE = dict(dtype=torch.float64, tol=1e-9, agglom_rows=4, use_kernels=True)
LEG_FUNCS = ("down_leg", "up_leg", "rbgs_sweep", "jacobi_sweep", "residual")

# world -> (mesh shape, {case: config overrides}). "single" cases are held
# against the port's single-device solve (cycles.solve) instead of JAX.
WORLDS = {
    # m = 32 rows a rank at k=6: one interior boundary.
    "rows2": ((2,), {"rbgs": dict(k=6, smoother="rbgs")}),
    "rows4": ((4,), {
        # The composed route: V(4,4) exceeds the down leg's sweep cap.
        "rbgs-v44": dict(k=6, smoother="rbgs", nu1=4, nu2=4),
        "single-k7": dict(k=7, smoother="rbgs"),
        # Two leg levels, so the second visit of level 1 takes stale ghosts
        # (only the first coarse visit is fresh): against JAX, and against
        # the port's single-device W-cycle.
        "rbgs-w": dict(k=6, smoother="rbgs", cycle="w"),
        "single-w": dict(k=6, smoother="rbgs", cycle="w"),
    }),
    # m = 8 rows a rank at k=6, the least a leg level takes; level 1 (m=4)
    # runs the owned-tile route and its coarse tile is extended with
    # zero-filled two-hop ghosts.
    "rows8": ((8,), {"rbgs-m8": dict(k=6, smoother="rbgs")}),
    "block2x2": ((2, 2), {
        "rbgs": dict(k=6, smoother="rbgs"),
        "chebyshev": dict(k=6, smoother="chebyshev"),
    }),
    "block4x2": ((4, 2), {"jacobi": dict(k=6, smoother="jacobi")}),
}
CASES = [(w, c) for w, (_, cases) in WORLDS.items() for c in cases]


# ---------------------------------------------------------------------------
# Rank side (torch and the port only)
# ---------------------------------------------------------------------------

def _counting(name, calls):
    fn = getattr(local2d, name)

    def wrapper(*args, **kwargs):
        calls[name] += 1
        return fn(*args, **kwargs)
    return wrapper


def _run_world(rank, world, init_file, shape, cases, inputs, out_dir):
    """One rank: solve every case on the mesh and save what it saw."""
    import multigridcmt_tpu_torch as mt

    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
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
                        else None)}
        for name, kw in cases.items():
            cfg = SolverConfig(ndim=2, **BASE, **kw)
            b = torch.from_numpy(inputs[name])
            calls = dict.fromkeys(LEG_FUNCS, 0)
            saved = {f: getattr(local2d, f) for f in LEG_FUNCS}
            for f in LEG_FUNCS:
                setattr(local2d, f, _counting(f, calls))
            try:
                s = sharded.ShardedSolver(cfg, mesh)
                res = s.solve(b)
            finally:
                for f, fn in saved.items():
                    setattr(local2d, f, fn)
            got = {"x": res.x, "tile": sharded.shard_rhs(res.x, mesh,
                                                         s.decomp),
                   "hist": res.res_history, "iters": res.iters,
                   "converged": res.converged, "calls": calls,
                   "leg0": sharded._leg_level_ok(cfg, s.decomp, 0)}
            if name.startswith("single"):
                prob = mt.poisson2d(device="cpu", **BASE, **kw)
                ref = mt.solve(prob.hierarchy, b, cfg)
                got["single"] = {"x": ref.x, "hist": ref.res_history,
                                 "iters": ref.iters}
            out[name] = got
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
                                    agglom_rows=4, **kw).b)


def _jax_case(shape, kw, b):
    """(result, JAX mesh) of the JAX ShardedSolver on the virtual devices."""
    import jax.numpy as jnp

    from multigridcmt_tpu import kernels as jkernels
    from multigridcmt_tpu.config import SolverConfig as JConfig
    from multigridcmt_tpu.parallel import sharded as jsharded

    jmesh = _jax_mesh(shape)
    cfg = JConfig(ndim=2, dtype=jnp.float64, tol=1e-9, agglom_rows=4,
                  use_pallas=True, **kw)
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jkernels, "PALLAS_MIN_N", KERNEL_MIN_N)
        res = jsharded.ShardedSolver(cfg, jmesh).solve(b)
    return res, jmesh


@pytest.fixture(scope="module")
def world_results():
    """world -> (per-rank results, per-case JAX references), each world
    spawned on first use; the JAX solves run while the ranks do."""
    cache = {}

    def get(world):
        if world in cache:
            return cache[world]
        from multigridcmt_tpu_torch import convert

        shape, cases = WORLDS[world]
        # The ranks lay out the JAX mesh's shape.
        assert convert.mesh_shape_from_jax(_jax_mesh(shape)) == shape
        inputs = {name: _jax_rhs(kw) for name, kw in cases.items()}
        nprocs = int(np.prod(shape))
        with tempfile.TemporaryDirectory() as tmp:
            ctx = mp.start_processes(
                _run_world, args=(nprocs, os.path.join(tmp, "rdv"), shape,
                                  cases, inputs, tmp),
                nprocs=nprocs, join=False, start_method="spawn")
            refs = {name: _jax_case(shape, kw, inputs[name])
                    for name, kw in cases.items()
                    if not name.startswith("single")}
            deadline = time.monotonic() + WORLD_TIMEOUT_S
            while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
                if time.monotonic() > deadline:
                    for p in ctx.processes:
                        p.kill()
                    pytest.fail(f"world {world} did not finish in "
                                f"{WORLD_TIMEOUT_S} s")
            ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                                weights_only=False) for r in range(nprocs)]
        cache[world] = (ranks, refs)
        return cache[world]

    return get


@pytest.mark.parametrize("world,case", CASES,
                         ids=[f"{w}-{c}" for w, c in CASES])
def test_sharded_solve_matches_jax(world, case, world_results):
    ranks, refs = world_results(world)
    shape, cases = WORLDS[world]
    got = [r[case] for r in ranks]
    # Every rank ends with the same full solution and history.
    for g in got[1:]:
        assert torch.equal(g["x"], got[0]["x"])
        assert torch.equal(g["hist"], got[0]["hist"])
    g = got[0]
    assert g["converged"]
    kw = cases[case]
    nu_fits = kw.get("nu1", 2) <= local2d.max_down_sweeps(kw["smoother"])
    # The route: whole legs where they fit, else the local2d sweeps and
    # residual on the kernel-sized owned tiles.
    assert g["leg0"] == (kw["smoother"] != "chebyshev" and nu_fits)
    if g["leg0"]:
        assert g["calls"]["down_leg"] > 0 and g["calls"]["up_leg"] > 0
    else:
        assert g["calls"]["residual"] > 0
        assert g["calls"]["down_leg"] == g["calls"]["up_leg"] == 0
    if case.startswith("single"):
        ref = g["single"]
        iters, hist, jx = ref["iters"], ref["hist"].numpy(), ref["x"].numpy()
    else:
        want, jmesh = refs[case]
        iters, hist = int(want.iters), np.asarray(want.res_history)
        jx = np.asarray(want.x)
    assert g["iters"] == iters
    # rtol 1e-10, down to the float64 rounding floor of the relative
    # residual (~eps * 8/h^2 * max|x| / rms(b), 7e-13 at k=6), where routes
    # that sum in other orders part: the plain versions and the JAX
    # kernels, or the sharded and the single-device route (~1e-14 apart).
    np.testing.assert_allclose(g["hist"].numpy(), hist, rtol=1e-10,
                               atol=1e-12)
    scale = np.abs(jx).max()
    np.testing.assert_allclose(g["x"].numpy(), jx, rtol=0, atol=1e-10 * scale)
    if case.startswith("single"):
        return
    from multigridcmt_tpu.parallel import sharded as jsharded
    from multigridcmt_tpu_torch import convert

    # Each rank's owned tile against its tile of JAX's sharded result.
    decomp = sharded.Decomp(ndim=2, axes=tuple(
        (a, f"ax{a}", d) for a, d in enumerate(shape)))
    jtiles = jsharded.shard_rhs(jx, jmesh)
    for r in ranks:
        want_tile = convert.tile_from_jax(jtiles, decomp, r["coords"],
                                          device="cpu")
        np.testing.assert_allclose(r[case]["tile"].numpy(),
                                   want_tile.numpy(), rtol=0,
                                   atol=1e-10 * scale)


@pytest.mark.parametrize("world", ["rows2", "rows4", "rows8"])
def test_halo_extend_takes_the_neighbours_rows(world, world_results):
    ranks, _ = world_results(world)
    for r, got in enumerate(ranks):
        want = torch.full((6, 3), float(r + 1), dtype=torch.float64)
        want[0] = r if r > 0 else 0.0
        want[-1] = r + 2 if r + 1 < len(ranks) else 0.0
        assert torch.equal(got["halo"], want)
