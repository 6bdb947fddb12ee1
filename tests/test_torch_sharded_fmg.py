"""The port's sharded full multigrid (parallel/sharded.py: _sharded_fmg,
ShardedSolver.solve with cycle="fmg") in gloo worlds of CPU processes, a
row mesh of 2 and a 2 x 2 block mesh, against the JAX ShardedSolver with
cycle="fmg" on as many of the conftest's virtual devices (Pallas kernels in
interpret mode, PALLAS_MIN_N = KERNEL_MIN_N = 30) and against the port's
single-device FMG solve; the warm start that skips the FMG pass; and the
cubic walk, which the sharded solver refuses (JAX's walks linearly
whatever the config says: ROADMAP.md queue 3, F4).

Spawned as tests/test_torch_sharded.py spawns its worlds (its ranks import
torch and the port only)."""
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
from multigridcmt_tpu_torch.parallel import sharded
from test_torch_sharded import (KERNEL_MIN_N, PACK_MIN_N, WORLD_TIMEOUT_S,
                                _decomp, _jax_mesh)

BASE = dict(dtype=torch.float64, tol=1e-9, agglom_rows=4, use_kernels=True,
            cycle="fmg")
# world -> (mesh shape, {case: settings}): config overrides, and
#   pack: PACK_MIN_N = 30 on the port's side (k=8: the 255 level packs; the
#     case is held against the port's single-device solve only, as JAX's
#     packed norm counts overlap rows twice at m = 128, F1);
#   warm: the solve starts from x0 = 0.5 u_exact, which skips the FMG pass.
WORLDS = {
    "rows2": ((2,), {
        "rbgs": dict(k=6, smoother="rbgs"),
        "packed": dict(k=8, smoother="rbgs", pack=True),
        "warm": dict(k=6, smoother="rbgs", warm=True),
    }),
    "block2x2": ((2, 2), {
        "rbgs": dict(k=6, smoother="rbgs"),
        "jacobi": dict(k=6, smoother="jacobi"),
    }),
}
SETTINGS = ("pack", "warm")
CASES = [(w, c) for w, (_, cases) in WORLDS.items() for c in cases]


def _config_kw(kw):
    return {k: v for k, v in kw.items() if k not in SETTINGS}


def _inputs(kw):
    """(b, x0 or None) of a case, from the JAX model problem."""
    import jax.numpy as jnp

    import multigridcmt_tpu as jmg

    prob = jmg.poisson2d(dtype=jnp.float64, tol=1e-9, agglom_rows=4,
                         **_config_kw(kw))
    x0 = 0.5 * np.asarray(prob.u_exact) if kw.get("warm") else None
    return np.asarray(prob.b), x0


# ---------------------------------------------------------------------------
# Rank side (torch and the port only)
# ---------------------------------------------------------------------------

def _run_case(mesh, kw, b, x0):
    import multigridcmt_tpu_torch as mt

    saved, saved_fmg = kernels.PACK_MIN_N, sharded._sharded_fmg
    passes = []

    def counting_fmg(*args, **kwargs):
        passes.append(1)
        return saved_fmg(*args, **kwargs)

    if kw.get("pack"):
        kernels.PACK_MIN_N = PACK_MIN_N
    sharded._sharded_fmg = counting_fmg
    try:
        cfg = SolverConfig(ndim=2, **{**BASE, **_config_kw(kw)})
        s = sharded.ShardedSolver(cfg, mesh)
        res = s.solve(b, x0=x0)
        prob = mt.poisson2d(device="cpu", **{**BASE, **_config_kw(kw)})
        one = mt.solve(prob.hierarchy, b, cfg if x0 is None else
                       SolverConfig(ndim=2, **{**BASE, **_config_kw(kw),
                                               "cycle": "v"}), x0=x0)
        return {"x": res.x, "tile": sharded.shard_rhs(res.x, mesh, s.decomp),
                "hist": res.res_history, "iters": res.iters,
                "converged": res.converged, "passes": len(passes),
                "pack0": sharded._pack_level_ok(cfg, s.decomp, 0),
                "single": {"x": one.x, "hist": one.res_history,
                           "iters": one.iters}}
    finally:
        kernels.PACK_MIN_N = saved
        sharded._sharded_fmg = saved_fmg


def _run_world(rank, world, init_file, shape, cases, inputs, out_dir):
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        kernels.KERNEL_MIN_N = KERNEL_MIN_N
        mesh = (sharded.make_mesh(device="cpu") if len(shape) == 1
                else sharded.make_block_mesh(shape, device="cpu"))
        out = {"coords": mesh.coords}
        for name, kw in cases.items():
            b, x0 = inputs[name]
            out[name] = _run_case(
                mesh, kw, torch.from_numpy(b),
                None if x0 is None else torch.from_numpy(x0))
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Test side
# ---------------------------------------------------------------------------

def _jax_solve(shape, kw, b, x0):
    import jax.numpy as jnp

    from multigridcmt_tpu import kernels as jkernels
    from multigridcmt_tpu.config import SolverConfig as JConfig
    from multigridcmt_tpu.parallel import sharded as jsharded

    jmesh = _jax_mesh(shape)
    cfg = JConfig(ndim=2, dtype=jnp.float64, tol=1e-9, agglom_rows=4,
                  use_pallas=True, cycle="fmg", **_config_kw(kw))
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jkernels, "PALLAS_MIN_N", KERNEL_MIN_N)
        res = jsharded.ShardedSolver(cfg, jmesh).solve(b, x0=x0)
    return res, jmesh


@pytest.fixture(scope="module")
def world_results():
    cache = {}

    def get(world):
        if world in cache:
            return cache[world]
        shape, cases = WORLDS[world]
        inputs = {name: _inputs(kw) for name, kw in cases.items()}
        nprocs = int(np.prod(shape))
        with tempfile.TemporaryDirectory() as tmp:
            ctx = mp.start_processes(
                _run_world, args=(nprocs, os.path.join(tmp, "rdv"), shape,
                                  cases, inputs, tmp),
                nprocs=nprocs, join=False, start_method="spawn")
            refs = {name: _jax_solve(shape, kw, *inputs[name])
                    for name, kw in cases.items() if not kw.get("pack")}
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
def test_sharded_fmg_matches_jax(world, case, world_results):
    """Every rank ends with the same solution and history; one FMG pass
    ran (none from a warm start, which polishes x0 by V-cycles as JAX's
    skip_fmg does); equal polishing counts, histories rtol 1e-10 (atol
    1e-12) and iterates within 1e-10 of their largest value against the
    port's single-device solve and JAX's ShardedSolver, and each rank's
    owned tile against its tile of JAX's."""
    from multigridcmt_tpu.parallel import sharded as jsharded
    from multigridcmt_tpu_torch import convert

    ranks, refs = world_results(world)
    shape, cases = WORLDS[world]
    kw = cases[case]
    got = [r[case] for r in ranks]
    for g in got[1:]:
        assert torch.equal(g["x"], got[0]["x"])
        assert torch.equal(g["hist"], got[0]["hist"])
    g = got[0]
    assert g["converged"] and g["iters"] >= 1
    assert g["passes"] == (0 if kw.get("warm") else 1)
    assert g["pack0"] == bool(kw.get("pack"))
    one = g["single"]
    assert g["iters"] == one["iters"]
    np.testing.assert_allclose(g["hist"].numpy(), one["hist"].numpy(),
                               rtol=1e-10, atol=1e-12)
    scale = one["x"].abs().max().item()
    np.testing.assert_allclose(g["x"].numpy(), one["x"].numpy(), rtol=0,
                               atol=1e-10 * scale)
    if kw.get("pack"):
        return
    want, jmesh = refs[case]
    assert g["iters"] == int(want.iters)
    np.testing.assert_allclose(g["hist"].numpy(),
                               np.asarray(want.res_history), rtol=1e-10,
                               atol=1e-12)
    jx = np.asarray(want.x)
    np.testing.assert_allclose(g["x"].numpy(), jx, rtol=0, atol=1e-10 * scale)
    jtiles = jsharded.shard_rhs(jx, jmesh)
    for r in ranks:
        want_tile = convert.tile_from_jax(jtiles, _decomp(shape), r["coords"],
                                          device="cpu")
        np.testing.assert_allclose(r[case]["tile"].numpy(),
                                   want_tile.numpy(), rtol=0,
                                   atol=1e-10 * scale)


@pytest.fixture
def world_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        yield sharded.make_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def test_cubic_walk_is_refused(world_of_one):
    """fmg_prolong="cubic" with cycle="fmg": the sharded walk is linear
    only, and the solver says so instead of walking linearly."""
    cfg = SolverConfig(ndim=2, k=6, cycle="fmg", fmg_prolong="cubic",
                       agglom_rows=4)
    with pytest.raises(ValueError, match="linear only"):
        sharded.ShardedSolver(cfg, world_of_one)
    # The cubic setting means nothing to a V-cycle solve: accepted.
    sharded.ShardedSolver(SolverConfig(ndim=2, k=6, fmg_prolong="cubic",
                                       agglom_rows=4), world_of_one)


def test_single_rank_fmg_matches_single_device(world_of_one, monkeypatch):
    """A mesh of 1 on the whole-leg route (KERNEL_MIN_N 30: 63 on the
    local2d legs): the sharded FMG pass and solve equal the single-device
    FMG pass and solve (fused2d legs) to rounding, and from a warm start
    both polish x0 the same way."""
    import multigridcmt_tpu_torch as mt

    monkeypatch.setattr(kernels, "KERNEL_MIN_N", KERNEL_MIN_N)
    prob = mt.poisson2d(k=6, smoother="rbgs", device="cpu", **BASE)
    s = sharded.ShardedSolver(prob.config, world_of_one)
    assert sharded._leg_level_ok(prob.config, s.decomp, 0)
    single = mt.MultigridSolver(prob)
    b_t = sharded.shard_rhs(prob.b, world_of_one, s.decomp)
    x_t = sharded._sharded_fmg(s.hierarchy, prob.config, s.decomp, b_t)
    np.testing.assert_allclose(sharded.unshard(x_t, s.decomp).numpy(),
                               single.fmg().numpy(), rtol=0, atol=1e-12)
    for x0 in (None, 0.5 * prob.u_exact):
        got, want = s.solve(prob.b, x0=x0), single.solve(x0=x0)
        if x0 is not None:
            # The single-device FMG solve ignores x0 (as JAX's): its warm
            # twin is the V-cycle solve.
            want = mt.solve(prob.hierarchy, prob.b, SolverConfig(
                ndim=2, smoother="rbgs", k=6, **{**BASE, "cycle": "v"}),
                x0=x0)
        assert got.converged and got.iters == want.iters
        np.testing.assert_allclose(got.res_history.numpy(),
                                   want.res_history.numpy(), rtol=1e-10,
                                   atol=1e-12)
