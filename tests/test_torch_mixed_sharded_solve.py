"""Sharded MG-PCG with a bfloat16 preconditioner (ShardedSolver(...,
precond_dtype=torch.bfloat16).solve(b, method="pcg")) in gloo worlds of CPU
processes, against the JAX ShardedSolver's mixed PCG on as many of the
conftest's virtual devices (Pallas kernels in interpret mode, PALLAS_MIN_N
= KERNEL_MIN_N = 30) and against the full-dtype answer.

Worlds: a row mesh of 2 and a 2 x 2 block mesh, each with an unpacked case
(k = 6: the local2d legs' bfloat16 modes on 63, float32 legs on 31) and a
packed one (k = 8, PACK_MIN_N = 30: the plocal2d legs' bfloat16 modes on
255, m = 128, several JAX windows a tile). Every rank ends with the same
solution; the cycle's fine level ran the bfloat16 legs (the up leg storing
float32) and no other level did; the iteration counts equal JAX's (its
sharded tier stores the top level in float32 too, so the two run the same
mixed cycle, apart from rounding); the solution lies within rtol 1e-7, atol
1e-8 of the rank's full-dtype PCG and of JAX's mixed answer, JAX's own
criterion (tests/test_mixed.py). Spawned by tests/test_torch_sharded.py's
spawn_world; its ranks import torch and the port only.
"""
import numpy as np
import pytest
import torch

from multigridcmt_tpu_torch import kernels
from multigridcmt_tpu_torch.config import SolverConfig
from multigridcmt_tpu_torch.parallel import sharded
from test_torch_sharded import KERNEL_MIN_N, PACK_MIN_N, _jax_mesh, \
    spawn_world

BASE = dict(dtype=torch.float64, tol=1e-9, agglom_rows=4, use_kernels=True,
            smoother="rbgs")
# world -> (mesh shape, {case: (k, packed)}).
WORLDS = {
    "rows2": ((2,), {"unpacked": (6, False), "packed": (8, True)}),
    "block2x2": ((2, 2), {"unpacked": (6, False), "packed": (8, True)}),
}
CASES = [(w, c) for w, (_, cases) in WORLDS.items() for c in cases]
LEGS = ("down_leg", "up_leg")


def _rhs(k):
    import jax.numpy as jnp

    import multigridcmt_tpu as jmg

    return np.asarray(jmg.poisson2d(k=k, dtype=jnp.float64, tol=1e-9,
                                    agglom_rows=4, smoother="rbgs").b)


# ---------------------------------------------------------------------------
# Rank side (torch and the port only)
# ---------------------------------------------------------------------------

def _run_case(mesh, case, b):
    """The mixed and the full-dtype PCG of one case on the mesh, with the
    dtypes each leg call took (module, leg, tile dtype, out_dtype) in the
    mixed one."""
    from multigridcmt_tpu_torch.kernels import local2d, plocal2d

    k, packed = case
    saved = kernels.PACK_MIN_N
    if packed:
        kernels.PACK_MIN_N = PACK_MIN_N
    seen = []
    originals = [(mod, f, getattr(mod, f)) for mod in (local2d, plocal2d)
                 for f in LEGS]

    def spy(mod, f, fn):
        def wrapper(x, *args, **kwargs):
            seen.append((mod.__name__.split(".")[-1], f, str(x.dtype),
                         str(kwargs.get("out_dtype"))))
            return fn(x, *args, **kwargs)
        return wrapper

    try:
        out = {}
        for pd in (torch.bfloat16, None):
            cfg = SolverConfig(ndim=2, k=k, precond_dtype=pd, **BASE)
            s = sharded.ShardedSolver(cfg, mesh)
            for mod, f, fn in originals:
                setattr(mod, f, spy(mod, f, fn) if pd is not None else fn)
            res = s.solve(b, method="pcg")
            out["mixed" if pd is not None else "full"] = {
                "x": res.x, "iters": res.iters, "converged": res.converged,
                "hist": res.res_history,
                "pd": sharded.mixed_leg_dtype(cfg, s.decomp),
                "pack0": sharded._pack_level_ok(cfg, s.decomp, 0)}
        out["seen"] = seen
    finally:
        for mod, f, fn in originals:
            setattr(mod, f, fn)
        kernels.PACK_MIN_N = saved
    return out


# ---------------------------------------------------------------------------
# Test side
# ---------------------------------------------------------------------------

def _jax_mixed(shape, case, b):
    """JAX's ShardedSolver mixed PCG of one case."""
    import jax.numpy as jnp

    from multigridcmt_tpu import kernels as jkernels
    from multigridcmt_tpu.config import SolverConfig as JConfig
    from multigridcmt_tpu.parallel import sharded as jsharded

    k, packed = case
    cfg = JConfig(ndim=2, k=k, dtype=jnp.float64, tol=1e-9, agglom_rows=4,
                  use_pallas=True, smoother="rbgs",
                  precond_dtype=jnp.bfloat16)
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jkernels, "PALLAS_MIN_N", KERNEL_MIN_N)
        if packed:
            patch.setattr(jkernels, "PACK_MIN_N", PACK_MIN_N)
        solver = jsharded.ShardedSolver(cfg, _jax_mesh(shape))
        assert jsharded.mixed_leg_dtype(cfg, solver.decomp) == jnp.bfloat16
        assert jsharded._pack_level_ok(cfg, solver.decomp, 0) == packed
        return solver.solve(b, method="pcg")


@pytest.fixture(scope="module")
def world_results():
    """world -> (per-rank results, per-case JAX references), each world
    spawned on first use."""
    cache = {}

    def get(world):
        if world not in cache:
            shape, cases = WORLDS[world]
            inputs = {name: _rhs(k) for name, (k, _) in cases.items()}
            cache[world] = spawn_world(
                shape, cases, inputs,
                lambda: {name: _jax_mixed(shape, case, inputs[name])
                         for name, case in cases.items()},
                run_case=_run_case)
        return cache[world]

    return get


@pytest.mark.parametrize("world,case", CASES,
                         ids=[f"{w}-{c}" for w, c in CASES])
def test_mixed_pcg_matches_jax(world, case, world_results):
    ranks, refs = world_results(world)
    _, cases = WORLDS[world]
    k, packed = cases[case]
    got = [r[case] for r in ranks]
    for g in got[1:]:
        for run in ("mixed", "full"):
            assert torch.equal(g[run]["x"], got[0][run]["x"])
    g = got[0]
    mixed, full = g["mixed"], g["full"]
    assert mixed["pd"] == torch.bfloat16 and full["pd"] is None
    assert mixed["pack0"] == packed
    assert mixed["converged"] and full["converged"]
    assert mixed["x"].dtype == torch.float64
    # Each preconditioning cycle: one bfloat16 down leg and one float32-out
    # up leg on the fine level (plocal2d when it packs), float32 legs on
    # the coarser leg levels, nothing in bfloat16 or float64 elsewhere.
    fine = "plocal2d" if packed else "local2d"
    cycles = mixed["iters"] + 1
    seen = g["seen"]
    assert seen.count((fine, "down_leg", "torch.bfloat16", "None")) == cycles
    assert seen.count((fine, "up_leg", "torch.bfloat16",
                       "torch.float32")) == cycles
    coarse = [s for s in seen if s[2] != "torch.bfloat16"]
    assert coarse and all(s[0] == "local2d" and s[2] == "torch.float32"
                          and s[3] == "None" for s in coarse)
    assert len(seen) == 2 * cycles + len(coarse)
    want = refs[case]
    assert mixed["iters"] == int(want.iters)
    jx = np.asarray(want.x)
    np.testing.assert_allclose(mixed["x"].numpy(), full["x"].numpy(),
                               rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(mixed["x"].numpy(), jx, rtol=1e-7, atol=1e-8)
