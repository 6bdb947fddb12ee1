"""Sharded 3D MG-PCG with a bfloat16 preconditioner (ShardedSolver(...,
precond_dtype=torch.bfloat16).solve(b, method="pcg") with ndim=3 on slab and
pencil meshes) and its gate, ``sharded.mixed_slab_dtype``.

The gate is held against JAX's ``mixed_slab_dtype`` on a table of
configurations and meshes, including those its TPU VMEM arithmetic refuses;
where JAX casts to a dtype the kernels do not store (float16) the port
raises. The solves run in gloo worlds of CPU processes (spawned by
tests/test_torch_sharded.py's spawn_world; the ranks import torch and the
port only) with KERNEL3_MIN_N lowered to 10, at k = 5, float64, tol 1e-10:
JAX's test_sharded_pcg_bf16_3d_slab. The mixed run converges, in at most
ceil(1.2 x) + 1 the full-precision run's iterations, to within rtol 1e-7,
atol 1e-8 of its answer (JAX's criterion), and a spy on the stencil3d
wrappers shows the route: the fine stack's down sweeps and residual in
bfloat16, the correction add promoting the stack to float32 and the up
sweeps in float32, the coarser kernel levels in float32 (the bfloat16
residual's output), CG's own residuals and applies in float64. Mixed runs
are held against converged full-precision answers, not JAX's mixed
histories: their rounding parts (ROADMAP.md queue 3, F5), and JAX's level
adds its correction in bfloat16, which the port does not copy (F7).

F7's pin: on a world of 1 at k = 5, float64, tol 1e-8, the mixed PCG takes
the full-precision run's iterations (RB-GS 5, Jacobi 7) and its first
step (the relative residual after one iteration) lies within 10% of the
full run's, as the single device's mixed history does; adding the
correction in bfloat16 had made that step 0.238 (RB-GS) and 0.210
(Jacobi) against 0.116 and 0.135.
"""
import math

import numpy as np
import pytest
import torch

from multigridcmt_tpu_torch import kernels
from multigridcmt_tpu_torch.config import SolverConfig
from multigridcmt_tpu_torch.parallel import sharded
from test_torch_sharded import spawn_world

KERNEL3_MIN_N = 10
BASE = dict(dtype=torch.float64, tol=1e-10, max_iters=60, agglom_rows=4,
            use_kernels=True)
# F7's pin: the full-precision run's iterations at k = 5, tol 1e-8, and
# how far the mixed run's first step may part from the full run's.
PIN_TOL = 1e-8
PIN_ITERS = {"rbgs": 5, "jacobi": 7}
PIN_STEP_RTOL = 0.1
WORLDS = {"slab4": (4,), "pencil2x2": (2, 2)}
SMOOTHERS = ("rbgs", "jacobi")
CASES = [(w, s) for w in WORLDS for s in SMOOTHERS]
WRAPPERS = ("residual", "rbgs_sweep", "jacobi_sweep")

# (k, mesh shape, smoother, nu1, nu2, dtype, precond dtype, min n), each
# named by what it exercises. min n: KERNEL3_MIN_N and PALLAS3_MIN_N.
BF, F32, F64, F16 = "bfloat16", "float32", "float64", "float16"
GATE_CASES = {
    "slab-k9-bf16": (9, (1,), "rbgs", 2, 2, F32, BF, 100),
    "pencil-k9-bf16": (9, (1, 1), "rbgs", 2, 2, F32, BF, 100),
    "slab-k10-bf16": (10, (4,), "jacobi", 2, 2, F32, BF, 100),
    # 17 x 1032 x 1152 x 4 bytes: 80.8 MB, within JAX's 80 MiB.
    "slab-k10-f32": (10, (2,), "rbgs", 2, 2, F64, F32, 100),
    # n + 2 = 2049 rows: 152 MB in bfloat16, past JAX's budget.
    "slab-k11-vmem": (11, (8,), "rbgs", 2, 2, F32, BF, 100),
    # ... while a pencil's 256 + 10 rows fit.
    "pencil-k11-bf16": (11, (2, 8), "rbgs", 2, 2, F32, BF, 100),
    "pencil-k11-f32-vmem": (11, (1, 2), "rbgs", 2, 2, F64, F32, 100),
    "k8-below-min-n": (8, (2,), "rbgs", 2, 2, F32, BF, 300),
    "k5-slab": (5, (4,), "rbgs", 2, 2, F64, BF, 10),
    # m0 = 4 < 5 ghost planes (the stagewise route): no cast.
    "k5-slab-shallow": (5, (8,), "rbgs", 2, 2, F64, BF, 10),
    "k5-slab-shallow-v12": (5, (8,), "rbgs", 1, 2, F64, BF, 10),
    "k5-jacobi-shallow": (5, (8,), "jacobi", 2, 2, F64, BF, 10),
    "k5-pencil": (5, (2, 2), "jacobi", 2, 2, F64, BF, 10),
    # m1 = 4 rows < 5.
    "k5-pencil-shallow": (5, (2, 8), "rbgs", 2, 2, F64, BF, 10),
    "chebyshev": (9, (2,), "chebyshev", 2, 2, F32, BF, 100),
    "same-dtype": (9, (2,), "rbgs", 2, 2, F32, F32, 100),
    "f16": (9, (2,), "rbgs", 2, 2, F32, F16, 100),
    "f16-vmem": (11, (2,), "rbgs", 2, 2, F32, F16, 100),
}


@pytest.mark.parametrize("name", list(GATE_CASES))
@pytest.mark.parametrize("kernels_on", [True, False])
def test_mixed_slab_dtype_matches_jax(name, kernels_on, monkeypatch):
    import jax.numpy as jnp

    from multigridcmt_tpu import kernels as jkernels
    from multigridcmt_tpu.config import SolverConfig as JConfig
    from multigridcmt_tpu.parallel import sharded as jsharded

    k, shape, smoother, nu1, nu2, dt, pd, min_n = GATE_CASES[name]
    monkeypatch.setattr(jkernels, "PALLAS3_MIN_N", min_n)
    monkeypatch.setattr(kernels, "KERNEL3_MIN_N", min_n)
    axes = tuple((a, ("row", "col")[a], d) for a, d in enumerate(shape))
    kw = dict(ndim=3, k=k, smoother=smoother, nu1=nu1, nu2=nu2,
              agglom_rows=2)
    want = jsharded.mixed_slab_dtype(
        JConfig(**kw, dtype=getattr(jnp, dt), precond_dtype=getattr(jnp, pd),
                use_pallas=kernels_on),
        jsharded.Decomp(ndim=3, axes=axes))
    cfg = SolverConfig(**kw, dtype=getattr(torch, dt),
                       precond_dtype=getattr(torch, pd),
                       use_kernels=kernels_on)
    dec = sharded.Decomp(ndim=3, axes=axes)
    if want is not None and pd == F16:
        with pytest.raises(NotImplementedError, match="bfloat16, float32"):
            sharded.mixed_slab_dtype(cfg, dec)
        return
    got = sharded.mixed_slab_dtype(cfg, dec)
    assert (None if got is None else str(got).split(".")[1]) == \
        (None if want is None else np.dtype(want).name)
    # The 2D gate never casts a 3D solve.
    if pd != F16:
        assert sharded.mixed_leg_dtype(cfg, dec) is None


# ---------------------------------------------------------------------------
# Rank side (torch and the port only)
# ---------------------------------------------------------------------------

def _run_case(mesh, smoother, b):
    """The mixed and the full-precision PCG of one smoother on the mesh,
    the mixed one with the stencil3d calls spied on."""
    from multigridcmt_tpu_torch.kernels import stencil3d

    saved = kernels.KERNEL3_MIN_N
    originals = {f: getattr(stencil3d, f) for f in WRAPPERS}
    calls = []

    def spy(name, fn):
        def wrapper(u, bb, n, h, *args, **kwargs):
            calls.append((name, tuple(u.shape), str(u.dtype), str(bb.dtype),
                          str(kwargs.get("out_dtype"))))
            return fn(u, bb, n, h, *args, **kwargs)
        return wrapper

    out = {}
    try:
        kernels.KERNEL3_MIN_N = KERNEL3_MIN_N
        for pd in (torch.bfloat16, None):
            cfg = SolverConfig(ndim=3, k=5, smoother=smoother,
                               precond_dtype=pd, **BASE)
            s = sharded.ShardedSolver(cfg, mesh)
            for f, fn in originals.items():
                setattr(stencil3d, f, spy(f, fn) if pd is not None else fn)
            res = s.solve(b, method="pcg")
            out["mixed" if pd is not None else "full"] = {
                "x": res.x, "iters": res.iters, "converged": res.converged,
                "pd": sharded.mixed_slab_dtype(cfg, s.decomp)}
        out["calls"] = calls
    finally:
        for f, fn in originals.items():
            setattr(stencil3d, f, fn)
        kernels.KERNEL3_MIN_N = saved
    return out


# ---------------------------------------------------------------------------
# Test side
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world_results():
    cache = {}

    def get(world):
        if world not in cache:
            import multigridcmt_tpu_torch as mt

            b = mt.poisson3d(k=5, dtype=torch.float64, device="cpu").b.numpy()
            cache[world] = spawn_world(
                WORLDS[world], {s: s for s in SMOOTHERS},
                {s: b for s in SMOOTHERS}, dict, run_case=_run_case)[0]
        return cache[world]

    return get


@pytest.mark.parametrize("world,smoother", CASES,
                         ids=[f"{w}-{s}" for w, s in CASES])
def test_mixed_pcg_3d_converges(world, smoother, world_results):
    shape = WORLDS[world]
    ranks = world_results(world)
    got = [r[smoother] for r in ranks]
    for g in got[1:]:
        for run in ("mixed", "full"):
            assert torch.equal(g[run]["x"], got[0][run]["x"])
    mixed, full = got[0]["mixed"], got[0]["full"]
    assert mixed["pd"] == torch.bfloat16 and full["pd"] is None
    assert mixed["converged"] and full["converged"]
    assert mixed["iters"] <= math.ceil(1.2 * full["iters"]) + 1
    assert mixed["x"].dtype == torch.float64
    np.testing.assert_allclose(mixed["x"].numpy(), full["x"].numpy(),
                               rtol=1e-7, atol=1e-8)
    # The route: the fine stack (m0 + 2 hz planes) in bfloat16 down to its
    # residual, its up smoothing in float32 (the correction add promotes
    # the stack); the other kernel levels in float32; CG's residual and
    # applies at the fine level in float64 (the slab residual kernel; plain
    # on a pencil mesh).
    k, n = 5, 31
    hz = 5 if smoother == "rbgs" else 3
    sweep = smoother + "_sweep"
    m0 = 2 ** k // shape[0]
    fine = (m0 + 2 * hz,
            (n + 2) if len(shape) == 1 else 2 ** k // shape[1] + 2 * hz,
            n + 2)
    cycles = mixed["iters"] + 1
    for r in ranks:
        calls = r[smoother]["calls"]
        on_fine = [c for c in calls if c[1] == fine]
        bf, f32, f64 = "torch.bfloat16", "torch.float32", "torch.float64"
        assert sorted(on_fine) == sorted(
            [(sweep, fine, bf, bf, "None")] * cycles
            + [(sweep, fine, f32, f32, "None")] * cycles
            + [("residual", fine, bf, bf, "None")] * cycles)
        assert all(c[4] == "None" for c in calls)
        rest = [c for c in calls if c[1] != fine]
        assert rest
        assert {c[2] for c in rest} == ({f32, f64} if len(shape) == 1
                                        else {f32})
        if len(shape) == 1:
            check = [c for c in rest if c[2] == f64]
            assert check == [("residual", (m0 + 2, n + 2, n + 2), f64, f64,
                              "None")] * (1 + mixed["iters"])


def _run_pin(mesh, smoother, b):
    """F7's pin on a world of 1: the mixed and the full-precision PCG's
    iterations and residual histories."""
    saved = kernels.KERNEL3_MIN_N
    out = {}
    try:
        kernels.KERNEL3_MIN_N = KERNEL3_MIN_N
        for pd in (torch.bfloat16, None):
            cfg = SolverConfig(ndim=3, k=5, smoother=smoother,
                               precond_dtype=pd, **{**BASE, "tol": PIN_TOL})
            res = sharded.ShardedSolver(cfg, mesh).solve(b, method="pcg")
            out["mixed" if pd is not None else "full"] = {
                "iters": res.iters, "converged": res.converged,
                "hist": res.res_history[: res.iters + 1].clone()}
    finally:
        kernels.KERNEL3_MIN_N = saved
    return out


@pytest.fixture(scope="module")
def pin_results():
    import multigridcmt_tpu_torch as mt

    b = mt.poisson3d(k=5, dtype=torch.float64, device="cpu").b.numpy()
    (rank,), _ = spawn_world((1,), {s: s for s in SMOOTHERS},
                             {s: b for s in SMOOTHERS}, dict,
                             run_case=_run_pin)
    return rank


@pytest.mark.parametrize("smoother", SMOOTHERS)
def test_mixed_pcg_3d_first_step_follows_full(smoother, pin_results):
    """F7: the mixed PCG on a world of 1 takes the full run's iterations,
    its first step within PIN_STEP_RTOL of the full run's."""
    mixed, full = pin_results[smoother]["mixed"], pin_results[smoother]["full"]
    assert mixed["converged"] and full["converged"]
    assert mixed["iters"] == full["iters"] == PIN_ITERS[smoother]
    step = mixed["hist"][1] / mixed["hist"][0]
    want = full["hist"][1] / full["hist"][0]
    assert abs(step - want) <= PIN_STEP_RTOL * want, (step, want)
