"""Where the V-cycle's time goes on one CUDA card.

    python -m multigridcmt_tpu_torch.utils.breakdown [--k 12] [--reps 5]
    python -m multigridcmt_tpu_torch.utils.breakdown --smoother chebyshev
    python -m multigridcmt_tpu_torch.utils.breakdown --nu1 4 --nu2 4
    python -m multigridcmt_tpu_torch.utils.breakdown --ndim 3 [--k 9]
    python -m multigridcmt_tpu_torch.utils.breakdown --mesh rows|block
    python -m multigridcmt_tpu_torch.utils.breakdown --ndim 3 --mesh rows|block
    python -m multigridcmt_tpu_torch.utils.breakdown --sweeps
    python -m multigridcmt_tpu_torch.utils.breakdown --transfers
    python -m multigridcmt_tpu_torch.utils.breakdown --sparse
    python -m multigridcmt_tpu_torch.utils.breakdown --fmg [--k 10]
    python -m multigridcmt_tpu_torch.utils.breakdown --eigen ii|lobpcg [--k 9]
    python -m multigridcmt_tpu_torch.utils.breakdown --dtype bfloat16 \
        [--smoother jacobi] [--k 11]

For each route of the float32 V(nu1,nu2) cycle (default RB-GS V(2,2)) at
2^k - 1 (k=12: 4095^2; in 3D, k=9: 511^3), prints the cycle time (CUDA
events, median of 20), the host-clock time of 20 cycles back to back, the
device-busy time a cycle and the device ops a cycle (``torch.profiler``,
summed over the kernel rows), of it the device time of the fused2d and
packed2d legs, of the stencil2d and packed2d sweeps and of
transfer2d.residual_restrict (by kernel name), the idle share
1 - busy/cycle, and
the solve's cycle count, wall time and peak device memory. The routes: the
kernel backend as shipped; the same with the finest level unpacked
(PACK_MIN_N above n, so the unpacked kernels run there); the plain
backend; and the kernel backend with KERNEL_MIN_N = 7 (every level but
the coarsest on the kernel tier).
Then, per level, the kernel time of each leg as the cycle runs it (fused,
or composed from the smoothing and the fused transfer) on the kernel tier,
packed and unpacked where a level can be either, and of the check. In 3D
the routes are the kernel backend as shipped, the plain backend, and the
kernel backend with KERNEL3_MIN_N = 7; then, per level, one RB-GS sweep
and the residual on the stencil3d kernels and the plain restriction and
prolongation. Each per-level time is given as single/chained/device ms:
one call timed alone (CUDA events, median of 20; the wrapper's host work
inside), the time a call of 20 back-to-back calls between one pair of
events (the device's time once the host runs ahead, as inside a cycle;
where a call's host work takes longer than its kernels, the host's time)
and the kernels' device time a call from the profiler (what the chained
time cannot show at the small levels).

With ``--mesh``, the sharded cycle instead (parallel/sharded.py, a
torch.distributed world of 1 over NCCL, a row mesh or a (1, 1) block mesh),
as shipped and with KERNEL_MIN_N = 7 (the plain owned-tile levels 127 and
63 on the leg kernels too): ``ShardedSolver.v_cycle_fn`` (one cycle, owned
tiles in and out, unpacked at any PACK_MIN_N) and the chain the solve runs,
``v_cycles_fn`` over 20 cycles (its fine level colour-packed at the
shipped PACK_MIN_N, on the plocal2d legs), each with the same figures a
cycle plus the device time of the local2d kernels and of the plocal2d
legs; then the single-device kernel cycle; then, on a row mesh, the legs
on rank 0's tiles single/chained: at the fine level plocal2d (packed) and
local2d (unpacked) at nu = 0, 1, 2 and the cap, beside the packed2d legs
on the whole grid; at the next level the local2d legs beside the fused2d
legs on the whole grid.

With ``--ndim 3 --mesh rows`` (a slab mesh of 1) or ``--mesh block`` (a
pencil mesh of 1), the sharded 3D cycle at 511^3 (the default k = 9):
``v_cycle_fn`` and ``v_cycles_fn`` over 20 cycles, then the single-device
kernel cycle, each with the same figures a cycle plus the device time of
the stencil3d kernels and of the cat and copy kernels (on the sharded
route the extended stacks' builds and owned slices, on both the plain
transfers' copies), and each solve's cycles, wall time and peak device
memory.

With ``--no-levels``, the routes alone (no per-level times). With
``--transfers``, only transfer2d.residual_restrict at the composed cycles'
levels 2047...255, beside the zero-sweep fused2d down leg (the same
residual and restriction, with u' stored), single/chained/device. With
``--sparse``, only the BELL SpMM at the SpMV bench's shape (64 x 64 blocks
of 128^2, density 0.15, seed 1) at m = 128 and through bell.spmv's 8-row
carrier, single/chained/device.

With ``--sweeps``, only the fused sweeps as the composed cycles (RB-GS
V(4,4), Jacobi V(8,8)) run them, single/chained/device, at each of their
levels: on the whole grid (paths B and C) and on rank 0's tiles of a row
mesh of 1 (the local2d sweeps of config 5's S3 and S4, and both at S1's
4095 tile, each tile's local2d residual beside them).

With ``--fmg``, one FMG pass (``MultigridSolver.fmg``, RB-GS V(2,2), config
3's 1023^2 at the default k = 10) and one ``solve`` with ``cycle="fmg"``,
float32 and float64: the pass's time (CUDA events), its device busy time,
ops and idle share, the legs' device time by the route's kernel groups,
and the solve's polishing cycles, wall time and peak device memory. With
``--eigen ii`` or ``--eigen lobpcg``, one outer step of config 4's
eigensolve (k = 1, float64, 511^2 at the default k = 9; an II step is the
inner solve's V-cycles, each with its residual check, then the Ritz and
Rayleigh steps; a LOBPCG step one preconditioning V-cycle and the
Rayleigh-Ritz step on [X, W, P]), the same figures a step, and the whole
eigensolve's outer steps, cycles and wall time.

With ``--dtype bfloat16``, the bfloat16 solve's cycle instead (config
dtype bfloat16, kernels on; the default k = 11, the widest whose levels
all stay bfloat16): the kernel route's figures as above, the device time
of the native legs (the row stream's native_down_kernel and
native_up_kernel), of the native RB-GS and Jacobi sweeps
(native_sweep_kernel, native_jacobi_sweep_kernel; a parent tree's
native_rbgs_kernel, native_jacobi_kernel), of the native residual
restriction (native_residual_restrict_kernel; a parent's
native_restrict_kernel), of the native prolongation-add
(native_prolong_add_kernel; a parent's native_prolong_kernel) and of the
native residual (native_bf16.cu's native_residual_kernel), and the native
launches a cycle by the port's counters; no per-level times.

Informative only: nothing is checked. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import re
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

import multigridcmt_tpu_torch as mt
from multigridcmt_tpu_torch import kernels
from multigridcmt_tpu_torch.kernels import (fused2d, local2d, packed2d,
                                           plocal2d, stencil2d, stencil3d)
from multigridcmt_tpu_torch.ops import transfer
from multigridcmt_tpu_torch.utils.profiling import (chained_ms, count_cycles,
                                                   cuda_time_ms)

# The sharded kernels by their names in the profiler: the local2d kernels
# (the residual, local_residual_kernel; the legs and the sweeps, the
# row-streaming down_kernel, up_kernel and sweep_kernel on the UTile frame,
# and the shared-memory local_*_kernel before them, so that a tree from
# before the row stream, timed in turns with this tool, reads the same
# group), and the plocal2d legs (the row stream on the Tile frame;
# plocal_down_kernel and plocal_up_kernel before it).
SHARDED_KERNELS = {
    "local2d kernels": re.compile(r"(?<!\w)local_|(?<!\w)UTile(?!\w)"),
    "plocal2d legs": re.compile(r"(?<!\w)plocal_(down|up)|(?<!\w)Tile(?!\w)"),
}
# The single-device route's row-streaming kernels by name: the fused2d
# legs (down_kernel and up_kernel on the Unpacked frame), the packed2d legs
# (the Whole frame), and the sweeps on each frame (sweep_kernel: stencil2d
# on Unpacked, packed2d on Whole). The sweep groups also take the
# shared-memory sweeps that came before the row stream (a frameless
# sweep_kernel and rbgs_kernel), so that a tree from before it, timed in
# turns with this tool, reads the same groups.
_LEG = r"(?<!\w)(down|up)_kernel<.*(?<!\w){}(?!\w)"
_SWEEP = r"(?<!\w)sweep_kernel<.*(?<!\w){}(?!\w)"
ROUTE_KERNELS = {
    "fused2d legs": re.compile(_LEG.format("Unpacked")),
    "packed2d legs": re.compile(_LEG.format("Whole")),
    "stencil2d sweeps": re.compile(_SWEEP.format("Unpacked")
                                   + r"|(?<!\w)sweep_kernel<(float|double)>"),
    "packed2d sweeps": re.compile(_SWEEP.format("Whole")
                                  + r"|(?<!\w)rbgs_kernel<"),
    # transfer2d.residual_restrict: the row stream's residual_restrict_kernel
    # (its shared-memory rr_kernel before it).
    "residual_restrict": re.compile(r"(?<!\w)(rr|residual_restrict)_kernel<"),
    # The bfloat16 solve's native legs on the row stream; its native RB-GS
    # and Jacobi sweeps (the row stream's native_sweep_kernel and
    # native_jacobi_sweep_kernel, native_bf16.cu's native_rbgs_kernel and
    # native_jacobi_kernel before them), residual restriction (the row
    # stream's native_residual_restrict_kernel, native_restrict_kernel
    # before it) and prolongation-add (the block kernel
    # native_prolong_add_kernel, native_bf16.cu's native_prolong_kernel
    # before it), so that the parent tree, timed in turns with this tool,
    # reads the same groups; native_bf16.cu's residual.
    "native legs": re.compile(r"(?<!\w)native_(down|up)_kernel<"),
    "native sweeps": re.compile(
        r"(?<!\w)native_(sweep|rbgs|jacobi_sweep|jacobi)_kernel"),
    "native restriction": re.compile(
        r"(?<!\w)native_(residual_restrict|restrict)_kernel"),
    "native prolongation": re.compile(
        r"(?<!\w)native_prolong(_add)?_kernel"),
    "native kernels": re.compile(r"(?<!\w)native_residual_kernel"),
}
# The native bfloat16 launch counters a bfloat16 cycle reads (module,
# counter).
NATIVE_COUNTERS = (("fused2d", "down_bf16_launches"),
                   ("fused2d", "up_bf16_launches"),
                   ("stencil2d", "residual_bf16_launches"),
                   ("stencil2d", "rbgs_bf16_launches"),
                   ("stencil2d", "jacobi_bf16_launches"),
                   ("transfer2d", "residual_restrict_bf16_launches"),
                   ("transfer2d", "prolong_add_bf16_launches"))
# The sharded 3D cycle's kernels by name: the stencil3d z-march (the
# RB-GS sweep's rbgs_kernel and rbgs_pairs_kernel, the residual's and
# Jacobi's pass_kernel), and the copies (torch.cat's CatArrayBatchedCopy,
# the strided copies of .contiguous() and of slab writes).
SHARDED3D_KERNELS = {
    "stencil3d kernels": re.compile(
        r"(?<!\w)(rbgs|rbgs_pairs|jacobi_pairs|pass)_kernel<"),
    "cat and copy kernels": re.compile(r"CatArrayBatchedCopy|copy_kernel"),
}
# Cycles of the chain a timing of v_cycles_fn runs.
CHAIN = 20
# Profiled windows a device_busy reading takes the median of: now and then
# a window records fewer kernels than ran, as few as none (on an H100 at
# 700 W a local2d up leg read 0.0485 ms a call against its 0.0654 ms
# bound, and once 0.0000; PERF.md), which one window alone would report
# as a faster call.
PROFILE_WINDOWS = 3


def device_busy(fn, reps: int, groups: dict | None = None):
    """(device ms a call, device ops a call, {name: device ms a call of the
    kernels whose name the pattern groups[name] finds}) over ``reps``
    calls, from the window of PROFILE_WINDOWS with the median device
    time."""
    fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    readings = []
    for _ in range(PROFILE_WINDOWS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ops = sum(1 for e in prof.events() if e.device_type == cuda)
        rows = [e for e in prof.key_averages() if e.device_type == cuda]
        busy = sum(e.device_time_total for e in rows)
        matched = {name: sum(e.device_time_total for e in rows
                             if pat.search(e.key)) / reps / 1e3
                   for name, pat in (groups or {}).items()}
        readings.append((busy / reps / 1e3, ops / reps, matched))
    return sorted(readings, key=lambda r: r[0])[len(readings) // 2]


def grids(n: int, seed: int, ndim: int = 2):
    """u, b (b scaled by 1/h^2) on (n+2)^ndim and e on the coarse grid."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for m in (n, n, (n - 1) // 2):
        g = torch.zeros((m + 2,) * ndim, device="cuda")
        g[(slice(1, -1),) * ndim] = torch.randn((m,) * ndim, generator=gen,
                                                device="cuda")
        out.append(g)
    u, b, e = out
    return u, b * float((n + 1) ** 2), e


def routes(k: int, reps: int, ndim: int, schedule: dict,
           dtype=torch.float32) -> None:
    n = 2 ** k - 1
    # (KERNEL_MIN_N, PACK_MIN_N, KERNEL3_MIN_N)
    shipped = (kernels.KERNEL_MIN_N, kernels.PACK_MIN_N,
               kernels.KERNEL3_MIN_N)
    if dtype == torch.bfloat16:
        table = (("kernel, bfloat16", True) + shipped,)
    elif ndim == 2:
        table = (("kernel", True) + shipped,
                 ("kernel, finest level unpacked", True, shipped[0], n + 1,
                  shipped[2]),
                 ("plain", False) + shipped,
                 ("kernel, KERNEL_MIN_N=7", True, 7) + shipped[1:])
    else:
        table = (("kernel", True) + shipped,
                 ("plain", False) + shipped,
                 ("kernel, KERNEL3_MIN_N=7", True) + shipped[:2] + (7,))
    try:
        for label, use_kernels, *thresholds in table:
            (kernels.KERNEL_MIN_N, kernels.PACK_MIN_N,
             kernels.KERNEL3_MIN_N) = thresholds
            route(label, k, ndim, use_kernels, reps, schedule, dtype)
    finally:
        (kernels.KERNEL_MIN_N, kernels.PACK_MIN_N,
         kernels.KERNEL3_MIN_N) = shipped


def native_launches(fn) -> dict:
    """The native bfloat16 launches of one call of fn, by the counters of
    NATIVE_COUNTERS (those a tree lacks read 0)."""
    import importlib

    mods = {m: importlib.import_module(f"multigridcmt_tpu_torch.kernels.{m}")
            for m, _ in NATIVE_COUNTERS}
    for m, name in NATIVE_COUNTERS:
        if hasattr(mods[m], name):
            setattr(mods[m], name, 0)
    fn()
    torch.cuda.synchronize()
    return {f"{m}.{name}": getattr(mods[m], name, 0)
            for m, name in NATIVE_COUNTERS if getattr(mods[m], name, 0)}


def route(label: str, k: int, ndim: int, use_kernels: bool, reps: int,
          schedule: dict, dtype=torch.float32) -> None:
    """Time one route's cycle and solve under the thresholds set now."""
    prob = mt.poisson(k=k, ndim=ndim, dtype=dtype,
                      use_kernels=use_kernels, device="cuda", **schedule)
    solver = mt.MultigridSolver(prob)
    x0 = torch.zeros_like(prob.b)
    if dtype == torch.bfloat16:
        print(f"{label}: native launches a cycle "
              f"{native_launches(lambda: solver.v_cycle(x0, prob.b))}",
              flush=True)
    ms = cuda_time_ms(lambda: solver.v_cycle(x0, prob.b))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        solver.v_cycle(x0, prob.b)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / 20 * 1e3
    busy, ops, by = device_busy(lambda: solver.v_cycle(x0, prob.b), reps,
                               ROUTE_KERNELS)
    kern = ", ".join(f"{name} {t:.4f}" for name, t in by.items())
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = solver.solve()
    torch.cuda.synchronize()
    solve_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    print(f"{label}: cycle {ms:.4f} ms (events), {host_ms:.4f} ms (host "
          f"clock, 20 back to back), device busy {busy:.4f} ms/cycle "
          f"({kern}), idle share {1 - busy / ms:.4f}, device ops/cycle "
          f"{ops:.0f}; "
          f"solve {res.iters} cycles {solve_ms:.1f} ms, final "
          f"{res.res_history[res.iters].item():.4e}, peak device memory "
          f"{peak} bytes", flush=True)
    del prob, solver, x0, res
    torch.cuda.empty_cache()


@contextlib.contextmanager
def world_of_one(mesh_kind: str):
    """A torch.distributed world of 1 over NCCL (a file rendezvous, no
    network) and its row mesh or (1, 1) block mesh; destroyed on exit."""
    import os
    import tempfile

    import torch.distributed as dist

    from multigridcmt_tpu_torch.parallel import sharded

    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.set_device(0)
        dist.init_process_group(
            "nccl", init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
            world_size=1, rank=0)
        try:
            yield (sharded.make_mesh() if mesh_kind == "rows"
                   else sharded.make_block_mesh((1, 1)))
        finally:
            dist.destroy_process_group()


def sharded_routes(k: int, reps: int, mesh_kind: str,
                   schedule: dict) -> None:
    """The sharded cycle on a mesh of 1, as shipped and with KERNEL_MIN_N
    = 7, then the single-device kernel route."""
    from multigridcmt_tpu_torch.parallel import sharded

    shipped = kernels.KERNEL_MIN_N
    with world_of_one(mesh_kind) as mesh:
        try:
            for label, kmin in ((f"sharded {mesh_kind}", shipped),
                                (f"sharded {mesh_kind}, KERNEL_MIN_N=7", 7)):
                kernels.KERNEL_MIN_N = kmin
                prob = mt.poisson2d(k=k, dtype=torch.float32,
                                    use_kernels=True, device="cuda",
                                    **schedule)
                solver = sharded.ShardedSolver(prob.config, mesh)
                cycle = solver.v_cycle_fn()
                b = sharded.shard_rhs(prob.b, mesh, solver.decomp)
                x = torch.zeros_like(b)
                chain = solver.v_cycles_fn()
                for what, fn, cycles in (
                        ("v_cycle_fn", lambda: cycle(x, b), 1),
                        (f"v_cycles_fn, {CHAIN} chained",
                         lambda: chain(x, b, CHAIN), CHAIN)):
                    sharded_cycle(f"{label}, {what}", fn, cycles, reps)
                del prob, solver, b, x, chain
                torch.cuda.empty_cache()
        finally:
            kernels.KERNEL_MIN_N = shipped
    route("single device, kernel", k, 2, True, reps, schedule)
    if mesh_kind == "rows":
        tile_legs(k, schedule)


def sharded3d_routes(k: int, reps: int, mesh_kind: str,
                     schedule: dict) -> None:
    """The sharded 3D cycle on a slab (rows) or pencil (block) mesh of 1,
    one cycle and the chain, then the single-device kernel cycle; each
    route's solve."""
    from multigridcmt_tpu_torch.parallel import sharded

    prob = mt.poisson3d(k=k, dtype=torch.float32, use_kernels=True,
                        device="cuda", **schedule)
    with world_of_one(mesh_kind) as mesh:
        solver = sharded.ShardedSolver(prob.config, mesh)
        cycle = solver.v_cycle_fn()
        b = sharded.shard_rhs(prob.b, mesh, solver.decomp)
        x = torch.zeros_like(b)
        chain = solver.v_cycles_fn()
        label = "sharded 3D " + ("slab" if mesh_kind == "rows" else "pencil")
        for what, fn, cycles in (
                ("v_cycle_fn", lambda: cycle(x, b), 1),
                (f"v_cycles_fn, {CHAIN} chained",
                 lambda: chain(x, b, CHAIN), CHAIN)):
            sharded_cycle(f"{label}, {what}", fn, cycles, reps,
                          SHARDED3D_KERNELS)
        solve_line(label, lambda: solver.solve(prob.b))
        del solver, b, x, chain
    single = mt.MultigridSolver(prob)
    x0 = torch.zeros_like(prob.b)
    sharded_cycle("single device, kernel", lambda: single.v_cycle(x0, prob.b),
                  1, reps, SHARDED3D_KERNELS)
    solve_line("single device, kernel", single.solve)


def solve_line(label: str, solve) -> None:
    """One line for a solve: cycles, wall time, peak device memory."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = solve()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    print(f"{label}: solve {res.iters} cycles {wall:.1f} ms, final "
          f"{res.res_history[res.iters].item():.4e}, peak device memory "
          f"{torch.cuda.max_memory_allocated()} bytes", flush=True)


def sharded_cycle(label: str, fn, cycles: int, reps: int,
                  groups: dict = SHARDED_KERNELS) -> None:
    """One line for a sharded cycle: fn runs ``cycles`` cycles; the
    device time of the kernels ``groups`` names."""
    ms = cuda_time_ms(fn, reps=max(1, 20 // cycles)) / cycles
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(max(1, 20 // cycles)):
        fn()
    torch.cuda.synchronize()
    host_ms = ((time.perf_counter() - t0) * 1e3
               / (max(1, 20 // cycles) * cycles))
    busy, ops, by = device_busy(fn, max(1, reps // cycles), groups)
    busy, ops = busy / cycles, ops / cycles
    kern = ", ".join(f"{name} {t / cycles:.4f}" for name, t in by.items())
    print(f"{label}: cycle {ms:.4f} ms (events), {host_ms:.4f} ms (host "
          f"clock, 20 cycles back to back), device busy {busy:.4f} ms/cycle "
          f"({kern}), idle share {1 - busy / ms:.4f}, device ops/cycle "
          f"{ops:.0f}", flush=True)


def row_tile(n: int, seed: int):
    """u, b, e on the (n+2)^2 grid (as ``grids``) and rank 0's extended
    tiles of them on a row mesh of 1 (m = n + 1 owned rows, row offset
    1 - HALO_ROWS): ue, be and the coarse ee."""
    hh = local2d.HALO_ROWS
    off = 1 - hh
    u, b, e = grids(n, seed=seed)
    ue, be = (torch.zeros((n + 1 + 2 * hh, n + 2), device="cuda")
              for _ in range(2))
    ue[-off:-off + n + 2], be[-off:-off + n + 2] = u, b
    nc = (n - 1) // 2
    ee = torch.zeros(((n + 1) // 2 + 2 * hh, nc + 2), device="cuda")
    c0 = -local2d.coarse_offset(off)       # coarse row 0 in the tile
    ee[c0:c0 + nc + 2] = e
    return u, b, e, ue, be, ee


def tile_legs(k: int, schedule: dict) -> None:
    """The leg levels' legs on rank 0's tiles of a row mesh of 1: at the
    fine level plocal2d on the packed tile and local2d on the unpacked
    one, at nu = 0, 1, 2 and the cap, beside the packed2d legs on the whole
    packed grid at the schedule's nu; at the next level (unpacked) the
    local2d legs beside the fused2d legs on the whole grid, at the
    schedule's nu (none where a leg does not fuse it)."""
    kind = schedule["smoother"]
    nu1, nu2 = schedule["nu1"], schedule["nu2"]
    if kind == "chebyshev" or nu1 > local2d.max_down_sweeps(kind) \
            or nu2 > local2d.max_up_sweeps(kind):
        return
    kw = dict(kind=kind, omega=1.0 if kind == "rbgs" else 0.8)
    off = 1 - local2d.HALO_ROWS
    n = 2 ** k - 1
    nc, h = (n - 1) // 2, 1.0 / (n + 1)
    u, b, e, ue, be, ee = row_tile(n, k)
    su, sb = plocal2d.pack_ext(ue, 0), plocal2d.pack_ext(be, 0)
    for nu in sorted({0, 1, 2, local2d.max_down_sweeps(kind)}):
        print_level(n, {
            f"tile nu={nu}: plocal2d down": lambda: plocal2d.down_leg(
                su, sb, n, h, n + 1, off, sweeps=nu, **kw),
            "local2d down": lambda: local2d.down_leg(
                ue, be, n, h, n + 1, off, sweeps=nu, **kw),
            "plocal2d up": lambda: plocal2d.up_leg(
                su, ee, sb, n, nc, h, n + 1, off, sweeps=nu, **kw),
            "local2d up": lambda: local2d.up_leg(
                ue, ee, be, n, nc, h, n + 1, off, sweeps=nu, **kw)})
    pu, pb = packed2d.pack(u), packed2d.pack(b)
    print_level(n, {
        f"whole grid: packed2d down nu={nu1}":
            lambda: packed2d.smooth_residual_restrict(pu, pb, n, h,
                                                      sweeps=nu1, **kw),
        f"packed2d up nu={nu2}":
            lambda: packed2d.prolong_add_smooth(pu, e, pb, n, nc, h,
                                                sweeps=nu2, **kw)})
    del u, b, e, ue, be, ee, su, sb, pu, pb
    n = 2 ** (k - 1) - 1
    nc, h = (n - 1) // 2, 1.0 / (n + 1)
    u, b, e, ue, be, ee = row_tile(n, k - 1)
    print_level(n, {
        f"tile: local2d down nu={nu1}": lambda: local2d.down_leg(
            ue, be, n, h, n + 1, off, sweeps=nu1, **kw),
        f"local2d up nu={nu2}": lambda: local2d.up_leg(
            ue, ee, be, n, nc, h, n + 1, off, sweeps=nu2, **kw),
        f"whole grid: fused2d down nu={nu1}":
            lambda: fused2d.smooth_residual_restrict(u, b, n, h, sweeps=nu1,
                                                     **kw),
        f"fused2d up nu={nu2}": lambda: fused2d.prolong_add_smooth(
            u, e, b, n, nc, h, sweeps=nu2, **kw)})


def leg_calls(u, b, e, n, h, kind, omega, nu1, nu2):
    """The down and up legs of one level as the kernel backend's cycle runs
    them, and whether each fuses."""
    bk = kernels.KERNEL_BACKEND
    nc = (n - 1) // 2
    kw = dict(kind=kind, omega=omega)
    fused_down = bk.smooth_residual_restrict(u, b, n, h, sweeps=nu1,
                                             **kw) is not None
    fused_up = bk.prolong_add_smooth(u, e, b, n, nc, h, sweeps=nu2,
                                     **kw) is not None

    def down():
        if fused_down:
            return bk.smooth_residual_restrict(u, b, n, h, sweeps=nu1, **kw)
        x = bk.smooth(u, b, n, h, sweeps=nu1, **kw)
        return bk.residual_restrict(x, b, n, h)

    def up():
        if fused_up:
            return bk.prolong_add_smooth(u, e, b, n, nc, h, sweeps=nu2,
                                         **kw)
        return bk.smooth(bk.prolong_add(u, e, n, nc), b, n, h, sweeps=nu2,
                         **kw)

    return down, up, fused_down, fused_up


def levels(k: int, schedule: dict) -> None:
    kind = schedule["smoother"]
    omega = 1.0 if kind == "rbgs" else 0.8
    shipped = kernels.KERNEL_MIN_N
    kernels.KERNEL_MIN_N = 7          # every level on the kernel tier
    try:
        for j in range(k, 2, -1):
            level(2 ** j - 1, j, kind, omega, schedule)
    finally:
        kernels.KERNEL_MIN_N = shipped


def level(n: int, seed: int, kind: str, omega: float,
          schedule: dict) -> None:
    """Time one level's legs, unpacked and packed, and its check."""
    h = 1.0 / (n + 1)
    u, b, e = grids(n, seed=seed)
    su, sb = packed2d.pack(u), packed2d.pack(b)
    row = {}
    for tag, uu, bb in (("", u, b), ("packed ", su, sb)):
        down, up, fd, fu = leg_calls(uu, bb, e, n, h, kind, omega,
                                     schedule["nu1"], schedule["nu2"])
        row[f"{tag}down ({'fused' if fd else 'composed'})"] = down
        row[f"{tag}up ({'fused' if fu else 'composed'})"] = up
    row["residual"] = lambda: stencil2d.residual(u, b, n, h)
    row["packed norm"] = lambda: packed2d.residual_norm_sq(
        su, sb, n, h, red_only=kind == "rbgs")
    print_level(n, row)


def print_level(n: int, row: dict) -> None:
    """One level's line: each call's single/chained/device ms."""
    print(f"level n={n}: " + ", ".join(
        f"{key} {cuda_time_ms(fn):.4f}/{chained_ms(fn):.4f}/"
        f"{device_busy(fn, 20)[0]:.4f} ms" for key, fn in row.items()),
        flush=True)


def sweeps() -> None:
    """The fused sweeps as the composed cycles run them: the packed RB-GS
    sweep at 4095^2 (nu = 4, path B's, and nu = 1, the smoother figure),
    the stencil2d RB-GS sweep at nu = 4 at 2047...255 (B) and the Jacobi
    sweep at nu = 8 at 1023...255 (C), each single/chained/device; then the
    local2d sweeps on rank 0's tiles of a row mesh of 1, RB-GS nu = 4 at
    4095...255 (S3's levels 2047...255) and Jacobi nu = 8 at 4095 and
    1023...255 (S4's levels 1023...255), and the local2d residual there
    (the composed route's other kernel)."""
    n = 4095
    h = 1.0 / (n + 1)
    u, b, _ = grids(n, seed=12)
    su, sb = packed2d.pack(u), packed2d.pack(b)
    del u, b
    print_level(n, {f"packed2d rbgs nu={nu}": (
        lambda nu=nu: packed2d.rbgs_sweep(su, sb, n, h, sweeps=nu))
        for nu in (4, 1)})
    del su, sb
    for n in (2047, 1023, 511, 255):
        h = 1.0 / (n + 1)
        u, b, _ = grids(n, seed=n)
        row = {"stencil2d rbgs nu=4": lambda: stencil2d.rbgs_sweep(
            u, b, n, h, sweeps=4)}
        if n <= 1023:
            row["stencil2d jacobi nu=8"] = lambda: stencil2d.jacobi_sweep(
                u, b, n, h, 0.8, sweeps=8)
        print_level(n, row)
        del u, b
    off = 1 - local2d.HALO_ROWS
    for n in (4095, 2047, 1023, 511, 255):
        h = 1.0 / (n + 1)
        *_, ue, be, _ = row_tile(n, n)
        row = {f"tile {tuple(ue.shape)}: local2d rbgs nu=4":
               lambda: local2d.rbgs_sweep(ue, be, n, h, off, sweeps=4)}
        if n <= 1023 or n == 4095:
            row["local2d jacobi nu=8"] = lambda: local2d.jacobi_sweep(
                ue, be, n, h, 0.8, off, sweeps=8)
        row["local2d residual"] = lambda: local2d.residual(ue, be, n, h, off)
        print_level(n, row)
        del ue, be


def transfers() -> None:
    """residual_restrict at 2047...255 beside the zero-sweep fused2d down
    leg (float32)."""
    from multigridcmt_tpu_torch.kernels import transfer2d

    for n in (2047, 1023, 511, 255):
        h = 1.0 / (n + 1)
        u, b, _ = grids(n, seed=n)
        print_level(n, {
            "residual_restrict": lambda: transfer2d.residual_restrict(
                u, b, n, h),
            "fused2d down nu=0": lambda: fused2d.smooth_residual_restrict(
                u, b, n, h, kind="rbgs", omega=1.0, sweeps=0)})
        del u, b


def bell_bench(dtype=torch.float32, m: int = 128):
    """The SpMV bench's blocked-ELL matrix (bench_spmv.py: 64 x 64 blocks
    of 128^2 N(0,1) values at density 0.15 plus the block diagonal, seed
    1) as a BELL on the card, and an (m, 8192) Xt of N(0,1) values."""
    import numpy as np
    import scipy.sparse as sp

    from multigridcmt_tpu_torch.kernels import bell

    rng = np.random.default_rng(1)
    mask = rng.random((64, 64)) < 0.15
    mask[np.arange(64), np.arange(64)] = True
    blocks = {(i, j): rng.standard_normal((128, 128)).astype(np.float32)
              for i, j in zip(*np.nonzero(mask))}
    a_sp = sp.bmat([[sp.csr_matrix(blocks[(i, j)]) if (i, j) in blocks
                     else None for j in range(64)] for i in range(64)],
                   format="csr")
    xt = torch.from_numpy(rng.standard_normal((m, 64 * 128))).to(dtype)
    return bell.bell_from_scipy(a_sp, dtype=dtype, device="cuda"), xt.cuda()


def sparse() -> None:
    """The BELL SpMM at the SpMV bench's shape (``bell_bench``), float32,
    at m = 128 and through bell.spmv's 8-row carrier."""
    from multigridcmt_tpu_torch.kernels import bell

    a, xt = bell_bench()
    x = xt[0].clone()
    print(f"bell kmax={a.kmax}: " + ", ".join(
        f"{key} {cuda_time_ms(fn):.4f}/{chained_ms(fn):.4f}/"
        f"{device_busy(fn, 20)[0]:.4f} ms" for key, fn in (
            ("spmm m=128", lambda: bell.spmm(a, xt)),
            ("spmv carrier m=8", lambda: bell.spmv(a, x)))), flush=True)


def levels3(k: int) -> None:
    for j in range(k, 2, -1):
        n = 2 ** j - 1
        h = 1.0 / (n + 1)
        u, b, e = grids(n, seed=j, ndim=3)
        print_level(n, {
            "rbgs sweep": lambda: stencil3d.rbgs_sweep(u, b, n, h),
            "residual": lambda: stencil3d.residual(u, b, n, h),
            "restrict (plain)": lambda: transfer.restrict(u),
            "prolong+add (plain)": lambda: u + transfer.prolong(e),
        })
        del u, b, e


def fmg(k: int, reps: int) -> None:
    """One FMG pass and one FMG solve at 2^k - 1, float32 and float64."""
    for dtype in (torch.float32, torch.float64):
        prob = mt.poisson2d(k=k, dtype=dtype, smoother="rbgs",
                            use_kernels=True, device="cuda", cycle="fmg")
        solver = mt.MultigridSolver(prob)
        ms = cuda_time_ms(solver.fmg, reps=10, warmup=2)
        busy, ops, by = device_busy(solver.fmg, reps, ROUTE_KERNELS)
        kern = ", ".join(f"{name} {t:.4f}" for name, t in by.items() if t)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = solver.solve()
        torch.cuda.synchronize()
        solve_ms = (time.perf_counter() - t0) * 1e3
        print(f"fmg {2 ** k - 1}^2 {str(dtype).split('.')[-1]}: pass "
              f"{ms:.4f} ms (events), device busy {busy:.4f} ms ({kern}), "
              f"idle share {1 - busy / ms:.4f}, device ops {ops:.0f}; "
              f"solve(cycle='fmg') {res.iters} polishing cycles "
              f"{solve_ms:.1f} ms, final "
              f"{res.res_history[res.iters].item():.4e}, l2 error "
              f"{solver.discrete_l2_error(res.x).item():.4e}, peak device "
              f"memory {torch.cuda.max_memory_allocated()} bytes",
              flush=True)
        del prob, solver, res
        torch.cuda.empty_cache()


def eigen_step(k: int, method: str, reps: int) -> None:
    """One outer step of the k=1 float64 eigensolve at 2^k - 1 by
    ``method``, from the solve's own start block (max_iters=1 runs
    exactly one step; LOBPCG's iteration 0 is that step), and the whole
    eigensolve."""
    prob = mt.poisson2d(k=k, dtype=torch.float64, smoother="rbgs",
                        use_kernels=True, device="cuda")
    solver = mt.MultigridSolver(prob)

    def step():
        return solver.eigensolve(k=1, method=method, max_iters=1)

    ms = cuda_time_ms(step, reps=5, warmup=1)
    busy, ops, by = device_busy(step, reps, ROUTE_KERNELS)
    kern = ", ".join(f"{name} {t:.4f}" for name, t in by.items() if t)
    with count_cycles() as one:
        step()
    torch.cuda.reset_peak_memory_stats()
    with count_cycles() as whole:
        t0 = time.perf_counter()
        res = solver.eigensolve(k=1, method=method)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    print(f"eigen {method} {2 ** k - 1}^2 float64, one outer step: "
          f"{ms:.4f} ms (events), {one.count} V-cycles, device busy "
          f"{busy:.4f} ms ({kern}), idle share {1 - busy / ms:.4f}, device "
          f"ops {ops:.0f}; eigensolve {res.iters} outer steps, {whole.count} "
          f"V-cycles, {wall:.1f} ms, lambda_1 "
          f"{res.eigenvalues[0].item():.12f}, peak device memory "
          f"{torch.cuda.max_memory_allocated()} bytes", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ndim", type=int, default=2, choices=(2, 3))
    ap.add_argument("--k", type=int, default=None,
                    help="default 12 in 2D, 9 in 3D")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--smoother", default="rbgs",
                    choices=("rbgs", "jacobi", "chebyshev"))
    ap.add_argument("--nu1", type=int, default=2)
    ap.add_argument("--nu2", type=int, default=2)
    ap.add_argument("--mesh", choices=("rows", "block"), default=None,
                    help="break down the sharded cycle on a mesh of 1 (in "
                    "3D: slabs or pencils)")
    ap.add_argument("--sweeps", action="store_true",
                    help="time the fused sweeps of the composed cycles only")
    ap.add_argument("--transfers", action="store_true",
                    help="time residual_restrict at 2047...255 only")
    ap.add_argument("--sparse", action="store_true",
                    help="time the BELL SpMM at the bench shape only")
    ap.add_argument("--no-levels", action="store_true",
                    help="the routes only, no per-level times")
    ap.add_argument("--fmg", action="store_true",
                    help="one FMG pass and FMG solve (default k=10) only")
    ap.add_argument("--eigen", choices=("ii", "rqi", "lobpcg"), default=None,
                    help="one eigensolve outer step (default k=9) only")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32",
                    help="bfloat16: the bfloat16 solve's cycle (default "
                    "k=11), the kernel route only")
    args = ap.parse_args()
    bf16 = args.dtype == "bfloat16"
    k = args.k if args.k is not None else (
        10 if args.fmg else 9 if args.eigen else 11 if bf16
        else {2: 12, 3: 9}[args.ndim])
    schedule = dict(smoother=args.smoother, nu1=args.nu1, nu2=args.nu2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    if args.fmg or args.eigen:
        if args.fmg:
            fmg(k, args.reps)
        if args.eigen:
            eigen_step(k, args.eigen, args.reps)
        return
    if args.sweeps or args.transfers or args.sparse:
        for flag, fn in ((args.sweeps, sweeps), (args.transfers, transfers),
                         (args.sparse, sparse)):
            if flag:
                fn()
        return
    if args.mesh is not None:
        (sharded_routes if args.ndim == 2 else sharded3d_routes)(
            k, args.reps, args.mesh, schedule)
        return
    if bf16:
        routes(k, args.reps, 2, schedule, torch.bfloat16)
        return
    routes(k, args.reps, args.ndim, schedule)
    if args.no_levels:
        return
    if args.ndim == 2:
        levels(k, schedule)
    else:
        levels3(k)


if __name__ == "__main__":
    main()
