"""Where the V-cycle's time goes on one CUDA card.

    python -m multigridcmt_tpu_torch.utils.breakdown [--k 12] [--reps 5]
    python -m multigridcmt_tpu_torch.utils.breakdown --smoother chebyshev
    python -m multigridcmt_tpu_torch.utils.breakdown --nu1 4 --nu2 4
    python -m multigridcmt_tpu_torch.utils.breakdown --ndim 3 [--k 9]
    python -m multigridcmt_tpu_torch.utils.breakdown --mesh rows|block

For each route of the float32 V(nu1,nu2) cycle (default RB-GS V(2,2)) at
2^k - 1 (k=12: 4095^2; in 3D, k=9: 511^3), prints the cycle time (CUDA
events, median of 20), the host-clock time of 20 cycles back to back, the
device-busy time a cycle and the device ops a cycle (``torch.profiler``,
summed over the kernel rows), the idle share 1 - busy/cycle, and the
solve's cycle count, wall time and peak device memory. The routes: the
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
prolongation. Each per-level time is given as single/chained ms: one call
timed alone (CUDA events, median of 20; the wrapper's host work inside)
and the time a call of 20 back-to-back calls between one pair of events
(the device's time once the host runs ahead, as inside a cycle).

With ``--mesh``, the sharded cycle instead (parallel/sharded.py, a
torch.distributed world of 1 over NCCL, a row mesh or a (1, 1) block mesh;
``ShardedSolver.v_cycle_fn``, owned tiles in and out): the same figures
plus the device time of the local2d kernels, as shipped and with
KERNEL_MIN_N = 7 (the plain owned-tile levels 127 and 63 on the leg
kernels too), beside the single-device kernel cycle.

Informative only: nothing is checked. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

import multigridcmt_tpu_torch as mt
from multigridcmt_tpu_torch import kernels
from multigridcmt_tpu_torch.kernels import packed2d, stencil2d, stencil3d
from multigridcmt_tpu_torch.ops import transfer
from multigridcmt_tpu_torch.utils.profiling import chained_ms, cuda_time_ms


def device_busy(fn, reps: int, match: str = ""):
    """(device ms a call, device ops a call, device ms a call of the kernels
    whose name contains ``match``) over ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    ops = sum(1 for e in prof.events() if e.device_type == cuda)
    rows = [e for e in prof.key_averages() if e.device_type == cuda]
    busy = sum(e.device_time_total for e in rows)
    matched = sum(e.device_time_total for e in rows
                  if match and match in e.key)
    return busy / reps / 1e3, ops / reps, matched / reps / 1e3


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


def routes(k: int, reps: int, ndim: int, schedule: dict) -> None:
    n = 2 ** k - 1
    # (KERNEL_MIN_N, PACK_MIN_N, KERNEL3_MIN_N)
    shipped = (kernels.KERNEL_MIN_N, kernels.PACK_MIN_N,
               kernels.KERNEL3_MIN_N)
    if ndim == 2:
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
            route(label, k, ndim, use_kernels, reps, schedule)
    finally:
        (kernels.KERNEL_MIN_N, kernels.PACK_MIN_N,
         kernels.KERNEL3_MIN_N) = shipped


def route(label: str, k: int, ndim: int, use_kernels: bool, reps: int,
          schedule: dict) -> None:
    """Time one route's cycle and solve under the thresholds set now."""
    prob = mt.poisson(k=k, ndim=ndim, dtype=torch.float32,
                      use_kernels=use_kernels, device="cuda", **schedule)
    solver = mt.MultigridSolver(prob)
    x0 = torch.zeros_like(prob.b)
    ms = cuda_time_ms(lambda: solver.v_cycle(x0, prob.b))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        solver.v_cycle(x0, prob.b)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / 20 * 1e3
    busy, ops, _ = device_busy(lambda: solver.v_cycle(x0, prob.b), reps)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = solver.solve()
    torch.cuda.synchronize()
    solve_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    print(f"{label}: cycle {ms:.4f} ms (events), {host_ms:.4f} ms (host "
          f"clock, 20 back to back), device busy {busy:.4f} ms/cycle, "
          f"idle share {1 - busy / ms:.4f}, device ops/cycle {ops:.0f}; "
          f"solve {res.iters} cycles {solve_ms:.1f} ms, final "
          f"{res.res_history[res.iters].item():.4e}, peak device memory "
          f"{peak} bytes", flush=True)
    del prob, solver, x0, res
    torch.cuda.empty_cache()


def sharded_routes(k: int, reps: int, mesh_kind: str,
                   schedule: dict) -> None:
    """The sharded cycle on a mesh of 1, as shipped and with KERNEL_MIN_N
    = 7, then the single-device kernel route."""
    import os
    import tempfile

    import torch.distributed as dist

    from multigridcmt_tpu_torch.parallel import sharded

    shipped = kernels.KERNEL_MIN_N
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.set_device(0)
        dist.init_process_group(
            "nccl", init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
            world_size=1, rank=0)
        try:
            mesh = (sharded.make_mesh() if mesh_kind == "rows"
                    else sharded.make_block_mesh((1, 1)))
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
                ms = cuda_time_ms(lambda: cycle(x, b))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(20):
                    cycle(x, b)
                torch.cuda.synchronize()
                host_ms = (time.perf_counter() - t0) / 20 * 1e3
                busy, ops, local = device_busy(lambda: cycle(x, b), reps,
                                               match="local_")
                print(f"{label}: cycle {ms:.4f} ms (events), {host_ms:.4f} "
                      f"ms (host clock, 20 back to back), device busy "
                      f"{busy:.4f} ms/cycle (local2d kernels {local:.4f}), "
                      f"idle share {1 - busy / ms:.4f}, device ops/cycle "
                      f"{ops:.0f}", flush=True)
                del prob, solver, b, x
                torch.cuda.empty_cache()
        finally:
            kernels.KERNEL_MIN_N = shipped
            dist.destroy_process_group()
    route("single device, kernel", k, 2, True, reps, schedule)


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
    """One level's line: each call's single/chained ms."""
    print(f"level n={n}: " + ", ".join(
        f"{key} {cuda_time_ms(fn):.4f}/{chained_ms(fn):.4f} ms"
        for key, fn in row.items()), flush=True)


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
                    help="break down the sharded 2D cycle on a mesh of 1")
    args = ap.parse_args()
    k = args.k if args.k is not None else {2: 12, 3: 9}[args.ndim]
    schedule = dict(smoother=args.smoother, nu1=args.nu1, nu2=args.nu2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    if args.mesh is not None:
        sharded_routes(k, args.reps, args.mesh, schedule)
        return
    routes(k, args.reps, args.ndim, schedule)
    if args.ndim == 2:
        levels(k, schedule)
    else:
        levels3(k)


if __name__ == "__main__":
    main()
