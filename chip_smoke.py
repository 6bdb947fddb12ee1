#!/usr/bin/env python3
"""Drive the PyTorch port (multigridcmt_tpu_torch) on one CUDA card.

Phases:
  1. set-up: the card's name and power limit, the CUDA version, and the
     build of the kernel library from the sources in this checkout;
  2. each CUDA kernel against its plain PyTorch version on the card;
  3. the main path through the public entry points: the 4095^2 float32
     RB-GS solve (launch counts, residual, error against the analytic
     solution), kernel against plain V-cycles, and float64 solves at k=10
     and k=12 against the plain path;
  4. times (CUDA events, warm-up, median of 20): one V(2,2) cycle at
     4095^2 float32 on the kernel and the plain path, each kernel against
     its plain version at the main path's shapes, the packed kernels
     against their unpacked twins at 4095^2, and the peak device memory.

The main path's kernels: at k=12 the 4095 level is color-packed
(kernels.PACK_MIN_N) and runs the packed2d down and up legs and the fused
residual norm of the convergence check; levels 2047..255 run the fused2d
legs. The stencil2d residual kernel checks convergence on an unpacked fine
level (k = 8..11); it is held against its plain version in phase 2 and
driven by the float64 k=10 solve in phase 3.

Run from the root of the repository:  python3 chip_smoke.py
Any failed check exits non-zero. Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result. The
line before the last is a JSON object with the main path's kernels; the
last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

MAIN_K = 12                 # 4095^2 fine grid
SIGMA = 11.5
# Kernel against plain on the card, as max|kernel - plain| / max|plain|
# (for the squared norms, |kernel - plain| / plain).
# float64: the kernels contract a*b+c into FMAs, multiply by 1/(4 -
# sigma h^2) where the plain version divides, and the packed kernels sum
# the neighbours in another order: a few ulp a sweep; 1e-12 leaves room for
# the residual's cancellation (up to ~4/h^2 |u| / |r|).
# float32: the same ulp-level differences, amplified by that cancellation
# in the restricted residual, stay near 1e-6 of its largest value at
# n=4095 for the inputs below; the norms differ by the plain version's
# float32 summation over up to 8.4M squares (the kernel sums in float64).
# 1e-5 bounds both.
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
COMPARE_SHAPES = [(torch.float32, 4095), (torch.float32, 2047),
                  (torch.float32, 255), (torch.float32, 1023),
                  (torch.float64, 255), (torch.float64, 1023)]
# 5 V-cycles at 4095^2, kernel path against plain path, relative l2. The
# packed down leg restricts the red residual only (the black one is zero
# after an RB-GS sweep in exact arithmetic, as in the JAX package); the
# plain path also restricts the black residual's rounding. float32 is at
# its rounding floor after one cycle at this h (relative residual ~0.1):
# the iterates differ by that floor's noise, ~1e-3 of |x| (their error
# against u_exact is ~3e-3), so 1e-2. float64 has no such floor here, and
# the dropped rounding moves x by far less than 1e-9.
VCYCLE_RTOL = {torch.float32: 1e-2, torch.float64: 1e-9}
F64_TOL = 1e-8


class SmokeFailure(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def grids_on_card(n: int, dtype, seed: int, count: int):
    """``count`` padded (n+2)^2 grids with N(0,1) interiors, made on the
    card from ``seed``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for _ in range(count):
        g = torch.zeros((n + 2, n + 2), dtype=dtype, device="cuda")
        g[1:-1, 1:-1] = torch.randn((n, n), generator=gen, device="cuda",
                                    dtype=torch.float64).to(dtype)
        out.append(g)
    return out


def leg_inputs(n: int, dtype, seed: int):
    """u, b, e for the legs: b is scaled by 1/h^2 so that h^2 b and the
    neighbour sum of the Gauss-Seidel update are of one size."""
    u, b = grids_on_card(n, dtype, seed, 2)
    (e,) = grids_on_card((n - 1) // 2, dtype, seed + 1, 1)
    return u, b * float((n + 1) ** 2), e


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max abs error / max|want|)."""
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    return err, err / scale if scale > 0 else err


def ghosts_zero(t: torch.Tensor) -> bool:
    return bool((t[0] == 0).all() and (t[-1] == 0).all()
                and (t[:, 0] == 0).all() and (t[:, -1] == 0).all())


def logical(t: torch.Tensor) -> torch.Tensor:
    """A kernel output as a logical grid; raises if a packed output's pad
    lanes are not zero."""
    from multigridcmt_tpu_torch.kernels import packed2d

    if not packed2d.is_packed(t):
        return t
    u = packed2d.unpack(t)
    require(torch.equal(packed2d.pack(u), t), "packed pad lanes not zero")
    return u


def phase_setup():
    from multigridcmt_tpu_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.load_library()
    log(f"kernel build+load: {time.perf_counter() - t0:.2f} s "
        f"({_build.BUILD_ROOT / _build.source_hash()})")
    return card


def check_pair(label: str, got, want, tol: float, shape=None):
    """Hold a kernel output against its plain version; returns (max abs
    error, relative error, tol). Arrays: relative to max|want|, ghosts
    zero; 0-d: relative to |want|."""
    torch.cuda.synchronize()
    if got.ndim == 0:
        err = (got - want).abs().item()
        rel = err / max(want.abs().item(), 1e-300)
        ok = got.shape == want.shape
    else:
        g, w = logical(got), logical(want)
        err, rel = rel_err(g, w)
        ok = ghosts_zero(g) and (shape is None or tuple(g.shape) == shape)
    log(f"  {label}: rel {rel:.3e}")
    require(ok and rel <= tol, f"{label}: rel {rel:.3e} > {tol} or bad "
            "ghosts/shape")
    return err, rel, tol


def phase_compare():
    """Each kernel against its plain version on the card. Returns (max abs
    error, relative error, tolerance) per kernel at the main path's shapes
    (float32, RB-GS, nu=2, sigma=0; packed at n=4095, fused2d and
    stencil2d at n=2047); of a leg's two outputs, the one with the larger
    relative error."""
    from multigridcmt_tpu_torch.kernels import fused2d, packed2d, stencil2d

    main_err = {}
    for dtype, n in COMPARE_SHAPES:
        h = 1.0 / (n + 1)
        nc = (n - 1) // 2
        tol = TOL[dtype]
        u, b, e = leg_inputs(n, dtype, seed=n)
        su, sb, se = packed2d.pack(u), packed2d.pack(b), packed2d.pack(e)
        name = f"{str(dtype).split('.')[-1]} n={n}"
        main = dtype == torch.float32
        for sigma in (0.0, SIGMA):
            err = check_pair(
                f"residual {name} sigma={sigma}",
                stencil2d.residual(u, b, n, h, sigma=sigma),
                stencil2d.residual_plain(u, b, n, h, sigma=sigma), tol)
            if main and n == 2047 and sigma == 0.0:
                main_err["stencil2d_residual"] = err
            for red_only in (False, True):
                err = check_pair(
                    f"resnorm {name} red_only={red_only} sigma={sigma}",
                    packed2d.residual_norm_sq(su, sb, n, h, sigma=sigma,
                                              red_only=red_only),
                    packed2d.residual_norm_sq_plain(
                        su, sb, n, h, sigma=sigma, red_only=red_only), tol)
                if main and n == 4095 and red_only and sigma == 0.0:
                    main_err["packed2d_resnorm"] = err
            for kind, omega in (("rbgs", 1.0), ("jacobi", 0.8)):
                kw = dict(kind=kind, omega=omega, sigma=sigma)
                at_main = main and kind == "rbgs" and sigma == 0.0
                for sweeps in sorted({2, fused2d.max_down_sweeps(kind)}):
                    gu, grc = fused2d.smooth_residual_restrict(
                        u, b, n, h, sweeps=sweeps, **kw)
                    wu, wrc = fused2d.smooth_residual_restrict_plain(
                        u, b, n, h, sweeps=sweeps, **kw)
                    label = f"down {name} {kind} nu={sweeps} sigma={sigma}"
                    err = max(check_pair(label + " u'", gu, wu, tol),
                              check_pair(label + " r_c", grc, wrc, tol,
                                         (nc + 2, nc + 2)),
                              key=lambda t: t[1])
                    if at_main and n == 2047 and sweeps == 2:
                        main_err["fused2d_down"] = err
                    for pc in (False, True) if sweeps == 2 else (False,):
                        gu, grc = packed2d.smooth_residual_restrict(
                            su, sb, n, h, sweeps=sweeps, packed_coarse=pc,
                            **kw)
                        wu, wrc = packed2d.smooth_residual_restrict_plain(
                            su, sb, n, h, sweeps=sweeps, packed_coarse=pc,
                            **kw)
                        label = (f"packed down {name} {kind} nu={sweeps} "
                                 f"sigma={sigma} packed_coarse={pc}")
                        err = max(check_pair(label + " u'", gu, wu, tol),
                                  check_pair(label + " r_c", grc, wrc, tol,
                                             (nc + 2, nc + 2)),
                                  key=lambda t: t[1])
                        if at_main and n == 4095 and sweeps == 2 and not pc:
                            main_err["packed2d_down"] = err
                for sweeps in sorted({2, fused2d.max_up_sweeps(kind)}):
                    err = check_pair(
                        f"up {name} {kind} nu={sweeps} sigma={sigma}",
                        fused2d.prolong_add_smooth(u, e, b, n, nc, h,
                                                   sweeps=sweeps, **kw),
                        fused2d.prolong_add_smooth_plain(
                            u, e, b, n, nc, h, sweeps=sweeps, **kw), tol)
                    if at_main and n == 2047 and sweeps == 2:
                        main_err["fused2d_up"] = err
                    for ee in (e, se) if sweeps == 2 else (e,):
                        err = check_pair(
                            f"packed up {name} {kind} nu={sweeps} "
                            f"sigma={sigma} packed_e={ee is se}",
                            packed2d.prolong_add_smooth(
                                su, ee, sb, n, nc, h, sweeps=sweeps, **kw),
                            packed2d.prolong_add_smooth_plain(
                                su, ee, sb, n, nc, h, sweeps=sweeps, **kw),
                            tol)
                        if (at_main and n == 4095 and sweeps == 2
                                and ee is e):
                            main_err["packed2d_up"] = err
        del u, b, e, su, sb, se
    return main_err


COUNTERS = {
    "packed2d_down": ("packed2d", "down_launches"),
    "packed2d_up": ("packed2d", "up_launches"),
    "packed2d_resnorm": ("packed2d", "resnorm_launches"),
    "fused2d_down": ("fused2d", "down_launches"),
    "fused2d_up": ("fused2d", "up_launches"),
    "stencil2d_residual": ("stencil2d", "launches"),
}


def reset_counts() -> None:
    import multigridcmt_tpu_torch.kernels as kernels

    for mod, attr in COUNTERS.values():
        setattr(getattr(kernels, mod), attr, 0)


def read_counts() -> dict:
    import multigridcmt_tpu_torch.kernels as kernels

    return {name: getattr(getattr(kernels, mod), attr)
            for name, (mod, attr) in COUNTERS.items()}


def phase_main_path():
    """The slice through the public entry points. Returns the launch
    counts of the 4095^2 solve and its peak device memory."""
    import multigridcmt_tpu_torch as mt
    from multigridcmt_tpu_torch import kernels

    prob = mt.poisson2d(k=MAIN_K, dtype=torch.float32, smoother="rbgs",
                        use_kernels=True, device="cuda")
    solver = mt.MultigridSolver(prob)
    sizes = [lv.n for lv in prob.hierarchy.levels[:-1]]
    packed_levels = sum(n >= kernels.PACK_MIN_N for n in sizes)
    fused_levels = sum(kernels.KERNEL_MIN_N <= n < kernels.PACK_MIN_N
                       for n in sizes)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = solver.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    x = res.x
    maxerr = (x - prob.u_exact).abs().max().item()
    hist = res.res_history[: res.iters + 1].tolist()
    log(f"solve k={MAIN_K} float32 rbgs: iters {res.iters}, converged "
        f"{res.converged}, final rel residual {hist[-1]:.4e}, max error vs "
        f"u_exact {maxerr:.4e}, l2 error "
        f"{solver.discrete_l2_error(x).item():.4e}, wall {wall:.3f} s, "
        f"peak memory {peak / 2**20:.1f} MiB")
    log(f"  history {[f'{v:.3e}' for v in hist]}")
    log(f"  launches {launches}; {packed_levels} packed and {fused_levels} "
        "fused2d levels")
    require(x.shape == (2 ** MAIN_K + 1,) * 2 and bool(x.isfinite().all()),
            "solution has the wrong shape or non-finite values")
    require((packed_levels, fused_levels) == (1, 4),
            f"{packed_levels} packed and {fused_levels} fused2d levels, "
            "not 1 and 4")
    require(res.iters >= 2 and hist[-1] < 0.5 * hist[0],
            f"the solve did not reduce the residual: {hist}")
    # The float32 solve stalls near 1e-1 relative residual at this h (the
    # 1/h^2 cancellation); the iterate is still close to the analytic
    # solution.
    require(maxerr < 1e-2, f"max error vs u_exact {maxerr:.3e} >= 1e-2")
    want = {"packed2d_down": res.iters, "packed2d_up": res.iters,
            "packed2d_resnorm": res.iters + 1,
            "fused2d_down": fused_levels * res.iters,
            "fused2d_up": fused_levels * res.iters,
            "stencil2d_residual": 0}
    require(launches == want, f"launches {launches}, expected {want}")

    # Five V-cycles on the kernel path and on the plain path, both on the
    # card, from x = 0, through MultigridSolver.v_cycle (which packs and
    # unpacks the 4095 level at its boundary).
    for dtype, rtol in VCYCLE_RTOL.items():
        pk, pp = (mt.poisson2d(k=MAIN_K, dtype=dtype, smoother="rbgs",
                               use_kernels=use_kernels, device="cuda")
                  for use_kernels in (True, False))
        sk, sp = mt.MultigridSolver(pk), mt.MultigridSolver(pp)
        xk = torch.zeros_like(pk.b)
        xp = torch.zeros_like(pp.b)
        for _ in range(5):
            xk = sk.v_cycle(xk, pk.b)
            xp = sp.v_cycle(xp, pp.b)
        diff = (torch.linalg.vector_norm(xk - xp)
                / torch.linalg.vector_norm(xp)).item()
        errs = [(x - pk.u_exact).abs().max().item() for x in (xk, xp)]
        log(f"5 V-cycles {str(dtype).split('.')[-1]} k={MAIN_K}, kernel vs "
            f"plain: rel l2 {diff:.3e}, max abs "
            f"{(xk - xp).abs().max().item():.3e}; max error vs u_exact "
            f"{errs[0]:.3e} (kernel), {errs[1]:.3e} (plain)")
        require(diff <= rtol and max(errs) < 1e-2,
                f"{dtype} V-cycles differ: {diff:.3e} > {rtol}, or error "
                f"vs u_exact {errs} >= 1e-2")
        del pk, pp, sk, sp, xk, xp

    # float64: kernel path against plain path. k=10 (fused2d legs, the
    # stencil2d check) must agree to rtol 1e-8 in its history. At k=12 the
    # kernel path's check sums the red residual only; near the float64
    # floor (~1e-9 relative at this h) that differs from the plain path's
    # full norm by up to a few 1e-3 of the value, so the histories are held
    # to 1e-2 there and the cycle counts must agree.
    for k, hist_rtol in ((10, 1e-8), (MAIN_K, 1e-2)):
        out = {}
        for use_kernels in (True, False):
            p = mt.poisson2d(k=k, dtype=torch.float64, smoother="rbgs",
                             tol=F64_TOL, use_kernels=use_kernels,
                             device="cuda")
            reset_counts()
            out[use_kernels] = (p, mt.MultigridSolver(p).solve(),
                                read_counts())
        (pk, rk, ck), (_, rp, _) = out[True], out[False]
        hk = rk.res_history[: rk.iters + 1]
        hp = rp.res_history[: rp.iters + 1]
        err64 = (rk.x - pk.u_exact).abs().max().item()
        log(f"solve k={k} float64 rbgs: kernel iters {rk.iters} converged "
            f"{rk.converged}, plain iters {rp.iters}; final "
            f"{hk[-1].item():.3e}; max error vs u_exact {err64:.3e}; "
            f"launches {ck}")
        require(rk.converged and rp.converged and rk.iters == rp.iters,
                f"float64 k={k} solves: {rk.iters}/{rk.converged} vs "
                f"{rp.iters}/{rp.converged}")
        hdiff = ((hk - hp).abs() / hp).tolist()
        log(f"  history rel diff {[f'{v:.1e}' for v in hdiff]}")
        require(max(hdiff) <= hist_rtol, f"float64 k={k} histories differ "
                f"by {max(hdiff):.3e} > {hist_rtol}")
        require(err64 < 1e-5, f"float64 k={k} max error vs u_exact "
                f"{err64:.3e}")
        if k == 10:
            require(ck["stencil2d_residual"] == rk.iters + 1,
                    f"k=10 residual kernel launched {ck}")
        del out, pk, rk, rp
    return launches, peak


def phase_times():
    """Times on the card, float32, RB-GS, nu = 2, sigma = 0: the cycle at
    4095^2, each kernel against its plain version at its main-path shape
    (packed: 4095; fused2d and stencil2d: 2047, the largest unpacked
    level), and the packed kernels against their unpacked twins at 4095."""
    import multigridcmt_tpu_torch as mt
    from multigridcmt_tpu_torch.kernels import fused2d, packed2d, stencil2d
    from multigridcmt_tpu_torch.utils.profiling import cuda_time_ms

    times = {}
    for use_kernels in (True, False):
        prob = mt.poisson2d(k=MAIN_K, dtype=torch.float32, smoother="rbgs",
                            use_kernels=use_kernels, device="cuda")
        solver = mt.MultigridSolver(prob)
        x = torch.zeros_like(prob.b)
        times["cycle" if use_kernels else "cycle_plain"] = cuda_time_ms(
            lambda: solver.v_cycle(x, prob.b))
        del prob, solver, x
    kw = dict(kind="rbgs", omega=1.0, sweeps=2)
    unpacked = ("fused2d_down", "fused2d_up", "stencil2d_residual")
    # (n, key suffix, kernels timed): every kernel at 4095, the packed
    # level; the unpacked ones also at 2047, their main-path shape.
    for n, tag, names in ((2 ** MAIN_K - 1, "@4095", None),
                          (2 ** (MAIN_K - 1) - 1, "", unpacked)):
        nc = (n - 1) // 2
        h = 1.0 / (n + 1)
        u, b, e = leg_inputs(n, torch.float32, seed=7)
        su, sb = packed2d.pack(u), packed2d.pack(b)
        pairs = {
            "fused2d_down": (
                lambda: fused2d.smooth_residual_restrict(u, b, n, h, **kw),
                lambda: fused2d.smooth_residual_restrict_plain(u, b, n, h,
                                                               **kw)),
            "fused2d_up": (
                lambda: fused2d.prolong_add_smooth(u, e, b, n, nc, h, **kw),
                lambda: fused2d.prolong_add_smooth_plain(u, e, b, n, nc, h,
                                                         **kw)),
            "stencil2d_residual": (
                lambda: stencil2d.residual(u, b, n, h),
                lambda: stencil2d.residual_plain(u, b, n, h)),
            "stencil2d_residual+norm": (
                lambda: torch.linalg.vector_norm(
                    stencil2d.residual(u, b, n, h)),
                lambda: torch.linalg.vector_norm(
                    stencil2d.residual_plain(u, b, n, h))),
            "packed2d_down": (
                lambda: packed2d.smooth_residual_restrict(su, sb, n, h,
                                                          **kw),
                lambda: packed2d.smooth_residual_restrict_plain(
                    su, sb, n, h, **kw)),
            "packed2d_up": (
                lambda: packed2d.prolong_add_smooth(su, e, sb, n, nc, h,
                                                    **kw),
                lambda: packed2d.prolong_add_smooth_plain(
                    su, e, sb, n, nc, h, **kw)),
            "packed2d_resnorm": (
                lambda: packed2d.residual_norm_sq(su, sb, n, h,
                                                  red_only=True),
                lambda: packed2d.residual_norm_sq_plain(su, sb, n, h,
                                                        red_only=True)),
        }
        for name, (kernel, plain) in pairs.items():
            if names is not None and name not in names:
                continue
            # Plain, kernel, kernel, plain: compare within one window.
            p1 = cuda_time_ms(plain)
            k1 = cuda_time_ms(kernel)
            k2 = cuda_time_ms(kernel)
            p2 = cuda_time_ms(plain)
            times[name + tag] = min(k1, k2)
            times[name + tag + "_plain"] = min(p1, p2)
            log(f"time {name} n={n}: kernel {k1:.4f}/{k2:.4f} ms, plain "
                f"{p1:.4f}/{p2:.4f} ms")
        del pairs, u, b, e, su, sb
    log(f"packed against unpacked at 4095^2: down "
        f"{times['packed2d_down@4095']:.4f} vs "
        f"{times['fused2d_down@4095']:.4f} ms, up "
        f"{times['packed2d_up@4095']:.4f} vs {times['fused2d_up@4095']:.4f}"
        f" ms, check {times['packed2d_resnorm@4095']:.4f} vs residual+norm "
        f"{times['stencil2d_residual+norm@4095']:.4f} ms")
    log(f"time V(2,2) cycle 4095^2 float32: kernel path {times['cycle']:.3f}"
        f" ms, plain path {times['cycle_plain']:.3f} ms")
    return times


# Kernel -> (CUDA source, the TPU kernel it replaces, the key of its time).
SOURCES = {
    "packed2d_down": ("multigridcmt_tpu_torch/kernels/csrc/packed2d.cu",
                      "multigridcmt_tpu/kernels/packed2d.py:839",
                      "packed2d_down@4095"),
    "packed2d_up": ("multigridcmt_tpu_torch/kernels/csrc/packed2d.cu",
                    "multigridcmt_tpu/kernels/packed2d.py:1067",
                    "packed2d_up@4095"),
    "packed2d_resnorm": ("multigridcmt_tpu_torch/kernels/csrc/packed2d.cu",
                         "multigridcmt_tpu/kernels/packed2d.py:553",
                         "packed2d_resnorm@4095"),
    "fused2d_down": ("multigridcmt_tpu_torch/kernels/csrc/fused2d.cu",
                     "multigridcmt_tpu/kernels/fused2d.py:289",
                     "fused2d_down"),
    "fused2d_up": ("multigridcmt_tpu_torch/kernels/csrc/fused2d.cu",
                   "multigridcmt_tpu/kernels/fused2d.py:479", "fused2d_up"),
}
# Ported, but off the k=12 path (the check on an unpacked fine level).
OFF_PATH = {
    "stencil2d_residual": ("multigridcmt_tpu_torch/kernels/csrc/stencil2d.cu",
                           "multigridcmt_tpu/kernels/stencil2d.py:304",
                           "stencil2d_residual"),
}


def kernel_rows(table, launches, errs, times):
    """The JSON rows. max_abs_err is in the output's own units (the legs'
    inputs carry b ~ 1/h^2 ~ 1.7e7 and the norm is a sum of ~8e6 such
    squares); rel_err is it over max|plain| (|plain| for the norm), held
    to tol."""
    return [{"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": launches[name], "max_abs_err": errs[name][0],
             "rel_err": errs[name][1], "tol": errs[name][2],
             "ms": times[key], "plain_ms": times[key + "_plain"]}
            for name, (src, rep, key) in table.items()]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    try:
        import multigridcmt_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}",
              file=sys.stderr)
        return 1
    try:
        card = phase_setup()
        errs = phase_compare()
        launches, peak = phase_main_path()
        times = phase_times()
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        return 1
    log(f"peak device memory of the 4095^2 solve: {peak} bytes; card: {card}")
    log("off the k=12 path: " + json.dumps(
        kernel_rows(OFF_PATH, launches, errs, times)))
    print(json.dumps({"kernels": kernel_rows(SOURCES, launches, errs,
                                             times)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
