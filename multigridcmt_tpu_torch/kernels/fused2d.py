"""Whole-leg fused kernels: one pass over the fine grid per V-cycle leg.

  down:  u  -> smooth^nu1 -> residual -> restrict -> r_c
  up:    e_c -> prolong -> correct -> smooth^nu2  -> u'

Replace the TPU kernels ``multigridcmt_tpu/kernels/fused2d.py``:
``smooth_residual_restrict`` and ``prolong_add_smooth``, with
``csrc/packed2d_legs.cuh``'s row-streaming legs on the unpacked frame,
instantiated by ``csrc/fused2d.cu`` (down), ``csrc/fused2d_up.cu`` and
``csrc/fused2d_up_f64.cu`` (up): each warp streams a strip of the logical
grid down a segment of rows in registers (see the note in ``fused2d.cu``
on what bounds them and how the frame maps the packed legs' algebra onto
the unpacked grid). ``leg_geometry`` gives their launch geometry. The
down leg's residual is taken at every interior point, as in JAX.

Each wrapper has its plain PyTorch version beside it: the composition of
the ``ops/`` functions. Device rule: a CPU tensor takes the plain version;
a CUDA tensor launches the kernel or raises.

Native bfloat16 (the TPU legs' own mode on bfloat16 grids, a bfloat16
solve's kernel-tier levels: every operation rounded to bfloat16, sigma and
the constants too): ``native_bf16.down_leg`` and ``up_leg``, one launch of
the same row stream with the native arithmetic
(``csrc/fused2d_native_bf16.cu``, ``fused2d_up_native_bf16.cu``) on this
module's geometry, counted apart.
"""
from __future__ import annotations

import torch

from ..ops import laplacian, smoothers, transfer
from . import _build, native_bf16, packed2d
from ._wrap import check_grid, launch_on, on_cuda

# Launches of each CUDA kernel in this process (plain-version calls do not
# count); the native bfloat16 legs apart.
down_launches = 0
up_launches = 0
down_bf16_launches = 0
up_bf16_launches = 0

# The least segment of the row stream on this frame (packed2d.LEG_MIN_SEG
# on the packed ones). The launch aims at packed2d.LEG_WARPS_PER_SM warps
# an SM: at 2047^2 segments of 36-40 rows; below, too few rows to fill the
# card, so the segments are as short as this. A unit streams its rows one
# after another, and at 1023^2 and below the time is the rows a unit
# streams, not the bytes: at nu = 2, as 20 calls of a CUDA graph, the legs
# at 1023^2 took 0.0319-0.0323 and 0.0259-0.0263 ms a call with segments
# of 64 rows, 0.0169-0.0171 and 0.0147 with 10; at 511^2 and 255^2
# segments of 6 rows beat 8, 10 and 16 (utils/leg_segments.py on an H100
# at 700 W; PERF.md).
MIN_SEG = 6


def max_down_sweeps(kind: str) -> int:
    """Sweeps one smooth_residual_restrict launch can fuse."""
    halo = _build.MAX_HALO
    return (halo - 2) // 2 if kind == "rbgs" else halo - 2


def max_up_sweeps(kind: str) -> int:
    """Sweeps one prolong_add_smooth launch can fuse."""
    halo = _build.MAX_HALO
    return halo // 2 if kind == "rbgs" else halo


def _frame(n: int) -> dict:
    """The unpacked frame's rows and lanes (those of the packed grid of the
    same n: lane l holds columns 2l and 2l + 1) and its least segment."""
    return dict(rows=n + 2, lanes=(n + 3) // 2, min_seg=MIN_SEG)


def leg_geometry(leg: str, n: int, kind: str, sweeps: int, *,
                 sm_count: int = 132) -> packed2d.LegGeometry:
    """The row-streaming geometry (``packed2d.leg_geometry``) of the down
    or up leg, or of the sweep stream (``stencil2d``'s sweeps), on the
    unpacked (n+2)^2 grid."""
    return packed2d.leg_geometry(leg, n, kind, sweeps, sm_count=sm_count,
                                 **_frame(n))


def _launch_geometry(leg: str, n: int, kind: str, sweeps: int,
                     t: torch.Tensor):
    """The leg's (or sweep stream's) geometry on t's card
    (packed2d._launch_geometry on this frame)."""
    return packed2d._launch_geometry(leg, n, kind, sweeps,
                                     t.device.index or 0, **_frame(n))


def _on_pair(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it where it does not start on a pair of elements: on
    an even row the kernels load a lane's two points as one access."""
    return t if t.data_ptr() % (2 * t.element_size()) == 0 else t.clone()


def _check_schedule(kind: str, sweeps: int, cap: int) -> None:
    if kind not in _build.KIND_CODES:
        raise ValueError(f"fused legs run jacobi or rbgs, not {kind!r}")
    if not 0 <= sweeps <= cap:
        raise ValueError(f"{sweeps} {kind} sweeps: one fused leg takes 0 to "
                         f"{cap}")


def smooth_residual_restrict_plain(u, b, n, h, *, kind, omega, sweeps,
                                   sigma=0.0):
    """Plain PyTorch version: (smooth^sweeps(u), restrict(b - A u'))."""
    us = smoothers.smooth(u, b, h, kind=kind, omega=omega, sweeps=sweeps,
                          sigma=sigma)
    return us, transfer.restrict(laplacian.residual(us, b, h, sigma=sigma))


def smooth_residual_restrict(u: torch.Tensor, b: torch.Tensor, n: int,
                             h: float, *, kind: str, omega: float,
                             sweeps: int, sigma=0.0):
    """(smooth^sweeps(u), restrict(b - (A - sigma I) u')) in one pass.

    u, b: (n+2, n+2) padded grids; returns u' (n+2, n+2) and the coarse
    right-hand side ((n-1)/2 + 2)^2. Requires sweeps <= max_down_sweeps.
    """
    global down_launches, down_bf16_launches
    _check_schedule(kind, sweeps, max_down_sweeps(kind))
    if n < 3 or n % 2 == 0:
        raise ValueError(f"fine n={n} must be odd and >= 3 (n = 2*nc + 1)")
    check_grid("u", u, n, u, storage=True)
    check_grid("b", b, n, u, storage=True)
    if u.dtype == torch.bfloat16:
        us, rc, launched = native_bf16.down_leg(
            u, b, n, h, kind=kind, omega=omega, sweeps=sweeps, sigma=sigma)
        down_bf16_launches += launched
        return us, rc
    if not on_cuda(u):
        return smooth_residual_restrict_plain(
            u, b, n, h, kind=kind, omega=omega, sweeps=sweeps, sigma=sigma)
    nc = (n - 1) // 2
    u, b = _on_pair(u), _on_pair(b)
    u_out = torch.empty_like(u)
    rc = torch.empty((nc + 2, nc + 2), dtype=u.dtype, device=u.device)
    launch_on(u, "fused2d_down", u.data_ptr(), b.data_ptr(),
              u_out.data_ptr(), rc.data_ptr(), n, float(h), float(sigma),
              _build.KIND_CODES[kind], float(omega), sweeps,
              _launch_geometry("down", n, kind, sweeps, u),
              writes=(u_out, rc))
    down_launches += 1
    return u_out, rc


def prolong_add_smooth_plain(x, e, b, n, nc, h, *, kind, omega, sweeps,
                             sigma=0.0):
    """Plain PyTorch version: smooth^sweeps(x + P e)."""
    return smoothers.smooth(x + transfer.prolong(e), b, h, kind=kind,
                            omega=omega, sweeps=sweeps, sigma=sigma)


def prolong_add_smooth(x: torch.Tensor, e: torch.Tensor, b: torch.Tensor,
                       n: int, nc: int, h: float, *, kind: str, omega: float,
                       sweeps: int, sigma=0.0) -> torch.Tensor:
    """smooth^sweeps(x + P e) in one pass.

    x, b: (n+2, n+2); e: (nc+2, nc+2) with n = 2*nc + 1. Requires
    sweeps <= max_up_sweeps.
    """
    global up_launches, up_bf16_launches
    _check_schedule(kind, sweeps, max_up_sweeps(kind))
    if n != 2 * nc + 1:
        raise ValueError(f"fine n={n} is not 2*nc+1 for nc={nc}")
    check_grid("x", x, n, x, storage=True)
    check_grid("e", e, nc, x, storage=True)
    check_grid("b", b, n, x, storage=True)
    if x.dtype == torch.bfloat16:
        out, launched = native_bf16.up_leg(
            x, e, b, n, nc, h, kind=kind, omega=omega, sweeps=sweeps,
            sigma=sigma)
        up_bf16_launches += launched
        return out
    if not on_cuda(x):
        return prolong_add_smooth_plain(x, e, b, n, nc, h, kind=kind,
                                        omega=omega, sweeps=sweeps,
                                        sigma=sigma)
    x, b = _on_pair(x), _on_pair(b)
    out = torch.empty_like(x)
    launch_on(x, "fused2d_up", x.data_ptr(), e.data_ptr(), b.data_ptr(),
              out.data_ptr(), n, float(h), float(sigma),
              _build.KIND_CODES[kind], float(omega), sweeps,
              _launch_geometry("up", n, kind, sweeps, x), writes=(out,))
    up_launches += 1
    return out
