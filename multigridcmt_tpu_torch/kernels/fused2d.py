"""Whole-leg fused kernels: one pass over the fine grid per V-cycle leg.

  down:  u  -> smooth^nu1 -> residual -> restrict -> r_c
  up:    e_c -> prolong -> correct -> smooth^nu2  -> u'

Replace the TPU kernels ``multigridcmt_tpu/kernels/fused2d.py``:
``smooth_residual_restrict`` and ``prolong_add_smooth``, with
``csrc/fused2d.cu`` (2D thread-block tiles in shared memory with a halo
that covers the sweeps' staleness; see the note there on what bounds them
and how the tiles are laid out).

Each wrapper has its plain PyTorch version beside it: the composition of
the ``ops/`` functions. Device rule: a CPU tensor takes the plain version;
a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from ..ops import laplacian, smoothers, transfer
from . import _build
from ._wrap import check_grid, launch_on, on_cuda

# Launches of each CUDA kernel in this process (plain-version calls do not
# count).
down_launches = 0
up_launches = 0


def max_down_sweeps(kind: str) -> int:
    """Sweeps one smooth_residual_restrict launch can fuse."""
    halo = _build.MAX_HALO
    return (halo - 2) // 2 if kind == "rbgs" else halo - 2


def max_up_sweeps(kind: str) -> int:
    """Sweeps one prolong_add_smooth launch can fuse."""
    halo = _build.MAX_HALO
    return halo // 2 if kind == "rbgs" else halo


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
    global down_launches
    _check_schedule(kind, sweeps, max_down_sweeps(kind))
    if n < 3 or n % 2 == 0:
        raise ValueError(f"fine n={n} must be odd and >= 3 (n = 2*nc + 1)")
    check_grid("u", u, n, u)
    check_grid("b", b, n, u)
    if not on_cuda(u):
        return smooth_residual_restrict_plain(
            u, b, n, h, kind=kind, omega=omega, sweeps=sweeps, sigma=sigma)
    nc = (n - 1) // 2
    u_out = torch.empty_like(u)
    rc = torch.empty((nc + 2, nc + 2), dtype=u.dtype, device=u.device)
    launch_on(u, "fused2d_down", u.data_ptr(), b.data_ptr(),
              u_out.data_ptr(), rc.data_ptr(), n, float(h), float(sigma),
              _build.KIND_CODES[kind], float(omega), sweeps)
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
    global up_launches
    _check_schedule(kind, sweeps, max_up_sweeps(kind))
    if n != 2 * nc + 1:
        raise ValueError(f"fine n={n} is not 2*nc+1 for nc={nc}")
    check_grid("x", x, n, x)
    check_grid("e", e, nc, x)
    check_grid("b", b, n, x)
    if not on_cuda(x):
        return prolong_add_smooth_plain(x, e, b, n, nc, h, kind=kind,
                                        omega=omega, sweeps=sweeps,
                                        sigma=sigma)
    out = torch.empty_like(x)
    launch_on(x, "fused2d_up", x.data_ptr(), e.data_ptr(), b.data_ptr(),
              out.data_ptr(), n, float(h), float(sigma),
              _build.KIND_CODES[kind], float(omega), sweeps)
    up_launches += 1
    return out
