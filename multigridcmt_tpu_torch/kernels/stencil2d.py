"""2D residual kernel: r = b - (A - sigma I) u in one pass.

Replaces the TPU kernel ``multigridcmt_tpu/kernels/stencil2d.py:residual``
with ``csrc/stencil2d.cu`` (one CUDA thread per point; see the note
there on what bounds it). The solve's convergence check on an unpacked
kernel-tier fine level (255 <= n < PACK_MIN_N) runs through it once per
cycle; a color-packed fine level checks with ``packed2d.residual_norm_sq``
instead. The fused RB-GS and Jacobi sweep kernels of the same TPU module
are not ported yet (ROADMAP queue 2).

Device rule (``_wrap``): a CPU tensor takes the plain PyTorch version; a
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from ..ops import laplacian
from ._wrap import check_grid, launch_on, on_cuda

# Launches of the CUDA kernel in this process (plain-version calls do not
# count).
launches = 0


def residual_plain(u: torch.Tensor, b: torch.Tensor, n: int, h: float,
                   sigma=0.0) -> torch.Tensor:
    """Plain PyTorch version of the kernel."""
    return laplacian.residual(u, b, h, sigma=sigma)


def residual(u: torch.Tensor, b: torch.Tensor, n: int, h: float,
             sigma=0.0) -> torch.Tensor:
    """r = b - (A - sigma I) u on (n+2, n+2) padded grids; ghosts of r are
    zero."""
    global launches
    check_grid("u", u, n, u)
    check_grid("b", b, n, u)
    if not on_cuda(u):
        return residual_plain(u, b, n, h, sigma=sigma)
    r = torch.empty_like(u)
    launch_on(u, "stencil2d_residual", u.data_ptr(), b.data_ptr(),
              r.data_ptr(), n, float(h), float(sigma))
    launches += 1
    return r
