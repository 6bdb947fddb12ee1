"""Smoothers: weighted Jacobi and red-black Gauss-Seidel.

PyTorch port of ``multigridcmt_tpu.ops.smoothers``. Both are whole-grid
vectorised stencil updates; RB-GS computes the update everywhere and
selects one colour by a mask. Red means (i+j) even on padded indices
(1D: i even; 3D: i+j+k even). The Chebyshev smoother is not ported yet
(ROADMAP queue 1, unported modules: Chebyshev).
"""
from __future__ import annotations

import torch

from . import laplacian

CHEBYSHEV_TODO = ("the Chebyshev smoother is not ported to PyTorch yet "
                  "(ROADMAP.md, queue 1: Chebyshev)")


def jacobi(u: torch.Tensor, b: torch.Tensor, h: float, omega: float,
           sigma=0.0) -> torch.Tensor:
    """One weighted-Jacobi sweep on a padded grid: x + omega*D^-1*(b - Ax)."""
    d = laplacian.diag_value(u.ndim, h, sigma)
    r = laplacian.residual(u, b, h, sigma)
    return u + (omega / d) * r


def _color_mask(shape, parity: int, row_offset: int = 0,
                device="cpu") -> torch.Tensor:
    """Points whose padded coordinate sum (plus ``row_offset``) has
    ``parity``."""
    s = torch.zeros((), dtype=torch.int64, device=device) + row_offset
    for dim, size in enumerate(shape):
        view = [1] * len(shape)
        view[dim] = size
        s = s + torch.arange(size, device=device).view(view)
    return s % 2 == parity


def _gs_update(u: torch.Tensor, b: torch.Tensor, h: float,
               sigma=0.0) -> torch.Tensor:
    """Gauss-Seidel update value at every interior point, from the current
    u everywhere: (h^2 b + sum of neighbours) / (2d - sigma h^2)."""
    h2 = h * h
    if u.ndim == 1:
        core = (h2 * b[1:-1] + u[:-2] + u[2:]) / (2.0 - sigma * h2)
    elif u.ndim == 3:
        core = (h2 * b[1:-1, 1:-1, 1:-1]
                + u[:-2, 1:-1, 1:-1] + u[2:, 1:-1, 1:-1]
                + u[1:-1, :-2, 1:-1] + u[1:-1, 2:, 1:-1]
                + u[1:-1, 1:-1, :-2] + u[1:-1, 1:-1, 2:]) / (6.0 - sigma * h2)
    else:
        core = (h2 * b[1:-1, 1:-1] + u[:-2, 1:-1] + u[2:, 1:-1]
                + u[1:-1, :-2] + u[1:-1, 2:]) / (4.0 - sigma * h2)
    return laplacian._pad(core)


def rbgs_half_sweep(u: torch.Tensor, b: torch.Tensor, h: float, parity: int,
                    row_offset: int = 0, sigma=0.0) -> torch.Tensor:
    """Update only the points of one colour; ghosts keep u's values."""
    upd = _gs_update(u, b, h, sigma)
    mask = _color_mask(u.shape, parity, row_offset, device=u.device)
    imask = torch.zeros_like(mask)
    imask[(slice(1, -1),) * u.ndim] = True
    return torch.where(mask & imask, upd, u)


def rbgs(u: torch.Tensor, b: torch.Tensor, h: float, row_offset: int = 0,
         sigma=0.0) -> torch.Tensor:
    """One full red-black Gauss-Seidel sweep: red (parity 0) then black."""
    u = rbgs_half_sweep(u, b, h, parity=0, row_offset=row_offset, sigma=sigma)
    return rbgs_half_sweep(u, b, h, parity=1, row_offset=row_offset,
                           sigma=sigma)


def smooth(u: torch.Tensor, b: torch.Tensor, h: float, *, kind: str,
           omega: float, sweeps: int, sigma=0.0) -> torch.Tensor:
    """Apply ``sweeps`` smoothing sweeps of the requested kind."""
    if kind == "chebyshev":
        raise NotImplementedError(CHEBYSHEV_TODO)
    if kind not in ("jacobi", "rbgs"):
        raise ValueError(f"unknown smoother {kind!r}")
    for _ in range(sweeps):
        if kind == "jacobi":
            u = jacobi(u, b, h, omega, sigma=sigma)
        else:
            u = rbgs(u, b, h, sigma=sigma)
    return u
