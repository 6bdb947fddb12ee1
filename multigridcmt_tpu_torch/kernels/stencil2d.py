"""2D stencil kernels on the logical padded layout: the residual and the
fused RB-GS and Jacobi sweeps.

Replace the TPU kernels of ``multigridcmt_tpu/kernels/stencil2d.py`` with
``csrc/stencil2d.cu`` and ``csrc/stencil2d_sweep*.cu`` (see the notes there
on what bounds them):
  * ``residual``: r = b - (A - sigma I) u in one pass, one CUDA thread a
    point. The solve's convergence check on an unpacked kernel-tier fine
    level (255 <= n < PACK_MIN_N) and MG-PCG's operator apply there run
    through it, and so do the Chebyshev smoother's residual applies on the
    kernel-tier levels; a color-packed level uses ``packed2d`` instead;
  * ``rbgs_sweep`` and ``jacobi_sweep``: up to ``max_fused_sweeps(kind)``
    sweeps in one pass: ``csrc/packed2d_legs.cuh``'s row-streaming sweep
    kernel (the up leg's stream without its coarse operand) on the
    unpacked frame of the ``fused2d`` legs, each stencil summed in the
    plain versions' order, on ``fused2d``'s rows, lanes and least segment
    (``fused2d.leg_geometry("sweep", ...)``). The kernel backend smooths a
    kernel-tier level with them where a leg has more sweeps than a fused
    leg takes, in chunks of that many.

Native bfloat16 (the TPU kernels' own mode on bfloat16 grids: every
operation rounded to bfloat16, sigma and the constants too): the three
take bfloat16 u and b and run ``native_bf16``'s plain versions or its
kernels, counted apart: the RB-GS and the Jacobi sweeps one launch of the
row stream with the native arithmetic
(``csrc/stencil2d_sweep_native_bf16.cu``,
``csrc/stencil2d_jacobi_native_bf16.cu``, on the float sweeps' geometry),
the residual ``csrc/native_bf16.cu``. A bfloat16 solve runs the residual
and the sweeps on its kernel-tier levels (the convergence check, the
sweeps of a leg that does not fuse: RB-GS V(4,5)'s both legs, Jacobi
V(8,8)'s down leg).

Device rule (``_wrap``): a CPU tensor takes the plain PyTorch version; a
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from ..ops import laplacian, smoothers
from . import _build, fused2d, native_bf16
from ._wrap import check_grid, launch_on, on_cuda

# Launches of each CUDA kernel in this process (plain-version calls do not
# count): the residual, and the sweep kernel in each mode (one a launch,
# whatever its sweep count); the native bfloat16 modes apart (one a call,
# whatever its launches).
launches = 0
rbgs_launches = 0
jacobi_launches = 0
residual_bf16_launches = 0
rbgs_bf16_launches = 0
jacobi_bf16_launches = 0


def max_fused_sweeps(kind: str) -> int:
    """Most smoothing sweeps one sweep launch fuses."""
    return _build.MAX_HALO // 2 if kind == "rbgs" else _build.MAX_HALO


def residual_plain(u: torch.Tensor, b: torch.Tensor, n: int, h: float,
                   sigma=0.0) -> torch.Tensor:
    """Plain PyTorch version of the kernel."""
    return laplacian.residual(u, b, h, sigma=sigma)


def residual(u: torch.Tensor, b: torch.Tensor, n: int, h: float,
             sigma=0.0) -> torch.Tensor:
    """r = b - (A - sigma I) u on (n+2, n+2) padded grids; ghosts of r are
    zero. bfloat16 grids: the native mode."""
    global launches, residual_bf16_launches
    check_grid("u", u, n, u, storage=True)
    check_grid("b", b, n, u, storage=True)
    if u.dtype == torch.bfloat16:
        r, launched = native_bf16.residual(u, b, n, h, sigma=sigma)
        residual_bf16_launches += launched
        return r
    if not on_cuda(u):
        return residual_plain(u, b, n, h, sigma=sigma)
    r = torch.empty_like(u)
    launch_on(u, "stencil2d_residual", u.data_ptr(), b.data_ptr(),
              r.data_ptr(), n, float(h), float(sigma), writes=(r,))
    launches += 1
    return r


def _sweep(kind: str, u, b, n, h, omega, sigma, sweeps) -> torch.Tensor:
    global rbgs_launches, jacobi_launches
    global rbgs_bf16_launches, jacobi_bf16_launches
    cap = max_fused_sweeps(kind)
    if not 1 <= sweeps <= cap:
        raise ValueError(f"{sweeps} {kind} sweeps: one launch takes 1 to "
                         f"{cap}")
    check_grid("u", u, n, u, storage=True)
    check_grid("b", b, n, u, storage=True)
    if u.dtype == torch.bfloat16:
        out, launched = native_bf16.sweep(kind, u, b, n, h, omega, sweeps,
                                          sigma=sigma)
        if kind == "rbgs":
            rbgs_bf16_launches += launched
        else:
            jacobi_bf16_launches += launched
        return out
    if not on_cuda(u):
        if kind == "rbgs":
            return rbgs_sweep_plain(u, b, n, h, sigma=sigma, sweeps=sweeps)
        return jacobi_sweep_plain(u, b, n, h, omega, sigma=sigma,
                                  sweeps=sweeps)
    u, b = fused2d._on_pair(u), fused2d._on_pair(b)
    out = torch.empty_like(u)
    launch_on(u, "stencil2d_sweep", u.data_ptr(), b.data_ptr(),
              out.data_ptr(), n, float(h), float(sigma),
              _build.KIND_CODES[kind], float(omega), sweeps,
              fused2d._launch_geometry("sweep", n, kind, sweeps, u),
              writes=(out,))
    if kind == "rbgs":
        rbgs_launches += 1
    else:
        jacobi_launches += 1
    return out


def rbgs_sweep_plain(u, b, n, h, sigma=0.0, sweeps=1):
    """Plain PyTorch version: ``sweeps`` RB-GS sweeps of ``ops/``."""
    return smoothers.smooth(u, b, h, kind="rbgs", omega=1.0, sweeps=sweeps,
                            sigma=sigma)


def rbgs_sweep(u: torch.Tensor, b: torch.Tensor, n: int, h: float,
               sigma=0.0, sweeps: int = 1) -> torch.Tensor:
    """``sweeps`` (1 to 4) red+black Gauss-Seidel sweeps in one pass on
    (n+2, n+2) padded grids; ghosts keep u's values."""
    return _sweep("rbgs", u, b, n, h, 1.0, sigma, sweeps)


def jacobi_sweep_plain(u, b, n, h, omega, sigma=0.0, sweeps=1):
    """Plain PyTorch version: ``sweeps`` weighted-Jacobi sweeps of
    ``ops/``."""
    return smoothers.smooth(u, b, h, kind="jacobi", omega=omega,
                            sweeps=sweeps, sigma=sigma)


def jacobi_sweep(u: torch.Tensor, b: torch.Tensor, n: int, h: float,
                 omega: float, sigma=0.0, sweeps: int = 1) -> torch.Tensor:
    """``sweeps`` (1 to 8) weighted-Jacobi sweeps in one pass on (n+2,
    n+2) padded grids; ghosts keep u's values."""
    return _sweep("jacobi", u, b, n, h, omega, sigma, sweeps)
