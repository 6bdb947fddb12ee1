"""3D 7-point kernels: the residual, weighted-Jacobi and RB-GS sweeps.

Replaces the three modes of the TPU kernel in
``multigridcmt_tpu/kernels/stencil3d.py`` (one ``pallas_call``) with
``csrc/stencil3d.cu`` (a z-march over (x, y) tiles; see the note there on
what bounds it):
  * ``residual``: r = b - (A - sigma I) u, one launch;
  * ``jacobi_sweep``: weighted Jacobi, one launch a sweep;
  * ``rbgs_sweep``: one full red-then-black Gauss-Seidel sweep a call of
    the kernel, as two launches (a red pass into a scratch grid, then the
    black pass); ``rbgs_launches`` counts one a sweep.

Grids: a stack of p planes of r x c points with c = n + 2 and p, r >= 3:
the logical padded (n+2)^3 grid of a level, or a slab or pencil stack
whose plane 0 is global plane ``goff`` and row 0 global row ``roff``, as
in the TPU kernel. Edge rule, all modes: an output plane is zero unless
it is neither the stack's first nor last and g + goff lies in [1, n]; in
such a plane a point is updated if its global row and column lie in
[1, n] and its row is not the stack's first or last. Elsewhere the
residual is zero and the sweeps keep u. (At a stack's edge rows the TPU
kernel rolls around to the other edge; the port leaves them alone, so a
chained sweep invalidates the edge rows' halo as it does the planes'.)
Red means (g + goff) + (y + roff) + x even.

The TPU module's aligned3 layout and its VMEM budgets (``fits_vmem``,
``_pick_pb``) are Mosaic artefacts with no counterpart on Hopper: every 3D
level at or above ``KERNEL3_MIN_N`` runs these kernels, whatever its size.
bfloat16 storage and ``out_dtype`` belong to mixed precision and raise.

Each wrapper has its plain PyTorch version beside it, in the TPU kernel's
arithmetic order. Device rule (``_wrap``): a CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ._wrap import check_storage, check_tensor, launch_on, on_cuda

# Launches of each CUDA kernel in this process (plain-version calls do not
# count; an RB-GS sweep counts once for its two passes).
residual_launches = 0
jacobi_launches = 0
rbgs_launches = 0


def _check(u: torch.Tensor, b: torch.Tensor, n: int, what: str,
           out_dtype=None) -> None:
    check_storage(what, u, out_dtype)
    check_storage(what, b)
    if u.ndim != 3 or min(u.shape[:2]) < 3 or u.shape[2] != n + 2:
        raise ValueError(f"{what}: u has shape {tuple(u.shape)}; expected a "
                         f"(p, r, {n + 2}) plane stack with p, r >= 3")
    check_tensor("u", u, tuple(u.shape), u)
    check_tensor("b", b, tuple(u.shape), u)


# ----------------------------------------------------------------------------
# Plain versions
# ----------------------------------------------------------------------------

def _masks(u: torch.Tensor, n: int, goff: int, roff: int):
    """(valid planes (p, 1, 1), updatable points, red points) as bool
    tensors broadcastable to u's shape."""
    p, r, c = u.shape
    dev = u.device
    g = torch.arange(p, device=dev) + goff
    y = torch.arange(r, device=dev) + roff
    x = torch.arange(c, device=dev)
    zlocal = torch.arange(p, device=dev)
    ylocal = torch.arange(r, device=dev)
    zvalid = ((zlocal >= 1) & (zlocal <= p - 2) & (g >= 1)
              & (g <= n)).view(p, 1, 1)
    yok = ((ylocal >= 1) & (ylocal <= r - 2) & (y >= 1)
           & (y <= n)).view(1, r, 1)
    xok = ((x >= 1) & (x <= n)).view(1, 1, c)
    update = zvalid & yok & xok
    red = ((g % 2).view(p, 1, 1) ^ (y % 2).view(1, r, 1)
           ^ (x % 2).view(1, 1, c)) == 0
    return zvalid, update, red


def _nsum(u: torch.Tensor) -> torch.Tensor:
    """Sum of the six face neighbours at every point of u's core, in the
    TPU kernel's order."""
    return (((((u[:-2, 1:-1, 1:-1] + u[2:, 1:-1, 1:-1])
               + u[1:-1, :-2, 1:-1]) + u[1:-1, 2:, 1:-1])
             + u[1:-1, 1:-1, :-2]) + u[1:-1, 1:-1, 2:])


def _pad(core: torch.Tensor) -> torch.Tensor:
    return F.pad(core, (1, 1, 1, 1, 1, 1))


def _residual_core(u, b, h, sigma):
    inv_h2 = 1.0 / (h * h)
    zm = u[1:-1, 1:-1, 1:-1]
    au = (6.0 * zm - _nsum(u)) * inv_h2
    return b[1:-1, 1:-1, 1:-1] - au + sigma * zm


def _gs(u, b, h, sigma):
    """The Gauss-Seidel value at every point from u (padded, core only)."""
    h2 = h * h
    inv_den = 1.0 / (6.0 - sigma * h2)
    return _pad((h2 * b[1:-1, 1:-1, 1:-1] + _nsum(u)) * inv_den)


def residual_plain(u, b, n, h, sigma=0.0, goff=0, roff=0):
    """Plain PyTorch version of ``residual``."""
    _, update, _ = _masks(u, n, goff, roff)
    r = _pad(_residual_core(u, b, h, sigma))
    return torch.where(update, r, torch.zeros_like(r))


def jacobi_sweep_plain(u, b, n, h, omega, sigma=0.0, sweeps=1, goff=0,
                       roff=0):
    """Plain PyTorch version of ``jacobi_sweep``."""
    zvalid, update, _ = _masks(u, n, goff, roff)
    scale = omega / (6.0 * (1.0 / (h * h)) - sigma)
    for _ in range(sweeps):
        upd = u + scale * _pad(_residual_core(u, b, h, sigma))
        u = torch.where(update, upd, u)
        u = torch.where(zvalid, u, torch.zeros_like(u))
    return u


def rbgs_sweep_plain(u, b, n, h, sigma=0.0, sweeps=1, goff=0, roff=0):
    """Plain PyTorch version of ``rbgs_sweep``."""
    zvalid, update, red = _masks(u, n, goff, roff)
    for _ in range(sweeps):
        u = torch.where(update & red, _gs(u, b, h, sigma), u)
        u = torch.where(update & ~red, _gs(u, b, h, sigma), u)
        u = torch.where(zvalid, u, torch.zeros_like(u))
    return u


# ----------------------------------------------------------------------------
# Kernel wrappers
# ----------------------------------------------------------------------------

def residual(u: torch.Tensor, b: torch.Tensor, n: int, h: float, sigma=0.0,
             goff: int = 0, roff: int = 0) -> torch.Tensor:
    """r = b - (A - sigma I) u on a plane stack (see the module's edge
    rule); one pass."""
    global residual_launches
    _check(u, b, n, "stencil3d.residual")
    if not on_cuda(u):
        return residual_plain(u, b, n, h, sigma=sigma, goff=goff, roff=roff)
    out = torch.empty_like(u)
    launch_on(u, "stencil3d_residual", u.data_ptr(), b.data_ptr(),
              out.data_ptr(), *u.shape, n, float(h), float(sigma), int(goff),
              int(roff))
    residual_launches += 1
    return out


def jacobi_sweep(u: torch.Tensor, b: torch.Tensor, n: int, h: float,
                 omega: float, sigma=0.0, sweeps: int = 1, goff: int = 0,
                 roff: int = 0, out_dtype=None) -> torch.Tensor:
    """``sweeps`` weighted-Jacobi sweeps, u + omega/(6/h^2 - sigma) r, one
    pass (launch) each."""
    global jacobi_launches
    _check(u, b, n, "stencil3d.jacobi_sweep", out_dtype)
    if not on_cuda(u):
        return jacobi_sweep_plain(u, b, n, h, omega, sigma=sigma,
                                  sweeps=sweeps, goff=goff, roff=roff)
    for _ in range(sweeps):
        out = torch.empty_like(u)
        launch_on(u, "stencil3d_jacobi", u.data_ptr(), b.data_ptr(),
                  out.data_ptr(), *u.shape, n, float(h), float(sigma),
                  float(omega), int(goff), int(roff))
        jacobi_launches += 1
        u = out
    return u


def rbgs_sweep(u: torch.Tensor, b: torch.Tensor, n: int, h: float,
               sigma=0.0, sweeps: int = 1, goff: int = 0, roff: int = 0,
               out_dtype=None) -> torch.Tensor:
    """``sweeps`` full red-then-black Gauss-Seidel sweeps; each is two
    passes (red into a scratch grid, then black) and counts one launch."""
    global rbgs_launches
    _check(u, b, n, "stencil3d.rbgs_sweep", out_dtype)
    if not on_cuda(u):
        return rbgs_sweep_plain(u, b, n, h, sigma=sigma, sweeps=sweeps,
                                goff=goff, roff=roff)
    tmp = torch.empty_like(u) if sweeps > 0 else None
    for _ in range(sweeps):
        out = torch.empty_like(u)
        launch_on(u, "stencil3d_rbgs", u.data_ptr(), b.data_ptr(),
                  tmp.data_ptr(), out.data_ptr(), *u.shape, n, float(h),
                  float(sigma), int(goff), int(roff))
        rbgs_launches += 1
        u = out
    return u
