"""Multigrid-preconditioned conjugate gradients (MG-PCG).

PyTorch port of ``multigridcmt_tpu.solvers.krylov``. One cycle from a zero
guess is the preconditioner z = M^-1 r; the flexible (Polak-Ribiere) beta
z'(r_new - r_old) / z'r keeps CG convergent for the slightly nonsymmetric
RB-GS cycle. Arrays stay in the backend's layout throughout (a packed fine
level stays packed), so the operator apply and the residual run the same
kernels as the stationary solve: ``packed2d.residual`` on a packed level,
``stencil2d.residual`` or ``stencil3d.residual`` on a kernel-tier level.
The JAX package runs the loop on the device in a ``while_loop``; here it
runs on the host with one device-to-host copy an iteration.

Mixed precision (``config.precond_dtype``, ``mixed_cycle_dtype``): the
preconditioning cycle runs in that dtype on the packed 2D tier and on the
3D stencil3d tier (RB-GS), cast at the preconditioner boundary only; CG's
recurrence and dots stay in ``config.dtype``. A bfloat16 cycle keeps
bfloat16 on its fine level's storage only, and returns float32
(``cycles.v_cycle``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..config import SolverConfig
from ..grids import Hierarchy, interior, pad_interior
from . import cycles

# The dtypes a preconditioning cycle on the kernel tier runs in: the
# kernels' bfloat16 storage and their compute dtypes.
_CYCLE_DTYPES = (torch.bfloat16, torch.float32, torch.float64)

# The JAX package casts a 3D cycle only while its TPU kernel's plane ring
# fits VMEM (its stencil3d.fits_vmem: 17 aligned planes of (round8(n+2),
# round128(n+2)) points within 80 MiB). Kept only so that the port casts
# exactly where JAX casts (up to k=10 in bfloat16); it says nothing about
# the H100.
_JAX_PLANE_BUDGET_BYTES = 80 * 1024 * 1024


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # Whole-array dots are interior dots: ghosts and packed pad lanes are
    # zero by invariant.
    return torch.sum(a * b)


def _jax_fits_vmem(rows: int, cols: int, dtype: torch.dtype) -> bool:
    """JAX's fits_vmem for a plane of rows x cols points in its TPU
    layout (rows to a multiple of 8, columns to one of 128)."""
    r = -(-rows // 8) * 8
    c = -(-cols // 128) * 128
    return 17 * r * c * dtype.itemsize <= _JAX_PLANE_BUDGET_BYTES


def _jax_casts_3d(n: int, dtype: torch.dtype) -> bool:
    return _jax_fits_vmem(n + 2, n + 2, dtype)


def mixed_cycle_dtype(config: SolverConfig, route: str = "MG-PCG"):
    """The dtype the preconditioning cycle is cast to, or None (it runs in
    ``config.dtype``), where the JAX package's ``mixed_cycle_dtype`` says
    so: ``precond_dtype`` with ``use_kernels`` on the packed 2D tier (the
    fine level packs) and for a 3D RB-GS cycle on the stencil3d tier while
    JAX's plane ring would fit its VMEM budget (``_jax_casts_3d``: up to
    k=10 in bfloat16); None elsewhere. A dtype the kernels do not store
    (not bfloat16, float32 or float64) raises ``NotImplementedError``
    naming ``route``, the solver that asked: the port never runs another
    precision silently."""
    pd = config.precond_dtype if config.precond_dtype is not None \
        else config.dtype
    if pd == config.dtype:
        return None
    from .. import kernels     # deferred: kernels imports solvers.cycles

    packed2d = config.ndim == 2 and config.n >= kernels.PACK_MIN_N
    tier3d = (config.ndim == 3 and config.smoother == "rbgs"
              and config.n >= kernels.KERNEL3_MIN_N
              and _jax_casts_3d(config.n, pd))
    if not (config.use_kernels and (packed2d or tier3d)):
        return None
    if pd not in _CYCLE_DTYPES:
        raise NotImplementedError(
            f"{route} with precond_dtype={pd}: the kernels store bfloat16, "
            "float32 or float64 only")
    return pd


def cg_loop(x, b, *, dot, apply_a, precond, residual, tol, max_iters):
    """Flexible (Polak-Ribiere) preconditioned-CG iteration loop.

      dot(a, b)      inner product, a 0-d tensor
      apply_a(p)     operator apply in the caller's layout
      precond(r)     one cycle from a zero guess
      residual(x, b) r = b - A x

    The stall and divergence guards of ``cycles.solve``
    (``cycles.step_guards``) end the loop. Returns ``(x, iters, hist,
    rel)``: ``hist`` has length ``max_iters + 1``, entries past ``iters``
    repeat the final relative residual ``rel`` (a float).
    """
    b_norm = torch.sqrt(dot(b, b))
    b_norm = torch.where(b_norm == 0, torch.ones_like(b_norm), b_norm)

    r = residual(x, b)
    hist = [torch.sqrt(dot(r, r)) / b_norm]
    z = precond(r)
    p = z
    rz = dot(r, z)
    rel = hist[0].item()                      # host sync
    stall = div = 0
    k = 0
    while rel >= tol and k < max_iters and cycles.guards_ok(stall, div):
        ap = apply_a(p)
        pap = dot(p, ap)
        alpha = rz / torch.where(pap == 0, torch.ones_like(pap), pap)
        x = x + alpha * p
        r_new = r - alpha * ap
        hist.append(torch.sqrt(dot(r_new, r_new)) / b_norm)
        z_new = precond(r_new)
        rz_new = dot(r_new, z_new)
        beta = (rz_new - dot(z_new, r)) / torch.where(
            rz == 0, torch.ones_like(rz), rz)
        p = z_new + beta * p
        r, z, rz = r_new, z_new, rz_new
        new_rel = hist[-1].item()             # host sync, once an iteration
        stall, div = cycles.step_guards(new_rel, rel, stall, div)
        rel = new_rel
        k += 1
    hist += [hist[-1]] * (max_iters - k)
    return x, k, torch.stack(hist), rel


def solve_pcg(hier: Hierarchy, b: torch.Tensor, config: SolverConfig,
              x0: Optional[torch.Tensor] = None) -> cycles.SolveResult:
    """Solve A x = b by CG preconditioned with one cycle an iteration.

    Same contract as ``cycles.solve``: iterate until ||r|| / ||b|| <
    ``config.tol``, ``config.max_iters`` or a guard, returning a
    ``SolveResult`` whose history holds the relative residual after each
    CG iteration.
    """
    pd = mixed_cycle_dtype(config)
    bk = cycles.get_backend(config)
    n, h = hier.fine.n, hier.fine.h
    b = bk.encode(pad_interior(interior(b)))
    x = (torch.zeros_like(b) if x0 is None
         else bk.encode(pad_interior(interior(x0))))
    zeros = torch.zeros_like(b)

    def apply_a(p):
        # A p = -(0 - A p): the backend's residual kernel with b = 0.
        return -bk.residual(p, zeros, n, h)

    def precond(r):
        # Mixed precision: the cycle runs in pd, cast at the preconditioner
        # boundary only (flexible CG tolerates the inexact M^-1).
        rp = r if pd is None else r.to(pd)
        return cycles.cycle(hier, torch.zeros_like(rp), rp,
                            config).to(r.dtype)

    x, iters, hist, rel = cg_loop(
        x, b, dot=_dot, apply_a=apply_a, precond=precond,
        residual=lambda xx, bb: bk.residual(xx, bb, n, h),
        tol=config.tol, max_iters=config.max_iters)
    return cycles.SolveResult(x=bk.decode(x), iters=iters, res_history=hist,
                              converged=rel < config.tol)
