"""CUDA kernel backend: ``KERNEL_BACKEND``, the counterpart of the JAX
package's ``PALLAS_BACKEND``, routed level by level as it is.

Per level:
  * 2D, n >= PACK_MIN_N: the level lives in the color-packed layout
    (``packed2d``); its kernels run the down and up legs, the solve's
    convergence check (the fused residual norm), the residual (MG-PCG's
    operator apply, the Chebyshev and Jacobi smoothing's residual applies)
    and longer RB-GS schedules (``rbgs_sweep``);
  * 2D, KERNEL_MIN_N <= n < PACK_MIN_N: the logical padded layout; the
    whole-leg kernels (``fused2d``) run the legs; where a leg does not fuse
    (the Chebyshev smoother, more sweeps than a fused leg takes) the cycle
    composes it from the ``stencil2d`` sweeps or residual and the
    ``transfer2d`` kernels; the residual of such a fine level (the
    convergence check, MG-PCG) is the ``stencil2d`` kernel;
  * 3D, n >= KERNEL3_MIN_N: the logical padded layout; the ``stencil3d``
    kernels run the sweeps and the residual, and the cycle composes the legs
    from them and the plain transfers (the fused-leg hooks decline, as in
    JAX);
  * smaller levels, and every 1D level: the plain ``ops/`` stencils; a
    smaller bfloat16 2D level runs the counterparts of JAX's aligned-
    layout stencils (``ops/bf16.py``), whose order of operations sets
    bfloat16 results (float32 and float64 levels keep the plain ops).
The sparse path's kernels (``spmv``: the banded DIA SpMV; ``bell``: the
blocked-ELL SpMM) are called directly, not through the backend.

Mixed precision (``solvers.krylov.mixed_cycle_dtype``): a cycle cast to
bfloat16 has its fine level in bfloat16, packed 2D or 3D; the kernels
compute in float32 and emit the coarse right-hand side in float32 (the
packed down leg's, the stencil3d residual's), so every coarser level runs
as in a float32 cycle. The top level's correction add promotes to float32
(``out_dtype``, passed by ``cycles.v_cycle``): the fused packed up leg
stores x' in float32; on a composed packed route the zero-sweep up leg
does; in 3D ``x + P e`` promotes by itself (the stencil3d level has no
prolong-add kernel, as in JAX, so ``out_dtype`` has nothing to widen
there). The post-smoothing then runs the float32 kernels. The smoothing
before it (RB-GS sweeps, the Chebyshev and Jacobi residual applies and
their elementwise updates) runs on bfloat16 grids, as in JAX.
``encode``/``decode`` pack and unpack a packed fine level at the solve's
boundary.
"""
from __future__ import annotations

import torch

from ..ops import bf16, laplacian, smoothers, transfer
from ..solvers.cycles import Backend
from . import fused2d, packed2d, stencil2d, stencil3d, transfer2d

# Below this interior size a 2D level runs the plain PyTorch stencils.
# The value is the JAX package's PALLAS_MIN_N, carried over as it is; no
# threshold sweep has been measured on the H100 yet (ROADMAP.md, PERF.md).
KERNEL_MIN_N = 200

# At or above this interior size a 2D level is color-packed. The value is
# the JAX package's PACK_MIN_N (only the 4095 level at k=12), carried over
# as it is; the H100 comparison of the packed and unpacked legs is in
# PERF.md.
PACK_MIN_N = 3000

# At or above this interior size a 3D level runs the stencil3d kernels (at
# k=9: 511, 255 and 127). The value is the JAX package's PALLAS3_MIN_N,
# carried over as it is; no threshold has been measured on the H100.
KERNEL3_MIN_N = 100


def _pack_level(n: int) -> bool:
    return n >= PACK_MIN_N


def _kernel_level(u, n: int) -> bool:
    """True if this logical-layout 2D level runs on the kernel tier."""
    return u.ndim == 2 and n >= KERNEL_MIN_N


def _kernel3_level(u, n: int) -> bool:
    """True if this 3D level (not packed: callers test that first) runs
    on the stencil3d kernels."""
    return u.ndim == 3 and n >= KERNEL3_MIN_N


def _fuses(kind: str, sweeps: int, cap: int) -> bool:
    """True if a fused leg runs this schedule (JAX's rule: Jacobi or RB-GS
    within the leg's cap); else the hook declines and the cycle composes
    the leg."""
    return kind in ("jacobi", "rbgs") and sweeps <= cap


def _smooth(u, b, n, h, *, kind, omega, sweeps, sigma=0.0):
    if packed2d.is_packed(u):
        if kind == "rbgs":
            while sweeps > 0:
                s = min(sweeps, packed2d.max_fused_sweeps())
                u = packed2d.rbgs_sweep(u, b, n, h, sweeps=s, sigma=sigma)
                sweeps -= s
            return u
        if kind == "chebyshev":
            return smoothers.chebyshev_generic(
                u, b, sweeps, laplacian.diag_value(2, h, sigma),
                lambda uu, bb: packed2d.residual(uu, bb, n, h, sigma=sigma))
        if kind != "jacobi":
            raise ValueError(f"unknown smoother {kind!r}")
        # Jacobi: the residual kernel and an elementwise update a sweep.
        scale = omega / laplacian.diag_value(2, h, sigma)
        for _ in range(sweeps):
            u = u + scale * packed2d.residual(u, b, n, h, sigma=sigma)
        return u
    if _kernel3_level(u, n):
        if kind == "rbgs":
            return stencil3d.rbgs_sweep(u, b, n, h, sigma=sigma,
                                        sweeps=sweeps)
        if kind == "jacobi":
            return stencil3d.jacobi_sweep(u, b, n, h, omega, sigma=sigma,
                                          sweeps=sweeps)
        if kind == "chebyshev":
            # Unreached through cycles.get_backend (a 3D Chebyshev cycle
            # takes the plain backend, JAX's rule); kept as JAX has it.
            return smoothers.chebyshev_generic(
                u, b, sweeps, laplacian.diag_value(3, h, sigma),
                lambda uu, bb: stencil3d.residual(uu, bb, n, h, sigma=sigma))
        raise ValueError(f"unknown smoother {kind!r}")
    if u.ndim != 2:
        return smoothers.smooth(u, b, h, kind=kind, omega=omega,
                                sweeps=sweeps, sigma=sigma)
    if kind == "chebyshev":
        # Residual applies (this backend's residual: the stencil2d kernel
        # on the kernel tier) and elementwise updates.
        return smoothers.chebyshev_generic(
            u, b, sweeps, laplacian.diag_value(2, h, sigma),
            lambda uu, bb: _residual(uu, bb, n, h, sigma=sigma))
    if not _kernel_level(u, n):
        if u.dtype == torch.bfloat16:
            return bf16.smooth(u, b, n, h, kind=kind, omega=omega,
                               sweeps=sweeps, sigma=sigma)
        return smoothers.smooth(u, b, h, kind=kind, omega=omega,
                                sweeps=sweeps, sigma=sigma)
    if kind not in ("jacobi", "rbgs"):
        raise ValueError(f"unknown smoother {kind!r}")
    # As many sweeps a launch as the kernel's halo takes.
    while sweeps > 0:
        s = min(sweeps, stencil2d.max_fused_sweeps(kind))
        if kind == "jacobi":
            u = stencil2d.jacobi_sweep(u, b, n, h, omega, sigma=sigma,
                                       sweeps=s)
        else:
            u = stencil2d.rbgs_sweep(u, b, n, h, sigma=sigma, sweeps=s)
        sweeps -= s
    return u


def _residual(u, b, n, h, sigma=0.0):
    if packed2d.is_packed(u):
        return packed2d.residual(u, b, n, h, sigma=sigma)
    if _kernel3_level(u, n):
        return stencil3d.residual(u, b, n, h, sigma=sigma)
    if _kernel_level(u, n):
        return stencil2d.residual(u, b, n, h, sigma=sigma)
    if u.ndim == 2 and u.dtype == torch.bfloat16:
        return bf16.residual(u, b, n, h, sigma=sigma)
    return laplacian.residual(u, b, h, sigma=sigma)


def _restrict(r):
    if packed2d.is_packed(r):
        # restrict(r) is the coarse output of the down leg with no sweeps
        # on (u = 0, b = r): residual(0, r) = r.
        n = r.shape[1] - 2
        _, rc = packed2d.smooth_residual_restrict(
            torch.zeros_like(r), r, n, 1.0, kind="rbgs", omega=1.0,
            sweeps=0, packed_coarse=_pack_level((n - 1) // 2))
        return rc
    return transfer.restrict(r)


def _prolong(e, nc):
    n = 2 * nc + 1
    if (e.ndim == 2 or packed2d.is_packed(e)) and _pack_level(n):
        # P e on a packed fine level: the up leg with no sweeps on x = 0.
        zero = torch.zeros(packed2d.packed_shape(n), dtype=e.dtype,
                           device=e.device)
        return packed2d.prolong_add_smooth(zero, e, zero, n, nc, 1.0,
                                           kind="rbgs", omega=1.0, sweeps=0)
    return transfer.prolong(e)


def _encode(u):
    if u.ndim == 2 and _pack_level(u.shape[0] - 2):
        return packed2d.pack(u)
    return u


def _decode(u):
    return packed2d.unpack(u) if packed2d.is_packed(u) else u


def _residual_restrict(u, b, n, h):
    """R (b - A u) with sigma = 0 (the cycle's only call)."""
    if packed2d.is_packed(u):
        _, rc = packed2d.smooth_residual_restrict(
            u, b, n, h, kind="rbgs", omega=1.0, sweeps=0,
            packed_coarse=_pack_level((n - 1) // 2))
        return rc
    if _kernel3_level(u, n):
        return transfer.restrict(stencil3d.residual(u, b, n, h))
    if _kernel_level(u, n):
        return transfer2d.residual_restrict(u, b, n, h)
    return transfer.restrict(_residual(u, b, n, h))


def _prolong_add(x, e, n, nc, out_dtype=None):
    """x + P e (stored in ``out_dtype`` on a packed level: float32 for a
    bfloat16 x at the top of a mixed cycle; a 3D level's bfloat16 x plus
    the float32 correction is float32 by promotion)."""
    if packed2d.is_packed(x):
        return packed2d.prolong_add_smooth(
            x, e, torch.zeros_like(x), n, nc, 1.0, kind="rbgs", omega=1.0,
            sweeps=0, out_dtype=out_dtype)
    if _kernel_level(x, n):
        return transfer2d.prolong_add(x, e, n, nc)
    return x + transfer.prolong(e)


def _smooth_residual_restrict(u, b, n, h, *, kind, omega, sweeps,
                              sigma=0.0):
    """Whole down leg on a 2D kernel-tier level; None (the cycle composes
    the leg) elsewhere and for a schedule no fused leg runs."""
    if packed2d.is_packed(u):
        if not _fuses(kind, sweeps, packed2d.max_down_sweeps(kind)):
            return None
        return packed2d.smooth_residual_restrict(
            u, b, n, h, kind=kind, omega=omega, sweeps=sweeps, sigma=sigma,
            packed_coarse=_pack_level((n - 1) // 2))
    if (not _kernel_level(u, n)
            or not _fuses(kind, sweeps, fused2d.max_down_sweeps(kind))):
        return None
    return fused2d.smooth_residual_restrict(
        u, b, n, h, kind=kind, omega=omega, sweeps=sweeps, sigma=sigma)


def _prolong_add_smooth(x, e, b, n, nc, h, *, kind, omega, sweeps,
                        sigma=0.0, out_dtype=None):
    """Whole up leg on a 2D kernel-tier level (x' stored in ``out_dtype``
    on a packed level); None elsewhere and for a schedule no fused leg
    runs."""
    if packed2d.is_packed(x):
        if not _fuses(kind, sweeps, packed2d.max_up_sweeps(kind)):
            return None
        return packed2d.prolong_add_smooth(
            x, e, b, n, nc, h, kind=kind, omega=omega, sweeps=sweeps,
            sigma=sigma, out_dtype=out_dtype)
    if (not _kernel_level(x, n)
            or not _fuses(kind, sweeps, fused2d.max_up_sweeps(kind))):
        return None
    return fused2d.prolong_add_smooth(
        x, e, b, n, nc, h, kind=kind, omega=omega, sweeps=sweeps,
        sigma=sigma)


def _residual_norm2(x, b, n, h, red_only=False):
    """Fused convergence check on a packed level; None elsewhere."""
    if not packed2d.is_packed(x):
        return None
    return packed2d.residual_norm_sq(x, b, n, h, red_only=red_only)


KERNEL_BACKEND = Backend(
    smooth=_smooth,
    residual=_residual,
    restrict=_restrict,
    prolong=_prolong,
    encode=_encode,
    decode=_decode,
    residual_restrict=_residual_restrict,
    prolong_add=_prolong_add,
    smooth_residual_restrict=_smooth_residual_restrict,
    prolong_add_smooth=_prolong_add_smooth,
    residual_norm2=_residual_norm2,
)
