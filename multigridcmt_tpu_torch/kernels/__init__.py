"""CUDA kernel backend: ``KERNEL_BACKEND``, the counterpart of the JAX
package's ``PALLAS_BACKEND``.

Per level, as in the JAX package:
  * 2D, n >= PACK_MIN_N: the level lives in the color-packed layout
    (``packed2d``); its kernels run the down and up legs, the solve's
    convergence check (the fused residual norm) and the residual (MG-PCG's
    operator apply);
  * 2D, KERNEL_MIN_N <= n < PACK_MIN_N: the logical padded layout; the
    whole-leg kernels (``fused2d``) run the legs, and the residual of such a
    fine level (the convergence check, MG-PCG) is the ``stencil2d`` kernel;
  * 3D, n >= KERNEL3_MIN_N: the logical padded layout; the ``stencil3d``
    kernels run the sweeps and the residual, and the cycle composes the legs
    from them and the plain transfers (the fused-leg hooks decline, as in
    JAX);
  * smaller levels, and every 1D level: the plain ``ops/`` stencils.
``encode``/``decode`` pack and unpack a packed fine level at the solve's
boundary. A kernel-tier level that asks for something these kernels do not
cover raises ``NotImplementedError`` instead of running another path.
"""
from __future__ import annotations

from ..ops import laplacian, smoothers, transfer
from ..solvers.cycles import Backend
from . import fused2d, packed2d, stencil2d, stencil3d

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

SWEEPS_TODO = ("{sweeps} {kind} sweeps on a {leg} leg exceed what one fused "
               "kernel takes ({cap}); longer schedules need {todo}, not "
               "ported to CUDA yet (ROADMAP.md, queue 2)")
UNFUSED_TODO = "the unfused stencil2d sweeps and transfer2d kernels"
PACKED_TODO = "the packed2d rbgs_sweep and residual kernels"
SMOOTH_TODO = ("smoothing a kernel-tier level outside a fused leg needs the "
               "stencil2d sweep kernels, not ported to CUDA yet (ROADMAP.md, "
               "queue 2: stencil2d rbgs_sweep/jacobi_sweep)")
PACKED_OP_TODO = ("a packed level runs only the packed legs, the residual "
                  "and its norm; {op} on it needs the packed2d rbgs_sweep "
                  "kernel, not ported to CUDA yet (ROADMAP.md, queue 2: "
                  "packed2d)")


def _pack_level(n: int) -> bool:
    return n >= PACK_MIN_N


def _kernel_level(u, n: int) -> bool:
    """True if this logical-layout 2D level runs on the kernel tier."""
    return u.ndim == 2 and n >= KERNEL_MIN_N


def _kernel3_level(u, n: int) -> bool:
    """True if this 3D level (not packed: callers test that first) runs
    on the stencil3d kernels."""
    return u.ndim == 3 and n >= KERNEL3_MIN_N


def _check_leg(leg: str, kind: str, sweeps: int, cap: int, todo: str) -> None:
    if kind == "chebyshev":
        raise NotImplementedError(smoothers.CHEBYSHEV_TODO)
    if sweeps > cap:
        raise NotImplementedError(SWEEPS_TODO.format(
            sweeps=sweeps, kind=kind, leg=leg, cap=cap, todo=todo))


def _smooth(u, b, n, h, *, kind, omega, sweeps, sigma=0.0):
    # The cycle smooths a 2D kernel-tier level only inside the fused legs
    # below, which raise rather than decline; a 3D kernel-tier level here.
    if packed2d.is_packed(u):
        raise NotImplementedError(PACKED_OP_TODO.format(op="smoothing"))
    if _kernel3_level(u, n) and kind == "rbgs":
        return stencil3d.rbgs_sweep(u, b, n, h, sigma=sigma, sweeps=sweeps)
    if _kernel3_level(u, n) and kind == "jacobi":
        return stencil3d.jacobi_sweep(u, b, n, h, omega, sigma=sigma,
                                      sweeps=sweeps)
    if _kernel_level(u, n) and sweeps > 0:
        raise NotImplementedError(SMOOTH_TODO)
    return smoothers.smooth(u, b, h, kind=kind, omega=omega, sweeps=sweeps,
                            sigma=sigma)


def _residual(u, b, n, h, sigma=0.0):
    if packed2d.is_packed(u):
        return packed2d.residual(u, b, n, h, sigma=sigma)
    if _kernel3_level(u, n):
        return stencil3d.residual(u, b, n, h, sigma=sigma)
    if _kernel_level(u, n):
        return stencil2d.residual(u, b, n, h, sigma=sigma)
    return laplacian.residual(u, b, h, sigma=sigma)


def _restrict(r):
    if packed2d.is_packed(r):
        raise NotImplementedError(PACKED_OP_TODO.format(op="restriction"))
    return transfer.restrict(r)


def _prolong(e, nc):
    # A 2D fine level at or above PACK_MIN_N is packed: a logical P e
    # cannot be added to it.
    if packed2d.is_packed(e) or (e.ndim == 2 and _pack_level(2 * nc + 1)):
        raise NotImplementedError(PACKED_OP_TODO.format(op="prolongation"))
    return transfer.prolong(e)


def _encode(u):
    if u.ndim == 2 and _pack_level(u.shape[0] - 2):
        return packed2d.pack(u)
    return u


def _decode(u):
    return packed2d.unpack(u) if packed2d.is_packed(u) else u


def _smooth_residual_restrict(u, b, n, h, *, kind, omega, sweeps,
                              sigma=0.0):
    """Whole down leg on a kernel-tier level; None (compose from the plain
    ops) elsewhere."""
    if packed2d.is_packed(u):
        _check_leg("down", kind, sweeps, packed2d.max_down_sweeps(kind),
                   PACKED_TODO)
        return packed2d.smooth_residual_restrict(
            u, b, n, h, kind=kind, omega=omega, sweeps=sweeps, sigma=sigma,
            packed_coarse=_pack_level((n - 1) // 2))
    if not _kernel_level(u, n):
        return None
    _check_leg("down", kind, sweeps, fused2d.max_down_sweeps(kind),
               UNFUSED_TODO)
    return fused2d.smooth_residual_restrict(
        u, b, n, h, kind=kind, omega=omega, sweeps=sweeps, sigma=sigma)


def _prolong_add_smooth(x, e, b, n, nc, h, *, kind, omega, sweeps,
                        sigma=0.0):
    """Whole up leg on a kernel-tier level; None elsewhere."""
    if packed2d.is_packed(x):
        _check_leg("up", kind, sweeps, packed2d.max_up_sweeps(kind),
                   PACKED_TODO)
        return packed2d.prolong_add_smooth(
            x, e, b, n, nc, h, kind=kind, omega=omega, sweeps=sweeps,
            sigma=sigma)
    if not _kernel_level(x, n):
        return None
    _check_leg("up", kind, sweeps, fused2d.max_up_sweeps(kind), UNFUSED_TODO)
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
    smooth_residual_restrict=_smooth_residual_restrict,
    prolong_add_smooth=_prolong_add_smooth,
    residual_norm2=_residual_norm2,
)
