"""The native bfloat16 modes of the 2D stencil kernels, the fused legs and
the transfers: the residual and the RB-GS and Jacobi sweeps of
``stencil2d`` (whole grids) and ``local2d`` (a shard's extended tile), the
legs of ``fused2d`` and the residual restriction and prolongation-add of
``transfer2d``, on bfloat16 grids, computed in bfloat16 itself, as the JAX
package computes them.

Replace the bfloat16 modes of the TPU kernels
``multigridcmt_tpu/kernels/stencil2d.py`` (``residual`` :304,
``rbgs_sweep`` :284, ``jacobi_sweep`` :295),
``multigridcmt_tpu/kernels/local2d.py`` (``rbgs_sweep`` :263,
``jacobi_sweep`` :278, ``residual`` :289) and
``multigridcmt_tpu/kernels/transfer2d.py`` (``prolong_add`` :204,
``residual_restrict`` :371): the residual and a shard's tile's sweeps
with ``csrc/native_bf16.cu`` (a thread a point), the prolongation-add
with ``csrc/transfer2d_prolong_native_bf16.cu`` (a thread a word of
two fine rows); those of
``multigridcmt_tpu/kernels/fused2d.py`` (``smooth_residual_restrict``
:289, ``prolong_add_smooth`` :479) with the row stream's native mode
(``csrc/fused2d_native_bf16.cu``, ``fused2d_up_native_bf16.cu``); a whole
grid's RB-GS and Jacobi sweeps and the residual restriction run the row
stream too (``csrc/stencil2d_sweep_native_bf16.cu``,
``stencil2d_jacobi_native_bf16.cu``, ``transfer2d_native_bf16.cu``); the
notes there say how each is built and what bounds it. The stencil2d and
local2d wrappers call ``residual`` and ``sweep`` below for a bfloat16
grid, transfer2d's ``residual_restrict`` and ``prolong_add``, fused2d's
``down_leg`` and ``up_leg``; a whole (n+2)^2 grid is the tile at global
(0, 0), whose ring is the grid's ghosts.

The rule (JAX's weak typing, ``stencil2d.py:81-90``, ``:214-254``): sigma
arrives as a bfloat16 array; a Python float (h^2, 1/h^2, 4, omega, 4/h^2
computed in double) is rounded to bfloat16 where it meets one; every + - x
/ then rounds to bfloat16, in the source's order:
  residual   au = ((((4 u - up) - down) - left) - right) * inv_h2,
             r = (b - au) + sig u (sig u even at sigma = 0), 0 off the
             points the kernel sets;
  RB-GS      inv_den = 1 / (4 - sig h2), once; red, then black points take
             ((((h2 b + up) + down) + left) + right) * inv_den;
  Jacobi     coef = omega / (4/h^2 - sig), once; every point takes
             u + coef * r(u), r as above;
  restrict   (``transfer2d.py:218-350``, ``fused2d.py:110-286``) r as
             above, without sig u in transfer2d's (``transfer2d.py:265``),
             with it in the fused down leg's; rows first, then columns,
             t = (0.25 r[i-1] + 0.5 r[i]) + 0.25 r[i+1] (the 0/1 selection
             dots that follow are exact); the coarse ring 0;
  prolong    (``transfer2d.py:56-200``, ``fused2d.py:313-476``) fine 2I
             takes coarse I, an odd point 0.5 a + 0.5 b rounded once (the
             interpolation dots' two terms); transfer2d interpolates
             columns first, then rows, the fused up leg rows first, then
             columns; then x + P e on the interior, x elsewhere.
The fused legs compose these: the down leg's sweeps, then the restriction
with sig u (``down_leg``); the up leg's prolongation-add (rows first), then
its sweeps (``up_leg``); on the card each is one launch of the row stream,
and so are a whole grid's sweeps and transfer2d's restriction.
The JAX kernels hold on finite inputs; a NaN or Inf inside their selection
dots spreads over a row or block (0 * Inf), which these modes do not copy:
their plain versions define the port's semantics there.
``constants`` computes h2, inv_h2, sig, inv_den and coef on the host in
that order; the kernel and the plain versions use the same values. A
Python scalar is rounded through float32, as JAX's conversion of a weakly
typed scalar is.

The plain versions run each operation as a bfloat16 PyTorch op, in the
same order, with the constants as bfloat16 tensors (a bfloat16 tensor times
a Python float would compute with the scalar unrounded). On the card the
kernel equals them bit for bit (chip_smoke.py, phase 2).

Device rule (``_wrap``): a CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..ops.bf16 import scalar
from . import _build
from ._wrap import launch_on, on_cuda

BF = torch.bfloat16


class Constants(NamedTuple):
    """The scalars of a level, each a bfloat16 value held as a float."""

    h2: float        # h^2
    inv_h2: float    # 1/h^2
    sig: float       # sigma
    inv_den: float   # 1 / (4 - sig h2)
    coef: float      # omega / (4/h^2 - sig)


@functools.lru_cache(maxsize=None)
def constants(h: float, sigma: float = 0.0, omega: float = 1.0) -> Constants:
    """The level's scalars in JAX's order, each operation rounded to
    bfloat16 (the Python products h*h, 1/(h*h) and 4/(h*h) in double);
    cached, as a level's scalars repeat from call to call."""
    h2, inv_h2, sig = (scalar(v) for v in (h * h, 1.0 / (h * h), sigma))
    inv_den = scalar(1.0) / (scalar(4.0) - sig * h2)
    coef = scalar(omega) / (scalar(4.0 * (1.0 / (h * h))) - sig)
    return Constants(*(float(v) for v in (h2, inv_h2, sig, inv_den, coef)))


def _residual_vals(u, b, c: dict, shift: bool = True) -> torch.Tensor:
    """JAX's ``_residual_vals`` off the ring, each op in bfloat16; without
    ``shift`` (transfer2d's residual) b - au."""
    ctr = u[1:-1, 1:-1]
    t = c["four"] * ctr
    t = t - u[:-2, 1:-1]
    t = t - u[2:, 1:-1]
    t = t - u[1:-1, :-2]
    t = t - u[1:-1, 2:]
    r = b[1:-1, 1:-1] - t * c["inv_h2"]
    return F.pad(r + c["sig"] * ctr if shift else r, (1, 1, 1, 1))


def _gs_vals(u, b, c: dict) -> torch.Tensor:
    """JAX's ``_gs_vals`` off the ring, each op in bfloat16."""
    t = c["h2"] * b[1:-1, 1:-1]
    t = t + u[:-2, 1:-1]
    t = t + u[2:, 1:-1]
    t = t + u[1:-1, :-2]
    t = t + u[1:-1, 2:]
    return F.pad(t * c["inv_den"], (1, 1, 1, 1))


def _tensors(c: Constants, device) -> dict:
    out = {k: torch.tensor(v, dtype=BF, device=device)
           for k, v in c._asdict().items()}
    for k, v in (("four", 4.0), ("quarter", 0.25), ("half", 0.5)):
        out[k] = torch.tensor(v, dtype=BF, device=device)
    return out


def residual_plain(u, b, n: int, c: Constants, row_off: int = 0,
                   col_off: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the native residual."""
    from .local2d import _masks

    _, update, _ = _masks(u.shape, n, row_off, col_off, u.device)
    vals = _residual_vals(u, b, _tensors(c, u.device))
    return torch.where(update, vals, torch.zeros_like(vals))


def sweep_plain(kind: str, u, b, n: int, c: Constants, sweeps: int,
                row_off: int = 0, col_off: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the native sweeps; the points the kernel
    does not set keep u's values."""
    from .local2d import _masks

    _, update, red = _masks(u.shape, n, row_off, col_off, u.device)
    ct = _tensors(c, u.device)
    for _ in range(sweeps):
        if kind == "rbgs":
            u = torch.where(update & red, _gs_vals(u, b, ct), u)
            u = torch.where(update & ~red, _gs_vals(u, b, ct), u)
        else:
            u = torch.where(update,
                            u + ct["coef"] * _residual_vals(u, b, ct), u)
    return u


def residual(u, b, n: int, h: float, row_off: int = 0, col_off: int = 0,
             sigma=0.0) -> tuple:
    """The native residual of bfloat16 u and b (checked by the caller) on
    the R x C tile at global (row_off, col_off); returns (r, launched)."""
    c = constants(float(h), float(sigma))
    if not on_cuda(u):
        return residual_plain(u, b, n, c, row_off, col_off), False
    r = torch.empty_like(u)
    launch_on(u, "native2d_residual", u.data_ptr(), b.data_ptr(),
              r.data_ptr(), u.shape[0], u.shape[1], n, int(row_off),
              int(col_off), c.inv_h2, c.sig, writes=(r,))
    return r, True


def sweep(kind: str, u, b, n: int, h: float, omega: float, sweeps: int,
          row_off: int = 0, col_off: int = 0, sigma=0.0) -> tuple:
    """``sweeps`` native RB-GS or Jacobi sweeps of bfloat16 u and b
    (checked by the caller) on the tile at global (row_off, col_off);
    returns (u', launched). On a whole (n+2)^2 grid either kind is one
    launch of the row stream (``csrc/stencil2d_sweep_native_bf16.cu``,
    ``csrc/stencil2d_jacobi_native_bf16.cu``, on ``fused2d``'s sweep
    geometry); on a shard's tile at an offset ``csrc/native_bf16.cu`` runs
    one launch a colour a sweep (RB-GS, the first one reading u, the rest in
    place on u') or one a sweep (Jacobi, alternating u' and a scratch grid
    so that the last lands in u')."""
    c = constants(float(h), float(sigma), float(omega))
    if not on_cuda(u):
        return sweep_plain(kind, u, b, n, c, sweeps, row_off, col_off), False
    if (row_off, col_off) == (0, 0) and tuple(u.shape) == (n + 2, n + 2):
        return _sweep_stream(kind, u, b, n, c, sweeps), True
    out = torch.empty_like(u)
    tmp = (torch.empty_like(u) if kind == "jacobi" and sweeps > 1
           else out)
    launch_on(u, "native2d_sweep", u.data_ptr(), b.data_ptr(),
              out.data_ptr(), tmp.data_ptr(), u.shape[0], u.shape[1], n,
              int(row_off), int(col_off), *c, _build.KIND_CODES[kind],
              sweeps, writes=(out,))
    return out, True


# The row stream's entry point of each kind on a whole grid.
_SWEEP_STREAMS = {"rbgs": "stencil2d_sweep_native",
                  "jacobi": "stencil2d_jacobi_native"}


def _sweep_stream(kind: str, u, b, n: int, c: Constants,
                  sweeps: int) -> torch.Tensor:
    """The native sweeps of a whole grid on the card: one launch of the row
    stream, no scratch grid."""
    from . import fused2d

    u, b = fused2d._on_pair(u), fused2d._on_pair(b)
    out = torch.empty_like(u)
    launch_on(u, _SWEEP_STREAMS[kind], u.data_ptr(), b.data_ptr(),
              out.data_ptr(), n, *c, sweeps,
              fused2d._launch_geometry("sweep", n, kind, sweeps, u),
              writes=(out,))
    return out


def _full_weight(r, axis: int, c: dict) -> torch.Tensor:
    """(0.25 r[2I-1] + 0.5 r[2I]) + 0.25 r[2I+1] along ``axis`` at the
    coarse points I = 1 .. nc, each op in bfloat16."""
    m = r.shape[axis] - 2
    lo, mid, hi = (r.narrow(axis, s, m - 1)[
        (slice(None),) * axis + (slice(None, None, 2),)] for s in (1, 2, 3))
    return (c["quarter"] * lo + c["half"] * mid) + c["quarter"] * hi


def residual_restrict_plain(u, b, n: int, c: Constants,
                            shift: bool) -> torch.Tensor:
    """Plain PyTorch version of the native residual restriction: the
    residual (``_residual_vals``, ``shift`` as there) at the interior
    points, full weighting over rows, then over columns; the coarse ring
    0."""
    ct = _tensors(c, u.device)
    r = _residual_vals(u, b, ct, shift)
    return F.pad(_full_weight(_full_weight(r, 0, ct), 1, ct), (1, 1, 1, 1))


def _interpolate(e, axis: int) -> torch.Tensor:
    """Linear interpolation along ``axis``, nc + 2 -> 2 nc + 3 points: the
    even points copy e, an odd one is 0.5 a + 0.5 b in float32 rounded to
    bfloat16 once (as JAX's interpolation products sum)."""
    m = e.shape[axis] - 1
    odd = (e.narrow(axis, 0, m).float() * 0.5
           + e.narrow(axis, 1, m).float() * 0.5).to(BF)
    shape = list(e.shape)
    shape[axis] = 2 * m + 1
    out = torch.empty(shape, dtype=BF, device=e.device)
    at = (slice(None),) * axis
    out[at + (slice(0, None, 2),)] = e
    out[at + (slice(1, None, 2),)] = odd
    return out


def prolong_add_plain(x, e, n: int, nc: int,
                      rows_first: bool) -> torch.Tensor:
    """Plain PyTorch version of the native prolongation-add: P e, rows then
    columns (``rows_first``, fused2d's up leg) or columns then rows
    (transfer2d.prolong_add), then x + P e on the interior, x elsewhere."""
    axes = (0, 1) if rows_first else (1, 0)
    pe = _interpolate(_interpolate(e, axes[0]), axes[1])
    out = x.clone()
    out[1:-1, 1:-1] = x[1:-1, 1:-1] + pe[1:-1, 1:-1]
    return out


def residual_restrict(u, b, n: int, h: float) -> tuple:
    """transfer2d's native residual restriction (no sig u term) of
    bfloat16 u and b (checked by the caller) into the ((n-1)/2 + 2)^2
    coarse grid, on the card in one launch of the row stream
    (``csrc/transfer2d_native_bf16.cu``, on the zero-sweep fused2d down
    leg's geometry); returns (rc, launched)."""
    from . import fused2d

    c = constants(float(h))
    nc = (n - 1) // 2
    if not on_cuda(u):
        return residual_restrict_plain(u, b, n, c, False), False
    u, b = fused2d._on_pair(u), fused2d._on_pair(b)
    rc = torch.empty((nc + 2, nc + 2), dtype=BF, device=u.device)
    launch_on(u, "native2d_residual_restrict", u.data_ptr(), b.data_ptr(),
              rc.data_ptr(), n, c.inv_h2,
              fused2d._launch_geometry("down", n, "rbgs", 0, u),
              writes=(rc,))
    return rc, True


def prolong_add(x, e, n: int, nc: int) -> tuple:
    """transfer2d's native x + P e (columns first) of bfloat16 x and e
    (checked by the caller), on the card in one launch of
    ``csrc/transfer2d_prolong_native_bf16.cu`` (a thread a word of two
    fine rows, on arrays that start on a 4-byte word); returns (out,
    launched)."""
    from . import fused2d

    if not on_cuda(x):
        return prolong_add_plain(x, e, n, nc, False), False
    x, e = fused2d._on_pair(x), fused2d._on_pair(e)
    out = torch.empty_like(x)
    launch_on(x, "transfer2d_prolong_add_native", x.data_ptr(),
              e.data_ptr(), out.data_ptr(), n, writes=(out,))
    return out, True


def down_leg_plain(u, b, n: int, c: Constants, kind: str, sweeps: int):
    """Plain PyTorch version of the native down leg: (u', rc)."""
    u = sweep_plain(kind, u, b, n, c, sweeps)
    return u, residual_restrict_plain(u, b, n, c, True)


def down_leg(u, b, n: int, h: float, *, kind: str, omega: float,
             sweeps: int, sigma=0.0) -> tuple:
    """fused2d's down leg on bfloat16 grids (checked by the caller):
    ``sweeps`` native sweeps, then the residual (with sig u) restricted, on
    the card in one launch of the row stream. Returns (u', rc,
    launched)."""
    from . import fused2d

    c = constants(float(h), float(sigma), float(omega))
    if not on_cuda(u):
        return (*down_leg_plain(u, b, n, c, kind, sweeps), False)
    nc = (n - 1) // 2
    u, b = fused2d._on_pair(u), fused2d._on_pair(b)
    u_out = torch.empty_like(u)
    rc = torch.empty((nc + 2, nc + 2), dtype=BF, device=u.device)
    launch_on(u, "fused2d_down_native", u.data_ptr(), b.data_ptr(),
              u_out.data_ptr(), rc.data_ptr(), n, *c,
              _build.KIND_CODES[kind], sweeps,
              fused2d._launch_geometry("down", n, kind, sweeps, u),
              writes=(u_out, rc))
    return u_out, rc, True


def up_leg_plain(x, e, b, n: int, nc: int, c: Constants, kind: str,
                 sweeps: int) -> torch.Tensor:
    """Plain PyTorch version of the native up leg."""
    return sweep_plain(kind, prolong_add_plain(x, e, n, nc, True), b, n, c,
                       sweeps)


def up_leg(x, e, b, n: int, nc: int, h: float, *, kind: str, omega: float,
           sweeps: int, sigma=0.0) -> tuple:
    """fused2d's up leg on bfloat16 grids (checked by the caller): x + P e
    (rows first), then ``sweeps`` native sweeps, on the card in one launch
    of the row stream. Returns (x', launched)."""
    from . import fused2d

    c = constants(float(h), float(sigma), float(omega))
    if not on_cuda(x):
        return up_leg_plain(x, e, b, n, nc, c, kind, sweeps), False
    x, b = fused2d._on_pair(x), fused2d._on_pair(b)
    out = torch.empty_like(x)
    launch_on(x, "fused2d_up_native", x.data_ptr(), e.data_ptr(),
              b.data_ptr(), out.data_ptr(), n, *c, _build.KIND_CODES[kind],
              sweeps, fused2d._launch_geometry("up", n, kind, sweeps, x),
              writes=(out,))
    return out, True
