"""The native bfloat16 modes of the 2D stencil kernels: the residual and the
RB-GS and Jacobi sweeps of ``stencil2d`` (whole grids) and ``local2d``
(a shard's extended tile) on bfloat16 grids, computed in bfloat16 itself,
as the JAX package computes them.

Replace the bfloat16 modes of the TPU kernels
``multigridcmt_tpu/kernels/stencil2d.py`` (``residual`` :304,
``rbgs_sweep`` :284, ``jacobi_sweep`` :295) and
``multigridcmt_tpu/kernels/local2d.py`` (``rbgs_sweep`` :263,
``jacobi_sweep`` :278, ``residual`` :289) with ``csrc/native_bf16.cu``
(see the note there on its design and what bounds it). The stencil2d and
local2d wrappers call ``residual`` and ``sweep`` below for a bfloat16 grid;
a whole (n+2)^2 grid is the tile at global (0, 0), whose ring is the
grid's ghosts.

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
             u + coef * r(u), r as above.
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


def _scalar(x: float) -> torch.Tensor:
    """A Python float as a 0-d bfloat16 tensor, rounded through float32."""
    return torch.tensor(float(x), dtype=torch.float32).to(BF)


@functools.lru_cache(maxsize=None)
def constants(h: float, sigma: float = 0.0, omega: float = 1.0) -> Constants:
    """The level's scalars in JAX's order, each operation rounded to
    bfloat16 (the Python products h*h, 1/(h*h) and 4/(h*h) in double);
    cached, as a level's scalars repeat from call to call."""
    h2, inv_h2, sig = _scalar(h * h), _scalar(1.0 / (h * h)), _scalar(sigma)
    inv_den = _scalar(1.0) / (_scalar(4.0) - sig * h2)
    coef = _scalar(omega) / (_scalar(4.0 * (1.0 / (h * h))) - sig)
    return Constants(*(float(v) for v in (h2, inv_h2, sig, inv_den, coef)))


def _residual_vals(u, b, c: dict) -> torch.Tensor:
    """JAX's ``_residual_vals`` off the ring, each op in bfloat16."""
    ctr = u[1:-1, 1:-1]
    t = c["four"] * ctr
    t = t - u[:-2, 1:-1]
    t = t - u[2:, 1:-1]
    t = t - u[1:-1, :-2]
    t = t - u[1:-1, 2:]
    au = t * c["inv_h2"]
    return F.pad((b[1:-1, 1:-1] - au) + c["sig"] * ctr, (1, 1, 1, 1))


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
    out["four"] = torch.tensor(4.0, dtype=BF, device=device)
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
    returns (u', launched). The kernel runs one launch a colour a sweep
    (RB-GS, the first one reading u, the rest in place on u') or one a sweep
    (Jacobi, alternating u' and a scratch grid so that the last lands in
    u')."""
    c = constants(float(h), float(sigma), float(omega))
    if not on_cuda(u):
        return sweep_plain(kind, u, b, n, c, sweeps, row_off, col_off), False
    out = torch.empty_like(u)
    tmp = (torch.empty_like(u) if kind == "jacobi" and sweeps > 1
           else out)
    launch_on(u, "native2d_sweep", u.data_ptr(), b.data_ptr(),
              out.data_ptr(), tmp.data_ptr(), u.shape[0], u.shape[1], n,
              int(row_off), int(col_off), *c, _build.KIND_CODES[kind],
              sweeps, writes=(out,))
    return out, True
