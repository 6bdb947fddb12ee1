"""bfloat16 arithmetic as the JAX package computes it.

A bfloat16 PyTorch tensor times a Python float computes with the scalar
unrounded (in float32); JAX's weak typing first rounds the scalar to
bfloat16. ``weak`` gives a Python scalar that meets a bfloat16 tensor the
JAX rounding; every other operand passes through unchanged, so float32 and
float64 code keeps its operations and its bits.

The aligned-layout stencils (``residual``, ``jacobi``, ``rbgs``,
``smooth``) are the counterparts of ``multigridcmt_tpu.ops.
stencils_aligned``, which JAX's kernel backend runs on the 2D levels below
its kernel threshold. Their arithmetic is not the plain ops': the
neighbours are summed first, ((up + down) + left) + right; the residual
adds sigma u even at sigma = 0 (so a zero keeps the sign JAX gives it);
Jacobi scales by omega / (4/h^2 - sigma); RB-GS divides by 4 - sigma h^2.
In bfloat16, where every operation rounds, that order sets the result, so
the kernel backend (``kernels/__init__.py``) runs them on its bfloat16
levels below ``KERNEL_MIN_N``; float32 and float64 levels keep the plain
ops. They work on the logical padded grid (the JAX helpers on its TPU-
aligned embedding, whose extra zeros no interior point reads). JAX's
``restrict_aligned`` sums as ``transfer.restrict`` does and its
``prolong_aligned`` is ``prolong``, so the transfers need no counterpart.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

BF = torch.bfloat16


def scalar(x, device=None) -> torch.Tensor:
    """A Python number (or a tensor) as a 0-d bfloat16 tensor: a number is
    rounded through float32, as JAX converts a weakly typed scalar."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=BF)
    return torch.tensor(float(x), dtype=torch.float32,
                        device=device).to(BF)


def weak(x, like: torch.Tensor):
    """``x`` as it meets ``like`` in JAX: a Python number rounded to
    bfloat16 where ``like`` is bfloat16; anything else unchanged."""
    if like.dtype == BF and isinstance(x, (int, float)):
        return scalar(x, like.device)
    return x


def _interior(u: torch.Tensor, n: int) -> torch.Tensor:
    mask = torch.zeros(u.shape, dtype=torch.bool, device=u.device)
    mask[1:n + 1, 1:n + 1] = True
    return mask


def _neighbour_sum(u: torch.Tensor) -> torch.Tensor:
    """((up + down) + left) + right at the interior points."""
    return ((u[:-2, 1:-1] + u[2:, 1:-1]) + u[1:-1, :-2]) + u[1:-1, 2:]


def residual(u, b, n: int, h: float, sigma=0.0) -> torch.Tensor:
    """``stencils_aligned.residual``: ((b - (4u - sum) / h^2) + sigma u) at
    the interior points, 0 elsewhere."""
    d = u.device
    au = (scalar(4.0, d) * u[1:-1, 1:-1] - _neighbour_sum(u)) \
        * scalar(1.0 / (h * h), d)
    r = (b[1:-1, 1:-1] - au) + scalar(sigma, d) * u[1:-1, 1:-1]
    return F.pad(r, (1, 1, 1, 1))


def jacobi(u, b, n: int, h: float, omega: float, sigma=0.0) -> torch.Tensor:
    """``stencils_aligned.jacobi``: u + (omega / (4/h^2 - sigma)) r."""
    d = u.device
    coef = scalar(omega, d) / (scalar(4.0 / (h * h), d) - scalar(sigma, d))
    return u + coef * residual(u, b, n, h, sigma)


def rbgs(u, b, n: int, h: float, sigma=0.0) -> torch.Tensor:
    """``stencils_aligned.rbgs``: red, then black points take (h^2 b + sum)
    / (4 - sigma h^2)."""
    d = u.device
    h2 = scalar(h * h, d)
    den = scalar(4.0, d) - scalar(sigma, d) * h2
    rows = torch.arange(u.shape[0], device=d)[:, None]
    cols = torch.arange(u.shape[1], device=d)[None, :]
    interior = _interior(u, n)
    for parity in (0, 1):
        vals = F.pad((h2 * b[1:-1, 1:-1] + _neighbour_sum(u)) / den,
                     (1, 1, 1, 1))
        u = torch.where(interior & ((rows + cols) % 2 == parity), vals, u)
    return u


def smooth(u, b, n: int, h: float, *, kind: str, omega: float, sweeps: int,
           sigma=0.0) -> torch.Tensor:
    """``stencils_aligned.smooth``: ``sweeps`` Jacobi or RB-GS sweeps."""
    for _ in range(sweeps):
        if kind == "jacobi":
            u = jacobi(u, b, n, h, omega, sigma)
        elif kind == "rbgs":
            u = rbgs(u, b, n, h, sigma)
        else:
            raise ValueError(f"unknown smoother {kind!r}")
    return u
