"""Smoothers: weighted Jacobi, red-black Gauss-Seidel and Chebyshev.

PyTorch port of ``multigridcmt_tpu.ops.smoothers``. Jacobi and RB-GS are
whole-grid vectorised stencil updates; RB-GS computes the update
everywhere and selects one colour by a mask. Red means (i+j) even on
padded indices (1D: i even; 3D: i+j+k even). The Chebyshev smoother
(``chebyshev_generic``) needs only residual applies and elementwise
updates, so every backend runs it from its own residual.

On a bfloat16 grid the Python scalars (omega, the diagonal, the Chebyshev
coefficients) are rounded to bfloat16 before use, as JAX's weak typing
rounds them (``bf16.weak``); float32 and float64 grids compute as before.
"""
from __future__ import annotations

import torch

from . import bf16, laplacian


def jacobi(u: torch.Tensor, b: torch.Tensor, h: float, omega: float,
           sigma=0.0) -> torch.Tensor:
    """One weighted-Jacobi sweep on a padded grid: x + omega*D^-1*(b - Ax).

    bfloat16: omega and d each rounded to bfloat16, then divided there (the
    JAX function's ``asarray(omega) / asarray(d)``); float32 and float64
    divide the Python floats."""
    d = laplacian.diag_value(u.ndim, h, sigma)
    r = laplacian.residual(u, b, h, sigma)
    return u + (bf16.weak(omega, u) / bf16.weak(d, u)) * r


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


# --- Chebyshev polynomial smoother ----------------------------------------
#
# The eigenvalues of D^-1 A for the model operators lie in (0, 2). The
# polynomial damps [CHEB_LMIN_FRAC * lmax, lmax] with lmax = 2, the
# oscillatory half of the spectrum; constants and recurrence as in the JAX
# module.

CHEB_LMAX = 2.0
CHEB_LMIN_FRAC = 0.25


def chebyshev_generic(u, b, degree: int, diag, residual_fn,
                      lmax: float = CHEB_LMAX,
                      lmin_frac: float = CHEB_LMIN_FRAC):
    """Degree-``degree`` Chebyshev smoother from operator applies only.

    ``residual_fn(u, b)`` returns ``b - A u`` in the caller's layout (the
    plain stencil, a CUDA residual kernel, the packed one); ``diag`` is the
    constant diagonal of A. The three-term recurrence, with theta =
    (lmax+lmin)/2, delta = (lmax-lmin)/2, sigma1 = theta/delta:
        d_0 = (1/theta) z_0,  d_k = rho_k rho_{k-1} d_{k-1}
              + (2 rho_k / delta) z_k,  u_{k+1} = u_k + d_k,
        z_k = D^-1 (b - A u_k),  rho_0 = 1/sigma1,
        rho_k = 1/(2 sigma1 - rho_{k-1}).
    """
    if degree <= 0:
        # A degree-0 polynomial is the identity: no smoothing.
        return u
    lmin = lmax * lmin_frac
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma1 = theta / delta
    inv_diag = 1.0 / diag
    rho = 1.0 / sigma1
    w = lambda x: bf16.weak(x, u)                             # noqa: E731
    r = residual_fn(u, b)
    d = w(inv_diag / theta) * r
    u = u + d
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        r = residual_fn(u, b)
        d = (w(rho_new * rho) * d
             + w(2.0 * rho_new / delta) * (w(inv_diag) * r))
        u = u + d
        rho = rho_new
    return u


def chebyshev(u: torch.Tensor, b: torch.Tensor, h: float, degree: int,
              sigma=0.0) -> torch.Tensor:
    """Chebyshev smoother on a padded grid (plain stencil residuals)."""
    diag = laplacian.diag_value(u.ndim, h, sigma)
    return chebyshev_generic(
        u, b, degree, diag,
        lambda uu, bb: laplacian.residual(uu, bb, h, sigma=sigma))


def smooth(u: torch.Tensor, b: torch.Tensor, h: float, *, kind: str,
           omega: float, sweeps: int, sigma=0.0) -> torch.Tensor:
    """Apply ``sweeps`` smoothing sweeps of the requested kind; for
    ``kind="chebyshev"`` one polynomial of degree ``sweeps``."""
    if kind == "chebyshev":
        return chebyshev(u, b, h, degree=sweeps, sigma=sigma)
    if kind not in ("jacobi", "rbgs"):
        raise ValueError(f"unknown smoother {kind!r}")
    for _ in range(sweeps):
        if kind == "jacobi":
            u = jacobi(u, b, h, omega, sigma=sigma)
        else:
            u = rbgs(u, b, h, sigma=sigma)
    return u
