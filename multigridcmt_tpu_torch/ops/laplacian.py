"""Matrix-free Poisson (negative Laplacian) operators on padded grids.

PyTorch port of ``multigridcmt_tpu.ops.laplacian``. Grids carry a one-cell
ghost boundary of zeros (homogeneous Dirichlet); operators read the
padding and write zeros back to it. The arithmetic order follows the JAX
module term for term, so float64 results agree to rounding.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _is_zero(sigma) -> bool:
    """True iff sigma is a Python zero (lets the shift be skipped)."""
    return isinstance(sigma, (int, float)) and sigma == 0


def _pad(core: torch.Tensor) -> torch.Tensor:
    """Wrap an interior array in a one-cell zero ghost boundary."""
    return F.pad(core, (1, 1) * core.ndim)


def apply_poisson(u: torch.Tensor, h: float, sigma=0.0) -> torch.Tensor:
    """y = (A - sigma*I) u with A the (negative) Laplacian; padded in/out."""
    if u.ndim == 1:
        y = _apply_1d(u, h)
    elif u.ndim == 2:
        y = _apply_2d(u, h)
    elif u.ndim == 3:
        y = _apply_3d(u, h)
    else:
        raise ValueError(f"expected 1D/2D/3D padded grid, got ndim={u.ndim}")
    if _is_zero(sigma):
        return y
    return y - sigma * u


def _apply_1d(u: torch.Tensor, h: float) -> torch.Tensor:
    inv_h2 = 1.0 / (h * h)
    return _pad((2.0 * u[1:-1] - u[:-2] - u[2:]) * inv_h2)


def _apply_2d(u: torch.Tensor, h: float) -> torch.Tensor:
    inv_h2 = 1.0 / (h * h)
    core = (4.0 * u[1:-1, 1:-1] - u[:-2, 1:-1] - u[2:, 1:-1]
            - u[1:-1, :-2] - u[1:-1, 2:]) * inv_h2
    return _pad(core)


def _apply_3d(u: torch.Tensor, h: float) -> torch.Tensor:
    """7-point stencil (1/h^2)[6 centre, -1 each face neighbour]."""
    inv_h2 = 1.0 / (h * h)
    core = (6.0 * u[1:-1, 1:-1, 1:-1]
            - u[:-2, 1:-1, 1:-1] - u[2:, 1:-1, 1:-1]
            - u[1:-1, :-2, 1:-1] - u[1:-1, 2:, 1:-1]
            - u[1:-1, 1:-1, :-2] - u[1:-1, 1:-1, 2:]) * inv_h2
    return _pad(core)


def residual(u: torch.Tensor, b: torch.Tensor, h: float,
             sigma=0.0) -> torch.Tensor:
    """r = b - (A - sigma*I) u, padded in, padded out (ghosts stay zero)."""
    inv_h2 = 1.0 / (h * h)
    if u.ndim == 1:
        core = b[1:-1] - (2.0 * u[1:-1] - u[:-2] - u[2:]) * inv_h2
        if not _is_zero(sigma):
            core = core + sigma * u[1:-1]
        return _pad(core)
    if u.ndim == 3:
        core = b[1:-1, 1:-1, 1:-1] - (
            6.0 * u[1:-1, 1:-1, 1:-1]
            - u[:-2, 1:-1, 1:-1] - u[2:, 1:-1, 1:-1]
            - u[1:-1, :-2, 1:-1] - u[1:-1, 2:, 1:-1]
            - u[1:-1, 1:-1, :-2] - u[1:-1, 1:-1, 2:]) * inv_h2
        if not _is_zero(sigma):
            core = core + sigma * u[1:-1, 1:-1, 1:-1]
        return _pad(core)
    if u.ndim != 2:
        raise ValueError(f"expected 1D/2D/3D padded grid, got ndim={u.ndim}")
    core = b[1:-1, 1:-1] - (4.0 * u[1:-1, 1:-1] - u[:-2, 1:-1] - u[2:, 1:-1]
                            - u[1:-1, :-2] - u[1:-1, 2:]) * inv_h2
    if not _is_zero(sigma):
        core = core + sigma * u[1:-1, 1:-1]
    return _pad(core)


def diag_value(ndim: int, h: float, sigma=0.0):
    """Diagonal entry of A - sigma*I (constant across the grid): 2d/h^2."""
    d = (2.0 * ndim) / (h * h)
    if _is_zero(sigma):
        return d
    return d - sigma


def dense_operator(n: int, ndim: int, h: float) -> np.ndarray:
    """Dense float64 NumPy operator for the coarsest-level inverse and tests.

    1D: tridiag(-1, 2, -1)/h^2 of size n; 2D: 5-point Kronecker sum of size
    n^2 (row-major interior ordering); 3D: 7-point Kronecker sum of size n^3.
    """
    t = (np.diag(2.0 * np.ones(n)) - np.diag(np.ones(n - 1), 1)
         - np.diag(np.ones(n - 1), -1))
    if ndim == 1:
        return t / (h * h)
    eye = np.eye(n)
    if ndim == 2:
        return (np.kron(t, eye) + np.kron(eye, t)) / (h * h)
    eye2 = np.eye(n * n)
    a3 = (np.kron(t, eye2) + np.kron(eye, np.kron(t, eye))
          + np.kron(eye2, t))
    return a3 / (h * h)


def eigenvalue_1d(k: int, n: int, h: float) -> float:
    """Exact k-th eigenvalue of the discrete 1D operator: (2/h^2)(1-cos(k*pi*h))."""
    return (2.0 / (h * h)) * (1.0 - np.cos(k * np.pi * h))


def eigenvalue_2d(kx: int, ky: int, n: int, h: float) -> float:
    """Exact eigenvalue of the discrete 2D operator (sum of 1D eigenvalues)."""
    return eigenvalue_1d(kx, n, h) + eigenvalue_1d(ky, n, h)


def eigenvalue_3d(kx: int, ky: int, kz: int, n: int, h: float) -> float:
    """Exact eigenvalue of the discrete 3D operator (sum of 1D eigenvalues)."""
    return (eigenvalue_1d(kx, n, h) + eigenvalue_1d(ky, n, h)
            + eigenvalue_1d(kz, n, h))
