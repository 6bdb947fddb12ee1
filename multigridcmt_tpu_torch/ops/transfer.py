"""Inter-grid transfers: full-weighting restriction, (bi/tri)linear
prolongation and the cubic prolongation of full multigrid's solution walk,
as strided slicing on padded grids.

PyTorch port of ``restrict``, ``prolong`` and ``fmg_prolong`` from
``multigridcmt_tpu.ops.transfer``. Fine interior point 2j (1-based over
the padded array) coincides with coarse point j, and n = 2*nc + 1. Each
function's separable passes run in the JAX function's own axis order
(``restrict`` and ``prolong``: ascending in 1D/2D, minor first in 3D;
``fmg_prolong``: ascending in every dimension), with the same arithmetic
per pass. Outputs are contiguous, as the CUDA kernels require of their
inputs. The JAX module's 3D banded-matmul passes and aligned-layout
variants have no counterpart, as the port keeps the logical padded layout.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _along(ndim: int, axis: int, s: slice):
    """Index that applies slice ``s`` to ``axis`` only."""
    idx = [slice(None)] * ndim
    idx[axis] = s
    return tuple(idx)


def _pad_axis(t: torch.Tensor, axis: int) -> torch.Tensor:
    """Zero ghost cell at both ends of one axis."""
    pad = [0, 0] * t.ndim
    pad[2 * (t.ndim - 1 - axis)] = pad[2 * (t.ndim - 1 - axis) + 1] = 1
    return F.pad(t, pad)


def _restrict_axis(f: torch.Tensor, axis: int) -> torch.Tensor:
    """Full weighting [1,2,1]/4 and coarsening along one padded axis."""
    at = lambda s: _along(f.ndim, axis, s)                    # noqa: E731
    core = f[at(slice(1, -1))]              # length n = 2*nc + 1
    centers = core[at(slice(1, None, 2))]   # fine points 2, 4, ..., 2*nc
    edges = core[at(slice(0, None, 2))]     # fine points 1, 3, ..., 2*nc+1
    rc = 0.25 * (edges[at(slice(None, -1))] + 2.0 * centers
                 + edges[at(slice(1, None))])
    return _pad_axis(rc, axis)


def _prolong_axis(c: torch.Tensor, axis: int) -> torch.Tensor:
    """Linear interpolation along one padded axis: nc+2 -> 2*nc+3."""
    at = lambda s: _along(c.ndim, axis, s)                    # noqa: E731
    shape = list(c.shape)
    shape[axis] = 2 * (shape[axis] - 2) + 1
    fine = torch.empty(shape, dtype=c.dtype, device=c.device)
    # Fine 2j+1 (j = 0..nc) averages coarse j and j+1, the ghosts supplying
    # the boundary halves; fine 2j takes coarse j.
    fine[at(slice(0, None, 2))] = 0.5 * (c[at(slice(None, -1))]
                                         + c[at(slice(1, None))])
    fine[at(slice(1, None, 2))] = c[at(slice(1, -1))]
    return _pad_axis(fine, axis)


def _axis_order(ndim: int):
    return range(ndim) if ndim < 3 else reversed(range(ndim))


def restrict(r: torch.Tensor) -> torch.Tensor:
    """Full-weighting restriction, padded fine grid -> padded coarse grid
    (1D [1,2,1]/4, 2D 9-point/16, 3D 27-point/64)."""
    for ax in _axis_order(r.ndim):
        r = _restrict_axis(r, ax)
    return r


def prolong(e: torch.Tensor) -> torch.Tensor:
    """(Bi/tri)linear prolongation, padded coarse grid -> padded fine grid."""
    for ax in _axis_order(e.ndim):
        e = _prolong_axis(e, ax)
    return e


def _fmg_prolong_axis(c: torch.Tensor, axis: int) -> torch.Tensor:
    """Cubic interpolation along one padded axis: nc+2 -> 2*nc+3.

    Odd fine points take the 4-point cubic (-1, 9, 9, -1)/16; at the
    domain's ends the out-of-domain value comes from the odd reflection
    u(-h) = -u(h) of a homogeneous-Dirichlet solution."""
    at = lambda s: _along(c.ndim, axis, s)                    # noqa: E731
    nc = c.shape[axis] - 2
    # ext[j] = c[j-1] for j = 0..nc+3, with c[-1] := -c[1] and
    # c[nc+2] := -c[nc].
    ext = torch.cat([-c[at(slice(1, 2))], c, -c[at(slice(nc, nc + 1))]],
                    dim=axis)
    # Fine 2j+1 (j = 0..nc) sits between coarse j and j+1: the cubic
    # through coarse j-1 .. j+2; fine 2j takes coarse j.
    odd = (-ext[at(slice(0, nc + 1))] + 9.0 * c[at(slice(0, nc + 1))]
           + 9.0 * c[at(slice(1, nc + 2))] - ext[at(slice(3, nc + 4))]) / 16.0
    shape = list(c.shape)
    shape[axis] = 2 * nc + 1
    fine = torch.empty(shape, dtype=c.dtype, device=c.device)
    fine[at(slice(0, None, 2))] = odd
    fine[at(slice(1, None, 2))] = c[at(slice(1, -1))]
    return _pad_axis(fine, axis)


def fmg_prolong(e: torch.Tensor) -> torch.Tensor:
    """Cubic (FMG-order) prolongation, padded coarse grid -> padded fine
    grid, any ndim: the tensor product of the 1D cubic, its passes in
    ascending axis order (unlike ``prolong`` in 3D)."""
    for ax in range(e.ndim):
        e = _fmg_prolong_axis(e, ax)
    return e
