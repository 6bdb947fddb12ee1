"""Sparse Laplacian assembly (CSR/COO/DIA), SciPy interop and the general
SpMVs.

PyTorch port of ``multigridcmt_tpu.ops.sparse``. The formats are frozen
dataclasses of tensors, with JAX's arrays and index dtypes (int32 indices,
an int32 ``indptr``):

  * assembly runs once on the host in NumPy/SciPy (the set-up path), as in
    JAX, and the arrays then move to ``device`` (None: the card,
    ``grids.DEFAULT_DEVICE``; with no card a CUDA device raises);
  * ``spmv``/``spmv_coo`` are a gather and an ``index_add_`` over the row
    ids, ``spmv_dia`` one shifted multiply-add a diagonal: plain PyTorch,
    as they are XLA (not Pallas) in JAX. The banded fast path is the CUDA
    DIA kernel in ``kernels/spmv.py``.

The solver's hot path stays matrix-free (``ops/laplacian.py``); these
matrices serve the generality capability, the SpMV benchmark and checks
against ``scipy.sparse``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..grids import check_device


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed-sparse-row matrix: SciPy's (data, indices, indptr) plus
    ``row_ids`` (the row of each nonzero), so the SpMV is one
    ``index_add_`` without an indptr walk."""

    data: torch.Tensor      # (nnz,)
    indices: torch.Tensor   # (nnz,) int32 column of each nonzero
    indptr: torch.Tensor    # (nrows + 1,) int32
    row_ids: torch.Tensor   # (nnz,) int32 row of each nonzero
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return self.data.shape[0]


@dataclasses.dataclass(frozen=True)
class COO:
    """Coordinate-format sparse matrix."""

    data: torch.Tensor   # (nnz,)
    row: torch.Tensor    # (nnz,) int32
    col: torch.Tensor    # (nnz,) int32
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return self.data.shape[0]


@dataclasses.dataclass(frozen=True)
class DIA:
    """Diagonal storage: ``diags[k, i]`` holds ``A[i, i + offsets[k]]``,
    zero where that column is out of range. ``offsets`` are Python ints."""

    diags: torch.Tensor          # (ndiag, n)
    offsets: Tuple[int, ...]
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        """Structural nonzeros (SciPy's count: the explicit zeros that pad
        the fixed-bandwidth diagonals are not counted)."""
        return int(torch.count_nonzero(self.diags))


def _kron_chain(mats):
    import scipy.sparse as sp

    out = mats[0]
    for m in mats[1:]:
        out = sp.kron(out, m)
    return out


def _laplacian_coo_numpy(n: int, ndim: int, h: float):
    """Host-side COO triplets of the 1D/2D/3D Poisson operator (float64)."""
    inv_h2 = 1.0 / (h * h)
    if ndim == 3:
        # Kronecker sum in the row-major interior ordering of
        # laplacian.dense_operator: kron(t,I,I) + kron(I,t,I) + kron(I,I,t).
        import scipy.sparse as sp

        t = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n))
        eye = sp.identity(n)
        a = sum(
            _kron_chain([t if ax == d else eye for ax in range(3)])
            for d in range(3)
        )
        a = (a * inv_h2).tocoo()
        order = np.lexsort((a.col, a.row))
        return (a.row[order], a.col[order], a.data[order], a.shape)
    if ndim == 1:
        idx = np.arange(n)
        rows = [idx, idx[1:], idx[:-1]]
        cols = [idx, idx[1:] - 1, idx[:-1] + 1]
        vals = [np.full(n, 2.0 * inv_h2), np.full(n - 1, -inv_h2),
                np.full(n - 1, -inv_h2)]
        return (np.concatenate(rows), np.concatenate(cols),
                np.concatenate(vals), (n, n))
    # 2D: row-major interior ordering p = i * n + j, 5-point stencil.
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    p = (ii * n + jj).ravel()
    rows, cols, vals = [p], [p], [np.full(n * n, 4.0 * inv_h2)]
    for di, dj in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        ni, nj = ii + di, jj + dj
        ok = ((ni >= 0) & (ni < n) & (nj >= 0) & (nj < n)).ravel()
        q = (ni * n + nj).ravel()
        rows.append(p[ok])
        cols.append(q[ok])
        vals.append(np.full(ok.sum(), -inv_h2))
    return (np.concatenate(rows), np.concatenate(cols),
            np.concatenate(vals), (n * n, n * n))


def _index(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.int32), device=device)


def _values(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), device=device).to(dtype)


def _csr_from_sorted(row, col, val, shape, dtype, device) -> CSR:
    """A CSR from host triplets sorted by (row, col)."""
    indptr = np.zeros(shape[0] + 1, dtype=np.int64)
    np.add.at(indptr, row + 1, 1)
    indptr = np.cumsum(indptr)
    return CSR(data=_values(val, dtype, device), indices=_index(col, device),
               indptr=_index(indptr, device), row_ids=_index(row, device),
               shape=tuple(shape))


def laplacian_coo(n: int, ndim: int, h: float, dtype=torch.float32,
                  device=None) -> COO:
    """The Poisson operator in COO format (sorted by row, col), on
    ``device`` (None: the card)."""
    device = check_device(device)
    row, col, val, shape = _laplacian_coo_numpy(n, ndim, h)
    order = np.lexsort((col, row))
    return COO(data=_values(val[order], dtype, device),
               row=_index(row[order], device),
               col=_index(col[order], device), shape=tuple(shape))


def laplacian_csr(n: int, ndim: int, h: float, dtype=torch.float32,
                  device=None) -> CSR:
    """The Poisson operator in CSR format, on ``device`` (None: the card)."""
    device = check_device(device)
    row, col, val, shape = _laplacian_coo_numpy(n, ndim, h)
    order = np.lexsort((col, row))
    return _csr_from_sorted(row[order], col[order], val[order], shape, dtype,
                            device)


def coo_to_csr(a: COO) -> CSR:
    """COO -> CSR on the host; the result lies on ``a``'s device."""
    row = a.row.cpu().numpy()
    col = a.col.cpu().numpy()
    val = a.data.cpu().numpy()
    order = np.lexsort((col, row))
    return _csr_from_sorted(row[order], col[order], val[order], a.shape,
                            a.data.dtype, a.data.device)


def csr_to_scipy(a: CSR):
    """Export to ``scipy.sparse.csr_matrix`` (tests and oracles)."""
    import scipy.sparse as sp

    return sp.csr_matrix((a.data.cpu().numpy(), a.indices.cpu().numpy(),
                          a.indptr.cpu().numpy()), shape=a.shape)


def spmv(a: CSR, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a general CSR matrix (gather + ``index_add_``)."""
    prods = a.data * torch.index_select(x, 0, a.indices)
    y = torch.zeros(a.shape[0], dtype=prods.dtype, device=prods.device)
    return y.index_add_(0, a.row_ids, prods)


def spmv_coo(a: COO, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a general COO matrix."""
    prods = a.data * torch.index_select(x, 0, a.col)
    y = torch.zeros(a.shape[0], dtype=prods.dtype, device=prods.device)
    return y.index_add_(0, a.row, prods)


def laplacian_dia(n: int, ndim: int, h: float, dtype=torch.float32,
                  device=None) -> DIA:
    """The Poisson operator in DIA format, on ``device`` (None: the card).

    1D: offsets (-1, 0, 1). 2D row-major: offsets (-n, -1, 0, 1, n), with
    the +-1 diagonals zeroed where a row of the grid wraps. 3D: offsets
    (-n^2, -n, -1, 0, 1, n, n^2), zeroed likewise on each axis.
    """
    device = check_device(device)
    inv_h2 = 1.0 / (h * h)
    if ndim == 3:
        m = n ** 3
        offsets = (-n * n, -n, -1, 0, 1, n, n * n)
        d = np.full((7, m), -inv_h2)
        d[3, :] = 6.0 * inv_h2
        idx = np.arange(m)
        ax = [idx // (n * n), (idx // n) % n, idx % n]   # (i, j, k)
        for axis, (lo_row, hi_row) in enumerate(((0, 6), (1, 5), (2, 4))):
            d[lo_row, ax[axis] == 0] = 0.0       # no neighbour below
            d[hi_row, ax[axis] == n - 1] = 0.0   # no neighbour above
        shape = (m, m)
    elif ndim == 1:
        d = np.zeros((3, n))
        d[0, :] = -inv_h2   # offset -1, stored aligned to the row
        d[1, :] = 2.0 * inv_h2
        d[2, :] = -inv_h2
        d[0, 0] = 0.0       # row 0 has no left neighbour
        d[2, -1] = 0.0      # row n-1 has no right neighbour
        offsets = (-1, 0, 1)
        shape = (n, n)
    else:
        m = n * n
        d = np.zeros((5, m))
        d[0, :] = -inv_h2                   # offset -n (up)
        d[1, :] = -inv_h2                   # offset -1 (left)
        d[2, :] = 4.0 * inv_h2              # main
        d[3, :] = -inv_h2                   # offset +1 (right)
        d[4, :] = -inv_h2                   # offset +n (down)
        idx = np.arange(m)
        d[0, idx // n == 0] = 0.0           # first grid row: no up
        d[4, idx // n == n - 1] = 0.0       # last grid row: no down
        d[1, idx % n == 0] = 0.0            # first column: no left
        d[3, idx % n == n - 1] = 0.0        # last column: no right
        offsets = (-n, -1, 0, 1, n)
        shape = (m, m)
    return DIA(diags=_values(d, dtype, device), offsets=offsets, shape=shape)


def spmv_dia(a: DIA, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for DIA storage: one shifted multiply-add a diagonal, in
    ``offsets`` order; y[i] += diags[k, i] * x[i + offsets[k]]."""
    y = torch.zeros_like(x)
    n = a.shape[0]
    for k, off in enumerate(a.offsets):
        dk = a.diags[k]
        if off == 0:
            y += dk * x
        elif off > 0:
            y[: n - off] += dk[: n - off] * x[off:]
        else:
            o = -off
            y[o:] += dk[o:] * x[: n - o]
    return y


# ---------------------------------------------------------------------------
# Explicit transfer matrices and Galerkin coarse operators (host, set-up
# time): A_c = R A P with full-weighting R and (bi)linear P, the algebraic
# alternative to re-discretising each level.
# ---------------------------------------------------------------------------


def _prolongation_scipy_1d(nc: int):
    import scipy.sparse as sp

    nf = 2 * nc + 1
    rows, cols, vals = [], [], []
    for j in range(nc):           # coarse interior point j <-> fine 2j+1
        i = 2 * j + 1
        rows += [i, i - 1, i + 1]
        cols += [j, j, j]
        vals += [1.0, 0.5, 0.5]
    return sp.csr_matrix(
        (np.array(vals), (np.array(rows), np.array(cols))), shape=(nf, nc))


def _prolongation_scipy(nc: int, ndim: int):
    return _kron_chain([_prolongation_scipy_1d(nc)] * ndim).tocsr()


def prolongation_csr(nc: int, ndim: int, dtype=torch.float32,
                     device=None) -> CSR:
    """Linear/bilinear interpolation P: (2nc+1)^d x nc^d interior points
    (vertex-centred, Dirichlet boundaries eliminated)."""
    return scipy_to_csr(_prolongation_scipy(nc, ndim), dtype, device)


def restriction_csr(nc: int, ndim: int, dtype=torch.float32,
                    device=None) -> CSR:
    """Full-weighting restriction R = P^T / 2^d: nc^d x (2nc+1)^d."""
    p = _prolongation_scipy(nc, ndim)
    return scipy_to_csr((p.T / 2.0 ** ndim).tocsr(), dtype, device)


def scipy_to_csr(a, dtype=torch.float32, device=None) -> CSR:
    """Import a scipy.sparse matrix as a CSR on ``device`` (None: the
    card)."""
    import scipy.sparse as sp

    device = check_device(device)
    a = sp.csr_matrix(a)
    a.sum_duplicates()
    coo = a.tocoo()
    order = np.lexsort((coo.col, coo.row))
    return _csr_from_sorted(coo.row[order], coo.col[order], coo.data[order],
                            a.shape, dtype, device)


def galerkin_coarse(a: CSR, nc: int, ndim: int, drop_tol: float = 0.0) -> CSR:
    """A_c = R A P with full-weighting R and (bi)linear P (host, set-up
    time), on ``a``'s device. In 1D this is the re-discretised coarse
    operator exactly; in 2D the standard 9-point Galerkin stencil."""
    p = _prolongation_scipy(nc, ndim)
    r = (p.T / 2.0 ** ndim).tocsr()
    ac = (r @ csr_to_scipy(a) @ p).tocsr()
    if drop_tol > 0.0:
        ac.data[np.abs(ac.data) < drop_tol] = 0.0
        ac.eliminate_zeros()
    return scipy_to_csr(ac, a.data.dtype, a.data.device)
