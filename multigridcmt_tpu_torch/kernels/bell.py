"""Block-sparse (blocked-ELL) SpMM.

Replaces the TPU kernel ``multigridcmt_tpu/kernels/bell.py`` (``spmm``,
one ``pallas_call``) with ``csrc/bell.cu``: a CTA a block row, a tile of
vectors and a share of the block row's slices (the share of one rank of a
thread-block cluster), FFMA register tiles fed by a cp.async ring of
slices, the FMAs of a slice skipped where its A values are all zero and
its X values all finite, the cluster's partial tiles summed in rank order
(see the note there on what bounds it). ``launch_geometry`` mirrors its
m-tile and cluster rules.

Format, as in the JAX package: every block row stores exactly ``kmax``
(128, 128) blocks, padded with explicit zero blocks at block column 0, and
``cols`` holds their block columns (int32). Operands are transposed
multivectors: ``Xt`` is (m, n_cols), one vector a row, m a multiple of 8;
``spmv`` carries a single vector as row 0 of an 8-row ``Xt``.

The product accumulates in the compute dtype (JAX's ``_cdt``): float32
for float32 and bfloat16 storage, float64 for float64, in full precision:
the JAX kernel asks for ``Precision.HIGHEST``, so neither the kernel nor
the plain version uses TF32. ``data`` and ``Xt`` must have one dtype and
one device. With bfloat16 storage every value is widened to float32 where
it is used and Yt is rounded to bfloat16 once, at the end (no path of
either package runs it: direct calls).

``spmm_plain`` is the plain PyTorch version (a gather of X's blocks and
an ``einsum`` a k step, in the compute dtype). Device rule (``_wrap``): a CPU tensor takes the
plain version; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..grids import check_device
from ._wrap import check_tensor, compute_dtype, launch_on, on_cuda

BM = 128
BN = 128

# Launches of the CUDA kernel in this process (plain-version calls do not
# count); the bfloat16 mode's apart.
launches = 0
bf16_launches = 0

# csrc/bell.cu's launch constants (the CPU tests hold them against the
# source): threads a CTA; bytes of block columns a staged slice; slices in
# the cp.async ring; the largest cluster a block row's walk of slices
# splits over and the CTAs an SM the split aims at; the m-tiles by dtype
# (the least one that holds m, else the largest); a thread's block rows
# (WIDE at a float32 accumulator's largest m-tile) and vectors.
THREADS = 256
SLICE_BYTES = 128
STAGES = 3
MAX_CLUSTER = 8
CTAS_PER_SM = 4
M_TILES = {torch.float32: (8, 32, 128), torch.float64: (8, 32),
           torch.bfloat16: (8, 32, 128)}
TILE_ROWS, TILE_ROWS_WIDE = 4, 8
TILE_VECTORS = 8


@dataclasses.dataclass(frozen=True)
class SpmmGeometry:
    """The launch of ``spmm``'s kernel: m-tiles of ``m_tile`` vectors
    (``m_tiles`` of them); each stored block walked in slices of
    ``slice_cols`` block columns, a block row's kmax * 128 / slice_cols
    slices split over a cluster of ``cluster`` CTAs, rank q taking slices
    q, q + cluster, ...; a thread's register tile ``rows`` block rows by
    ``vectors`` vectors; a slice's columns split over ``col_groups``
    thread groups."""
    m_tile: int
    m_tiles: int
    cluster: int
    slice_cols: int
    rows: int
    vectors: int
    col_groups: int


def launch_geometry(nbr: int, kmax: int, m: int, dtype, *,
                    sm_count: int = 132) -> SpmmGeometry:
    """``spmm``'s launch on a card of ``sm_count`` SMs, as csrc/bell.cu
    computes it."""
    tiles = M_TILES[dtype]
    m_tile = next((t for t in tiles if m <= t), tiles[-1])
    m_tiles = -(-m // m_tile)
    slice_cols = SLICE_BYTES // dtype.itemsize
    slices = kmax * BN // slice_cols
    cluster = 1
    while (cluster < MAX_CLUSTER and 2 * cluster <= slices
           and nbr * m_tiles * cluster < CTAS_PER_SM * sm_count):
        cluster *= 2
    rows = (TILE_ROWS_WIDE if compute_dtype(dtype) == torch.float32
            and m_tile == tiles[-1] else TILE_ROWS)
    return SpmmGeometry(
        m_tile=m_tile, m_tiles=m_tiles, cluster=cluster,
        slice_cols=slice_cols, rows=rows, vectors=TILE_VECTORS,
        col_groups=THREADS * rows * TILE_VECTORS // (BM * m_tile))


@dataclasses.dataclass(frozen=True)
class BELL:
    """Blocked-ELL matrix: (nbr, kmax) dense (128, 128) blocks and their
    block columns."""

    data: torch.Tensor       # (nbr, kmax, 128, 128)
    cols: torch.Tensor       # (nbr, kmax) int32 block columns
    shape: Tuple[int, int]   # logical (unpadded) matrix shape
    nnz_scalar: int          # scalar nnz of the source matrix (metrics)

    @property
    def nbr(self) -> int:
        return self.data.shape[0]

    @property
    def kmax(self) -> int:
        return self.data.shape[1]

    @property
    def block_shape(self) -> Tuple[int, int]:
        return self.data.shape[2], self.data.shape[3]

    @property
    def n_stored(self) -> int:
        """Stored (dense-block) element count, zero blocks included."""
        return int(np.prod(self.data.shape))


def bell_from_scipy(a, dtype=torch.float32, kmax: int | None = None,
                    device=None) -> BELL:
    """Any scipy.sparse matrix -> BELL with (128, 128) blocks, on
    ``device`` (None: the card). Host-side, set-up time. Block rows with
    fewer populated block columns than ``kmax`` are padded with zero blocks
    at block column 0; a ``kmax`` below the densest block row raises."""
    import scipy.sparse as sp

    device = check_device(device)
    a = sp.csr_matrix(a)
    n_r, n_c = a.shape
    nbr = -(-n_r // BM)
    nbc = -(-n_c // BN)
    coo = a.tocoo()
    pair = (coo.row // BM).astype(np.int64) * nbc + coo.col // BN
    blocks_of = [[] for _ in range(nbr)]
    for p in np.unique(pair):
        br, bc = divmod(int(p), nbc)
        blocks_of[br].append(bc)
    need = max((len(b) for b in blocks_of), default=1) or 1
    if kmax is None:
        kmax = need
    elif kmax < need:
        raise ValueError(f"kmax={kmax} < densest block row ({need})")

    # Held in float64 (exact for the source's values), rounded once to
    # ``dtype`` on the way to the device.
    data = np.zeros((nbr, kmax, BM, BN))
    cols = np.zeros((nbr, kmax), dtype=np.int32)
    padded = sp.csr_matrix((a.data, a.indices, a.indptr),
                           shape=(n_r, nbc * BN))
    for br, bcs in enumerate(blocks_of):
        r0, r1 = br * BM, min((br + 1) * BM, n_r)
        strip = padded[r0:r1]
        for k, bc in enumerate(sorted(bcs)):
            data[br, k, :r1 - r0, :] = strip[:, bc * BN:(bc + 1) * BN] \
                .toarray()
            cols[br, k] = bc
    return BELL(data=torch.from_numpy(data).to(device=device, dtype=dtype),
                cols=torch.from_numpy(cols).to(device), shape=(n_r, n_c),
                nnz_scalar=int(a.nnz))


def _nbc(a: BELL) -> int:
    return -(-a.shape[1] // BN)


def _prepare(a: BELL, xt: torch.Tensor) -> torch.Tensor:
    """Check the operands; return Xt zero-padded to nbc * 128 columns."""
    if xt.ndim != 2 or xt.shape[0] % 8 != 0:
        raise ValueError(f"bell.spmm: Xt of shape {tuple(xt.shape)}; "
                         "expected (m, n_cols) with m a multiple of 8")
    width = _nbc(a) * BN
    if xt.shape[1] < width:
        xt = F.pad(xt, (0, width - xt.shape[1]))
    check_tensor("Xt", xt, tuple(xt.shape), xt, storage=True)
    check_tensor("data", a.data, (a.nbr, a.kmax, BM, BN), xt, storage=True)
    if a.cols.dtype != torch.int32 or a.cols.device != xt.device \
            or tuple(a.cols.shape) != (a.nbr, a.kmax) \
            or not a.cols.is_contiguous():
        raise ValueError(f"bell.spmm: cols must be contiguous int32 of shape "
                         f"{(a.nbr, a.kmax)} on {xt.device}; got "
                         f"{a.cols.dtype} {tuple(a.cols.shape)} on "
                         f"{a.cols.device}")
    return xt


def spmm_plain(a: BELL, xt: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``spmm``: gather X's blocks, then add
    Yt[:, i, r] += sum over c of Xb[:, i, k, c] * data[i, k, r, c] one k
    at a time, as the TPU kernel's k steps do (so zero padding blocks add
    exact zeros), in the compute dtype (bfloat16 values widened to float32,
    Yt rounded to bfloat16 once, at the end)."""
    m = xt.shape[0]
    cdt = compute_dtype(xt.dtype)
    xb = xt[:, :_nbc(a) * BN].reshape(m, _nbc(a), BN)[:, a.cols.long()]
    xb = xb.to(cdt)
    yt = torch.zeros((m, a.nbr, BM), dtype=cdt, device=xt.device)
    for k in range(a.kmax):
        yt += torch.einsum("mic,irc->mir", xb[:, :, k], a.data[:, k].to(cdt))
    return yt.reshape(m, a.nbr * BM).to(xt.dtype)


def spmm(a: BELL, xt: torch.Tensor) -> torch.Tensor:
    """Yt (m, nbr*128) = (A @ X)^T for the transposed multivector Xt
    (m, >= n_cols), m a multiple of 8. Xt's columns past a.shape[1] must be
    zero (or meet zero blocks); Yt's columns past a.shape[0] are zero.
    Yt is stored in Xt's dtype (bfloat16: accumulated in float32, rounded
    once)."""
    global launches, bf16_launches
    xt = _prepare(a, xt)
    if not on_cuda(xt):
        return spmm_plain(a, xt)
    m = xt.shape[0]
    yt = torch.empty((m, a.nbr * BM), dtype=xt.dtype, device=xt.device)
    launch_on(xt, "bell_spmm", a.data.data_ptr(), a.cols.data_ptr(),
              xt.data_ptr(), yt.data_ptr(), a.nbr, a.kmax, m, xt.shape[1],
              writes=(yt,))
    if xt.dtype == torch.bfloat16:
        bf16_launches += 1
    else:
        launches += 1
    return yt


def spmv(a: BELL, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x through ``spmm`` (an 8-row carrier, row 0 live)."""
    n_r, n_c = a.shape
    xt = torch.zeros((8, _nbc(a) * BN), dtype=x.dtype, device=x.device)
    xt[0, :n_c] = x
    return spmm(a, xt)[0, :n_r]
