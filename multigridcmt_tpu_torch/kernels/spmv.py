"""Banded (DIA) SpMV on the packed layout.

Replaces the TPU kernel ``multigridcmt_tpu/kernels/spmv.py``
(``spmv_packed``, one ``pallas_call``) with ``csrc/spmv.cu`` (one thread an
output element; see the note there on what bounds it).

Layout, as in the JAX package, so that chained applies never repack and
the tests compare like with like: a length-N vector is stored packed as a
``(H + R + H, 128)`` array, element i at row ``H + i // 128``, lane
``i % 128``, with R = ceil(N / 128) rounded up to 8 and H (a multiple of 8)
covering the largest |offset| in rows; the H-row skirts are zero. A
``PackedDIA`` holds diagonal k's row-aligned values (``A[i, i +
offsets[k]]`` at packed position i) as ``(ndiag, R, 128)``, zero for
i >= N, and its offsets once as a device int64 tensor (they are run-time
values on the card; the JAX kernel bakes them in at trace time). The
kernel writes the same packed layout, skirts included, so its output
feeds the next apply directly.

Every diagonal entry past N is zero (``pack_dia`` pads with zeros), so
rows i >= N of the result come out 0, and the skirt reads of edge rows are
multiplied by the zeros the assembly put there: the kernel has no masks,
as the TPU kernel has none.

bfloat16 (the TPU kernel's own mode, which no path of either package runs):
the product and the sum of each step round to bfloat16, y = 0, then y = y +
d_k x_k in ``offsets`` order, each operation rounded (``mg_spmv_dia_bf16``;
launches counted apart, ``bf16_launches``).

``spmv_packed_plain`` is the plain PyTorch version: the same sum, in
``offsets`` order, each product and sum a PyTorch op in the storage dtype
(in bfloat16 each rounds, as the TPU kernel's). Device rule (``_wrap``): a CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from ..ops.sparse import DIA
from ._wrap import check_tensor, launch_on, on_cuda

LANES = 128

# Launches of the CUDA kernel in this process (plain-version calls do not
# count); the bfloat16 mode's apart.
launches = 0
bf16_launches = 0


def rows_for(n_elems: int) -> int:
    """Packed row count R for an N-element vector (a multiple of 8)."""
    r = -(-n_elems // LANES)
    return -(-r // 8) * 8


def halo_rows(offsets: Tuple[int, ...]) -> int:
    """Skirt rows H covering the largest |offset| (a multiple of 8)."""
    m = max(abs(o) for o in offsets) if offsets else 0
    h = m // LANES + 1
    return -(-h // 8) * 8


@dataclasses.dataclass(frozen=True)
class PackedDIA:
    """A DIA matrix packed into the kernel's (rows, 128) layout.

    ``diags`` is (ndiag, R, 128); ``offset_tensor`` holds ``offsets`` as
    int64 on ``diags``' device, made once here so that chained applies
    copy nothing to the card."""

    diags: torch.Tensor            # (ndiag, R, 128)
    offsets: Tuple[int, ...]
    n: int                         # logical vector length N
    offset_tensor: torch.Tensor = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "offset_tensor", torch.tensor(
            self.offsets, dtype=torch.int64, device=self.diags.device))

    @property
    def halo(self) -> int:
        return halo_rows(self.offsets)

    @property
    def nnz(self) -> int:
        return int(torch.count_nonzero(self.diags))


def pack_dia(a: DIA) -> PackedDIA:
    """DIA (``ops.sparse``) -> the packed layout, on ``a``'s device."""
    n = a.shape[0]
    ndiag = a.diags.shape[0]
    r = rows_for(n)
    d = torch.zeros((ndiag, r * LANES), dtype=a.diags.dtype,
                    device=a.diags.device)
    d[:, :n] = a.diags
    return PackedDIA(diags=d.view(ndiag, r, LANES),
                     offsets=tuple(int(o) for o in a.offsets), n=n)


def pack_x(x: torch.Tensor, halo: int) -> torch.Tensor:
    """(N,) vector -> packed (halo + R + halo, 128) operand, skirts zero."""
    n = x.shape[0]
    r = rows_for(n)
    flat = F.pad(x, (halo * LANES, r * LANES - n + halo * LANES))
    return flat.view(-1, LANES)


def unpack_y(y_packed: torch.Tensor, n: int, halo: int) -> torch.Tensor:
    """Packed result -> (N,) vector (a view)."""
    return y_packed.reshape(-1)[halo * LANES: halo * LANES + n]


def _check(a: PackedDIA, x_packed: torch.Tensor) -> None:
    if a.diags.ndim != 3 or a.diags.shape[0] != len(a.offsets) \
            or a.diags.shape[2] != LANES:
        raise ValueError(f"spmv: diags of shape {tuple(a.diags.shape)} for "
                         f"{len(a.offsets)} offsets; expected (ndiag, R, "
                         f"{LANES})")
    r = a.diags.shape[1]
    if r != rows_for(a.n):
        raise ValueError(f"spmv: {r} packed rows for n={a.n}, expected "
                         f"{rows_for(a.n)}")
    check_tensor("diags", a.diags, tuple(a.diags.shape), x_packed,
                 storage=True)
    check_tensor("x_packed", x_packed, (r + 2 * a.halo, LANES), x_packed,
                 storage=True)


def spmv_packed_plain(a: PackedDIA, x_packed: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``spmv_packed``: 0 + d_0 x_0 + d_1 x_1 + ...
    in ``offsets`` order, skirts zero."""
    r = a.diags.shape[1]
    base = a.halo * LANES
    y = torch.zeros_like(x_packed)
    core = y.view(-1)[base: base + r * LANES]
    xf = x_packed.reshape(-1)
    for k, off in enumerate(a.offsets):
        core += a.diags[k].reshape(-1) * xf[base + off: base + off
                                            + r * LANES]
    return y


def spmv_packed(a: PackedDIA, x_packed: torch.Tensor) -> torch.Tensor:
    """y = A @ x entirely in the packed layout; y feeds the next call."""
    global launches, bf16_launches
    _check(a, x_packed)
    if not on_cuda(x_packed):
        return spmv_packed_plain(a, x_packed)
    r = a.diags.shape[1]
    y = torch.empty_like(x_packed)
    launch_on(x_packed, "spmv_dia", a.diags.data_ptr(), x_packed.data_ptr(),
              a.offset_tensor.data_ptr(), y.data_ptr(), len(a.offsets),
              r * LANES, a.halo * LANES, writes=(y,))
    if x_packed.dtype == torch.bfloat16:
        bf16_launches += 1
    else:
        launches += 1
    return y


def spmv_dia(a: DIA, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a DIA matrix through ``spmv_packed`` ((N,) in and
    out). Hot loops pack once and chain ``spmv_packed``."""
    pk = pack_dia(a)
    return unpack_y(spmv_packed(pk, pack_x(x, pk.halo)), pk.n, pk.halo)
