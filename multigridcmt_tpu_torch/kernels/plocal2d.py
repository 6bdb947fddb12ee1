"""Colour-packed shard-local 2D kernels: the whole V-cycle legs, the
residual, the operator apply and the fused residual norm on one rank's
halo-extended tile stored colour-packed.

Replace the TPU kernels of ``multigridcmt_tpu/kernels/plocal2d.py`` with
``csrc/plocal2d.cu`` (the residual, apply and norm) and
``csrc/plocal2d_legs.cu``, ``csrc/plocal2d_legs_f64.cu`` (the legs:
``csrc/packed2d_legs.cuh``'s row stream on the tile frame; see the note in
``plocal2d.cu`` on what bounds them and what the frame adds):
  * ``residual``: r = b - (A - sigma I) u, and ``apply_op``: (A - sigma I)
    u, one kernel with and without the b stream;
  * ``down_leg``: sweeps, residual and full weighting in one pass (after an
    RB-GS sweep the red residual only: the closing black half-sweep zeroes
    the black one in exact arithmetic), the coarse right-hand side emitted
    in ``local2d``'s unpacked extended convention;
  * ``up_leg``: x + P e, e in that convention, then sweeps;
  * ``residual_norm_sq``: ||b - (A - sigma I) u||^2 over the owned points,
    with no residual written; ``red_only`` sums the red points only.

The packed extended tile. ``local2d``'s extended tile ua (R x C points of
the global padded grid from (row_off, col_off)) is stored as two planes
(2, R, (C + 1) // 2), red points ((i + j) even, global indices) in plane 0
and black ones in plane 1, as in the JAX module:

    P0[p, l] = ua[p, 2l + s(p)]        P1[p, l] = ua[p, 2l + 1 - s(p)]

with s(p) = (p + row_off + col_off) % 2. row_off = d*m + 1 - HALO_ROWS is
odd, so s(p) = (p + 1 + cpar) % 2, cpar = col_off % 2: 0 on a row
decomposition (col_off = 0), 1 on a block one (col_off odd). Unlike the
JAX tile, which Mosaic wants in (16j, 128j) blocks, the tile keeps its
logical extent: a row tile (C = n + 2, odd) has one pad lane a row in one
plane, which stays zero; a block tile (C = mcol + 2*HALO_ROWS, even) has
none. A point is owned if it lies in rows [HALO_ROWS, HALO_ROWS + m) and,
on a block tile, columns [HALO_ROWS, HALO_ROWS + mcol), which are lanes
[HALO_ROWS/2, HALO_ROWS/2 + mcol/2) of both planes.

The norm counts each owned point once. The JAX kernel takes ownership from
its clamped window start (``plocal2d.py:763,798``), so once the tile spans
more than one of its 64-row windows (m >= 128) it counts the last window's
overlap rows twice; the port does not copy that.

Each wrapper has its plain PyTorch version beside it: unpack, the
``local2d`` plain version, pack. Device rule (``_wrap``): a CPU tensor
takes the plain version; a CUDA tensor launches the kernel or raises.

Mixed precision: the legs also take bfloat16 packed tiles, the fine level
of a sharded mixed cycle (``csrc/plocal2d_legs_bf16.cu``,
``csrc/plocal2d_up_bf16_f32.cu``), by ``local2d``'s rule: float32
registers, u' and x' rounded to bfloat16 once on their store (x' in float32
with ``out_dtype``), the down leg's residual that of u' as stored, the
coarse right-hand side and correction in float32. The residual, the apply
and the norm take bfloat16 tiles by the same rule
(``csrc/plocal2d_bf16.cu``): r and (A - sigma I) u rounded once, the norm
a float32 sum. No path of either package runs those three in bfloat16
(the sharded MG-PCG applies A and takes its residual at full precision):
direct calls.
"""
from __future__ import annotations

import torch

from . import _build, local2d, packed2d
from ._wrap import check_out_dtype, check_tensor, compute_dtype, \
    launch_on, on_cuda
from .local2d import HALO_ROWS, max_down_sweeps, max_up_sweeps
from .packed2d import RESNORM_BLOCKS

# Launches of each CUDA kernel in this process (plain-version calls do not
# count): the residual kernel with the b stream (residual) and without it
# (apply_op), each leg and the norm; the bfloat16 modes apart, as local2d
# counts them.
residual_launches = 0
apply_launches = 0
down_launches = 0
up_launches = 0
resnorm_launches = 0
down_bf16_launches = 0
up_bf16_launches = 0
up_bf16_f32_launches = 0
residual_bf16_launches = 0
apply_bf16_launches = 0
resnorm_bf16_launches = 0


def _layout(cpar: int):
    """(plane, first row, first column) of the four strided parts of an
    extended tile whose even rows hold red points from column s0."""
    s0 = (1 + cpar) % 2
    return ((0, 0, s0), (0, 1, 1 - s0), (1, 0, 1 - s0), (1, 1, s0))


def pack_ext(ua: torch.Tensor, cpar: int) -> torch.Tensor:
    """Unpacked extended tile (R, C) -> colour-packed (2, R, (C + 1) // 2);
    ``cpar``: the parity of the tile's column offset (0 rows, 1 blocks)."""
    r, c = ua.shape
    s = ua.new_zeros((2, r, (c + 1) // 2))
    for plane, row0, col0 in _layout(cpar):
        part = ua[row0::2, col0::2]
        s[plane, row0::2, : part.shape[1]] = part
    return s


def unpack_ext(s: torch.Tensor, c: int, cpar: int) -> torch.Tensor:
    """Colour-packed (2, R, (c + 1) // 2) -> unpacked extended (R, c)."""
    ua = s.new_zeros((s.shape[1], c))
    for plane, row0, col0 in _layout(cpar):
        part = ua[row0::2, col0::2]
        part.copy_(s[plane, row0::2, : part.shape[1]])
    return ua


def _cols(s: torch.Tensor, n: int, col_off: int) -> int:
    """Unpacked columns of a packed tile: a row tile (col_off 0) has the
    grid's n + 2, a block tile (col_off odd) twice its lanes."""
    return 2 * s.shape[2] if col_off % 2 else n + 2


# ---------------------------------------------------------------------------
# Plain PyTorch versions: unpack, local2d's plain version, pack
# ---------------------------------------------------------------------------

def _unpacked(n, col_off, *tiles):
    c = _cols(tiles[0], n, col_off)
    return [unpack_ext(t, c, col_off % 2) for t in tiles]


def _red(r, n, row_off, col_off):
    """r with its black points ((i + j) odd, global indices) set to 0."""
    _, _, red = local2d._masks(r.shape, n, row_off, col_off, r.device)
    return torch.where(red, r, torch.zeros_like(r))


def residual_plain(s, bs, n, h, row_off, col_off=0, sigma=0.0):
    """Plain PyTorch version of ``residual``: in the compute dtype (from
    widened tiles for bfloat16 ones, rounded once to bfloat16 at the end,
    the TPU kernel's rule; ``local2d.residual_plain`` on bfloat16 tiles
    would round every operation)."""
    cdt = compute_dtype(s.dtype)
    u, b = _unpacked(n, col_off, s, bs)
    r = local2d.residual_plain(u.to(cdt), b.to(cdt), n, h, row_off, col_off,
                               sigma=sigma)
    return pack_ext(r, col_off % 2).to(s.dtype)


def apply_op_plain(s, n, h, row_off, col_off=0, sigma=0.0):
    """Plain PyTorch version of ``apply_op``: -residual(u, 0) (rounding
    to nearest even is odd-symmetric, so a bfloat16 apply rounds as the
    kernel's (A - sigma I) u)."""
    return -residual_plain(s, torch.zeros_like(s), n, h, row_off, col_off,
                           sigma=sigma)


def residual_restrict_plain(s, bs, n, h, m, row_off, col_off=0, *,
                            sigma=0.0, mcol=0, red_only=False):
    """``local2d.residual_restrict_plain`` of packed tiles: the down
    leg's coarse output for its stored u' (``red_only`` after an RB-GS
    sweep)."""
    u, b = _unpacked(n, col_off, s, bs)
    return local2d.residual_restrict_plain(u, b, n, h, m, row_off, col_off,
                                           sigma=sigma, mcol=mcol,
                                           red_only=red_only)


def down_leg_plain(s, bs, n, h, m, row_off, col_off=0, *, kind, omega,
                   sweeps, sigma=0.0, mcol=0):
    """Plain PyTorch version of ``down_leg``: in the compute dtype
    (float32 for bfloat16 tiles), u' stored in the tiles' dtype, the
    residual of u' as stored (red only after an RB-GS sweep)."""
    cdt = compute_dtype(s.dtype)
    u, b = _unpacked(n, col_off, s, bs)
    us = local2d._smooth_plain(u.to(cdt), b.to(cdt), n, h, row_off, col_off,
                               kind=kind, omega=omega, sweeps=sweeps,
                               sigma=sigma).to(s.dtype)
    return (pack_ext(us, col_off % 2),
            local2d.residual_restrict_plain(
                us, b, n, h, m, row_off, col_off, sigma=sigma, mcol=mcol,
                red_only=kind == "rbgs" and sweeps >= 1))


def up_leg_plain(x, e_ext, bs, n, nc, h, m, row_off, col_off=0, *, kind,
                 omega, sweeps, sigma=0.0, mcol=0, out_dtype=None):
    """Plain PyTorch version of ``up_leg`` (x' in ``out_dtype``, default
    x's)."""
    u, b = _unpacked(n, col_off, x, bs)
    return pack_ext(local2d.up_leg_plain(u, e_ext, b, n, nc, h, m, row_off,
                                         col_off, kind=kind, omega=omega,
                                         sweeps=sweeps, sigma=sigma,
                                         mcol=mcol, out_dtype=out_dtype),
                    col_off % 2)


def residual_norm_sq_plain(s, bs, n, h, m, row_off, col_off=0, *, mcol=0,
                           red_only=False, sigma=0.0):
    """Plain PyTorch version of ``residual_norm_sq``: the sum of squares of
    the unpacked residual over the owned points (red ones with
    ``red_only``), in the compute dtype (from widened tiles, summed in
    float32, for bfloat16 ones)."""
    cdt = compute_dtype(s.dtype)
    u, b = _unpacked(n, col_off, s, bs)
    r = local2d.residual_plain(u.to(cdt), b.to(cdt), n, h, row_off, col_off,
                               sigma=sigma)
    if red_only:
        r = _red(r, n, row_off, col_off)
    hh = HALO_ROWS
    ro = r[hh:hh + m, hh:hh + mcol] if mcol else r[hh:hh + m]
    return torch.sum(ro * ro)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _frame(rows: int, cols: int, row_off: int, col_off: int) -> dict:
    """The row-streaming legs' frame (``packed2d.leg_geometry``'s rows,
    first, lanes) of the packed tile of an unpacked rows x cols extended
    tile at global (row_off, col_off): global rows from row_off, and the
    tile frame's lanes, one more than the array's on a block tile (odd
    col_off; csrc/plocal2d.cu's note)."""
    return dict(rows=rows, first=row_off,
                lanes=(cols + (col_off & 1) + 1) // 2)


def leg_geometry(leg: str, rows: int, cols: int, n: int, row_off: int,
                 col_off: int, kind: str, sweeps: int, *,
                 sm_count: int = 132) -> packed2d.LegGeometry:
    """Geometry of the row-streaming down or up leg (``packed2d.
    leg_geometry``) on the packed tile of an unpacked rows x cols extended
    tile at global (row_off, col_off), for ``sm_count`` SMs."""
    return packed2d.leg_geometry(leg, n, kind, sweeps, sm_count=sm_count,
                                 **_frame(rows, cols, row_off, col_off))


def _check_packed(what: str, s: torch.Tensor, b, n: int,
                  col_off: int) -> int:
    """Raise unless s (and b, if given) is a packed tile whose unpacked
    width fits ``col_off``'s decomposition, float32, float64 or bfloat16;
    returns that width."""
    if s.ndim != 3 or s.shape[0] != 2 or s.shape[1] < 3 or s.shape[2] < 2:
        raise ValueError(f"{what}: expected a packed (2, R, lanes) tile, "
                         f"got shape {tuple(s.shape)}")
    if n < 3:
        raise ValueError(f"{what}: n={n} must be >= 3")
    c = _cols(s, n, col_off)
    if col_off % 2 == 0 and (col_off != 0 or s.shape[2] != (c + 1) // 2):
        raise ValueError(f"{what}: a row tile (col_off 0) of n={n} has "
                         f"{(c + 1) // 2} lanes, got {s.shape[2]} lanes and "
                         f"col_off {col_off}")
    check_tensor("u", s, s.shape, s, storage=True)
    if b is not None:
        check_tensor("b", b, s.shape, s, storage=True)
    return c


def _check_leg(what, s, b, n, m, mcol, col_off):
    """The coarse tile's shape of a leg on packed tile s (float32, float64
    or bfloat16)."""
    c = _check_packed(what, s, b, n, col_off)
    if (mcol == 0) != (col_off % 2 == 0):
        raise ValueError(f"{what}: mcol={mcol} and col_off={col_off} are "
                         "not one decomposition (rows: 0 and 0; blocks: "
                         "mcol > 0, col_off odd)")
    return local2d._check_leg(n, m, mcol, (s.shape[1], c))


def _residual(s, b, c, n, h, row_off, col_off, sigma):
    """Launch the residual kernel on packed tile s of c unpacked columns:
    with the b stream, or the apply (A - sigma I) u when b is None."""
    out = torch.empty_like(s)
    launch_on(s, "plocal2d_residual", s.data_ptr(),
              (s if b is None else b).data_ptr(), out.data_ptr(), s.shape[1],
              c, n, int(row_off), int(col_off), float(h), float(sigma),
              int(b is not None), writes=(out,))
    return out


def residual(s: torch.Tensor, bs: torch.Tensor, n: int, h: float,
             row_off: int, col_off: int = 0, sigma=0.0) -> torch.Tensor:
    """r = b - (A - sigma I) u on a packed extended tile; zero off the
    global interior, on the tile's ring and in pad lanes. bfloat16 tiles:
    computed in float32, r stored in bfloat16, as the TPU kernel's."""
    global residual_launches, residual_bf16_launches
    c = _check_packed("plocal2d.residual", s, bs, n, col_off)
    if not on_cuda(s):
        return residual_plain(s, bs, n, h, row_off, col_off, sigma=sigma)
    out = _residual(s, bs, c, n, h, row_off, col_off, sigma)
    if s.dtype == torch.bfloat16:
        residual_bf16_launches += 1
    else:
        residual_launches += 1
    return out


def apply_op(s: torch.Tensor, n: int, h: float, row_off: int,
             col_off: int = 0, sigma=0.0) -> torch.Tensor:
    """(A - sigma I) u on a packed extended tile, -residual(u, 0) without
    reading a b; ghosts need to be exact to depth 1. bfloat16 tiles as
    ``residual``."""
    global apply_launches, apply_bf16_launches
    c = _check_packed("plocal2d.apply_op", s, None, n, col_off)
    if not on_cuda(s):
        return apply_op_plain(s, n, h, row_off, col_off, sigma=sigma)
    out = _residual(s, None, c, n, h, row_off, col_off, sigma)
    if s.dtype == torch.bfloat16:
        apply_bf16_launches += 1
    else:
        apply_launches += 1
    return out


def down_leg(s: torch.Tensor, bs: torch.Tensor, n: int, h: float, m: int,
             row_off: int, col_off: int = 0, *, kind: str, omega: float,
             sweeps: int, sigma=0.0, mcol: int = 0):
    """(smooth^sweeps, residual, restrict) of a V-cycle down leg in one pass
    over a packed extended tile of m owned rows (and mcol owned columns; 0
    for a row decomposition).

    Returns (u', rc_ext): the smoothed packed tile (ghosts stale) and the
    coarse right-hand side in ``local2d``'s unpacked extended convention
    (``local2d.down_leg``'s rc_ext: owned rows at [HALO_ROWS, HALO_ROWS +
    m/2), ghosts zero). Requires sweeps <= max_down_sweeps(kind). Tiles of
    float32, float64 or bfloat16 (u' in the tiles' dtype, rc_ext in float32
    for bfloat16).
    """
    global down_launches, down_bf16_launches
    local2d._check_kind(kind, sweeps, max_down_sweeps(kind))
    cshape = _check_leg("plocal2d.down_leg", s, bs, n, m, mcol, col_off)
    if not on_cuda(s):
        return down_leg_plain(s, bs, n, h, m, row_off, col_off, kind=kind,
                              omega=omega, sweeps=sweeps, sigma=sigma,
                              mcol=mcol)
    hh = HALO_ROWS
    c = _cols(s, n, col_off)
    u_out = torch.empty_like(s)
    # The kernel writes every entry of rc (zeros off the owned box).
    rc = torch.empty(cshape, dtype=compute_dtype(s.dtype), device=s.device)
    ccol = local2d.coarse_offset(col_off) if mcol else 0
    cols = (hh, hh + mcol // 2) if mcol else (0, cshape[1])
    launch_on(s, "plocal2d_down", s.data_ptr(), bs.data_ptr(),
              u_out.data_ptr(), rc.data_ptr(), s.shape[1], c, cshape[0],
              cshape[1], n, int(row_off), int(col_off),
              local2d.coarse_offset(row_off), ccol, hh, hh + m // 2, cols[0],
              cols[1], float(h), float(sigma), _build.KIND_CODES[kind],
              float(omega), sweeps,
              packed2d._launch_geometry(
                  "down", n, kind, sweeps, s.device.index or 0,
                  **_frame(s.shape[1], c, int(row_off), int(col_off))),
              writes=(u_out, rc))
    if s.dtype == torch.bfloat16:
        down_bf16_launches += 1
    else:
        down_launches += 1
    return u_out, rc


def up_leg(x: torch.Tensor, e_ext: torch.Tensor, bs: torch.Tensor, n: int,
           nc: int, h: float, m: int, row_off: int, col_off: int = 0, *,
           kind: str, omega: float, sweeps: int, sigma=0.0, out_dtype=None,
           mcol: int = 0) -> torch.Tensor:
    """smooth^sweeps(x + P e) of a V-cycle up leg in one pass over a packed
    extended tile. x and b carry exact ghosts; e is the coarse correction in
    ``local2d``'s unpacked extended convention with exact ghosts. Returns
    the smoothed packed tile (ghosts stale). Requires sweeps <=
    max_up_sweeps(kind). x and b of float32, float64 or bfloat16; e in the
    compute dtype (float32 for bfloat16 x); x' in x's dtype or, with
    ``out_dtype=torch.float32`` for bfloat16 x (the top level of a mixed
    cycle), in float32.
    """
    global up_launches, up_bf16_launches, up_bf16_f32_launches
    local2d._check_kind(kind, sweeps, max_up_sweeps(kind))
    if n != 2 * nc + 1:
        raise ValueError(f"fine n={n} is not 2*nc+1 for nc={nc}")
    cshape = _check_leg("plocal2d.up_leg", x, bs, n, m, mcol, col_off)
    out_dtype = check_out_dtype("plocal2d.up_leg", x, out_dtype)
    check_tensor("e", e_ext, cshape, x, compute_dtype(x.dtype))
    if not on_cuda(x):
        return up_leg_plain(x, e_ext, bs, n, nc, h, m, row_off, col_off,
                            kind=kind, omega=omega, sweeps=sweeps,
                            sigma=sigma, mcol=mcol, out_dtype=out_dtype)
    c = _cols(x, n, col_off)
    out = torch.empty_like(x, dtype=out_dtype)
    ccol = local2d.coarse_offset(col_off) if mcol else 0
    launch_on(x, "plocal2d_up", x.data_ptr(), e_ext.data_ptr(),
              bs.data_ptr(), out.data_ptr(), x.shape[1], c, cshape[0],
              cshape[1], n, int(row_off), int(col_off),
              local2d.coarse_offset(row_off), ccol, float(h), float(sigma),
              _build.KIND_CODES[kind], float(omega), sweeps,
              packed2d._launch_geometry(
                  "up", n, kind, sweeps, x.device.index or 0,
                  **_frame(x.shape[1], c, int(row_off), int(col_off))),
              out_dtype=out_dtype, writes=(out,))
    if x.dtype != torch.bfloat16:
        up_launches += 1
    elif out_dtype == torch.bfloat16:
        up_bf16_launches += 1
    else:
        up_bf16_f32_launches += 1
    return out


def residual_norm_sq(s: torch.Tensor, bs: torch.Tensor, n: int, h: float,
                     m: int, row_off: int, col_off: int = 0, *,
                     mcol: int = 0, red_only: bool = False,
                     sigma=0.0) -> torch.Tensor:
    """||b - (A - sigma I) u||^2 over the owned points of a packed extended
    tile (each once), without writing the residual; a 0-d tensor of the
    compute dtype (the tile's own, float32 for bfloat16 tiles, as the TPU
    kernel's; the sum over the mesh is the caller's). Requires ghosts
    exact to depth 1. ``red_only`` sums the red points only, which is exact
    when u has just finished an RB-GS sweep."""
    global resnorm_launches, resnorm_bf16_launches
    c = _check_packed("plocal2d.residual_norm_sq", s, bs, n, col_off)
    if not (0 < m <= s.shape[1] - 2 * HALO_ROWS
            and 0 <= mcol <= c - 2 * HALO_ROWS):
        raise ValueError(f"owned extents m={m}, mcol={mcol} do not fit the "
                         f"tile {tuple(s.shape)}")
    if not on_cuda(s):
        return residual_norm_sq_plain(s, bs, n, h, m, row_off, col_off,
                                      mcol=mcol, red_only=red_only,
                                      sigma=sigma)
    hh = HALO_ROWS
    cols = (hh, hh + mcol) if mcol else (0, c)
    partial = torch.empty(RESNORM_BLOCKS, dtype=torch.float64,
                          device=s.device)
    out = torch.empty((), dtype=compute_dtype(s.dtype), device=s.device)
    launch_on(s, "plocal2d_resnorm", s.data_ptr(), bs.data_ptr(),
              partial.data_ptr(), out.data_ptr(), s.shape[1], c, n,
              int(row_off), int(col_off), hh, hh + m, cols[0], cols[1],
              float(h), float(sigma), int(red_only), RESNORM_BLOCKS,
              writes=(out,))
    if s.dtype == torch.bfloat16:
        resnorm_bf16_launches += 1
    else:
        resnorm_launches += 1
    return out
