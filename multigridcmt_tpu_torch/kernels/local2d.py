"""Shard-local 2D kernels: smoothing, the residual and whole V-cycle legs
on one rank's halo-extended tile.

Replace the TPU kernels of ``multigridcmt_tpu/kernels/local2d.py``:
  * ``rbgs_sweep``, ``jacobi_sweep``: up to ``max_fused_sweeps(kind)``
    sweeps in one pass, with ``csrc/local2d_sweep.cu`` and
    ``csrc/local2d_sweep_f64.cu``: ``csrc/packed2d_legs.cuh``'s sweep
    stream (the up leg's row stream without its coarse operand) on the
    legs' unpacked tile frame, at any offsets (see the note in
    ``local2d_sweep.cu``); ``leg_geometry("sweep", ...)`` gives their
    launch geometry;
  * ``residual``: r = b - (A - sigma I) u, with ``csrc/local2d.cu`` (one
    thread a point);
  * ``down_leg``: sweeps, residual and full weighting in one pass, the
    coarse right-hand side emitted in the extended convention, and
    ``up_leg``: x + P e, then sweeps, in one pass, with
    ``csrc/local2d_legs.cu`` and ``csrc/local2d_legs_f64.cu``:
    ``csrc/packed2d_legs.cuh``'s row stream on the unpacked tile frame
    (see the note in ``local2d_legs.cu`` on what bounds them and what the
    frame takes from the plocal2d and fused2d legs). ``leg_geometry``
    gives their launch geometry.

The extended tile. A rank of a row decomposition owns m padded-grid rows,
global rows d*m + 1 .. (d+1)*m; its extended tile holds them at rows
[HALO_ROWS, HALO_ROWS + m) with HALO_ROWS ghost rows on each side, so
tile row p is global row ``row_off + p``, row_off = d*m + 1 - HALO_ROWS,
and its columns are the padded grid's n + 2 (col_off = 0). A block
decomposition extends the columns the same way (mcol owned, col_off =
d*mcol + 1 - HALO_ROWS). The JAX kernels embed this tile in a (16j,
128j) zero-padded array for Mosaic; here it keeps its logical extent,
(m + 2*HALO_ROWS, n + 2) or (m + 2*HALO_ROWS, mcol + 2*HALO_ROWS), and
``ext_rows`` does not round. The offsets are plain ints: each rank knows
its coordinates. Interior and red/black colour come from global indices
(red: row + col even), with floor parity where the offset is negative.

Every kernel updates a point only if it is interior to the global grid and
not on the tile's outer ring (its four neighbours must be in the tile); the
ring keeps its values. A sweep makes the ghost rows stale from the tile's
edge inward (RB-GS 2 rows a sweep, Jacobi 1), so the owned rows are exact
while the staleness stays within HALO_ROWS: that bounds the fused sweeps
(``max_*_sweeps``, as in JAX) and the callers exchange the ghosts again
before they reuse a tile (``parallel/sharded.py``).

Each wrapper has its plain PyTorch version beside it. Device rule
(``_wrap``): a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises.

Mixed precision (the TPU module's ``_cdt`` rule, ``local2d.py:332-343``):
the legs also take bfloat16 tiles, the fine level of a sharded mixed cycle
(``csrc/local2d_legs_bf16.cu``, ``csrc/local2d_up_bf16_f32.cu``). Every
load widens to float32, the sweeps, the residual and the restriction run
in float32, and each point of u' or x' is rounded to bfloat16 once, on its
store; the down leg's residual is that of u' as stored and its coarse
right-hand side is float32, as is the up leg's coarse correction. The up
leg stores x' in bfloat16 or, with ``out_dtype=torch.float32`` (the top
level of a mixed cycle, ``parallel/sharded.py``), in float32. The plain
versions follow the same rule.

Native bfloat16 (the TPU sweeps' and residual's own mode on bfloat16
tiles: every operation rounded to bfloat16, sigma and the constants too):
``rbgs_sweep``, ``jacobi_sweep`` and ``residual`` take bfloat16 tiles and
run ``native_bf16``'s plain versions or its kernel
(``csrc/native_bf16.cu``), counted apart. No path of either package runs
them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build, native_bf16, packed2d
from ._wrap import check_out_dtype, check_tensor, compute_dtype, \
    launch_on, on_cuda

# Ghost rows exchanged per side of a tile, as in the JAX module: 4 fused
# RB-GS sweeps or 8 Jacobi sweeps, or one whole leg.
HALO_ROWS = 8
# Coarse tiles use the same extended convention (the down leg emits its
# coarse right-hand side in it; the up leg reads the correction in it).
COARSE_HALO = HALO_ROWS

# The least segment of the legs' and sweeps' row stream on a tile: the
# unpacked frame's (fused2d.MIN_SEG). Below the 2047 level the launch fills
# the card with segments this short (utils/leg_segments.py --tile times the
# legs and the sweeps at each least segment).
MIN_SEG = 6

# Launches of each CUDA kernel in this process (plain-version calls do not
# count): the sweep kernel of each kind (one a launch, whatever its sweep
# count), the residual, and each leg; the legs' bfloat16 modes apart: the up
# leg's with a bfloat16 x' and with a float32 one (up_bf16_f32_launches).
rbgs_launches = 0
jacobi_launches = 0
residual_launches = 0
down_launches = 0
up_launches = 0
down_bf16_launches = 0
up_bf16_launches = 0
up_bf16_f32_launches = 0
# The native bfloat16 modes of the sweeps and the residual (one a call,
# whatever its launches).
rbgs_bf16_launches = 0
jacobi_bf16_launches = 0
residual_bf16_launches = 0


def max_fused_sweeps(kind: str) -> int:
    return HALO_ROWS // 2 if kind == "rbgs" else HALO_ROWS


def max_down_sweeps(kind: str) -> int:
    """Pre-sweeps one down_leg fuses: the residual (+1) and the restriction
    (+1) eat two rows of the ghost-staleness budget."""
    return (HALO_ROWS - 2) // 2 if kind == "rbgs" else HALO_ROWS - 2


def max_up_sweeps(kind: str) -> int:
    """Post-sweeps one up_leg fuses; two rows of the budget stay reserved
    for the zero-filled two-hop coarse ghosts of a shallow coarse tile
    (``parallel.sharded._ext_coarse_tile``)."""
    return (HALO_ROWS - 2) // 2 if kind == "rbgs" else HALO_ROWS - 2


def ext_rows(m: int) -> int:
    """Rows of the extended tile of m owned rows (no alignment rounding)."""
    return m + 2 * HALO_ROWS


def coarse_offset(off: int) -> int:
    """Global index of coarse tile entry 0 along an extended axis whose fine
    tile starts at global ``off`` (= d*m + 1 - HALO_ROWS): d*m/2 + 1 -
    HALO_ROWS."""
    return (off + 1 - HALO_ROWS) // 2


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _masks(shape, n: int, row_off: int, col_off: int, device):
    """(interior, update, red): points interior to the global grid; those
    of them off the tile's outer ring; points whose global row + col is
    even."""
    rows, cols = shape
    gr = torch.arange(rows, device=device)[:, None] + row_off
    gc = torch.arange(cols, device=device)[None, :] + col_off
    interior = (gr >= 1) & (gr <= n) & (gc >= 1) & (gc <= n)
    ring = torch.ones(shape, dtype=torch.bool, device=device)
    ring[1:-1, 1:-1] = False
    red = ((gr + gc) & 1) == 0
    return interior, interior & ~ring, red


def _gs_vals(u, b, h2, inv_den):
    """Gauss-Seidel update value at every point off the ring (JAX's
    _gs_vals: (h^2 b + up + down + left + right) / (4 - sigma h^2))."""
    core = (h2 * b[1:-1, 1:-1] + u[:-2, 1:-1] + u[2:, 1:-1]
            + u[1:-1, :-2] + u[1:-1, 2:]) * inv_den
    return F.pad(core, (1, 1, 1, 1))


def _residual_vals(u, b, inv_h2, sigma):
    """b - (4u - up - down - left - right) / h^2 + sigma u off the ring."""
    c = u[1:-1, 1:-1]
    au = (4.0 * c - u[:-2, 1:-1] - u[2:, 1:-1] - u[1:-1, :-2]
          - u[1:-1, 2:]) * inv_h2
    return F.pad(b[1:-1, 1:-1] - au + sigma * c, (1, 1, 1, 1))


def _smooth_plain(u, b, n, h, row_off, col_off, *, kind, omega, sweeps,
                  sigma):
    if sweeps == 0:
        return u
    _, update, red = _masks(u.shape, n, row_off, col_off, u.device)
    h2 = h * h
    if kind == "rbgs":
        inv_den = 1.0 / (4.0 - sigma * h2)
        redm, blackm = update & red, update & ~red
        for _ in range(sweeps):
            u = torch.where(redm, _gs_vals(u, b, h2, inv_den), u)
            u = torch.where(blackm, _gs_vals(u, b, h2, inv_den), u)
        return u
    inv_h2 = 1.0 / h2
    scale = omega / (4.0 * inv_h2 - sigma)
    for _ in range(sweeps):
        u = torch.where(update,
                        u + scale * _residual_vals(u, b, inv_h2, sigma), u)
    return u


def rbgs_sweep_plain(u_ext, b_ext, n, h, row_off, col_off=0, sigma=0.0,
                     sweeps=1):
    """Plain PyTorch version of ``rbgs_sweep``."""
    return _smooth_plain(u_ext, b_ext, n, h, row_off, col_off, kind="rbgs",
                         omega=1.0, sweeps=sweeps, sigma=sigma)


def jacobi_sweep_plain(u_ext, b_ext, n, h, omega, row_off, col_off=0,
                       sigma=0.0, sweeps=1):
    """Plain PyTorch version of ``jacobi_sweep``."""
    return _smooth_plain(u_ext, b_ext, n, h, row_off, col_off, kind="jacobi",
                         omega=omega, sweeps=sweeps, sigma=sigma)


def residual_plain(u_ext, b_ext, n, h, row_off, col_off=0, sigma=0.0):
    """Plain PyTorch version of ``residual``."""
    _, update, _ = _masks(u_ext.shape, n, row_off, col_off, u_ext.device)
    vals = _residual_vals(u_ext, b_ext, 1.0 / (h * h), sigma)
    return torch.where(update, vals, torch.zeros_like(vals))


def _restrict_ext(r, n, m, row_off, col_off, mcol):
    """Full weighting of the tile residual r onto the owned coarse rows,
    rows first, then columns; the rest of the coarse tile is zero."""
    hh = HALO_ROWS
    nc = (n - 1) // 2
    mc = m // 2
    # Coarse owned row q is global d*m/2 + 1 + q, centred on tile row
    # 2q + hh + 1; it reads tile rows 2q + hh .. 2q + hh + 2.
    t = 0.25 * (r[hh:hh + m - 1:2] + 2.0 * r[hh + 1:hh + m:2]
                + r[hh + 2:hh + m + 1:2])
    if mcol:
        # Extended columns, the rows' mapping transposed.
        t = 0.25 * (t[:, hh:hh + mcol - 1:2] + 2.0 * t[:, hh + 1:hh + mcol:2]
                    + t[:, hh + 2:hh + mcol + 1:2])
        gcol = (torch.arange(mcol // 2, device=r.device)
                + coarse_offset(col_off) + hh)
        t = torch.where(gcol[None, :] <= nc, t, torch.zeros_like(t))
        t = F.pad(t, (hh, hh))
    else:
        # Global columns: coarse J centres on fine 2J (J = 1 .. nc).
        t = 0.25 * (t[:, 1:n - 1:2] + 2.0 * t[:, 2:n:2] + t[:, 3:n + 1:2])
        t = F.pad(t, (1, 1))
    grow = torch.arange(mc, device=r.device) + coarse_offset(row_off) + hh
    t = torch.where(grow[:, None] <= nc, t, torch.zeros_like(t))
    return F.pad(t, (0, 0, hh, hh))


def _interp_rows(e, rows: int, off: int, coff: int):
    """Linear interpolation along axis 0 from the coarse tile e (global row
    of entry 0: coff) to ``rows`` fine rows (global row of row 0: off):
    fine global 2I takes coarse I, an odd one averages its two coarse
    neighbours; a coarse row outside e reads as zero."""
    f = torch.arange(rows, device=e.device) + off
    lo = (f >> 1) - coff
    even = ((f & 1) == 0)[:, None]

    def take(i):
        ok = ((i >= 0) & (i < e.shape[0]))[:, None]
        return torch.where(ok, e[i.clamp(0, e.shape[0] - 1)],
                           torch.zeros((), dtype=e.dtype, device=e.device))

    a = take(lo)
    return torch.where(even, a, 0.5 * (a + take(lo + 1)))


def _prolong_ext(e, row_off, col_off, mcol, shape):
    """P e on the fine tile: rows first, then columns, as transfer.prolong
    and the JAX kernel's row and lane interpolations."""
    ccol = coarse_offset(col_off) if mcol else 0
    rows_f = _interp_rows(e, shape[0], row_off, coarse_offset(row_off))
    return _interp_rows(rows_f.t(), shape[1], col_off, ccol).t()


def residual_restrict_plain(u_ext, b_ext, n, h, m, row_off, col_off=0, *,
                            sigma=0.0, mcol=0, red_only=False):
    """The full weighting of b - (A - sigma I) u onto the owned coarse
    rows (the extended convention), in the compute dtype (float32 for
    bfloat16 tiles), the red residual only with ``red_only``: the down
    leg's coarse output for its stored u'."""
    cdt = compute_dtype(u_ext.dtype)
    r = residual_plain(u_ext.to(cdt), b_ext.to(cdt), n, h, row_off, col_off,
                       sigma=sigma)
    if red_only:
        _, _, red = _masks(r.shape, n, row_off, col_off, r.device)
        r = torch.where(red, r, torch.zeros_like(r))
    return _restrict_ext(r, n, m, row_off, col_off, mcol)


def down_leg_plain(u_ext, b_ext, n, h, m, row_off, col_off=0, *, kind,
                   omega, sweeps, sigma=0.0, mcol=0):
    """Plain PyTorch version of ``down_leg``: in the compute dtype
    (float32 for bfloat16 tiles), u' stored in the tiles' dtype, the
    residual of u' as stored."""
    cdt = compute_dtype(u_ext.dtype)
    us = _smooth_plain(u_ext.to(cdt), b_ext.to(cdt), n, h, row_off, col_off,
                       kind=kind, omega=omega, sweeps=sweeps, sigma=sigma)
    us = us.to(u_ext.dtype)
    return us, residual_restrict_plain(us, b_ext, n, h, m, row_off, col_off,
                                       sigma=sigma, mcol=mcol)


def up_leg_plain(x_ext, e_ext, b_ext, n, nc, h, m, row_off, col_off=0, *,
                 kind, omega, sweeps, sigma=0.0, mcol=0, out_dtype=None):
    """Plain PyTorch version of ``up_leg``: in the compute dtype (float32
    for bfloat16 tiles), x' stored in ``out_dtype`` (default x's)."""
    cdt = compute_dtype(x_ext.dtype)
    x = x_ext.to(cdt)
    # P e is added at every point interior to the global grid, ring
    # included (the sweeps then leave the ring as it is).
    pe = _prolong_ext(e_ext, row_off, col_off, mcol, x.shape)
    interior, _, _ = _masks(x.shape, n, row_off, col_off, x.device)
    w = torch.where(interior, x + pe, x)
    xs = _smooth_plain(w, b_ext.to(cdt), n, h, row_off, col_off, kind=kind,
                       omega=omega, sweeps=sweeps, sigma=sigma)
    return xs.to(x_ext.dtype if out_dtype is None else out_dtype)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _frame(rows: int, cols: int, row_off: int, col_off: int) -> dict:
    """The row-streaming legs' frame (``packed2d.leg_geometry``'s rows,
    first, lanes, least segment) of a rows x cols extended tile at global
    (row_off, col_off): global rows from row_off, and lanes of two
    columns from the even column at or left of col_off (one lane more
    than cols / 2 on a block tile, whose col_off is odd;
    csrc/local2d_legs.cu's note)."""
    return dict(rows=rows, first=row_off,
                lanes=(cols + (col_off & 1) + 1) // 2, min_seg=MIN_SEG)


def leg_geometry(leg: str, rows: int, cols: int, n: int, row_off: int,
                 col_off: int, kind: str, sweeps: int, *,
                 sm_count: int = 132) -> packed2d.LegGeometry:
    """Geometry of the row-streaming down or up leg, or of the sweep stream
    (``leg="sweep"``; ``packed2d.leg_geometry``), on a rows x cols extended
    tile at global (row_off, col_off), for ``sm_count`` SMs."""
    return packed2d.leg_geometry(leg, n, kind, sweeps, sm_count=sm_count,
                                 **_frame(rows, cols, row_off, col_off))


def _launch_geometry(leg: str, t: torch.Tensor, n: int, row_off: int,
                     col_off: int, kind: str, sweeps: int):
    """The leg's (or sweep stream's) geometry on tile t's card, as the
    kernel's int array (``packed2d._launch_geometry`` on this frame)."""
    return packed2d._launch_geometry(
        leg, n, kind, sweeps, t.device.index or 0,
        **_frame(*t.shape, int(row_off), int(col_off)))


def _check_tile(what: str, u: torch.Tensor, b: torch.Tensor) -> None:
    """Raise unless u and b are 2D tiles of one shape and dtype: float32,
    float64 or bfloat16."""
    if u.ndim != 2 or min(u.shape) < 3:
        raise ValueError(f"{what}: expected a 2D tile of at least 3 x 3, "
                         f"got shape {tuple(u.shape)}")
    check_tensor("u", u, u.shape, u, storage=True)
    check_tensor("b", b, u.shape, u, storage=True)


def _check_kind(kind: str, sweeps: int, cap: int) -> None:
    if kind not in _build.KIND_CODES:
        raise ValueError(f"local legs and sweeps run jacobi or rbgs, not "
                         f"{kind!r}")
    if not 0 <= sweeps <= cap:
        raise ValueError(f"{sweeps} {kind} sweeps: one launch takes 0 to "
                         f"{cap}")


def _check_leg(n: int, m: int, mcol: int, shape) -> tuple:
    """(coarse tile shape) of a leg on the (ext_rows(m), cols) tile."""
    if n < 3 or n % 2 == 0:
        raise ValueError(f"fine n={n} must be odd and >= 3 (n = 2*nc + 1)")
    if m < 2 or m % 2 or mcol < 0 or mcol % 2:
        raise ValueError(f"owned extents m={m}, mcol={mcol} must be even")
    cols = mcol + 2 * HALO_ROWS if mcol else n + 2
    if tuple(shape) != (ext_rows(m), cols):
        raise ValueError(f"tile shape {tuple(shape)}, expected "
                         f"{(ext_rows(m), cols)} for m={m}, mcol={mcol}")
    nc = (n - 1) // 2
    return (ext_rows(m // 2),
            mcol // 2 + 2 * HALO_ROWS if mcol else nc + 2)


def _sweep(kind: str, u, b, n, h, omega, row_off, col_off, sigma, sweeps):
    out = torch.empty_like(u)
    launch_on(u, "local2d_sweep", u.data_ptr(), b.data_ptr(), out.data_ptr(),
              u.shape[0], u.shape[1], n, int(row_off), int(col_off),
              float(h), float(sigma), _build.KIND_CODES[kind], float(omega),
              sweeps, _launch_geometry("sweep", u, n, row_off, col_off, kind,
                                       sweeps), writes=(out,))
    return out


def rbgs_sweep(u_ext: torch.Tensor, b_ext: torch.Tensor, n: int, h: float,
               row_off: int, col_off: int = 0, sigma=0.0,
               sweeps: int = 1) -> torch.Tensor:
    """``sweeps`` (1 to 4) fused RB-GS sweeps on an extended tile; n is the
    global interior size, (row_off, col_off) the global index of the
    tile's (0, 0)."""
    global rbgs_launches, rbgs_bf16_launches
    if sweeps < 1:
        raise ValueError(f"{sweeps} rbgs sweeps: one launch takes 1 to "
                         f"{max_fused_sweeps('rbgs')}")
    _check_kind("rbgs", sweeps, max_fused_sweeps("rbgs"))
    _check_tile("local2d.rbgs_sweep", u_ext, b_ext)
    if u_ext.dtype == torch.bfloat16:
        out, launched = native_bf16.sweep("rbgs", u_ext, b_ext, n, h, 1.0,
                                          sweeps, row_off, col_off, sigma)
        rbgs_bf16_launches += launched
        return out
    if not on_cuda(u_ext):
        return rbgs_sweep_plain(u_ext, b_ext, n, h, row_off, col_off,
                                sigma=sigma, sweeps=sweeps)
    out = _sweep("rbgs", u_ext, b_ext, n, h, 1.0, row_off, col_off, sigma,
                 sweeps)
    rbgs_launches += 1
    return out


def jacobi_sweep(u_ext: torch.Tensor, b_ext: torch.Tensor, n: int, h: float,
                 omega: float, row_off: int, col_off: int = 0, sigma=0.0,
                 sweeps: int = 1) -> torch.Tensor:
    """``sweeps`` (1 to 8) fused weighted-Jacobi sweeps on an extended
    tile."""
    global jacobi_launches, jacobi_bf16_launches
    if sweeps < 1:
        raise ValueError(f"{sweeps} jacobi sweeps: one launch takes 1 to "
                         f"{max_fused_sweeps('jacobi')}")
    _check_kind("jacobi", sweeps, max_fused_sweeps("jacobi"))
    _check_tile("local2d.jacobi_sweep", u_ext, b_ext)
    if u_ext.dtype == torch.bfloat16:
        out, launched = native_bf16.sweep("jacobi", u_ext, b_ext, n, h,
                                          omega, sweeps, row_off, col_off,
                                          sigma)
        jacobi_bf16_launches += launched
        return out
    if not on_cuda(u_ext):
        return jacobi_sweep_plain(u_ext, b_ext, n, h, omega, row_off,
                                  col_off, sigma=sigma, sweeps=sweeps)
    out = _sweep("jacobi", u_ext, b_ext, n, h, omega, row_off, col_off,
                 sigma, sweeps)
    jacobi_launches += 1
    return out


def residual(u_ext: torch.Tensor, b_ext: torch.Tensor, n: int, h: float,
             row_off: int, col_off: int = 0, sigma=0.0) -> torch.Tensor:
    """r = b - (A - sigma I) u on an extended tile; zero off the global
    interior and on the tile's ring."""
    global residual_launches, residual_bf16_launches
    _check_tile("local2d.residual", u_ext, b_ext)
    if u_ext.dtype == torch.bfloat16:
        out, launched = native_bf16.residual(u_ext, b_ext, n, h, row_off,
                                             col_off, sigma)
        residual_bf16_launches += launched
        return out
    if not on_cuda(u_ext):
        return residual_plain(u_ext, b_ext, n, h, row_off, col_off,
                              sigma=sigma)
    out = torch.empty_like(u_ext)
    launch_on(u_ext, "local2d_residual", u_ext.data_ptr(), b_ext.data_ptr(),
              out.data_ptr(), u_ext.shape[0], u_ext.shape[1], n,
              int(row_off), int(col_off), float(h), float(sigma),
              writes=(out,))
    residual_launches += 1
    return out


def down_leg(u_ext: torch.Tensor, b_ext: torch.Tensor, n: int, h: float,
             m: int, row_off: int, col_off: int = 0, *, kind: str,
             omega: float, sweeps: int, sigma=0.0, mcol: int = 0):
    """(smooth^sweeps, residual, restrict) of a V-cycle down leg in one pass
    over the extended tile of m owned rows (and mcol owned columns; 0 for a
    row decomposition).

    Returns (u', rc_ext): the smoothed tile (ghost rows stale: exchange
    them before reuse) and the coarse right-hand side in the same extended
    convention, shape (ext_rows(m/2), nc + 2) or (ext_rows(m/2), mcol/2 +
    2*HALO_ROWS), owned rows at [HALO_ROWS, HALO_ROWS + m/2), ghosts zero.
    Requires sweeps <= max_down_sweeps(kind). Tiles of float32, float64 or
    bfloat16 (u' in the tiles' dtype, rc_ext in float32 for bfloat16).
    """
    global down_launches, down_bf16_launches
    _check_kind(kind, sweeps, max_down_sweeps(kind))
    _check_tile("local2d.down_leg", u_ext, b_ext)
    cshape = _check_leg(n, m, mcol, u_ext.shape)
    if not on_cuda(u_ext):
        return down_leg_plain(u_ext, b_ext, n, h, m, row_off, col_off,
                              kind=kind, omega=omega, sweeps=sweeps,
                              sigma=sigma, mcol=mcol)
    hh = HALO_ROWS
    u_out = torch.empty_like(u_ext)
    # The kernel writes every entry of rc (zeros off the owned box).
    rc = torch.empty(cshape, dtype=compute_dtype(u_ext.dtype),
                     device=u_ext.device)
    ccol = coarse_offset(col_off) if mcol else 0
    cols = (hh, hh + mcol // 2) if mcol else (0, cshape[1])
    launch_on(u_ext, "local2d_down", u_ext.data_ptr(), b_ext.data_ptr(),
              u_out.data_ptr(), rc.data_ptr(), u_ext.shape[0],
              u_ext.shape[1], cshape[0], cshape[1], n, int(row_off),
              int(col_off), coarse_offset(row_off), ccol, hh, hh + m // 2,
              cols[0], cols[1], float(h), float(sigma),
              _build.KIND_CODES[kind], float(omega), sweeps,
              _launch_geometry("down", u_ext, n, row_off, col_off, kind,
                               sweeps), writes=(u_out, rc))
    if u_ext.dtype == torch.bfloat16:
        down_bf16_launches += 1
    else:
        down_launches += 1
    return u_out, rc


def up_leg(x_ext: torch.Tensor, e_ext: torch.Tensor, b_ext: torch.Tensor,
           n: int, nc: int, h: float, m: int, row_off: int, col_off: int = 0,
           *, kind: str, omega: float, sweeps: int, sigma=0.0,
           out_dtype=None, mcol: int = 0) -> torch.Tensor:
    """smooth^sweeps(x + P e) of a V-cycle up leg in one pass over the
    extended tile. x and b carry exact ghosts; e is the coarse correction
    in the extended convention (shape as ``down_leg``'s rc_ext) with exact
    ghosts. Returns the smoothed tile (ghost rows stale). Requires sweeps
    <= max_up_sweeps(kind). x and b of float32, float64 or bfloat16; e in
    the compute dtype (float32 for bfloat16 x); x' in x's dtype or, with
    ``out_dtype=torch.float32`` for bfloat16 x (the top level of a mixed
    cycle), in float32.
    """
    global up_launches, up_bf16_launches, up_bf16_f32_launches
    _check_kind(kind, sweeps, max_up_sweeps(kind))
    _check_tile("local2d.up_leg", x_ext, b_ext)
    out_dtype = check_out_dtype("local2d.up_leg", x_ext, out_dtype)
    if n != 2 * nc + 1:
        raise ValueError(f"fine n={n} is not 2*nc+1 for nc={nc}")
    cshape = _check_leg(n, m, mcol, x_ext.shape)
    check_tensor("e", e_ext, cshape, x_ext, compute_dtype(x_ext.dtype))
    if not on_cuda(x_ext):
        return up_leg_plain(x_ext, e_ext, b_ext, n, nc, h, m, row_off,
                            col_off, kind=kind, omega=omega, sweeps=sweeps,
                            sigma=sigma, mcol=mcol, out_dtype=out_dtype)
    out = torch.empty_like(x_ext, dtype=out_dtype)
    ccol = coarse_offset(col_off) if mcol else 0
    launch_on(x_ext, "local2d_up", x_ext.data_ptr(), e_ext.data_ptr(),
              b_ext.data_ptr(), out.data_ptr(), x_ext.shape[0],
              x_ext.shape[1], cshape[0], cshape[1], n, int(row_off),
              int(col_off), coarse_offset(row_off), ccol, float(h),
              float(sigma), _build.KIND_CODES[kind], float(omega), sweeps,
              _launch_geometry("up", x_ext, n, row_off, col_off, kind,
                               sweeps), out_dtype=out_dtype,
              writes=(out,))
    if x_ext.dtype != torch.bfloat16:
        up_launches += 1
    elif out_dtype == torch.bfloat16:
        up_bf16_launches += 1
    else:
        up_bf16_f32_launches += 1
    return out
