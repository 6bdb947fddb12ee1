"""The row-streaming plocal2d legs (csrc/packed2d_legs.cuh's down_kernel and
up_kernel on the tile frame, csrc/plocal2d_legs*.cu) emulated on the CPU.

The CUDA kernels run only on the card. Here tests/test_torch_packed.py's
step-by-step emulation of their schedule (tagged window slots, NaN at the
shuffle edges, rows read only after they are loaded, each output entry
written exactly once) runs on the tile frame (``LegFrame``: global rows
from the tile's odd row offset, the frame's lanes shifted by one column on
a block tile, the coarse tile with its owned box) and is held against
``plocal2d.down_leg_plain`` / ``up_leg_plain`` in float64, at sigma 0 and
3.7, for both smoothers at every sweep count up to the caps. Tiles: rank 0
and an inner rank of a row split of 63^2 (odd row offsets, cpar 0) and a
rank of a 2x2 block split of 127^2 (odd column offset, cpar 1, two strips),
each with segments of 10 rows (several, the last partial) and with the
launch's own segments. One row case and one block case are held against
JAX's plocal2d legs in interpret mode too, on test_torch_plocal2d.py's
255^2 tiles. Tolerance: rtol 1e-12 and atol 1e-12 * max|plain| (the
emulation and the plain versions sum in other orders); against JAX, that
file's 1e-13 * 4^8 on the owned points. The legs' bfloat16 storage modes
(the fine tile of a sharded mixed cycle: the emulation's rings of loaded
rows and of u' as stored) are held against the plain versions on the
same bfloat16 tiles by tests/test_torch_mixed.py's bfloat16 rule, a
float32 x' and the coarse output (against the plain restriction of the
emulated u') to 1e-5 of their largest value.
"""
import functools

import numpy as np
import pytest
import torch

from multigridcmt_tpu_torch.kernels import local2d, packed2d, plocal2d
from test_torch_packed import LegFrame, _bf16_rule, _emulate_leg, _f32_close
from test_torch_plocal2d import CASES, OMEGA, Tile, _case, _results, \
    check_owned

HH = plocal2d.HALO_ROWS
SIGMAS = (0.0, 3.7)

# name -> (n, rows ranks, row rank, col ranks, col rank); col ranks 0: a
# row decomposition.
TILES = {
    "rows-rank0": (63, 2, 0, 0, 0),
    "rows-inner": (63, 4, 1, 0, 0),
    "block-01": (127, 2, 0, 2, 1),
}


def tile_frame(t: Tile) -> LegFrame:
    """The kernels' frame of tile t, from the arguments plocal2d.down_leg
    passes (the coarse tile at coarse_offset, its owned box)."""
    rc, cc = t.coarse_shape()
    crow = local2d.coarse_offset(t.row_off)
    ccol = local2d.coarse_offset(t.col_off) if t.mcol else 0
    slo, shi = (HH, HH + t.mcol // 2) if t.mcol else (0, cc)
    return LegFrame(
        t.n, t.row_off, t.col_off, t.cols,
        (t.row_off + 1, t.row_off + t.rows - 2, t.col_off + 1,
         t.col_off + t.cols - 2),
        (rc, cc, crow, ccol),
        (crow + HH, crow + HH + t.m // 2 - 1, ccol + slo, ccol + shi - 1))


def geometry(leg, t, kind, sweeps, seg=None):
    """The wrapper's geometry of tile t; with ``seg``, segments of seg rows,
    got by lowering the launch's least segment to seg (at 132 SMs the rule
    would give these small tiles one segment each)."""
    with pytest.MonkeyPatch.context() as mp:
        if seg is not None:
            mp.setattr(packed2d, "LEG_MIN_SEG", seg)
        g = plocal2d.leg_geometry(leg, t.rows, t.cols, t.n, t.row_off,
                                  t.col_off, kind, sweeps)
    assert seg is None or g.seg == seg
    return g


@functools.cache
def _tile(name):
    t = Tile(*TILES[name], seed=11)
    su, sb = (plocal2d.pack_ext(torch.from_numpy(a), t.cpar)
              for a in (t.ue, t.be))
    e = np.random.default_rng(t.n + t.row_off).standard_normal(
        t.coarse_shape())
    return t, su, sb, e


def _close(got, want):
    want = want.numpy() if isinstance(want, torch.Tensor) else want
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


def _cases(cap_of):
    return [(kind, nu) for kind in ("rbgs", "jacobi")
            for nu in range(cap_of(kind) + 1)]


@pytest.mark.parametrize("seg", [10, None])
@pytest.mark.parametrize("kind,sweeps", _cases(local2d.max_down_sweeps))
@pytest.mark.parametrize("name", list(TILES))
def test_tile_down_schedule_matches_plain(name, kind, sweeps, seg):
    t, su, sb, _ = _tile(name)
    sigma = SIGMAS[sweeps & 1]
    g = geometry("down", t, kind, sweeps, seg)
    assert (g.segs > 1 or seg is None) and g.span() <= packed2d.LEG_WINDOW
    got_u, got_rc = _emulate_leg(g, kind, sweeps, su.numpy(), sb.numpy(),
                                 t.h, sigma, OMEGA, frame=tile_frame(t))
    want_u, want_rc = plocal2d.down_leg_plain(
        su, sb, t.n, t.h, t.m, t.row_off, t.col_off, kind=kind, omega=OMEGA,
        sweeps=sweeps, sigma=sigma, mcol=t.mcol)
    _close(got_u, want_u)
    _close(got_rc, want_rc)


@pytest.mark.parametrize("seg", [10, None])
@pytest.mark.parametrize("kind,sweeps", _cases(local2d.max_up_sweeps))
@pytest.mark.parametrize("name", list(TILES))
def test_tile_up_schedule_matches_plain(name, kind, sweeps, seg):
    t, su, sb, e = _tile(name)
    sigma = SIGMAS[(sweeps + 1) & 1]
    g = geometry("up", t, kind, sweeps, seg)
    assert (g.segs > 1 or seg is None) and g.span() <= packed2d.LEG_WINDOW
    got = _emulate_leg(g, kind, sweeps, su.numpy(), sb.numpy(), t.h, sigma,
                       OMEGA, e=e, frame=tile_frame(t))
    want = plocal2d.up_leg_plain(
        su, torch.from_numpy(e), sb, t.n, (t.n - 1) // 2, t.h, t.m,
        t.row_off, t.col_off, kind=kind, omega=OMEGA, sweeps=sweeps,
        sigma=sigma, mcol=t.mcol)
    _close(got, want)


# (tile, kind, nu, seg) of the bfloat16 cases: zero stages on rank 0's
# tile (a zero row above it) in several segments, RB-GS nu = 2 (the mixed
# paths') on the inner and block tiles, Jacobi odd and even.
_BF16 = [("rows-rank0", "rbgs", 0, 10), ("rows-inner", "rbgs", 2, None),
         ("block-01", "rbgs", 2, 10), ("block-01", "jacobi", 3, None),
         ("rows-rank0", "jacobi", 2, 10)]
BF = torch.bfloat16


@functools.cache
def _bf16_tile(name):
    """_tile's u and b rounded to bfloat16 and packed, e in float32."""
    t, _, _, e = _tile(name)
    su, sb = (plocal2d.pack_ext(torch.from_numpy(a).to(BF), t.cpar)
              for a in (t.ue, t.be))
    return t, su, sb, e.astype(np.float32)


@pytest.mark.parametrize("name,kind,sweeps,seg", _BF16)
def test_tile_bf16_down_schedule_matches_plain(name, kind, sweeps, seg):
    t, su, sb, _ = _bf16_tile(name)
    sigma = SIGMAS[sweeps & 1]
    g = geometry("down", t, kind, sweeps, seg)
    assert g.segs > 1 or seg is None
    got_u, got_rc = _emulate_leg(g, kind, sweeps, su.float().numpy(),
                                 sb.float().numpy(), t.h, sigma, OMEGA,
                                 frame=tile_frame(t), bf16=True)
    want_u, _ = plocal2d.down_leg_plain(
        su, sb, t.n, t.h, t.m, t.row_off, t.col_off, kind=kind, omega=OMEGA,
        sweeps=sweeps, sigma=sigma, mcol=t.mcol)
    _bf16_rule(got_u, want_u)
    _f32_close(got_rc, plocal2d.residual_restrict_plain(
        torch.from_numpy(got_u).to(BF), sb, t.n, t.h, t.m, t.row_off,
        t.col_off, sigma=sigma, mcol=t.mcol,
        red_only=kind == "rbgs" and sweeps >= 1))


@pytest.mark.parametrize("f32_out", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("name,kind,sweeps,seg", _BF16)
def test_tile_bf16_up_schedule_matches_plain(name, kind, sweeps, seg,
                                             f32_out):
    t, su, sb, e = _bf16_tile(name)
    sigma = SIGMAS[(sweeps + 1) & 1]
    g = geometry("up", t, kind, sweeps, seg)
    got = _emulate_leg(g, kind, sweeps, su.float().numpy(),
                       sb.float().numpy(), t.h, sigma, OMEGA, e=e,
                       frame=tile_frame(t), bf16=True, f32_out=f32_out)
    want = plocal2d.up_leg_plain(
        su, torch.from_numpy(e), sb, t.n, (t.n - 1) // 2, t.h, t.m,
        t.row_off, t.col_off, kind=kind, omega=OMEGA, sweeps=sweeps,
        sigma=sigma, mcol=t.mcol,
        out_dtype=torch.float32 if f32_out else None)
    if f32_out:
        assert want.dtype == torch.float32
        _f32_close(got, want)
    else:
        _bf16_rule(got, want)


def test_tiles_exercise_the_frame():
    """The tiles above cover what the tile frame adds: odd row offsets
    (rank 0's tile starting above the grid, whose first segment streams a
    zero row), an odd column offset with a frame lane more than the
    array's, two strips (the last partial) everywhere, and steady chunks (on the two
    deeper tiles; the inner rank's 32 rows hold none)."""
    seen = set()
    for name in TILES:
        t = _tile(name)[0]
        assert t.row_off % 2 == 1
        for seg in (10, None):
            g = geometry("down", t, "rbgs", 2, seg)
            y0, y1, ys, ye = g.rows(0)
            assert (y0, ys) == (t.row_off, t.row_off - 1)
            assert g.strips * g.strip > g.lanes
            seen.add(("strips", g.strips > 1))
        seen.add(("block", t.col_off % 2 == 1))
        seen.add(("rank0", t.row_off < 0))
        _emulate_leg(geometry("down", t, "rbgs", 2), "rbgs", 2,
                     *(a.numpy() for a in _tile(name)[1:3]), t.h, 0.0,
                     OMEGA, frame=tile_frame(t))
        seen.add(("steady", _emulate_leg.steady_steps > 0))
    assert seen == {("strips", True)} | {
        (k, v) for k in ("block", "rank0", "steady") for v in (True, False)}


def _writers(g, t, leg):
    """Writers of each entry of the packed u' (2, R, lanes) and of the
    coarse tile, counted from the geometry as the kernels' Unit assigns
    them (no values)."""
    f = tile_frame(t)
    cpa = (t.cols + 1) // 2
    fine = np.zeros((2, t.rows, cpa), dtype=int)
    rc, cc, crow, ccol = f.ca
    coarse = np.zeros((rc, cc), dtype=int)
    x = np.arange(packed2d.LEG_LANES)
    ylo, yhi, xlo, xhi = f.keep
    for sx in range(g.strips):
        _, J, at, ok, core, _ = f.unit(g, sx, x)
        for sy in range(g.segs):
            y0, y1, _, _ = g.rows(sy)
            for par in (0, 1):
                first = y0 + ((y0 & 1) != par)
                rows = np.arange(first, y1, 2) - t.row_off
                for c in (0, 1):
                    p = (c + par) & 1
                    lanes = at[p][core & ok[p]]
                    fine[c, rows[:, None], lanes[None, :]] += 1
            if leg == "down":
                I = np.arange(y0 + (y0 & 1), y1, 2) >> 1
                I = I[(I >= ylo) & (I <= yhi)]
                Jo = J[core & (J >= xlo) & (J <= xhi)]
                coarse[(I - crow)[:, None], (Jo - ccol)[None, :]] += 1
    if leg == "down":
        for q, s in f.coarse_frame():
            coarse[q, s] += 1
    return fine, coarse


# S1's own tile (config 5's 4095^2 on a row mesh of 1), the emulated tiles
# and a 2x2 block rank of 2047^2 (phase 2 of chip_smoke.py).
_OWNERSHIP = [(4095, 1, 0, 0, 0), (63, 4, 1, 0, 0), (127, 2, 0, 2, 1),
              (2047, 2, 1, 2, 1)]


@pytest.mark.parametrize("leg,cap_of", [("down", local2d.max_down_sweeps),
                                        ("up", local2d.max_up_sweeps)])
@pytest.mark.parametrize("tile", _OWNERSHIP)
def test_tile_geometry_writes_each_entry_once(tile, leg, cap_of):
    """Every entry of the packed u' (ghost and ring rows, pad lanes) has
    exactly one writer, and (down leg) every entry of the coarse tile, its
    ghost bands and zero columns included: the restriction writes the
    owned box, zero_coarse_frame the rest; at the launch's geometry for
    each smoother at its cap, and at 4095^2 for RB-GS nu = 2 too."""
    t = Tile(*tile) if tile[0] < 1000 else _BigTile(*tile)
    schedules = [(kind, cap_of(kind)) for kind in ("rbgs", "jacobi")]
    if tile[0] == 4095:
        schedules.append(("rbgs", 2))
    for kind, nu in schedules:
        g = geometry(leg, t, kind, nu)
        assert g.strips * g.strip >= g.lanes
        assert g.segs * g.seg >= t.rows + (t.row_off & 1)
        fine, coarse = _writers(g, t, leg)
        assert (fine == 1).all(), (kind, nu)
        if leg == "down":
            assert (coarse == 1).all(), (kind, nu)


class _BigTile:
    """A tile's shape and offsets only (no data), as Tile has them."""

    def __init__(self, n, dr, r, dc, c):
        self.n = n
        self.m = (n + 1) // dr
        self.mcol = (n + 1) // dc if dc else 0
        self.row_off = r * self.m + 1 - HH
        self.col_off = c * self.mcol + 1 - HH if dc else 0
        self.cols = self.mcol + 2 * HH if dc else n + 2
        self.rows = self.m + 2 * HH

    coarse_shape = Tile.coarse_shape


def test_s1_tile_geometry():
    """S1's tile (2 x 4112 x 2049, row_off -7), RB-GS nu = 2: the down leg
    runs 26-lane strips by segments of 160 rows, 79 x 26 units, which fills
    132 SMs at about LEG_WARPS_PER_SM warps each."""
    t = _BigTile(4095, 1, 0, 0, 0)
    g = geometry("down", t, "rbgs", 2)
    assert (g.strip, g.strips, g.seg, g.segs) == (26, 79, 160, 26)
    assert g.strips * g.segs >= 132 * packed2d.LEG_WARPS_PER_SM * 0.95


@pytest.mark.parametrize("leg,cap_of", [("down", local2d.max_down_sweeps),
                                        ("up", local2d.max_up_sweeps)])
@pytest.mark.parametrize("kind", ["rbgs", "jacobi"])
def test_tile_geometry_fits_its_window(leg, cap_of, kind):
    """At every sweep count up to the tile caps the rows a lane holds at
    once fit the register window, the streamed rows start even, and the
    stages stay behind the up leg's store and ahead of the down leg's
    residual, on S1's tile and a block tile."""
    for tile in ((4095, 1, 0, 0, 0), (2047, 2, 1, 2, 1)):
        t = _BigTile(*tile)
        for sweeps in range(cap_of(kind) + 1):
            g = geometry(leg, t, kind, sweeps)
            assert g.span() <= packed2d.LEG_WINDOW
            assert g.stages < g.out_lag + (leg == "up")
            assert all(g.rows(sy)[2] % 2 == 0 for sy in range(g.segs))


@pytest.mark.parametrize("name,func", [("rows-rank0", "down_leg"),
                                       ("rows-rank0", "up_leg"),
                                       ("block-11", "down_leg"),
                                       ("block-11", "up_leg")])
def test_tile_schedule_matches_jax(name, func):
    """The emulated kernels against JAX's plocal2d legs in interpret mode
    on test_torch_plocal2d.py's 255^2 tiles (several JAX windows a tile):
    owned points of u', and the whole coarse tile."""
    t, (su, sb), _, e = _case(name)
    *_, kind, nu, sigma = CASES[name]
    frame = tile_frame(t)
    want = _results(name, func)[1]
    if func == "down_leg":
        g = geometry("down", t, kind, nu)
        gu, grc = _emulate_leg(g, kind, nu, su.numpy(), sb.numpy(), t.h,
                               sigma, OMEGA, frame=frame)
        check_owned(torch.from_numpy(gu), want[0], t)
        wrc = np.asarray(want[1])[:grc.shape[0], :grc.shape[1]]
        assert np.abs(grc - wrc).max() <= 1e-13 * 4.0 ** 8
        return
    g = geometry("up", t, kind, nu)
    got = _emulate_leg(g, kind, nu, su.numpy(), sb.numpy(), t.h, sigma,
                       OMEGA, e=e, frame=frame)
    check_owned(torch.from_numpy(got), want, t)
