"""The row-streaming local2d sweeps (csrc/packed2d_legs.cuh's sweep_kernel,
the up leg's stream without its coarse operand, on the unpacked tile frame
UTile; csrc/local2d_sweep*.cu) emulated on the CPU.

The CUDA kernels run only on the card. Here tests/test_torch_packed.py's
step-by-step emulation of their schedule (tagged window slots, NaN at the
shuffle edges, rows read only after they are loaded, each neighbour row
swept exactly as often as a sequential sweep would have it, each output
entry written exactly once, every address inside its row and the array,
every paired access on a pair) runs on the sweep geometry
(``local2d.leg_geometry("sweep", ...)``) of the unpacked tile frame and is
held against ``local2d.rbgs_sweep_plain`` / ``jacobi_sweep_plain`` in
float64, for both smoothers at every sweep count up to the caps (RB-GS 4,
Jacobi 8: 8 stages), sigma 0 and 3.7 by turns. Tiles: the three of
tests/test_torch_local2d_stream.py (rank 0 of a row split of 63^2, its
first segment streaming a zero row above the tile; an inner rank of a
4-way row split; a rank of a 2x2 block split of 127^2, odd column offset),
and two the sharded solver never cuts but the wrappers take, as JAX's
traced offsets do: an even row offset (-6, rows above the grid, no zero
row streamed, no paired access) and an even nonzero column offset (80,
the tile running past the grid's last column, paired accesses on the odd
rows). Each with segments of 10 rows (several, the last partial), of 64
(one or two, with chunks of steps with no row tests) and the launch's own
(``local2d.MIN_SEG``). h is a power of two and the frame sums each stencil
and rounds the Jacobi step as the plain versions do, so at sigma 0 the
emulated sweeps equal the plain ones bit for bit, ghosts and ring
included; at 3.7 within rtol 1e-12 and atol 1e-12 * max|plain|. The launch
geometry is checked to write each entry once at config 5's S3, S4 and S1
tiles and to fit the register window at 8 stages, the C entry points
against their ctypes declarations, and two cases against JAX's local2d
sweeps in interpret mode on test_torch_local2d.py's tiles.
"""
import ctypes
import dataclasses
import functools
import re

import numpy as np
import pytest
import torch

from multigridcmt_tpu.kernels import local2d as jlocal2d
from multigridcmt_tpu_torch.kernels import _build, local2d, packed2d
from test_torch_local2d import TILES as JAX_TILES
from test_torch_local2d import Tile as JaxTile
from test_torch_local2d import check as check_owned
from test_torch_local2d_stream import SEGS, SIGMAS, TILES, _check, _tile, \
    _writers, utile_frame
from test_torch_packed import LegFrame, _emulate_leg
from test_torch_plocal2d_stream import _BigTile

OMEGA = 0.8


@dataclasses.dataclass(frozen=True)
class OffsetTile:
    """A rows x cols tile of the padded n^2 grid at any global offsets
    (zeros off the grid), with its data from a numpy seed."""
    n: int
    rows: int
    cols: int
    row_off: int
    col_off: int

    @property
    def h(self):
        return 1.0 / (self.n + 1)

    @functools.cached_property
    def data(self):
        rng = np.random.default_rng(self.n + self.rows + self.cols)
        u, b = (np.zeros((self.n + 2, self.n + 2)) for _ in range(2))
        u[1:-1, 1:-1] = rng.standard_normal((self.n, self.n))
        b[1:-1, 1:-1] = rng.standard_normal((self.n, self.n)) \
            * (self.n + 1) ** 2
        r = np.arange(self.rows) + self.row_off
        c = np.arange(self.cols) + self.col_off
        ok_r = (r >= 0) & (r <= self.n + 1)
        ok_c = (c >= 0) & (c <= self.n + 1)
        out = []
        for g in (u, b):
            t = np.zeros((self.rows, self.cols))
            t[np.ix_(ok_r, ok_c)] = g[np.ix_(r[ok_r], c[ok_c])]
            out.append(t)
        return out

    def frame(self):
        """What local2d_sweep.cu's utile_frame gives the kernel: the tile's
        rows, columns and upd box (off its ring), an empty coarse tile."""
        return LegFrame(self.n, self.row_off, self.col_off, self.cols,
                        (self.row_off + 1, self.row_off + self.rows - 2,
                         self.col_off + 1, self.col_off + self.cols - 2),
                        (0, 0, 0, 0), unpacked=True)


# name -> OffsetTile: an even row offset on a row tile of 63^2, and an odd
# row offset with an even nonzero column offset on 127^2.
EVEN_TILES = {
    "rows-even": OffsetTile(63, 40, 65, -6, 0),
    "cols-even": OffsetTile(127, 50, 60, 33, 80),
}


def _case(name):
    """(n, rows, cols, row_off, col_off, h, u, b, frame) of a tile."""
    if name in EVEN_TILES:
        t = EVEN_TILES[name]
        return (t.n, t.rows, t.cols, t.row_off, t.col_off, t.h, *t.data,
                t.frame())
    t, _ = _tile(name)
    return (t.n, t.rows, t.cols, t.row_off, t.col_off, t.h, t.ue, t.be,
            utile_frame(t))


def geometry(name, kind, nu, seg=None):
    """The wrapper's sweep geometry of the tile; with ``seg``, segments of
    seg rows, got by setting the launch's least segment to seg (at 132 SMs
    the rule gives these small tiles the least segment)."""
    n, rows, cols, row_off, col_off, *_ = _case(name)
    with pytest.MonkeyPatch.context() as mp:
        if seg is not None:
            mp.setattr(local2d, "MIN_SEG", seg)
        g = local2d.leg_geometry("sweep", rows, cols, n, row_off, col_off,
                                 kind, nu)
    assert g.seg == (local2d.MIN_SEG if seg is None else seg)
    assert g.span() <= packed2d.LEG_WINDOW
    return g


def emulate(name, kind, nu, sigma, seg):
    """(geometry, the emulated sweep stream, the plain sweeps)."""
    n, _, _, row_off, col_off, h, ue, be, f = _case(name)
    g = geometry(name, kind, nu, seg)
    got = _emulate_leg(g, kind, nu, ue, be, h, sigma, OMEGA, frame=f)
    tu, tb = torch.from_numpy(ue), torch.from_numpy(be)
    if kind == "rbgs":
        want = local2d.rbgs_sweep_plain(tu, tb, n, h, row_off, col_off,
                                        sigma=sigma, sweeps=nu)
    else:
        want = local2d.jacobi_sweep_plain(tu, tb, n, h, OMEGA, row_off,
                                          col_off, sigma=sigma, sweeps=nu)
    return g, got, want


CASES = [(kind, nu) for kind in ("rbgs", "jacobi")
         for nu in range(1, local2d.max_fused_sweeps(kind) + 1)]


@pytest.mark.parametrize("seg", SEGS)
@pytest.mark.parametrize("kind,nu", CASES)
@pytest.mark.parametrize("name", list(TILES) + list(EVEN_TILES))
def test_utile_sweep_schedule_matches_plain(name, kind, nu, seg):
    """Bit for bit at sigma 0 (every whole tile, ghosts and ring
    included), rtol 1e-12 at 3.7; each (tile, kind, nu) takes both sigmas
    across its segment sizes."""
    sigma = SIGMAS[(nu + SEGS.index(seg)) & 1]
    g, got, want = emulate(name, kind, nu, sigma, seg)
    assert g.segs > 1 or seg == 64
    _check(got, want, sigma)


def test_tiles_exercise_the_sweep_frame():
    """The tiles above cover what the sweeps take beyond the legs: an even
    row offset (the first segment starts on the tile's first row, no zero
    row), an even nonzero column offset (paired accesses on the odd rows
    of an even pitch), besides odd row offsets (a zero row above the
    tile), the block tile's odd column offset (no pairs), two strips (the
    last partial), several segments (the last partial) and chunks of
    steps with no row tests."""
    seen = set()
    for name in list(TILES) + list(EVEN_TILES):
        n, rows, cols, row_off, col_off, *_, f = _case(name)
        seen.add(("row parity", row_off & 1))
        seen.add(("col offset", "odd" if col_off & 1 else
                  "even" if col_off else "0"))
        seen.add(("pairs", f.paired(1)))
        assert not f.paired(0)
        for seg in SEGS:
            g, *_ = emulate(name, "rbgs", 4, 0.0, seg)
            y0, _, ys, _ = g.rows(0)
            assert (y0, ys) == (row_off, row_off - (row_off & 1))
            seen.add(("strips", g.strips > 1))
            seen.add(("partial strip", g.strips * g.strip > g.lanes))
            seen.add(("partial segment",
                      g.segs * g.seg > rows + (row_off & 1)))
            seen.add(("steady", _emulate_leg.steady_steps > 0))
    assert seen >= {("strips", True), ("partial strip", True),
                    ("partial segment", True), ("steady", True),
                    ("steady", False), ("row parity", 0),
                    ("row parity", 1), ("pairs", True), ("pairs", False)}
    assert {("col offset", v) for v in ("odd", "even", "0")} <= seen
    assert EVEN_TILES["cols-even"].frame().paired(1)


# Config 5's tiles on a mesh of 1 (rank 0 of a row split): S3's RB-GS
# nu = 4 at 2047...255, S4's Jacobi nu = 8 at 1023...255, and both at S1's
# 4095 tile.
_PATH_TILES = ([(n, "rbgs", 4) for n in (2047, 1023, 511, 255)]
               + [(n, "jacobi", 8) for n in (1023, 511, 255)]
               + [(4095, "rbgs", 4), (4095, "jacobi", 8)])


@pytest.mark.parametrize("n,kind,nu", _PATH_TILES)
def test_sweep_geometry_writes_each_entry_once(n, kind, nu):
    """Every entry of u' (ghost and ring rows and columns) has exactly one
    writer at the launch's geometry, which the launcher's covers rule
    accepts."""
    t = _BigTile(n, 1, 0, 0, 0)
    g = local2d.leg_geometry("sweep", t.rows, t.cols, n, t.row_off,
                             t.col_off, kind, nu)
    assert g.strips * g.strip >= g.lanes
    assert g.segs * g.seg >= t.rows + (t.row_off & 1)
    fine, _ = _writers(g, t, "sweep")
    assert (fine == 1).all()


def test_sweep_geometry_fits_its_window():
    """At every sweep count up to the caps (8 stages: the kernels are
    instantiated up to kMaxUpStages, not the tile legs' kMaxTileStages)
    the rows a lane holds fit the register window, the halos pass the
    launcher's rules, the streamed rows start even, and the geometry is the
    up leg's on the same frame; on S1's tile, S2's block tile and the even
    offset tiles."""
    src = (_build.CSRC / "packed2d_legs.cuh").read_text()
    const = {name: int(v) for name, v in
             re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert 2 * local2d.max_fused_sweeps("rbgs") == const["kMaxUpStages"]
    assert local2d.max_fused_sweeps("jacobi") == const["kMaxUpStages"]
    assert const["kMaxTileStages"] < const["kMaxUpStages"]
    tiles = [_BigTile(4095, 1, 0, 0, 0), _BigTile(2047, 1, 0, 1, 0),
             *EVEN_TILES.values()]
    shapes = [(t.rows, t.cols, t.n, t.row_off, t.col_off) for t in tiles]
    for rows, cols, n, row_off, col_off in shapes:
        for kind, nu in CASES:
            g = local2d.leg_geometry("sweep", rows, cols, n, row_off,
                                     col_off, kind, nu)
            K = 2 * nu if kind == "rbgs" else nu
            assert g.stages == g.out_lag == K <= const["kMaxUpStages"]
            assert g.span() <= packed2d.LEG_WINDOW
            assert min(g.top, g.bottom, 2 * g.halo_lanes) >= K
            assert g.strip + 2 * g.halo_lanes == const["kWarp"]
            assert g.seg >= local2d.MIN_SEG and g.seg % 2 == 0
            assert all(g.rows(sy)[2] % 2 == 0 for sy in range(g.segs))
            up = local2d.leg_geometry("up", rows, cols, n, row_off, col_off,
                                      kind, nu)
            assert g.ints() == up.ints()


def test_c_entry_points_take_the_geometry():
    """The sweeps' C entry points live in local2d_sweep.cu and
    local2d_sweep_f64.cu and take the geometry before the stream, the
    residual's in local2d.cu, each with as many parameters as ctypes
    passes; the shared-memory sweep kernel and its helpers are gone."""
    src = {p.name: p.read_text() for p in _build.CSRC.glob("*.cu*")}
    for t in ("f32", "f64"):
        for name, path, geom in (
                (f"mg_local2d_sweep_{t}",
                 "local2d_sweep.cu" if t == "f32" else "local2d_sweep_f64.cu",
                 True),
                (f"mg_local2d_residual_{t}", "local2d.cu", False)):
            m = re.search(rf"\bint {name}\(([^)]*)\)\s*\{{", src[path])
            params = [p.strip() for p in m.group(1).split(",")]
            argtypes = _build.SIGNATURES[name]
            assert len(params) == len(argtypes)
            assert argtypes[-1] is ctypes.c_void_p
            assert (params[-2] == "const int* geom") == geom
            assert (argtypes[-2] is _build._IP) == geom
    for path in ("local2d_sweep.cu", "local2d_sweep_f64.cu"):
        assert "launch_sweep<" in src[path] and "utile_frame(" in src[path]
    assert "local_sweep_kernel" not in src["local2d.cu"]
    for helper in ("smooth_tile", "rbgs_half_sweep", "jacobi_sweep",
                   "store_core", "sweep_halo"):
        assert not re.search(rf"\b{helper}\b", src["common.cuh"]), helper


@pytest.mark.parametrize("name,kind,nu,sigma", [
    ("rows2-m128", "rbgs", 4, 3.7),
    ("block4x2-31", "jacobi", 8, 0.0),
])
def test_utile_sweep_matches_jax(name, kind, nu, sigma):
    """The emulated sweeps against JAX's local2d sweeps in interpret mode on
    test_torch_local2d.py's tiles (255^2 with m = 128 owned rows; a block
    tile of 127^2 holding the grid's far ghost), owned points (that file's
    1e-12 of the largest reference value)."""
    jt = JaxTile(name, seed=7)
    t = _BigTile(*JAX_TILES[name])
    ue, be = jt.ext(jt.u), jt.ext(jt.b)
    uj, bj = jt.jaxes(ue, be)
    g = local2d.leg_geometry("sweep", *ue.shape, jt.n, jt.row_off,
                             jt.col_off, kind, nu)
    got = _emulate_leg(g, kind, nu, ue, be, jt.h, sigma, OMEGA,
                       frame=utile_frame(t))
    if kind == "rbgs":
        want = jlocal2d.rbgs_sweep(uj, bj, jt.n, jt.h, jt.row_off,
                                   jt.col_off, sigma=sigma, sweeps=nu)
    else:
        want = jlocal2d.jacobi_sweep(uj, bj, jt.n, jt.h, OMEGA, jt.row_off,
                                     jt.col_off, sigma=sigma, sweeps=nu)
    check_owned(got, want, jt)
