"""The row-streaming local2d legs (csrc/packed2d_legs.cuh's down_kernel and
up_kernel on the unpacked tile frame, UTile; csrc/local2d_legs*.cu)
emulated on the CPU.

The CUDA kernels run only on the card. Here tests/test_torch_packed.py's
step-by-step emulation of their schedule (tagged window slots, NaN at the
shuffle edges, rows read only after they are loaded, each output entry
written exactly once, every address inside its row and the array, every
paired access on a pair) runs on the unpacked tile frame (``LegFrame``
with ``unpacked`` and a coarse tile: global rows from the tile's odd row
offset, lanes of two adjacent columns from the even column at or left of
the tile's column offset, the tile's own row pitch, the coarse tile with
its owned box) and is held against ``local2d.down_leg_plain`` /
``up_leg_plain`` in float64, for both smoothers at every sweep count up to
the caps, sigma 0 and 3.7 by turns. Tiles: rank 0 of a row split of 63^2
(row offset -7, its first segment streaming a zero row above the tile),
an inner rank of a 4-way row split of 63^2, and a rank of a 2x2 block
split of 127^2 (odd column offset: lane 0's phase-0 point lies off the
tile; two strips), each with segments of 10 rows (several, the last
partial), with 64-row ones (chunks of steps with no row tests) and with the
launch's own (``local2d.MIN_SEG``). h is a power of two, and the frame sums
each stencil in the plain versions' order, so at sigma 0 the emulated legs
equal the plain ones bit for bit; at 3.7 within rtol 1e-12 and atol 1e-12 *
max|plain| (1/(4 - sigma h^2) is taken as the plain versions take it, but
the tolerance does not rely on that). The launch geometry is checked to
write each output entry once at config 5's tiles, and two cases are held
against JAX's local2d legs in interpret mode on test_torch_local2d.py's
tiles. The legs' bfloat16 storage modes (the emulation's rings of loaded
rows, a row tile's paired odd rows as one 32-bit word, and of u' as
stored) are held against the plain versions on the same bfloat16 tiles by
tests/test_torch_mixed.py's bfloat16 rule, a float32 x' and the coarse
output (against the plain restriction of the emulated u') to 1e-5 of
their largest value.
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
from test_torch_local2d import embed
from test_torch_packed import LegFrame, _bf16_rule, _emulate_leg, _f32_close
from test_torch_plocal2d import Tile
from test_torch_plocal2d_stream import _BigTile
from test_torch_plocal2d_stream import tile_frame as packed_tile_frame

HH = local2d.HALO_ROWS
OMEGA = 0.8
SIGMAS = (0.0, 3.7)

# name -> (n, rows ranks, row rank, col ranks, col rank); col ranks 0: a
# row decomposition.
TILES = {
    "rows-rank0": (63, 2, 0, 0, 0),
    "rows-inner": (63, 4, 1, 0, 0),
    "block-01": (127, 2, 0, 2, 1),
}
# Segment rows: 10 (several), 64 (one or two, with steady chunks) and the
# launch's own (None: local2d.MIN_SEG rows at these sizes).
SEGS = (10, 64, None)


def utile_frame(t) -> LegFrame:
    """The kernels' frame of tile t, from the arguments local2d.down_leg
    passes: the packed tile frame's rows, box and coarse tile, with the
    tile's points unpacked."""
    return dataclasses.replace(packed_tile_frame(t), unpacked=True)


def geometry(leg, t, kind, sweeps, seg=None):
    """The wrapper's geometry of tile t; with ``seg``, segments of seg rows,
    got by setting the launch's least segment to seg (at 132 SMs the rule
    gives these small tiles the least segment)."""
    with pytest.MonkeyPatch.context() as mp:
        if seg is not None:
            mp.setattr(local2d, "MIN_SEG", seg)
        g = local2d.leg_geometry(leg, t.rows, t.cols, t.n, t.row_off,
                                 t.col_off, kind, sweeps)
    assert g.seg == (local2d.MIN_SEG if seg is None else seg)
    assert g.span() <= packed2d.LEG_WINDOW
    return g


@functools.cache
def _tile(name):
    t = Tile(*TILES[name], seed=5)
    e = np.random.default_rng(t.n + t.row_off).standard_normal(
        t.coarse_shape())
    return t, e


def _check(got, want, sigma):
    want = want.numpy()
    assert got.shape == want.shape
    if sigma == 0.0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())


def _cases(cap_of):
    return [(kind, nu) for kind in ("rbgs", "jacobi")
            for nu in range(cap_of(kind) + 1)]


def emulate_down(name, kind, nu, sigma, seg):
    t, _ = _tile(name)
    g = geometry("down", t, kind, nu, seg)
    got = _emulate_leg(g, kind, nu, t.ue, t.be, t.h, sigma, OMEGA,
                       frame=utile_frame(t))
    want = local2d.down_leg_plain(
        torch.from_numpy(t.ue), torch.from_numpy(t.be), t.n, t.h, t.m,
        t.row_off, t.col_off, kind=kind, omega=OMEGA, sweeps=nu,
        sigma=sigma, mcol=t.mcol)
    return g, got, want


def emulate_up(name, kind, nu, sigma, seg):
    t, e = _tile(name)
    g = geometry("up", t, kind, nu, seg)
    got = _emulate_leg(g, kind, nu, t.ue, t.be, t.h, sigma, OMEGA, e=e,
                       frame=utile_frame(t))
    want = local2d.up_leg_plain(
        torch.from_numpy(t.ue), torch.from_numpy(e), torch.from_numpy(t.be),
        t.n, (t.n - 1) // 2, t.h, t.m, t.row_off, t.col_off, kind=kind,
        omega=OMEGA, sweeps=nu, sigma=sigma, mcol=t.mcol)
    return g, got, want


@pytest.mark.parametrize("seg", SEGS)
@pytest.mark.parametrize("kind,nu", _cases(local2d.max_down_sweeps))
@pytest.mark.parametrize("name", list(TILES))
def test_utile_down_schedule_matches_plain(name, kind, nu, seg):
    sigma = SIGMAS[(nu + SEGS.index(seg)) & 1]
    g, (got_u, got_rc), (want_u, want_rc) = emulate_down(name, kind, nu,
                                                         sigma, seg)
    assert g.segs > 1 or seg == 64
    _check(got_u, want_u, sigma)
    _check(got_rc, want_rc, sigma)


@pytest.mark.parametrize("seg", SEGS)
@pytest.mark.parametrize("kind,nu", _cases(local2d.max_up_sweeps))
@pytest.mark.parametrize("name", list(TILES))
def test_utile_up_schedule_matches_plain(name, kind, nu, seg):
    sigma = SIGMAS[(nu + SEGS.index(seg) + 1) & 1]
    g, got, want = emulate_up(name, kind, nu, sigma, seg)
    assert g.segs > 1 or seg == 64
    _check(got, want, sigma)


# (tile, kind, nu, seg) of the bfloat16 cases: zero stages on rank 0's
# tile in several segments, RB-GS nu = 2 (the mixed paths') on the inner
# row tile (paired odd rows, steady chunks) and the block tile (no pairs),
# Jacobi odd and even.
_BF16 = [("rows-rank0", "rbgs", 0, 10), ("rows-inner", "rbgs", 2, 64),
         ("block-01", "rbgs", 2, 10), ("block-01", "jacobi", 3, None),
         ("rows-rank0", "jacobi", 2, 64)]
BF = torch.bfloat16


def _bf16_tile(name):
    """_tile's u and b rounded to bfloat16 (as tensors and as float32
    arrays) and e in float32."""
    t, e = _tile(name)
    su, sb = (torch.from_numpy(a).to(BF) for a in (t.ue, t.be))
    return t, su, sb, e.astype(np.float32)


@pytest.mark.parametrize("name,kind,nu,seg", _BF16)
def test_utile_bf16_down_schedule_matches_plain(name, kind, nu, seg):
    t, su, sb, _ = _bf16_tile(name)
    sigma = SIGMAS[nu & 1]
    g = geometry("down", t, kind, nu, seg)
    got_u, got_rc = _emulate_leg(g, kind, nu, su.float().numpy(),
                                 sb.float().numpy(), t.h, sigma, OMEGA,
                                 frame=utile_frame(t), bf16=True)
    want_u, _ = local2d.down_leg_plain(
        su, sb, t.n, t.h, t.m, t.row_off, t.col_off, kind=kind, omega=OMEGA,
        sweeps=nu, sigma=sigma, mcol=t.mcol)
    _bf16_rule(got_u, want_u)
    _f32_close(got_rc, local2d.residual_restrict_plain(
        torch.from_numpy(got_u).to(BF), sb, t.n, t.h, t.m, t.row_off,
        t.col_off, sigma=sigma, mcol=t.mcol))


@pytest.mark.parametrize("f32_out", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("name,kind,nu,seg", _BF16)
def test_utile_bf16_up_schedule_matches_plain(name, kind, nu, seg, f32_out):
    t, su, sb, e = _bf16_tile(name)
    sigma = SIGMAS[(nu + 1) & 1]
    g = geometry("up", t, kind, nu, seg)
    got = _emulate_leg(g, kind, nu, su.float().numpy(), sb.float().numpy(),
                       t.h, sigma, OMEGA, e=e, frame=utile_frame(t),
                       bf16=True, f32_out=f32_out)
    want = local2d.up_leg_plain(
        su, torch.from_numpy(e), sb, t.n, (t.n - 1) // 2, t.h, t.m,
        t.row_off, t.col_off, kind=kind, omega=OMEGA, sweeps=nu,
        sigma=sigma, mcol=t.mcol,
        out_dtype=torch.float32 if f32_out else None)
    if f32_out:
        assert want.dtype == torch.float32
        _f32_close(got, want)
    else:
        _bf16_rule(got, want)


def test_tiles_exercise_the_frame():
    """The tiles above cover what the unpacked tile frame adds: odd row
    offsets (rank 0's tile starting above the grid), paired accesses on
    the odd rows of a row tile (odd pitch) and none on a block tile (even
    pitch, odd column offset, lane 0's phase-0 point off the tile), two
    strips (the last partial), several segments (the last partial) and
    steady chunks of steps."""
    seen = set()
    for name in TILES:
        t, _ = _tile(name)
        f = utile_frame(t)
        assert t.row_off % 2 == 1
        pairs = tuple(f.paired(q) for q in (0, 1))
        assert pairs == ((False, False) if t.mcol else (False, True))
        seen.add(("block", t.col_off % 2 == 1))
        seen.add(("rank0", t.row_off < 0))
        for seg in SEGS:
            g, *_ = emulate_down(name, "rbgs", 2, 0.0, seg)
            y0, _, ys, _ = g.rows(0)
            assert (y0, ys) == (t.row_off, t.row_off - 1)
            seen.add(("strips", g.strips > 1))
            seen.add(("partial strip", g.strips * g.strip > g.lanes))
            seen.add(("partial segment",
                      g.segs * g.seg > t.rows + (t.row_off & 1)))
            seen.add(("steady", _emulate_leg.steady_steps > 0))
    assert seen >= {("strips", True), ("partial strip", True),
                    ("partial segment", True), ("steady", True),
                    ("steady", False)}
    assert {("block", v) for v in (True, False)} <= seen
    assert {("rank0", v) for v in (True, False)} <= seen


def _writers(g, t, leg):
    """Writers of each entry of u' (R x C) and of the coarse tile, counted
    from the geometry as the kernels' Unit assigns them (no values)."""
    f = utile_frame(t)
    fine = np.zeros((t.rows, t.cols), dtype=int)
    rc, cc, crow, ccol = f.ca
    coarse = np.zeros((rc, cc), dtype=int)
    x = np.arange(packed2d.LEG_LANES)
    ylo, yhi, xlo, xhi = f.keep
    for sx in range(g.strips):
        _, J, at, ok, core, _ = f.unit(g, sx, x)
        for sy in range(g.segs):
            y0, y1, _, _ = g.rows(sy)
            rows = np.arange(y0, y1) - t.row_off
            for p in (0, 1):
                cols = at[p][core & ok[p]]
                assert ((cols >= 0) & (cols < t.cols)).all()
                fine[rows[:, None], cols[None, :]] += 1
            if leg == "down":
                I = np.arange(y0 + (y0 & 1), y1, 2) >> 1
                I = I[(I >= ylo) & (I <= yhi)]
                Jo = J[core & (J >= xlo) & (J <= xhi)]
                coarse[(I - crow)[:, None], (Jo - ccol)[None, :]] += 1
    if leg == "down":
        for q, s in f.coarse_frame():
            coarse[q, s] += 1
    return fine, coarse


# Config 5's tiles on a mesh of 1: S1's 4095 and 2047 levels (rows) and
# S2's 2047^2 block tile; the emulated block tile.
_OWNERSHIP = [(4095, 1, 0, 0, 0), (2047, 1, 0, 0, 0), (2047, 1, 0, 1, 0),
              (127, 2, 0, 2, 1)]


@pytest.mark.parametrize("leg,cap_of", [("down", local2d.max_down_sweeps),
                                        ("up", local2d.max_up_sweeps)])
@pytest.mark.parametrize("tile", _OWNERSHIP)
def test_utile_geometry_writes_each_entry_once(tile, leg, cap_of):
    """Every entry of u' (ghost and ring rows and columns) has exactly one
    writer, and (down leg) every entry of the coarse tile, its ghost bands
    and side columns included: the restriction writes the owned box,
    zero_coarse_frame the rest; at the launch's geometry for each smoother
    at nu = 2 and its cap."""
    t = _BigTile(*tile)
    for kind in ("rbgs", "jacobi"):
        for nu in sorted({2, cap_of(kind)}):
            g = local2d.leg_geometry(leg, t.rows, t.cols, t.n, t.row_off,
                                     t.col_off, kind, nu)
            assert g.strips * g.strip >= g.lanes
            assert g.segs * g.seg >= t.rows + (t.row_off & 1)
            fine, coarse = _writers(g, t, leg)
            assert (fine == 1).all(), (kind, nu)
            if leg == "down":
                assert (coarse == 1).all(), (kind, nu)


def test_s1_tile_geometry():
    """S1's tiles, RB-GS nu = 2: at 4095 (4112 x 4097) the down leg runs
    26-lane strips by 160-row segments, as the plocal2d legs do on the
    packed twin (79 x 26 units, about LEG_WARPS_PER_SM warps on each of
    132 SMs); at 2047 (2064 x 2049) 40 strips by 40-row segments; at 255
    the least segment."""
    for n, want in ((4095, (26, 79, 160, 26)), (2047, (26, 40, 40, 52)),
                    (255, (26, 5, local2d.MIN_SEG, 46))):
        t = _BigTile(n, 1, 0, 0, 0)
        g = local2d.leg_geometry("down", t.rows, t.cols, n, t.row_off, 0,
                                 "rbgs", 2)
        assert (g.strip, g.strips, g.seg, g.segs) == want
        assert g.lanes == (n + 3) // 2 and g.first == -7


def test_utile_geometry_fits_its_window():
    """At every sweep count up to the tile caps the rows a lane holds at
    once fit the register window and the streamed rows start even, on
    S1's tile and S2's block tile."""
    for tile in ((4095, 1, 0, 0, 0), (2047, 1, 0, 1, 0)):
        t = _BigTile(*tile)
        for leg, cap_of in (("down", local2d.max_down_sweeps),
                            ("up", local2d.max_up_sweeps)):
            for kind in ("rbgs", "jacobi"):
                for nu in range(cap_of(kind) + 1):
                    g = local2d.leg_geometry(leg, t.rows, t.cols, t.n,
                                             t.row_off, t.col_off, kind, nu)
                    assert g.span() <= packed2d.LEG_WINDOW
                    assert all(g.rows(sy)[2] % 2 == 0
                               for sy in range(g.segs))


def test_c_entry_points_take_the_geometry():
    """The local2d legs' C entry points live in local2d_legs*.cu, take the
    geometry before the stream, and as many parameters as ctypes passes;
    the plocal2d legs' take the same arguments."""
    src = {p.name: p.read_text() for p in _build.CSRC.glob("local2d*.cu")}
    for t in ("f32", "f64"):
        for leg in ("down", "up"):
            name = f"mg_local2d_{leg}_{t}"
            path = "local2d_legs.cu" if t == "f32" else "local2d_legs_f64.cu"
            m = re.search(rf"\bint {name}\(([^)]*)\)\s*\{{", src[path])
            params = [p.strip() for p in m.group(1).split(",")]
            argtypes = _build.SIGNATURES[name]
            assert len(params) == len(argtypes)
            assert params[-2] == "const int* geom"
            assert argtypes[-2] is _build._IP
            assert argtypes[-1] is ctypes.c_void_p
            assert _build.SIGNATURES[f"mg_plocal2d_{leg}_{t}"] == argtypes
    assert "mg_local2d_down" not in src["local2d.cu"]
    assert "local_down_kernel" not in src["local2d.cu"]


@pytest.mark.parametrize("name,leg,kind,nu,sigma", [
    ("rows2-m128", "down", "rbgs", 2, 3.7),
    ("block2x2-10", "up", "rbgs", 3, 3.7),
])
def test_utile_schedule_matches_jax(name, leg, kind, nu, sigma):
    """The emulated kernels against JAX's local2d legs in interpret mode on
    test_torch_local2d.py's tiles (255^2 with m = 128 owned rows, and a
    block tile of 63^2), owned points of u' (that file's 1e-12 of the
    largest reference value) and, for the down leg, the whole coarse
    tile."""
    jt = JaxTile(name, seed=6)
    t = _BigTile(*JAX_TILES[name])
    ue, be = jt.ext(jt.u), jt.ext(jt.b)
    (uj, bj) = jt.jaxes(ue, be)
    f = utile_frame(t)
    kw = dict(kind=kind, omega=OMEGA, sweeps=nu, sigma=sigma, mcol=jt.mcol)
    g = local2d.leg_geometry(leg, *ue.shape, jt.n, jt.row_off, jt.col_off,
                             kind, nu)
    if leg == "down":
        got_u, got_rc = _emulate_leg(g, kind, nu, ue, be, jt.h, sigma, OMEGA,
                                     frame=f)
        want_u, want_rc = jlocal2d.down_leg(uj, bj, jt.n, jt.h, jt.m,
                                            jt.row_off, jt.col_off, **kw)
        check_owned(got_u, want_u, jt)
        wrc = np.asarray(want_rc)[:got_rc.shape[0], :got_rc.shape[1]]
        assert np.abs(got_rc - wrc).max() <= 1e-12 * np.abs(wrc).max()
        return
    nc = (jt.n - 1) // 2
    e = np.random.default_rng(jt.n).standard_normal(t.coarse_shape())
    got = _emulate_leg(g, kind, nu, ue, be, jt.h, sigma, OMEGA, e=e, frame=f)
    want = jlocal2d.up_leg(uj, embed(e, jlocal2d.ext_rows(jt.m // 2)), bj,
                           jt.n, nc, jt.h, jt.m, jt.row_off, jt.col_off,
                           **kw)
    check_owned(got, want, jt)



def test_breakdown_groups_tell_the_frames_apart():
    """utils/breakdown.py's kernel groups, on kernel names as the profiler
    gives them: the local2d group takes the row stream on UTile (the legs
    and the sweeps) and the shared-memory kernels before it (so that a tree
    from before it reads the same group), and no other group takes a UTile
    kernel: the local2d sweeps are not the stencil2d sweeps."""
    from multigridcmt_tpu_torch.utils.breakdown import (ROUTE_KERNELS,
                                                       SHARDED_KERNELS)

    ns = "(anonymous namespace)::"
    args = "(float const*, float const*, float*, float*, {f}, " \
           "mg::Coef<float>, int, {ns}LegGeom)"

    def leg(name, frame, ty="float"):
        f = ns + frame
        return (f"void {ns}{name}_kernel<{ty}, 1, 4, {f}>"
                + args.format(f=f, ns=ns))

    def groups(kernel):
        return {g for g, pat in {**SHARDED_KERNELS, **ROUTE_KERNELS}.items()
                if pat.search(kernel)}

    for name in ("down", "up"):
        assert groups(leg(name, "UTile")) == {"local2d kernels"}
        assert groups(leg(name, "UTile", "double")) == {"local2d kernels"}
        assert groups(leg(name, "Tile")) == {"plocal2d legs"}
        assert groups(leg(name, "Unpacked")) == {"fused2d legs"}
        assert groups(leg(name, "Whole")) == {"packed2d legs"}
        assert groups(f"void {ns}local_{name}_kernel<float>(float const*, "
                      "float const*, float*, float*, mg::Rect, "
                      "mg::InteriorBox, mg::Rect, mg::InteriorBox, "
                      "mg::Coef<float>, int, int, int)") == {
                          "local2d kernels"}
    assert groups(f"void {ns}local_sweep_kernel<float>(float const*, "
                  "float const*, float*, mg::Rect, mg::InteriorBox, "
                  "mg::Coef<float>, int, int, int)") == {"local2d kernels"}
    for ty in ("float", "double"):
        for kind, stages in ((1, 8), (0, 8), (0, 1)):
            f = ns + "UTile"
            sweep = (f"void {ns}sweep_kernel<{ty}, {kind}, {stages}, {f}>"
                     f"({ty} const*, {ty} const*, {ty}*, {f}, "
                     f"mg::Coef<{ty}>, {ns}LegGeom)")
            assert groups(sweep) == {"local2d kernels"}
            assert groups(sweep.replace("UTile", "Unpacked")) == {
                "stencil2d sweeps"}
