"""The row-streaming fused2d legs (csrc/packed2d_legs.cuh's down_kernel and
up_kernel on the unpacked frame, csrc/fused2d*.cu) emulated on the CPU.

The CUDA kernels run only on the card. Here tests/test_torch_packed.py's
step-by-step emulation of their schedule (tagged window slots, NaN at the
shuffle edges, rows read only after they are loaded, each output point
written exactly once) runs on the unpacked frame (``LegFrame`` with
``unpacked``: lane l's points are columns 2l and 2l + 1 of the logical
(n+2)^2 grid, the last lane's phase-1 point, column n + 2, lies off the
row, the down leg's residual is taken at every interior point, and each
stencil is summed in the plain versions' order) and is held against
``fused2d.smooth_residual_restrict_plain`` / ``prolong_add_smooth_plain``
in float64, both smoothers, at every sweep count up to the caps at sigma 0
and 11.5 at n = 3, 7 and 31 (one strip, one or several segments), and at
n = 255 (five strips, the last partial; several segments; chunks with no
row tests, which RB-GS alone runs) at every RB-GS sweep count and at 0, 1
and the cap for Jacobi, sigma 0 for even counts and 11.5 for odd ones, to
keep the file's time small. The emulation asserts that no address reaches
column n + 2 or past (n + 2)^2; at sigma 0 it rounds as the plain versions
do, bit for bit. The launch geometry is checked to own every point once
at the main path's sizes, and one case of each leg against JAX's fused2d
Pallas kernels in interpret mode. Tolerance: rtol 1e-12 and atol 1e-12 *
max|plain| (with sigma 11.5 the kernels multiply by 1/(4 - sigma h^2)
where the plain versions divide; JAX's kernels sum in their own order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigridcmt_tpu.grids import from_aligned, to_aligned
from multigridcmt_tpu.kernels import fused2d as jfused2d
from multigridcmt_tpu_torch.kernels import fused2d, packed2d
from test_torch_packed import LegFrame, _emulate_leg

OMEGA = {"rbgs": 1.0, "jacobi": 0.8}
SIGMAS = (0.0, 11.5)


def _padded(rng, n):
    a = np.zeros((n + 2, n + 2))
    a[1:-1, 1:-1] = rng.standard_normal((n, n))
    return a


def _inputs(n, seed):
    """u (or x), b scaled by 1/h^2 (so h^2 b and the neighbour sum are of
    one size) and e, float64."""
    rng = np.random.default_rng(seed)
    return (_padded(rng, n), _padded(rng, n) * (n + 1) ** 2,
            _padded(rng, (n - 1) // 2))


def _close(got, want):
    want = want.numpy() if isinstance(want, torch.Tensor) else want
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


def geometry(leg, n, kind, sweeps, seg=None):
    """The wrapper's geometry; with ``seg``, segments of seg rows, got by
    raising the least segment to seg (at 132 SMs the launch rule then
    picks exactly that segment at n <= 255, which is asserted)."""
    with pytest.MonkeyPatch.context() as mp:
        if seg is not None:
            mp.setattr(fused2d, "MIN_SEG", seg)
        g = fused2d.leg_geometry(leg, n, kind, sweeps)
    assert seg is None or g.seg == seg
    assert g.span() <= packed2d.LEG_WINDOW
    return g


# (n, segment rows): the launch's own segments (one at n = 3) and short
# ones (several segments, the last partial); at 255 segments of 64 rows
# (five, with chunks that need no row tests).
SIZES = [(3, None), (3, 2), (7, None), (7, 4), (31, None), (31, 10),
         (255, 64)]


def _cases(cap_of):
    """(n, seg, kind, nu, sigma): every case at the small sizes; at 255 one
    sigma a sweep count, and Jacobi at 0, 1 and the cap only."""
    return [(n, seg, kind, nu, sigma) for n, seg in SIZES
            for kind in ("rbgs", "jacobi")
            for nu in range(cap_of(kind) + 1) for sigma in SIGMAS
            if n < 255 or (sigma == SIGMAS[nu & 1] and (
                kind == "rbgs" or nu in (0, 1, cap_of(kind))))]


def _emulate(leg, n, seg, kind, nu, sigma):
    u, b, e = _inputs(n, 100 * n + 10 * nu + (leg == "up"))
    g = geometry(leg, n, kind, nu, seg)
    frame = LegFrame.whole(n, unpacked=True)
    h = 1.0 / (n + 1)
    if leg == "down":
        got = _emulate_leg(g, kind, nu, u, b, h, sigma, OMEGA[kind],
                           frame=frame)
        want = fused2d.smooth_residual_restrict_plain(
            torch.from_numpy(u), torch.from_numpy(b), n, h, kind=kind,
            omega=OMEGA[kind], sweeps=nu, sigma=sigma)
        return g, got, want
    got = _emulate_leg(g, kind, nu, u, b, h, sigma, OMEGA[kind], e=e,
                       frame=frame)
    want = fused2d.prolong_add_smooth_plain(
        torch.from_numpy(u), torch.from_numpy(e), torch.from_numpy(b), n,
        (n - 1) // 2, h, kind=kind, omega=OMEGA[kind], sweeps=nu,
        sigma=sigma)
    return g, got, want


@pytest.mark.parametrize("n,seg,kind,nu,sigma",
                         _cases(fused2d.max_down_sweeps))
def test_unpacked_down_schedule_matches_plain(n, seg, kind, nu, sigma):
    g, (got_u, got_rc), (want_u, want_rc) = _emulate("down", n, seg, kind,
                                                     nu, sigma)
    assert g.segs > 1 or seg is None
    _close(got_u, want_u)
    _close(got_rc, want_rc)


@pytest.mark.parametrize("n,seg,kind,nu,sigma",
                         _cases(fused2d.max_up_sweeps))
def test_unpacked_up_schedule_matches_plain(n, seg, kind, nu, sigma):
    g, got, want = _emulate("up", n, seg, kind, nu, sigma)
    assert g.segs > 1 or seg is None
    _close(got, want)


@pytest.mark.parametrize("leg,cap_of", [("down", fused2d.max_down_sweeps),
                                        ("up", fused2d.max_up_sweeps)])
def test_unpacked_legs_round_as_the_plain_path(leg, cap_of):
    """At sigma = 0 with h a power of two every product is exact, and the
    unpacked frame adds each stencil in the plain versions' order: the
    emulated RB-GS legs equal the plain ones bit for bit at every sweep
    count (chip_smoke.py's float64 history gate, kernel path against plain
    path at k = 10 with no rounding floor, rests on it)."""
    n = 31
    for nu in range(cap_of("rbgs") + 1):
        _, got, want = _emulate(leg, n, 10, "rbgs", nu, 0.0)
        pairs = zip(got, want) if leg == "down" else [(got, want)]
        for g, w in pairs:
            assert np.array_equal(g, w.numpy()), nu


def test_sizes_exercise_the_frame():
    """The cases above cover several strips (the last partial), several
    segments (the last partial), a unit alone on the grid, and chunks of
    steps with no row tests; and the last lane's phase-1 point (column
    n + 2) lies in a stored strip, so the frame must skip it."""
    seen = set()
    for n, seg in SIZES:
        g, *_ = _emulate("down", n, seg, "rbgs", 2, 0.0)
        seen.add(("strips", g.strips > 1))
        seen.add(("segments", g.segs > 1))
        seen.add(("steady", _emulate_leg.steady_steps > 0))
        seen.add(("partial strip", g.strips * g.strip > g.lanes))
        assert 2 * (g.lanes - 1) + 1 == n + 2    # column n + 2 is a lane's
    assert seen == {(k, v) for k in ("strips", "segments", "steady")
                    for v in (True, False)} | {("partial strip", True)}


def _writers(g, n, leg):
    """Writers of each point of u' (n+2)^2 and of the coarse grid
    ((n-1)/2 + 2)^2, counted from the geometry as the kernels' Unit
    assigns them (no values)."""
    f = LegFrame.whole(n, unpacked=True)
    p = n + 2
    fine = np.zeros((p, p), dtype=int)
    coarse = np.zeros(((n + 3) // 2,) * 2, dtype=int)
    x = np.arange(packed2d.LEG_LANES)
    for sx in range(g.strips):
        _, J, at, ok, core, _ = f.unit(g, sx, x)
        for ph in (0, 1):
            cols = at[ph][core & ok[ph]]
            assert (cols < p).all()
            for sy in range(g.segs):
                y0, y1, _, _ = g.rows(sy)
                fine[y0:y1, cols] += 1
        for sy in range(g.segs):
            y0, y1, _, _ = g.rows(sy)
            if leg == "down":
                rows = np.arange(y0 + (y0 & 1), y1, 2) >> 1
                coarse[rows[:, None], J[core][None, :]] += 1
    return fine, coarse


@pytest.mark.parametrize("n", [4095, 2047, 1023])
@pytest.mark.parametrize("leg,cap_of", [("down", fused2d.max_down_sweeps),
                                        ("up", fused2d.max_up_sweeps)])
def test_geometry_owns_each_point_once(n, leg, cap_of):
    """At the launch's geometry for each smoother at nu = 2 and the cap,
    every point of u' has one writer (no lane stores column n + 2) and,
    on the down leg, every coarse point (fine row 2I, lane J) one."""
    for kind in ("rbgs", "jacobi"):
        for nu in sorted({2, cap_of(kind)}):
            g = geometry(leg, n, kind, nu)
            assert g.strips * g.strip >= g.lanes == (n + 3) // 2
            assert g.segs * g.seg >= n + 2
            fine, coarse = _writers(g, n, leg)
            assert (fine == 1).all(), (kind, nu)
            if leg == "down":
                assert (coarse == 1).all(), (kind, nu)


def test_geometry_is_the_packed_grids_with_its_own_segments():
    """The unpacked frame has the packed grid's rows and lanes; only the
    least segment is fused2d's own (the packed legs' stays)."""
    for n in (4095, 2047, 255):
        for leg in ("down", "up"):
            g = fused2d.leg_geometry(leg, n, "rbgs", 2)
            p = packed2d.leg_geometry(leg, n, "rbgs", 2,
                                      min_seg=fused2d.MIN_SEG)
            assert g == p
            assert (g.count, g.lanes, g.first) == (n + 2, (n + 3) // 2, 0)
    whole = packed2d.leg_geometry("down", 4095, "rbgs", 2)
    assert whole.seg >= packed2d.LEG_MIN_SEG


@pytest.mark.parametrize("leg", ["down", "up"])
def test_unpacked_schedule_matches_jax(leg):
    """The emulated kernels against JAX's fused2d legs in interpret mode at
    n = 63, RB-GS nu = 2 with a shift, several segments."""
    n, nu, sigma = 63, 2, 11.5
    nc, h = (n - 1) // 2, 1.0 / (n + 1)
    u, b, e = _inputs(n, 7)
    frame = LegFrame.whole(n, unpacked=True)
    g = geometry(leg, n, "rbgs", nu, seg=16)
    ju, jb, je = (to_aligned(jnp.asarray(a)) for a in (u, b, e))
    if leg == "down":
        want_u, want_rc = jfused2d.smooth_residual_restrict(
            ju, jb, n, h, kind="rbgs", omega=1.0, sweeps=nu, sigma=sigma)
        got_u, got_rc = _emulate_leg(g, "rbgs", nu, u, b, h, sigma, 1.0,
                                     frame=frame)
        _close(got_u, np.asarray(from_aligned(want_u, n)))
        _close(got_rc, np.asarray(from_aligned(want_rc, nc)))
        return
    want = jfused2d.prolong_add_smooth(ju, je, jb, n, nc, h, kind="rbgs",
                                       omega=1.0, sweeps=nu, sigma=sigma)
    got = _emulate_leg(g, "rbgs", nu, u, b, h, sigma, 1.0, e=e, frame=frame)
    _close(got, np.asarray(from_aligned(want, n)))
