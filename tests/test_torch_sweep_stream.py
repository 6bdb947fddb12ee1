"""The row-streaming sweeps (csrc/packed2d_legs.cuh's sweep_kernel: the up
leg's stream without its coarse operand) emulated on the CPU, on both
frames they run on: the whole packed grid (``packed2d.rbgs_sweep``,
csrc/packed2d_sweep.cu) and the unpacked grid (``stencil2d.rbgs_sweep`` and
``jacobi_sweep``, csrc/stencil2d_sweep*.cu).

The CUDA kernels run only on the card. Here tests/test_torch_packed.py's
step-by-step emulation of their schedule (tagged window slots, NaN at the
shuffle edges, rows read only after they are loaded, each neighbour row
swept exactly as often as a sequential sweep would have it, each output
point written exactly once; on the unpacked frame every address inside its
row and the array) runs on ``packed2d.leg_geometry("sweep", ...)`` and is
held against the plain versions in float64 at every sweep count up to the
caps, at n = 7 (one strip, one or several segments), 61 and 127 (several
strips and segments, the last partial, with short segments), at sigma 0
and 11.5. On the unpacked frame at sigma 0 with h a power of two the RB-GS
sweeps round as the plain ones do, bit for bit (every product exact, each
stencil summed in the plain order: chip_smoke.py's float64 history gate of
path B, kernel against plain with no rounding floor, rests on it). Every
other case, within rtol 1e-12 and atol 1e-12 * max|plain|: the packed frame
sums a stencil's neighbours first, Jacobi steps by omega / (4/h^2 - sigma)
where the plain version divides, and with sigma 11.5 the kernels multiply
by 1/(4 - sigma h^2) where the plain versions divide. The geometry is
pinned against the kernel source's constants and the launcher's rules, and
is checked to own every point once at the main path's sizes.
"""
import re

import numpy as np
import pytest
import torch

from multigridcmt_tpu_torch.kernels import _build, fused2d, packed2d, \
    stencil2d
from test_torch_fused2d_stream import _emulate as _emulate_fused
from test_torch_fused2d_stream import _writers
from test_torch_packed import LegFrame, _emulate_leg

OMEGA = {"rbgs": 1.0, "jacobi": 0.8}
SIGMA = 11.5
# (n, segment rows): the launch's own segments (at 7 and 127: one of 64
# rows packed, the unpacked frame's least segment of 6 rows) and short ones
# (several, the last partial); on the unpacked frame also one segment at 7
# and segments of 64 rows at 127, whose chunks of steps need no row tests
# (the packed frame's own at 127). Every size but 7 has several strips, the
# last partial.
SIZES = [(7, None), (7, 4), (7, 10), (61, 10), (127, 64), (127, None)]
PACKED_SIZES = [(7, None), (7, 4), (61, 10), (127, 16), (127, None)]


def _cap(kind):
    return stencil2d.max_fused_sweeps(kind)


def _padded(rng, n):
    a = np.zeros((n + 2, n + 2))
    a[1:-1, 1:-1] = rng.standard_normal((n, n))
    return a


def geometry(n, kind, nu, seg, unpacked):
    """The wrapper's sweep geometry on the frame; with ``seg``, segments of
    seg rows, got by raising the frame's least segment to seg (at 132 SMs
    the launch rule then picks exactly that segment at n <= 127, which is
    asserted)."""
    with pytest.MonkeyPatch.context() as mp:
        if seg is not None:
            mp.setattr(fused2d, "MIN_SEG", seg)
            mp.setattr(packed2d, "LEG_MIN_SEG", seg)
        g = (fused2d.leg_geometry("sweep", n, kind, nu) if unpacked
             else packed2d.leg_geometry("sweep", n, kind, nu))
    assert seg is None or g.seg == seg
    assert g.span() <= packed2d.LEG_WINDOW
    return g


def emulate(n, seg, kind, nu, sigma, unpacked, h=None):
    """(geometry, the emulated sweep stream, the plain sweeps) on logical
    float64 grids; h defaults to 2^-ceil(log2(n + 1)), a power of two."""
    rng = np.random.default_rng(1000 * n + 10 * nu + (kind == "jacobi"))
    h = 2.0 ** -int(np.ceil(np.log2(n + 1))) if h is None else h
    u, b = _padded(rng, n), _padded(rng, n) / h ** 2
    g = geometry(n, kind, nu, seg, unpacked)
    tu, tb = torch.from_numpy(u), torch.from_numpy(b)
    if kind == "rbgs":
        want = stencil2d.rbgs_sweep_plain(tu, tb, n, h, sigma=sigma,
                                          sweeps=nu)
    else:
        want = stencil2d.jacobi_sweep_plain(tu, tb, n, h, OMEGA[kind],
                                            sigma=sigma, sweeps=nu)
    if unpacked:
        got = _emulate_leg(g, kind, nu, u, b, h, sigma, OMEGA[kind],
                           frame=LegFrame.whole(n, unpacked=True))
    else:
        got = _emulate_leg(g, kind, nu, packed2d.pack(tu).numpy(),
                           packed2d.pack(tb).numpy(), h, sigma, OMEGA[kind])
        # The packed pad lanes stay zero.
        assert np.array_equal(
            packed2d.pack(packed2d.unpack(torch.from_numpy(got))).numpy(),
            got)
        got = packed2d.unpack(torch.from_numpy(got)).numpy()
    return g, got, want.numpy()


def _close(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("n,seg", SIZES)
@pytest.mark.parametrize("nu", range(1, _cap("rbgs") + 1))
def test_unpacked_rbgs_rounds_as_the_plain_sweeps(n, seg, nu):
    g, got, want = emulate(n, seg, "rbgs", nu, 0.0, unpacked=True)
    assert g.segs > 1 or seg is None or seg >= n + 2
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n,seg", SIZES)
@pytest.mark.parametrize("nu", range(1, _cap("rbgs") + 1))
def test_unpacked_rbgs_with_a_shift_matches_plain(n, seg, nu):
    _, got, want = emulate(n, seg, "rbgs", nu, SIGMA, unpacked=True,
                           h=1.0 / (n + 1))
    _close(got, want)


# Jacobi: every case at n <= 61; at 127 one sigma a sweep count (0 for even
# counts, 11.5 for odd ones), to keep the file's time small.
JACOBI_CASES = [(n, seg, sigma, nu) for n, seg in SIZES
                for nu in range(1, _cap("jacobi") + 1)
                for sigma in (0.0, SIGMA)
                if n < 127 or sigma == (0.0, SIGMA)[nu & 1]]


@pytest.mark.parametrize("n,seg,sigma,nu", JACOBI_CASES)
def test_unpacked_jacobi_matches_plain(n, seg, sigma, nu):
    """At sigma 0 bit for bit: the unpacked frame also rounds the Jacobi
    step's product and sum apart, as the plain version does (no FMA;
    chip_smoke.py's float64 history gate of path C rests on it)."""
    _, got, want = emulate(n, seg, "jacobi", nu, sigma, unpacked=True)
    if sigma == 0.0:
        assert np.array_equal(got, want)
    _close(got, want)


@pytest.mark.parametrize("n,seg", PACKED_SIZES)
@pytest.mark.parametrize("sigma", [0.0, SIGMA])
@pytest.mark.parametrize("nu", range(1, packed2d.max_fused_sweeps() + 1))
def test_packed_rbgs_matches_plain(n, seg, sigma, nu):
    g, got, want = emulate(n, seg, "rbgs", nu, sigma, unpacked=False)
    assert g.segs > 1 or seg is None or seg >= n + 2
    _close(got, want)


@pytest.mark.parametrize("leg,cap_of", [("down", fused2d.max_down_sweeps),
                                        ("up", fused2d.max_up_sweeps)])
def test_fused2d_jacobi_legs_round_as_the_plain_path(leg, cap_of):
    """The fused2d Jacobi legs on the same frame (path C runs the up leg at
    nu = 8) round as the plain ones at sigma 0, h a power of two, at every
    sweep count: with the unpacked sweeps, C's float64 history gate holds
    kernel against plain with no rounding floor."""
    for nu in range(cap_of("jacobi") + 1):
        _, got, want = _emulate_fused(leg, 31, 10, "jacobi", nu, 0.0)
        pairs = zip(got, want) if leg == "down" else [(got, want)]
        for g, w in pairs:
            assert np.array_equal(g, w.numpy()), nu


def test_sizes_exercise_the_frames():
    """The cases above cover, on each frame, one strip and several (the
    last partial), one segment and several (the last partial), and chunks
    of steps with no row tests and without."""
    for unpacked, sizes in ((True, SIZES), (False, PACKED_SIZES)):
        seen = set()
        for n, seg in sizes:
            g, *_ = emulate(n, seg, "rbgs", 1, 0.0, unpacked)
            seen.add(("strips", g.strips > 1))
            seen.add(("segments", g.segs > 1))
            seen.add(("steady", _emulate_leg.steady_steps > 0))
            assert g.strips * g.strip > g.lanes        # a partial strip
            assert g.segs * g.seg > n + 2              # a partial segment
        assert seen == {(k, v) for k in ("strips", "segments", "steady")
                        for v in (True, False)}, unpacked


def _schedules():
    return [(kind, nu) for kind in ("rbgs", "jacobi")
            for nu in range(1, _cap(kind) + 1)]


def test_sweep_geometry_matches_the_kernel_source():
    """The sweep stream's stage counts fit the kernel's kMaxUpStages (the
    wrappers' caps are exactly it), its strips fill a warp (kWarp), and its
    halos are the up leg's, which the launcher checks (top and bottom K
    rows, 2 halo_lanes >= K columns, top even); each is the up leg's
    geometry on its frame."""
    src = (_build.CSRC / "packed2d_legs.cuh").read_text()
    const = {name: int(v) for name, v in
             re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    launcher = src[src.index("int launch_sweep("):]
    for rule in ("g.top < K", "g.bottom < K", "2 * g.hp < K"):
        assert rule in launcher[:launcher.index("const auto cf")]
    assert 2 * packed2d.max_fused_sweeps() == const["kMaxUpStages"]
    assert 2 * _cap("rbgs") == _cap("jacobi") == const["kMaxUpStages"]
    for kind, nu in _schedules():
        for n, unpacked in ((4095, False), (2047, True), (255, True)):
            g = geometry(n, kind, nu, None, unpacked)
            K = 2 * nu if kind == "rbgs" else nu
            assert g.stages == K <= const["kMaxUpStages"]
            assert g.strip + 2 * g.halo_lanes == const["kWarp"]
            assert g.top % 2 == 0 and g.seg % 2 == 0
            assert min(g.top, g.bottom, 2 * g.halo_lanes) >= K
            assert g.out_lag == K and g.span() <= packed2d.LEG_WINDOW
            up = (fused2d.leg_geometry("up", n, kind, nu) if unpacked
                  else packed2d.leg_geometry("up", n, kind, nu))
            assert g.ints() == up.ints()
            least = fused2d.MIN_SEG if unpacked else packed2d.LEG_MIN_SEG
            assert g.seg >= least


@pytest.mark.parametrize("n,unpacked", [(4095, False), (2999, False),
                                        (2047, True), (2999, True),
                                        (1023, True), (511, True),
                                        (255, True), (7, True)])
def test_sweep_geometry_covers_and_owns_each_point_once(n, unpacked):
    """The launcher's covers rule (strips * strip >= the frame's lanes,
    segs * seg >= n + 2) holds at the wrappers' geometry, and every point
    of u' has one writer, at the main path's sizes and at 2999 and 7
    (partial strips and segments)."""
    p, lanes = n + 2, (n + 3) // 2
    for kind, nu in _schedules():
        g = geometry(n, kind, nu, None, unpacked)
        assert g.strips * g.strip >= lanes == g.lanes
        assert g.segs * g.seg >= p == g.count
        if unpacked:
            fine, _ = _writers(g, n, "up")
        else:
            fine = np.zeros((p, lanes), dtype=int)
            for sy in range(g.segs):
                y0, y1, ys, ye = g.rows(sy)
                assert ys <= max(0, y0 - g.stages)
                assert ye == min(p, y1 + g.stages)
                for sx in range(g.strips):
                    l0, l1 = g.strip_lanes(sx)
                    fine[y0:y1, l0:l1] += 1
        assert (fine == 1).all(), (kind, nu)


def test_c_entry_points_take_their_declared_arguments():
    """Every C entry point that _build declares for ctypes is defined in a
    csrc/*.cu with as many parameters (the sweeps' now take the geometry
    before the stream), each a pointer where ctypes passes c_void_p or an
    int array, and is defined once."""
    import ctypes

    defs = {}
    for path in sorted(_build.CSRC.glob("*.cu")):
        for name, params in re.findall(r"\bint (mg_\w+)\(([^)]*)\)\s*\{",
                                       path.read_text()):
            assert name not in defs, name
            defs[name] = [p.strip() for p in params.split(",")]
    assert set(_build.SIGNATURES) <= set(defs)
    for name, argtypes in _build.SIGNATURES.items():
        params = defs[name]
        assert len(params) == len(argtypes), name
        for param, t in zip(params, argtypes):
            pointer = "*" in param
            assert pointer == (t in (ctypes.c_void_p, _build._IP)), \
                (name, param)
