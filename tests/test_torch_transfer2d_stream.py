"""transfer2d.residual_restrict's row stream (csrc/packed2d_legs.cuh's
residual_restrict_kernel, launched from csrc/transfer2d.cu) emulated on
the CPU.

The kernel is the fused2d down leg's stream on the unpacked frame with no
smoothing stage (K = 0) and no store of u'. Here tests/test_torch_packed.py's
step-by-step emulation of that schedule (``_emulate_leg`` with ``fine``
False: tagged window slots, NaN at the shuffle edges, each coarse point
written exactly once, no fine point stored) runs on the geometry the
wrapper launches (``transfer2d.leg_geometry``: the zero-sweep down leg's
on ``fused2d``'s frame) and on shorter segments, and is held against
``transfer2d.residual_restrict_plain`` in float64 at n = 3…255: bit for
bit at h = 2^-k (sigma is always 0 here, as in JAX), since the stream sums
the residual in ``residual_of``'s plain order and the full weighting rows
first, as ``transfer.restrict`` does. The launch geometry is checked to
own every coarse point once at the composed paths' levels, the kernel
source to route the wrapper through that stream, and one case against
JAX's transfer2d Pallas kernel in interpret mode (rtol 1e-12 and atol
1e-12 * max|ref|: it weights rows and columns in another order).
"""
import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigridcmt_tpu.grids import from_aligned, to_aligned
from multigridcmt_tpu.kernels import transfer2d as jtransfer2d
from multigridcmt_tpu_torch.kernels import _build, fused2d, packed2d, \
    transfer2d
from test_torch_fused2d_stream import _writers
from test_torch_packed import LegFrame, _emulate_leg


def _inputs(n, seed):
    """u and b (scaled by 1/h^2), float64 padded grids."""
    rng = np.random.default_rng(seed)
    u, b = np.zeros((n + 2, n + 2)), np.zeros((n + 2, n + 2))
    u[1:-1, 1:-1] = rng.standard_normal((n, n))
    b[1:-1, 1:-1] = rng.standard_normal((n, n)) * (n + 1) ** 2
    return u, b


def geometry(n, seg=None):
    """The wrapper's geometry; with ``seg``, segments of seg rows (the
    least segment raised to seg, which the launch rule then picks at
    n <= 255, asserted)."""
    with pytest.MonkeyPatch.context() as mp:
        if seg is not None:
            mp.setattr(fused2d, "MIN_SEG", seg)
        g = transfer2d.leg_geometry(n)
    assert seg is None or g.seg == seg
    assert (g.leg, g.stages, g.top, g.bottom, g.halo_lanes) == (
        "down", 0, 2, 1, 1)
    return g


def _emulate(n, seg, seed):
    u, b = _inputs(n, seed)
    g = geometry(n, seg)
    h = 1.0 / (n + 1)
    rc = _emulate_leg(g, "rbgs", 0, u, b, h, 0.0, 1.0,
                      frame=LegFrame.whole(n, unpacked=True), fine=False)
    want = transfer2d.residual_restrict_plain(torch.from_numpy(u),
                                              torch.from_numpy(b), n, h)
    return g, rc, want.numpy()


# (n, segment rows): the launch's own segments and shorter ones (several
# segments, the last partial; at 255 several strips, the last partial, and
# chunks with no row tests; 57's 30 lanes fill one strip).
SIZES = [(3, None), (3, 2), (5, None), (7, None), (7, 4), (15, 6),
         (31, None), (31, 10), (57, 8), (63, 8), (63, 16), (127, 12),
         (255, None), (255, 64)]


@pytest.mark.parametrize("n,seg", SIZES)
def test_residual_restrict_stream_rounds_as_the_plain_version(n, seg):
    """The emulated stream equals restrict(residual(u, b)) bit for bit in
    float64 at h = 2^-k: chip_smoke.py's float64 history gates of the
    composed paths B and C (kernel path against plain path, no rounding
    floor) rest on it."""
    g, rc, want = _emulate(n, seg, 13 * n + (seg or 0))
    assert rc.shape == want.shape == ((n + 3) // 2,) * 2
    assert g.segs > 1 or seg is None
    assert np.array_equal(rc, want)


def test_sizes_exercise_the_frame():
    """The cases above cover several strips (the last partial), several
    segments (the last partial), a unit alone on the grid, and chunks of
    steps with no row tests."""
    seen = set()
    for n, seg in SIZES:
        g, *_ = _emulate(n, seg, 1)
        seen.add(("strips", g.strips > 1))
        seen.add(("segments", g.segs > 1))
        seen.add(("steady", _emulate_leg.steady_steps > 0))
        seen.add(("partial strip", g.strips * g.strip > g.lanes))
    assert seen == {(k, v) for k in ("strips", "segments", "steady",
                                     "partial strip") for v in (True, False)}


@pytest.mark.parametrize("n", [4095, 2047, 1023, 511, 255])
def test_geometry_owns_each_coarse_point_once(n):
    """At the launch's geometry every coarse point (fine row 2I, lane J)
    has one writer, at the composed paths' levels and at 4095."""
    g = transfer2d.leg_geometry(n)
    assert g.strips * g.strip >= g.lanes == (n + 3) // 2
    assert g.segs * g.seg >= n + 2
    _, coarse = _writers(g, n, "down")
    assert (coarse == 1).all()


def test_geometry_is_the_zero_sweep_down_legs():
    """transfer2d launches the zero-sweep fused2d down leg's geometry (the
    same rows, lanes, halos, lags and least segment), for every card."""
    for n in (4095, 2047, 1023, 255, 7):
        for sms in (132, 114, 1):
            g = transfer2d.leg_geometry(n, sm_count=sms)
            assert g == fused2d.leg_geometry("down", n, "rbgs", 0,
                                             sm_count=sms)
            assert g == packed2d.leg_geometry(
                "down", n, "rbgs", 0, sm_count=sms, min_seg=fused2d.MIN_SEG)
            assert g.span() <= packed2d.LEG_WINDOW


def test_stream_matches_jax():
    """The emulated stream against JAX's transfer2d.residual_restrict in
    interpret mode at n = 63, several segments."""
    n = 63
    u, b = _inputs(n, 7)
    h = 1.0 / (n + 1)
    rc = _emulate_leg(geometry(n, 16), "rbgs", 0, u, b, h, 0.0, 1.0,
                      frame=LegFrame.whole(n, unpacked=True), fine=False)
    want = np.asarray(from_aligned(jtransfer2d.residual_restrict(
        to_aligned(jnp.asarray(u)), to_aligned(jnp.asarray(b)), n, h),
        (n - 1) // 2))
    np.testing.assert_allclose(rc, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


def test_kernel_source_runs_the_stream():
    """csrc/transfer2d.cu's entry points take the geometry and launch
    packed2d_legs.cuh's residual_restrict_kernel on the unpacked frame,
    the down leg's stream at K = 0 with the store of u' compiled out; the
    shared-memory tile kernel and common.cuh's tile helpers are gone."""
    src = {p.name: p.read_text() for p in _build.CSRC.glob("*.cu*")}
    cu, legs = src["transfer2d.cu"], src["packed2d_legs.cuh"]
    for t, ty in (("f32", "float"), ("f64", "double")):
        name = f"mg_transfer2d_residual_restrict_{t}"
        m = re.search(rf"\bint {name}\(([^)]*)\)\s*\{{", cu)
        params = [p.strip() for p in m.group(1).split(",")]
        argtypes = _build.SIGNATURES[name]
        assert len(params) == len(argtypes)
        assert params[-2] == "const int* geom" and argtypes[-2] is _build._IP
        assert argtypes[-1] is ctypes.c_void_p
        assert re.search(rf"launch_residual_restrict<{ty}>\(\s*u, b, rc, "
                         r"Unpacked\{n\}", cu)
    assert '#include "packed2d_legs.cuh"' in cu
    # (The trailing template arguments are the frame and the storage type,
    # T for this float32/float64 stream.)
    assert re.search(r"residual_restrict_kernel\([^)]*\)\s*\{\s*"
                     r"down_stream<T, mg::kRbgs, 0, false, Unpacked, T>"
                     r"\(u, b, nullptr", legs)
    assert re.search(r"down_kernel\([^)]*\)\s*\{\s*"
                     r"down_stream<T, KIND, K, true, Fr, S>", legs)
    assert "rr_kernel" not in cu
    for helper in ("set_smem", "load_tile", "core_residual",
                   "restrict_core"):
        assert not re.search(rf"\b{helper}\b", src["common.cuh"]), helper
        assert not re.search(rf"\b{helper}\b", cu), helper


def test_wrapper_on_cpu_takes_the_plain_version():
    """A CPU tensor takes the plain version (no launch), off a pair of
    elements too."""
    n = 31
    u, b = (torch.from_numpy(a) for a in _inputs(n, 3))
    before = transfer2d.residual_restrict_launches
    buf = torch.zeros(u.numel() + 1, dtype=u.dtype)
    off = buf[1:].view(u.shape)
    off.copy_(u)
    h = 1.0 / (n + 1)
    got = transfer2d.residual_restrict(off, b, n, h)
    assert torch.equal(got, transfer2d.residual_restrict_plain(u, b, n, h))
    assert transfer2d.residual_restrict_launches == before


def test_breakdown_group_takes_the_stream_and_the_old_kernel():
    """utils/breakdown.py's residual_restrict group, on kernel names as the
    profiler gives them, takes the row stream's residual_restrict_kernel
    and the shared-memory rr_kernel before it (so that the parent tree,
    timed in turns with this tool, reads the same group), and no other
    group takes them; the zero-sweep down leg stays a fused2d leg."""
    from multigridcmt_tpu_torch.utils.breakdown import (ROUTE_KERNELS,
                                                       SHARDED_KERNELS)

    ns = "(anonymous namespace)::"

    def groups(kernel):
        return {g for g, pat in {**SHARDED_KERNELS, **ROUTE_KERNELS}.items()
                if pat.search(kernel)}

    for ty in ("float", "double"):
        assert groups(f"void {ns}residual_restrict_kernel<{ty}>({ty} const*, "
                      f"{ty} const*, {ty}*, {ns}Unpacked, mg::Coef<{ty}>, "
                      f"{ns}LegGeom)") == {"residual_restrict"}
        assert groups(f"void {ns}rr_kernel<{ty}>({ty} const*, {ty} const*, "
                      f"{ty}*, int, mg::Coef<{ty}>)") == {"residual_restrict"}
        assert groups(f"void {ns}down_kernel<{ty}, 1, 0, {ns}Unpacked>("
                      f"{ty} const*, {ty} const*, {ty}*, {ty}*, {ns}Unpacked, "
                      f"mg::Coef<{ty}>, int, {ns}LegGeom)") == {"fused2d legs"}
