"""The native bfloat16 fused2d legs on the row stream
(csrc/packed2d_legs.cuh's down and up streams with the native arithmetic,
csrc/fused2d_native_bf16.cu and fused2d_up_native_bf16.cu) emulated on the
CPU.

The CUDA kernels run only on the card. Here tests/test_torch_packed.py's
step-by-step emulation of their schedule (tagged window slots, NaN at the
shuffle edges and in dead ring slots, rows read only after they are loaded,
each output point written exactly once) runs in its native mode on the
unpacked frame (``LegFrame.whole(n, unpacked=True)``): the rows in flight
held as raw bfloat16 words (an even row's pair as one word), every
operation rounded to bfloat16 after its float32 operation, the host's
constants (``native_bf16.constants``), the restriction's (0.25 lo + 0.5
mid) + 0.25 hi over rows then columns and the prolongation's rows-first
averages. It is held bit for bit against ``native_bf16.down_leg_plain`` and
``up_leg_plain`` (which tests/test_torch_native_bf16_legs.py holds against
JAX's fused2d kernels in interpret mode) at sigma 0 and 11.5: at n = 7 (the
launch's own geometry) and 31 (segments of 10 rows) every sweep count up to
each leg's cap with both smoothers; at n = 255 (segments of 64 rows: five
strips, the last partial, and chunks with no row tests) RB-GS at 0, 1, 2
and the cap, Jacobi at 0, 1 and the cap. The emulation asserts that every
paired access starts on a 4-byte pair and that the down leg's residual
reads bfloat16 values from the window (the stream keeps no ring of rounded
rows). Inputs: N(0, 1) values (b scaled by 1/h^2) made with numpy from a
seed and rounded to bfloat16. The wrappers' route on a CUDA tensor (one
launch of the stream a leg, no native sweep counted) is checked with the
device rule faked.
"""
import numpy as np
import pytest
import torch

from multigridcmt_tpu_torch.kernels import fused2d, native_bf16, stencil2d
from test_torch_packed import LegFrame, _emulate_leg, _nat

OMEGA = {"rbgs": 1.0, "jacobi": 0.8}
SIGMAS = (0.0, 11.5)
# (n, segment rows): the launch's own geometry; short segments; at 255
# segments of 64 rows (several strips and segments, steady chunks).
SIZES = {7: None, 31: 10, 255: 64}


def _padded(rng, n, scale=1.0):
    a = np.zeros((n + 2, n + 2), dtype=np.float32)
    a[1:-1, 1:-1] = rng.standard_normal((n, n)) * scale
    return _nat(a)


def _inputs(n, seed):
    """u (or x), b of 1/h^2 size and the coarse e, bfloat16 values in
    float32 arrays."""
    rng = np.random.default_rng(seed)
    return (_padded(rng, n), _padded(rng, n, float((n + 1) ** 2)),
            _padded(rng, (n - 1) // 2))


def _geometry(leg, n, kind, sweeps):
    seg = SIZES[n]
    with pytest.MonkeyPatch.context() as mp:
        if seg is not None:
            mp.setattr(fused2d, "MIN_SEG", seg)
        g = fused2d.leg_geometry(leg, n, kind, sweeps)
    assert seg is None or g.seg == seg
    return g


def _cases(cap_of):
    """(n, kind, nu, sigma): every count at 7 and 31; at 255 RB-GS 0, 1, 2
    and the cap, Jacobi 0, 1 and the cap."""
    out = []
    for n in SIZES:
        for kind in ("rbgs", "jacobi"):
            cap = cap_of(kind)
            nus = (range(cap + 1) if n < 255 else
                   sorted({0, 1, 2, cap} if kind == "rbgs" else {0, 1, cap}))
            out += [(n, kind, nu, sigma) for nu in nus for sigma in SIGMAS]
    return out


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@pytest.mark.parametrize("n,kind,nu,sigma", _cases(fused2d.max_down_sweeps))
def test_native_down_stream_equals_plain(n, kind, nu, sigma):
    u, b, _ = _inputs(n, 7000 + 10 * n + nu)
    h = 1.0 / (n + 1)
    g = _geometry("down", n, kind, nu)
    got_u, got_rc = _emulate_leg(g, kind, nu, u, b, h, sigma, OMEGA[kind],
                                 frame=LegFrame.whole(n, unpacked=True),
                                 native=True)
    c = native_bf16.constants(h, sigma, OMEGA[kind])
    want_u, want_rc = native_bf16.down_leg_plain(
        torch.from_numpy(u).bfloat16(), torch.from_numpy(b).bfloat16(), n,
        c, kind, nu)
    assert np.array_equal(got_u, _bits(want_u))
    assert np.array_equal(got_rc, _bits(want_rc))


@pytest.mark.parametrize("n,kind,nu,sigma", _cases(fused2d.max_up_sweeps))
def test_native_up_stream_equals_plain(n, kind, nu, sigma):
    x, b, e = _inputs(n, 8000 + 10 * n + nu)
    h, nc = 1.0 / (n + 1), (n - 1) // 2
    g = _geometry("up", n, kind, nu)
    got = _emulate_leg(g, kind, nu, x, b, h, sigma, OMEGA[kind], e=e,
                       frame=LegFrame.whole(n, unpacked=True), native=True)
    c = native_bf16.constants(h, sigma, OMEGA[kind])
    want = native_bf16.up_leg_plain(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(e).bfloat16(),
        torch.from_numpy(b).bfloat16(), n, nc, c, kind, nu)
    assert np.array_equal(got, _bits(want))


def test_native_cases_exercise_the_stream():
    """At 255 the cases run several strips (the last partial) and
    segments, and chunks with no row tests; at 31 several segments."""
    n, nu = 255, 2
    u, b, _ = _inputs(n, 1)
    g = _geometry("down", n, "rbgs", nu)
    _emulate_leg(g, "rbgs", nu, u, b, 1.0 / (n + 1), 0.0, 1.0,
                 frame=LegFrame.whole(n, unpacked=True), native=True)
    assert g.strips > 1 and g.strips * g.strip > g.lanes and g.segs > 1
    assert _emulate_leg.steady_steps > 0
    assert _geometry("up", 31, "jacobi", 8).segs > 1


@pytest.mark.parametrize("leg", ["down", "up"])
def test_native_legs_launch_the_stream(leg, monkeypatch):
    """On a CUDA tensor (the device rule faked, the launches recorded) a
    bfloat16 leg makes one launch of its stream's entry point with the
    host's constants, the kind, the sweeps and fused2d's geometry, on
    arrays that start on a 4-byte pair (an input off one is copied); it
    counts once on fused2d's native counter and never on stencil2d's
    native sweeps."""
    calls = []
    monkeypatch.setattr(native_bf16, "on_cuda", lambda t: True)
    monkeypatch.setattr(native_bf16, "launch_on",
                        lambda t, kernel, *args, writes=(): calls.append(
                            (kernel, args, writes)))
    monkeypatch.setattr(fused2d, "_launch_geometry",
                        lambda lg, n, kind, nu, t: fused2d.leg_geometry(
                            lg, n, kind, nu).ints())
    for mod, name in ((fused2d, "down_bf16_launches"),
                      (fused2d, "up_bf16_launches"),
                      (stencil2d, "rbgs_bf16_launches"),
                      (stencil2d, "jacobi_bf16_launches")):
        monkeypatch.setattr(mod, name, 0)
    n, nc, h, sigma, nu = 31, 15, 1.0 / 32, 11.5, 3
    flat = torch.zeros((n + 2) ** 2 + 1, dtype=torch.bfloat16)
    u = flat[1:].view(n + 2, n + 2)             # off a 4-byte pair
    b = torch.zeros((n + 2, n + 2), dtype=torch.bfloat16)
    e = torch.zeros((nc + 2, nc + 2), dtype=torch.bfloat16)
    if leg == "down":
        fused2d.smooth_residual_restrict(u, b, n, h, kind="jacobi",
                                         omega=0.8, sweeps=nu, sigma=sigma)
        kind = "jacobi"
    else:
        fused2d.prolong_add_smooth(u, e, b, n, nc, h, kind="rbgs",
                                   omega=1.0, sweeps=nu, sigma=sigma)
        kind = "rbgs"
    (kernel, args, writes), = calls
    assert kernel == f"fused2d_{leg}_native"
    ptrs = args[:4]
    assert all(p % 4 == 0 for p in ptrs) and u.data_ptr() not in ptrs
    c = native_bf16.constants(h, sigma, OMEGA[kind])
    assert args[4:] == (n, *c, 0 if kind == "jacobi" else 1, nu,
                        fused2d.leg_geometry(leg, n, kind, nu).ints())
    assert all(w.dtype == torch.bfloat16 for w in writes)
    assert (fused2d.down_bf16_launches, fused2d.up_bf16_launches,
            stencil2d.rbgs_bf16_launches,
            stencil2d.jacobi_bf16_launches) == (
        (1, 0, 0, 0) if leg == "down" else (0, 1, 0, 0))


def test_breakdown_groups_take_the_native_legs_and_the_chain():
    """utils/breakdown.py's kernel groups, on kernel names as the profiler
    gives them: "native legs" takes the row stream's native_down_kernel
    and native_up_kernel and no float leg group does; "native sweeps" the
    stream's native_sweep_kernel (RB-GS) and native_jacobi_sweep_kernel and
    native_bf16.cu's native_rbgs_kernel and native_jacobi_kernel, "native
    restriction" the stream's native_residual_restrict_kernel and
    native_bf16.cu's native_restrict_kernel, "native prolongation" the block
    kernel native_prolong_add_kernel and native_bf16.cu's
    native_prolong_kernel (so that a parent tree, timed in turns with this
    tool, reads the same groups), and "native kernels" native_bf16.cu's
    residual."""
    from multigridcmt_tpu_torch.utils.breakdown import (ROUTE_KERNELS,
                                                       SHARDED_KERNELS)

    ns = "(anonymous namespace)::"
    bf = "__nv_bfloat16"

    def groups(kernel):
        return {g for g, pat in {**SHARDED_KERNELS, **ROUTE_KERNELS}.items()
                if pat.search(kernel)}

    for leg in ("down", "up"):
        for kind, stages in ((1, 4), (0, 0), (0, 8)):
            name = (f"void {ns}native_{leg}_kernel<{kind}, {stages}>("
                    f"{bf} const*, {bf} const*, {bf}*, {bf}*, {ns}Unpacked, "
                    f"mg::Coef<{ns}Nb>, {ns}LegGeom)")
            assert groups(name) == {"native legs"}
    for kernel, stages in (("native_sweep_kernel", 2),
                           ("native_sweep_kernel", 8),
                           ("native_jacobi_sweep_kernel", 1),
                           ("native_jacobi_sweep_kernel", 8)):
        name = (f"void {ns}{kernel}<{stages}>({bf} const*, "
                f"{bf} const*, {bf}*, {ns}Unpacked, mg::Coef<{ns}Nb>, "
                f"{ns}LegGeom)")
        assert groups(name) == {"native sweeps"}
    assert groups(f"{ns}native_residual_restrict_kernel({bf} const*, "
                  f"{bf} const*, {bf}*, {ns}Unpacked, mg::Coef<{ns}Nb>, "
                  f"{ns}LegGeom)") == {"native restriction"}
    for cols in (1, 2):
        assert groups(f"void {ns}native_prolong_add_kernel<{cols}>({bf} "
                      f"const*, {bf} const*, {bf}*, int, int)") == {
            "native prolongation"}
    for name, group in (("native_rbgs_kernel", "native sweeps"),
                        ("native_jacobi_kernel", "native sweeps"),
                        ("native_residual_kernel", "native kernels"),
                        ("native_restrict_kernel<true>",
                         "native restriction"),
                        ("native_prolong_kernel<true>",
                         "native prolongation"),
                        ("native_restrict_kernel", "native restriction"),
                        ("native_prolong_kernel", "native prolongation")):
        assert groups(f"void {ns}{name}({bf} const*, {bf} const*, {bf}*, "
                      "int)") == {group}
