"""The native bfloat16 RB-GS sweeps of a whole grid and the native residual
restriction on the row stream (csrc/stencil2d_sweep_native_bf16.cu: the
sweep stream with the native arithmetic; csrc/transfer2d_native_bf16.cu:
the down stream at no sweeps, with no store of u' and no sigma u term)
emulated on the CPU.

The CUDA kernels run only on the card. Here tests/test_torch_packed.py's
step-by-step emulation of their schedule (tagged window slots, NaN at the
shuffle edges and in dead ring slots, rows read only after they are loaded,
each output point written exactly once) runs in its native mode on the
unpacked frame (``LegFrame.whole(n, unpacked=True)``), as
tests/test_torch_native_legs_stream.py runs it for the fused legs: the
sweep stream ("sweep" geometry) and the down stream with ``fine`` False and
``shift`` False. Each is held bit for bit against
``native_bf16.sweep_plain`` and ``residual_restrict_plain(..., shift=False)``
(which tests/test_torch_native_bf16.py and test_torch_native_bf16_legs.py
hold against JAX's kernels in interpret mode): the sweep at n = 7 (the
launch's own geometry), 31 (segments of 10 rows) and 255 (segments of 64:
several strips, the last partial, and chunks with no row tests), every nu
from 1 to 4, sigma 0 and 11.5; the restriction at the same sizes. Two
cases pin the dropped sigma u term: a residual of -0 at points where u > 0
(b = -0 on a constant u: -0 + 0 u would give +0) and +-Inf and NaN in u
(0 Inf would give NaN); the emulated stream keeps the plain version's bits,
NaN where it has NaN. Inputs: N(0, 1) values (b scaled by 1/h^2) made with
numpy from a seed and rounded to bfloat16. The wrappers' route on a CUDA
tensor (the device rule faked) is one launch of each new entry point;
Jacobi and a shard's tile keep ``native2d_sweep``.
"""
import numpy as np
import pytest
import torch

from multigridcmt_tpu_torch.kernels import (fused2d, local2d, native_bf16,
                                           stencil2d, transfer2d)
from test_torch_packed import LegFrame, _emulate_leg, _nat

SIGMAS = (0.0, 11.5)
# (n, segment rows): the launch's own geometry; short segments; at 255
# segments of 64 rows (several strips and segments, steady chunks).
SIZES = {7: None, 31: 10, 255: 64}
NUS = (1, 2, 3, 4)
# The Jacobi stream: every nu up to the sweep stream's cap at 7 and 31, the
# cap alone at 255; omega as the bfloat16 solves' Jacobi levels take it.
JACOBI_NUS = tuple(range(1, stencil2d.max_fused_sweeps("jacobi") + 1))
OMEGA = {"rbgs": 1.0, "jacobi": 0.8}


def _padded(rng, n, scale=1.0):
    a = np.zeros((n + 2, n + 2), dtype=np.float32)
    a[1:-1, 1:-1] = rng.standard_normal((n, n)) * scale
    return _nat(a)


def _inputs(n, seed):
    """u and b of 1/h^2 size, bfloat16 values in float32 arrays."""
    rng = np.random.default_rng(seed)
    return _padded(rng, n), _padded(rng, n, float((n + 1) ** 2))


def _geometry(leg, n, sweeps, kind="rbgs"):
    seg = SIZES[n]
    with pytest.MonkeyPatch.context() as mp:
        if seg is not None:
            mp.setattr(fused2d, "MIN_SEG", seg)
        g = fused2d.leg_geometry(leg, n, kind, sweeps)
    assert seg is None or g.seg == seg
    return g


def _same_bits(got: np.ndarray, want: torch.Tensor) -> None:
    """got (the emulation's output, bfloat16 values in a float array)
    equals want (a bfloat16 tensor) bit for bit, -0 and +-Inf included;
    NaN exactly where want has NaN (a NaN's payload aside)."""
    w = want.float().numpy()
    g = np.asarray(got, dtype=np.float32)
    nan = np.isnan(w)
    assert np.array_equal(np.isnan(g), nan)
    assert np.array_equal(g.view(np.uint32)[~nan], w.view(np.uint32)[~nan])


def _sweep(u, b, n, sigma, nu, kind="rbgs"):
    """(emulated stream, plain version) of nu native sweeps of ``kind``."""
    h = 1.0 / (n + 1)
    omega = OMEGA[kind]
    g = _geometry("sweep", n, nu, kind)
    with np.errstate(invalid="ignore", over="ignore"):
        got = _emulate_leg(g, kind, nu, u, b, h, sigma, omega,
                           frame=LegFrame.whole(n, unpacked=True),
                           native=True)
    c = native_bf16.constants(h, sigma, omega)
    want = native_bf16.sweep_plain(kind, torch.from_numpy(u).bfloat16(),
                                   torch.from_numpy(b).bfloat16(), n, c, nu)
    return got, want


def _restrict(u, b, n):
    """(emulated stream, plain version) of the native residual
    restriction."""
    h = 1.0 / (n + 1)
    g = _geometry("down", n, 0)
    with np.errstate(invalid="ignore", over="ignore"):
        got = _emulate_leg(g, "rbgs", 0, u, b, h, 0.0, 1.0,
                           frame=LegFrame.whole(n, unpacked=True),
                           native=True, fine=False, shift=False)
    want = native_bf16.residual_restrict_plain(
        torch.from_numpy(u).bfloat16(), torch.from_numpy(b).bfloat16(), n,
        native_bf16.constants(h), False)
    return got, want


@pytest.mark.parametrize("n,nu,sigma", [(n, nu, sigma) for n in SIZES
                                        for nu in NUS for sigma in SIGMAS])
def test_native_sweep_stream_equals_plain(n, nu, sigma):
    u, b = _inputs(n, 9000 + 10 * n + nu)
    _same_bits(*_sweep(u, b, n, sigma, nu))


@pytest.mark.parametrize("n,nu,sigma", [
    (n, nu, sigma) for n in (7, 31) for nu in JACOBI_NUS for sigma in SIGMAS]
    + [(255, JACOBI_NUS[-1], sigma) for sigma in SIGMAS])
def test_native_jacobi_stream_equals_plain(n, nu, sigma):
    """The Jacobi kind of the sweep stream (T = Nb, K = nu stages, each
    reading the last one's window) equals nu plain native Jacobi sweeps, bit
    for bit."""
    u, b = _inputs(n, 9200 + 10 * n + nu)
    _same_bits(*_sweep(u, b, n, sigma, nu, "jacobi"))


@pytest.mark.parametrize("n", list(SIZES))
def test_native_restrict_stream_equals_plain(n):
    u, b = _inputs(n, 9500 + n)
    _same_bits(*_restrict(u, b, n))


def _signed_zero_inputs(n):
    """u = 1 and b = -0 on a block of the interior (elsewhere N(0, 1)
    values): there au = +0 exactly, so the residual b - au is -0 at points
    where u > 0, and so is every coarse point whose 3 x 3 fine points lie
    in the block."""
    u, b = _inputs(n, 9700 + n)
    u[4:n - 3, 4:n - 3] = 1.0
    b[5:n - 4, 5:n - 4] = -0.0
    return u, b


def _nonfinite_inputs(n):
    """N(0, 1) values with +Inf, -Inf and NaN in u's interior."""
    u, b = _inputs(n, 9800 + n)
    u[n // 3, n // 2] = np.inf
    u[2 * n // 3, 7] = -np.inf
    u[n // 2, n - 3] = np.nan
    return u, b


@pytest.mark.parametrize("case", ["signed zero", "nonfinite"])
def test_native_restrict_stream_drops_the_shift(case):
    """The stream's residual has no sigma u term, and at sigma = 0 that
    shows in the bits: the emulation equals the plain version without the
    term and parts from the one with it (-0 against +0 at the block's
    coarse points; the Inf points' residual -+Inf against NaN)."""
    n = 31
    u, b = (_signed_zero_inputs if case == "signed zero"
            else _nonfinite_inputs)(n)
    got, want = _restrict(u, b, n)
    _same_bits(got, want)
    if case == "signed zero":
        w = want.float().numpy()
        neg = np.signbit(w) & (w == 0)
        assert neg.sum() >= 9
        shifted = native_bf16.residual_restrict_plain(
            torch.from_numpy(u).bfloat16(), torch.from_numpy(b).bfloat16(),
            n, native_bf16.constants(1.0 / (n + 1)), True).float().numpy()
        assert not np.signbit(shifted[neg]).any()
    else:
        assert np.isnan(got).any() and np.isinf(got).any()
        # The fine residual itself: the plain version's without the term
        # is -Inf at the +Inf point, with it NaN.
        c = native_bf16.constants(1.0 / (n + 1))
        tu, tb = torch.from_numpy(u).bfloat16(), torch.from_numpy(b).bfloat16()
        ct = native_bf16._tensors(c, "cpu")
        i, j = n // 3, n // 2
        assert native_bf16._residual_vals(tu, tb, ct, False)[i, j] == \
            -float("inf")
        assert native_bf16._residual_vals(tu, tb, ct, True)[i, j].isnan()


def _nonfinite_sweep(kind, sigma, nu):
    n = 31
    u, b = _nonfinite_inputs(n)
    got, want = _sweep(u, b, n, sigma, nu, kind)
    assert np.isnan(got).any()
    _same_bits(got, want)


@pytest.mark.parametrize("sigma", SIGMAS)
def test_native_sweep_stream_nonfinite(sigma):
    """NaN and +-Inf in u spread through the stencil as in the plain
    version: NaN exactly where it has NaN, every other bit equal."""
    _nonfinite_sweep("rbgs", sigma, 4)


@pytest.mark.parametrize("sigma", SIGMAS)
def test_native_jacobi_stream_nonfinite(sigma):
    """The Jacobi kind at its cap on the same inputs: NaN exactly where the
    plain version has NaN, every other bit equal."""
    _nonfinite_sweep("jacobi", sigma, JACOBI_NUS[-1])


def test_native_stream_cases_exercise_the_stream():
    """At 255 the cases run several strips (the last partial) and
    segments, and chunks with no row tests; at 31 several segments."""
    n = 255
    u, b = _inputs(n, 1)
    g = _geometry("sweep", n, 4)
    _emulate_leg(g, "rbgs", 4, u, b, 1.0 / (n + 1), 0.0, 1.0,
                 frame=LegFrame.whole(n, unpacked=True), native=True)
    assert g.strips > 1 and g.strips * g.strip > g.lanes and g.segs > 1
    assert _emulate_leg.steady_steps > 0
    g = _geometry("down", n, 0)
    _emulate_leg(g, "rbgs", 0, u, b, 1.0 / (n + 1), 0.0, 1.0,
                 frame=LegFrame.whole(n, unpacked=True), native=True,
                 fine=False, shift=False)
    assert g.strips > 1 and g.segs > 1 and _emulate_leg.steady_steps > 0
    assert _geometry("sweep", 31, 4).segs > 1
    assert _geometry("down", 31, 0).segs > 1


def _fake_card(monkeypatch):
    """The device rule faked (every tensor 'on the card') and the launches
    recorded; the counters zeroed."""
    calls = []
    monkeypatch.setattr(native_bf16, "on_cuda", lambda t: True)
    monkeypatch.setattr(native_bf16, "launch_on",
                        lambda t, kernel, *args, writes=(): calls.append(
                            (kernel, args, writes)))
    monkeypatch.setattr(fused2d, "_launch_geometry",
                        lambda lg, n, kind, nu, t: fused2d.leg_geometry(
                            lg, n, kind, nu).ints())
    for mod, name in ((stencil2d, "rbgs_bf16_launches"),
                      (stencil2d, "jacobi_bf16_launches"),
                      (local2d, "rbgs_bf16_launches"),
                      (local2d, "jacobi_bf16_launches"),
                      (transfer2d, "residual_restrict_bf16_launches")):
        monkeypatch.setattr(mod, name, 0)
    return calls


def _off_pair(n):
    flat = torch.zeros((n + 2) ** 2 + 1, dtype=torch.bfloat16)
    return flat[1:].view(n + 2, n + 2)          # off a 4-byte pair


@pytest.mark.parametrize("nu", NUS)
def test_native_rbgs_sweep_launches_the_stream(nu, monkeypatch):
    """A bfloat16 stencil2d.rbgs_sweep on a CUDA tensor is one launch of
    the stream's entry point with the host's constants, the sweeps and
    fused2d's sweep geometry, on arrays that start on a 4-byte
    pair (an input off one is copied), counted once."""
    calls = _fake_card(monkeypatch)
    n, h, sigma = 31, 1.0 / 32, 11.5
    u, b = _off_pair(n), torch.zeros((n + 2, n + 2), dtype=torch.bfloat16)
    stencil2d.rbgs_sweep(u, b, n, h, sigma=sigma, sweeps=nu)
    (kernel, args, writes), = calls
    assert kernel == "stencil2d_sweep_native"
    assert all(p % 4 == 0 for p in args[:3]) and u.data_ptr() not in args
    assert args[3:] == (n, *native_bf16.constants(h, sigma), nu,
                        fused2d.leg_geometry("sweep", n, "rbgs", nu).ints())
    assert [w.dtype for w in writes] == [torch.bfloat16]
    assert (stencil2d.rbgs_bf16_launches,
            stencil2d.jacobi_bf16_launches) == (1, 0)


def test_native_residual_restrict_launches_the_stream(monkeypatch):
    """A bfloat16 transfer2d.residual_restrict on a CUDA tensor is one
    launch of the stream's entry point with 1/h^2 and the zero-sweep down
    leg's geometry, on arrays that start on a 4-byte pair, counted once."""
    calls = _fake_card(monkeypatch)
    n, h = 31, 1.0 / 32
    u, b = _off_pair(n), torch.zeros((n + 2, n + 2), dtype=torch.bfloat16)
    rc = transfer2d.residual_restrict(u, b, n, h)
    (kernel, args, writes), = calls
    assert kernel == "native2d_residual_restrict"
    assert all(p % 4 == 0 for p in args[:2]) and u.data_ptr() not in args
    assert args[2] == rc.data_ptr()
    assert args[3:] == (n, native_bf16.constants(h).inv_h2,
                        fused2d.leg_geometry("down", n, "rbgs", 0).ints())
    assert writes == (rc,) and rc.shape == (17, 17)
    assert transfer2d.residual_restrict_bf16_launches == 1


def test_native_jacobi_and_tiles_keep_their_kernels(monkeypatch):
    """The Jacobi sweeps of a whole grid (stencil2d's, and local2d's handed
    a whole grid at (0, 0)) are one launch each of the Jacobi stream's entry
    point with the host's constants and fused2d's Jacobi sweep geometry, on
    arrays that start on a 4-byte pair, and allocate no scratch grid; the
    RB-GS and Jacobi sweeps of a shard's tile at an offset still launch
    native2d_sweep (csrc/native_bf16.cu)."""
    calls = _fake_card(monkeypatch)
    allocs = []
    empty_like = torch.empty_like
    monkeypatch.setattr(native_bf16.torch, "empty_like",
                        lambda t: allocs.append(t.shape) or empty_like(t))
    n, h, sigma = 31, 1.0 / 32, 11.5
    u = _off_pair(n)
    stencil2d.jacobi_sweep(u, u.clone(), n, h, 0.8, sigma=sigma, sweeps=8)
    local2d.jacobi_sweep(u.clone(), u.clone(), n, h, 0.8, 0, 0, sweeps=3)
    assert allocs == [(n + 2, n + 2)] * 2          # u' alone, no scratch
    ue = torch.zeros((24, n + 2), dtype=torch.bfloat16)
    local2d.rbgs_sweep(ue, ue.clone(), n, h, -7, 0, sweeps=3)
    local2d.jacobi_sweep(ue, ue.clone(), n, h, 0.8, -7, 0, sweeps=3)
    assert [k for k, *_ in calls] == ["stencil2d_jacobi_native"] * 2 + [
        "native2d_sweep"] * 2
    (_, args, writes) = calls[0]
    assert all(p % 4 == 0 for p in args[:3]) and u.data_ptr() not in args
    assert args[3:] == (n, *native_bf16.constants(h, sigma, 0.8), 8,
                        fused2d.leg_geometry("sweep", n, "jacobi", 8).ints())
    assert [w.dtype for w in writes] == [torch.bfloat16]
    assert calls[1][1][3:] == (n, *native_bf16.constants(h, 0.0, 0.8), 3,
                               fused2d.leg_geometry("sweep", n, "jacobi",
                                                    3).ints())
    assert calls[2][1][4:9] == (24, n + 2, n, -7, 0)
    assert calls[3][1][4:9] == (24, n + 2, n, -7, 0)
    assert (stencil2d.jacobi_bf16_launches, local2d.jacobi_bf16_launches,
            local2d.rbgs_bf16_launches, stencil2d.rbgs_bf16_launches) == (
        1, 2, 1, 0)
