"""The bfloat16 residual of a whole packed grid on words of two lanes
(csrc/packed_tile.cuh's presidual_pairs_kernel), emulated on the CPU.

The CUDA kernel cannot run here, so these tests replay its indexing:
grid row y = 2 i + c (plane c's row i), the thread's word f and its lanes
a = 2f + p and a + 1 (p = (c + i) & 1, the row's phase, which with cp odd
is also the parity of the row's first index, plane 1's offset R cp being
odd), its six aligned 32-bit loads of the flat arrays (u's word, b's, the
other plane's rows i - 1 and i + 1 at the same lanes and its row i at
lanes a - 1 and a + 1; each load asserted even and inside the array), the
row's odd lane (the first thread's: the last lane when p = 0, lane 0 when
p = 1), ghost rows without loads, and a store of every point exactly once.
Inputs are bfloat16 values with random ghosts and NaN pad lanes (which no
updated point may read). The emulation computes in float32 in the
kernel's order and is held bit for bit against an emulation of the scalar
kernel it replaces (presidual_kernel, a thread a lane; numpy does not
contract into FMAs, so the two agree exactly) and against the plain
version by the bfloat16 rule of tests/test_torch_packed.py.
"""
import numpy as np
import pytest
import torch

from multigridcmt_tpu_torch.kernels import packed2d

SIGMA = 11.5


def _bits(a):
    """float32 values -> bfloat16 bits (to nearest even), uint32."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(
        np.uint16).astype(np.uint32)


def _widen(bits):
    return (bits.astype(np.uint32) << np.uint32(16)).view(np.float32)


def _low(w):
    return (w << np.uint32(16)).view(np.float32)


def _high(w):
    return (w & np.uint32(0xFFFF0000)).view(np.float32)


def _coef(h, sigma):
    """Coef<float>::make's inv_h2 and sigma."""
    return np.float32(1.0 / (h * h)), np.float32(sigma)


def _point(v, bv, up, down, same, side, inv_h2, sig):
    """presidual_kernel's arithmetic at one point, in float32."""
    au = (np.float32(4.0) * v - (((up + down) + same) + side)) * inv_h2
    return bv - au + sig * v


def _inputs(n, seed):
    """Packed bfloat16 u and b (uint16 bits, (2, n + 2, cp)): random
    points, ghosts included, pad lanes NaN."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((n + 2, n + 2))
    b = rng.standard_normal((n + 2, n + 2)) * (n + 1) ** 2
    out = []
    for g in (u, b):
        s = packed2d.pack(torch.from_numpy(g).float()).to(torch.bfloat16)
        bits = s.view(torch.int16).numpy().view(np.uint16).copy()
        if (n + 2) % 2:        # the last lane of a phase-1 row is a pad
            pad = np.zeros(bits.shape, dtype=bool)
            for c in (0, 1):
                pad[c, (1 - c)::2, -1] = True
            bits[pad] = 0x7FC0
        out.append(bits)
    return out


def _emulate_pairs(u16, b16, n, h, sigma):
    """presidual_pairs_kernel on packed bits; returns (r as float32 values
    of its bfloat16 bits, writes a point)."""
    _, R, cp = u16.shape
    assert cp % 2 == 1 and R % 2 == 1
    fu, fb = u16.reshape(-1).astype(np.uint32), b16.reshape(-1).astype(
        np.uint32)
    total = fu.size
    inv_h2, sig = _coef(h, sigma)
    out = np.full(total, np.nan, dtype=np.float32)
    writes = np.zeros(total, dtype=int)
    words = (cp - 1) // 2
    f = np.arange(words)
    plane = R * cp

    def word(a, e):
        assert np.all(e % 2 == 0) and np.all(e >= 0) \
            and np.all(e + 1 < total)
        return a[e] | (a[e + 1] << np.uint32(16))

    def store(e, v):
        out[e] = _widen(_bits(v))
        writes[e] += 1

    for y in range(2 * R):              # blockIdx.y
        c, i = y & 1, y >> 1
        p = (c + i) & 1
        row, orow = c * plane + i * cp, (1 - c) * plane + i * cp
        lane = 2 * f + p
        inner = 1 <= i <= n
        r0 = r1 = np.zeros(words, dtype=np.float32)
        if inner:
            w, wb = word(fu, row + lane), word(fb, row + lane)
            up = word(fu, orow - cp + lane)
            down = word(fu, orow + cp + lane)
            lo, hi = word(fu, orow + lane - 1), word(fu, orow + lane + 1)
            x0 = 2 * lane + p
            r0 = np.where((x0 >= 1) & (x0 <= n), _point(
                _low(w), _low(wb), _low(up), _low(down), _high(lo),
                _low(hi) if p else _low(lo), inv_h2, sig), 0.0)
            r1 = np.where(x0 + 2 <= n, _point(
                _high(w), _high(wb), _high(up), _high(down), _low(hi),
                _high(hi) if p else _high(lo), inv_h2, sig), 0.0)
        store(row + lane, r0)
        store(row + lane + 1, r1)
        r = np.float32(0.0)
        if p and inner:
            r = _point(*(_widen(a[k]) for a, k in (
                (fu, row), (fb, row), (fu, orow - cp), (fu, orow + cp),
                (fu, orow), (fu, orow + 1))), inv_h2, sig)
        store(np.array([row + (0 if p else cp - 1)]), np.array([r]))
    return out.reshape(u16.shape), writes.reshape(u16.shape)


def _emulate_scalar(u16, b16, n, h, sigma):
    """presidual_kernel (a thread a lane, S = bfloat16) on packed bits."""
    _, R, cp = u16.shape
    u, b = _widen(u16), _widen(b16)
    inv_h2, sig = _coef(h, sigma)
    i = np.arange(R)[None, :, None]
    lane = np.arange(cp)[None, None, :]
    c = np.arange(2)[:, None, None]
    p = (c + i) & 1
    x = 2 * lane + p
    upd = (i >= 1) & (i <= n) & (x >= 1) & (x <= n)
    o = u[::-1]                               # the other plane
    pad = np.pad(o, ((0, 0), (1, 1), (1, 1)))  # zeros off the array
    up, down = pad[:, :-2, 1:-1], pad[:, 2:, 1:-1]
    side = np.where(p == 1, pad[:, 1:-1, 2:], pad[:, 1:-1, :-2])
    with np.errstate(invalid="ignore"):
        r = _point(u, b, up, down, o, side, inv_h2, sig)
    return _widen(_bits(np.where(upd, r, 0.0)))


def _bf16_rule(got, want):
    """Every point within one bfloat16 ulp of want plus 1e-5 of its
    largest value; the share of points that differ at all."""
    assert np.isfinite(got).all()
    diff = np.abs(got.astype(np.float64) - want)
    _, ex = np.frexp(want)
    ulp = np.where(want != 0, np.ldexp(1.0, ex - 8), 0.0)
    assert np.all(diff <= ulp + 1e-5 * np.abs(want).max())
    return np.mean(diff > 0)


@pytest.mark.parametrize("sigma", [0.0, SIGMA])
@pytest.mark.parametrize("n", [3, 31, 127, 511])
def test_paired_residual_matches_scalar_and_plain(n, sigma):
    """n = 2^k - 1 (cp odd: the layout pairs) from one word a row to 128,
    several blocks a row at 511: every point written once, bit for bit
    the scalar kernel's, the plain version by the bfloat16 rule, ghosts
    and pad lanes 0 on both planes."""
    u16, b16 = _inputs(n, seed=n + 7)
    h = 1.0 / (n + 1)
    ut, bt = (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
              for a in (u16, b16))
    assert packed2d.residual_pairs(ut, bt, torch.empty_like(ut))
    got, writes = _emulate_pairs(u16, b16, n, h, sigma)
    assert (writes == 1).all()
    np.testing.assert_array_equal(got, _emulate_scalar(u16, b16, n, h,
                                                       sigma))
    mask = packed2d.pack(torch.ones((n + 2, n + 2))).numpy() > 0
    inner = packed2d.pack(torch.nn.functional.pad(
        torch.ones((n, n)), (1, 1, 1, 1))).numpy() > 0
    assert np.all(got[~inner] == 0.0) and mask.sum() == (n + 2) ** 2
    want = packed2d.residual_plain(ut, bt, n, h, sigma=sigma)
    assert _bf16_rule(got, want.double().numpy()) <= 1e-3


def test_layouts_that_do_not_pair():
    """n = 1 mod 4 (cp even) or an array off a 4-byte word takes the
    scalar kernel: residual_pairs, the launcher's rule, says so."""
    for n, want in ((29, False), (13, False), (15, True), (4095, True)):
        s = torch.zeros(packed2d.packed_shape(n), dtype=torch.bfloat16)
        assert packed2d.residual_pairs(s, s, s) is want
    s = torch.zeros(packed2d.packed_shape(15), dtype=torch.bfloat16)
    off = torch.zeros(s.numel() + 1, dtype=torch.bfloat16)[1:].view(s.shape)
    assert not packed2d.residual_pairs(s, s, off)
    assert not packed2d.residual_pairs(off, s, s)
