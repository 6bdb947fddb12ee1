"""The native bfloat16 prolongation-add of transfer2d
(csrc/transfer2d_prolong_native_bf16.cu, native_prolong_add_kernel: a
thread a word of two fine rows) emulated on the CPU.

The CUDA kernel runs only on the card. Here a numpy model of its
thread-to-block map runs thread by thread, as the kernel's code does: the
row pair I and word J of each thread, the word indices of x and out it
touches (the even row's word J of row pair I at word I C + J, the odd
row's at I C + nc + 1 + J, the grid's last point a half word), the two
aligned words of e it loads a coarse row (coarse columns J - 1 .. J + 1 of
coarse rows I and I + 1, shifted by the first one's parity) and the
float32 arithmetic with each average and the add rounded to bfloat16
once. At n = 3, 5, 7, 31, 63 and 255 every fine point of the (n+2)^2 grid
is written exactly once, every word access starts on an
even element (a 4-byte word: the odd pitch alternates the pairing by row)
and lies inside its array, and the result equals
``native_bf16.prolong_add_plain(..., rows_first=False)`` (which
tests/test_torch_native_bf16_legs.py holds against JAX's transfer2d kernel
in interpret mode) bit for bit; also with NaN and +-Inf in x and e. Inputs:
N(0, 1) values made with numpy from a seed, rounded to bfloat16, on the
grids' rings too (a ring point written as x + P e would show). The
wrapper's route on a CUDA tensor (the device rule faked) is one launch of
the new entry point, counted once.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from multigridcmt_tpu_torch.kernels import _build, native_bf16, transfer2d
from test_torch_packed import _average, _nat

SOURCE = _build.CSRC / "transfer2d_prolong_native_bf16.cu"
SIZES = (3, 5, 7, 31, 63, 255)


def _padded(rng, n):
    """N(0, 1) values on the whole (n+2)^2 grid, its ring too: the kernel
    keeps x's ring and reads e's, whatever they hold."""
    return _nat(rng.standard_normal((n + 2, n + 2)).astype(np.float32))


def _inputs(n, seed, nonfinite=False):
    """x on the (n+2)^2 grid and e on the coarse one, bfloat16 values in
    float32 arrays; with ``nonfinite`` each holds NaN and +-Inf."""
    rng = np.random.default_rng(seed)
    x, e = _padded(rng, n), _padded(rng, (n - 1) // 2)
    if nonfinite:
        for a in (x, e):
            m = a.shape[0] - 2
            a[m // 3 + 1, m // 2 + 1] = np.nan
            a[2 * m // 3 + 1, 1] = np.inf
            a[m // 2 + 1, m] = -np.inf
    return x, e


class _Words:
    """A flat array of bfloat16 values read and written as the kernel does:
    words of two elements at an even index, or one element alone; each
    access asserted aligned and inside the array, each write counted."""

    def __init__(self, a):
        self.a = a.reshape(-1)
        self.writes = np.zeros(self.a.size, dtype=np.int64)

    def word(self, w):
        i = 2 * w
        assert 0 <= i and i + 1 < self.a.size
        return self.a[i], self.a[i + 1]

    def half(self, i):
        assert 0 <= i < self.a.size
        return self.a[i]

    def put(self, w, lo, hi):
        i = 2 * w
        assert 0 <= i and i + 1 < self.a.size
        self.a[i], self.a[i + 1] = lo, hi
        self.writes[i:i + 2] += 1

    def put_half(self, i, v):
        assert 0 <= i < self.a.size
        self.a[i] = v
        self.writes[i] += 1


def _coarse_word(e, w):
    """coarse_word: the word at element 2 w, the last element's half word
    alone (high half 0), 0 off the array."""
    i = 2 * w
    if 0 <= i and i + 1 < e.a.size:
        return e.word(w)
    if 0 <= i < e.a.size:
        return e.half(i), np.float32(0)
    return np.float32(0), np.float32(0)


def _coarse_three(e, I, J, Cc):
    """coarse_three: coarse row I's values at columns J - 1 .. J + 1 from
    two words."""
    q = I * Cc + J - 1
    s = q & 1
    w0 = (q - s) // 2
    a, b = _coarse_word(e, w0), _coarse_word(e, w0 + 1)
    return [a[0], a[1], b[0]] if s == 0 else [a[1], b[0], b[1]]


def _add(xv, pe, inside):
    """x + P e rounded once where inside, x's value elsewhere."""
    return _nat(np.float32(xv) + np.float32(pe)) if inside else xv


def _emulate(x, e, n):
    """The kernel's threads on x and e (bfloat16 values in float32 arrays):
    (out, each fine point's writes)."""
    nc = (n - 1) // 2
    Cc, C = nc + 2, n + 2
    xs, es = _Words(x.copy()), _Words(e.copy())
    out = _Words(np.full(C * C, np.nan, dtype=np.float32))
    for t in range(Cc * Cc):
        I, J = divmod(t, Cc)
        even = I * C
        odd = even + nc + 1
        v0 = _coarse_three(es, I, J, Cc)
        v1 = _coarse_three(es, I + 1, J, Cc)
        row_even = 1 <= I <= nc
        if J <= nc:
            lo, hi = xs.word(even + J)
            out.put(even + J, _add(lo, v0[1], row_even and J >= 1),
                    _add(hi, _average(v0[1], v0[2]), row_even))
        if I <= nc:
            lo, hi = xs.word(odd + J)
            odd_lo = _average(_average(v0[0], v0[1]),
                              _average(v1[0], v1[1]))
            out.put(odd + J, _add(lo, odd_lo, J >= 1),
                    _add(hi, _average(v0[1], v1[1]), 1 <= J <= nc))
        if I == nc + 1 and J == 0:
            out.put_half(2 * odd, xs.half(2 * odd))
    return out.a.reshape(C, C), out.writes.reshape(C, C)


def _plain(x, e, n):
    return native_bf16.prolong_add_plain(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(e).bfloat16(), n,
        (n - 1) // 2, False).float().numpy()


def _same_bits(got, want):
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(got.view(np.uint32)[~nan],
                          want.view(np.uint32)[~nan])


@pytest.mark.parametrize("n", SIZES)
def test_prolong_block_map_writes_each_point_once(n):
    """Every fine point written exactly once, every access aligned and in
    its array, and the bits of the plain version."""
    x, e = _inputs(n, 6000 + 10 * n)
    got, writes = _emulate(x, e, n)
    assert (writes == 1).all()
    _same_bits(got, _plain(x, e, n))


@pytest.mark.parametrize("n", (31, 63))
def test_prolong_block_map_nonfinite(n):
    """NaN and +-Inf in x and e: NaN exactly where the plain version has
    it, every other bit equal (the ghosts keep x's bits)."""
    x, e = _inputs(n, 6500 + n, nonfinite=True)
    with np.errstate(invalid="ignore"):
        got, writes = _emulate(x, e, n)
    assert (writes == 1).all() and np.isnan(got).any()
    _same_bits(got, _plain(x, e, n))


def test_prolong_kernel_is_one_instance():
    """One kernel, a thread a word of two fine rows: no template, no column
    count in the entry point, and a thread for each of the (nc + 2)^2 words
    of a row pair's rows."""
    text = SOURCE.read_text()
    assert "template" not in text and "cols" not in text
    assert len(re.findall(r"__global__", text)) == 1
    assert re.search(r"words = .*\(n - 1\) / 2 \+ 2\) \*\s*"
                     r"\(\(n - 1\) / 2 \+ 2\);", text)


def test_prolong_add_launches_the_block_kernel(monkeypatch):
    """A bfloat16 transfer2d.prolong_add on a CUDA tensor is one launch of
    the block kernel's entry point with n, on arrays that
    start on a 4-byte word (an input off one is copied), counted once."""
    from multigridcmt_tpu_torch.kernels import fused2d

    calls = []
    monkeypatch.setattr(native_bf16, "on_cuda", lambda t: True)
    monkeypatch.setattr(native_bf16, "launch_on",
                        lambda t, kernel, *args, writes=(): calls.append(
                            (kernel, args, writes)))
    monkeypatch.setattr(transfer2d, "prolong_add_bf16_launches", 0)
    n, nc = 31, 15
    flat = torch.zeros((n + 2) ** 2 + 1, dtype=torch.bfloat16)
    x = flat[1:].view(n + 2, n + 2)                 # off a 4-byte word
    e = torch.zeros((nc + 2, nc + 2), dtype=torch.bfloat16)
    out = transfer2d.prolong_add(x, e, n, nc)
    (kernel, args, writes), = calls
    assert kernel == "transfer2d_prolong_add_native"
    assert all(p % 4 == 0 for p in args[:3]) and x.data_ptr() not in args
    assert args[2] == out.data_ptr() and args[3:] == (n,)
    assert writes == (out,) and out.shape == x.shape
    assert transfer2d.prolong_add_bf16_launches == 1
    assert fused2d._on_pair(e) is e


def test_prolong_entry_point_is_registered():
    """The block kernel's C entry point replaces native_bf16.cu's."""
    assert _build.SIGNATURES["mg_transfer2d_prolong_add_native_bf16"] == [
        _build._P, _build._P, _build._P, _build._I, _build._P]
    assert "mg_native2d_prolong_add_bf16" not in _build.SIGNATURES
    old = Path(_build.CSRC, "native_bf16.cu").read_text()
    assert "native_prolong_kernel" not in old and "interpolate" not in old
