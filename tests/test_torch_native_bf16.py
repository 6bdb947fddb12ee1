"""The native bfloat16 modes of the port (kernels/native_bf16.py through
stencil2d's and local2d's residual and sweeps; kernels/spmv.py) against the
JAX package's Pallas kernels in interpret mode, bit for bit.

JAX computes these kernels in bfloat16 itself: sigma arrives as a bfloat16
array, every Python constant is rounded to bfloat16 where it meets one, and
every + - x / rounds to bfloat16 in the source's order. On a CPU tensor
each wrapper takes its native plain version (each operation a bfloat16
PyTorch op), which chip_smoke.py holds the CUDA kernels against on the
card, bit for bit. Inputs are made with numpy from a seed, rounded to
bfloat16 with ml_dtypes and carried to both packages unchanged (JAX's
arrays through ``convert``, whose bfloat16 repair is tested here too).

Cases: stencil2d at n = 127 (three JAX row tiles), sigma 0 and 11.5, the
largest fused sweep counts (RB-GS 4, Jacobi 8, omega 0.8 and 2/3); local2d
on rank 0 of a 2-way row split of 255^2 (m = 128: three JAX row tiles,
row_off = -7) and a block tile of a 4x2 split of 127^2 (col_off = 57,
odd), compared on the owned points (the JAX kernels roll the tile's edge
rows round; 8 ghost rows cover 4 RB-GS or 8 Jacobi sweeps); the DIA SpMV
in 2D at n = 127 and 3D at n = 63 (R = 1960 packed rows, several 512-row
JAX tiles) with random bfloat16 diagonals. A pin shows that the constant
rounding matters: the plain versions with unrounded constants (what a
bfloat16 tensor times a Python float computes) part from JAX.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from multigridcmt_tpu.grids import from_aligned, to_aligned
from multigridcmt_tpu.kernels import local2d as jlocal2d
from multigridcmt_tpu.kernels import spmv as jspmv
from multigridcmt_tpu.kernels import stencil2d as jstencil2d
from multigridcmt_tpu.ops import sparse as jsparse
from multigridcmt_tpu_torch import convert
from multigridcmt_tpu_torch.kernels import local2d, native_bf16, spmv, \
    stencil2d
from test_torch_local2d import HH, embed

BF = ml_dtypes.bfloat16
SIGMA = 11.5
N2 = 127
STENCIL_CASES = [("residual", 0.0, None), ("residual", SIGMA, None),
                 ("rbgs", 0.0, None), ("rbgs", SIGMA, None),
                 ("jacobi", 0.0, 0.8), ("jacobi", SIGMA, 0.8),
                 ("jacobi", 0.0, 2 / 3), ("jacobi", SIGMA, 2 / 3)]
# name -> (n, row ranks, row rank, col ranks, col rank), as
# test_torch_local2d.TILES.
TILES = {"rows2-rank0": (255, 2, 0, 0, 0), "block4x2-31": (127, 4, 3, 2, 1)}
LOCAL_CASES = [(t, mode, sigma) for t in TILES
               for mode in ("residual", "rbgs", "jacobi")
               for sigma in (0.0, SIGMA)]
OMEGA = 0.8
SPMV_CASES = [(127, 2), (63, 3)]


def _counts():
    return (stencil2d.launches, stencil2d.rbgs_launches,
            stencil2d.jacobi_launches, stencil2d.residual_bf16_launches,
            stencil2d.rbgs_bf16_launches, stencil2d.jacobi_bf16_launches,
            local2d.residual_launches, local2d.rbgs_launches,
            local2d.jacobi_launches, local2d.residual_bf16_launches,
            local2d.rbgs_bf16_launches, local2d.jacobi_bf16_launches,
            spmv.launches, spmv.bf16_launches)


def _grids(n, seed):
    """bfloat16 (ml_dtypes) u and b (b of 1/h^2 size) on the padded n^2
    grid, zero ghosts."""
    rng = np.random.default_rng(seed)
    u, b = (np.zeros((n + 2, n + 2)) for _ in range(2))
    u[1:-1, 1:-1] = rng.standard_normal((n, n))
    b[1:-1, 1:-1] = rng.standard_normal((n, n)) * (n + 1) ** 2
    return u.astype(BF), b.astype(BF)


def _same_bits(got: torch.Tensor, want) -> None:
    """got (a bfloat16 tensor) equals JAX's bfloat16 want bit for bit."""
    w = convert._tensor(want, "cpu")
    assert got.dtype == w.dtype == torch.bfloat16
    assert got.shape == w.shape
    differ = int((got.view(torch.int16) != w.view(torch.int16)).sum())
    assert differ == 0, f"{differ} of {got.numel()} differ"


def _stencil(mode, u, b, n, h, sigma, omega, ports: bool):
    """One stencil2d mode at its largest fused sweep count, through the
    port's wrapper (``ports``) or JAX's."""
    mod = stencil2d if ports else jstencil2d
    if mode == "residual":
        return mod.residual(u, b, n, h, sigma=sigma)
    if mode == "rbgs":
        return mod.rbgs_sweep(u, b, n, h, sigma=sigma,
                              sweeps=stencil2d.max_fused_sweeps("rbgs"))
    return mod.jacobi_sweep(u, b, n, h, omega, sigma=sigma,
                            sweeps=stencil2d.max_fused_sweeps("jacobi"))


@pytest.mark.parametrize("mode,sigma,omega", STENCIL_CASES)
def test_stencil2d_native_matches_jax(mode, sigma, omega):
    n, h = N2, 1.0 / (N2 + 1)
    ub, bb = _grids(n, 3)
    before = _counts()
    got = _stencil(mode, convert._tensor(ub, "cpu"),
                   convert._tensor(bb, "cpu"), n, h, sigma, omega, True)
    want = _stencil(mode, to_aligned(jnp.asarray(ub)),
                    to_aligned(jnp.asarray(bb)), n, h, sigma, omega, False)
    _same_bits(got, from_aligned(want, n))
    assert _counts() == before


class Tile:
    """One rank's extended bfloat16 tiles of u and b, for the port and,
    embedded in JAX's (16j, 128j) layout, for JAX."""

    def __init__(self, name):
        n, dr, r, dc, c = TILES[name]
        self.n, self.h = n, 1.0 / (n + 1)
        m = (n + 1) // dr
        mcol = (n + 1) // dc if dc else 0
        self.offs = (r * m + 1 - HH, c * mcol + 1 - HH if dc else 0)
        cols = mcol + 2 * HH if dc else n + 2
        self.owned = (slice(HH, HH + m),
                      slice(HH, HH + mcol) if dc else slice(None))
        u, b = _grids(n, n + r + c)
        rows = local2d.ext_rows(m)
        rr = np.arange(rows) + self.offs[0]
        cc = np.arange(cols) + self.offs[1]
        okr = (rr >= 0) & (rr < n + 2)
        okc = (cc >= 0) & (cc < n + 2)
        self.ue, self.be = (np.zeros((rows, cols), dtype=BF)
                            for _ in range(2))
        for t, g in ((self.ue, u), (self.be, b)):
            t[np.ix_(okr, okc)] = g[np.ix_(rr[okr], cc[okc])]
        self.cols = cols

    def ports(self):
        return (convert._tensor(self.ue, "cpu"),
                convert._tensor(self.be, "cpu"))

    def jaxes(self):
        return [embed(a, jlocal2d.ext_rows(a.shape[0] - 2 * HH))
                for a in (self.ue, self.be)]

    def owned_of(self, a):
        rows, cols = self.owned
        return np.asarray(a)[:, : self.cols][rows, cols]


def _local(mode, u, b, t, sigma, ports: bool):
    mod = local2d if ports else jlocal2d
    if mode == "residual":
        return mod.residual(u, b, t.n, t.h, *t.offs, sigma=sigma)
    if mode == "rbgs":
        return mod.rbgs_sweep(u, b, t.n, t.h, *t.offs, sigma=sigma,
                              sweeps=local2d.max_fused_sweeps("rbgs"))
    return mod.jacobi_sweep(u, b, t.n, t.h, OMEGA, *t.offs, sigma=sigma,
                            sweeps=local2d.max_fused_sweeps("jacobi"))


@pytest.mark.parametrize("name,mode,sigma", LOCAL_CASES)
def test_local2d_native_matches_jax(name, mode, sigma):
    t = Tile(name)
    before = _counts()
    got = _local(mode, *t.ports(), t, sigma, True)
    want = _local(mode, *t.jaxes(), t, sigma, False)
    rows, cols = t.owned
    _same_bits(got[rows, cols].contiguous(), t.owned_of(want))
    assert _counts() == before


def _dia(n, ndim, seed):
    """A JAX DIA of the Poisson operator's offsets with random bfloat16
    diagonals, and a random bfloat16 x."""
    band = jsparse.laplacian_dia(n, ndim, 1.0 / (n + 1), jnp.float32)
    rng = np.random.default_rng(seed)
    size = band.shape[0]
    diags = rng.standard_normal((len(band.offsets), size)).astype(BF)
    x = rng.standard_normal(size).astype(BF)
    return (jsparse.DIA(jnp.asarray(diags), band.offsets, band.shape),
            jnp.asarray(x))


@pytest.mark.parametrize("n,ndim", SPMV_CASES)
def test_spmv_native_matches_jax(n, ndim):
    ja, jx = _dia(n, ndim, n + ndim)
    a, x = convert.dia_from_jax(ja, device="cpu"), convert._tensor(jx, "cpu")
    before = _counts()
    got = spmv.spmv_dia(a, x)
    assert _counts() == before
    _same_bits(got, jspmv.spmv_dia(ja, jx))
    # The packed form: the skirts too, chained once more.
    jpk = jspmv.pack_dia(ja)
    pk = convert.packed_dia_from_jax(jpk, device="cpu")
    jy = jspmv.spmv_packed(jpk, jspmv.pack_x(jx, jpk.halo))
    y = spmv.spmv_packed(pk, spmv.pack_x(x, pk.halo))
    _same_bits(y, jy)
    _same_bits(spmv.spmv_packed(pk, y), jspmv.spmv_packed(jpk, jy))
    if ndim == 3:
        assert pk.diags.shape[1] > 512


def _unrounded(h, sigma, omega):
    """native_bf16._tensors with the constants as Python floats in double:
    each bfloat16 op then computes with the scalar unrounded."""
    def tensors(c, device):
        return {"h2": h * h, "inv_h2": 1.0 / (h * h), "sig": sigma,
                "inv_den": 1.0 / (4.0 - sigma * h * h),
                "coef": omega / (4.0 / (h * h) - sigma), "four": 4.0}
    return tensors


# (mode, sigma) where the rounding of a constant shows: Jacobi's coef at
# sigma 11.5 (omega / (4/h^2 - sigma) with omega and 4/h^2 - sigma rounded
# first), and sigma itself in the residual where bfloat16 does not hold
# it.
PIN_CASES = [("jacobi", SIGMA), ("residual", 11.3)]


@pytest.mark.parametrize("mode,sigma", PIN_CASES)
def test_constant_rounding_is_pinned(mode, sigma, monkeypatch):
    """JAX rounds sigma and the Python constants to bfloat16 before use;
    the plain versions with the constants unrounded part from it."""
    n, h = N2, 1.0 / (N2 + 1)
    ub, bb = _grids(n, 5)
    u, b = convert._tensor(ub, "cpu"), convert._tensor(bb, "cpu")
    want = convert._tensor(from_aligned(_stencil(
        mode, to_aligned(jnp.asarray(ub)), to_aligned(jnp.asarray(bb)), n, h,
        sigma, OMEGA, False), n), "cpu")
    assert torch.equal(_stencil(mode, u, b, n, h, sigma, OMEGA, True), want)
    monkeypatch.setattr(native_bf16, "_tensors", _unrounded(h, sigma, OMEGA))
    off = _stencil(mode, u, b, n, h, sigma, OMEGA, True)
    assert off.dtype == torch.bfloat16
    assert int((off.view(torch.int16) != want.view(torch.int16)).sum()) > 0


def test_constants_follow_jax_order():
    """The host's constants at n = 127, sigma 11.5, omega 0.8: each
    operation rounded to bfloat16 (inv_den rounds to 1/4: 4 - sigma h^2
    is 4 in bfloat16)."""
    h = 1.0 / 128
    c = native_bf16.constants(h, SIGMA, OMEGA)
    bf = [float(np.float32(v).astype(BF)) for v in c]
    assert list(c) == bf
    assert c.h2 == h * h and c.inv_h2 == 128.0 ** 2 and c.sig == SIGMA
    assert c.inv_den == 0.25
    assert c.coef == float(np.float32(np.float32(0.8).astype(BF)
                                      / np.float32(65536.0 - 11.5)
                                      .astype(BF)).astype(BF))


def test_convert_carries_bfloat16():
    """JAX's bfloat16 arrays cross through ``convert`` bit for bit: a grid,
    a DIA matrix and its packed form."""
    ub, _ = _grids(15, 9)
    got = convert._tensor(jnp.asarray(ub), "cpu")
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy(),
                          ub.view(np.int16))
    ja, _ = _dia(15, 2, 1)
    a = convert.dia_from_jax(ja, device="cpu")
    assert a.diags.dtype == torch.bfloat16
    assert np.array_equal(a.diags.view(torch.int16).numpy(),
                          np.asarray(ja.diags).view(np.int16))
    pk = convert.packed_dia_from_jax(jspmv.pack_dia(ja), device="cpu")
    assert torch.equal(pk.diags.view(torch.int16),
                       spmv.pack_dia(a).diags.view(torch.int16))
