"""The bfloat16 storage modes of the port's remaining _cdt kernels against
the JAX package's Pallas kernels in interpret mode: the packed shard
tile's residual, apply and norm (kernels/plocal2d.py), the whole packed
grid's norm (kernels/packed2d.py) and the blocked-ELL SpMM and SpMV
(kernels/bell.py).

JAX's ``_cdt`` rule: u, b, A and Xt stored in bfloat16, each load widened
to float32, sigma and 1/h^2 float32, each output point rounded once to
bfloat16 (nearest even), the norms a float32 sum. On a CPU tensor each
wrapper takes its plain version, which chip_smoke.py holds the CUDA
kernels against on the card. Inputs are made with numpy from a seed,
rounded to bfloat16 and carried across by ``convert`` (whose bfloat16
repair is tested here too).

Tolerances (tests/test_torch_mixed.py's rule): a bfloat16 output lies
within one bfloat16 ulp of JAX's plus BF16_SCALE_TOL of the field's
largest value at every point (both evaluate in float32, in other orders,
and round once), and at most BF16_SHARE of the points differ at all; a
float32 norm within NORM_RTOL of JAX's (the port sums in float32 on the
CPU and float64 on the card, JAX in float32). The plocal2d norm is held at
m = 64 only, one JAX window: past it the JAX norm counts the last window's
overlap rows twice (ROADMAP.md queue 3, F1).
"""
import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from multigridcmt_tpu.kernels import bell as jbell
from multigridcmt_tpu.kernels import packed2d as jpacked2d
from multigridcmt_tpu.kernels import plocal2d as jplocal2d
from multigridcmt_tpu_torch import convert
from multigridcmt_tpu_torch.kernels import bell, local2d, packed2d, plocal2d
from test_torch_bell import _block_random
from test_torch_mixed import _jpack, _padded, _tpack
from test_torch_plocal2d import Tile

BF16_SCALE_TOL = 1e-5
BF16_SHARE = 1e-3
NORM_RTOL = 1e-5
SIGMA = 11.5
BF = torch.bfloat16
JBF = jnp.bfloat16


def _bf16_close(got, want):
    """got (a bfloat16 tensor) against want (JAX's bfloat16 output as a
    float64 numpy array) by the module's rule."""
    assert got.dtype == BF
    g = got.double().numpy()
    want = np.asarray(want, dtype=np.float64)
    assert g.shape == want.shape
    diff = np.abs(g - want)
    _, ex = np.frexp(want)
    ulp = np.where(want != 0, np.ldexp(1.0, ex - 8), 0.0)
    assert np.all(diff <= ulp + BF16_SCALE_TOL * np.abs(want).max())
    assert np.mean(diff > 0) <= BF16_SHARE


def _norm_close(got, want):
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.item(), float(want), rtol=NORM_RTOL)


def _plocal2d_launches():
    return (plocal2d.residual_launches, plocal2d.apply_launches,
            plocal2d.resnorm_launches, plocal2d.residual_bf16_launches,
            plocal2d.apply_bf16_launches, plocal2d.resnorm_bf16_launches)


def _bf16_tile(t):
    """A Tile's u and b rounded to bfloat16: JAX's packed tiles and the
    port's, carried across by convert."""
    uj, bj = (t.jax_packed(a).astype(JBF) for a in (t.ue, t.be))
    su, sb = t.from_jax(uj), t.from_jax(bj)
    assert su.dtype == sb.dtype == BF
    return (uj, bj), (su, sb)


def test_convert_carries_bfloat16_bits():
    """A JAX bfloat16 array arrives with its bits: zeros of both signs,
    subnormals, the extremes and infinities; so do a packed tile and a
    BELL matrix's blocks."""
    rng = np.random.default_rng(3)
    special = np.array([0.0, -0.0, 1e-40, -3e-39, 3.3e38, -3.3e38, np.inf,
                        -np.inf], dtype=ml_dtypes.bfloat16)
    a = np.concatenate([special, rng.standard_normal(120).astype(
        ml_dtypes.bfloat16)]).reshape(2, 4, 16)
    for t in (convert._tensor(jnp.asarray(a), "cpu"),
              convert.packed_tile_from_jax(jnp.asarray(a), 4, 31,
                                           device="cpu")):
        assert t.dtype == BF
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      a.view(np.int16))
    a_sp = _block_random(2, 2, 0.6, 4)
    ja = jbell.bell_from_scipy(a_sp, dtype=JBF)
    c = convert.bell_from_jax(ja, device="cpu")
    assert c.data.dtype == BF
    np.testing.assert_array_equal(c.data.view(torch.int16).numpy(),
                                  np.asarray(ja.data).view(np.int16))
    np.testing.assert_array_equal(c.cols.numpy(), np.asarray(ja.cols))


# k = 8, m = 128: rows and 2x2 blocks, ranks 0 and 1, sigma 0 and 11.5.
TILES = {
    "rows-rank0": ((255, 2, 0, 0, 0), 0.0),
    "rows-rank1": ((255, 2, 1, 0, 0), SIGMA),
    "block-00": ((255, 2, 0, 2, 0), SIGMA),
    "block-11": ((255, 2, 1, 2, 1), 0.0),
}


@pytest.mark.parametrize("func", ["residual", "apply_op"])
@pytest.mark.parametrize("name", list(TILES))
def test_plocal2d_bf16_matches_pallas(name, func):
    """The packed tile's bfloat16 residual and apply: float32 arithmetic,
    r rounded once, as JAX's kernels (plocal2d.py:201-202, :917-918); the
    whole tile, pad lanes and ring zero as the float modes'."""
    (n, dr, r, dc, c), sigma = TILES[name]
    t = Tile(n, dr, r, dc, c, seed=9)
    (uj, bj), (su, sb) = _bf16_tile(t)
    offs = (t.row_off, t.col_off)
    if func == "residual":
        got = plocal2d.residual(su, sb, n, t.h, *offs, sigma=sigma)
        want = jplocal2d.residual(uj, bj, n, t.h, *offs, sigma=sigma)
    else:
        got = plocal2d.apply_op(su, n, t.h, *offs, sigma=sigma)
        want = jplocal2d.apply_op(uj, n, t.h, *offs, sigma=sigma)
    assert got.shape == (2, t.rows, (t.cols + 1) // 2)
    _bf16_close(got[t.owned], t.from_jax(want)[t.owned].double().numpy())
    u = plocal2d.unpack_ext(got, t.cols, t.cpar)
    assert torch.equal(plocal2d.pack_ext(u, t.cpar), got)
    assert not u[0].any() and not u[-1].any()
    assert not u[:, 0].any() and not u[:, -1].any()
    assert _plocal2d_launches() == (0,) * 6


@pytest.mark.parametrize("n,dr,r,dc,c", [
    (255, 4, 1, 0, 0),          # rows, m = 64
    (127, 2, 1, 2, 1),          # blocks, m = 64
])
def test_plocal2d_bf16_norm_matches_pallas(n, dr, r, dc, c):
    """The owned-box norm of bfloat16 tiles is a float32 sum, as JAX's,
    red only and on both planes, at sigma 0 and 11.5."""
    t = Tile(n, dr, r, dc, c, seed=10)
    (uj, bj), (su, sb) = _bf16_tile(t)
    offs = (t.row_off, t.col_off)
    for red_only, sigma in ((False, 0.0), (True, SIGMA)):
        kw = dict(mcol=t.mcol, red_only=red_only, sigma=sigma)
        _norm_close(plocal2d.residual_norm_sq(su, sb, n, t.h, t.m, *offs,
                                              **kw),
                    jplocal2d.residual_norm_sq(uj, bj, n, t.h, t.m, *offs,
                                               **kw))
    assert _plocal2d_launches() == (0,) * 6


@pytest.mark.parametrize("n", [61, 63])
def test_packed2d_bf16_norm_matches_pallas(n):
    """The whole packed grid's norm of bfloat16 grids: a float32 sum, as
    JAX's (packed2d.py:534), red only and full, at sigma 0 and 11.5."""
    rng = np.random.default_rng(500 + n)
    h = 1.0 / (n + 1)
    su, sb = _tpack(_padded(rng, n)), _tpack(_padded(rng, n) / h ** 2)
    uj, bj = _jpack(su), _jpack(sb)
    for red_only, sigma in ((False, SIGMA), (True, 0.0), (True, SIGMA)):
        _norm_close(packed2d.residual_norm_sq(su, sb, n, h,
                                              red_only=red_only,
                                              sigma=sigma),
                    jpacked2d.residual_norm_sq(uj, bj, n, h,
                                               red_only=red_only,
                                               sigma=sigma))
    assert (packed2d.resnorm_launches, packed2d.resnorm_bf16_launches) == (
        0, 0)


@pytest.mark.parametrize("m", [8, 16])
def test_bell_bf16_matches_pallas(m):
    """The bfloat16 SpMM on a 300 x 260 matrix of 3 x 3 blocks with kmax
    padded past its densest block row: products and sums in float32, Yt
    rounded once, as JAX's (bell.py:54-59, :195); at m = 8 also the SpMV
    carrier."""
    a_sp = _block_random(3, 3, 0.5, 41 + m, 300, 260)
    need = jbell.bell_from_scipy(a_sp).kmax
    ja = jbell.bell_from_scipy(a_sp, dtype=JBF, kmax=need + 1)
    a = convert.bell_from_jax(ja, device="cpu")
    rng = np.random.default_rng(m)
    xt = np.zeros((m, 3 * 128), ml_dtypes.bfloat16)
    xt[:, :260] = rng.standard_normal((m, 260))
    got = bell.spmm(a, convert._tensor(jnp.asarray(xt), "cpu"))
    want = jbell.spmm(ja, jnp.asarray(xt))
    assert want.dtype == JBF and got.shape == want.shape == (m, 3 * 128)
    _bf16_close(got, np.asarray(want.astype(jnp.float32)))
    assert not got[:, 300:].any()
    if m == 8:
        x = xt[0, :260]
        got = bell.spmv(a, convert._tensor(jnp.asarray(x), "cpu"))
        want = jbell.spmv(ja, jnp.asarray(x))
        assert got.shape == (300,)
        _bf16_close(got, np.asarray(want.astype(jnp.float32)))
    assert (bell.launches, bell.bf16_launches) == (0, 0)


def _spread_tile(seed):
    """A row tile of 63^2 (m = 32) in bfloat16 whose values span many
    binades, so that rounding after every operation parts from rounding
    once."""
    rng = np.random.default_rng(seed)
    t = Tile(63, 2, 1, 0, 0, seed=seed)
    scale = np.exp2(rng.integers(-12, 12, size=t.ue.shape))
    ue, be = (torch.from_numpy(a * scale).to(BF) for a in (t.ue, t.be))
    return t, ue, be


def test_plocal2d_plain_versions_round_once():
    """The bfloat16 plain versions compute in float32 from widened tiles
    and round once: bit for bit float32's result rounded, and not the
    all-bfloat16 computation (local2d.residual_plain on bfloat16 tiles,
    the native rule of the next slice)."""
    t, ue, be = _spread_tile(11)
    offs = (t.row_off, t.col_off)
    su, sb = plocal2d.pack_ext(ue, 0), plocal2d.pack_ext(be, 0)
    for sigma in (0.0, SIGMA):
        r32 = local2d.residual_plain(ue.float(), be.float(), t.n, t.h,
                                     *offs, sigma=sigma)
        once = plocal2d.pack_ext(r32, 0).to(BF)
        native = plocal2d.pack_ext(local2d.residual_plain(
            ue, be, t.n, t.h, *offs, sigma=sigma), 0)
        got = plocal2d.residual(su, sb, t.n, t.h, *offs, sigma=sigma)
        assert got.dtype == BF and torch.equal(got, once)
        assert not torch.equal(got, native)
        a32 = local2d.residual_plain(ue.float(), torch.zeros_like(
            ue, dtype=torch.float32), t.n, t.h, *offs, sigma=sigma)
        applied = plocal2d.apply_op(su, t.n, t.h, *offs, sigma=sigma)
        assert torch.equal(applied, (-plocal2d.pack_ext(a32, 0)).to(BF))
        norm = plocal2d.residual_norm_sq(su, sb, t.n, t.h, t.m, *offs,
                                         sigma=sigma)
        owned = r32[plocal2d.HALO_ROWS:plocal2d.HALO_ROWS + t.m]
        assert norm.dtype == torch.float32
        assert torch.equal(norm, torch.sum(owned * owned))
    assert _plocal2d_launches() == (0,) * 6


def test_bf16_modes_refuse_float32_partners():
    """bfloat16 storage is all or nothing: a float32 b, Xt or data beside
    bfloat16 raises ValueError and launches nothing."""
    t, ue, be = _spread_tile(12)
    su = plocal2d.pack_ext(ue, 0)
    with pytest.raises(ValueError):
        plocal2d.residual(su, su.float(), t.n, t.h, t.row_off)
    with pytest.raises(ValueError):
        plocal2d.residual_norm_sq(su, su.float(), t.n, t.h, t.m, t.row_off)
    a = bell.bell_from_scipy(_block_random(2, 2, 0.6, 4), dtype=BF,
                             device="cpu")
    with pytest.raises(ValueError):
        bell.spmm(a, torch.zeros((8, 256)))
    with pytest.raises(ValueError):
        bell.spmm(dataclasses.replace(a, data=a.data.float()),
                  torch.zeros((8, 256), dtype=BF))
    assert _plocal2d_launches() == (0,) * 6
    assert (bell.launches, bell.bf16_launches) == (0, 0)
