"""The plain versions of the port's colour-packed shard kernels
(kernels/plocal2d.py) against the JAX plocal2d kernels in interpret mode,
on the same float64 tiles cut from a global 255^2 grid made from a numpy
seed.

k = 8, m = 128 owned rows: a tile of 144 rows spans more than one of the
JAX kernels' windows (64 fine rows and their halos). Tiles: ranks 0 and 1
of a row split (columns unsharded, packing phase cpar 0) and of a 2x2
block split (odd column offset, cpar 1). JAX packs the tile embedded in its
(16j, 128j) layout; ``convert.packed_tile_from_jax`` carries its packed
inputs and outputs across. Owned regions are compared, to 1e-13 * 4^k (the
residuals scale with 1/h^2), the JAX package's own tolerance.

The norm is held against the port's own packed residual and a sum of
squares over the owned points at m = 128 and 256: the JAX norm counts the
last window's overlap rows twice once a tile spans several windows
(ROADMAP.md queue 3, F1), so it is compared only at m = 64, a single
window, where it is exact.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigridcmt_tpu.kernels import local2d as jlocal2d
from multigridcmt_tpu.kernels import plocal2d as jplocal2d
from multigridcmt_tpu_torch import convert
from multigridcmt_tpu_torch.kernels import plocal2d

HH = plocal2d.HALO_ROWS
OMEGA = 0.8
SIGMA = 3.7

# name -> (n, rows ranks, row rank, col ranks, col rank, kind, sweeps,
# sigma); col ranks 0: a row decomposition. Rows and blocks each see both
# smoothers and both shifts, at the legs' sweep caps and below.
CASES = {
    "rows-rank0": (255, 2, 0, 0, 0, "rbgs", 2, 0.0),
    "rows-rank1": (255, 2, 1, 0, 0, "jacobi", 6, SIGMA),
    "block-00": (255, 2, 0, 2, 0, "jacobi", 2, 0.0),
    "block-11": (255, 2, 1, 2, 1, "rbgs", 3, SIGMA),
}
FUNCS = ("down_leg", "up_leg", "residual", "apply_op")


class Tile:
    """A global padded grid pair (u, b) from a numpy seed and one rank's
    extended tile of each: unpacked, packed by the port, and packed by
    JAX from its embedded layout."""

    def __init__(self, n, dr, r, dc, c, seed=0):
        self.n, self.h = n, 1.0 / (n + 1)
        self.m = (n + 1) // dr
        self.mcol = (n + 1) // dc if dc else 0
        self.row_off = r * self.m + 1 - HH
        self.col_off = c * self.mcol + 1 - HH if dc else 0
        self.cols = self.mcol + 2 * HH if dc else n + 2
        self.rows = self.m + 2 * HH
        self.cpar = 1 if dc else 0
        rng = np.random.default_rng(seed + n + 7 * r + c + dc)
        u, b = (np.zeros((n + 2, n + 2)) for _ in range(2))
        u[1:-1, 1:-1] = rng.standard_normal((n, n))
        b[1:-1, 1:-1] = rng.standard_normal((n, n)) * (n + 1) ** 2
        self.ue, self.be = self.cut(u), self.cut(b)
        lanes = slice(HH // 2, HH // 2 + self.mcol // 2) if dc \
            else slice(None)
        self.owned = (slice(None), slice(HH, HH + self.m), lanes)

    def cut(self, g):
        """The extended tile of grid g: zeros off the grid."""
        out = np.zeros((self.rows, self.cols))
        r = np.arange(self.rows) + self.row_off
        c = np.arange(self.cols) + self.col_off
        ok_r = (r >= 0) & (r < g.shape[0])
        ok_c = (c >= 0) & (c < g.shape[1])
        out[np.ix_(ok_r, ok_c)] = g[np.ix_(r[ok_r], c[ok_c])]
        return out

    def jax_packed(self, a):
        """JAX's packed tile of unpacked tile a, embedded in (16j, 128j)."""
        rows = jlocal2d.ext_rows(self.m)
        c128 = -(-a.shape[1] // 128) * 128
        emb = np.pad(a, ((0, rows - a.shape[0]), (0, c128 - a.shape[1])))
        return jplocal2d.pack_ext(jnp.asarray(emb), self.cpar)

    def from_jax(self, s):
        return convert.packed_tile_from_jax(s, self.rows, self.cols,
                                            device="cpu")

    def coarse_shape(self):
        return (self.m // 2 + 2 * HH,
                self.mcol // 2 + 2 * HH if self.mcol else (self.n - 1) // 2
                + 2)


@functools.cache
def _case(name):
    """(tile, port inputs, JAX inputs, coarse correction) of one case."""
    n, dr, r, dc, c, *_ = CASES[name]
    t = Tile(n, dr, r, dc, c)
    uj, bj = t.jax_packed(t.ue), t.jax_packed(t.be)
    su, sb = t.from_jax(uj), t.from_jax(bj)
    # The port packs the same tile into the same lanes.
    for port, ext in ((su, t.ue), (sb, t.be)):
        assert torch.equal(port, plocal2d.pack_ext(torch.from_numpy(ext),
                                                   t.cpar))
    e = np.random.default_rng(n + r + c).standard_normal(t.coarse_shape())
    return t, (su, sb), (uj, bj), e


@functools.cache
def _results(name, func):
    """(port output, JAX output) of one function on one case; JAX runs
    once per case and function."""
    t, (su, sb), (uj, bj), e = _case(name)
    *_, kind, nu, sigma = CASES[name]
    offs = (t.row_off, t.col_off)
    leg = dict(kind=kind, omega=OMEGA, sweeps=nu, sigma=sigma, mcol=t.mcol)
    if func == "down_leg":
        return (plocal2d.down_leg(su, sb, t.n, t.h, t.m, *offs, **leg),
                jplocal2d.down_leg(uj, bj, t.n, t.h, t.m, *offs, **leg))
    if func == "up_leg":
        nc = (t.n - 1) // 2
        rows = jlocal2d.ext_rows(t.m // 2)
        ej = jnp.asarray(np.pad(e, ((0, rows - e.shape[0]),
                                    (0, -(-e.shape[1] // 128) * 128
                                     - e.shape[1]))))
        return (plocal2d.up_leg(su, torch.from_numpy(e), sb, t.n, nc, t.h,
                                t.m, *offs, **leg),
                jplocal2d.up_leg(uj, ej, bj, t.n, nc, t.h, t.m, *offs,
                                 **leg))
    if func == "residual":
        return (plocal2d.residual(su, sb, t.n, t.h, *offs, sigma=sigma),
                jplocal2d.residual(uj, bj, t.n, t.h, *offs, sigma=sigma))
    return (plocal2d.apply_op(su, t.n, t.h, *offs, sigma=sigma),
            jplocal2d.apply_op(uj, t.n, t.h, *offs, sigma=sigma))


def check_owned(got, want_jax, t):
    want = t.from_jax(want_jax)
    assert got.shape == want.shape == (2, t.rows, (t.cols + 1) // 2)
    err = (got[t.owned] - want[t.owned]).abs().max().item()
    assert err <= 1e-13 * 4.0 ** 8, err


@pytest.mark.parametrize("func", FUNCS)
@pytest.mark.parametrize("name", list(CASES))
def test_matches_jax(name, func):
    t = _case(name)[0]
    got, want = _results(name, func)
    if func != "down_leg":
        check_owned(got, want, t)
        return
    (gu, grc), (wu, wrc) = got, want
    check_owned(gu, wu, t)
    # The whole coarse tile, in local2d's unpacked extended convention:
    # owned rows, ghosts zero in both (JAX's padding is zero too).
    wrc = np.asarray(wrc)
    rows, cols = grc.shape
    assert (rows, cols) == t.coarse_shape()
    err = np.abs(grc.numpy() - wrc[:rows, :cols]).max()
    assert err <= 1e-13 * 4.0 ** 8, err
    assert not grc[:HH].any() and not grc[rows - HH:].any()
    assert not wrc[rows:].any() and not wrc[:, cols:].any()


@pytest.mark.parametrize("name", list(CASES))
def test_outputs_keep_pad_lanes_and_ring(name):
    """The residual and apply are zero off the owned grid's interior
    (pad lanes, the tile's ring); every output is finite."""
    t = _case(name)[0]
    for func in ("residual", "apply_op"):
        got = _results(name, func)[0]
        u = plocal2d.unpack_ext(got, t.cols, t.cpar)
        assert torch.equal(plocal2d.pack_ext(u, t.cpar), got)
        assert not u[0].any() and not u[-1].any()
        assert not u[:, 0].any() and not u[:, -1].any()
        assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("n,dr,r,dc,c", [
    (255, 2, 1, 0, 0),          # rows, m = 128
    (255, 1, 0, 0, 0),          # rows, m = 256
    (255, 2, 0, 2, 1),          # blocks, m = 128
    (511, 2, 1, 2, 0),          # blocks, m = 256
])
@pytest.mark.parametrize("red_only", [False, True])
def test_norm_counts_each_owned_point_once(n, dr, r, dc, c, red_only):
    """||r||^2 over the owned points equals the port's packed residual
    squared and summed over the owned lanes of both planes (red only: plane
    0), to rtol 1e-12, at tiles deeper than one JAX window."""
    t = Tile(n, dr, r, dc, c, seed=5)
    su, sb = (plocal2d.pack_ext(torch.from_numpy(a), t.cpar)
              for a in (t.ue, t.be))
    got = plocal2d.residual_norm_sq(su, sb, n, t.h, t.m, t.row_off,
                                    t.col_off, mcol=t.mcol,
                                    red_only=red_only, sigma=SIGMA)
    res = plocal2d.residual(su, sb, n, t.h, t.row_off, t.col_off,
                            sigma=SIGMA)[t.owned]
    want = torch.sum(res[0] ** 2) if red_only else torch.sum(res ** 2)
    assert got.shape == ()
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-12)


@pytest.mark.parametrize("n,dr,r,dc,c", [
    (255, 4, 1, 0, 0),          # rows, m = 64
    (127, 2, 1, 2, 1),          # blocks, m = 64
])
def test_norm_matches_jax_in_one_window(n, dr, r, dc, c):
    """At m = 64 the tile is one JAX window and the JAX norm is exact."""
    t = Tile(n, dr, r, dc, c, seed=6)
    su, sb = (plocal2d.pack_ext(torch.from_numpy(a), t.cpar)
              for a in (t.ue, t.be))
    uj, bj = t.jax_packed(t.ue), t.jax_packed(t.be)
    for red_only in (False, True):
        got = plocal2d.residual_norm_sq(su, sb, n, t.h, t.m, t.row_off,
                                        t.col_off, mcol=t.mcol,
                                        red_only=red_only)
        want = jplocal2d.residual_norm_sq(uj, bj, n, t.h, t.m, t.row_off,
                                          t.col_off, mcol=t.mcol,
                                          red_only=red_only)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-12)


@pytest.mark.parametrize("cpar,cols", [(0, 33), (0, 34), (1, 40), (1, 41)])
def test_pack_ext_round_trip_and_phase(cpar, cols):
    """unpack(pack(ua)) == ua; plane 0 holds the red points ((i + j) even
    in global indices; row_off is odd, col_off's parity is cpar) and
    plane 1 the black ones; an odd width leaves one zero pad lane a row in
    one plane."""
    rows, row_off = 24, -7
    col_off = -7 if cpar else 0
    gi = torch.arange(rows)[:, None] + row_off
    gj = torch.arange(cols)[None, :] + col_off
    colour = ((gi + gj) % 2).to(torch.float64)
    ua = colour + 1.0          # 1 at red points, 2 at black ones
    s = plocal2d.pack_ext(ua, cpar)
    assert s.shape == (2, rows, (cols + 1) // 2)
    assert torch.equal(plocal2d.unpack_ext(s, cols, cpar), ua)
    pads = 2 * rows * ((cols + 1) // 2) - rows * cols
    assert int((s == 0).sum()) == pads
    assert bool(((s[0] == 1) | (s[0] == 0)).all())
    assert bool(((s[1] == 2) | (s[1] == 0)).all())
    noise = torch.randn(rows, cols, dtype=torch.float64,
                        generator=torch.Generator().manual_seed(cols))
    s = plocal2d.pack_ext(noise, cpar)
    assert torch.equal(plocal2d.pack_ext(plocal2d.unpack_ext(s, cols, cpar),
                                         cpar), s)


def test_packed_tile_from_jax_rejects_small_tiles():
    with pytest.raises(ValueError):
        convert.packed_tile_from_jax(np.zeros((2, 10, 8)), 16, 10,
                                     device="cpu")
