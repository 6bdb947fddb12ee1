"""The plain versions of the port's shard-local kernels (kernels/local2d.py)
against the JAX local2d kernels in interpret mode, on the same float64
tiles cut from a global grid made from a numpy seed.

Tiles: a row decomposition's rank 0 (negative row offset) and a rank of a
2-way split of 255^2 with m = 128 owned rows (several of the JAX kernels'
row tiles: _T_DN = 64, _T_UP = 48), and block tiles of 2x2 and 4x2 meshes
(the last one holds the grid's far ghost as a dead entry). The port keeps
the tile at its logical extent; the JAX kernels get it embedded in their
(16j, 128j) zero-padded layout. Owned regions are compared, to 1e-12 of
the largest reference value.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigridcmt_tpu.kernels import local2d as jlocal2d
from multigridcmt_tpu_torch.kernels import local2d
from multigridcmt_tpu_torch.ops import smoothers

HH = local2d.HALO_ROWS
OMEGA = 0.8
SIGMA = 3.7
RTOL = 1e-12

# name -> (n, rows ranks, row rank, col ranks, col rank); col ranks 0: a
# row decomposition (columns unsharded).
TILES = {
    "rows4-rank0": (63, 4, 0, 0, 0),
    "rows2-m128": (255, 2, 1, 0, 0),
    "block2x2-10": (63, 2, 1, 2, 0),
    "block4x2-31": (127, 4, 3, 2, 1),
}


class Tile:
    """A global padded grid pair (u, b) and one rank's extended tile of
    each, for the port and, embedded, for JAX."""

    def __init__(self, name, seed=0):
        n, dr, r, dc, c = TILES[name]
        self.n, self.h = n, 1.0 / (n + 1)
        self.m = (n + 1) // dr
        self.mcol = (n + 1) // dc if dc else 0
        self.row_off = r * self.m + 1 - HH
        self.col_off = c * self.mcol + 1 - HH if dc else 0
        self.cols = self.mcol + 2 * HH if dc else n + 2
        rng = np.random.default_rng(seed + n + r + c)
        self.u, self.b = (np.zeros((n + 2, n + 2)) for _ in range(2))
        self.u[1:-1, 1:-1] = rng.standard_normal((n, n))
        self.b[1:-1, 1:-1] = rng.standard_normal((n, n)) * (n + 1) ** 2
        self.owned = (slice(HH, HH + self.m),
                      slice(HH, HH + self.mcol) if dc else slice(None))

    def cut(self, g, rows, row0, cols, col0):
        """Rows row0.., cols col0.. of grid g, zeros off the grid."""
        out = np.zeros((rows, cols))
        r = np.arange(rows) + row0
        c = np.arange(cols) + col0
        ok_r = (r >= 0) & (r < g.shape[0])
        ok_c = (c >= 0) & (c < g.shape[1])
        out[np.ix_(ok_r, ok_c)] = g[np.ix_(r[ok_r], c[ok_c])]
        return out

    def ext(self, g):
        return self.cut(g, local2d.ext_rows(self.m), self.row_off, self.cols,
                        self.col_off)

    def ports(self, *arrays):
        return [torch.from_numpy(a) for a in arrays]

    def jaxes(self, *arrays):
        return [embed(a, jlocal2d.ext_rows(a.shape[0] - 2 * HH))
                for a in arrays]


def embed(a, rows):
    """The JAX kernels' layout: rows padded to ``rows``, columns to a
    multiple of 128, with zeros."""
    c128 = -(-a.shape[1] // 128) * 128
    return jnp.asarray(np.pad(a, ((0, rows - a.shape[0]),
                                  (0, c128 - a.shape[1]))))


def owned_diff(got, want, t):
    """(max |got - want|, max |want|) over the owned region of tile t; want
    may carry the JAX layout's padding."""
    rows, cols = t.owned
    g = np.asarray(got)[rows, cols]
    w = np.asarray(want)[rows, : t.cols][:, cols]
    return np.abs(g - w).max(), np.abs(w).max()


def check(got, want, t):
    err, scale = owned_diff(got, want, t)
    assert err <= RTOL * scale, (err, scale)


@pytest.mark.parametrize("name,sigma", [("rows4-rank0", 0.0),
                                        ("rows2-m128", SIGMA),
                                        ("block2x2-10", SIGMA),
                                        ("block4x2-31", 0.0)])
def test_sweeps_and_residual_match_jax(name, sigma):
    """The most sweeps one launch fuses (RB-GS 4, Jacobi 8), and the
    residual."""
    t = Tile(name)
    ue, be = t.ext(t.u), t.ext(t.b)
    (u, b), (uj, bj) = t.ports(ue, be), t.jaxes(ue, be)
    args = (t.n, t.h)
    offs = (t.row_off, t.col_off)
    sw = local2d.max_fused_sweeps("rbgs")
    check(local2d.rbgs_sweep(u, b, *args, *offs, sigma=sigma, sweeps=sw),
          jlocal2d.rbgs_sweep(uj, bj, *args, *offs, sigma=sigma, sweeps=sw),
          t)
    sw = local2d.max_fused_sweeps("jacobi")
    check(local2d.jacobi_sweep(u, b, *args, OMEGA, *offs, sigma=sigma,
                               sweeps=sw),
          jlocal2d.jacobi_sweep(uj, bj, *args, OMEGA, *offs, sigma=sigma,
                                sweeps=sw), t)
    check(local2d.residual(u, b, *args, *offs, sigma=sigma),
          jlocal2d.residual(uj, bj, *args, *offs, sigma=sigma), t)


@pytest.mark.parametrize("kind", ["rbgs", "jacobi"])
def test_one_sweep_matches_jax(kind):
    t = Tile("rows2-m128", seed=1)
    ue, be = t.ext(t.u), t.ext(t.b)
    (u, b), (uj, bj) = t.ports(ue, be), t.jaxes(ue, be)
    offs = (t.row_off, t.col_off)
    if kind == "rbgs":
        got = local2d.rbgs_sweep(u, b, t.n, t.h, *offs)
        want = jlocal2d.rbgs_sweep(uj, bj, t.n, t.h, *offs)
    else:
        got = local2d.jacobi_sweep(u, b, t.n, t.h, OMEGA, *offs)
        want = jlocal2d.jacobi_sweep(uj, bj, t.n, t.h, OMEGA, *offs)
    check(got, want, t)


@pytest.mark.parametrize("name,kind,nu,sigma", [
    ("rows4-rank0", "rbgs", 3, 0.0),
    ("rows2-m128", "rbgs", 2, SIGMA),
    ("rows2-m128", "jacobi", 6, 0.0),
    ("block2x2-10", "jacobi", 6, SIGMA),
    ("block4x2-31", "rbgs", 0, SIGMA),
])
def test_down_leg_matches_jax(name, kind, nu, sigma):
    t = Tile(name, seed=2)
    ue, be = t.ext(t.u), t.ext(t.b)
    (u, b), (uj, bj) = t.ports(ue, be), t.jaxes(ue, be)
    kw = dict(kind=kind, omega=OMEGA, sweeps=nu, sigma=sigma, mcol=t.mcol)
    gu, grc = local2d.down_leg(u, b, t.n, t.h, t.m, t.row_off, t.col_off,
                               **kw)
    wu, wrc = jlocal2d.down_leg(uj, bj, t.n, t.h, t.m, t.row_off, t.col_off,
                                **kw)
    check(gu, wu, t)
    # The whole coarse tile: owned rows, and ghosts zero in both; the JAX
    # layout's padding is zero too.
    wrc = np.asarray(wrc)
    rows, cols = grc.shape
    assert (rows, cols) == (local2d.ext_rows(t.m // 2),
                            t.mcol // 2 + 2 * HH if t.mcol
                            else (t.n - 1) // 2 + 2)
    err = np.abs(grc.numpy() - wrc[:rows, :cols]).max()
    assert err <= RTOL * np.abs(wrc).max(), err
    assert not grc[:HH].any() and not grc[rows - HH:].any()
    assert not wrc[rows:].any() and not wrc[:, cols:].any()


@pytest.mark.parametrize("name,kind,nu,sigma", [
    ("rows4-rank0", "jacobi", 6, SIGMA),
    ("rows2-m128", "rbgs", 3, 0.0),
    ("block2x2-10", "rbgs", 3, SIGMA),
    ("block4x2-31", "jacobi", 2, 0.0),
])
def test_up_leg_matches_jax(name, kind, nu, sigma):
    t = Tile(name, seed=3)
    ue, be = t.ext(t.u), t.ext(t.b)
    (u, b), (uj, bj) = t.ports(ue, be), t.jaxes(ue, be)
    nc = (t.n - 1) // 2
    cshape = (local2d.ext_rows(t.m // 2),
              t.mcol // 2 + 2 * HH if t.mcol else nc + 2)
    # A coarse correction with nonzero ghosts, as a refreshed tile has.
    e = np.random.default_rng(t.n).standard_normal(cshape)
    ej = embed(e, jlocal2d.ext_rows(t.m // 2))
    kw = dict(kind=kind, omega=OMEGA, sweeps=nu, sigma=sigma, mcol=t.mcol)
    check(local2d.up_leg(u, torch.from_numpy(e), b, t.n, nc, t.h, t.m,
                         t.row_off, t.col_off, **kw),
          jlocal2d.up_leg(uj, ej, bj, t.n, nc, t.h, t.m, t.row_off,
                          t.col_off, **kw), t)


@pytest.mark.parametrize("name", list(TILES))
def test_sweeps_on_owned_rows_equal_the_global_sweep(name):
    """Overlap-recompute: the owned region of a tile swept 4 times equals
    the single-device RB-GS sweeps of the whole grid (ops/smoothers.py)."""
    t = Tile(name, seed=4)
    u, b = t.ports(t.ext(t.u), t.ext(t.b))
    got = local2d.rbgs_sweep(u, b, t.n, t.h, t.row_off, t.col_off,
                             sweeps=4)
    want = torch.from_numpy(t.u)
    for _ in range(4):
        want = smoothers.rbgs(want, torch.from_numpy(t.b), t.h)
    check(got, torch.from_numpy(t.ext(want.numpy())), t)


def test_extended_convention():
    assert local2d.HALO_ROWS == local2d.COARSE_HALO == jlocal2d.HALO_ROWS
    for kind in ("rbgs", "jacobi"):
        for fn in ("max_fused_sweeps", "max_down_sweeps", "max_up_sweeps"):
            assert getattr(local2d, fn)(kind) == getattr(jlocal2d, fn)(kind)
    # The port does not round the extended rows to JAX's 16.
    assert local2d.ext_rows(512) == 528 and local2d.ext_rows(4) == 20
    # Coarse entry 0 of rank d's extended coarse tile: d*m/2 + 1 - 8.
    for d, m in ((0, 16), (3, 512)):
        assert local2d.coarse_offset(d * m + 1 - HH) == d * m // 2 + 1 - HH
