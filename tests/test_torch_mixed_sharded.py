"""Sharded mixed precision of the PyTorch port: the bfloat16 storage modes of
the shard tile legs (kernels/local2d.py and kernels/plocal2d.py, down_leg
and up_leg) against the JAX package's Pallas kernels in interpret mode on
the same bfloat16 inputs, and ``parallel.sharded.mixed_leg_dtype`` against
JAX's on the same configs and meshes.

Inputs are made with numpy from a seed, rounded to bfloat16, and handed to
both; the tiles are cut from a global grid as tests/test_torch_local2d.py
and tests/test_torch_plocal2d.py cut them (n = 255 with m = 128 owned rows
spans several of the JAX kernels' row windows). On a CPU tensor each
wrapper takes its plain version, which chip_smoke.py holds the CUDA kernels
against on the card. Tolerances, as tests/test_torch_mixed.py states them:
a bfloat16 output lies within one bfloat16 ulp of JAX's plus BF16_SCALE_TOL
of the field's largest value at every owned point (both evaluate in
float32, in other orders, and round once), and at most BF16_SHARE of the
owned points differ at all; a float32 output (the up leg's x' with
out_dtype) to F32_TOL of the field's largest value. The down leg's coarse
right-hand side is the residual of u' as stored, so it is held against the
port's plain restriction of JAX's own u' (a one-ulp flip of u' moves the
residual there by 4/h^2 of an ulp), to F32_TOL.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigridcmt_tpu import kernels as jkernels
from multigridcmt_tpu.config import SolverConfig as JConfig
from multigridcmt_tpu.kernels import local2d as jlocal2d
from multigridcmt_tpu.kernels import plocal2d as jplocal2d
from multigridcmt_tpu.parallel import sharded as jsharded
from multigridcmt_tpu_torch import convert, kernels
from multigridcmt_tpu_torch.config import SolverConfig
from multigridcmt_tpu_torch.kernels import local2d, plocal2d
from multigridcmt_tpu_torch.parallel import sharded

BF = torch.bfloat16
HH = local2d.HALO_ROWS
BF16_SCALE_TOL = 1e-5
BF16_SHARE = 1e-3
F32_TOL = 1e-5
OMEGA = {"rbgs": 1.0, "jacobi": 0.8}
SIGMA = 3.7

# name -> (n, row ranks, row rank, column ranks, column rank, packed, kind,
# sweeps, sigma); column ranks 0: a row decomposition. Unpacked and packed
# tiles each see rows and blocks, both smoothers and both shifts.
CASES = {
    "local-rows-m128": (255, 2, 1, 0, 0, False, "rbgs", 2, 0.0),
    "local-rows-rank0": (63, 4, 0, 0, 0, False, "jacobi", 3, SIGMA),
    "local-block": (255, 2, 0, 2, 1, False, "rbgs", 1, SIGMA),
    "packed-rows-m128": (255, 2, 1, 0, 0, True, "rbgs", 2, 0.0),
    "packed-block": (255, 2, 1, 2, 1, True, "jacobi", 2, SIGMA),
}


class Tile:
    """One rank's extended tiles of u and b (bfloat16 values, b of 1/h^2
    size) cut from a global grid made from a numpy seed, and a float32
    coarse correction in the extended convention."""

    def __init__(self, name):
        n, dr, r, dc, c, self.packed, *_ = CASES[name]
        self.n, self.h = n, 1.0 / (n + 1)
        self.m = (n + 1) // dr
        self.mcol = (n + 1) // dc if dc else 0
        self.row_off = r * self.m + 1 - HH
        self.col_off = c * self.mcol + 1 - HH if dc else 0
        self.rows, self.cols = self.m + 2 * HH, (self.mcol + 2 * HH if dc
                                                 else n + 2)
        self.cpar = 1 if dc else 0
        rng = np.random.default_rng(n + 7 * r + c + dc)
        u, b = (np.zeros((n + 2, n + 2)) for _ in range(2))
        u[1:-1, 1:-1] = rng.standard_normal((n, n))
        b[1:-1, 1:-1] = rng.standard_normal((n, n)) * (n + 1) ** 2
        # bfloat16 values, exact in float64.
        self.u, self.b = (self._bf16(self._cut(g)) for g in (u, b))
        self.cshape = (self.m // 2 + 2 * HH, self.mcol // 2 + 2 * HH if dc
                       else (n - 1) // 2 + 2)
        self.e = rng.standard_normal(self.cshape).astype(np.float32)
        self.owned = (slice(HH, HH + self.m),
                      slice(HH, HH + self.mcol) if dc else slice(None))

    @staticmethod
    def _bf16(a):
        return torch.from_numpy(a).to(BF).double().numpy()

    def _cut(self, g):
        out = np.zeros((self.rows, self.cols))
        r = np.arange(self.rows) + self.row_off
        c = np.arange(self.cols) + self.col_off
        ok_r = (r >= 0) & (r < g.shape[0])
        ok_c = (c >= 0) & (c < g.shape[1])
        out[np.ix_(ok_r, ok_c)] = g[np.ix_(r[ok_r], c[ok_c])]
        return out

    def port(self, a, dtype=BF):
        """Tile a on the port's side: bfloat16, packed on a packed case."""
        t = torch.from_numpy(a).to(dtype)
        return plocal2d.pack_ext(t, self.cpar) if self.packed else t

    def jax(self, a, dtype=jnp.bfloat16):
        """Tile a on JAX's side, embedded in its (16j, 128j) layout (packed
        on a packed case)."""
        rows = jlocal2d.ext_rows(a.shape[0] - 2 * HH)
        c128 = -(-a.shape[1] // 128) * 128
        emb = jnp.asarray(np.pad(a, ((0, rows - a.shape[0]),
                                     (0, c128 - a.shape[1])))).astype(dtype)
        return jplocal2d.pack_ext(emb, self.cpar) if self.packed else emb

    def logical(self, got):
        """A port output as an unpacked float64 numpy tile."""
        if self.packed:
            got = plocal2d.unpack_ext(got, self.cols, self.cpar)
        return got.double().numpy()

    def from_jax(self, want):
        """A JAX output as an unpacked float64 numpy tile."""
        if self.packed:
            want = convert.packed_tile_from_jax(
                np.asarray(want.astype(jnp.float32)), self.rows, self.cols,
                device="cpu")
            return plocal2d.unpack_ext(want, self.cols, self.cpar).double() \
                .numpy()
        return np.array(want.astype(jnp.float64))[:self.rows, :self.cols]


def _bf16_close(got, want, t):
    """The owned points of got (the port's bfloat16 output) against JAX's,
    as the module's docstring says."""
    g, w = t.logical(got)[t.owned], t.from_jax(want)[t.owned]
    diff = np.abs(g - w)
    _, ex = np.frexp(w)
    ulp = np.where(w != 0, np.ldexp(1.0, ex - 8), 0.0)
    scale = np.abs(w).max()
    assert np.all(diff <= ulp + BF16_SCALE_TOL * scale), (diff - ulp).max()
    assert np.mean(diff > 0) <= BF16_SHARE, np.mean(diff > 0)


def _f32_close(got, want, scale):
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL * scale)


def _leg_kw(name, t):
    *_, kind, nu, sigma = CASES[name]
    return dict(kind=kind, omega=OMEGA[kind], sweeps=nu, sigma=sigma,
                mcol=t.mcol)


@functools.cache
def _jax_down(name):
    t = Tile(name)
    mod = jplocal2d if t.packed else jlocal2d
    return mod.down_leg(t.jax(t.u), t.jax(t.b), t.n, t.h, t.m, t.row_off,
                        t.col_off, **_leg_kw(name, t))


@pytest.mark.parametrize("name", list(CASES))
def test_bf16_down_leg_matches_pallas(name):
    """u' in bfloat16 against JAX's; rc in float32, as JAX's, against the
    plain restriction of JAX's own stored u' (the red residual only after an
    RB-GS sweep on a packed tile)."""
    t = Tile(name)
    kw = _leg_kw(name, t)
    mod = plocal2d if t.packed else local2d
    launches = (mod.down_launches, mod.down_bf16_launches)
    gu, grc = mod.down_leg(t.port(t.u), t.port(t.b), t.n, t.h, t.m,
                           t.row_off, t.col_off, **kw)
    assert (mod.down_launches, mod.down_bf16_launches) == launches
    assert gu.dtype == BF and grc.dtype == torch.float32
    assert tuple(grc.shape) == t.cshape
    wu, wrc = _jax_down(name)
    assert wu.dtype == jnp.bfloat16 and wrc.dtype == jnp.float32
    _bf16_close(gu, wu, t)
    # The coarse right-hand side of each side's own stored u'.
    jrc = np.asarray(wrc)
    scale = np.abs(jrc).max()
    rows, cols = t.cshape
    _f32_close(grc.double().numpy(), _rc_of(t.logical(gu), t, kw), scale)
    _f32_close(jrc[:rows, :cols], _rc_of(t.from_jax(wu), t, kw), scale)
    assert not jrc[rows:].any() and not jrc[:, cols:].any()


def _rc_of(u, t, kw):
    """The port's plain restriction (float32) of the residual of the
    stored u' (an unpacked float64 numpy tile of bfloat16 values): the red
    residual only after an RB-GS sweep on a packed tile, as the packed legs
    take it."""
    rc = local2d.residual_restrict_plain(
        torch.from_numpy(u).to(BF), torch.from_numpy(t.b).to(BF), t.n, t.h,
        t.m, t.row_off, t.col_off, sigma=kw["sigma"], mcol=t.mcol,
        red_only=t.packed and kw["kind"] == "rbgs" and kw["sweeps"] >= 1)
    assert rc.dtype == torch.float32
    return rc.double().numpy()


@pytest.mark.parametrize("out", ["bf16", "f32"])
@pytest.mark.parametrize("name", list(CASES))
def test_bf16_up_leg_matches_pallas(name, out):
    """x' stored in bfloat16 (the TPU kernel's own mode) or float32 (the top
    level of a mixed cycle, out_dtype) against JAX's, from bfloat16 x and b
    and a float32 coarse correction with nonzero ghosts."""
    t = Tile(name)
    kw = _leg_kw(name, t)
    mod = plocal2d if t.packed else local2d
    odt = BF if out == "bf16" else torch.float32
    nc = (t.n - 1) // 2
    got = mod.up_leg(t.port(t.u), torch.from_numpy(t.e), t.port(t.b), t.n,
                     nc, t.h, t.m, t.row_off, t.col_off,
                     out_dtype=None if out == "bf16" else odt, **kw)
    assert got.dtype == odt
    ej = jnp.asarray(np.pad(t.e, ((0, jlocal2d.ext_rows(t.m // 2)
                                   - t.cshape[0]),
                                  (0, -(-t.cshape[1] // 128) * 128
                                   - t.cshape[1]))))
    jmod = jplocal2d if t.packed else jlocal2d
    want = jmod.up_leg(t.jax(t.u), ej, t.jax(t.b), t.n, nc, t.h, t.m,
                       t.row_off, t.col_off,
                       out_dtype=None if out == "bf16" else jnp.float32,
                       **kw)
    if out == "bf16":
        assert want.dtype == jnp.bfloat16
        _bf16_close(got, want, t)
    else:
        assert want.dtype == jnp.float32
        w = t.from_jax(want)[t.owned]
        _f32_close(t.logical(got)[t.owned], w, np.abs(w).max())


def test_bf16_legs_emit_and_take_float32_coarse_grids():
    """A bfloat16 tile's coarse operand is float32: the down leg emits it
    so (every coarser level of a mixed cycle runs in float32), the up leg
    refuses a bfloat16 one (not a compute dtype), a bfloat16 b beside a
    float32 u is refused, and float16 is no storage of theirs."""
    t = Tile("local-rows-rank0")
    kw = _leg_kw("local-rows-rank0", t)
    u, b = t.port(t.u), t.port(t.b)
    nc = (t.n - 1) // 2
    with pytest.raises(TypeError):
        local2d.up_leg(u, torch.from_numpy(t.e).to(BF), b, t.n, nc, t.h, t.m,
                       t.row_off, **kw)
    with pytest.raises(ValueError):
        local2d.down_leg(u.float(), b, t.n, t.h, t.m, t.row_off, **kw)
    with pytest.raises(TypeError):
        local2d.down_leg(u.half(), b.half(), t.n, t.h, t.m, t.row_off, **kw)


# (k, mesh shape, config overrides): JAX's own cases (tests/test_mixed.py:
# k=6 on 8 rows and a 4 x 2 block mesh cast, k=5 on 8 rows does not: tiles
# too shallow for the halo), and the routes where no cast is made.
DTYPE_CASES = {
    "rows8-k6": (6, (8,), {}),
    "rows8-k5": (5, (8,), {}),
    "block4x2-k6": (6, (4, 2), {}),
    "rows2-k8-packed": (8, (2,), dict(pack=True)),
    "no-kernels": (6, (2,), dict(use_kernels=False)),
    "chebyshev": (6, (2,), dict(smoother="chebyshev")),
    "nu-over-cap": (6, (2,), dict(nu1=4, nu2=4)),
    "f32-precond": (6, (2,), dict(precond_dtype="float32")),
    "same-dtype": (6, (2,), dict(precond_dtype="float64")),
    "no-precond": (6, (2,), dict(precond_dtype=None)),
}


@pytest.mark.parametrize("case", list(DTYPE_CASES))
def test_mixed_leg_dtype_matches_jax(case, monkeypatch):
    """The port casts its sharded PCG preconditioner exactly where JAX's
    mixed_leg_dtype does, to the same dtype."""
    k, shape, kw = DTYPE_CASES[case]
    kw = dict(kw)
    pack = kw.pop("pack", False)
    pd = kw.pop("precond_dtype", "bfloat16")
    base = {"ndim": 2, "k": k, "smoother": "rbgs", "agglom_rows": 8, **kw}
    monkeypatch.setattr(jkernels, "PALLAS_MIN_N", 30)
    monkeypatch.setattr(kernels, "KERNEL_MIN_N", 30)
    if pack:
        monkeypatch.setattr(jkernels, "PACK_MIN_N", 30)
        monkeypatch.setattr(kernels, "PACK_MIN_N", 30)
    use = base.pop("use_kernels", True)
    jcfg = JConfig(dtype=jnp.float64, use_pallas=use,
                   precond_dtype=None if pd is None else jnp.dtype(pd),
                   **base)
    cfg = SolverConfig(dtype=torch.float64, use_kernels=use,
                       precond_dtype=None if pd is None
                       else getattr(torch, pd), **base)
    jmesh = (jsharded.make_mesh(jax.devices()[:shape[0]]) if len(shape) == 1
             else jsharded.make_block_mesh(shape))
    want = jsharded.mixed_leg_dtype(jcfg, jsharded.decomp_from_mesh(jmesh, 2))
    decomp = sharded.Decomp(ndim=2, axes=tuple(
        (a, f"ax{a}", d) for a, d in enumerate(shape)))
    got = sharded.mixed_leg_dtype(cfg, decomp)
    assert (None if want is None else jnp.dtype(want).name) == (
        None if got is None else str(got).split(".")[-1])
    if case in ("rows8-k6", "block4x2-k6", "rows2-k8-packed"):
        assert got == torch.bfloat16


def test_mixed_leg_dtype_refuses_other_storage(monkeypatch):
    """A precond_dtype the kernels do not store (float16) raises where the
    cast would be made, naming the solver; the port never runs another
    precision silently."""
    monkeypatch.setattr(kernels, "KERNEL_MIN_N", 30)
    cfg = SolverConfig(ndim=2, k=6, dtype=torch.float64, smoother="rbgs",
                       use_kernels=True, agglom_rows=8,
                       precond_dtype=torch.float16)
    decomp = sharded.Decomp(ndim=2, axes=((0, "row", 2),))
    with pytest.raises(NotImplementedError, match="sharded MG-PCG"):
        sharded.mixed_leg_dtype(cfg, decomp)
    # Off the whole-leg route no cast is made, so nothing is refused.
    cfg_off = SolverConfig(ndim=2, k=6, dtype=torch.float64,
                           smoother="chebyshev", use_kernels=True,
                           agglom_rows=8, precond_dtype=torch.float16)
    assert sharded.mixed_leg_dtype(cfg_off, decomp) is None


def test_tile_bf16_entry_points_match_their_signatures():
    """Each shard tile leg's bfloat16 entry point is defined in a .cu file
    of its own (none in the float32/float64 leg files, whose build it would
    lengthen), with the argument count _build declares, launching its frame
    (UTile unpacked, Tile packed) with bfloat16 storage and, for the top
    level's up leg, a float32 x'."""
    import re

    from multigridcmt_tpu_torch.kernels import _build

    src = {p.name: p.read_text() for p in _build.CSRC.glob("*.cu")}
    files = {}
    for mod, frame in (("local2d", "UTile"), ("plocal2d", "Tile")):
        files[f"mg_{mod}_down_bf16"] = (f"{mod}_legs_bf16.cu", "launch_down",
                                        frame)
        files[f"mg_{mod}_up_bf16"] = (f"{mod}_legs_bf16.cu", "launch_up",
                                      frame)
        files[f"mg_{mod}_up_bf16_f32"] = (f"{mod}_up_bf16_f32.cu",
                                          "launch_up", frame)
    # The packed tile's residual (and apply) and norm in bfloat16 have a
    # file of their own too, on the tile's update rule.
    others = {"mg_plocal2d_residual_bf16": "launch_presidual",
              "mg_plocal2d_resnorm_bf16": "launch_presnorm"}
    assert {k for k in _build.SIGNATURES
            if "bf16" in k and "local2d" in k} == set(files) | set(others)
    for name, launcher in others.items():
        where = [f for f, text in src.items()
                 if re.search(rf"\b{name}\(", text)]
        assert where == ["plocal2d_bf16.cu"]
        m = re.search(rf"\bint {name}\(([^)]*)\)\s*\{{(.*?)\n\}}",
                      src["plocal2d_bf16.cu"], re.S)
        assert len(m.group(1).split(",")) == len(_build.SIGNATURES[name])
        targs = [a.strip() for a in re.search(rf"\b{launcher}<([^>]*)>",
                                              m.group(2)).group(1).split(",")]
        assert targs == ["float", "mg::InteriorBox", "__nv_bfloat16"]
    for name, (fname, launcher, frame) in files.items():
        where = [f for f, text in src.items()
                 if re.search(rf"\b{name}\(", text)]
        assert where == [fname]
        m = re.search(rf"\bint {name}\(([^)]*)\)\s*\{{(.*?)\n\}}", src[fname],
                      re.S)
        params = [p.strip() for p in m.group(1).split(",")]
        assert len(params) == len(_build.SIGNATURES[name])
        targs = [a.strip() for a in re.search(rf"\b{launcher}<([^>]*)>",
                                              m.group(2)).group(1).split(",")]
        assert targs == (["float", "kMaxTileStages", frame, "__nv_bfloat16"]
                         + (["float"] if name.endswith("_f32") else []))
    for legs in ("local2d_legs.cu", "local2d_legs_f64.cu", "plocal2d_legs.cu",
                 "plocal2d_legs_f64.cu"):
        assert "bfloat16" not in src[legs]
