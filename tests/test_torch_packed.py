"""The color-packed tier of the PyTorch port (kernels/packed2d.py) against
the JAX package's packed2d Pallas kernels in interpret mode, called as
tests/test_packed.py calls them, and the packed solve end to end.

On a CPU tensor each wrapper takes its plain PyTorch version, so these
tests pin that version, which chip_smoke.py then holds the CUDA kernel
against on the card. Inputs are float64, made with numpy from a seed.
Tolerance: rtol 1e-12 and atol 1e-12 * max|ref| for arrays, rtol 1e-12 for
the squared norms (the Pallas kernels and the plain versions evaluate the
same formulas in other orders). n=255 spans several Pallas row tiles.
"""
import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import multigridcmt_tpu as jmg
import multigridcmt_tpu_torch as mt
from multigridcmt_tpu import kernels as jkernels
from multigridcmt_tpu.grids import from_aligned, to_aligned
from multigridcmt_tpu.kernels import packed2d as jpacked2d
from multigridcmt_tpu_torch import convert, kernels
from multigridcmt_tpu_torch.kernels import fused2d, local2d, native_bf16, \
    packed2d, stencil2d

OMEGA = {"rbgs": 1.0, "jacobi": 0.8}
SIGMA = 11.5


def _padded(rng, n):
    a = np.zeros((n + 2, n + 2))
    a[1:-1, 1:-1] = rng.standard_normal((n, n))
    return a


def _jpack(a):
    return jpacked2d.pack(to_aligned(jnp.asarray(a)))


def _junpack(s, n):
    """JAX packed -> logical padded numpy grid."""
    c = to_aligned(jnp.zeros((n + 2, n + 2))).shape[1]
    return np.asarray(from_aligned(jpacked2d.unpack(s, c), n))


def _tpack(a):
    return packed2d.pack(torch.from_numpy(a))


def _close(got: torch.Tensor, want: np.ndarray, m: int) -> None:
    """got (logical or packed) equals the logical grid want; ghosts and
    pad lanes are zero."""
    if packed2d.is_packed(got):
        assert tuple(got.shape) == packed2d.packed_shape(m)
        g = packed2d.unpack(got).numpy()
        assert np.array_equal(packed2d.pack(torch.from_numpy(g)).numpy(),
                              got.numpy())       # pad lanes are zero
        got = torch.from_numpy(g)
    got = got.numpy()
    assert got.shape == (m + 2, m + 2)
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    ghosts = got.copy()
    ghosts[1:-1, 1:-1] = 0.0
    assert np.abs(ghosts).max() == 0.0


def _counts():
    return (packed2d.down_launches, packed2d.up_launches,
            packed2d.resnorm_launches)


@pytest.mark.parametrize("n", [15, 63])
def test_pack_layout_matches_jax(n):
    u = _padded(np.random.default_rng(n), n)
    got = _tpack(u)
    assert tuple(got.shape) == packed2d.packed_shape(n)
    want = np.asarray(_jpack(u))
    cp = got.shape[2]
    np.testing.assert_array_equal(got.numpy(), want[:, : n + 2, :cp])
    assert np.abs(want[:, : n + 2, cp:]).max() == 0.0
    np.testing.assert_array_equal(packed2d.unpack(got).numpy(), u)


def test_sweep_caps_match_jax():
    for kind in ("rbgs", "jacobi"):
        assert (packed2d.max_down_sweeps(kind)
                == jpacked2d.max_down_sweeps(kind))
        assert packed2d.max_up_sweeps(kind) == jpacked2d.max_up_sweeps(kind)
    assert packed2d.max_fused_sweeps() == jpacked2d.max_fused_sweeps()


def _leg_cases(cap_of):
    cases = []
    for kind in ("rbgs", "jacobi"):
        cap = cap_of(kind)
        full = range(cap + 1) if kind == "rbgs" else (0, 1, cap)
        cases += [(63, kind, s, SIGMA, False) for s in full]
        cases += [(63, kind, 2, 0.0, True), (255, kind, cap, 0.0, False)]
    return cases


@pytest.mark.parametrize("n,kind,sweeps,sigma,packed_coarse",
                         _leg_cases(packed2d.max_down_sweeps))
def test_down_leg_matches_pallas(n, kind, sweeps, sigma, packed_coarse):
    rng = np.random.default_rng(4000 + n + sweeps)
    u, b = _padded(rng, n), _padded(rng, n)
    h = 1.0 / (n + 1)
    nc = (n - 1) // 2
    ju, jrc = jpacked2d.smooth_residual_restrict(
        _jpack(u), _jpack(b), n, h, kind=kind, omega=OMEGA[kind],
        sweeps=sweeps, sigma=sigma, packed_coarse=packed_coarse)
    before = _counts()
    tu, trc = packed2d.smooth_residual_restrict(
        _tpack(u), _tpack(b), n, h, kind=kind, omega=OMEGA[kind],
        sweeps=sweeps, sigma=sigma, packed_coarse=packed_coarse)
    assert _counts() == before                 # CPU: the plain version
    assert packed2d.is_packed(trc) == packed_coarse
    _close(tu, _junpack(ju, n), n)
    want_rc = (_junpack(jrc, nc) if packed_coarse
               else np.asarray(from_aligned(jrc, nc)))
    _close(trc, want_rc, nc)


@pytest.mark.parametrize("n,kind,sweeps,sigma,packed_e",
                         _leg_cases(packed2d.max_up_sweeps))
def test_up_leg_matches_pallas(n, kind, sweeps, sigma, packed_e):
    rng = np.random.default_rng(5000 + n + sweeps)
    nc = (n - 1) // 2
    x, b, e = _padded(rng, n), _padded(rng, n), _padded(rng, nc)
    h = 1.0 / (n + 1)
    je = _jpack(e) if packed_e else to_aligned(jnp.asarray(e))
    jx = jpacked2d.prolong_add_smooth(
        _jpack(x), je, _jpack(b), n, nc, h, kind=kind, omega=OMEGA[kind],
        sweeps=sweeps, sigma=sigma)
    te = _tpack(e) if packed_e else torch.from_numpy(e)
    before = _counts()
    tx = packed2d.prolong_add_smooth(
        _tpack(x), te, _tpack(b), n, nc, h, kind=kind, omega=OMEGA[kind],
        sweeps=sweeps, sigma=sigma)
    assert _counts() == before
    _close(tx, _junpack(jx, n), n)


@pytest.mark.parametrize("n", [63, 255])
@pytest.mark.parametrize("red_only", [False, True])
@pytest.mark.parametrize("sigma", [0.0, SIGMA])
def test_residual_norm_matches_pallas(n, red_only, sigma):
    rng = np.random.default_rng(6000 + n)
    u, b = _padded(rng, n), _padded(rng, n)
    h = 1.0 / (n + 1)
    want = float(jpacked2d.residual_norm_sq(
        _jpack(u), _jpack(b), n, h, red_only=red_only, sigma=sigma))
    before = _counts()
    got = packed2d.residual_norm_sq(_tpack(u), _tpack(b), n, h,
                                    red_only=red_only, sigma=sigma)
    assert _counts() == before
    assert got.ndim == 0 and got.dtype == torch.float64
    np.testing.assert_allclose(got.item(), want, rtol=1e-12)


@pytest.mark.parametrize("n", [63, 255])
@pytest.mark.parametrize("sigma", [0.0, SIGMA])
def test_residual_matches_pallas(n, sigma):
    """The packed residual (MG-PCG's operator apply on a packed level):
    both planes, ghosts and pad lanes zero (CG's whole-array dots rely on
    it)."""
    rng = np.random.default_rng(7000 + n)
    u, b = _padded(rng, n), _padded(rng, n)
    h = 1.0 / (n + 1)
    want = _junpack(jpacked2d.residual(_jpack(u), _jpack(b), n, h,
                                       sigma=sigma), n)
    before = packed2d.residual_launches
    got = packed2d.residual(_tpack(u), _tpack(b), n, h, sigma=sigma)
    assert packed2d.residual_launches == before
    assert packed2d.is_packed(got)
    _close(got, want, n)


@pytest.mark.parametrize("n,sigma", [(63, SIGMA), (255, 0.0)])
@pytest.mark.parametrize("sweeps", [1, 2, 3, 4])
def test_rbgs_sweep_matches_pallas(sweeps, n, sigma):
    """The packed RB-GS sweep (a packed level's smoothing where its legs do
    not fuse): both planes, ghosts and pad lanes zero."""
    rng = np.random.default_rng(7500 + n + sweeps)
    h = 1.0 / (n + 1)
    u, b = _padded(rng, n), _padded(rng, n) / h ** 2
    want = _junpack(jpacked2d.rbgs_sweep(_jpack(u), _jpack(b), n, h,
                                         sweeps=sweeps, sigma=sigma), n)
    before = packed2d.rbgs_launches
    got = packed2d.rbgs_sweep(_tpack(u), _tpack(b), n, h, sweeps=sweeps,
                              sigma=sigma)
    assert packed2d.rbgs_launches == before
    assert packed2d.is_packed(got)
    _close(got, want, n)


@pytest.mark.parametrize("k,pack_min_n", [(6, 30), (7, 60)])
def test_packed_tier_solve_matches_jax_pallas(k, pack_min_n, monkeypatch):
    """float64 RB-GS with PACK_MIN_N lowered, as tests/test_packed.py
    does: k=6 packs level 63 (coarse 31 on the fused2d tier); k=7 packs
    127 and 63, so the 127 legs emit and take a packed coarse grid."""
    monkeypatch.setattr(jkernels, "PALLAS_MIN_N", 20)
    monkeypatch.setattr(jkernels, "PACK_MIN_N", pack_min_n)
    monkeypatch.setattr(kernels, "KERNEL_MIN_N", 20)
    monkeypatch.setattr(kernels, "PACK_MIN_N", pack_min_n)
    jprob = jmg.poisson2d(k=k, dtype=jnp.float64, smoother="rbgs", tol=1e-9,
                          use_pallas=True)
    want = jmg.MultigridSolver(jprob).solve()
    prob = convert.problem_from_jax(jprob, device="cpu")

    calls = {key: [] for key in ("pdown", "pup", "norm", "fdown", "fup",
                                 "residual")}
    for mod, name, key, pos in (
            (packed2d, "smooth_residual_restrict", "pdown", 2),
            (packed2d, "prolong_add_smooth", "pup", 3),
            (packed2d, "residual_norm_sq", "norm", 2),
            (fused2d, "smooth_residual_restrict", "fdown", 2),
            (fused2d, "prolong_add_smooth", "fup", 3),
            (stencil2d, "residual", "residual", 2)):
        def spy(*a, _f=getattr(mod, name), _k=key, _p=pos, **kw):
            calls[_k].append(a[_p])
            return _f(*a, **kw)
        monkeypatch.setattr(mod, name, spy)
    before = _counts()
    got = mt.MultigridSolver(prob).solve()

    iters = int(want.iters)
    assert got.iters == iters and got.converged
    # As in test_torch_solve.py: rtol 1e-9 down to the float64 rounding
    # floor of the residual (~1e-14 of ||b||).
    np.testing.assert_allclose(got.res_history.numpy(),
                               np.asarray(want.res_history),
                               rtol=1e-9, atol=1e-13)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x),
                               rtol=1e-10, atol=1e-12)
    packed = [2 ** j - 1 for j in range(k, 4, -1)
              if 2 ** j - 1 >= pack_min_n]
    fused = [2 ** j - 1 for j in range(k, 4, -1)
             if 20 <= 2 ** j - 1 < pack_min_n]
    assert calls["pdown"] == packed * iters
    assert calls["pup"] == packed[::-1] * iters
    assert calls["fdown"] == fused * iters
    assert calls["fup"] == fused[::-1] * iters
    assert calls["norm"] == [2 ** k - 1] * (iters + 1)
    assert calls["residual"] == []
    assert _counts() == before


def test_v_cycle_on_packed_level_matches_plain_route(monkeypatch):
    """MultigridSolver.v_cycle packs and unpacks a packed fine level at its
    boundary; the result equals the plain route's cycle up to the red-only
    restriction's rounding."""
    monkeypatch.setattr(kernels, "KERNEL_MIN_N", 20)
    monkeypatch.setattr(kernels, "PACK_MIN_N", 30)
    out = {}
    for use_kernels in (True, False):
        prob = mt.poisson2d(k=6, dtype=torch.float64, smoother="rbgs",
                            use_kernels=use_kernels, device="cpu")
        solver = mt.MultigridSolver(prob)
        x = torch.zeros_like(prob.b)
        for _ in range(3):
            x = solver.v_cycle(x, prob.b)
        out[use_kernels] = x
    assert out[True].shape == out[False].shape == (65, 65)
    np.testing.assert_allclose(out[True].numpy(), out[False].numpy(),
                               rtol=1e-10, atol=1e-12)


# ---------------------------------------------------------------------------
# The row-streaming legs' launch geometry (packed2d.leg_geometry), which
# csrc/packed2d_legs.cuh's down_kernel, up_kernel and sweep_kernel take as
# they are (the sweep stream's cases are in test_torch_sweep_stream.py).
# The CUDA kernels run only on the card; here a step-by-step emulation of their
# schedule (one warp's unit at a time, its register window and lags as in
# the kernel, stages in the kernel's order within a step) runs on the
# geometry and is held against the plain versions. On every read it asserts
# that the window slot holds the row it expects and that the row has been
# loaded, and, for RB-GS, that each neighbour row has had exactly the
# half-sweeps a sequential sweep would have given it by then; every point
# of the outputs must be written exactly once. Float64; tolerance as
# _close. The bfloat16 storage modes (``bf16``) run the same schedule in
# float32 with the kernels' rings: loaded rows held as bfloat16 values in a
# ring of LEG_AHEAD slots and widened into the window only in the step that
# first reads them, the down leg's u' rounded once a row into a ring that
# its residual and store read; a ring slot past its row's life holds NaN.
# The native bfloat16 mode (``native``, the fused2d legs' on the unpacked
# frame) runs the bfloat16 rings with every operation rounded to bfloat16
# (_nat), the host's constants (native_bf16.constants) and JAX's order in
# the transfers.
# ---------------------------------------------------------------------------

def _coefs(h, sigma, omega):
    h2 = h * h
    inv_h2 = 1.0 / h2
    return h2, inv_h2, sigma, 1.0 / (4.0 - sigma * h2), \
        omega / (4.0 * inv_h2 - sigma)


# The bfloat16 down leg's ring of rows of u' as stored (the kernel's
# kRounded): the emulation's, whose slots past their row's life hold NaN.
ROUNDED_ROWS = 4


def _coefs32(h, sigma, omega):
    """_coefs as the kernels' float32 Coef makes them: h^2, 1/h^2 and sigma
    rounded from float64, the rest computed in float32."""
    f = np.float32
    h2, inv_h2, sig = f(h * h), f(1.0 / (h * h)), f(sigma)
    return h2, inv_h2, sig, f(1) / (f(4) - sig * h2), \
        f(omega) / (f(4) * inv_h2 - sig)


def _bf16(a):
    """a rounded to bfloat16 (to nearest even), held in float32."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(
        torch.bfloat16).float().numpy()


def _bf16_rule(got, want):
    """got (the emulated kernel's bfloat16 output, float32) against want
    (the plain version's, bfloat16) by tests/test_torch_mixed.py's rule:
    every point within one bfloat16 ulp of want plus 1e-5 of its largest
    value, at most 1e-3 of the points differing at all."""
    want = want.double().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.array_equal(_bf16(got), got)          # rounded once, stored
    diff = np.abs(got.astype(np.float64) - want)
    _, ex = np.frexp(want)
    ulp = np.where(want != 0, np.ldexp(1.0, ex - 8), 0.0)
    assert np.all(diff <= ulp + 1e-5 * np.abs(want).max())
    assert np.mean(diff > 0) <= 1e-3


def _nat(a):
    """float32 a rounded to bfloat16 (to nearest even), held in float32:
    the native mode's rounding after each float32 operation."""
    return np.asarray(a, dtype=np.float32).astype(ml_dtypes.bfloat16).astype(
        np.float32)


def _weigh(a, m, z):
    """(0.25 a + 0.5 m) + 0.25 z, each operation rounded (the native
    restriction's weighting)."""
    q, hf = np.float32(0.25), np.float32(0.5)
    return _nat(_nat(_nat(q * a) + _nat(hf * m)) + _nat(q * z))


def _average(a, b):
    """0.5 a + 0.5 b in float32, rounded once (the native interpolation)."""
    hf = np.float32(0.5)
    return _nat(np.float32(hf * a) + np.float32(hf * b))


def _f32_close(got, want):
    """A float32 output of the emulation against the plain version's, to
    1e-5 of its largest value (both float32, summed in other orders)."""
    want = want.double().numpy() if isinstance(want, torch.Tensor) else want
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


class _Window:
    """Rows of both planes of `width` lanes, slot i & (size - 1), each slot
    tagged with the row it holds and, for RB-GS, its updates by colour."""

    def __init__(self, size, width, dtype=np.float64):
        self.mask = size - 1
        self.data = np.full((size, 2, width), np.nan, dtype=dtype)
        self.tag = np.full(size, -1)
        self.count = np.zeros((size, 2), dtype=int)
        self.limit = None       # the last row loaded so far

    def put(self, i, rows):
        k = i & self.mask
        self.data[k], self.tag[k] = rows, i
        self.count[k] = 0

    def slot(self, i):
        k = i & self.mask
        assert self.tag[k] == i, f"slot of row {i} holds row {self.tag[k]}"
        return k

    def row(self, i):
        assert self.limit is None or i <= self.limit, \
            f"row {i} read before it was loaded (row {self.limit})"
        return self.data[self.slot(i)]


@dataclasses.dataclass(frozen=True)
class LegFrame:
    """What csrc/packed2d_legs.cuh's kernels know of their frame: the packed
    array's first global row and column (goy, gox) and its unpacked columns
    C; the points a stage may update, (ylo, yhi, xlo, xhi) in global
    indices; and the coarse output: the whole coarse grid (ca None) or a
    shard's coarse tile ca = (Rc, Cc, crow, ccol) with its owned box keep =
    (ylo, yhi, xlo, xhi), global coarse indices. ``unpacked``: the array
    holds its points unpacked, not as two planes: the logical (n+2)^2 grid
    (the Unpacked frame) or, with ``ca``, a shard's unpacked tile of C
    columns (the UTile frame); lane l's points are global columns gx0 +
    2l and gx0 + 2l + 1 (gx0 = gox - (gox & 1)), at array column gx - gox,
    and the down leg's residual is full."""
    n: int
    goy: int = 0
    gox: int = 0
    C: int = 0
    upd: tuple = ()
    ca: tuple | None = None
    keep: tuple | None = None
    unpacked: bool = False

    @staticmethod
    def whole(n, unpacked=False):
        return LegFrame(n, 0, 0, n + 2, (1, n, 1, n), unpacked=unpacked)

    def lanes(self):
        """The frame's lanes: one more than the array's where gox is odd."""
        return (self.C + (self.gox & 1) + 1) // 2

    def unit(self, g, sx, x):
        """A unit's lanes x (0 .. LEG_LANES - 1) of strip sx: (frame lane
        gl, coarse column J, array lane at[p] (on the unpacked frame the
        array column), ok[p], core, upd[p]), as the kernel's Unit."""
        xs = self.gox & 1
        cpa = (self.C + 1) // 2
        gl = sx * g.strip - g.halo_lanes + x
        J = ((self.gox - xs) >> 1) + gl
        core = (x >= g.halo_lanes) & (x < g.halo_lanes + g.strip) \
            & (gl < self.lanes())
        if self.unpacked:
            at = [2 * J + p - self.gox for p in (0, 1)]
            ok = [(gl >= 0) & (gl < self.lanes()) & (a >= 0) & (a < self.C)
                  for a in at]
        else:
            at = [gl - (xs & (1 - p)) for p in (0, 1)]
            ok = [(a >= 0) & (a < cpa) for a in at]
        ylo, yhi, xlo, xhi = self.upd
        upd = [(2 * x + p >= 1) & (2 * x + p <= 2 * len(x) - 2)
               & (2 * J + p >= max(1, xlo)) & (2 * J + p <= min(self.n, xhi))
               for p in (0, 1)]
        return gl, J, at, ok, core, upd

    def paired(self, q):
        """Whether, on the unpacked frames, a lane whose two points lie in
        rows of parity q makes one paired access (the kernels' rule: the
        whole grid's even rows; on a tile, the odd rows if there the
        phase-0 point's index (i - goy) C + 2l - (gox & 1) is even)."""
        if self.ca is None:
            return q == 0
        return q == 1 and ((((1 - self.goy) & self.C) ^ self.gox) & 1) == 0

    def coarse_frame(self):
        """The entries of the coarse tile off its owned box, in the order
        the kernel's zero_coarse_frame numbers them."""
        rc_, cc, crow, ccol = self.ca
        qlo, qhi = self.keep[0] - crow, self.keep[1] + 1 - crow
        slo, shi = self.keep[2] - ccol, self.keep[3] + 1 - ccol
        above, side = qlo * cc, cc - (shi - slo)
        bands = above + (rc_ - qhi) * cc
        for k in range(bands + (qhi - qlo) * side):
            if k < bands:
                r = k if k < above else k - above + qhi * cc
                yield r // cc, r % cc
            else:
                q, s = qlo + (k - bands) // side, (k - bands) % side
                yield q, s + (shi - slo if s >= slo else 0)


def _emulate_leg(g, kind, sweeps, s, bs, h, sigma, omega, *, e=None,
                 packed_coarse=False, frame=None, fine=True, bf16=False,
                 f32_out=False, native=False, shift=True):
    """csrc/packed2d_legs.cuh's down_kernel, up_kernel (with e) or
    sweep_kernel (the up leg's stream without e), as g.leg says, on
    geometry g and frame (the whole packed grid when None), unit by unit;
    returns u' and the coarse residual (down) or x'. With ``fine`` False
    the down leg stores no u' (residual_restrict_kernel's stream) and
    returns the coarse residual alone. Rows are global; stage
    k works on row t - 1 - k of step t. On the unpacked frames s, bs and u'
    are unpacked arrays of f.C columns (the logical (n+2)^2 grid or a
    tile), every address read or written is asserted to lie in its row and
    in the array, and every paired access to start on a pair.

    ``bf16``: the bfloat16 storage mode (s and bs bfloat16 values in
    float32 arrays, e float32), in float32 with the kernels' rings (the
    section's note); u' and x' come back rounded to bfloat16, or x' in
    float32 with ``f32_out`` (the up leg's float32 store).

    ``native``: the native bfloat16 mode on the unpacked (n+2)^2 grid (s,
    bs and e bfloat16 values in float32 arrays), the bfloat16 rings with
    every operation rounded (_nat), native_bf16.constants' scalars and
    JAX's transfer order; its down leg's residual and store read the window
    (asserted to hold bfloat16 values: no ring of rounded rows), and every
    paired access is asserted to start on a 4-byte pair of bfloat16. With
    ``shift`` False its residual has no sigma u term (the native residual
    restriction's: the down leg with ``fine`` False)."""
    f = frame or LegFrame.whole(g.n)
    n, K, TW, hp = g.n, g.stages, packed2d.LEG_LANES, g.halo_lanes
    cpa = s.shape[1] if f.unpacked else s.shape[2]
    rings = bf16 or native              # bfloat16 storage: the raw rings
    dt = np.float32 if rings else np.float64
    if rings:
        assert s.dtype == bs.dtype == np.float32
        assert np.array_equal(_bf16(s), s, equal_nan=True)
        assert np.array_equal(_bf16(bs), bs, equal_nan=True)
    assert shift or (native and not fine)
    if native:
        assert f.unpacked and f.ca is None and not bf16
        assert e is None or np.array_equal(_bf16(e), e)
        h2, inv_h2, sig, inv_den, jscale = (
            np.float32(v) for v in native_bf16.constants(h, sigma, omega))
    elif bf16:
        h2, inv_h2, sig, inv_den, jscale = _coefs32(h, sigma, omega)
    else:
        h2, inv_h2, sig, inv_den, jscale = _coefs(h, sigma, omega)
    down = g.leg == "down"
    up = g.leg == "up"             # the sweep stream: neither
    assert (e is not None) == up
    red_only = kind == "rbgs" and sweeps >= 1 and not f.unpacked
    out = np.zeros_like(s)
    out_w = np.zeros(s.shape, dtype=int)
    if f.ca is None:
        cp = (n + 3) // 2
        rc = np.zeros((2, cp, (cp + 1) // 2) if packed_coarse else (cp, cp))
        rc_w = np.zeros((cp, cp), dtype=int)
    else:
        rc = np.full(f.ca[:2], np.nan)
        rc_w = np.zeros(f.ca[:2], dtype=int)
        if down:
            for q, c in f.coarse_frame():
                rc[q, c] = 0.0
                rc_w[q, c] += 1
    x = np.arange(TW)
    A = packed2d.LEG_AHEAD
    nc = (n - 1) // 2
    n_steady = [0]
    for sy in range(g.segs):
        y0, y1, ys, ye = g.rows(sy)
        assert ys % 2 == 0
        for sx in range(g.strips):
            gl, Jl, at, ok, core, upd = f.unit(g, sx, x)
            atc = [np.clip(a, 0, cpa - 1) for a in at]
            W = packed2d.LEG_WINDOW
            ur, br = _Window(W, TW, dt), _Window(W, TW, dt)
            js = [_Window(W, TW, dt) for _ in range(K)]
            rr = _Window(W, TW, dt)
            cs = _Window(packed2d.LEG_COARSE_WINDOW, TW + 1, dt)
            fr = js[K - 1] if kind == "jacobi" and K else ur
            # bfloat16: the rings of loaded rows (u and b, as the kernel's
            # raw words) and of rounded rows of u' (the down leg's residual
            # reads u' as stored).
            raw = [_Window(A, TW), _Window(A, TW)]
            qr = _Window(ROUNDED_ROWS, TW, dt)
            prolonged = set()

            lo = max(ys + 1, max(f.upd[0], 1))
            hi = min(ye - 2, min(f.upd[1], n))

            def live(i):    # a row the smoothing updates
                return lo <= i <= hi

            def load_coarse(I):
                J = Jl[0] + np.arange(TW + 1)
                if f.ca is None:
                    cp = (n + 3) // 2
                    okc = (J >= 0) & (J < cp) & (0 <= I < cp)
                    Jc, Ic = np.clip(J, 0, cp - 1), min(max(I, 0), cp - 1)
                    v = (e[(Ic + Jc) & 1, Ic, Jc >> 1] if e.ndim == 3
                         else e[Ic, Jc])
                else:
                    rc_, cc, crow, ccol = f.ca
                    okc = ((J - ccol >= 0) & (J - ccol < cc)
                           & (0 <= I - crow < rc_))
                    v = e[min(max(I - crow, 0), rc_ - 1),
                          np.clip(J - ccol, 0, cc - 1)]
                cs.put(I, np.stack([np.where(okc, v, 0.0)] * 2))

            def in_row(i, p, lanes):
                """The unpacked frame's addresses (i - goy) C + at[p] of
                ``lanes`` lie in row i and in the array; where the row's
                parity pairs a lane's two points, its phase-0 address is
                even."""
                cols = at[p][lanes]
                assert (cols >= 0).all() and (cols < f.C).all()
                addr = (i - f.goy) * f.C + cols
                assert (addr >= 0).all() and (addr < s.size).all()
                both = lanes & ok[0] & ok[1]
                if f.paired(i & 1) and both.any():
                    assert ((addr[both[lanes]] - p) % 2 == 0).all()
                    if native:
                        # The pair's first bfloat16 (2 bytes an element)
                        # on a 4-byte word of an array that starts on one.
                        assert ((addr[both[lanes]] - p) * 2 % 4 == 0).all()

            def arow(a, i):
                """Both planes of global row i at the frame's lanes: plane
                c from array lane at[(c + i) & 1] (unpacked: the row's
                column at[(c + i) & 1]); 0 off the array."""
                rows = np.zeros((2, TW), dtype=dt)
                if i < f.goy:
                    return rows
                for c in (0, 1):
                    p = (c + i) & 1
                    if f.unpacked:
                        in_row(i, p, ok[p])
                        v = a[i - f.goy, atc[p]]
                    else:
                        v = a[c, i - f.goy, atc[p]]
                    rows[c] = np.where(ok[p], v, 0.0)
                return rows

            def words(rows, i):
                """Row i as the kernel's raw words w0, w1 (load_raw),
                held in float64: the bfloat16 bits of colours 0 and 1; on
                UTile those of phases 0 and 1, or a paired lane's pair in
                w0 (phase 0 low) and 0 in w1."""
                b = torch.from_numpy(np.ascontiguousarray(rows)).to(
                    torch.bfloat16).view(torch.int16).numpy().view(
                    np.uint16).astype(np.uint32)
                w = b
                if f.unpacked:
                    ph0, ph1 = b[i & 1], b[1 - (i & 1)]
                    pair = (f.paired(i & 1) & ok[0] & ok[1]) & (i >= f.goy)
                    w = np.stack([np.where(pair, ph0 | (ph1 << 16), ph0),
                                  np.where(pair, 0, ph1)])
                return w.astype(np.float64)

            def widened(wd, i):
                """The kernel's widen_raw of row i's words."""
                w0, w1 = wd.astype(np.uint32)

                def f32(v):
                    return v.astype(np.uint32).view(np.float32)

                if not f.unpacked:
                    return np.stack([f32(w0 << 16), f32(w1 << 16)])
                # The paired parity (a tile's odd rows, the whole grid's
                # even ones): phase 1 in the pair's high half or in w1.
                pq = 0 if f.ca is None else 1
                ph0 = f32(w0 << 16)
                ph1 = (f32((w0 & 0xFFFF0000) | (w1 << 16)) if (i & 1) == pq
                       else f32(w1 << 16))
                return np.stack([ph1, ph0] if i & 1 else [ph0, ph1])

            def load(i):
                if i >= ye:
                    if kind == "jacobi" and not rings:
                        # The kernel's Jacobi stream writes 0 (load_next),
                        # a row no step may read.
                        ur.put(i, np.full((2, TW), np.nan))
                        br.put(i, np.full((2, TW), np.nan))
                    return
                if rings:
                    # Into the raw ring, whose slot's last row was widened.
                    for ring, a in zip(raw, (s, bs)):
                        k = i & (A - 1)
                        assert ring.tag[k] < 0 or np.isnan(ring.data[k]).all()
                        ring.put(i, words(arow(a, i), i))
                else:
                    ur.put(i, arow(s, i))
                    br.put(i, arow(bs, i))
                if up and i & 1 and i >= ys + A:
                    load_coarse((i + 1) >> 1)

            def widen(t):
                """bfloat16: row t leaves the raw ring for the window in
                the step that first reads it; past ye (a row not loaded)
                the kernel widens the slot's stale words, a row no step may
                read."""
                if t >= ye:
                    ur.put(t, np.full((2, TW), np.nan))
                    br.put(t, np.full((2, TW), np.nan))
                    return
                for ring, win in zip(raw, (ur, br)):
                    k = ring.slot(t)
                    win.put(t, widened(ring.data[k], t))
                    ring.data[k] = np.nan           # past its row's life

            def nbrs(win, i, c, p):
                """(up, down, left, right) of colour c's points in row i
                at phase p: the side neighbour is the other colour's value
                of the next lane (p = 1) or the one before."""
                mid = win.row(i)[1 - c]
                side = np.roll(mid, -1) if p else np.roll(mid, 1)
                return (win.row(i - 1)[1 - c], win.row(i + 1)[1 - c],
                        mid if p else side, side if p else mid)

            def gs(win, i, c, p):
                """The Gauss-Seidel value, summed as the kernel's frame
                sums it (gs_value)."""
                up, dn, left, right = nbrs(win, i, c, p)
                bv = br.row(i)[c]
                if native:
                    t = _nat(h2 * bv)
                    for nb in (up, dn, left, right):
                        t = _nat(t + nb)
                    return _nat(t * inv_den)
                if f.unpacked:
                    return ((((h2 * bv + up) + dn) + left) + right) * inv_den
                side = right if p else left
                mid = left if p else right
                return (h2 * bv + (((up + dn) + mid) + side)) * inv_den

            def resid(win, i, c, p):
                """The residual, as the kernel's frame sums it
                (residual_of)."""
                up, dn, left, right = nbrs(win, i, c, p)
                v, bv = win.row(i)[c], br.row(i)[c]
                if native:
                    t = _nat(np.float32(4) * v)
                    for nb in (up, dn, left, right):
                        t = _nat(t - nb)
                    r = _nat(bv - _nat(t * inv_h2))
                    return _nat(r + _nat(sig * v)) if shift else r
                if f.unpacked:
                    a = (((4.0 * v - up) - dn) - left) - right
                else:
                    side = right if p else left
                    mid = left if p else right
                    a = 4.0 * v - (((up + dn) + mid) + side)
                return bv - a * inv_h2 + sig * v

            def prolong(t):
                if not (t < ye and 1 <= t <= n):
                    prolonged.add(t)
                    return
                I = t >> 1
                lo_ = cs.row(I)[0]
                hi_ = cs.row(I + 1)[0] if t & 1 else lo_
                for c in (0, 1):
                    gx = 2 * Jl + ((c + t) & 1)
                    v = ur.row(t)[c]
                    if native:
                        # Rows first, then columns; x + P e rounded.
                        if t & 1:
                            a = _average(lo_[:-1], hi_[:-1])
                            d = _average(lo_[1:], hi_[1:])
                        else:
                            a, d = lo_[:-1], lo_[1:]
                        pe = np.where(gx & 1, _average(a, d), a)
                        ur.row(t)[c] = np.where((gx >= 1) & (gx <= n),
                                                _nat(v + pe), v)
                        continue
                    if t & 1:
                        a = 0.5 * (lo_[:-1] + hi_[:-1])
                        d = 0.5 * (lo_[1:] + hi_[1:])
                    else:
                        a, d = lo_[:-1], lo_[1:]
                    pe = np.where(gx & 1, 0.5 * (a + d), a)
                    ur.row(t)[c] = np.where((gx >= 1) & (gx <= n), v + pe, v)
                prolonged.add(t)

            def smooth(t, k):
                i = t - 1 - k
                if up and live(i):
                    assert all(r in prolonged for r in (i - 1, i, i + 1))
                if kind == "rbgs":
                    if not live(i):
                        return
                    c = k & 1
                    p = (c + i) & 1
                    for r in (i - 1, i, i + 1):
                        if live(r):
                            assert ur.count[ur.slot(r), 1 - c] == (k + 1) // 2
                    assert ur.count[ur.slot(i), c] == k // 2
                    new = gs(ur, i, c, p)
                    ur.row(i)[c] = np.where(upd[p], new, ur.row(i)[c])
                    ur.count[ur.slot(i), c] += 1
                    return
                if not ys <= i < ye:
                    # The kernel writes a value here no step may read.
                    js[k].put(i, np.full((2, TW), np.nan))
                    return
                src = js[k - 1] if k else ur
                rows = np.empty((2, TW))
                for c in (0, 1):
                    p = (c + i) & 1
                    v = src.row(i)[c]
                    if live(i) and native:
                        v = np.where(upd[p], _nat(v + _nat(
                            jscale * resid(src, i, c, p))), v)
                    elif live(i):
                        v = np.where(upd[p], v + jscale * resid(src, i, c, p),
                                     v)
                    rows[c] = v
                js[k].put(i, rows)

            def finished(i):
                for r in (i - 1, i, i + 1) if down else (i,):
                    if live(r) and kind == "rbgs":
                        assert list(fr.count[fr.slot(r)]) == [sweeps] * 2

            def round_row(t):
                """bfloat16 down leg: row t - K leaves the last stage,
                rounded once into the ring of rows as stored."""
                r = t - K
                qr.put(r, _bf16(fr.row(r)) if ys <= r < ye
                       else np.full((2, TW), np.nan, dtype=dt))

            def residual_store(t):
                i = t - g.out_lag
                # The down leg's residual and store read u' as stored (the
                # native mode: the window, whose values are bfloat16 ones).
                src = qr if bf16 and down else fr
                if not ys <= i < ye:
                    return
                if native:
                    for r in ((i - 1, i, i + 1) if down else (i,)):
                        if ys <= r < ye:
                            w_ = fr.row(r)
                            assert np.array_equal(_nat(w_), w_,
                                                  equal_nan=True)
                if down:
                    res = np.zeros((2, TW), dtype=dt)
                    if live(i):
                        finished(i)
                        for c in (0, 1):
                            if red_only and c:
                                continue
                            p = (c + i) & 1
                            res[c] = np.where(upd[p], resid(src, i, c, p),
                                              0.0)
                    rr.put(i, res)
                elif kind == "rbgs" and live(i):
                    finished(i)
                if fine and y0 <= i < y1:
                    if up:
                        assert i in prolonged
                    rows = src.row(i)
                    if bf16 and not down and not f32_out:
                        rows = _bf16(rows)
                    for c in (0, 1):
                        p = (c + i) & 1
                        st = core & ok[p]
                        if f.unpacked:
                            in_row(i, p, st)
                            out[i - f.goy, at[p][st]] = rows[c][st]
                            out_w[i - f.goy, at[p][st]] += 1
                        else:
                            out[c, i - f.goy, at[p][st]] = rows[c][st]
                            out_w[c, i - f.goy, at[p][st]] += 1
                if bf16 and down and ys <= i - 1:
                    # Row i - 1 was last read by this residual.
                    qr.data[qr.slot(i - 1)] = np.nan

            def restrict(t):
                j = t - g.out_lag - 1
                if j & 1 or not y0 <= j < y1:
                    return
                I = j >> 1
                # Every core lane's weighting at once: rows first at its
                # columns 2J - 1 (lane x - 1's phase 1), 2J and 2J + 1,
                # then over the three columns.
                lanes = x[core]
                fw = np.zeros(lanes.size)
                keep = f.keep or (-1, n, -1, n)
                need = [keep[0] <= I <= keep[1] and keep[2] <= Jl[xx]
                        <= keep[3] and 1 <= Jl[xx] <= nc for xx in lanes]
                if 1 <= I <= nc and any(need):
                    tq = []
                    for q in range(3):
                        lane = lanes - 1 if q == 0 else lanes
                        ph = 0 if q == 1 else 1
                        r0, r1, r2 = (rr.row(jj)[(ph + jj) & 1][lane]
                                      for jj in (j - 1, j, j + 1))
                        tq.append(_weigh(r0, r1, r2) if native
                                  else 0.25 * (r0 + 2.0 * r1 + r2))
                    fw = (_weigh(*tq) if native
                          else 0.25 * (tq[0] + 2.0 * tq[1] + tq[2]))
                for xx, fv in zip(lanes, fw):
                    J = Jl[xx]
                    if f.keep is not None:
                        ylo, yhi, xlo, xhi = f.keep
                        if not (ylo <= I <= yhi and xlo <= J <= xhi):
                            continue
                    val = fv if 1 <= I <= nc and 1 <= J <= nc else 0.0
                    if f.ca is not None:
                        I_, J_ = I - f.ca[2], J - f.ca[3]
                        rc[I_, J_] = val
                    elif packed_coarse:
                        I_, J_ = I, J
                        rc[(I + J) & 1, I, J >> 1] = val
                    else:
                        I_, J_ = I, J
                        rc[I, J] = val
                    rc_w[I_, J_] += 1

            if down:
                last_even = y1 - 1 if y1 & 1 else y1 - 2
                t_end = last_even + g.out_lag + 1
            else:
                t_end = y1 - 1 + g.out_lag
                for m in range(A // 2 + 1 if up else 0):
                    load_coarse((ys >> 1) + m)
            for i in range(A):
                load(ys + i)
            K1 = g.out_lag
            for t in range(ys, t_end + 1):
                t0 = ys + (t - ys) // W * W
                # The kernel's test for a chunk of W steps run with no row
                # tests (packed2d_legs.cuh, `chunk`): then every row test
                # of the step holds.
                if down:
                    steady = (t0 - K1 >= lo and t0 - K1 - 1 >= y0
                              and t0 + W - 2 <= hi and t0 + W - 1 - K1 < y1
                              and t0 + W - 1 + A < ye)
                else:
                    steady = ((not up or (t0 >= 1 and t0 + W - 1 <= n))
                              and t0 - K >= lo
                              and t0 + W - 2 <= hi and t0 - K1 >= y0
                              and t0 + W - 1 - K1 < y1
                              and t0 + W - 1 + A < ye)
                if steady:
                    assert t + A < ye and t + A >= f.goy
                    assert all(lo <= t - 1 - k <= hi for k in range(K))
                    assert y0 <= t - K1 < y1
                    if down:
                        assert lo <= t - K1 <= hi
                        assert y0 <= t - K1 - 1 < y1
                    elif up:
                        assert 1 <= t <= n
                    n_steady[0] += 1
                if rings:
                    widen(t)
                load(t + A)
                for win in (ur, br, *js):
                    win.limit = t
                cs.limit = (t + 1) >> 1
                if up:
                    prolong(t)
                for k in range(K):
                    smooth(t, k)
                if bf16 and down:
                    round_row(t)
                residual_store(t)
                if down:
                    restrict(t)
    _emulate_leg.steady_steps = n_steady[0]
    if not fine:
        assert down and not out_w.any(), "u' stored"
    else:
        assert (out_w == 1).all(), "a point of u' stored more or less than " \
                                   "once"
    if down:
        assert (rc_w == 1).all(), "a coarse point written more or less " \
                                  "than once"
        return (out, rc) if fine else rc
    return out


def _emulation_cases(cap_of):
    return [(kind, s) for kind in ("rbgs", "jacobi")
            for s in range(cap_of(kind) + 1)]


# Segment rows: 8 and 10 give several short segments at n = 61 (each
# with two strips, the second partial); 64, one segment, as the card runs
# n = 61, with chunks of steps that need no row tests.
_EMULATED = [8, 10, 64]


@pytest.mark.parametrize("seg", _EMULATED)
@pytest.mark.parametrize("kind,sweeps",
                         _emulation_cases(packed2d.max_down_sweeps))
def test_row_stream_down_schedule_matches_plain(kind, sweeps, seg):
    n = 61
    rng = np.random.default_rng(6000 + sweeps)
    u, b = _padded(rng, n), _padded(rng, n) * (n + 1) ** 2
    h = 1.0 / (n + 1)
    pc = bool(sweeps & 1)
    g = packed2d.leg_geometry("down", n, kind, sweeps, seg=seg)
    assert (g.segs > 1 or seg >= n + 2) and g.span() <= packed2d.LEG_WINDOW
    assert g.strips > 1 or sweeps == 0
    su, sb = _tpack(u), _tpack(b)
    got_u, got_rc = _emulate_leg(g, kind, sweeps, su.numpy(), sb.numpy(), h,
                                 SIGMA, OMEGA[kind], packed_coarse=pc)
    assert _emulate_leg.steady_steps > 0 or seg < 64
    want_u, want_rc = packed2d.smooth_residual_restrict_plain(
        su, sb, n, h, kind=kind, omega=OMEGA[kind], sweeps=sweeps,
        sigma=SIGMA, packed_coarse=pc)
    _close(torch.from_numpy(got_u), packed2d.unpack(want_u).numpy(), n)
    nc = (n - 1) // 2
    want_rc = packed2d.unpack(want_rc) if pc else want_rc
    _close(torch.from_numpy(got_rc), want_rc.numpy(), nc)


@pytest.mark.parametrize("seg", _EMULATED)
@pytest.mark.parametrize("kind,sweeps",
                         _emulation_cases(packed2d.max_up_sweeps))
def test_row_stream_up_schedule_matches_plain(kind, sweeps, seg):
    n = 61
    nc = (n - 1) // 2
    rng = np.random.default_rng(7000 + sweeps)
    x, b, e = _padded(rng, n), _padded(rng, n), _padded(rng, nc)
    h = 1.0 / (n + 1)
    te = _tpack(e) if sweeps & 1 else torch.from_numpy(e)
    g = packed2d.leg_geometry("up", n, kind, sweeps, seg=seg)
    assert (g.segs > 1 or seg >= n + 2) and g.span() <= packed2d.LEG_WINDOW
    assert g.strips > 1 or sweeps == 0
    sx, sb = _tpack(x), _tpack(b)
    got = _emulate_leg(g, kind, sweeps, sx.numpy(), sb.numpy(), h, SIGMA,
                       OMEGA[kind], e=te.numpy())
    assert _emulate_leg.steady_steps > 0 or seg < 64
    want = packed2d.prolong_add_smooth_plain(
        sx, te, sb, n, nc, h, kind=kind, omega=OMEGA[kind], sweeps=sweeps,
        sigma=SIGMA)
    _close(torch.from_numpy(got), packed2d.unpack(want).numpy(), n)


# The bfloat16 storage modes on the whole packed grid (n = 61, as above):
# zero-stage legs (mixedA's), RB-GS nu = 2 (the mixed paths') and odd
# Jacobi counts, segments of 8 or 10 rows (several) and of 64 (one, with
# steady chunks); held against the plain versions on the same bfloat16
# grids by the bfloat16 rule (_bf16_rule) or, a float32 output, to 1e-5 of
# its largest value; the down leg's coarse output against the plain
# restriction of the emulated u' (the residual of u' as stored: a one-ulp
# flip of u' moves it by 4/h^2 of an ulp, far past that tolerance).
_BF16_DOWN = [("rbgs", 0, 8), ("rbgs", 0, 64), ("rbgs", 2, 10),
              ("rbgs", 2, 64), ("jacobi", 0, 10), ("jacobi", 3, 8),
              ("jacobi", 2, 64)]
_BF16_UP = [("rbgs", 0, 10), ("rbgs", 2, 8), ("rbgs", 2, 64),
            ("jacobi", 3, 10), ("jacobi", 2, 64)]
BF = torch.bfloat16


def _bf16_grids(seed, n):
    """Packed bfloat16 u and b (b of 1/h^2 size) from a numpy seed."""
    rng = np.random.default_rng(seed)
    u, b = _padded(rng, n), _padded(rng, n) * (n + 1) ** 2
    return (packed2d.pack(torch.from_numpy(a).to(BF)) for a in (u, b)), rng


@pytest.mark.parametrize("kind,sweeps,seg", _BF16_DOWN)
def test_row_stream_bf16_down_schedule_matches_plain(kind, sweeps, seg):
    n = 61
    (su, sb), _ = _bf16_grids(6100 + sweeps, n)
    h = 1.0 / (n + 1)
    pc = bool(sweeps & 1)
    g = packed2d.leg_geometry("down", n, kind, sweeps, seg=seg)
    assert (g.segs > 1) == (seg < 64) and (g.strips > 1 or sweeps == 0)
    got_u, got_rc = _emulate_leg(g, kind, sweeps, su.float().numpy(),
                                 sb.float().numpy(), h, SIGMA, OMEGA[kind],
                                 packed_coarse=pc, bf16=True)
    assert _emulate_leg.steady_steps > 0 or seg < 64
    want_u, want_rc = packed2d.smooth_residual_restrict_plain(
        su, sb, n, h, kind=kind, omega=OMEGA[kind], sweeps=sweeps,
        sigma=SIGMA, packed_coarse=pc)
    _bf16_rule(got_u, want_u)
    own = packed2d.residual_restrict_plain(
        torch.from_numpy(got_u).to(BF), sb, n, h,
        red_only=kind == "rbgs" and sweeps >= 1, sigma=SIGMA,
        packed_coarse=pc)
    assert own.dtype == torch.float32
    _f32_close(got_rc, own)
    if np.array_equal(got_u, want_u.float().numpy()):
        _f32_close(got_rc, want_rc)


@pytest.mark.parametrize("f32_out", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("kind,sweeps,seg", _BF16_UP)
def test_row_stream_bf16_up_schedule_matches_plain(kind, sweeps, seg,
                                                   f32_out):
    """x and b bfloat16, e float32 (logical, or packed at odd sweeps); x'
    in bfloat16 or, with f32_out, float32 (the top level of a mixed
    cycle)."""
    n = 61
    nc = (n - 1) // 2
    (sx, sb), rng = _bf16_grids(7100 + sweeps, n)
    e = torch.from_numpy(_padded(rng, nc)).float()
    te = packed2d.pack(e) if sweeps & 1 else e
    h = 1.0 / (n + 1)
    g = packed2d.leg_geometry("up", n, kind, sweeps, seg=seg)
    assert (g.segs > 1) == (seg < 64)
    got = _emulate_leg(g, kind, sweeps, sx.float().numpy(),
                       sb.float().numpy(), h, SIGMA, OMEGA[kind],
                       e=te.numpy(), bf16=True, f32_out=f32_out)
    want = packed2d.prolong_add_smooth_plain(
        sx, te, sb, n, nc, h, kind=kind, omega=OMEGA[kind], sweeps=sweeps,
        sigma=SIGMA, out_dtype=torch.float32 if f32_out else None)
    if f32_out:
        assert want.dtype == torch.float32
        _f32_close(got, want)
    else:
        _bf16_rule(got, want)


@pytest.mark.parametrize("sweeps,seg", [(1, 8), (2, 64), (4, 10)])
def test_row_stream_bf16_sweep_schedule_matches_plain(sweeps, seg):
    """The bfloat16 RB-GS sweep (mixedB's pre-smoothing at 4095^2): the up
    leg's stream without its coarse operand, on the same rings."""
    n = 61
    (su, sb), _ = _bf16_grids(8100 + sweeps, n)
    h = 1.0 / (n + 1)
    g = packed2d.leg_geometry("sweep", n, "rbgs", sweeps, seg=seg)
    assert (g.segs > 1) == (seg < 64)
    got = _emulate_leg(g, "rbgs", sweeps, su.float().numpy(),
                       sb.float().numpy(), h, SIGMA, 1.0, bf16=True)
    _bf16_rule(got, packed2d.rbgs_sweep_plain(su, sb, n, h, sweeps=sweeps,
                                              sigma=SIGMA))


_GEOMETRY_CASES = [(leg, n, kind, cap_of(kind))
                   for n in (61, 2999, 4095)
                   for leg, cap_of in (("down", packed2d.max_down_sweeps),
                                       ("up", packed2d.max_up_sweeps))
                   for kind in ("rbgs", "jacobi")]


@pytest.mark.parametrize("leg,n,kind,sweeps", _GEOMETRY_CASES)
def test_leg_geometry_owns_each_point_once(leg, n, kind, sweeps):
    """Every row and lane of the fine grid lies in exactly one unit's
    store, and every coarse point (fine row 2I, lane J) in one unit's
    restriction; each unit streams the halo rows its stages need."""
    g = packed2d.leg_geometry(leg, n, kind, sweeps)
    p, cp = n + 2, (n + 3) // 2
    rows = np.zeros(p, dtype=int)
    coarse_rows = np.zeros(cp, dtype=int)
    for sy in range(g.segs):
        y0, y1, ys, ye = g.rows(sy)
        assert y0 % 2 == 0 and y0 < y1 and ys % 2 == 0
        rows[y0:y1] += 1
        coarse_rows[(y0 + 1) // 2:(y1 + 1) // 2] += 1
        need_above = g.stages + (2 if leg == "down" else 0)
        need_below = g.stages + (1 if leg == "down" else 0)
        assert ys <= max(0, y0 - need_above)
        assert ye == min(p, y1 + need_below)
    lanes = np.zeros(cp, dtype=int)
    for sx in range(g.strips):
        l0, l1 = g.strip_lanes(sx)
        assert l0 < l1
        lanes[l0:l1] += 1
    assert (rows == 1).all() and (coarse_rows == 1).all()
    assert (lanes == 1).all()           # coarse columns J are lanes too
    assert g.strip + 2 * g.halo_lanes == packed2d.LEG_LANES
    # Fine columns of halo each side cover the stale columns.
    assert 2 * g.halo_lanes >= g.stages + (2 if leg == "down" else 0)


@pytest.mark.parametrize("leg,cap_of", [("down", packed2d.max_down_sweeps),
                                        ("up", packed2d.max_up_sweeps)])
@pytest.mark.parametrize("kind", ["rbgs", "jacobi"])
def test_leg_geometry_fits_its_window(leg, cap_of, kind):
    """At every sweep count up to the cap the rows a lane holds at once fit
    the kernel's register window (it needs no shared memory), the lags put
    the residual or store after the last stage, and the launch fills the
    card: at least LEG_WARPS_PER_SM warps' worth of units at 4095^2."""
    for sweeps in range(cap_of(kind) + 1):
        g = packed2d.leg_geometry(leg, 4095, kind, sweeps)
        assert g.span() <= packed2d.LEG_WINDOW
        # Stage k on row t - 1 - k: the last stage's row is at or behind
        # the up leg's store and ahead of the down leg's residual.
        assert g.stages < g.out_lag + (leg == "up")
        assert g.strips * g.segs >= 132 * packed2d.LEG_WARPS_PER_SM * 0.9


def test_leg_constants_match_the_kernel_source():
    """packed2d's LEG_* constants, the stage caps (the whole grid's and,
    from local2d's sweep caps, a tile's) and the geometry's ints are the
    ones csrc/packed2d_legs.cuh compiles with."""
    import re

    src = (packed2d._build.CSRC / "packed2d_legs.cuh").read_text()
    const = {name: int(v) for name, v in
             re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kWarp"] == packed2d.LEG_LANES
    assert const["kAhead"] == packed2d.LEG_AHEAD
    assert const["kWin"] == packed2d.LEG_WINDOW
    assert const["kCoarseWin"] == packed2d.LEG_COARSE_WINDOW
    assert const["kRounded"] == ROUNDED_ROWS
    for cap_of, key in ((packed2d.max_down_sweeps, "kMaxDownStages"),
                        (packed2d.max_up_sweeps, "kMaxUpStages"),
                        (local2d.max_down_sweeps, "kMaxTileStages"),
                        (local2d.max_up_sweeps, "kMaxTileStages")):
        assert const[key] == max(2 * cap_of("rbgs"), cap_of("jacobi"))
    fields = re.search(r"struct LegGeom \{\s*int ([^;]*);", src).group(1)
    g = packed2d.leg_geometry("down", 61, "rbgs", 2)
    assert len(fields.split(",")) == len(g.ints()) == 7
