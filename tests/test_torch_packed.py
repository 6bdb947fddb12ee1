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
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multigridcmt_tpu as jmg
import multigridcmt_tpu_torch as mt
from multigridcmt_tpu import kernels as jkernels
from multigridcmt_tpu.grids import from_aligned, to_aligned
from multigridcmt_tpu.kernels import packed2d as jpacked2d
from multigridcmt_tpu_torch import convert, kernels
from multigridcmt_tpu_torch.kernels import fused2d, packed2d, stencil2d

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
