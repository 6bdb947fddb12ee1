"""The kernel modules of the PyTorch port (multigridcmt_tpu_torch.kernels)
against the JAX package's Pallas kernels, run in interpret mode on the CPU
and called as tests/test_fused_kernels.py calls them.

On a CPU tensor each wrapper takes its plain PyTorch version, so these
tests pin that version, which chip_smoke.py then holds the CUDA kernel
against on the card. Inputs are float64, made with numpy from a seed.
Tolerance: rtol 1e-12 and atol 1e-12 * max|ref| (the Pallas kernels and
the plain versions evaluate the same formulas in other orders, e.g. a
reciprocal product against a division). n=255 spans several Pallas
tiles. Sweep counts run from 0 to each leg's cap for RB-GS (the solve's
smoother) at n=63 with a shift, and over the ends of the range elsewhere,
to keep the interpret-mode calls within the suite's time budget; the
stencil2d sweeps run 1 to 4 RB-GS and 1 and 8 Jacobi sweeps at both sizes,
with and without a shift.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigridcmt_tpu.grids import from_aligned, to_aligned
from multigridcmt_tpu.kernels import fused2d as jfused2d
from multigridcmt_tpu.kernels import stencil2d as jstencil2d
from multigridcmt_tpu_torch.kernels import fused2d, stencil2d

OMEGA = {"rbgs": 1.0, "jacobi": 0.8}
SIGMA = 11.5


def _padded(rng, n):
    a = np.zeros((n + 2, n + 2))
    a[1:-1, 1:-1] = rng.standard_normal((n, n))
    return a


def _close_with_zero_ghosts(got: torch.Tensor, want, m: int) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == (m + 2, m + 2)
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    ghosts = got.copy()
    ghosts[1:-1, 1:-1] = 0.0
    assert np.abs(ghosts).max() == 0.0


def _down_cases():
    cases = []
    for kind in ("rbgs", "jacobi"):
        cap = fused2d.max_down_sweeps(kind)
        full = range(cap + 1) if kind == "rbgs" else (0, 1, cap // 2, cap)
        cases += [(63, kind, s, SIGMA) for s in full]
        cases += [(63, kind, cap, 0.0), (255, kind, 0, 0.0),
                  (255, kind, cap, 0.0), (255, kind, cap, SIGMA)]
    return cases


def _up_cases():
    cases = []
    for kind in ("rbgs", "jacobi"):
        cap = fused2d.max_up_sweeps(kind)
        full = range(cap + 1) if kind == "rbgs" else (0, 1, cap // 2, cap)
        cases += [(63, kind, s, SIGMA) for s in full]
        cases += [(63, kind, cap, 0.0), (255, kind, 2, 0.0),
                  (255, kind, cap, 0.0), (255, kind, cap, SIGMA)]
    return cases


def test_sweep_caps_match_jax():
    for kind in ("rbgs", "jacobi"):
        assert fused2d.max_down_sweeps(kind) == jfused2d.max_down_sweeps(kind)
        assert fused2d.max_up_sweeps(kind) == jfused2d.max_up_sweeps(kind)
        assert (stencil2d.max_fused_sweeps(kind)
                == jstencil2d.max_fused_sweeps(kind))


@pytest.mark.parametrize("n,kind,sweeps,sigma", _down_cases())
def test_down_leg_matches_pallas(n, kind, sweeps, sigma):
    rng = np.random.default_rng(1000 + n + sweeps)
    u, b = _padded(rng, n), _padded(rng, n)
    h = 1.0 / (n + 1)
    nc = (n - 1) // 2
    ju, jrc = jfused2d.smooth_residual_restrict(
        to_aligned(jnp.asarray(u)), to_aligned(jnp.asarray(b)), n, h,
        kind=kind, omega=OMEGA[kind], sweeps=sweeps, sigma=sigma)
    before = fused2d.down_launches
    tu, trc = fused2d.smooth_residual_restrict(
        torch.from_numpy(u), torch.from_numpy(b), n, h, kind=kind,
        omega=OMEGA[kind], sweeps=sweeps, sigma=sigma)
    assert fused2d.down_launches == before      # CPU: the plain version
    _close_with_zero_ghosts(tu, from_aligned(ju, n), n)
    _close_with_zero_ghosts(trc, from_aligned(jrc, nc), nc)


@pytest.mark.parametrize("n,kind,sweeps,sigma", _up_cases())
def test_up_leg_matches_pallas(n, kind, sweeps, sigma):
    rng = np.random.default_rng(2000 + n + sweeps)
    nc = (n - 1) // 2
    x, b, e = _padded(rng, n), _padded(rng, n), _padded(rng, nc)
    h = 1.0 / (n + 1)
    jx = jfused2d.prolong_add_smooth(
        to_aligned(jnp.asarray(x)), to_aligned(jnp.asarray(e)),
        to_aligned(jnp.asarray(b)), n, nc, h, kind=kind, omega=OMEGA[kind],
        sweeps=sweeps, sigma=sigma)
    before = fused2d.up_launches
    tx = fused2d.prolong_add_smooth(
        torch.from_numpy(x), torch.from_numpy(e), torch.from_numpy(b), n, nc,
        h, kind=kind, omega=OMEGA[kind], sweeps=sweeps, sigma=sigma)
    assert fused2d.up_launches == before
    _close_with_zero_ghosts(tx, from_aligned(jx, n), n)


@pytest.mark.parametrize("n", [63, 255])
@pytest.mark.parametrize("sigma", [0.0, SIGMA])
def test_residual_matches_pallas(n, sigma):
    rng = np.random.default_rng(3000 + n)
    u, b = _padded(rng, n), _padded(rng, n)
    h = 1.0 / (n + 1)
    jr = jstencil2d.residual(to_aligned(jnp.asarray(u)),
                             to_aligned(jnp.asarray(b)), n, h, sigma=sigma)
    before = stencil2d.launches
    tr = stencil2d.residual(torch.from_numpy(u), torch.from_numpy(b), n, h,
                            sigma=sigma)
    assert stencil2d.launches == before
    _close_with_zero_ghosts(tr, from_aligned(jr, n), n)


def _sweep_counts():
    return stencil2d.rbgs_launches, stencil2d.jacobi_launches


@pytest.mark.parametrize("n", [63, 255])
@pytest.mark.parametrize("sigma", [0.0, SIGMA])
@pytest.mark.parametrize("kind,sweeps", [("rbgs", 1), ("rbgs", 2),
                                         ("rbgs", 3), ("rbgs", 4),
                                         ("jacobi", 1), ("jacobi", 8)])
def test_sweeps_match_pallas(kind, sweeps, sigma, n):
    """The fused sweeps (the smoothing of a kernel-tier level whose legs do
    not fuse); b is scaled by 1/h^2 so that both terms of the update
    count."""
    rng = np.random.default_rng(3500 + n + sweeps)
    h = 1.0 / (n + 1)
    u, b = _padded(rng, n), _padded(rng, n) / h ** 2
    ju, jb = to_aligned(jnp.asarray(u)), to_aligned(jnp.asarray(b))
    tu, tb = torch.from_numpy(u), torch.from_numpy(b)
    before = _sweep_counts()
    if kind == "rbgs":
        want = jstencil2d.rbgs_sweep(ju, jb, n, h, sigma=sigma, sweeps=sweeps)
        got = stencil2d.rbgs_sweep(tu, tb, n, h, sigma=sigma, sweeps=sweeps)
        plain = stencil2d.rbgs_sweep_plain(tu, tb, n, h, sigma=sigma,
                                           sweeps=sweeps)
    else:
        want = jstencil2d.jacobi_sweep(ju, jb, n, h, OMEGA[kind],
                                       sigma=sigma, sweeps=sweeps)
        got = stencil2d.jacobi_sweep(tu, tb, n, h, OMEGA[kind], sigma=sigma,
                                     sweeps=sweeps)
        plain = stencil2d.jacobi_sweep_plain(tu, tb, n, h, OMEGA[kind],
                                             sigma=sigma, sweeps=sweeps)
    assert _sweep_counts() == before           # CPU: the plain version
    assert torch.equal(got, plain)
    _close_with_zero_ghosts(got, from_aligned(want, n), n)


@pytest.mark.parametrize("kind,sweeps", [("rbgs", 0), ("rbgs", 5),
                                         ("jacobi", 9)])
def test_sweeps_reject_counts_beyond_one_launch(kind, sweeps):
    g = torch.zeros((9, 9), dtype=torch.float64)
    with pytest.raises(ValueError):
        if kind == "rbgs":
            stencil2d.rbgs_sweep(g, g, 7, 0.125, sweeps=sweeps)
        else:
            stencil2d.jacobi_sweep(g, g, 7, 0.125, 0.8, sweeps=sweeps)
    assert _sweep_counts() == (0, 0)
