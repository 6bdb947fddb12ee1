"""The fused transfers of the PyTorch port (kernels/transfer2d.py) against
the JAX package's transfer2d Pallas kernels in interpret mode, called as
tests/test_kernels.py calls them, and the solves whose legs exceed the
fused caps, which compose each leg from a sweep kernel and a transfer
kernel, against the JAX package's Pallas route.

On a CPU tensor each wrapper takes its plain PyTorch version, so these
tests pin that version, which chip_smoke.py then holds the CUDA kernel
against on the card. Inputs are float64, made with numpy from a seed.
Tolerance for the kernels: rtol 1e-12 and atol 1e-12 * max|ref| (the
Pallas kernels weight rows and columns in another order and by selection
matmuls); n=255 spans several Pallas row tiles. For the solves: the JAX
iteration count, iterates at rtol 1e-8 and atol 1e-12, and residual
histories at rtol 1e-8 down to the float64 rounding floor of the residual
(~1e-14 of ||b||, atol 1e-13, as in test_torch_solve.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multigridcmt_tpu as jmg
import multigridcmt_tpu_torch as mt
from multigridcmt_tpu import kernels as jkernels
from multigridcmt_tpu.grids import from_aligned, to_aligned
from multigridcmt_tpu.kernels import transfer2d as jtransfer2d
from multigridcmt_tpu_torch import convert, kernels
from multigridcmt_tpu_torch.kernels import (fused2d, packed2d, stencil2d,
                                            transfer2d)


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


def _counts():
    return (transfer2d.residual_restrict_launches,
            transfer2d.prolong_add_launches)


@pytest.mark.parametrize("n", [63, 255])
def test_residual_restrict_matches_pallas(n):
    rng = np.random.default_rng(8000 + n)
    u, b = _padded(rng, n), _padded(rng, n)
    h = 1.0 / (n + 1)
    nc = (n - 1) // 2
    want = jtransfer2d.residual_restrict(to_aligned(jnp.asarray(u)),
                                         to_aligned(jnp.asarray(b)), n, h)
    before = _counts()
    got = transfer2d.residual_restrict(torch.from_numpy(u),
                                       torch.from_numpy(b), n, h)
    assert _counts() == before                 # CPU: the plain version
    _close_with_zero_ghosts(got, from_aligned(want, nc), nc)


@pytest.mark.parametrize("n", [63, 255])
def test_prolong_add_matches_pallas(n):
    rng = np.random.default_rng(9000 + n)
    nc = (n - 1) // 2
    x, e = _padded(rng, n), _padded(rng, nc)
    want = jtransfer2d.prolong_add(to_aligned(jnp.asarray(x)),
                                   to_aligned(jnp.asarray(e)), n, nc)
    before = _counts()
    got = transfer2d.prolong_add(torch.from_numpy(x), torch.from_numpy(e), n,
                                 nc)
    assert _counts() == before
    _close_with_zero_ghosts(got, from_aligned(want, n), n)


def test_wrappers_reject_mismatched_levels():
    g = torch.zeros((9, 9), dtype=torch.float64)
    with pytest.raises(ValueError):
        transfer2d.residual_restrict(g, g, 8, 1 / 9)
    with pytest.raises(ValueError):
        transfer2d.prolong_add(g, torch.zeros((5, 5), dtype=torch.float64),
                               7, 2)
    assert _counts() == (0, 0)


def _spy(monkeypatch, calls, key, mod, name, arg):
    """Record argument ``arg`` (an index, or a keyword) of every call."""
    def spy(*a, _f=getattr(mod, name), **kw):
        calls[key].append(kw[arg] if isinstance(arg, str) else a[arg])
        return _f(*a, **kw)
    monkeypatch.setattr(mod, name, spy)


@pytest.mark.parametrize("smoother,nu1,nu2", [("rbgs", 4, 5),
                                              ("jacobi", 8, 9)])
def test_long_schedule_solve_matches_jax(smoother, nu1, nu2, monkeypatch):
    """k=6 with KERNEL_MIN_N/PALLAS_MIN_N = 20 and PACK_MIN_N = 40 in both
    packages: level 63 is packed and 31 is on the unpacked kernel tier.
    Both schedules exceed the fused caps of both legs on both tiers, so
    every leg composes: the packed level smooths with the packed RB-GS
    sweep (in chunks of 4) or the packed residual, and runs the zero-sweep
    packed legs as its residual-restrict and prolong-add; level 31 runs the
    stencil2d sweeps in chunks of max_fused_sweeps and the transfer2d
    kernels."""
    for mod in (jkernels, kernels):
        monkeypatch.setattr(mod, "PACK_MIN_N", 40)
    monkeypatch.setattr(jkernels, "PALLAS_MIN_N", 20)
    monkeypatch.setattr(kernels, "KERNEL_MIN_N", 20)
    jprob = jmg.poisson2d(k=6, dtype=jnp.float64, smoother=smoother,
                          nu1=nu1, nu2=nu2, tol=1e-9, use_pallas=True)
    want = jmg.MultigridSolver(jprob).solve()
    prob = convert.problem_from_jax(jprob, device="cpu")
    assert (prob.config.nu1, prob.config.nu2) == (nu1, nu2)

    calls = {key: [] for key in ("rr", "pa", "sweep", "psweep", "pres",
                                 "pdown", "pup", "fused")}
    sweep = "rbgs_sweep" if smoother == "rbgs" else "jacobi_sweep"
    _spy(monkeypatch, calls, "rr", transfer2d, "residual_restrict", 2)
    _spy(monkeypatch, calls, "pa", transfer2d, "prolong_add", 2)
    _spy(monkeypatch, calls, "sweep", stencil2d, sweep, "sweeps")
    _spy(monkeypatch, calls, "psweep", packed2d, "rbgs_sweep", "sweeps")
    _spy(monkeypatch, calls, "pres", packed2d, "residual", 2)
    _spy(monkeypatch, calls, "pdown", packed2d, "smooth_residual_restrict",
         "sweeps")
    _spy(monkeypatch, calls, "pup", packed2d, "prolong_add_smooth", "sweeps")
    for name in ("smooth_residual_restrict", "prolong_add_smooth"):
        _spy(monkeypatch, calls, "fused", fused2d, name, 2)
    got = mt.MultigridSolver(prob).solve()

    iters = int(want.iters)
    assert got.iters == iters and got.converged
    np.testing.assert_allclose(got.res_history.numpy(),
                               np.asarray(want.res_history),
                               rtol=1e-8, atol=1e-13)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x),
                               rtol=1e-8, atol=1e-12)
    cap = stencil2d.max_fused_sweeps(smoother)
    chunks = lambda nu: [cap] * (nu // cap) + [nu % cap] * bool(nu % cap)
    assert calls["rr"] == [31] * iters
    assert calls["pa"] == [31] * iters
    assert calls["sweep"] == (chunks(nu1) + chunks(nu2)) * iters
    assert calls["pdown"] == [0] * iters        # the zero-sweep down leg
    assert calls["pup"] == [0] * iters
    assert calls["fused"] == []
    if smoother == "rbgs":
        assert calls["psweep"] == (chunks(nu1) + chunks(nu2)) * iters
        assert calls["pres"] == []
    else:
        # Packed Jacobi: one residual a sweep.
        assert calls["psweep"] == []
        assert calls["pres"] == [63] * (nu1 + nu2) * iters
