"""The Chebyshev smoother of the PyTorch port against the JAX package: the
plain smoother (ops/smoothers.py) in 1D, 2D and 3D, the kernel backend's
Chebyshev smoothing on a packed and on an unpacked kernel-tier level
against JAX's Pallas backend (kernels in interpret mode), and Chebyshev
solves end to end: the 2D kernel route, MG-PCG and the 3D plain route.

Inputs are float64, made with numpy from a seed. Tolerance for the
smoothers: rtol 1e-12 and atol 1e-12 * max|ref| (the same recurrence; the
residuals differ in rounding order). For the solves: the JAX iteration
count, iterates at rtol 1e-8 and atol 1e-12, residual histories at rtol
1e-8 down to the float64 rounding floor of the residual (~1e-14 of ||b||,
atol 1e-13, as in test_torch_solve.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multigridcmt_tpu as jmg
import multigridcmt_tpu_torch as mt
from multigridcmt_tpu import kernels as jkernels
from multigridcmt_tpu.ops import smoothers as jsmoothers
from multigridcmt_tpu_torch import convert, kernels
from multigridcmt_tpu_torch.kernels import (fused2d, packed2d, stencil2d,
                                            transfer2d)
from multigridcmt_tpu_torch.ops import smoothers
from multigridcmt_tpu_torch.solvers import krylov

SIGMA = 11.5


def _padded(rng, n, ndim=2):
    a = np.zeros((n + 2,) * ndim)
    a[(slice(1, -1),) * ndim] = rng.standard_normal((n,) * ndim)
    return a


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("ndim,n", [(1, 63), (2, 31), (3, 7)])
@pytest.mark.parametrize("degree", [0, 1, 2, 3])
@pytest.mark.parametrize("sigma", [0.0, SIGMA])
def test_chebyshev_matches_jax(ndim, n, degree, sigma):
    rng = np.random.default_rng(100 * ndim + degree)
    h = 1.0 / (n + 1)
    u, b = _padded(rng, n, ndim), _padded(rng, n, ndim) / h ** 2
    tu, tb = torch.from_numpy(u), torch.from_numpy(b)
    want = jsmoothers.chebyshev(jnp.asarray(u), jnp.asarray(b), h, degree,
                                sigma=sigma)
    got = smoothers.chebyshev(tu, tb, h, degree, sigma=sigma)
    _close(got, want)
    # smooth(kind="chebyshev") is one polynomial of degree `sweeps`; the
    # identity at degree 0.
    assert torch.equal(smoothers.smooth(tu, tb, h, kind="chebyshev",
                                        omega=0.8, sweeps=degree,
                                        sigma=sigma), got)
    if degree == 0:
        assert got is tu


@pytest.mark.parametrize("n,pack_min_n", [(63, 40), (31, 3000)],
                         ids=["packed", "unpacked"])
@pytest.mark.parametrize("degree,sigma", [(2, 0.0), (3, SIGMA)])
def test_kernel_backend_chebyshev_matches_pallas(n, pack_min_n, degree,
                                                 sigma, monkeypatch):
    """The kernel backend's smooth(kind="chebyshev") on a packed level
    (the packed residual's route) and on an unpacked kernel-tier level
    (the stencil2d residual's), against PALLAS_BACKEND.smooth, each in its
    own layout. The packed result keeps its pad lanes at zero: the
    residual's pad lanes are zero, so the updates are too."""
    monkeypatch.setattr(jkernels, "PALLAS_MIN_N", 20)
    monkeypatch.setattr(jkernels, "PACK_MIN_N", pack_min_n)
    monkeypatch.setattr(kernels, "KERNEL_MIN_N", 20)
    monkeypatch.setattr(kernels, "PACK_MIN_N", pack_min_n)
    rng = np.random.default_rng(200 + n + degree)
    h = 1.0 / (n + 1)
    u, b = _padded(rng, n), _padded(rng, n) / h ** 2
    jbk, bk = jkernels.PALLAS_BACKEND, kernels.KERNEL_BACKEND
    kw = dict(kind="chebyshev", omega=0.8, sweeps=degree, sigma=sigma)
    want = jbk.decode(jbk.smooth(jbk.encode(jnp.asarray(u)),
                                 jbk.encode(jnp.asarray(b)), n, h, **kw), n)
    calls = []
    for mod in (packed2d, stencil2d):
        def spy(*a, _f=mod.residual, _m=mod.__name__, **k):
            calls.append(_m.rsplit(".", 1)[1])
            return _f(*a, **k)
        monkeypatch.setattr(mod, "residual", spy)
    tu, tb = bk.encode(torch.from_numpy(u)), bk.encode(torch.from_numpy(b))
    got = bk.smooth(tu, tb, n, h, **kw)
    assert packed2d.is_packed(got) == (n >= pack_min_n)
    assert calls == ["packed2d" if n >= pack_min_n else "stencil2d"] * degree
    if packed2d.is_packed(got):
        assert torch.equal(packed2d.pack(packed2d.unpack(got)), got)
    _close(bk.decode(got), want)


def _spy_calls(monkeypatch):
    """Record the fine n of each call to the wrappers a Chebyshev cycle
    reaches (and of the fused legs, which it must not)."""
    calls = {}
    # (key, module, wrapper, position of the fine n among its arguments)
    for key, mod, name, pos in (
            ("pres", packed2d, "residual", 2),
            ("pdown", packed2d, "smooth_residual_restrict", 2),
            ("pup", packed2d, "prolong_add_smooth", 3),
            ("norm", packed2d, "residual_norm_sq", 2),
            ("sres", stencil2d, "residual", 2),
            ("rr", transfer2d, "residual_restrict", 2),
            ("pa", transfer2d, "prolong_add", 2),
            ("fdown", fused2d, "smooth_residual_restrict", 2),
            ("fup", fused2d, "prolong_add_smooth", 3)):
        calls[key] = []

        def spy(*a, _f=getattr(mod, name), _k=key, _p=pos, **kw):
            calls[_k].append(a[_p])
            if _k == "norm":
                assert kw["red_only"] is False   # not after an RB-GS sweep
            return _f(*a, **kw)
        monkeypatch.setattr(mod, name, spy)
    return calls


def _thresholds(monkeypatch):
    """Level 63 packed, 31 on the unpacked kernel tier, in both packages."""
    for mod in (jkernels, kernels):
        monkeypatch.setattr(mod, "PACK_MIN_N", 40)
    monkeypatch.setattr(jkernels, "PALLAS_MIN_N", 20)
    monkeypatch.setattr(kernels, "KERNEL_MIN_N", 20)


def _agree(got, want):
    iters = int(want.iters)
    assert got.iters == iters and got.converged == bool(want.converged)
    np.testing.assert_allclose(got.res_history.numpy(),
                               np.asarray(want.res_history),
                               rtol=1e-8, atol=1e-13)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x),
                               rtol=1e-8, atol=1e-12)


def test_chebyshev_solve_matches_jax_pallas(monkeypatch):
    """V(2,2) Chebyshev at k=6: no leg fuses, so level 63 (packed) smooths
    from the packed residual and runs the zero-sweep packed legs, level 31
    smooths from the stencil2d residual and runs the transfer2d kernels,
    and the check sums the whole residual (red_only stays off)."""
    _thresholds(monkeypatch)
    jprob = jmg.poisson2d(k=6, dtype=jnp.float64, smoother="chebyshev",
                          tol=1e-9, use_pallas=True)
    want = jmg.MultigridSolver(jprob).solve()
    calls = _spy_calls(monkeypatch)
    got = mt.MultigridSolver(convert.problem_from_jax(jprob,
                                                      device="cpu")).solve()
    _agree(got, want)
    assert got.converged
    i, deg = got.iters, 4                      # nu1 + nu2 residual applies
    assert calls["pres"] == [63] * deg * i
    assert calls["sres"] == [31] * deg * i
    assert calls["pdown"] == calls["pup"] == [63] * i
    assert calls["rr"] == calls["pa"] == [31] * i
    assert calls["norm"] == [63] * (i + 1)
    assert calls["fdown"] == calls["fup"] == []


def test_chebyshev_pcg_matches_jax(monkeypatch):
    """MG-PCG preconditioned by a Chebyshev V(2,2) cycle at k=5 on the
    kernel route (31 on the unpacked kernel tier; PACK_MIN_N lowered so
    that nothing packs at this size), against JAX's solve_pcg."""
    _thresholds(monkeypatch)
    jprob = jmg.poisson2d(k=5, dtype=jnp.float64, smoother="chebyshev",
                          tol=1e-10, use_pallas=True)
    want = jmg.solve_pcg(jprob.hierarchy, jprob.b, jprob.config)
    prob = convert.problem_from_jax(jprob, device="cpu")
    calls = _spy_calls(monkeypatch)
    got = krylov.solve_pcg(prob.hierarchy, prob.b, prob.config)
    _agree(got, want)
    assert got.converged
    i = got.iters
    # One cycle a preconditioning (1 + iters); CG's residual and operator
    # apply run stencil2d.residual too (1 + iters).
    assert calls["rr"] == calls["pa"] == [31] * (i + 1)
    assert calls["sres"] == [31] * (4 * (i + 1) + 1 + i)
    assert calls["fdown"] == calls["fup"] == []


def test_chebyshev_3d_plain_route_matches_jax():
    """3D Chebyshev takes the plain backend even with kernels on (JAX's
    rule, cycles.get_backend); k=4, V(2,2)."""
    jprob = jmg.poisson3d(k=4, dtype=jnp.float64, smoother="chebyshev",
                          tol=1e-9, use_pallas=True)
    want = jmg.MultigridSolver(jprob).solve()
    got = mt.MultigridSolver(convert.problem_from_jax(jprob,
                                                      device="cpu")).solve()
    _agree(got, want)
    assert got.converged
