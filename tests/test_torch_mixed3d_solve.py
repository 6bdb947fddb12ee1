"""3D mixed precision of the PyTorch port (``config.precond_dtype`` with
a 3D RB-GS cycle on the stencil3d tier) against the JAX package: the
solves.

One mixed cycle's dtypes; MG-PCG at k=5 (float64 outer, bfloat16
preconditioner) against JAX's mixed iterations and its full-precision
answer, as JAX's tests/test_mixed.py:296-319 runs it; II, RQI and LOBPCG
at k=4 against the port's full-precision runs and the exact discrete
eigenvalue. ``KERNEL3_MIN_N`` (JAX: ``PALLAS3_MIN_N``) is lowered to 10 so
that 31 and 15 run the stencil3d tier, as JAX's test does; on CPU tensors
the wrappers take their plain versions (tests/test_torch_mixed3d.py holds
those against JAX's kernels). Inputs are made with numpy from a seed.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multigridcmt_tpu_torch as mt
from multigridcmt_tpu import kernels as jkernels
from multigridcmt_tpu.config import SolverConfig as JConfig
from multigridcmt_tpu.grids import build_hierarchy as jbuild_hierarchy
from multigridcmt_tpu.solvers import krylov as jkrylov
from multigridcmt_tpu_torch import kernels
from multigridcmt_tpu_torch.config import SolverConfig
from multigridcmt_tpu_torch.grids import build_hierarchy
from multigridcmt_tpu_torch.kernels import stencil3d
from multigridcmt_tpu_torch.ops import laplacian
from multigridcmt_tpu_torch.solvers import cycles

BF = torch.bfloat16
MIN_N = 10


def _counts():
    return (stencil3d.residual_launches, stencil3d.jacobi_launches,
            stencil3d.rbgs_launches, stencil3d.residual_bf16_launches,
            stencil3d.jacobi_bf16_launches,
            stencil3d.jacobi_bf16_f32_launches,
            stencil3d.rbgs_bf16_launches, stencil3d.rbgs_bf16_f32_launches)


def _rhs(n, seed=0):
    rng = np.random.default_rng(seed)
    b = np.zeros((n + 2,) * 3)
    b[1:-1, 1:-1, 1:-1] = rng.standard_normal((n,) * 3)
    return b


def test_mixed_cycle_dtypes(monkeypatch):
    """One mixed 3D cycle: bfloat16 only in the fine level's storage; every
    coarse array float32 (the bfloat16 residual emits float32), and the
    correction add promotes the top level to float32, as JAX's 3D cycle
    does."""
    monkeypatch.setattr(kernels, "KERNEL3_MIN_N", MIN_N)
    cfg = SolverConfig(ndim=3, k=5, dtype=torch.float64, smoother="rbgs",
                       use_kernels=True, precond_dtype=BF)
    hier = build_hierarchy(cfg, device="cpu")
    b = torch.from_numpy(_rhs(31, seed=1) * 32 ** 2).to(BF)
    seen = []
    orig = cycles.v_cycle

    def spy(hier, x, b, config, level=0, **kw):
        seen.append((level, x.dtype, b.dtype))
        return orig(hier, x, b, config, level=level, **kw)

    monkeypatch.setattr(cycles, "v_cycle", spy)
    out = cycles.cycle(hier, torch.zeros_like(b), b, cfg)
    assert out.dtype == torch.float32
    assert seen[0] == (0, BF, BF)
    assert [s[0] for s in seen] == list(range(hier.num_levels))
    assert all(s[1] == s[2] == torch.float32 for s in seen[1:])


def test_pcg_bf16_preconditioner(monkeypatch):
    """As JAX's tests/test_mixed.py:296-319: float64 MG-PCG to tol 1e-10 at
    k=5 with a bfloat16 RB-GS cycle, 31 and 15 on the stencil3d tier. Its
    iterations within 1 of JAX's mixed run (whose 3D cycle the port's
    matches: bfloat16 fine storage, float32 from the correction add on),
    its x within rtol 1e-7, atol 1e-8 of JAX's full-precision answer."""
    monkeypatch.setattr(jkernels, "PALLAS3_MIN_N", MIN_N)
    monkeypatch.setattr(kernels, "KERNEL3_MIN_N", MIN_N)
    b = _rhs(31)
    base = dict(ndim=3, k=5, dtype=jnp.float64, smoother="rbgs", tol=1e-10,
                max_iters=60)
    jcfg = JConfig(**base, use_pallas=True, precond_dtype=jnp.bfloat16)
    assert jkrylov.mixed_cycle_dtype(jcfg) == jnp.bfloat16
    jmixed = jkrylov.solve_pcg(jbuild_hierarchy(jcfg), jnp.asarray(b), jcfg)
    jcfg_full = JConfig(**base, use_pallas=False)
    want = np.asarray(jkrylov.solve_pcg(jbuild_hierarchy(jcfg_full),
                                        jnp.asarray(b), jcfg_full).x)
    kw = dict(k=5, dtype=torch.float64, smoother="rbgs", use_kernels=True,
              tol=1e-10, max_iters=60, device="cpu")
    before = _counts()
    mixed = mt.MultigridSolver(mt.poisson3d(precond_dtype=BF, **kw)).solve(
        torch.from_numpy(b), method="pcg")
    full = mt.MultigridSolver(mt.poisson3d(**kw)).solve(torch.from_numpy(b),
                                                        method="pcg")
    assert _counts() == before
    assert bool(jmixed.converged) and mixed.converged and full.converged
    assert abs(mixed.iters - int(jmixed.iters)) <= 1
    assert mixed.iters <= math.ceil(1.2 * full.iters) + 1
    assert mixed.x.dtype == torch.float64
    np.testing.assert_allclose(mixed.x.numpy(), want, rtol=1e-7, atol=1e-8)


@pytest.mark.parametrize("method", ["ii", "rqi", "lobpcg"])
def test_eigensolvers_bf16_preconditioner(method, monkeypatch):
    """II and RQI refine each inner solve with bfloat16 cycles, LOBPCG
    casts its preconditioner: at k=4 (15 on the stencil3d tier) lambda_1
    within 1e-8 of the port's full-precision run and of the exact discrete
    value 3 lambda_1d(1)."""
    monkeypatch.setattr(kernels, "KERNEL3_MIN_N", MIN_N)
    out = {}
    for pd in (None, BF):
        solver = mt.MultigridSolver(mt.poisson3d(
            k=4, dtype=torch.float64, smoother="rbgs", use_kernels=True,
            precond_dtype=pd, device="cpu"))
        out[pd] = solver.eigensolve(k=1, method=method, tol=1e-9)
    full, mixed = out[None], out[BF]
    assert full.converged and mixed.converged
    n = 15
    exact = 3 * laplacian.eigenvalue_1d(1, n, 1.0 / (n + 1))
    lam, lam_full = mixed.eigenvalues[0].item(), full.eigenvalues[0].item()
    assert abs(lam - lam_full) / lam_full < 1e-8
    assert abs(lam - exact) / exact < 1e-8
    assert mixed.eigenvectors.dtype == torch.float64
