"""Mixed precision on the packed 2D tier of the PyTorch port
(``config.precond_dtype``) against the JAX package.

The four packed2d kernels' bfloat16 storage modes (the down and up legs,
the RB-GS sweep, the residual) are held against JAX's Pallas kernels in
interpret mode on the same bfloat16 inputs, and the up leg's float32 store
against JAX's float32 kernel on the widened inputs. On a CPU tensor each
wrapper takes its plain version, which chip_smoke.py holds the CUDA kernels
against on the card. Tolerances: a bfloat16 output lies within one
bfloat16 ulp of JAX's plus BF16_SCALE_TOL of the field's largest value at
every point (both evaluate in float32, in other orders, and round once),
and at most BF16_SHARE of the points differ at all; a float32 output to
F32_TOL of the field's largest value. The down leg's coarse right-hand
side is the residual of u' as stored, so it is held against the port's
plain restriction of JAX's own u' (a one-ulp flip of u' moves the residual
there by 4/h^2 of an ulp).

The solves (float64 outer, bfloat16 preconditioner, k <= 8) hold MG-PCG,
II, RQI and LOBPCG against JAX's converged full-precision answers and the
port's own full-precision runs, not against JAX's mixed histories: the port
stores a mixed cycle's top level in float32 where JAX's single-device cycle
stores it in bfloat16 (ROADMAP.md, queue 3, F5), which changes the
iterations. test_top_level_store_repairs_jax_breakdown pins that departure.
Inputs are made with numpy from a seed.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multigridcmt_tpu as jmg
import multigridcmt_tpu_torch as mt
from multigridcmt_tpu import kernels as jkernels
from multigridcmt_tpu.config import SolverConfig as JConfig
from multigridcmt_tpu.grids import build_hierarchy as jbuild_hierarchy
from multigridcmt_tpu.grids import from_aligned, to_aligned
from multigridcmt_tpu.kernels import packed2d as jpacked2d
from multigridcmt_tpu.solvers import krylov as jkrylov
from multigridcmt_tpu_torch import convert, kernels
from multigridcmt_tpu_torch.config import SolverConfig
from multigridcmt_tpu_torch.grids import build_hierarchy
from multigridcmt_tpu_torch.kernels import packed2d
from multigridcmt_tpu_torch.solvers import cycles, krylov

BF16_SCALE_TOL = 1e-5
BF16_SHARE = 1e-3
F32_TOL = 1e-5
OMEGA = {"rbgs": 1.0, "jacobi": 0.8}
SIGMA = 11.5
BF = torch.bfloat16


def _padded(rng, n):
    a = np.zeros((n + 2, n + 2))
    a[1:-1, 1:-1] = rng.standard_normal((n, n))
    return a


def _tpack(a, dtype=BF):
    """Logical numpy grid -> the port's packed grid, rounded to dtype."""
    return packed2d.pack(torch.from_numpy(a).to(dtype))


def _jpack(t):
    """The port's packed grid -> JAX's packed grid of the same dtype, with
    the same values (bfloat16 values are exact in float32)."""
    a = packed2d.unpack(t).to(torch.float32).numpy()
    out = jpacked2d.pack(to_aligned(jnp.asarray(a)))
    return out.astype(jnp.bfloat16) if t.dtype == BF else out


def _junpack(s, n):
    """JAX packed -> logical float64 numpy grid."""
    c = to_aligned(jnp.zeros((n + 2, n + 2))).shape[1]
    return np.array(from_aligned(jpacked2d.unpack(s, c), n)
                    .astype(jnp.float64))


def _logical(t):
    """A packed output as a logical float64 numpy grid; its pad lanes are
    zero."""
    g = packed2d.unpack(t)
    assert torch.equal(packed2d.pack(g), t)
    return g.to(torch.float64).numpy()


def _ghosts_zero(g):
    inner = g.copy()
    inner[1:-1, 1:-1] = 0.0
    return np.abs(inner).max() == 0.0


def _bf16_close(got, want):
    """got (the port's bfloat16 packed output) against want (JAX's, a
    logical float64 grid of bfloat16 values), as the module's docstring
    says."""
    assert got.dtype == BF
    g = _logical(got)
    assert g.shape == want.shape and _ghosts_zero(g)
    diff = np.abs(g - want)
    mant, ex = np.frexp(want)
    ulp = np.where(want != 0, np.ldexp(1.0, ex - 8), 0.0)
    scale = np.abs(want).max()
    assert np.all(diff <= ulp + BF16_SCALE_TOL * scale)
    assert np.mean(diff > 0) <= BF16_SHARE


def _f32_close(got, want):
    """A float32 output (logical or packed) against JAX's, to F32_TOL of
    the field's largest value."""
    assert got.dtype == torch.float32
    g = _logical(got) if packed2d.is_packed(got) else got.double().numpy()
    assert g.shape == want.shape and _ghosts_zero(g)
    np.testing.assert_allclose(g, want, rtol=0,
                               atol=F32_TOL * np.abs(want).max())


def _launches():
    return (packed2d.down_launches, packed2d.up_launches,
            packed2d.residual_launches, packed2d.rbgs_launches,
            packed2d.down_bf16_launches, packed2d.up_bf16_launches,
            packed2d.up_bf16_f32_launches, packed2d.residual_bf16_launches,
            packed2d.rbgs_bf16_launches)


def _inputs(n, seed):
    """u and b (h^2 b of u's size) rounded to bfloat16, packed."""
    rng = np.random.default_rng(seed)
    h = 1.0 / (n + 1)
    return _tpack(_padded(rng, n)), _tpack(_padded(rng, n) / h ** 2), rng


# n = 255 spans several of JAX's 64-row Pallas tiles; 63 is one.
@pytest.mark.parametrize("n,kind,sweeps,sigma,packed_coarse", [
    (63, "rbgs", 0, 0.0, False), (63, "rbgs", 1, SIGMA, False),
    (63, "jacobi", 2, SIGMA, True), (255, "rbgs", 2, 0.0, False),
    (255, "jacobi", 4, 0.0, False)])
def test_bf16_down_leg_matches_pallas(n, kind, sweeps, sigma,
                                      packed_coarse):
    su, sb, _ = _inputs(n, 100 + n + sweeps)
    h, nc = 1.0 / (n + 1), (n - 1) // 2
    kw = dict(kind=kind, omega=OMEGA[kind], sweeps=sweeps, sigma=sigma,
              packed_coarse=packed_coarse)
    ju, jrc = jpacked2d.smooth_residual_restrict(_jpack(su), _jpack(sb), n,
                                                 h, **kw)
    assert jrc.dtype == jnp.float32
    before = _launches()
    tu, trc = packed2d.smooth_residual_restrict(su, sb, n, h, **kw)
    assert _launches() == before               # CPU: the plain version
    ju_np = _junpack(ju, n)
    _bf16_close(tu, ju_np)
    # The coarse right-hand side: float32, the residual of u' as stored.
    want_rc = (_junpack(jrc, nc) if packed_coarse
               else np.asarray(from_aligned(jrc, nc)).astype(np.float64))
    assert packed2d.is_packed(trc) == packed_coarse
    ju_t = packed2d.pack(torch.from_numpy(ju_np).to(BF))
    of_jax_u = packed2d.residual_restrict_plain(
        ju_t, sb, n, h, red_only=kind == "rbgs" and sweeps >= 1,
        sigma=sigma, packed_coarse=packed_coarse)
    _f32_close(of_jax_u, want_rc)
    if torch.equal(tu, ju_t):
        _f32_close(trc, want_rc)
    else:
        assert torch.equal(trc, packed2d.residual_restrict_plain(
            tu, sb, n, h, red_only=kind == "rbgs" and sweeps >= 1,
            sigma=sigma, packed_coarse=packed_coarse))


@pytest.mark.parametrize("out", [None, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("n,kind,sweeps,sigma,packed_e", [
    (63, "rbgs", 2, SIGMA, False), (63, "jacobi", 5, 0.0, True),
    (255, "rbgs", 4, 0.0, False), (255, "jacobi", 2, SIGMA, False)])
def test_bf16_up_leg_matches_pallas(n, kind, sweeps, sigma, packed_e, out):
    """x and b bfloat16, e float32 (the coarse levels of a mixed cycle);
    x' stored in bfloat16 against JAX's bfloat16 kernel, or in float32
    (out_dtype, the top level of a mixed cycle) against JAX's float32
    kernel on the widened x and b."""
    sx, sb, rng = _inputs(n, 200 + n + sweeps)
    h, nc = 1.0 / (n + 1), (n - 1) // 2
    e = _padded(rng, nc)
    te = _tpack(e, torch.float32) if packed_e else torch.from_numpy(e).float()
    je = (_jpack(te) if packed_e
          else to_aligned(jnp.asarray(e, dtype=jnp.float32)))
    kw = dict(kind=kind, omega=OMEGA[kind], sweeps=sweeps, sigma=sigma)
    jx, jb = _jpack(sx), _jpack(sb)
    if out is not None:
        jx, jb = jx.astype(jnp.float32), jb.astype(jnp.float32)
    want = _junpack(jpacked2d.prolong_add_smooth(jx, je, jb, n, nc, h, **kw),
                    n)
    before = _launches()
    got = packed2d.prolong_add_smooth(sx, te, sb, n, nc, h, out_dtype=out,
                                      **kw)
    assert _launches() == before
    if out is None:
        _bf16_close(got, want)
    else:
        _f32_close(got, want)


@pytest.mark.parametrize("n,sweeps,sigma", [(63, 4, SIGMA), (255, 4, 0.0),
                                            (255, 1, SIGMA)])
def test_bf16_rbgs_sweep_matches_pallas(n, sweeps, sigma):
    su, sb, _ = _inputs(n, 300 + n + sweeps)
    h = 1.0 / (n + 1)
    want = _junpack(jpacked2d.rbgs_sweep(_jpack(su), _jpack(sb), n, h,
                                         sweeps=sweeps, sigma=sigma), n)
    before = _launches()
    got = packed2d.rbgs_sweep(su, sb, n, h, sweeps=sweeps, sigma=sigma)
    assert _launches() == before
    _bf16_close(got, want)


@pytest.mark.parametrize("n,sigma", [(63, SIGMA), (255, 0.0)])
def test_bf16_residual_matches_pallas(n, sigma):
    """bfloat16 in, float32 arithmetic, bfloat16 out, as JAX's kernel
    (packed2d.py:420-422)."""
    su, sb, _ = _inputs(n, 400 + n)
    h = 1.0 / (n + 1)
    want = _junpack(jpacked2d.residual(_jpack(su), _jpack(sb), n, h,
                                       sigma=sigma), n)
    before = _launches()
    got = packed2d.residual(su, sb, n, h, sigma=sigma)
    assert _launches() == before
    _bf16_close(got, want)


def test_storage_rule_refuses_other_operands():
    """The coarse operand of a bfloat16 level is float32; x' is stored in
    x's dtype or, for bfloat16 x, float32; bfloat16 and float32 fine grids
    do not mix; the fused residual norm takes bfloat16 grids and returns
    its plain version's float32 sum."""
    n, nc, h = 15, 7, 1.0 / 16
    su, sb, _ = _inputs(n, 7)
    e32 = torch.zeros((nc + 2, nc + 2))
    kw = dict(kind="rbgs", omega=1.0, sweeps=1)
    assert packed2d.prolong_add_smooth(su, e32, sb, n, nc, h,
                                       **kw).dtype == BF
    with pytest.raises(TypeError):                    # a bfloat16 e
        packed2d.prolong_add_smooth(su, e32.to(BF), sb, n, nc, h, **kw)
    with pytest.raises(ValueError):                   # float64 x'
        packed2d.prolong_add_smooth(su, e32, sb, n, nc, h,
                                    out_dtype=torch.float64, **kw)
    with pytest.raises(ValueError):                   # mixed fine grids
        packed2d.residual(su, sb.float(), n, h)
    x32 = su.float()
    assert packed2d.prolong_add_smooth(
        x32, e32, sb.float(), n, nc, h, out_dtype=torch.float32,
        **kw).dtype == torch.float32
    norm = packed2d.residual_norm_sq(su, sb, n, h)
    assert norm.dtype == torch.float32
    assert torch.equal(norm, packed2d.residual_norm_sq_plain(su, sb, n, h))
    assert _launches() == (0,) * 9 and packed2d.resnorm_bf16_launches == 0


# (ndim, k, smoother, use_kernels, precond_dtype, PACK_MIN_N) over JAX's
# mixed_cycle_dtype's 2D routes, and its 3D ones: RB-GS on the kernel tier
# while JAX's plane ring fits VMEM (k = 9, 10 in bfloat16, not 11), Jacobi
# (the plain tier) and no kernels.
GATE_CASES = [
    (2, 12, "rbgs", True, "bfloat16", None),
    (2, 12, "jacobi", True, "bfloat16", None),
    (2, 12, "chebyshev", True, "bfloat16", None),
    (2, 12, "rbgs", True, "float64", None),
    (2, 12, "rbgs", True, None, None),
    (2, 12, "rbgs", False, "bfloat16", None),
    (2, 11, "rbgs", True, "bfloat16", None),
    (2, 6, "rbgs", True, "bfloat16", 30),
    (2, 6, "rbgs", True, "bfloat16", 100),
    (1, 12, "rbgs", True, "bfloat16", None),
    (3, 9, "rbgs", True, "bfloat16", None),
    (3, 10, "rbgs", True, "bfloat16", None),
    (3, 11, "rbgs", True, "bfloat16", None),
    (3, 9, "jacobi", True, "bfloat16", None),
    (3, 9, "rbgs", False, "bfloat16", None),
]


@pytest.mark.parametrize("ndim,k,smoother,use_kernels,pd,pack_min_n",
                         GATE_CASES)
def test_mixed_cycle_dtype_matches_jax_in_2d(ndim, k, smoother, use_kernels,
                                             pd, pack_min_n, monkeypatch):
    if pack_min_n is not None:
        monkeypatch.setattr(jkernels, "PACK_MIN_N", pack_min_n)
        monkeypatch.setattr(kernels, "PACK_MIN_N", pack_min_n)
    jcfg = JConfig(ndim=ndim, k=k, dtype=jnp.float32, smoother=smoother,
                   use_pallas=use_kernels,
                   precond_dtype=None if pd is None else jnp.dtype(pd))
    want = jkrylov.mixed_cycle_dtype(jcfg)
    got = krylov.mixed_cycle_dtype(convert.config_from_jax(jcfg))
    assert (got is None) == (want is None)
    if want is not None:
        assert got == getattr(torch, jnp.dtype(want).name)


def _pack_small(monkeypatch):
    """As JAX's tests/test_mixed.py: 63 and 31 pack at k=6 (the 63 legs
    emit and take a packed coarse grid), the levels below run fused2d."""
    monkeypatch.setattr(kernels, "PACK_MIN_N", 30)
    monkeypatch.setattr(kernels, "KERNEL_MIN_N", 20)


def _rhs(n, seed=0):
    """JAX's tests/test_mixed.py's right-hand side."""
    return torch.from_numpy(_padded(np.random.default_rng(seed), n))


@pytest.mark.parametrize("smoother,nu", [("rbgs", 2), ("jacobi", 2),
                                         ("chebyshev", 2), ("rbgs", 4)])
def test_pcg_bf16_preconditioner(smoother, nu, monkeypatch):
    """float64 MG-PCG to tol 1e-10 with a bfloat16 cycle converges in at
    most ceil(1.2 x) + 1 the full run's iterations, to JAX's
    full-precision solution within 1e-8 (relative l2)."""
    _pack_small(monkeypatch)
    kw = dict(k=6, dtype=torch.float64, smoother=smoother, nu1=nu, nu2=nu,
              use_kernels=True, tol=1e-10, max_iters=60, device="cpu")
    b = _rhs(63)
    full = mt.MultigridSolver(mt.poisson2d(**kw)).solve(b, method="pcg")
    before = _launches()
    mixed = mt.MultigridSolver(mt.poisson2d(
        precond_dtype=BF, **kw)).solve(b, method="pcg")
    assert _launches() == before
    jcfg = JConfig(ndim=2, k=6, dtype=jnp.float64, smoother=smoother,
                   nu1=nu, nu2=nu, tol=1e-10, max_iters=60)
    want = np.asarray(jkrylov.solve_pcg(jbuild_hierarchy(jcfg),
                                        jnp.asarray(b.numpy()), jcfg).x)
    assert full.converged and mixed.converged
    assert mixed.iters <= math.ceil(1.2 * full.iters) + 1
    assert mixed.x.dtype == torch.float64
    rel = np.linalg.norm(mixed.x.numpy() - want) / np.linalg.norm(want)
    assert rel < 1e-8


@pytest.fixture(scope="module")
def jax_lambda1():
    """JAX's full-precision smallest eigenvalue at k=6 (LOBPCG, tol
    1e-10, its plain route)."""
    res = jmg.MultigridSolver(jmg.poisson2d(k=6, dtype=jnp.float64,
                                            smoother="rbgs")).eigensolve(
        k=1, method="lobpcg", tol=1e-10)
    assert bool(res.converged)
    return float(res.eigenvalues[0])


@pytest.mark.parametrize("method", ["ii", "rqi", "lobpcg"])
def test_eigensolvers_bf16_preconditioner(method, jax_lambda1, monkeypatch):
    """II and RQI refine each inner solve with bfloat16 cycles, LOBPCG
    casts its preconditioner: lambda_1 within 1e-9 of JAX's, in at most 3
    outer steps more than the port's full-precision run."""
    _pack_small(monkeypatch)
    out = {}
    for pd in (None, BF):
        solver = mt.MultigridSolver(mt.poisson2d(
            k=6, dtype=torch.float64, smoother="rbgs", use_kernels=True,
            precond_dtype=pd, device="cpu"))
        out[pd] = solver.eigensolve(k=1, method=method, tol=1e-9)
    full, mixed = out[None], out[BF]
    assert full.converged and mixed.converged
    assert mixed.iters <= full.iters + 3
    lam = mixed.eigenvalues[0].item()
    assert abs(lam - jax_lambda1) / jax_lambda1 < 1e-9
    assert mixed.eigenvectors.dtype == torch.float64


def test_unsupported_regime_is_bit_identical(monkeypatch):
    """Where JAX's gate returns None (no packed fine level, or no kernels)
    precond_dtype is a no-op: bit-identical runs."""
    b = _rhs(31)
    for use_kernels in (True, False):
        kw = dict(k=5, dtype=torch.float64, smoother="rbgs", tol=1e-10,
                  max_iters=40, use_kernels=use_kernels, device="cpu")
        full = mt.MultigridSolver(mt.poisson2d(**kw)).solve(b, method="pcg")
        mixed = mt.MultigridSolver(mt.poisson2d(
            precond_dtype=BF, **kw)).solve(b, method="pcg")
        assert torch.equal(full.x, mixed.x) and full.iters == mixed.iters
        assert torch.equal(full.res_history, mixed.res_history)


def test_mixed_cycle_dtypes(monkeypatch):
    """One mixed cycle: bfloat16 only in the fine level's storage; every
    coarse array float32 (no float64 creep through the coarse solve), and
    the top level stored in float32 (JAX's returns bfloat16: F5)."""
    _pack_small(monkeypatch)
    cfg = SolverConfig(ndim=2, k=6, dtype=torch.float64, smoother="rbgs",
                       use_kernels=True, precond_dtype=BF)
    hier = build_hierarchy(cfg, device="cpu")
    bk = cycles.get_backend(cfg)
    b = bk.encode(_rhs(63)).to(BF)
    seen = []
    orig = cycles.v_cycle

    def spy(hier, x, b, config, level=0, **kw):
        seen.append((level, x.dtype, b.dtype, packed2d.is_packed(x)))
        return orig(hier, x, b, config, level=level, **kw)

    monkeypatch.setattr(cycles, "v_cycle", spy)
    out = cycles.cycle(hier, torch.zeros_like(b), b, cfg)
    assert out.dtype == torch.float32 and packed2d.is_packed(out)
    assert seen[0] == (0, BF, BF, True)
    assert [s[0] for s in seen] == list(range(hier.num_levels))
    assert all(s[1] == s[2] == torch.float32 for s in seen[1:])
    assert seen[1][3]                       # 31 packs, in float32


def test_top_level_store_repairs_jax_breakdown(monkeypatch):
    """F5: only the fine level packed (k=8, PACK_MIN_N 255, the levels
    below on the plain stencils), float64 PCG on the problem's own
    right-hand side. JAX's bfloat16 preconditioner stores its top level in
    bfloat16 and its first step grows the residual above 10; the port's
    stores it in float32 and its first step falls below 1."""
    n = 255
    monkeypatch.setattr(jkernels, "PACK_MIN_N", n)
    monkeypatch.setattr(jkernels, "PALLAS_MIN_N", 10 ** 9)
    monkeypatch.setattr(kernels, "PACK_MIN_N", n)
    monkeypatch.setattr(kernels, "KERNEL_MIN_N", 10 ** 9)
    jprob = jmg.poisson2d(k=8, dtype=jnp.float64, smoother="rbgs")
    jcfg = JConfig(ndim=2, k=8, dtype=jnp.float64, smoother="rbgs",
                   use_pallas=True, tol=1e-10, max_iters=1,
                   precond_dtype=jnp.bfloat16)
    jres = jkrylov.solve_pcg(jbuild_hierarchy(jcfg), jprob.b, jcfg)
    prob = mt.poisson2d(k=8, dtype=torch.float64, smoother="rbgs",
                        use_kernels=True, tol=1e-10, max_iters=1,
                        precond_dtype=BF, device="cpu")
    res = mt.MultigridSolver(prob).solve(
        torch.from_numpy(np.array(jprob.b)), method="pcg")
    assert float(jres.res_history[1]) > 10.0
    assert res.res_history[1].item() < 1.0


def test_eigen_and_lobpcg_cast_only_on_the_packed_tier(monkeypatch):
    """The eigensolvers read the gate as PCG does: off the packed tier in
    2D a precond_dtype changes nothing; a 3D RB-GS problem on the stencil3d
    tier (KERNEL3_MIN_N lowered to 10, k=4) is cast now, so LOBPCG's steps
    and II's one-cycle inner solves move (tests/test_torch_mixed3d_solve.py
    holds the converged eigenvalues)."""
    kw = dict(k=5, dtype=torch.float64, smoother="rbgs", device="cpu")
    for method in ("ii", "lobpcg"):
        full = mt.MultigridSolver(mt.poisson2d(**kw)).eigensolve(
            k=1, method=method, max_iters=3)
        mixed = mt.MultigridSolver(mt.poisson2d(
            precond_dtype=BF, **kw)).eigensolve(k=1, method=method,
                                                max_iters=3)
        assert torch.equal(full.eigenvalues, mixed.eigenvalues)
    monkeypatch.setattr(kernels, "KERNEL3_MIN_N", 10)
    kw3 = dict(k=4, ndim=3, dtype=torch.float64, smoother="rbgs",
               use_kernels=True, device="cpu")
    for method, extra in (("ii", dict(inner_cycles=1)), ("lobpcg", {})):
        full, mixed = (mt.MultigridSolver(mt.poisson(
            precond_dtype=pd, **kw3)).eigensolve(k=1, method=method,
                                                 max_iters=3, **extra)
            for pd in (None, BF))
        assert not torch.equal(full.eigenvalues, mixed.eigenvalues)
        np.testing.assert_allclose(mixed.eigenvalues.numpy(),
                                   full.eigenvalues.numpy(), rtol=1e-2)


def test_bf16_entry_points_match_their_signatures():
    """Each bfloat16 entry point is defined in a .cu file of its own (none
    in the float32/float64 leg files, whose build it would lengthen), with
    the argument count _build declares, launching the Whole frame with
    bfloat16 storage (float32 x' for the top level's up leg)."""
    import re

    from multigridcmt_tpu_torch.kernels import _build

    src = {p.name: p.read_text() for p in _build.CSRC.glob("*.cu")}
    files = {"mg_packed2d_down_bf16": ("packed2d_bf16.cu", "launch_down"),
             "mg_packed2d_residual_bf16": ("packed2d_bf16.cu",
                                           "launch_presidual"),
             "mg_packed2d_rbgs_bf16": ("packed2d_sweep_bf16.cu",
                                       "launch_sweep"),
             "mg_packed2d_up_bf16": ("packed2d_up_bf16.cu", "launch_up"),
             "mg_packed2d_up_bf16_f32": ("packed2d_up_bf16_f32.cu",
                                         "launch_up"),
             "mg_packed2d_resnorm_bf16": ("packed2d_bf16.cu",
                                          "launch_presnorm")}
    assert {k for k in _build.SIGNATURES
            if "bf16" in k and "packed2d" in k} == set(files)
    for name, (fname, launcher) in files.items():
        where = [f for f, text in src.items() if re.search(rf"\b{name}\(",
                                                           text)]
        assert where == [fname]
        m = re.search(rf"\bint {name}\(([^)]*)\)\s*\{{\s*return\s+"
                      rf"(?:mg::)?{launcher}<([^>]*)>", src[fname])
        params = [p.strip() for p in m.group(1).split(",")]
        assert len(params) == len(_build.SIGNATURES[name])
        targs = [a.strip() for a in m.group(2).split(",")]
        assert targs[0] == "float" and "__nv_bfloat16" in targs
        if name.endswith("_f32"):
            assert targs[-1] == "float"
    for legs in ("packed2d.cu", "packed2d_up.cu", "packed2d_up_f64.cu",
                 "packed2d_sweep.cu"):
        assert "bfloat16" not in src[legs]
