"""The last native bfloat16 modes of the port (the fused2d legs and the
transfer2d kernels, ``kernels/native_bf16.py``) and the bfloat16 2D solve
on the kernel route, against the JAX package, bit for bit.

JAX computes these kernels in bfloat16 itself: every operation rounds to
bfloat16, sigma and the Python constants too. Full weighting is
elementwise (rows, then columns); the selection and interpolation dots only
pick a point or average two. transfer2d's prolongation interpolates columns
first, the fused up leg rows first. On a CPU tensor each wrapper takes its
plain version, which chip_smoke.py holds the CUDA kernels against on the
card, bit for bit. JAX runs its Pallas kernels in interpret mode, each mode
jitted once with sigma traced. Inputs are made with numpy from a seed and
rounded to bfloat16 with ml_dtypes (``test_torch_native_bf16._grids``).

Cases: n = 127 (the JAX down leg's 64-row tiles: three), sigma 0 and 11.5,
RB-GS and Jacobi (omega 0.8 and 2/3), 0 sweeps and each leg's cap. Pins:
the other interpolation or restriction order parts from JAX; the repairs
of the port's bfloat16 solve outside the kernels (the model right-hand
side and grid coordinates, the plain Jacobi and Chebyshev scalars, the
aligned-layout stencils of the small levels, the guards in bfloat16, the
norm); the k = 8 solves by Jacobi and RB-GS equal JAX's, iterations,
history and x.
"""
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import multigridcmt_tpu as mj
import multigridcmt_tpu_torch as mt
from multigridcmt_tpu.grids import from_aligned, to_aligned
from multigridcmt_tpu.grids import grid_coords as jgrid_coords
from multigridcmt_tpu.kernels import fused2d as jfused2d
from multigridcmt_tpu.kernels import transfer2d as jtransfer2d
from multigridcmt_tpu.ops import smoothers as jsmoothers
from multigridcmt_tpu.ops import stencils_aligned
from multigridcmt_tpu.ops import transfer as jtransfer
from multigridcmt_tpu.solvers import cycles as jcycles
from multigridcmt_tpu_torch import convert
from multigridcmt_tpu_torch.grids import grid_coords
from multigridcmt_tpu_torch.kernels import fused2d, native_bf16, transfer2d
from multigridcmt_tpu_torch.ops import bf16, laplacian, smoothers, transfer
from multigridcmt_tpu_torch.solvers import cycles
from test_torch_native_bf16 import _grids, _same_bits

BF = ml_dtypes.bfloat16
N, NC = 127, 63
H = 1.0 / (N + 1)
SIGMA = 11.5
# (kind, omega, sweeps, sigma) of each leg; 0 sweeps ignores kind and omega.
# Each JAX mode compiles once for both sigmas (~2 s a mode), so Jacobi takes
# omega 0.8 on the down leg and 2/3 on the up leg.
DOWN_CASES = [("rbgs", 1.0, 0, 0.0), ("rbgs", 1.0, 0, SIGMA),
              ("rbgs", 1.0, 3, 0.0), ("rbgs", 1.0, 3, SIGMA),
              ("jacobi", 0.8, 6, 0.0), ("jacobi", 0.8, 6, SIGMA)]
UP_CASES = [("rbgs", 1.0, 0, 0.0),
            ("rbgs", 1.0, 4, 0.0), ("rbgs", 1.0, 4, SIGMA),
            ("jacobi", 2 / 3, 8, 0.0), ("jacobi", 2 / 3, 8, SIGMA)]


def _counts():
    return (fused2d.down_launches, fused2d.up_launches,
            fused2d.down_bf16_launches, fused2d.up_bf16_launches,
            transfer2d.residual_restrict_launches,
            transfer2d.prolong_add_launches,
            transfer2d.residual_restrict_bf16_launches,
            transfer2d.prolong_add_bf16_launches)


@functools.lru_cache(maxsize=None)
def _inputs():
    """u, b, x on the fine grid and e on the coarse one (ml_dtypes
    bfloat16, zero ghosts)."""
    u, b = _grids(N, 11)
    x, _ = _grids(N, 12)
    e, _ = _grids(NC, 13)
    return u, b, x, e


def _port(*arrays):
    return [convert._tensor(a, "cpu") for a in arrays]


@functools.lru_cache(maxsize=None)
def _jax_leg(leg, kind, omega, sweeps):
    """JAX's leg (or transfer) on aligned grids, jitted with sigma traced."""
    if leg == "down":
        return jax.jit(lambda s, u, b: jfused2d.smooth_residual_restrict(
            u, b, N, H, kind=kind, omega=omega, sweeps=sweeps, sigma=s))
    if leg == "up":
        return jax.jit(lambda s, x, e, b: jfused2d.prolong_add_smooth(
            x, e, b, N, NC, H, kind=kind, omega=omega, sweeps=sweeps,
            sigma=s))
    if leg == "rr":
        return jax.jit(lambda u, b: jtransfer2d.residual_restrict(u, b, N, H))
    return jax.jit(lambda x, e: jtransfer2d.prolong_add(x, e, N, NC))


@functools.lru_cache(maxsize=None)
def _want(leg, kind="rbgs", omega=1.0, sweeps=0, sigma=0.0):
    """JAX's outputs, logical bfloat16 arrays."""
    u, b, x, e = (to_aligned(jnp.asarray(a)) for a in _inputs())
    fn = _jax_leg(leg, kind, omega, sweeps)
    s = jnp.asarray(sigma, dtype=jnp.bfloat16)
    if leg == "down":
        us, rc = fn(s, u, b)
        return from_aligned(us, N), from_aligned(rc, NC)
    if leg == "up":
        return (from_aligned(fn(s, x, e, b), N),)
    if leg == "rr":
        return (from_aligned(fn(u, b), NC),)
    return (from_aligned(fn(x, e), N),)


def _differ(got: torch.Tensor, want) -> int:
    """Points where bfloat16 ``got`` and JAX's ``want`` differ in bits."""
    w = convert._tensor(want, "cpu")
    assert got.shape == w.shape
    return int((got.view(torch.int16) != w.view(torch.int16)).sum())


@pytest.mark.parametrize("kind,omega,sweeps,sigma", DOWN_CASES)
def test_down_leg_matches_jax(kind, omega, sweeps, sigma):
    u, b, _, _ = _port(*_inputs())
    before = _counts()
    us, rc = fused2d.smooth_residual_restrict(
        u, b, N, H, kind=kind, omega=omega, sweeps=sweeps, sigma=sigma)
    assert _counts() == before
    want_u, want_rc = _want("down", kind, omega, sweeps, sigma)
    _same_bits(us, want_u)
    _same_bits(rc, want_rc)


@pytest.mark.parametrize("kind,omega,sweeps,sigma", UP_CASES)
def test_up_leg_matches_jax(kind, omega, sweeps, sigma):
    _, b, x, e = _port(*_inputs())
    before = _counts()
    got = fused2d.prolong_add_smooth(x, e, b, N, NC, H, kind=kind,
                                     omega=omega, sweeps=sweeps, sigma=sigma)
    assert _counts() == before
    _same_bits(got, _want("up", kind, omega, sweeps, sigma)[0])


@pytest.mark.parametrize("mode", ["residual_restrict", "prolong_add"])
def test_transfer2d_matches_jax(mode):
    u, b, x, e = _port(*_inputs())
    before = _counts()
    if mode == "residual_restrict":
        got, want = transfer2d.residual_restrict(u, b, N, H), _want("rr")[0]
    else:
        got, want = transfer2d.prolong_add(x, e, N, NC), _want("pa")[0]
    assert _counts() == before
    _same_bits(got, want)


def _restrict_columns_first(u, b, c):
    """The native residual restriction over columns first, then rows."""
    ct = native_bf16._tensors(c, u.device)
    r = native_bf16._residual_vals(u, b, ct, shift=False)
    rr = native_bf16._full_weight(native_bf16._full_weight(r, 1, ct), 0, ct)
    return torch.nn.functional.pad(rr, (1, 1, 1, 1))


def test_other_orders_part_from_jax():
    """Full weighting columns first parts from JAX's residual restriction;
    transfer2d's prolongation done rows first parts from JAX's; the fused
    up leg under Jacobi done columns first parts from JAX's."""
    u, b, x, e = _port(*_inputs())
    c = native_bf16.constants(H, 0.0)
    assert _differ(_restrict_columns_first(u, b, c), _want("rr")[0]) > 100
    assert _differ(native_bf16.prolong_add_plain(x, e, N, NC, True),
                   _want("pa")[0]) > 100
    cj = native_bf16.constants(H, 0.0, 2 / 3)
    cols_first = native_bf16.sweep_plain(
        "jacobi", native_bf16.prolong_add_plain(x, e, N, NC, False), b, N,
        cj, 8)
    assert _differ(cols_first, _want("up", "jacobi", 2 / 3, 8, 0.0)[0]) > 100


def test_wrappers_take_bf16_coarse_only():
    """A bfloat16 leg wants its coarse operand in bfloat16 too (a bfloat16
    solve's levels are all bfloat16); a float32 one raises ValueError."""
    _, b, x, e = _port(*_inputs())
    with pytest.raises(ValueError, match="e:"):
        transfer2d.prolong_add(x, e.float(), N, NC)
    with pytest.raises(ValueError, match="e:"):
        fused2d.prolong_add_smooth(x, e.float(), b, N, NC, H, kind="rbgs",
                                   omega=1.0, sweeps=1)


# --- The repairs of the port's bfloat16 solve outside the kernels ----------

def test_model_problem_and_coords_match_jax():
    """F8a: the model right-hand side and analytic solution round pi and
    ndim pi^2 to bfloat16 (2D k=8, 3D k=5, 1D k=10: equal to JAX's); the
    grid coordinates follow jnp.arange in bfloat16 past 256 (n = 1023);
    pi unrounded parts from JAX."""
    for k, ndim in ((8, 2), (5, 3), (10, 1)):
        jp = mj.poisson(k=k, ndim=ndim, dtype=jnp.bfloat16)
        p = mt.poisson(k=k, ndim=ndim, dtype=torch.bfloat16, device="cpu")
        _same_bits(p.b, jp.b)
        _same_bits(p.u_exact, jp.u_exact)
    x = grid_coords(1023, 1, torch.bfloat16, device="cpu")[0]
    _same_bits(x, jgrid_coords(1023, 1, jnp.bfloat16)[0])
    c = grid_coords(255, 2, torch.bfloat16, device="cpu")
    old = 2 * np.pi ** 2 * torch.sin(np.pi * c[0]) * torch.sin(np.pi * c[1])
    jb = mj.poisson(k=8, ndim=2, dtype=jnp.bfloat16).b
    assert _differ(torch.nn.functional.pad(old, (1, 1, 1, 1)), jb) > 1000


def test_plain_smoother_scalars_match_jax():
    """F8b: two plain Jacobi sweeps (omega and d rounded to bfloat16, then
    divided there) and a degree-3 Chebyshev smoother (its coefficients
    rounded) equal JAX's at n = 255; Jacobi with omega / d in double parts
    from it."""
    n, h = 255, 1.0 / 256
    ub, bb = _grids(n, 21)
    u, b = _port(ub, bb)
    ju, jb = jnp.asarray(ub), jnp.asarray(bb)
    want = jsmoothers.smooth(ju, jb, h, kind="jacobi", omega=0.8, sweeps=2)
    _same_bits(smoothers.smooth(u, b, h, kind="jacobi", omega=0.8,
                                sweeps=2), want)
    _same_bits(smoothers.chebyshev(u, b, h, 3),
               jsmoothers.chebyshev(ju, jb, h, 3))
    off = u
    for _ in range(2):                      # omega / d in double
        off = off + (0.8 / (4.0 / h ** 2)) * laplacian.residual(off, b, h)
    assert _differ(off, want) > 1000


@pytest.mark.parametrize("sigma", [0.0, SIGMA])
def test_aligned_stencils_match_jax(sigma):
    """F8c: the small levels' stencils (ops/bf16.py) equal JAX's
    stencils_aligned at n = 127 (the residual, two Jacobi and two RB-GS
    sweeps), and JAX's aligned transfers equal the plain ones in
    bfloat16."""
    ub, bb = _grids(N, 31)
    u, b = _port(ub, bb)
    ju, jb = (to_aligned(jnp.asarray(a)) for a in (ub, bb))
    _same_bits(bf16.residual(u, b, N, H, sigma),
               from_aligned(stencils_aligned.residual(ju, jb, N, H, sigma),
                            N))
    for kind in ("jacobi", "rbgs"):
        _same_bits(bf16.smooth(u, b, N, H, kind=kind, omega=0.8, sweeps=2,
                               sigma=sigma),
                   from_aligned(stencils_aligned.smooth(
                       ju, jb, N, H, kind=kind, omega=0.8, sweeps=2,
                       sigma=sigma), N))
    r = bf16.residual(u, b, N, H, sigma)
    _same_bits(transfer.restrict(r), from_aligned(jtransfer.restrict_aligned(
        to_aligned(jnp.asarray(r.float().numpy()).astype(jnp.bfloat16)), N),
        NC))
    e = _port(_grids(NC, 32)[0])[0]
    _same_bits(transfer.prolong(e), from_aligned(jtransfer.prolong_aligned(
        to_aligned(jnp.asarray(e.float().numpy()).astype(jnp.bfloat16)),
        NC), N))


def test_guards_in_bf16():
    """F8d: in bfloat16 0.9 x 38.5 rounds to 34.5, so the step 38.5 ->
    34.5 is a stall, as JAX counts it; in double (34.65) it is not. The
    tolerance meets the history in bfloat16 too."""
    stall, _ = cycles.step_guards(34.5, 38.5, 0, 0, torch.bfloat16)
    jstall, _ = jcycles.step_guards(jnp.bfloat16(34.5), jnp.bfloat16(38.5),
                                    0, 0)
    assert stall == int(jstall) == 1
    assert cycles.step_guards(34.5, 38.5, 0, 0) == (0, 0)
    assert cycles._in(torch.bfloat16, 1e-3) == float(
        jnp.asarray(1e-3, jnp.bfloat16))


def test_norm_matches_jax():
    """F8e: the bfloat16 solve's norm (squares in bfloat16, the sum in
    float32 rounded, the root in bfloat16) equals JAX's _norm on random
    bfloat16 arrays; vector_norm parts from it on some of them."""
    parted = 0
    for seed in range(12):
        rng = np.random.default_rng(100 + seed)
        n = 257 + 64 * seed
        a = (rng.standard_normal((n, n)) * 1e4).astype(BF)
        want = jcycles._norm(jnp.asarray(a))
        t = convert._tensor(a, "cpu")
        _same_bits(cycles._norm(t), want)
        parted += _differ(torch.linalg.vector_norm(t), want)
    assert parted > 0


@pytest.mark.parametrize("smoother,schedule,iters,hist", [
    pytest.param("jacobi", {}, 3, [1.0, 27.5, 36.75, 44.25],
                 id="jacobi-3-hist0"),
    pytest.param("rbgs", {}, 6, [1.0, 32.5, 52.75, 38.5, 34.5, 55.0, 132.0],
                 id="rbgs-6-hist1"),
    pytest.param("jacobi", {"nu1": 8, "nu2": 8}, 18,
                 [1.0, 28.125, 51.75, 36.5, 33.25, 42.5, 37.0, 48.25, 32.5,
                  48.5, 22.75, 46.75, 17.375, 29.0, 47.5, 20.0, 28.5, 27.75,
                  30.625], id="jacobi-V(8,8)-18")])
def test_bf16_solve_matches_jax(smoother, schedule, iters, hist):
    """poisson(ndim=2, k=8, bfloat16) on the kernel route (the fused legs
    at 255, the aligned-layout stencils below) equals JAX's use_pallas
    solve bit for bit: iterations, history and x. Jacobi V(8,8) composes
    its down leg at 255 in both packages (8 sweeps pass the fused down
    leg's cap of 6: the whole grid's native Jacobi sweeps, then the
    residual restriction) and fuses its up leg. Each diverges (the
    bfloat16 residual cannot fall at this h), JAX's result as much as the
    port's; the iterations and histories are JAX's run's."""
    jp = mj.poisson2d(k=8, dtype=jnp.bfloat16, smoother=smoother,
                      use_pallas=True, **schedule)
    jr = mj.MultigridSolver(jp).solve()
    p = mt.poisson2d(k=8, dtype=torch.bfloat16, smoother=smoother,
                     use_kernels=True, device="cpu", **schedule)
    before = _counts()
    r = mt.MultigridSolver(p).solve()
    assert _counts() == before
    assert r.iters == int(jr.iters) == iters
    _same_bits(r.res_history, jr.res_history)
    assert r.res_history[: iters + 1].float().tolist() == hist
    _same_bits(r.x, jr.x)
