"""3D mixed precision of the PyTorch port (``config.precond_dtype`` on the
stencil3d tier) against the JAX package.

The stencil3d kernels' bfloat16 storage modes (the residual, which stores
r in float32; the Jacobi and RB-GS sweeps, storing bfloat16 or, by
``out_dtype``, float32) are held against JAX's Pallas kernel in interpret
mode on the same bfloat16 inputs. On a CPU tensor each wrapper takes its
plain version, which chip_smoke.py holds the CUDA kernels against on the
card. Tolerances (PR 16's bfloat16 rule): a bfloat16 output lies within one
bfloat16 ulp of JAX's plus BF16_SCALE_TOL of the field's largest value at
every point (both evaluate in float32, in other orders, and round once),
and at most BF16_SHARE of the points differ at all. A sweep's float32
output holds its red points rounded to bfloat16 (JAX's red ring is of the
storage dtype) and its black points in float32: the same per-point bound,
with a point counting as differing where it parts by more than F32_TOL of
the field's largest value. The residual's float32 output to F32_TOL of
the field's largest value.

Each JAX mode is jitted once at each n and set of static arguments
(sigma traced): its interpreted kernel takes seconds to trace, its runs
milliseconds. The 3D mixed solves are in tests/test_torch_mixed3d_solve.py.
Inputs are made with numpy from a seed.
"""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigridcmt_tpu.grids import from_aligned3, to_aligned3
from multigridcmt_tpu.kernels import stencil3d as jstencil3d
from multigridcmt_tpu_torch.kernels import _build, stencil3d

BF16_SCALE_TOL = 1e-5
BF16_SHARE = 1e-3
F32_TOL = 1e-5
SIGMA = 11.5
OMEGA = 6.0 / 7.0
BF = torch.bfloat16


def _counts():
    return (stencil3d.residual_launches, stencil3d.jacobi_launches,
            stencil3d.rbgs_launches, stencil3d.residual_bf16_launches,
            stencil3d.jacobi_bf16_launches,
            stencil3d.jacobi_bf16_f32_launches,
            stencil3d.rbgs_bf16_launches, stencil3d.rbgs_bf16_f32_launches)


def _grids(n, seed):
    """u and b (b ~ 1/h^2, so that h^2 b and the neighbour sum are of one
    size) on the padded (n+2)^3 grid, rounded to bfloat16 and held in
    float64."""
    rng = np.random.default_rng(seed)
    u = np.zeros((n + 2,) * 3)
    b = np.zeros_like(u)
    u[1:-1, 1:-1, 1:-1] = rng.standard_normal((n,) * 3)
    b[1:-1, 1:-1, 1:-1] = rng.standard_normal((n,) * 3) * (n + 1) ** 2
    return tuple(torch.from_numpy(a).to(BF).double().numpy() for a in (u, b))


def _ulp(want):
    """One bfloat16 ulp of each value (0 where it is 0)."""
    _, ex = np.frexp(want)
    return np.where(want != 0, np.ldexp(1.0, ex - 8), 0.0)


def _bf16_rule(got, want, noise=0.0):
    """got within one bfloat16 ulp of want plus BF16_SCALE_TOL of the scale
    at every point; at most BF16_SHARE of the points part by more than
    ``noise``."""
    assert got.shape == want.shape and np.isfinite(got).all()
    diff = np.abs(got - want)
    scale = np.abs(want).max()
    assert np.all(diff <= _ulp(want) + BF16_SCALE_TOL * scale)
    assert np.mean(diff > noise) <= BF16_SHARE


def _close(got: torch.Tensor, want: np.ndarray, f32_out: bool) -> None:
    """The port's output against JAX's by the module's rules."""
    assert got.dtype == (torch.float32 if f32_out else BF)
    g = got.double().numpy()
    if f32_out:
        _bf16_rule(g, want, noise=F32_TOL * np.abs(want).max())
    else:
        _bf16_rule(g, want)


@functools.lru_cache(maxsize=None)
def _jax_fn(mode, n, kw_items):
    """JAX's stencil3d ``mode`` at n with the static arguments kw_items,
    jitted with sigma traced (one compile of the interpreted kernel serves
    both sigmas), on aligned3 grids in and the logical grid out."""
    kw = dict(kw_items)
    h = 1.0 / (n + 1)
    return jax.jit(lambda u, b, sigma: from_aligned3(
        getattr(jstencil3d, mode)(u, b, n, h, sigma=sigma, **kw), n))


def _jax_call(mode, u, b, n, kw):
    """JAX's stencil3d ``mode`` on the bfloat16 grids u, b (logical,
    float64 holders): (its logical output in float64, its dtype)."""
    static = {k: v for k, v in kw.items() if k != "sigma"}
    if static.get("out_dtype") is not None:
        static["out_dtype"] = jnp.float32
    ja, jb = (to_aligned3(jnp.asarray(a, dtype=jnp.bfloat16)) for a in (u, b))
    out = _jax_fn(mode, n, tuple(sorted(static.items())))(ja, jb, kw["sigma"])
    return np.asarray(out.astype(jnp.float64)), out.dtype


def _cases():
    cases = []
    for n in (15, 31):
        for sigma in (0.0, SIGMA):
            cases.append((n, "residual", dict(sigma=sigma)))
            for sweeps in (1, 2):
                for out in (None, torch.float32):
                    kw = dict(sigma=sigma, sweeps=sweeps, out_dtype=out)
                    cases.append((n, "jacobi_sweep", dict(kw, omega=OMEGA)))
                    cases.append((n, "rbgs_sweep", kw))
    return cases


@pytest.mark.parametrize("n,mode,kw", _cases())
def test_bf16_modes_match_pallas(n, mode, kw):
    """Each bfloat16 mode's plain version against JAX's interpreted kernel
    on the same bfloat16 u and b: the residual stores float32 as JAX's
    does (stencil3d.py:362-366), a sweep bfloat16 or its out_dtype."""
    u, b = _grids(n, seed=n + len(kw) + int(kw["sigma"]))
    h = 1.0 / (n + 1)
    want, jdtype = _jax_call(mode, u, b, n, kw)
    before = _counts()
    got = getattr(stencil3d, mode)(torch.from_numpy(u).to(BF),
                                   torch.from_numpy(b).to(BF), n, h, **kw)
    assert _counts() == before                 # CPU: the plain version
    if mode == "residual":
        assert jdtype == jnp.float32 and got.dtype == torch.float32
        np.testing.assert_allclose(got.double().numpy(), want, rtol=0,
                                   atol=F32_TOL * np.abs(want).max())
    else:
        f32_out = kw["out_dtype"] is not None
        assert jdtype == (jnp.float32 if f32_out else jnp.bfloat16)
        _close(got, want, f32_out)
    ghosts = got.double().numpy().copy()
    ghosts[1:-1, 1:-1, 1:-1] = 0.0
    assert np.abs(ghosts).max() == 0.0


@pytest.mark.parametrize("mode,kw", [
    ("residual", dict(sigma=SIGMA)),
    ("jacobi_sweep", dict(omega=OMEGA, sweeps=2, sigma=SIGMA)),
    ("rbgs_sweep", dict(sigma=SIGMA, sweeps=2, out_dtype=torch.float32)),
])
def test_bf16_plane_stack_with_offsets_matches_pallas(mode, kw):
    """tests/test_torch_stencil3d.py's slab-and-pencil stack (planes
    11..18, rows -2..21 of n=15: goff=11, roff=-2) in bfloat16. JAX's
    stack is 8 x 24 x 128 (its tiling); the port's takes the n + 2 = 17
    columns."""
    n, goff, roff, p, r = 15, 11, -2, 8, 24
    u, b = _grids(n, seed=7)
    stacks = []
    for g in (u, b):
        s = np.zeros((p, r, 128))
        planes = g[goff:goff + p]
        s[:planes.shape[0], -roff:-roff + n + 2, :n + 2] = planes
        stacks.append(s)
    h = 1.0 / (n + 1)
    jkw = dict(kw, out_dtype=jnp.float32) if "out_dtype" in kw else kw
    want = np.asarray(getattr(jstencil3d, mode)(
        *(jnp.asarray(s, dtype=jnp.bfloat16) for s in stacks), n, h,
        goff=goff, roff=roff, **jkw).astype(jnp.float64))
    got = getattr(stencil3d, mode)(
        *(torch.from_numpy(s[..., :n + 2].copy()).to(BF) for s in stacks),
        n, h, goff=goff, roff=roff, **kw)
    assert np.abs(want[..., n + 2:]).max() == 0.0
    want = want[..., :n + 2]
    if mode == "residual":
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.double().numpy(), want, rtol=0,
                                   atol=F32_TOL * np.abs(want).max())
    else:
        _close(got, want, "out_dtype" in kw)
    # Planes outside [1, n] and the stack's edge planes are zero.
    assert np.abs(got.double().numpy()[[0, 5, 6, 7]]).max() == 0.0


def test_storage_rule_refuses_other_operands():
    """A bfloat16 sweep stores bfloat16 or float32; float16 is no storage;
    bfloat16 u takes bfloat16 b; a bfloat16 b beside a wider u is widened
    once (JAX's cast for the mixed cycle's post-smoothing), but the
    residual takes one dtype; sweeps=0 with out_dtype is u in it."""
    n, h = 7, 0.125
    ub = torch.zeros((n + 2,) * 3, dtype=BF)
    with pytest.raises(ValueError):
        stencil3d.rbgs_sweep(ub, ub, n, h, out_dtype=torch.float64)
    with pytest.raises(ValueError):
        stencil3d.jacobi_sweep(ub.float(), ub.float(), n, h, OMEGA,
                               out_dtype=BF)
    with pytest.raises(TypeError):
        stencil3d.residual(ub.half(), ub.half(), n, h)
    with pytest.raises(ValueError):
        stencil3d.rbgs_sweep(ub, ub.float(), n, h)
    with pytest.raises(ValueError):
        stencil3d.residual(ub.float(), ub, n, h)
    u32 = torch.ones((n + 2,) * 3)
    assert torch.equal(stencil3d.rbgs_sweep(u32, ub, n, h),
                       stencil3d.rbgs_sweep(u32, ub.float(), n, h))
    out = stencil3d.jacobi_sweep(ub, ub, n, h, OMEGA, sweeps=0,
                                 out_dtype=torch.float32)
    assert out.dtype == torch.float32 and torch.equal(out, ub.float())
    assert stencil3d.rbgs_sweep(ub, ub, n, h, sweeps=0) is ub
    assert _counts() == (0,) * 8


def test_rbgs_rounds_the_red_values_before_the_black_stage():
    """The plain sweep's float32 output: red points are bfloat16 values;
    black points, computed from them, are not, and differ from a sweep
    whose red values stay float32 (the storage rule is in the arithmetic,
    not only at the store)."""
    n = 15
    u, b = (torch.from_numpy(a).to(BF) for a in _grids(n, seed=3))
    h = 1.0 / (n + 1)
    got = stencil3d.rbgs_sweep(u, b, n, h, out_dtype=torch.float32)
    _, update, red = stencil3d._masks(u, n, 0, 0)
    red_pts = got[(update & red).expand_as(got)]
    assert torch.equal(red_pts, red_pts.to(BF).float())
    wide = stencil3d.rbgs_sweep_plain(u.float(), b.float(), n, h)
    black = (update & ~red).expand_as(got)
    assert not torch.equal(got[black], wide[black])
    assert torch.equal(got[(update & red).expand_as(got)],
                       wide[(update & red).expand_as(got)].to(BF).float())


def test_bf16_entry_points_match_their_signatures():
    """The stencil3d bfloat16 entry points live in csrc/stencil3d_bf16.cu
    (none in the float32/float64 file, whose build it would lengthen), with
    the float32 entry points' arguments, launching stencil3d.cuh's march
    with float registers, bfloat16 u and b, and the output type the name
    says (the residual's always float)."""
    src = {p.name: p.read_text() for p in _build.CSRC.glob("*.cu")}
    names = {k for k in _build.SIGNATURES if k.startswith("mg_stencil3d")
             and "bf16" in k}
    assert names == {f"mg_stencil3d_{m}_bf16{o}" for m in ("jacobi", "rbgs")
                     for o in ("", "_f32")} | {"mg_stencil3d_residual_bf16"}
    for name in names:
        where = [f for f, text in src.items()
                 if re.search(rf"\b{name}\(", text)]
        assert where == ["stencil3d_bf16.cu"]
        base = name[len("mg_stencil3d_"):].split("_")[0]
        m = re.search(rf"\bint {name}\(([^)]*)\)\s*\{{\s*return\s+"
                      rf"{base}<([^>]*)>", src["stencil3d_bf16.cu"])
        params = [p.strip() for p in m.group(1).split(",")]
        assert len(params) == len(_build.SIGNATURES[name])
        assert _build.SIGNATURES[name] == _build.SIGNATURES[
            f"mg_stencil3d_{base}_f32"]
        targs = [a.strip() for a in m.group(2).split(",")]
        out = "float" if (name.endswith("_f32") or base == "residual") \
            else "__nv_bfloat16"
        assert targs == ["float", "__nv_bfloat16", out]
    assert "__nv_bfloat16" not in src["stencil3d.cu"]
    assert '#include "stencil3d.cuh"' in src["stencil3d.cu"]
