"""The pieces of the port's sharded 3D levels (multigridcmt_tpu_torch/
parallel/sharded.py) against JAX's, on one process: the routing gates
(_slab3d_ok, _pencil3d_ok, _slab3d_hz_level) on tiles around their
thresholds, one extended-stack level's kernel calls on an inner rank's
slab and pencil stacks against JAX's interpreted stencil3d on its
TPU-padded stacks (cut by convert.slab_stack_from_jax), and the converter
itself. The solves are in test_torch_sharded3d.py.
"""
import math

import numpy as np
import pytest
import torch

from multigridcmt_tpu_torch import kernels
from multigridcmt_tpu_torch.config import SolverConfig
from multigridcmt_tpu_torch.parallel import sharded

KERNEL3_MIN_N = 10


def test_gates_follow_jax_formulas():
    """_slab3d_ok, _pencil3d_ok and _slab3d_hz_level against JAX's on
    tiles of every depth around their thresholds (JAX's VMEM term holds at
    these sizes), with KERNEL3_MIN_N and PALLAS3_MIN_N at 10 on both
    sides."""
    from multigridcmt_tpu import kernels as jkernels
    from multigridcmt_tpu.config import SolverConfig as JConfig
    from multigridcmt_tpu.parallel import sharded as jsharded

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jkernels, "PALLAS3_MIN_N", KERNEL3_MIN_N)
        patch.setattr(kernels, "KERNEL3_MIN_N", KERNEL3_MIN_N)
        checked = 0
        for smoother in ("rbgs", "jacobi", "chebyshev"):
            for nu1, nu2 in ((1, 2), (2, 2), (3, 1)):
                jcfg = JConfig(ndim=3, k=6, smoother=smoother, nu1=nu1,
                               nu2=nu2, use_pallas=True)
                cfg = SolverConfig(ndim=3, k=6, smoother=smoother, nu1=nu1,
                                   nu2=nu2, use_kernels=True)
                if smoother != "chebyshev":
                    assert sharded._slab3d_hz_level(cfg) == \
                        jsharded._slab3d_hz_level(jcfg)
                for n in (7, 15, 31):
                    for m0 in range(1, 9):
                        for m1 in (0, 3, 4, 5, 6):
                            axes = ((0, "row", 4),) if not m1 else \
                                ((0, "row", 2), (1, "col", 2))
                            jdec = jsharded.Decomp(ndim=3, axes=axes)
                            dec = sharded.Decomp(ndim=3, axes=axes)
                            shape = (m0, m1 or n + 2, n + 2)
                            ju = np.zeros(shape)
                            tu = torch.zeros(shape)
                            assert sharded._pencil3d_ok(tu, n, cfg, dec) == \
                                jsharded._pencil3d_ok(ju, n, jcfg, jdec)
                            for hz in (1, 4, 5):
                                assert sharded._slab3d_ok(
                                    tu, n, smoother, dec, hz) == \
                                    jsharded._slab3d_ok(ju, n, smoother,
                                                        jdec, hz)
                            checked += 1
    assert checked == 3 * 3 * 3 * 8 * 5


@pytest.mark.parametrize("mesh", ["slab", "pencil"])
def test_level_stack_matches_jax(mesh):
    """One extended-stack level's kernel calls on an inner rank's stack
    (slab: rank 1 of 4; pencil: rank (1, 1) of 2 x 2; k = 5, RB-GS V(2,2),
    hz = 5): JAX's stack in its TPU layout (planes to 4, rows to 8,
    columns to 128, as its _slab3d_level pads it) through JAX's
    interpreted stencil3d, cut by convert.slab_stack_from_jax, against the
    port's stack through its wrappers. JAX's kernel rolls around at a
    stack's edge rows and updates its last real plane (the padding planes
    follow it), where the port leaves both alone: the smoothed stacks
    agree on every point the two sweeps leave exact (2 planes and rows a
    sweep inside the stack's edges), the residuals one point further in:
    the ghosts the level reads and the owned points."""
    import jax
    import jax.numpy as jnp

    from multigridcmt_tpu.kernels import stencil3d as jstencil3d
    from multigridcmt_tpu_torch import convert
    from multigridcmt_tpu_torch.kernels import stencil3d

    k, hz, nu = 5, 5, 2
    n = 2 ** k - 1
    h = 1.0 / (n + 1)
    m0 = 2 ** k // (4 if mesh == "slab" else 2)
    goff = m0 + 1 - hz
    roff = goff if mesh == "pencil" else 0
    planes = m0 + 2 * hz
    rows = planes if mesh == "pencil" else n + 2
    rng = np.random.default_rng(11)
    grid = np.zeros((2, n + 2, n + 2, n + 2))
    grid[:, 1:-1, 1:-1, 1:-1] = rng.standard_normal((2, n, n, n))
    grid[1] /= h * h
    padded = np.zeros((2, n + 2 + 2 * hz, n + 2 + 2 * hz, n + 2))
    padded[:, hz:hz + n + 2, hz:hz + n + 2] = grid
    # The rank's stack: global planes (and rows) from goff (roff) on, zero
    # past the grid's ends, as the halo exchange builds it.
    stack = padded[:, goff + hz:goff + hz + planes,
                   roff + hz:roff + hz + rows]
    jax_stack = np.zeros((2, -(-planes // 4) * 4, -(-rows // 8) * 8, 128))
    jax_stack[:, :planes, :rows, :n + 2] = stack

    @jax.jit
    def jax_level(u, b):
        us = jstencil3d.rbgs_sweep(u, b, n, h, sweeps=nu, goff=goff,
                                   roff=roff)
        return us, jstencil3d.residual(us, b, n, h, goff=goff, roff=roff)

    want = [convert.slab_stack_from_jax(t, planes, rows, n, device="cpu")
            for t in jax_level(jnp.asarray(jax_stack[0]),
                               jnp.asarray(jax_stack[1]))]
    u, b = (torch.from_numpy(np.ascontiguousarray(t)) for t in stack)
    us = stencil3d.rbgs_sweep(u, b, n, h, sweeps=nu, goff=goff, roff=roff)
    got = [us, stencil3d.residual(us, b, n, h, goff=goff, roff=roff)]
    for depth, g, w in zip((2 * nu, 2 * nu + 1), got, want):
        inner = (slice(depth, planes - depth),
                 slice(depth, rows - depth) if mesh == "pencil"
                 else slice(None))
        scale = w.abs().max().item()
        np.testing.assert_allclose(g[inner].numpy(), w[inner].numpy(),
                                   rtol=0, atol=1e-13 * scale)
    # The owned points, which the level keeps, lie inside both.
    assert hz >= 2 * nu + 1


def test_slab_stack_from_jax_cuts_the_tpu_layout():
    """A JAX extended stack (planes to 4, rows to 8, columns to 128, zero
    padded) cut to the port's (m0 + 2 hz, rows, n + 2) stack; a stack too
    small raises."""
    from multigridcmt_tpu_torch import convert

    rng = np.random.default_rng(5)
    n, planes, rows = 31, 26, 26
    core = rng.standard_normal((planes, rows, n + 2))
    padded = np.zeros((math.ceil(planes / 4) * 4, math.ceil(rows / 8) * 8,
                       128))
    padded[:planes, :rows, :n + 2] = core
    got = convert.slab_stack_from_jax(padded, planes, rows, n, device="cpu")
    assert got.shape == (planes, rows, n + 2)
    assert np.array_equal(got.numpy(), core)
    with pytest.raises(ValueError, match="plane stack"):
        convert.slab_stack_from_jax(core[:, :, :n], planes, rows, n,
                                    device="cpu")
