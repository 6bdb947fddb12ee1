"""Inter-grid transfers fused with their neighbours, on the logical padded
layout: the halves of a composed V-cycle leg on a kernel-tier level.

  residual_restrict:  R (b - A u), writing only the coarse grid
  prolong_add:        x + P e in one pass

Replace the TPU kernels ``multigridcmt_tpu/kernels/transfer2d.py``:
``residual_restrict`` and ``prolong_add``, with ``csrc/transfer2d.cu``
(see the note there on what bounds them). ``residual_restrict`` runs the
fused2d down leg's row stream with no smoothing and no store of u'
(``csrc/packed2d_legs.cuh``'s ``residual_restrict_kernel``), on the zero-
sweep down leg's geometry (``leg_geometry``). The cycle takes them where a
level's legs do not fuse: the Chebyshev smoother, or more sweeps than a
fused leg takes. As in the JAX package, residual_restrict has no shift;
the cycle calls it only at sigma = 0.

Each wrapper has its plain PyTorch version beside it: the composition of
the ``ops/`` functions. Device rule (``_wrap``): a CPU tensor takes the
plain version; a CUDA tensor launches the kernel or raises.

Native bfloat16 (the TPU kernels' own mode on bfloat16 grids, a bfloat16
solve's composed legs: every operation rounded to bfloat16):
``native_bf16.residual_restrict`` (no shift term; one launch of the row
stream above with the native arithmetic, ``csrc/transfer2d_native_bf16.cu``)
and ``prolong_add`` (P e by columns first, then rows, as the TPU kernel
interpolates; one launch of ``csrc/transfer2d_prolong_native_bf16.cu``, a
thread a word of two fine rows), counted apart.
"""
from __future__ import annotations

import torch

from ..ops import laplacian, transfer
from . import fused2d, native_bf16
from ._wrap import check_grid, launch_on, on_cuda

# Launches of each CUDA kernel in this process (plain-version calls do not
# count); the native bfloat16 modes apart.
residual_restrict_launches = 0
prolong_add_launches = 0
residual_restrict_bf16_launches = 0
prolong_add_bf16_launches = 0


def _check_pair(n: int, nc: int) -> None:
    if n < 3 or n != 2 * nc + 1:
        raise ValueError(f"fine n={n} is not 2*nc+1 >= 3 for nc={nc}")


def leg_geometry(n: int, *, sm_count: int = 132):
    """The launch geometry of ``residual_restrict`` on the (n+2)^2 grid:
    the zero-sweep fused2d down leg's (its halos, lags and least
    segment)."""
    return fused2d.leg_geometry("down", n, "rbgs", 0, sm_count=sm_count)


def residual_restrict_plain(u, b, n, h):
    """Plain PyTorch version: restrict(b - A u)."""
    return transfer.restrict(laplacian.residual(u, b, h))


def residual_restrict(u: torch.Tensor, b: torch.Tensor, n: int,
                      h: float) -> torch.Tensor:
    """R (b - A u): fine (n+2, n+2) grids -> the ((n-1)/2 + 2)^2 coarse
    grid, ghosts zero, in one pass that never writes the fine residual."""
    global residual_restrict_launches, residual_restrict_bf16_launches
    nc = (n - 1) // 2
    _check_pair(n, nc)
    check_grid("u", u, n, u, storage=True)
    check_grid("b", b, n, u, storage=True)
    if u.dtype == torch.bfloat16:
        rc, launched = native_bf16.residual_restrict(u, b, n, h)
        residual_restrict_bf16_launches += launched
        return rc
    if not on_cuda(u):
        return residual_restrict_plain(u, b, n, h)
    u, b = fused2d._on_pair(u), fused2d._on_pair(b)
    rc = torch.empty((nc + 2, nc + 2), dtype=u.dtype, device=u.device)
    launch_on(u, "transfer2d_residual_restrict", u.data_ptr(), b.data_ptr(),
              rc.data_ptr(), n, float(h),
              fused2d._launch_geometry("down", n, "rbgs", 0, u),
              writes=(rc,))
    residual_restrict_launches += 1
    return rc


def prolong_add_plain(x, e, n, nc):
    """Plain PyTorch version: x + prolong(e)."""
    return x + transfer.prolong(e)


def prolong_add(x: torch.Tensor, e: torch.Tensor, n: int,
                nc: int) -> torch.Tensor:
    """x + P e: coarse e (nc+2, nc+2) into fine x (n+2, n+2), n = 2*nc + 1,
    in one pass; the ghosts of the result are x's."""
    global prolong_add_launches, prolong_add_bf16_launches
    _check_pair(n, nc)
    check_grid("x", x, n, x, storage=True)
    check_grid("e", e, nc, x, storage=True)
    if x.dtype == torch.bfloat16:
        out, launched = native_bf16.prolong_add(x, e, n, nc)
        prolong_add_bf16_launches += launched
        return out
    if not on_cuda(x):
        return prolong_add_plain(x, e, n, nc)
    out = torch.empty_like(x)
    launch_on(x, "transfer2d_prolong_add", x.data_ptr(), e.data_ptr(),
              out.data_ptr(), n, writes=(out,))
    prolong_add_launches += 1
    return out
