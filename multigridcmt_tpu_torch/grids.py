"""Grid hierarchy for vertex-centred geometric multigrid.

PyTorch port of ``multigridcmt_tpu.grids``. A 1D level with ``n`` interior
points is a tensor of shape ``(n+2,)``, a 2D level ``(n+2, n+2)``, a 3D
level ``(n+2,)*3``, each with a one-cell ghost boundary of zeros. Every
level, on every tier, stays in this logical padded layout: the CUDA
kernels index it directly, so the JAX package's TPU-aligned embedding
(``aligned_shape``/``to_aligned``) has no counterpart here.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .config import SolverConfig
from .ops import laplacian

# Every entry point that builds tensors runs on the card unless the caller
# asks for another device (``device="cpu"``).
DEFAULT_DEVICE = "cuda"


def check_device(device=None) -> torch.device:
    """The device to build on (None: ``DEFAULT_DEVICE``); a CUDA device
    with no card raises instead of carrying on elsewhere."""
    device = torch.device(DEFAULT_DEVICE if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device} requested but no CUDA device "
                           "is available (pass device=\"cpu\" to run on "
                           "the CPU)")
    return device


@dataclasses.dataclass(frozen=True)
class LevelSpec:
    """Static description of one multigrid level."""

    n: int      # interior points per axis
    h: float    # mesh spacing


@dataclasses.dataclass(frozen=True)
class Hierarchy:
    """Static level specs plus the dense coarsest-level operator and inverse.

    ``coarse_inv`` is the dense inverse of the coarsest Poisson operator
    (min_coarse^ndim square), built once on the host in float64 and moved
    to the device in the compute dtype; the coarsest solve is then one
    small matrix-vector product.
    """

    ndim: int
    levels: Tuple[LevelSpec, ...]   # fine -> coarse
    coarse_inv: torch.Tensor
    coarse_dense: torch.Tensor      # dense A_coarsest, for shifted solves

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    @property
    def fine(self) -> LevelSpec:
        return self.levels[0]

    @property
    def coarsest(self) -> LevelSpec:
        return self.levels[-1]


def build_hierarchy(config: SolverConfig, device=None) -> Hierarchy:
    """Build the level list and the dense coarsest inverse on ``device``
    (None: the card, ``DEFAULT_DEVICE``).

    The inverse is computed with NumPy in float64 and then cast to the
    compute dtype, so its accuracy does not depend on that dtype.
    """
    device = check_device(device)
    levels = tuple(LevelSpec(n=n, h=1.0 / (n + 1))
                   for n in config.level_sizes())
    a_dense = laplacian.dense_operator(levels[-1].n, config.ndim,
                                       levels[-1].h)
    inv = np.linalg.inv(a_dense)
    return Hierarchy(
        ndim=config.ndim, levels=levels,
        coarse_inv=torch.as_tensor(inv, dtype=config.dtype, device=device),
        coarse_dense=torch.as_tensor(a_dense, dtype=config.dtype,
                                     device=device))


def pad_interior(interior: torch.Tensor) -> torch.Tensor:
    """Wrap an interior-only array in a one-cell zero ghost boundary."""
    return F.pad(interior, (1, 1) * interior.ndim)


def interior(u: torch.Tensor) -> torch.Tensor:
    """View of the interior of a padded grid array (any ndim)."""
    return u[(slice(1, -1),) * u.ndim]


def grid_coords(n: int, ndim: int, dtype, device=None):
    """Interior coordinates on ``device`` (None: the card); 1D -> (x,),
    2D/3D -> 'ij' meshgrid tuple.

    The offsets 0 .. n-1 in the dtype, then 1 added in it, as
    ``jnp.arange(1, n + 1, dtype)`` computes them: in bfloat16 each offset
    and each sum rounds (past 256 that is not each integer rounded: the
    258th point is 256, not 258); in float32 and float64 every integer
    here is exact."""
    device = check_device(device)
    x = (torch.arange(n, dtype=dtype, device=device) + 1) / (n + 1)
    if ndim == 1:
        return (x,)
    return tuple(torch.meshgrid(*([x] * ndim), indexing="ij"))
