"""Solver configuration (PyTorch port of ``multigridcmt_tpu.config``).

One frozen dataclass holds every knob. Field names and defaults match the
JAX package one for one, so ``convert.config_from_jax`` maps a JAX config
field by field; the only renames are ``dtype`` (a ``torch.dtype`` here)
and ``use_pallas``, which is ``use_kernels`` here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static configuration for a multigrid solve.

    Attributes:
      ndim: spatial dimension (1, 2 or 3).
      k: grid exponent; the fine grid has ``n = 2**k - 1`` interior points
        per axis (vertex-centred coarsening, Dirichlet ghosts).
      dtype: compute dtype, ``torch.float32`` or ``torch.float64``.
      nu1, nu2: pre- and post-smoothing sweeps per level (for Chebyshev,
        the polynomial degrees).
      smoother: "jacobi", "rbgs" or "chebyshev".
      omega: Jacobi damping; None selects 2d/(2d+1).
      cycle: "v", "w" or "fmg" (full multigrid once, then V-cycles).
      min_coarse: coarsest-level interior size per axis.
      tol: relative residual tolerance ||r|| / ||b||.
      max_iters: outer-cycle cap (also the residual-history length - 1).
      use_kernels: route the large levels (2D: n >= ``kernels.KERNEL_MIN_N``;
        3D RB-GS: n >= ``kernels.KERNEL3_MIN_N``) through the hand-written
        CUDA kernels (``kernels/``) instead of the plain PyTorch stencils.
      precond_dtype: the dtype of the preconditioning cycles (MG-PCG's, the
        eigensolvers' inner solves, as iterative refinement, and LOBPCG's),
        e.g. ``torch.bfloat16``; the outer iteration stays in ``dtype``.
        Read by ``solvers.krylov.mixed_cycle_dtype``, as in JAX: the cycle
        is cast on the packed 2D tier (``use_kernels`` and the fine level
        packs, n >= ``kernels.PACK_MIN_N``) and for 3D RB-GS on the
        stencil3d tier (``use_kernels``, n >= ``kernels.KERNEL3_MIN_N``, up
        to k=10 in bfloat16, where JAX's TPU kernel fits VMEM), where
        bfloat16 lives only in the fine level's storage (the kernels
        compute in float32, emit the coarse levels in float32, and the top
        level's correction promotes to float32: ``cycles.v_cycle``); it is
        ignored elsewhere. ``ShardedSolver``'s MG-PCG reads it through
        ``parallel.sharded.mixed_leg_dtype``, as JAX's does: the cycle is
        cast where the fine level runs the whole-leg kernels (2D rows and
        blocks, ``use_kernels``, tiles at least ``HALO_ROWS`` deep), the
        fine tiles then stored in bfloat16 and the top level's up leg
        storing float32; its eigensolvers cast there too (II/RQI's inner
        solves as iterative refinement, LOBPCG's preconditioner at its
        boundary); its solve by cycles, FMG and ``v_cycle_fn`` ignore it,
        and its 3D solves still raise.
      fmg_prolong: the FMG solution walk's prolongation, "linear" or
        "cubic" (``ops.transfer.fmg_prolong``). The sharded FMG walks
        linearly only, and ``ShardedSolver`` refuses "cubic".
      mesh_axis, agglom_rows: kept so that JAX configs convert one to one;
        the single-device solvers do not read them.
    """

    ndim: int = 2
    k: int = 8
    dtype: torch.dtype = torch.float32
    nu1: int = 2
    nu2: int = 2
    smoother: str = "jacobi"
    omega: Optional[float] = None
    cycle: str = "v"
    min_coarse: int = 3
    tol: float = 1e-8
    max_iters: int = 100
    use_kernels: bool = False
    mesh_axis: str = "row"
    agglom_rows: int = 64
    precond_dtype: Optional[torch.dtype] = None
    fmg_prolong: str = "linear"

    def __post_init__(self):
        if not isinstance(self.dtype, torch.dtype):
            raise TypeError(f"dtype must be a torch.dtype, got {self.dtype!r}")
        if self.ndim not in (1, 2, 3):
            raise ValueError(f"ndim must be 1, 2, or 3, got {self.ndim}")
        if self.k < 2:
            raise ValueError(f"k must be >= 2, got {self.k}")
        if self.smoother not in ("jacobi", "rbgs", "chebyshev"):
            raise ValueError(f"unknown smoother {self.smoother!r}")
        if self.cycle not in ("v", "w", "fmg"):
            raise ValueError(f"unknown cycle {self.cycle!r}")
        if (self.precond_dtype is not None
                and not isinstance(self.precond_dtype, torch.dtype)):
            raise TypeError("precond_dtype must be a torch.dtype or None, "
                            f"got {self.precond_dtype!r}")
        if self.fmg_prolong not in ("linear", "cubic"):
            raise ValueError(f"unknown fmg_prolong {self.fmg_prolong!r}")

    @property
    def n(self) -> int:
        """Interior points per axis on the finest grid."""
        return 2 ** self.k - 1

    @property
    def h(self) -> float:
        """Mesh spacing on the finest grid (unit domain)."""
        return 1.0 / (self.n + 1)

    def effective_omega(self) -> float:
        if self.omega is not None:
            return self.omega
        return (2.0 * self.ndim) / (2.0 * self.ndim + 1.0)   # 2/3, 4/5, 6/7

    def level_sizes(self) -> Tuple[int, ...]:
        """Interior sizes fine to coarse: 2^k-1, 2^(k-1)-1, ..., <= min_coarse."""
        sizes = []
        kk = self.k
        while True:
            n = 2 ** kk - 1
            sizes.append(n)
            if n <= self.min_coarse or kk <= 1:
                break
            kk -= 1
        return tuple(sizes)
