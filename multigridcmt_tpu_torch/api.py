"""User-facing API: problem builders and the MultigridSolver facade.

PyTorch port of ``multigridcmt_tpu.api``. Model problem: -Laplace(u) = f
on the unit interval/square/cube with homogeneous Dirichlet boundary,
discretised on 2^k - 1 interior points per axis; the default right-hand
side has the analytic solution u = prod sin(pi x_i).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from .config import SolverConfig
from .grids import (Hierarchy, build_hierarchy, check_device,
                    grid_coords, interior, pad_interior)
from .ops import bf16, sparse
from .solvers import cycles, eigen, krylov


@dataclasses.dataclass(frozen=True)
class Problem:
    """An assembled Poisson problem: config + hierarchy + padded RHS."""

    config: SolverConfig
    hierarchy: Hierarchy
    b: torch.Tensor                       # padded RHS
    u_exact: Optional[torch.Tensor]       # padded analytic solution, if known


def _default_f(ndim: int):
    """RHS whose exact solution is u = prod sin(pi x_i). On bfloat16
    coordinates pi and ndim pi^2 are rounded to bfloat16 before use, as
    JAX's weak typing rounds them; float32 and float64 compute as before."""
    def f(*coords):
        out = bf16.weak(ndim * math.pi ** 2, coords[0])
        for c in coords:
            out = out * torch.sin(bf16.weak(math.pi, c) * c)
        return out
    return f


def _default_u(*coords):
    out = 1.0
    for c in coords:
        out = out * torch.sin(bf16.weak(math.pi, c) * c)
    return out


def poisson(k: int, ndim: int, f: Optional[Callable] = None,
            config: Optional[SolverConfig] = None, device=None,
            **config_overrides) -> Problem:
    """Assemble a Poisson problem on the 2^k - 1 interior grid on ``device``
    (None: the card, ``grids.DEFAULT_DEVICE``; ``device="cpu"`` for the
    CPU). With no card, a CUDA device raises ``RuntimeError``.

    ``f`` maps interior coordinate tensors to the RHS; None selects the
    model problem with a known analytic solution. Extra keyword arguments
    override `SolverConfig` fields.
    """
    device = check_device(device)
    if config is None:
        config = SolverConfig(ndim=ndim, k=k, **config_overrides)
    else:
        config = dataclasses.replace(config, ndim=ndim, k=k,
                                     **config_overrides)
    hier = build_hierarchy(config, device=device)
    coords = grid_coords(config.n, ndim, config.dtype, device=device)
    exact = None
    if f is None:
        f = _default_f(ndim)
        exact = pad_interior(_default_u(*coords).to(config.dtype))
    b = pad_interior(f(*coords).to(config.dtype))
    return Problem(config=config, hierarchy=hier, b=b, u_exact=exact)


def poisson1d(k: int, **kw) -> Problem:
    return poisson(k, ndim=1, **kw)


def poisson2d(k: int, **kw) -> Problem:
    return poisson(k, ndim=2, **kw)


def poisson3d(k: int, **kw) -> Problem:
    """7-point 3D Poisson on a (2^k - 1)^3 grid."""
    return poisson(k, ndim=3, **kw)


class MultigridSolver:
    """Facade over the cycles and the eigensolvers.

    >>> prob = poisson2d(k=8, smoother="rbgs")
    >>> solver = MultigridSolver(prob)
    >>> result = solver.solve()
    >>> x = solver.fmg()
    >>> pairs = solver.eigensolve(k=1)
    """

    def __init__(self, problem: Problem):
        self.problem = problem
        self.config = problem.config
        self.hierarchy = problem.hierarchy

    def solve(self, b: Optional[torch.Tensor] = None,
              x0: Optional[torch.Tensor] = None,
              method: str = "mg") -> cycles.SolveResult:
        """Solve A x = b with stationary cycles (method="mg") or CG
        preconditioned by one cycle an iteration (method="pcg"; in
        ``config.precond_dtype`` on the packed 2D tier and the 3D RB-GS
        stencil3d tier, see ``SolverConfig``). The stationary solve reads no precond_dtype, as
        in JAX."""
        b = self.problem.b if b is None else b
        if method == "pcg":
            return krylov.solve_pcg(self.hierarchy, b, self.config, x0=x0)
        if method != "mg":
            raise ValueError(f"unknown solve method {method!r}")
        return cycles.solve(self.hierarchy, b, self.config, x0=x0)

    def v_cycle(self, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """One cycle on logical padded arrays."""
        bk = cycles.get_backend(self.config)
        out = cycles.cycle(self.hierarchy, bk.encode(x), bk.encode(b),
                           self.config)
        return bk.decode(out)

    def fmg(self, b: Optional[torch.Tensor] = None,
            n_vcycles: int = 1) -> torch.Tensor:
        """One full-multigrid pass, O(N): ``n_vcycles`` V-cycles a level
        (1 reaches discretisation accuracy in 1D and 2D; 3D wants 2).
        Logical padded arrays in and out."""
        b = self.problem.b if b is None else b
        bk = cycles.get_backend(self.config)
        return bk.decode(cycles.fmg(self.hierarchy, bk.encode(b),
                                    self.config, n_vcycles=n_vcycles))

    def eigensolve(self, k: int = 1, method: str = "ii", tol: float = 1e-8,
                   max_iters: int = 100, inner_cycles: int = 30,
                   inner_tol: Optional[float] = None,
                   v0: Optional[torch.Tensor] = None) -> eigen.EigenResult:
        """The k smallest eigenpairs: method="ii" (block inverse
        iteration), "rqi" (Rayleigh-quotient shifts) or "lobpcg"
        (MG-preconditioned LOBPCG: one V-cycle a vector a step instead of
        a whole inner solve). ``v0``, a (k, *padded) block, warm-starts
        the iteration. With ``config.precond_dtype`` on the packed 2D tier
        or the 3D RB-GS stencil3d tier the inner cycles run in it: II and
        RQI as iterative refinement, LOBPCG's preconditioner cast at its
        boundary."""
        if method == "lobpcg":
            return eigen.lobpcg(self.hierarchy, self.config, k=k, tol=tol,
                                max_iters=max_iters, v0=v0)
        return eigen.eigensolve(self.hierarchy, self.config, k=k,
                                method=method, tol=tol, max_iters=max_iters,
                                inner_cycles=inner_cycles,
                                inner_tol=inner_tol, v0=v0)

    def as_csr(self) -> sparse.CSR:
        """The fine-level operator as an explicit CSR matrix, on the
        problem's device."""
        c = self.config
        return sparse.laplacian_csr(c.n, c.ndim, c.h, dtype=c.dtype,
                                    device=self.problem.b.device)

    def as_coo(self) -> sparse.COO:
        """The fine-level operator as a COO matrix, on the problem's
        device."""
        c = self.config
        return sparse.laplacian_coo(c.n, c.ndim, c.h, dtype=c.dtype,
                                    device=self.problem.b.device)

    def discrete_l2_error(self, x: torch.Tensor) -> torch.Tensor:
        """h^(d/2)-weighted L2 error against the analytic solution."""
        if self.problem.u_exact is None:
            raise ValueError("problem has no analytic solution attached")
        c = self.config
        diff = interior(x) - interior(self.problem.u_exact)
        return torch.linalg.vector_norm(diff) * (c.h ** (c.ndim / 2.0))
