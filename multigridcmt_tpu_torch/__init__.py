"""multigridcmt_tpu_torch — the PyTorch and CUDA port of multigridcmt_tpu.

Geometric multigrid for the Poisson problem on the 2^k - 1 vertex-centred
grid: the plain PyTorch tier (``ops/``), the V/W/FMG cycles with their
guards (``solvers/cycles.py``), MG-PCG (``solvers/krylov.py``), the
MG eigensolvers (``solvers/eigen.py``), and hand-written CUDA kernels
(``kernels/``), held against the JAX package, which stays the reference.
``ROADMAP.md`` lists what is not ported yet.
"""
import torch

from .api import (MultigridSolver, Problem, poisson, poisson1d,  # noqa: F401
                  poisson2d, poisson3d)
from .config import SolverConfig  # noqa: F401
from .grids import Hierarchy, build_hierarchy, interior, pad_interior  # noqa: F401
from .solvers.cycles import (SolveResult, convergence_factor,  # noqa: F401
                             fmg, solve, v_cycle)
from .solvers.eigen import EigenResult, eigensolve  # noqa: F401
from .solvers.krylov import solve_pcg  # noqa: F401

# The coarsest solve is a float32 matrix product on the card; TF32 would
# keep only about three decimal digits of it. PyTorch's default is off;
# the package pins it so that a caller's setting cannot change results.
torch.backends.cuda.matmul.allow_tf32 = False

__version__ = "0.1.0"
