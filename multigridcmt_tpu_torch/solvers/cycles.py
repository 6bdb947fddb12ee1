"""Multigrid cycles: V- and W-cycles, full multigrid (FMG) and the outer
solve loop.

PyTorch port of ``multigridcmt_tpu.solvers.cycles``. The recursion runs
eagerly over the static level list; every op goes through a ``Backend``
record, so the CUDA kernels (``kernels/``) replace the plain PyTorch
stencils level by level without touching the drivers. All grids are
padded with a one-cell zero ghost boundary (``grids.py``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..config import SolverConfig
from ..grids import Hierarchy, interior, pad_interior
from ..ops import bf16, laplacian, smoothers, transfer
from ..utils import profiling


class Backend(NamedTuple):
    """Pluggable stencil implementations (plain PyTorch default; the CUDA
    kernel tier in ``kernels/``).

    Arrays flow through a cycle in the backend's layout: the logical padded
    grid on every level of the plain backend; the kernel backend packs its
    finest 2D levels by colour (``kernels/packed2d.py``). ``encode`` and
    ``decode`` convert once a solve (or a public ``v_cycle`` call), at its
    boundary. The ops take their level's interior size (which decides the
    layout) and h:
      smooth(u, b, n, h, kind=..., omega=..., sweeps=..., sigma=...)
      residual(u, b, n, h, sigma=...)
      restrict(r)               # fine grid -> coarse grid
      prolong(e, nc)            # coarse level nc -> fine level 2*nc+1
      encode(u) / decode(u)
    Optional fused transfers (None: composed from the ops above):
      residual_restrict(u, b, n, h) = restrict(residual(u, b, n, h)), at
          sigma = 0 only
      prolong_add(x, e, n, nc[, out_dtype=]) = x + prolong(e, nc)
    Optional whole-leg fusions (one pass over the fine grid per leg); the
    callable returns None to decline a level, and the cycle then composes
    the leg from the ops above:
      smooth_residual_restrict(u, b, n, h, kind=, omega=, sweeps=, sigma=)
          -> (u', rc) | None
      prolong_add_smooth(x, e, b, n, nc, h, kind=, omega=, sweeps=, sigma=
          [, out_dtype=]) -> x' | None
    A bfloat16 level (the top of a mixed cycle, ``krylov.mixed_cycle_dtype``)
    gets ``out_dtype=torch.float32`` in both up hooks: its correction add
    promotes to float32.
    Optional fused convergence check, ||b - A x||^2 without writing the
    residual (None declines; red_only=True asserts that x has just
    finished an RB-GS sweep, whose closing black half-sweep zeroes the
    black residual):
      residual_norm2(x, b, n, h, red_only=False) -> 0-d tensor | None
    """

    smooth: Callable
    residual: Callable
    restrict: Callable
    prolong: Callable
    encode: Callable
    decode: Callable
    residual_restrict: Optional[Callable] = None
    prolong_add: Optional[Callable] = None
    smooth_residual_restrict: Optional[Callable] = None
    prolong_add_smooth: Optional[Callable] = None
    residual_norm2: Optional[Callable] = None


PLAIN_BACKEND = Backend(
    smooth=lambda u, b, n, h, **kw: smoothers.smooth(u, b, h, **kw),
    residual=lambda u, b, n, h, sigma=0.0: laplacian.residual(
        u, b, h, sigma=sigma),
    restrict=transfer.restrict,
    prolong=lambda e, nc: transfer.prolong(e),
    encode=lambda u: u,
    decode=lambda u: u,
)


def get_backend(config: SolverConfig) -> Backend:
    if config.use_kernels:
        if config.ndim == 3 and config.smoother != "rbgs":
            # The JAX package's rule (its cycles.get_backend): a 3D Jacobi
            # or Chebyshev cycle takes the plain stencils even with kernels
            # on; only RB-GS runs the stencil3d kernels. That rule came from
            # a TPU measurement; whether the H100 wants the Jacobi kernel
            # here is open (PERF.md).
            return PLAIN_BACKEND
        from ..kernels import KERNEL3_MIN_N, KERNEL_BACKEND

        if (config.ndim == 3 and config.dtype == torch.bfloat16
                and config.n >= KERNEL3_MIN_N):
            # The stencil3d kernels store bfloat16 as a mixed cycle's fine
            # level (precond_dtype); they emit the coarse levels and the
            # correction in float32, so a bfloat16 solve's cycle would
            # return float32. JAX's solve rejects that (its while_loop
            # keeps x's dtype), so there is no reference for this route.
            raise NotImplementedError(
                "stencil3d: a bfloat16 solve on the 3D kernel tier has no "
                "reference: the cycle returns float32 and the JAX "
                "package's solve rejects that dtype (use precond_dtype "
                "for a bfloat16 preconditioner)")
        return KERNEL_BACKEND
    return PLAIN_BACKEND


def coarse_solve(hier: Hierarchy, b: torch.Tensor, sigma=0.0) -> torch.Tensor:
    """Direct solve on the coarsest level (always in the logical layout:
    no backend packs a level that small).

    sigma == 0: one small product with the precomputed dense inverse (a
    plain ``torch.matmul``; float32 products run in full float32, see the
    package ``__init__``). Shifted: a dense solve on (A_c - sigma*I).
    """
    nc = hier.coarsest.n
    r = interior(b).reshape(-1)
    if laplacian._is_zero(sigma):
        x = (hier.coarse_inv @ r.to(hier.coarse_inv.dtype)).to(r.dtype)
    else:
        cd = hier.coarse_dense
        a = cd - sigma * torch.eye(cd.shape[0], dtype=cd.dtype,
                                   device=cd.device)
        x = torch.linalg.solve(a, r.to(cd.dtype)).to(r.dtype)
    return pad_interior(x.reshape((nc,) * hier.ndim))


def v_cycle(hier: Hierarchy, x: torch.Tensor, b: torch.Tensor,
            config: SolverConfig, level: int = 0, sigma=0.0,
            gamma: int = 1) -> torch.Tensor:
    """One multigrid cycle starting at ``level`` (gamma=1: V, gamma=2: W).

    Mixed precision: x and b in bfloat16 (only the fine level of a mixed
    cycle is, packed 2D or 3D; its kernels emit the coarse levels in
    float32) make the top level's correction add promote to float32, and
    the post-smoothing that follows it runs in float32 with b widened once.
    In 3D the add is ``x + P e`` itself (a bfloat16 x plus a float32
    correction is float32), as in JAX, and the cycle returns float32 as
    JAX's does. On the packed 2D tier the up leg stores x' in float32
    (``out_dtype``), where the JAX package's single-device cycle stores
    bfloat16: its final bfloat16 store of the top level makes the
    preconditioner break down as k grows (ROADMAP.md, queue 3, F5), and
    this is the repair JAX's sharded tier makes (``local2d.up_leg``'s
    ``out_dtype``)."""
    bk = get_backend(config)
    spec = hier.levels[level]
    omega = config.effective_omega()
    if level == hier.num_levels - 1:
        with profiling.level_scope(level):
            return coarse_solve(hier, b, sigma)
    with profiling.level_scope(level):
        down = None
        if bk.smooth_residual_restrict is not None:
            down = bk.smooth_residual_restrict(
                x, b, spec.n, spec.h, kind=config.smoother, omega=omega,
                sweeps=config.nu1, sigma=sigma)
        if down is not None:
            x, rc = down
        else:
            x = bk.smooth(x, b, spec.n, spec.h, kind=config.smoother,
                          omega=omega, sweeps=config.nu1, sigma=sigma)
            if bk.residual_restrict is not None and laplacian._is_zero(sigma):
                rc = bk.residual_restrict(x, b, spec.n, spec.h)
            else:
                rc = bk.restrict(bk.residual(x, b, spec.n, spec.h,
                                             sigma=sigma))
        ec = torch.zeros_like(rc)
    for _ in range(gamma):
        ec = v_cycle(hier, ec, rc, config, level=level + 1, sigma=sigma,
                     gamma=gamma)
    nc = hier.levels[level + 1].n
    wide = ({"out_dtype": torch.float32} if x.dtype == torch.bfloat16
            else {})
    with profiling.level_scope(level):
        up = None
        if bk.prolong_add_smooth is not None:
            up = bk.prolong_add_smooth(
                x, ec, b, spec.n, nc, spec.h, kind=config.smoother,
                omega=omega, sweeps=config.nu2, sigma=sigma, **wide)
        if up is not None:
            x = up
        else:
            if bk.prolong_add is not None:
                x = bk.prolong_add(x, ec, spec.n, nc, **wide)
            else:
                x = x + bk.prolong(ec, nc)
            x = bk.smooth(x, b.to(x.dtype), spec.n, spec.h,
                          kind=config.smoother, omega=omega,
                          sweeps=config.nu2, sigma=sigma)
    return x


def cycle(hier: Hierarchy, x: torch.Tensor, b: torch.Tensor,
          config: SolverConfig, sigma=0.0) -> torch.Tensor:
    """One cycle of the configured type from the finest level (an FMG
    config cycles by V-cycles, as JAX's)."""
    gamma = 2 if config.cycle == "w" else 1
    return v_cycle(hier, x, b, config, level=0, sigma=sigma, gamma=gamma)


def fmg(hier: Hierarchy, b: torch.Tensor, config: SolverConfig,
        n_vcycles: int = 1) -> torch.Tensor:
    """Full multigrid: restrict b through the whole hierarchy, solve the
    coarsest level directly, then walk up: prolong the current solution as
    the start of the next finer level and run ``n_vcycles`` V-cycles
    there. The walk prolongs linearly on the backend, or by the cubic
    ``transfer.fmg_prolong`` on the logical layout (``config.fmg_prolong
    = "cubic"``). The backend's layout in and out."""
    bk = get_backend(config)
    bs = [b]
    for _ in range(hier.num_levels - 1):
        bs.append(bk.restrict(bs[-1]))
    x = coarse_solve(hier, bs[-1])
    for level in range(hier.num_levels - 2, -1, -1):
        nc = hier.levels[level + 1].n
        if config.fmg_prolong == "cubic":
            x = bk.encode(transfer.fmg_prolong(bk.decode(x)))
        else:
            x = bk.prolong(x, nc)
        for _ in range(n_vcycles):
            x = v_cycle(hier, x, bs[level], config, level=level)
    return x


class SolveResult(NamedTuple):
    x: torch.Tensor            # padded solution
    iters: int                 # number of cycles taken
    res_history: torch.Tensor  # (max_iters + 1,) relative residual norms;
                               # entries past `iters` hold the final value
    converged: bool


# Failure detection, as in the JAX package: stall = residual not improving
# (>= 0.9x, the dtype's roundoff floor); diverge = residual grew more than
# DIVERGE_FACTOR in one cycle, DIVERGE_PATIENCE times in a row.
STALL_PATIENCE = 3
DIVERGE_FACTOR = 10.0
DIVERGE_PATIENCE = 2


def _in(dtype, x: float) -> float:
    """x rounded to bfloat16 for a bfloat16 history (JAX forms the guards'
    products and meets the tolerance in the history's dtype), else x."""
    return float(bf16.scalar(x)) if dtype == torch.bfloat16 else x


def step_guards(new_rel: float, rel: float, stall: int, div: int,
                dtype=None):
    """Updated (stall, diverge) counters after one outer iteration. With a
    bfloat16 ``dtype`` (the history's), 0.9 rel and 10 rel are formed in
    bfloat16 as JAX forms them: 0.9 rounded to bfloat16, then the product
    rounded."""
    stall = stall + 1 if new_rel >= _in(dtype, _in(dtype, 0.9) * rel) else 0
    div = div + 1 if new_rel > _in(dtype, DIVERGE_FACTOR * rel) else 0
    return stall, div


def guards_ok(stall: int, div: int) -> bool:
    return stall < STALL_PATIENCE and div < DIVERGE_PATIENCE


# The eigensolvers' outer loops count growths cumulatively: a broken shift
# (an indefinite operator) makes the eigen-residual oscillate, up 10x, down,
# up again, as the Ritz step renormalises every iteration, so a count of
# growths in a row never fires. A sound run grows at most once or twice
# (when the shift comes on).
EIGEN_DIVERGE_TOTAL = 4


def eigen_guard(new_res: float, res: float, div: int) -> int:
    """Cumulative count of eigen-residual growths by more than
    DIVERGE_FACTOR."""
    return div + (1 if new_res > DIVERGE_FACTOR * res else 0)


def _norm(v: torch.Tensor) -> torch.Tensor:
    """||v||_2. bfloat16: JAX's ``sqrt(sum(v * v))`` as the JAX package
    computes it on the CPU: each square rounded to bfloat16, the sum in
    float32 rounded once, the root in bfloat16; other dtypes
    ``vector_norm``."""
    if v.dtype == torch.bfloat16:
        return torch.sqrt((v * v).float().sum().to(v.dtype))
    return torch.linalg.vector_norm(v)


def solve(hier: Hierarchy, b: torch.Tensor, config: SolverConfig,
          x0: Optional[torch.Tensor] = None) -> SolveResult:
    """Iterate cycles until ||r|| / ||b|| < config.tol.

    With ``config.cycle == "fmg"``, FMG runs once first (``x0`` is then
    not read, as in JAX); its residual is the history's first entry, and
    V-cycles polish it while the tolerance asks for more.

    The loop runs on the host: each cycle ends with one device-to-host
    copy of the residual norm for the convergence and guard checks (the
    JAX package keeps the whole loop on the device in a while_loop).
    """
    bk = get_backend(config)
    n, h = hier.fine.n, hier.fine.h
    # Every op relies on the zero-ghost invariant: zero the user's ghosts.
    b = bk.encode(pad_interior(interior(b)))
    if config.cycle == "fmg":
        x = fmg(hier, b, config)
    else:
        x = (torch.zeros_like(b) if x0 is None
             else bk.encode(pad_interior(interior(x0))))
    b_norm = _norm(b)
    b_norm = torch.where(b_norm == 0, torch.ones_like(b_norm), b_norm)

    def rel_res(x, red_only=False):
        if bk.residual_norm2 is not None:
            v = bk.residual_norm2(x, b, n, h, red_only=red_only)
            if v is not None:
                return torch.sqrt(v) / b_norm
        return _norm(bk.residual(x, b, n, h)) / b_norm

    # After a cycle x ends with the finest level's post-smoothing: for
    # RB-GS its closing black half-sweep zeroes the black residual, so a
    # fused check needs the red points only.
    post_red = config.smoother == "rbgs" and config.nu2 >= 1

    hist = [rel_res(x)]
    rel = hist[0].item()                      # host sync
    dtype = hist[0].dtype
    tol = _in(dtype, config.tol)
    stall = div = 0
    while rel >= tol and len(hist) <= config.max_iters \
            and guards_ok(stall, div):
        x = cycle(hier, x, b, config)
        hist.append(rel_res(x, red_only=post_red))
        new_rel = hist[-1].item()             # host sync, once per cycle
        stall, div = step_guards(new_rel, rel, stall, div, dtype)
        rel = new_rel
    iters = len(hist) - 1
    # Entries past `iters` repeat the final residual (the JAX history has
    # the static length max_iters + 1).
    hist += [hist[-1]] * (config.max_iters - iters)
    return SolveResult(x=bk.decode(x), iters=iters,
                       res_history=torch.stack(hist),
                       converged=rel < tol)


def convergence_factor(result: SolveResult) -> float:
    """Geometric-mean residual reduction per cycle over the iterations run:
    rho = (r_final / r_0) ** (1 / iters)."""
    r0 = result.res_history[0].item()
    rk = result.res_history[result.iters].item()
    return (rk / r0) ** (1.0 / max(result.iters, 1))
