"""Multigrid-accelerated eigensolvers for the smallest Laplacian eigenpairs.

PyTorch port of ``multigridcmt_tpu.solvers.eigen``: block inverse
iteration (II) and Rayleigh-quotient iteration (RQI) with the inner solves
done by multigrid V-cycles, and MG-preconditioned LOBPCG, each started from
the nested-iteration guess (the coarsest level's eigenvectors, solved
densely and prolonged up the hierarchy) or from a caller's block ``v0``.

The outer loops run on the host with one device-to-host copy an outer step
(the eigen-residual, and with it the Ritz values RQI's shifts are made
from); an inner solve syncs once a V-cycle for its own check, as
``cycles.solve`` does. The block's k inner solves run one row after another
(JAX unrolls them statically: Mosaic has no batching rule for its kernels,
and the port's kernels take one grid a call). The Rayleigh quotients and
the Ritz steps apply A by the plain stencil, as JAX's do; the inner solves
and preconditioning cycles run on the configured backend. The small dense
algebra (QR of the (N, k) block, ``eigh``, the Rayleigh-Ritz Cholesky and
triangular solve) is ``torch.linalg``, where JAX has XLA's.

Physics payload: the smallest eigenpair of the 2D Dirichlet Laplacian is
the particle-in-a-box ground state, lambda_1 -> 2 pi^2 as h -> 0.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..config import SolverConfig
from ..grids import Hierarchy
from ..ops import laplacian, transfer
from . import cycles, krylov


class EigenResult(NamedTuple):
    eigenvalues: torch.Tensor   # (k,)
    eigenvectors: torch.Tensor  # (k, *padded_shape), interior-normalised
    iters: int                  # outer iterations taken
    res_history: torch.Tensor   # (max_iters + 1,) max eigen-residual per
                                # iteration; entries past `iters` hold the
                                # final value
    converged: bool


def _flat(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """(k, *padded) -> (k, N) interior-flattened."""
    core = v[(slice(None),) + (slice(1, -1),) * ndim]
    return core.reshape(core.shape[0], -1)


def _unflat(f: torch.Tensor, n: int, ndim: int) -> torch.Tensor:
    """(k, N) -> (k, *padded)."""
    return F.pad(f.reshape((f.shape[0],) + (n,) * ndim), (1, 1) * ndim)


def _orthonormalize(f: torch.Tensor) -> torch.Tensor:
    """Row-orthonormalise (k, N) by the QR of the transpose."""
    q, _ = torch.linalg.qr(f.T)         # (N, k)
    return q.T


def _apply_rows(vv: torch.Tensor, h: float) -> torch.Tensor:
    """A applied to each padded row of the block (the plain stencil)."""
    return torch.stack([laplacian.apply_poisson(u, h) for u in vv])


# ---------------------------------------------------------------------------
# The outer iterations and their tuning constants, as JAX's (shared there
# with its distributed eigensolvers, which inject other primitives).
# ---------------------------------------------------------------------------

# RQI shift schedule (see eigensolve): shifts come on once inverse
# iteration has localised the eigenvalues and go off again in the endgame,
# so that plain II polishes to tol.
RQI_ACTIVE_TOL = 1e-2
RQI_POLISH_TOL = 1e-5
# Back-off: the rediscretised coarse operators see lambda_1 with an
# O(h_coarse^2) error (~5% on the 3^2 coarsest grid); a 10% gap keeps every
# level positive definite, so the shifted inner solves converge.
RQI_BACKOFF = 0.9


def ii_loop(v, *, rayleigh, inner_solve, ritz, method: str, tol: float,
            max_iters: int, rqi_backoff: float = RQI_BACKOFF):
    """Block inverse-iteration / RQI outer loop.

      rayleigh(v)        -> (lam (k,), max eigen-residual, 0-d)
      inner_solve(v, s)  -> the MG solves (A - s_i I) w_i = v_i, one a row;
                            s is a list of Python floats, 0.0 where a
                            shift is off
      ritz(w)            -> (Ritz block, Ritz values)

    One host sync an outer step reads the residual (and the Ritz values
    RQI shifts by) for the loop's checks, with the cumulative divergence
    guard ``cycles.eigen_guard``. Returns (v, lam, iters, hist, res): hist
    has length max_iters + 1, entries past iters repeat the final res.
    """
    lam, res_t = rayleigh(v)
    hist = [res_t]
    vals = torch.cat([res_t.reshape(1), lam]).tolist()    # host sync
    res, lams = vals[0], vals[1:]
    it = div = 0
    while res >= tol and it < max_iters and div < cycles.EIGEN_DIVERGE_TOTAL:
        shift_on = method == "rqi" and RQI_POLISH_TOL < res < RQI_ACTIVE_TOL
        sigma = [lv * rqi_backoff if shift_on else 0.0 for lv in lams]
        v, _ = ritz(inner_solve(v, sigma))
        lam, res_t = rayleigh(v)
        hist.append(res_t)
        vals = torch.cat([res_t.reshape(1), lam]).tolist()  # host sync
        div = cycles.eigen_guard(vals[0], res, div)
        res, lams = vals[0], vals[1:]
        it += 1
    hist += [hist[-1]] * (max_iters - it)
    return v, lam, it, torch.stack(hist), res


def lobpcg_loop(x, *, k: int, rq_res, tcycle, project_out, safe_rownorm,
                rr, combine, tol: float, max_iters: int):
    """LOBPCG outer loop (Knyazev 2001, the "ortho" variant).

    x is an orthonormal block (rows are block vectors):
      rq_res(x)             -> (lam, residual block, max residual, 0-d)
      tcycle(r)             -> the preconditioner (V-cycles) a row
      project_out(f, base)  -> f less its components along base's rows
      safe_rownorm(v, salt) -> rows normalised, dead rows -> a fixed pattern
      rr(s, nkeep)          -> Rayleigh-Ritz coefficients (m, nkeep), values
      combine(c, s)         -> the Ritz block c^T s

    Iteration 0 does a Rayleigh-Ritz step on [X, W], the loop on [X, W, P];
    one host sync an outer step reads the residual. Returns (x, lam, iters,
    hist, res) as ``ii_loop``.
    """
    lam, r, res0 = rq_res(x)
    hist = [res0]
    w = safe_rownorm(project_out(tcycle(r), x), 0.0)
    s = torch.cat([x, w], dim=0)
    c, _ = rr(s, k)
    # Ritz vectors are G-orthonormal by construction (c^T G c = I); a QR
    # here would scramble the eigenpairs' order, so only row-normalise.
    x = safe_rownorm(combine(c, s), 0.5)
    p = safe_rownorm(combine(c[k:, :], w), 1.0)
    lam, _, res_t = rq_res(x)
    hist.append(res_t)
    res = res_t.item()                                      # host sync
    it, div = 1, 0
    while res >= tol and it < max_iters and div < cycles.EIGEN_DIVERGE_TOTAL:
        _, r, _ = rq_res(x)
        salt = float(it)
        w = safe_rownorm(project_out(tcycle(r), x), 2.0 * salt + 2.0)
        p = safe_rownorm(project_out(p, torch.cat([x, w], dim=0)),
                         2.0 * salt + 3.0)
        s = torch.cat([x, w, p], dim=0)
        c, _ = rr(s, k)
        x = safe_rownorm(combine(c, s), 2.0 * salt + 4.0)
        p = combine(c[k:, :], s[k:])      # the W + P contribution (Knyazev)
        lam, _, res_t = rq_res(x)
        hist.append(res_t)
        new_res = res_t.item()                              # host sync
        div = cycles.eigen_guard(new_res, res, div)
        res = new_res
        it += 1
    hist = hist[:max_iters + 1]
    hist += [hist[-1]] * (max_iters + 1 - len(hist))
    return x, lam, it, torch.stack(hist), res


def coarse_init(hier: Hierarchy, k: int, dtype) -> torch.Tensor:
    """Nested-iteration start: the coarsest level's k lowest eigenvectors
    (dense ``eigh``), prolonged linearly up to the finest level. Their
    signs are the LAPACK build's."""
    _, vecs = torch.linalg.eigh(hier.coarse_dense.to(dtype))
    nc = hier.coarsest.n
    v = vecs[:, :k].T.reshape((k,) + (nc,) * hier.ndim)
    v = F.pad(v, (1, 1) * hier.ndim)
    for _ in range(hier.num_levels - 1):
        v = torch.stack([transfer.prolong(u) for u in v])
    return v


def _start_block(hier: Hierarchy, k: int, dtype, v0) -> torch.Tensor:
    """The nested-iteration start, or the caller's (k, *padded) block with
    its ghosts zeroed (the ops rely on the zero-ghost invariant)."""
    if v0 is None:
        return coarse_init(hier, k, dtype)
    v = torch.as_tensor(v0).to(dtype=dtype, device=hier.coarse_dense.device)
    return _unflat(_flat(v, hier.ndim), hier.fine.n, hier.ndim)


def eigensolve(hier: Hierarchy, config: SolverConfig, k: int = 1,
               method: str = "ii", tol: float = 1e-8, max_iters: int = 100,
               inner_cycles: int = 30, inner_tol: Optional[float] = None,
               rqi_backoff: float = RQI_BACKOFF,
               v0: Optional[torch.Tensor] = None) -> EigenResult:
    """The k smallest eigenpairs of the discrete Laplacian.

    ``v0`` (a (k, *padded) block, e.g. an earlier run's ``eigenvectors``)
    warm-starts the iteration in place of the nested-iteration guess; the
    block is orthonormalised again, so any spanning set works.

    method="ii": block inverse iteration, each outer step MG-solves
    A w_i = v_i and then takes a Rayleigh-Ritz step. method="rqi": once
    inverse iteration has localised the eigenvalues (max residual under
    RQI_ACTIVE_TOL), the inner solves shift by sigma_i = rqi_backoff *
    lambda_i, which stays below lambda_1 (the Rayleigh quotient
    overestimates it by O(res^2), the coarse operators see it ~5% off), so
    A - sigma I stays positive definite on every level; under
    RQI_POLISH_TOL the shift goes off again and plain inverse iteration
    polishes to tol.

    The shifts are Python floats, made once an outer step (the kernel
    wrappers take ``float(sigma)``; a device scalar would sync at every
    launch). An off shift is 0.0, so the inner cycles take the unshifted
    route (the precomputed coarse inverse, the fused residual restriction)
    where JAX's traced zero takes the shifted one (a dense coarse solve of
    A - 0 I); the two agree to rounding, not bit for bit.

    Each inner solve runs V-cycles to relative residual ``inner_tol``
    (default 200 eps of the dtype), at most ``inner_cycles``: with a fixed
    cycle count the iteration would converge to an eigenvector of the
    approximate inverse, and the eigen-residual would stall at the inner
    error. Convergence: max_i ||A v_i - lambda_i v_i|| / lambda_i < tol.

    Mixed precision (``config.precond_dtype`` where
    ``krylov.mixed_cycle_dtype`` casts: the packed 2D tier, 3D RB-GS on the
    stencil3d tier): each inner solve is iterative refinement, as in JAX. The defect rhs - (A - sg I) w
    is taken in ``config.dtype`` and a cycle in ``precond_dtype`` from zero
    gives the correction, so the inner solve still reaches ``inner_tol``
    at ``config.dtype``'s grade.
    """
    if method not in ("ii", "rqi"):
        raise ValueError(f"unknown eigensolver method {method!r}")
    ndim, n, h = hier.ndim, hier.fine.n, hier.fine.h
    dtype = config.dtype
    pd = krylov.mixed_cycle_dtype(config, route="the eigensolver")
    v = _start_block(hier, k, dtype, v0)
    v = _unflat(_orthonormalize(_flat(v, ndim)), n, ndim)

    def rayleigh(vv):
        fv, fav = _flat(vv, ndim), _flat(_apply_rows(vv, h), ndim)
        lam = torch.sum(fv * fav, dim=1) / torch.sum(fv * fv, dim=1)
        res = (torch.linalg.vector_norm(fav - lam[:, None] * fv, dim=1)
               / torch.abs(lam))
        return lam, torch.max(res)

    bk = cycles.get_backend(config)
    if inner_tol is None:
        inner_tol = 200.0 * torch.finfo(dtype).eps

    def one(rhs, sg: float):
        """MG-solve (A - sg I) w = rhs to inner_tol, in the backend's
        layout; one host sync a cycle."""
        rhs = bk.encode(rhs)
        rhs_norm = torch.sqrt(torch.sum(rhs * rhs))
        rhs_norm = torch.where(rhs_norm == 0, torch.ones_like(rhs_norm),
                               rhs_norm)
        w = torch.zeros_like(rhs)
        r = rhs
        i, rel = 0, 1.0
        while rel >= inner_tol and i < inner_cycles:
            if pd is None:
                w = cycles.v_cycle(hier, w, rhs, config, sigma=sg)
            else:
                # Refinement: the correction from a pd cycle on the defect.
                rp = r.to(pd)
                dw = cycles.v_cycle(hier, torch.zeros_like(rp), rp, config,
                                    sigma=sg)
                w = w + dw.to(w.dtype)
            r = bk.residual(w, rhs, n, h, sigma=sg)
            rel = (torch.sqrt(torch.sum(r * r)) / rhs_norm).item()
            i += 1
        return bk.decode(w)

    def inner_solve(vv, sigma: List[float]):
        return torch.stack([one(rhs, sg) for rhs, sg in zip(vv, sigma)])

    def ritz(vv):
        """Orthonormalise, project, rotate to Ritz vectors."""
        f = _orthonormalize(_flat(vv, ndim))
        fav = _flat(_apply_rows(_unflat(f, n, ndim), h), ndim)
        hmat = f @ fav.T                        # (k, k), symmetric
        lam, s = torch.linalg.eigh(0.5 * (hmat + hmat.T))
        return _unflat(s.T @ f, n, ndim), lam

    v, lam, iters, hist, res = ii_loop(
        v, rayleigh=rayleigh, inner_solve=inner_solve, ritz=ritz,
        method=method, tol=tol, max_iters=max_iters, rqi_backoff=rqi_backoff)
    return EigenResult(eigenvalues=lam, eigenvectors=v, iters=iters,
                       res_history=hist, converged=res < tol)


# ---------------------------------------------------------------------------
# LOBPCG: locally optimal block preconditioned conjugate gradients.
# ---------------------------------------------------------------------------

def _safe_rownorm(f: torch.Tensor, salt: float) -> torch.Tensor:
    """Normalise block rows; a (near-)zero row becomes a fixed
    pseudo-random direction, so that the Rayleigh-Ritz Gram matrix never
    takes a spurious zero eigenvalue from a dead search direction (as when
    one eigenpair converges to rounding while others lag)."""
    nrm = torch.linalg.vector_norm(f, dim=1, keepdim=True)
    eps = torch.finfo(f.dtype).eps
    rows = torch.arange(f.shape[0], dtype=f.dtype, device=f.device)[:, None]
    cols = torch.arange(f.shape[1], dtype=f.dtype, device=f.device)[None, :]
    fallback = torch.sin((salt + 1.0) * (rows + 1.0) + 0.7391 * cols)
    fallback = fallback / torch.linalg.vector_norm(fallback, dim=1,
                                                   keepdim=True)
    good = nrm > eps * eps
    return torch.where(good, f / torch.where(good, nrm, torch.ones_like(nrm)),
                       fallback)


def lobpcg(hier: Hierarchy, config: SolverConfig, k: int = 1,
           tol: float = 1e-8, max_iters: int = 100, precond_cycles: int = 1,
           v0: Optional[torch.Tensor] = None) -> EigenResult:
    """MG-preconditioned LOBPCG for the k smallest eigenpairs.

    Each step does a Rayleigh-Ritz step on span{X, T R, P}, T being
    ``precond_cycles`` V-cycles from zero and P the previous step's update
    direction (Knyazev, SIAM J. Sci. Comput. 23(2), 2001); with
    ``config.precond_dtype`` where ``krylov.mixed_cycle_dtype`` casts (the
    packed 2D tier, 3D RB-GS on the stencil3d tier), T's cycles run in that
    dtype, cast at T's boundary, as in JAX. One V-cycle a
    block vector a step, against a whole MG solve a step in
    ``eigensolve``: the Ritz step projects on the true A, so T need only
    be a fixed positive definite approximate inverse. Stability follows
    the "ortho" variant (Hetmaniuk and Lehoucq, JCP 2006): W is
    orthogonalised against X and P against [X, W], so the 3k x 3k Gram
    matrix stays near the identity and its jittered Cholesky is safe.
    """
    ndim, n, h = hier.ndim, hier.fine.n, hier.fine.h
    dtype = config.dtype
    bk = cycles.get_backend(config)
    pd = krylov.mixed_cycle_dtype(config, route="the LOBPCG eigensolver")

    def apply_flat(f):
        """(m, N) interior-flattened block -> A applied row by row."""
        return _flat(_apply_rows(_unflat(f, n, ndim), h), ndim)

    def tcycle(r_flat):
        """The preconditioner: precond_cycles V-cycles from zero a row."""
        out = []
        for rhs in _unflat(r_flat, n, ndim):
            rhs_e = bk.encode(rhs)
            if pd is not None:
                rhs_e = rhs_e.to(pd)
            w = torch.zeros_like(rhs_e)
            for _ in range(precond_cycles):
                # A bfloat16 cycle returns float32 (cycles.v_cycle): the next
                # one starts from it stored in pd, as JAX's does.
                w = cycles.v_cycle(hier, w.to(rhs_e.dtype), rhs_e, config)
            out.append(bk.decode(w).to(r_flat.dtype))
        return _flat(torch.stack(out), ndim)

    def rq_res(x):
        """Rayleigh quotients and residual rows of an orthonormal block."""
        ax = apply_flat(x)
        lam = torch.sum(x * ax, dim=1)
        r = ax - lam[:, None] * x
        res = torch.linalg.vector_norm(r, dim=1) / torch.abs(lam)
        return lam, r, torch.max(res)

    def project_out(f, basis):
        """f's rows less their components along basis's (orthonormal)
        rows; twice, for orthogonality to rounding."""
        for _ in range(2):
            f = f - (f @ basis.T) @ basis
        return f

    def rr(s, nkeep):
        """Rayleigh-Ritz on the row basis s: the coefficients c (m, nkeep),
        S^T c's columns the Ritz vectors, and the Ritz values."""
        m = s.shape[0]
        eye = torch.eye(m, dtype=dtype, device=s.device)
        g = s @ s.T
        hm = s @ apply_flat(s).T
        hm = 0.5 * (hm + hm.T)
        eps = torch.finfo(dtype).eps
        ell = torch.linalg.cholesky(g + (100.0 * eps * torch.trace(g)) * eye)
        li = torch.linalg.solve_triangular(ell, eye, upper=False)
        ht = li @ hm @ li.T
        theta, y = torch.linalg.eigh(0.5 * (ht + ht.T))
        return li.T @ y[:, :nkeep], theta[:nkeep]

    x = _orthonormalize(_flat(_start_block(hier, k, dtype, v0), ndim))
    x, lam, iters, hist, res = lobpcg_loop(
        x, k=k, rq_res=rq_res, tcycle=tcycle, project_out=project_out,
        safe_rownorm=_safe_rownorm, rr=rr, combine=lambda c, s: c.T @ s,
        tol=tol, max_iters=max_iters)
    # eigh's Ritz values ascend: lam is sorted.
    return EigenResult(eigenvalues=lam, eigenvectors=_unflat(x, n, ndim),
                       iters=iters, res_history=hist, converged=res < tol)
