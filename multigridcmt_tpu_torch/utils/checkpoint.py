"""Checkpoint and resume of a solve or an eigensolve.

PyTorch port of ``multigridcmt_tpu.utils.checkpoint`` (Orbax there,
``torch.save`` here). A snapshot holds the iterate ``x`` (an eigensolve's
eigenvector block), its residual history, its iteration count, any extra
arrays, and an explicit ``kind``: ``"solve"`` or ``"eigen"``.
``resume_solve`` routes on that kind. JAX's routes on whether the snapshot
holds an ``eigenvalues`` key, so a solve snapshot that carries one resumes
as an eigensolve (ROADMAP.md, queue 3, F3); here it resumes as a solve.

Resuming a solve restarts the outer cycles from the saved x: a cycle is a
fixed-point map, so the resumed cycles are the ones the uninterrupted solve
runs next, bit for bit. Rank 0 writes the snapshot; with a process group
up, every rank waits at a barrier until it is written, so that each can
read it.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from .metrics import is_host0

KINDS = ("solve", "eigen")


def _host(v) -> torch.Tensor:
    """A tensor (any device) or array-like as a CPU tensor."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    return torch.from_numpy(np.array(v))


def save_state(path: str, x, res_history, iters,
               extra: Optional[Dict[str, Any]] = None,
               kind: str = "solve") -> None:
    """Snapshot solver state to the file ``path`` (replaced if it exists):
    ``kind`` "solve" (x: the padded iterate) or "eigen" (x: the (k,
    *padded) eigenvector block; ``extra`` may hold its eigenvalues). Every
    rank calls it; rank 0 writes."""
    if kind not in KINDS:
        raise ValueError(f"snapshot kind {kind!r}: expected one of {KINDS}")
    if is_host0():
        state = {"kind": kind, "x": _host(x),
                 "res_history": _host(res_history),
                 "iters": int(iters)}
        for k, v in (extra or {}).items():
            if k in state:
                raise ValueError(f"extra key {k!r} would replace the "
                                 "snapshot's own")
            state[k] = _host(v)
        path = os.path.abspath(path)
        tmp = path + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def load_state(path: str) -> Dict[str, Any]:
    """Restore a snapshot saved by ``save_state`` (tensors on the CPU)."""
    return torch.load(os.path.abspath(path), map_location="cpu",
                      weights_only=True)


def _device(solver) -> torch.device:
    """Where the solver's tensors live: the problem's device, or the
    mesh's for a ``ShardedSolver``."""
    if hasattr(solver, "problem"):
        return solver.problem.b.device
    return solver.mesh.device


def resume_solve(solver, path: str, b=None, **solve_kwargs):
    """Resume an interrupted solve or eigensolve from a snapshot.

    Works against both ``MultigridSolver`` (b defaults to the problem's
    RHS) and ``ShardedSolver`` (pass the full padded RHS as ``b``, or save
    it in the snapshot via ``extra={"b": ...}``). A "solve" snapshot
    restarts the outer iteration with x0 = saved x; an "eigen" snapshot
    restarts ``solver.eigensolve`` from the saved block (``v0``), which is
    re-orthonormalised on entry. Extra keyword arguments (e.g.
    ``method="pcg"``, or an eigensolve's ``k``) pass through.
    """
    state = load_state(path)
    kind = state.get("kind")
    dev = _device(solver)
    x0 = state["x"].to(dev)
    if kind == "eigen":
        return solver.eigensolve(v0=x0, **solve_kwargs)
    if kind != "solve":
        raise ValueError(f"{path}: snapshot kind {kind!r}, expected one of "
                         f"{KINDS}")
    if b is None and "b" in state:
        b = state["b"]
    if b is None:
        if not hasattr(solver, "problem"):
            # ShardedSolver has no stored RHS: solver.solve(b, ...) needs
            # it explicitly.
            raise ValueError(
                "ShardedSolver resume needs the RHS: pass b= to "
                "resume_solve, or save it in the snapshot via "
                'extra={"b": ...}')
        return solver.solve(x0=x0, **solve_kwargs)
    return solver.solve(torch.as_tensor(b).to(dev), x0=x0, **solve_kwargs)
