"""Structured solver metrics: per-iteration JSONL records.

PyTorch port of ``multigridcmt_tpu.utils.metrics``, record for record: one
``iteration`` record per history entry (``iter``, ``residual``, ``rho``)
and one ``solve_done`` summary (``iters``, ``converged``,
``final_residual``, ``mean_rho``, ``config``), written by rank 0 of the
process group only, so a multi-rank run has one stream.
"""
from __future__ import annotations

import json
import sys
import time
from typing import IO, Optional

import numpy as np
import torch
import torch.distributed as dist


def is_host0() -> bool:
    """Rank 0 of ``torch.distributed`` when a process group is up, else
    True (one process)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


def _history(res_history) -> np.ndarray:
    """A residual history (tensor or array) as a host array of its own
    dtype."""
    if isinstance(res_history, torch.Tensor):
        return res_history.detach().cpu().numpy()
    return np.asarray(res_history)


class MetricsLogger:
    """JSONL metrics writer (rank 0 only; no-ops elsewhere).

    >>> m = MetricsLogger(open("solve.jsonl", "w"))
    >>> m.log("iteration", iter=3, residual=1.2e-5, rho=0.09)
    """

    def __init__(self, stream: Optional[IO] = None):
        self.stream = stream if stream is not None else sys.stderr
        self.enabled = is_host0()
        self._t0 = time.perf_counter()

    def log(self, event: str, **fields):
        """One record: ``event``, seconds since the logger was made, and
        ``fields`` (0-d tensors and NumPy floats as floats)."""
        if not self.enabled:
            return
        rec = {"event": event,
               "t": round(time.perf_counter() - self._t0, 6)}
        rec.update({k: (float(v) if isinstance(v, (torch.Tensor, np.floating))
                        else v) for k, v in fields.items()})
        self.stream.write(json.dumps(rec) + "\n")
        self.stream.flush()

    def log_solve_result(self, result, config=None):
        """Expand a SolveResult into per-iteration records + a summary."""
        hist = _history(result.res_history)
        iters = int(result.iters)
        for k in range(iters + 1):
            rho = float(hist[k] / hist[k - 1]) if k > 0 and hist[k - 1] > 0 \
                else None
            self.log("iteration", iter=k, residual=float(hist[k]), rho=rho)
        mean_rho = float((hist[iters] / hist[0]) ** (1.0 / max(iters, 1)))
        self.log("solve_done", iters=iters, converged=bool(result.converged),
                 final_residual=float(hist[iters]), mean_rho=mean_rho,
                 config=None if config is None else {
                     "ndim": config.ndim, "k": config.k,
                     "smoother": config.smoother, "cycle": config.cycle,
                     "nu1": config.nu1, "nu2": config.nu2,
                     "tol": config.tol})


def divergence_guard(res_history, iters, threshold: float = 1.0) -> bool:
    """True if the solve is diverging: the residual grew by more than
    ``threshold`` over each of the last two steps."""
    hist = _history(res_history)
    iters = int(iters)
    if iters < 2:
        return False
    return bool(hist[iters] > threshold * hist[iters - 1]
                and hist[iters - 1] > threshold * hist[iters - 2])
