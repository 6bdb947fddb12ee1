"""Tracing and timing hooks (port of ``multigridcmt_tpu.utils.profiling``)
and CUDA-event timers.

``trace`` writes a Chrome/Perfetto trace of a block from
``torch.profiler``; each multigrid level runs inside a named range
(``level_scope``), so the trace shows one row per level. ``Timer`` is a
wall-clock timer with an explicit device fence. ``cuda_time_ms`` and
``chained_ms`` time a call by CUDA events.
"""
from __future__ import annotations

import contextlib
import os
import socket
import statistics
import time

import torch
from torch.profiler import ProfilerActivity, profile


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace around a block: the CPU ops, and the card's kernels
    when a card is present, written on exit (also when the block raises)
    as ``<logdir>/<host>_<pid>.<ns>.pt.trace.json``, a Chrome/Perfetto
    trace that TensorBoard's PyTorch profiler plugin also reads. Yields
    the ``torch.profiler.profile`` (its ``key_averages()``, its events).

    >>> with trace("/tmp/mg-trace"):
    ...     solver.solve()
    """
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    try:
        with prof:
            yield prof
            if cuda:
                torch.cuda.synchronize()
    finally:
        prof.export_chrome_trace(os.path.join(
            logdir, f"{socket.gethostname()}_{os.getpid()}."
            f"{time.time_ns()}.pt.trace.json"))


class Timer:
    """Wall-clock timer with an explicit device fence: CUDA calls return
    before the card finishes, so time work that ends in ``fence``.

    >>> with Timer() as t:
    ...     Timer.fence(solver.solve().x)
    >>> t.elapsed
    """

    def __init__(self):
        self.t0 = None
        self.elapsed = None

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        return False

    @staticmethod
    def fence(x: torch.Tensor) -> float:
        """Wait for ``x``'s device to finish its work and return
        ``float(x.sum())`` (a scalar fetched from ``x`` itself)."""
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
        return float(x.sum())


class count_cycles:                                         # noqa: N801
    """Counts the cycles started at the finest level while active: calls
    of ``cycles.v_cycle`` with level 0 (its recursion passes level + 1)."""

    def __enter__(self):
        from ..solvers import cycles

        self.count = 0
        self._orig = orig = cycles.v_cycle

        def counting(*args, **kwargs):
            self.count += kwargs.get("level", 0) == 0
            return orig(*args, **kwargs)

        cycles.v_cycle = counting
        return self

    def __exit__(self, *exc):
        from ..solvers import cycles

        cycles.v_cycle = self._orig
        return False


def level_scope(level: int):
    """Named profiler range for one multigrid level."""
    return torch.profiler.record_function(f"mg_level_{level}")


def cuda_time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median over ``reps`` of the CUDA-event time, in ms, of one call of
    ``fn`` on the current device, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def chained_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Median over ``reps`` of the CUDA-event time of ``calls`` back-to-back
    calls of ``fn`` between one pair of events, over ``calls``: the
    device's time a call once the host runs ahead of the card."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)
