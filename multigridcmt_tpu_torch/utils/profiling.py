"""Profiling hooks (port of ``level_scope`` from
``multigridcmt_tpu.utils.profiling``) and CUDA-event timers.

Each multigrid level runs inside a named ``torch.profiler`` range, so a
``torch.profiler.profile`` trace shows one row per level. The JAX module's
``trace`` and ``Timer`` are not ported yet: they raise, naming their
ROADMAP.md item.
"""
from __future__ import annotations

import statistics

import torch


UTILS_TODO = ("profiling.{name} is not ported to PyTorch yet (ROADMAP.md, "
              "queue 1: utils)")


def trace(*args, **kwargs):
    raise NotImplementedError(UTILS_TODO.format(name="trace"))


class Timer:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(UTILS_TODO.format(name="Timer"))


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
