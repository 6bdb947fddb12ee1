"""Device time of the fused2d legs (the row stream on the unpacked frame),
of the stencil2d sweeps (the same frame's sweep stream), of the local2d
legs (the row stream on the unpacked tile frame) or of the local2d sweeps
(that frame's sweep stream), for each least segment.

    python -m multigridcmt_tpu_torch.utils.leg_segments [--rounds 2]
    python -m multigridcmt_tpu_torch.utils.leg_segments --sweeps
    python -m multigridcmt_tpu_torch.utils.leg_segments --tile
    python -m multigridcmt_tpu_torch.utils.leg_segments --tile --sweeps

Float32 RB-GS, nu = 2, sigma = 0, random grids at 2047^2, 1023^2, 511^2
and 255^2: ``fused2d.MIN_SEG`` set to each value in SEGMENTS, both legs
through their wrappers (the segment rows the launch takes are printed:
above 2047^2 the launch fills the card with longer ones whatever the
least), each read as 20 calls replayed from a CUDA graph (the device's
time a call with no host work between the launches; a chained call of
these legs through Python reads the host's launch rate at 2047^2 and
below) and as 20 chained calls. The values go in turns, forward then
backward, ``--rounds`` times. ``fused2d.MIN_SEG`` is set from its output.
With ``--sweeps``, the stencil2d sweeps as paths B and C run them (RB-GS
nu = 4 at 2047...255, Jacobi nu = 8 at 1023...255) for each value in
SWEEP_SEGMENTS instead (longer ones too: with 8 stages a unit recomputes
16 halo rows). With ``--tile``, the local2d legs (RB-GS nu = 2) on rank 0's
tiles of a row mesh of 1 at S1's levels 2047...255 for each
``local2d.MIN_SEG`` in SEGMENTS instead (at the 2047 tile the launch fills
the card with 40-row segments whatever the least up to 40). With both,
the local2d sweeps as config 5's S3 and S4 run them on those tiles (RB-GS
nu = 4 at 2047...255, Jacobi nu = 8 at 1023...255) for each
``local2d.MIN_SEG`` in SWEEP_SEGMENTS. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess

import torch

from multigridcmt_tpu_torch.kernels import fused2d, local2d, stencil2d
from multigridcmt_tpu_torch.utils.breakdown import grids, row_tile
from multigridcmt_tpu_torch.utils.profiling import chained_ms

SEGMENTS = (6, 8, 10, 16, 32, 64)
SWEEP_SEGMENTS = (6, 16, 32, 64, 96, 128)
SWEEPS = 2


def graph_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Median over ``reps`` of the CUDA-event time of one replay of a CUDA
    graph that holds ``calls`` calls of ``fn``, over ``calls``. ``fn``
    must launch on the current stream and allocate nothing it keeps; the
    tensors it reads must stay referenced while the graph lives (capture
    frees the allocator's cached blocks)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def segments(rounds: int) -> None:
    shipped = fused2d.MIN_SEG
    kw = dict(kind="rbgs", omega=1.0, sweeps=SWEEPS)
    order = list(SEGMENTS)
    try:
        for n in (2047, 1023, 511, 255):
            nc, h = (n - 1) // 2, 1.0 / (n + 1)
            u, b, e = grids(n, seed=n)
            calls = {
                "down": lambda: fused2d.smooth_residual_restrict(
                    u, b, n, h, **kw),
                "up": lambda: fused2d.prolong_add_smooth(u, e, b, n, nc, h,
                                                         **kw)}
            for _ in range(rounds):
                for seg in order + order[::-1]:
                    fused2d.MIN_SEG = seg
                    rows = "/".join(str(fused2d.leg_geometry(
                        leg, n, "rbgs", SWEEPS).seg) for leg in calls)
                    print(f"n={n} MIN_SEG={seg} (segments {rows} rows): " +
                          ", ".join(f"{leg} {graph_ms(fn):.4f}/"
                                    f"{chained_ms(fn):.4f}"
                                    for leg, fn in calls.items()),
                          flush=True)
    finally:
        fused2d.MIN_SEG = shipped


def sweep_segments(rounds: int) -> None:
    shipped = fused2d.MIN_SEG
    order = list(SWEEP_SEGMENTS)
    try:
        for n in (2047, 1023, 511, 255):
            h = 1.0 / (n + 1)
            u, b, _ = grids(n, seed=n)
            # name -> (kind, sweeps, call)
            calls = {"rbgs nu=4": ("rbgs", 4, lambda: stencil2d.rbgs_sweep(
                u, b, n, h, sweeps=4))}
            if n <= 1023:
                calls["jacobi nu=8"] = ("jacobi", 8, lambda: (
                    stencil2d.jacobi_sweep(u, b, n, h, 0.8, sweeps=8)))
            for _ in range(rounds):
                for seg in order + order[::-1]:
                    fused2d.MIN_SEG = seg
                    print(f"n={n} MIN_SEG={seg}: " + ", ".join(
                        f"{name} (segments of "
                        f"{fused2d.leg_geometry('sweep', n, kind, nu).seg}) "
                        f"{graph_ms(fn):.4f}/{chained_ms(fn):.4f}"
                        for name, (kind, nu, fn) in calls.items()),
                        flush=True)
    finally:
        fused2d.MIN_SEG = shipped


def tile_segments(rounds: int) -> None:
    shipped = local2d.MIN_SEG
    kw = dict(kind="rbgs", omega=1.0, sweeps=SWEEPS)
    order = list(SEGMENTS)
    off = 1 - local2d.HALO_ROWS
    try:
        for n in (2047, 1023, 511, 255):
            nc, h = (n - 1) // 2, 1.0 / (n + 1)
            *_, ue, be, ee = row_tile(n, n)
            calls = {
                "down": lambda: local2d.down_leg(ue, be, n, h, n + 1, off,
                                                 **kw),
                "up": lambda: local2d.up_leg(ue, ee, be, n, nc, h, n + 1,
                                             off, **kw)}
            for _ in range(rounds):
                for seg in order + order[::-1]:
                    local2d.MIN_SEG = seg
                    rows = "/".join(str(local2d.leg_geometry(
                        leg, *ue.shape, n, off, 0, "rbgs", SWEEPS).seg)
                        for leg in calls)
                    print(f"tile {tuple(ue.shape)} n={n} MIN_SEG={seg} "
                          f"(segments {rows} rows): " +
                          ", ".join(f"{leg} {graph_ms(fn):.4f}/"
                                    f"{chained_ms(fn):.4f}"
                                    for leg, fn in calls.items()),
                          flush=True)
    finally:
        local2d.MIN_SEG = shipped


def tile_sweep_segments(rounds: int) -> None:
    shipped = local2d.MIN_SEG
    order = list(SWEEP_SEGMENTS)
    off = 1 - local2d.HALO_ROWS
    try:
        for n in (2047, 1023, 511, 255):
            h = 1.0 / (n + 1)
            *_, ue, be, _ = row_tile(n, n)
            # name -> (kind, sweeps, call)
            calls = {"rbgs nu=4": ("rbgs", 4, lambda: local2d.rbgs_sweep(
                ue, be, n, h, off, sweeps=4))}
            if n <= 1023:
                calls["jacobi nu=8"] = ("jacobi", 8, lambda: (
                    local2d.jacobi_sweep(ue, be, n, h, 0.8, off, sweeps=8)))
            for _ in range(rounds):
                for seg in order + order[::-1]:
                    local2d.MIN_SEG = seg
                    parts = []
                    for name, (kind, nu, fn) in calls.items():
                        g = local2d.leg_geometry("sweep", *ue.shape, n, off,
                                                 0, kind, nu)
                        parts.append(f"{name} (segments of {g.seg}) "
                                     f"{graph_ms(fn):.4f}/"
                                     f"{chained_ms(fn):.4f}")
                    print(f"tile {tuple(ue.shape)} n={n} MIN_SEG={seg}: "
                          + ", ".join(parts), flush=True)
    finally:
        local2d.MIN_SEG = shipped


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--sweeps", action="store_true",
                    help="the sweeps instead of the legs")
    ap.add_argument("--tile", action="store_true",
                    help="the local2d kernels on rank 0's tiles instead")
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    print("readings: ms a call (graph/chained)", flush=True)
    {(False, False): segments, (True, False): sweep_segments,
     (False, True): tile_segments, (True, True): tile_sweep_segments}[
        args.sweeps, args.tile](args.rounds)


if __name__ == "__main__":
    main()
