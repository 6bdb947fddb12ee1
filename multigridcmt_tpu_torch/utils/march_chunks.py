"""Chained time of the stencil3d z-march kernels for each chunk length.

    python -m multigridcmt_tpu_torch.utils.march_chunks [--n 511 255]
        [--rounds 2]

For each n, each kernel ("rbgs": one RB-GS sweep; "pass": the residual)
and each chunk length in CHUNKS, sets ``stencil3d.MARCH_CHUNK[kernel]``
(march_geometry then balances the chunks and shortens them where the
launch would have fewer than MARCH_MIN_UNITS units) and prints the
chained time (``profiling.chained_ms``) of that kernel on a random float32
(n+2)^3 grid, the planes a unit marches over, and the share of the bytes
bound (12 bytes a point over 3.35 TB/s). The lengths go in turns, the list
forward then backward, ``--rounds`` times; a line gives every reading of
one length. Informative only: MARCH_CHUNK is set from its output by hand.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch

from multigridcmt_tpu_torch.kernels import stencil3d
from multigridcmt_tpu_torch.utils.breakdown import grids
from multigridcmt_tpu_torch.utils.profiling import chained_ms

CHUNKS = {"rbgs": (16, 32, 64, 128, 256, 512), "pass": (4, 8, 16, 32, 64)}
HBM_BYTES_PER_MS = 3.35e9


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, nargs="+", default=[511, 255])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    shipped = dict(stencil3d.MARCH_CHUNK)
    for n in args.n:
        h = 1.0 / (n + 1)
        u, b, _ = grids(n, seed=n, ndim=3)
        bound = 12 * u.numel() / HBM_BYTES_PER_MS
        calls = {"rbgs": lambda: stencil3d.rbgs_sweep(u, b, n, h),
                 "pass": lambda: stencil3d.residual(u, b, n, h)}
        for kernel, fn in calls.items():
            order = list(CHUNKS[kernel])
            times = {c: [] for c in order}
            try:
                for _ in range(args.rounds):
                    for chunk in order + order[::-1]:
                        stencil3d.MARCH_CHUNK[kernel] = chunk
                        stencil3d._launch_geometry.cache_clear()
                        times[chunk].append(chained_ms(fn))
            finally:
                stencil3d.MARCH_CHUNK[kernel] = shipped[kernel]
                stencil3d._launch_geometry.cache_clear()
            for chunk in order:
                stencil3d.MARCH_CHUNK[kernel] = chunk
                geom = stencil3d.march_geometry(kernel, *u.shape, u.dtype)
                stencil3d.MARCH_CHUNK[kernel] = shipped[kernel]
                best = min(times[chunk])
                print(json.dumps({
                    "n": n, "kernel": kernel, "chunk": chunk,
                    "planes": geom[4], "units": geom[0] * geom[1] * geom[2],
                    "shipped": chunk == shipped[kernel], "ms": times[chunk],
                    "min_ms": best, "of_bound": bound / best,
                    "bound_ms": bound}), flush=True)
        del u, b


if __name__ == "__main__":
    main()
