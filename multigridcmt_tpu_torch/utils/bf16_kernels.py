"""Hold the paired bfloat16 kernels (the 3D RB-GS and Jacobi sweeps' paired
marches and the packed residual's word kernel), the float32 and float64
kernels that took a storage type for a bfloat16 mode (the BELL SpMM and
the residual norms) and those of the files that hold or sit beside a
native bfloat16 mode (the stencil2d and local2d residuals and sweeps, the
DIA SpMV, every row-streaming leg of packed2d_legs.cuh) against other
trees' builds, bit for bit, and time them in turns, on one CUDA card; and
the native bfloat16 fused2d legs, whole-grid RB-GS and Jacobi sweeps and
residual restriction (the row stream) and prolongation-add (a block
kernel) against the first other tree's native launches.

    python -m multigridcmt_tpu_torch.utils.bf16_kernels OTHER [OTHER ...] \\
        [--json PATH] [--steps 2,3,4,5,6,7,8]

Each OTHER is the root of another checkout of the repository (the parent
commit unpacked with ``git archive`` into the git-ignored
``.chip_scratch/``). Every csrc/*.cu that a tree has is compiled, each by
its own nvcc with the library's flags and ``-Xptxas -v``, all at once, and
linked into a library a tree; the port's wrappers launch into this
tree's. Then:

1. ptxas: the registers and spill bytes of every float32 and float64
   kernel (by mangled name from the kernel's own name on; presnorm_partial
   and bell_spmm_kernel, whose float names gained the storage type, by
   kernel, type and update rule or m-tile) of this build against the first
   OTHER's; the bfloat16 kernels' lines of every library side by side (the
   native legs' registers and spills among them).
2. Bits: the bfloat16 RB-GS sweep storing bfloat16 and float32 (sigma 0
   and 11.5) at 511^3 (the paired march here) and on two 511^3 plane
   stacks, one with goff + roff even (paired) and one odd (the scalar
   march); the bfloat16 Jacobi sweep storing bfloat16 (sigma 0 and 11.5)
   at 511^3 and on the mixed Jacobi paths' slab and pencil stacks
   (JACOBI_STACKS; the paired Jacobi march here, on r odd and r even), and
   storing float32 at 511^3 (the scalar march everywhere); the stencil3d
   bfloat16 residual at 511^3; the bfloat16 packed residual (sigma 0 and
   11.5) at 4095^2 and 511^2; the float32 and float64 residual norms
   (the whole grid's at 4095^2 and 255^2, the packed tile's on S1's fine
   tile, an 8-way row rank and a 2x2 block rank (float64: ranks of
   255^2), red only and both planes, sigma 0 and 11.5) and BELL SpMMs (the
   bench matrix at m = 128 and 8, with NaN and Inf in Xt's first block
   column, and 4 x 3 blocks in float64 at m = 16); the float32 and float64
   stencil2d residual and sweeps (RB-GS nu = 1 and 4, Jacobi nu = 8; float32
   at 2047^2 and 1023^2, float64 at 255^2), local2d residual and sweeps on
   S1's fine tile, a 2x2 block rank of 2047^2 and (float64) a row rank of
   255^2, and the DIA SpMV (4095^2 float32, 255^3 float64), sigma 0 and
   11.5; on the same inputs in each library, bit for bit. A call is replayed through ctypes with the arguments this tree's
   wrapper passed (captured once); an OTHER that predates a paired march
   takes the scalar march's geometry (march_geometry unpaired), which is
   what its own wrapper passes. Then (leg_calls) the float row-streaming
   legs: fused2d's down and up legs (float32 at 2047^2, RB-GS nu = 2 at
   sigma 0, Jacobi nu = 3 at 11.5; float64 at 255^2), the float32
   residual restriction at 2047^2 and the packed legs at 4095^2; and
   utils/bf16_legs.py's bfloat16 storage modes of the packed, local2d and
   plocal2d legs and the packed sweep (its CASES).
3. Times, at sigma 0: each bfloat16 mode in each library and its float32
   twin (the same entry point's float32 form in this library, on the
   widened inputs), in turns (the libraries in order, then in reverse):
   chained (LEG_CHAIN calls between one pair of CUDA events, median of 5)
   and the profiler's device time a call; beside the bound (its inputs
   read once and outputs written once at 3.35 TB/s). The bfloat16 Jacobi
   sweep also on the two JACOBI_STACKS. The float32 sweep and residual of
   stencil3d at 511^3, the float32 packed residual and red-only norm at
   4095^2 (the main path's), the plocal2d red-only norm at S1's tile and
   the float32 BELL SpMM at the bench shape are timed from this library
   and the first OTHER's the same way.
4. Cycles: the mixed Jacobi paths' preconditioning cycle at 511^3
   (slab511-mixed-jacobi and pencil511-mixed-jacobi on a mesh of 1: a
   sharded cycle from zero on the defect in bfloat16, storing float32 at
   the end, as ShardedSolver's PCG runs it) through the port's wrappers
   on each library's kernels (an OTHER without the paired Jacobi march
   runs the scalar one, as its own wrapper does), in turns beside the
   float32 cycle on the same defect: chained (CYCLE_CHAIN cycles between
   one pair of CUDA events, median of 5), the profiler's device busy time
   a cycle, its device ops and the stencil3d Jacobi kernels' time.
5. The profiler after a trace: the paired Jacobi sweep's device time a
   call read again after one ``utils.profiling.trace`` window (CPU and
   CUDA activity, exported), beside its reading before and its chained
   time; chip_smoke.py's phase 3 takes such a trace before phase 4 reads
   its kernels' device times.
6. The native bfloat16 fused2d legs at 2047^2, 1023^2, 511^2 and 255^2
   (RB-GS nu = 2, sigma 0; for the bits also Jacobi nu = 2 and RB-GS
   nu = 0 at sigma 11.5): this tree's row stream (one launch a leg, through the wrapper)
   and, where the first OTHER has it, that tree's chain of native_bf16.cu
   launches as its wrapper made them (the sweeps, a launch a colour a
   sweep, then the restriction with sig u; the prolongation-add by rows
   first, then the sweeps), called through ctypes with its own argument
   types: bit for bit against each other, then in turns: single (one call
   alone), chained and the profiler's device time a call, beside the bound
   (the inputs read once and the outputs written once in bfloat16).
7. The native bfloat16 RB-GS sweeps of a whole grid and the native
   residual restriction at the same levels: this tree's row streams (one
   launch each, through the wrappers) and, where the first OTHER launches
   them from native_bf16.cu (native_rbgs_kernel, a launch a colour a
   sweep; native_restrict_kernel, a thread a coarse point), that tree's
   launches through ctypes with its own argument types: bit for bit at nu
   = 1 .. 4, sigma 0 and 11.5, then in turns at sigma 0 (nu = 4 and 1)
   as step 6 times the legs.
8. The native bfloat16 Jacobi sweeps of a whole grid and the native
   prolongation-add at the same levels: this tree's Jacobi sweep stream
   and block kernel (one launch each, through the wrappers) and, where
   the first OTHER launches them from native_bf16.cu
   (native_jacobi_kernel, a launch a sweep; native_prolong_kernel, a
   thread a fine point), that tree's launches through ctypes with its own
   argument types: bit for bit at nu = 1 .. 8, sigma 0 and 11.5, then in
   turns at sigma 0 (nu = 8 and 1; the prolongation-add beside its
   yardstick, x + F.interpolate(e, bilinear, aligned corners) in
   bfloat16, whose relative difference is logged) as step 6 times the
   legs.

``--steps`` picks the steps after step 1 (the ptxas comparison, which
always runs); the default runs them all.

Prints the card's name and power limit, a line for each finding and one
JSON object last; exits 1 if a bit differs or a float32/float64 kernel's
ptxas line differs. Needs nvcc and a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from multigridcmt_tpu_torch.kernels import (_build, bell, local2d, packed2d,
                                            plocal2d, stencil3d)
from multigridcmt_tpu_torch.utils import bf16_legs
from multigridcmt_tpu_torch.utils.bf16_legs import (LEG_CHAIN,
                                                    PEAK_BYTES_PER_S, Call,
                                                    bits, finish_build,
                                                    in_turns, log,
                                                    start_build)
from multigridcmt_tpu_torch.utils.breakdown import device_busy
from multigridcmt_tpu_torch.utils.profiling import chained_ms

KERNEL = re.compile(r"(native_residual_restrict_kernel|native_sweep_kernel|"
                    r"native_jacobi_sweep_kernel|native_prolong_add_kernel|"
                    r"native_residual_kernel|native_rbgs_kernel|"
                    r"native_jacobi_kernel|native_restrict_kernel|"
                    r"native_prolong_kernel|native_down_kernel|"
                    r"native_up_kernel|rbgs_pairs_kernel|rbgs_kernel|"
                    r"jacobi_pairs_kernel|pass_kernel|"
                    r"presidual_pairs_kernel|presidual_kernel|"
                    r"presnorm_partial|sum_partials|bell_spmm_kernel|"
                    r"local_residual_kernel|residual_restrict_kernel|"
                    r"residual_kernel|sweep_kernel|spmv_dia_kernel|"
                    r"prolong_add_kernel|down_kernel|up_kernel)\w*")
# The kernels whose float32/float64 names gained a storage type S = T: a
# name's (kernel, type, update rule or m-tile).
RENAMED = re.compile(r"(presnorm_partial)I([fd])NS_\d+([A-Za-z]+?)E[fd]?E|"
                     r"(bell_spmm_kernel)I([fd])[fd]?Li(\d+)E")
BF, F32 = torch.bfloat16, torch.float32
N3, N2 = 511, 4095
SIGMA = 11.5
# Plane stacks of the 511^3 grid (goff, roff, p, r): goff + roff even (the
# paired march) and odd (chip_smoke.py's MIXED3D_STACK: the scalar one).
STACKS = ((200, 0, 63, 513), (200, -1, 63, 513))
# The mixed Jacobi paths' fine stacks at 511^3 on a mesh of 1 (goff, roff,
# p, r; chip_smoke.py's SHARDED3D_STACKS): the slab (r odd) and the pencil
# (r even), both paired for Jacobi.
JACOBI_STACKS = ((-2, 0, 518, 513), (-2, -2, 518, 518))
OMEGA = 6.0 / 7.0
# The residual's grids: the mixed path's and k = 9.
RESIDUAL_NS = (N2, 511)
# The 2D Jacobi sweeps' omega (config 5's S4, a 2D Jacobi cycle's 4/5).
OMEGA2 = 0.8
# Cycles a chained reading of the mixed Jacobi cycle takes.
CYCLE_CHAIN = 5
# The stencil3d Jacobi kernels (the paired march, pass_kernel's kJacobi).
JACOBI_KERNELS = re.compile(r"(?<!\w)(jacobi_pairs_kernel<|"
                            r"pass_kernel<(float|double), \d+, 1,)")


def ptxas_lines(text: str) -> dict:
    """{mangled name from the kernel's own name on: sorted [(registers,
    spill bytes)], each line once (a kernel compiled in several
    translation units, as sum_partials, has one line each)} of the
    kernels KERNEL names in ptxas's -v output."""
    props, name, spill = {}, None, 0
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            k = KERNEL.search(m.group(1))
            name, spill = (m.group(1)[k.start():] if k else None), 0
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            props.setdefault(name, []).append((int(m.group(1)), spill))
            name = None
    return {k: sorted(set(v)) for k, v in props.items()}


def tree_sources(root: Path) -> tuple:
    """Every kernel source of the tree at ``root``."""
    csrc = root / "multigridcmt_tpu_torch" / "kernels" / "csrc"
    return tuple(sorted(p.name for p in csrc.glob("*.cu")))


def ptxas_key(name: str):
    """A kernel's name for comparing builds: RENAMED's (kernel, type, rule
    or m-tile), else the name itself."""
    m = RENAMED.match(name)
    return tuple(g for g in m.groups() if g) if m else name


def compare_ptxas(mine: str, others: dict, first: str) -> tuple:
    """(failures, the bfloat16 kernels' lines): the float32/float64
    kernels against ``first``'s."""
    fails, lines = [], {}
    own = ptxas_lines(mine)
    own_keys = {ptxas_key(k): v for k, v in own.items()}
    for label, text in others.items():
        theirs = ptxas_lines(text)
        full = ([k for k in theirs if "__nv_bfloat16" not in k]
                if label == first else [])
        differ = [k for k in full if own_keys.get(ptxas_key(k)) != theirs[k]]
        for k in full:
            if isinstance(ptxas_key(k), tuple):
                log(f"ptxas {' '.join(map(str, ptxas_key(k)))}: {label} "
                    f"{theirs[k]}, this {own_keys.get(ptxas_key(k))}")
        log(f"ptxas {label}: {len(full)} float32/float64 kernels, "
            f"{len(full) - len(differ)} equal, {len(differ)} differ")
        fails += [f"ptxas {label} {k}: {theirs[k]} against "
                  f"{own_keys.get(ptxas_key(k))}" for k in differ]
        for k, v in theirs.items():
            if "__nv_bfloat16" in k:
                lines.setdefault(k, {})[label] = v
    for k, v in own.items():
        if "__nv_bfloat16" in k:
            lines.setdefault(k, {})["this"] = v
    return fails, lines


class Replay(Call):
    """A captured launch whose geometry argument is recomputed for each
    library: ``geom_for(lib)``, or None for the captured one."""

    def __init__(self, run, inputs, geom_for=None):
        super().__init__(run, inputs)
        self.geom_for = geom_for

    def with_args(self, lib):
        geom = None if self.geom_for is None else self.geom_for(lib)
        if geom is None:
            return self
        other = object.__new__(Replay)
        other.__dict__.update(self.__dict__, args=[
            geom if isinstance(a, ctypes.Array) else a for a in self.args])
        return other


def march_flavour(lib, text: str) -> None:
    """Mark lib with the paired marches its ptxas output names: ``_pairs``
    (the RB-GS sweep's, rbgs_pairs_kernel) and ``_jacobi_pairs`` (the
    Jacobi sweep's, jacobi_pairs_kernel)."""
    lib._pairs = "rbgs_pairs_kernel" in text
    lib._jacobi_pairs = "jacobi_pairs_kernel" in text


def geometry(kernel: str, shape: tuple, paired: bool):
    """march_geometry's bfloat16 ints as the kernel's array."""
    return (ctypes.c_int * 5)(*stencil3d.march_geometry(kernel, *shape, BF,
                                                        paired=paired))


def cube(seed: int):
    """bfloat16 u, b (b of 1/h^2 size) on the 511^3 grid."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.zeros((N3 + 2,) * 3, device="cuda")
    b = torch.zeros_like(u)
    u[1:-1, 1:-1, 1:-1] = torch.randn((N3,) * 3, generator=gen,
                                      device="cuda")
    b[1:-1, 1:-1, 1:-1] = torch.randn((N3,) * 3, generator=gen,
                                      device="cuda") * float((N3 + 1) ** 2)
    return u.to(BF), b.to(BF)


def cut(g, goff: int, roff: int, p: int, r: int):
    """Planes goff .. goff + p - 1 and rows roff .. roff + r - 1 of the
    grid g, zero where they leave it."""
    s = torch.zeros((p, r, g.shape[2]), dtype=g.dtype, device=g.device)
    z, y = max(0, -goff), max(0, roff)
    planes = g[max(goff, 0):goff + p, y:roff + r]
    s[z:z + planes.shape[0], y - roff:y - roff + planes.shape[1]] = planes
    return s


def packed(n: int, seed: int, dtype=None):
    """Packed u, b (b of 1/h^2 size) in bfloat16, or in ``dtype`` with the
    grid's h^2 b as well."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.zeros((n + 2, n + 2), device="cuda", dtype=dtype or F32)
    b = torch.zeros_like(u)
    u[1:-1, 1:-1] = torch.randn((n, n), generator=gen, device="cuda",
                                dtype=u.dtype)
    b[1:-1, 1:-1] = torch.randn((n, n), generator=gen, device="cuda",
                                dtype=u.dtype) * float((n + 1) ** 2)
    if dtype is None:
        return packed2d.pack(u).to(BF), packed2d.pack(b).to(BF)
    return packed2d.pack(u), packed2d.pack(b)


def sweep_call(u, b, sigma, out_dtype, goff=0, roff=0) -> Replay:
    """One bfloat16 RB-GS sweep through the wrapper, replayable."""
    n = N3
    run = (lambda: stencil3d.rbgs_sweep(u, b, n, 1.0 / (n + 1), sigma=sigma,
                                        goff=goff, roff=roff,
                                        out_dtype=out_dtype))
    scalar = geometry("rbgs", tuple(u.shape), False)
    return Replay(run, (u, b), lambda lib: None if lib._pairs else scalar)


def jacobi_call(u, b, sigma, out_dtype, goff=0, roff=0) -> Replay:
    """One bfloat16 Jacobi sweep through the wrapper, replayable; storing
    bfloat16 it runs the paired march here (jacobi_pairs holds on every
    stack of these)."""
    n = N3
    run = (lambda: stencil3d.jacobi_sweep(u, b, n, 1.0 / (n + 1), OMEGA,
                                          sigma=sigma, goff=goff, roff=roff,
                                          out_dtype=out_dtype))
    scalar = geometry("pass", tuple(u.shape), False)
    return Replay(run, (u, b), lambda lib: None if (
        out_dtype is not None or lib._jacobi_pairs) else scalar)


def stencil3d_residual_call(u, b, sigma) -> Replay:
    return Replay(lambda: stencil3d.residual(u, b, N3, 1.0 / (N3 + 1),
                                             sigma=sigma), (u, b))


def residual_call(u, b, n, sigma) -> Replay:
    return Replay(lambda: packed2d.residual(u, b, n, 1.0 / (n + 1),
                                            sigma=sigma), (u, b))


def kept_call(run, inputs) -> Replay:
    """``Replay(run, inputs)`` that keeps alive the scratch its wrapper
    allocates with torch.empty (the norms' partial sums), which every
    replay's arguments point to."""
    kept, real = [], torch.empty

    def keeping(*args, **kw):
        t = real(*args, **kw)
        kept.append(t)
        return t

    torch.empty = keeping
    try:
        call = Replay(run, inputs)
    finally:
        torch.empty = real
    call.keep = (call.keep, kept)
    return call


def bench_bell(dtype):
    """The SpMV bench's blocked-ELL matrix (64 x 64 blocks of 128^2 N(0,1)
    values at density 0.15 plus the block diagonal, seed 1, as
    chip_smoke.py's bell_bench_host) and its Xt (128, 8192), on the card."""
    import numpy as np
    import scipy.sparse as sp

    rng = np.random.default_rng(1)
    mask = rng.random((64, 64)) < 0.15
    mask[np.arange(64), np.arange(64)] = True
    blocks = {(i, j): rng.standard_normal((128, 128)).astype(np.float32)
              for i, j in zip(*np.nonzero(mask))}
    a_sp = sp.bmat([[sp.csr_matrix(blocks[(i, j)]) if (i, j) in blocks
                     else None for j in range(64)] for i in range(64)],
                   format="csr")
    xt = rng.standard_normal((128, 64 * 128)).astype(np.float32)
    return (bell.bell_from_scipy(a_sp, dtype=dtype, device="cuda"),
            torch.from_numpy(xt).to(device="cuda", dtype=dtype))


def ext_tiles(n: int, dtype, ranks, rank, seed: int):
    """One rank's extended tiles of u and b (b of 1/h^2 size) in a row
    split (``ranks[1] == 0``) or block split of the padded n^2 grid, and
    (m, mcol, row_off, col_off)."""
    hh = local2d.HALO_ROWS
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = [torch.zeros((n + 2, n + 2), dtype=dtype, device="cuda")
         for _ in range(2)]
    for k, x in enumerate(g):
        x[1:-1, 1:-1] = torch.randn((n, n), generator=gen, device="cuda",
                                    dtype=dtype) * float((n + 1) ** (2 * k))
    m = (n + 1) // ranks[0]
    mcol = (n + 1) // ranks[1] if ranks[1] else 0
    row_off = rank[0] * m + 1 - hh
    col_off = rank[1] * mcol + 1 - hh if ranks[1] else 0
    rows, cols = m + 2 * hh, (mcol + 2 * hh if mcol else n + 2)
    out = []
    for x in g:
        t = torch.zeros((rows, cols), dtype=dtype, device="cuda")
        r0, c0 = max(row_off, 0), max(col_off, 0)
        r1, c1 = min(row_off + rows, n + 2), min(col_off + cols, n + 2)
        t[r0 - row_off:r1 - row_off, c0 - col_off:c1 - col_off] = \
            x[r0:r1, c0:c1]
        out.append(t)
    return out, (m, mcol, row_off, col_off)


def tile(n: int, dtype, ranks, rank, seed: int):
    """``ext_tiles``' tiles packed (plocal2d.pack_ext), and (m, mcol,
    row_off, col_off)."""
    out, geom = ext_tiles(n, dtype, ranks, rank, seed)
    return [plocal2d.pack_ext(t, 1 if geom[1] else 0) for t in out], geom


def grid(n: int, dtype, seed: int):
    """u, b (b of 1/h^2 size) on the padded n^2 grid in ``dtype``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.zeros((n + 2, n + 2), device="cuda", dtype=dtype)
    b = torch.zeros_like(u)
    u[1:-1, 1:-1] = torch.randn((n, n), generator=gen, device="cuda",
                                dtype=dtype)
    b[1:-1, 1:-1] = torch.randn((n, n), generator=gen, device="cuda",
                                dtype=dtype) * float((n + 1) ** 2)
    return u, b


def float_calls() -> list:
    """(label, make) of the float32 and float64 norm and BELL cases held
    bit for bit (step 2)."""
    calls = []
    for dtype, n in ((F32, N2), (torch.float64, 255)):
        u, b = packed(n, 30 + n, dtype)
        for ro in (True, False):
            for sigma in (0.0, SIGMA):
                calls.append((
                    f"packed2d norm {dtype} n={n} red_only={ro} "
                    f"sigma={sigma}",
                    lambda u=u, b=b, n=n, ro=ro, s=sigma: kept_call(
                        lambda: packed2d.residual_norm_sq(
                            u, b, n, 1.0 / (n + 1), red_only=ro, sigma=s),
                        (u, b))))
    for dtype, n, ranks, rank in ((F32, N2, (1, 0), (0, 0)),
                                  (F32, N2, (8, 0), (3, 0)),
                                  (F32, 2047, (2, 2), (1, 1)),
                                  (torch.float64, 255, (2, 0), (1, 0)),
                                  (torch.float64, 255, (2, 2), (1, 1))):
        (u, b), (m, mcol, ro_, co) = tile(n, dtype, ranks, rank, n + 40)
        for ro in (True, False):
            for sigma in (0.0, SIGMA):
                calls.append((
                    f"plocal2d norm {dtype} n={n} rank {rank} of {ranks} "
                    f"red_only={ro} sigma={sigma}",
                    lambda u=u, b=b, n=n, m=m, mcol=mcol, ro_=ro_, co=co,
                    ro=ro, s=sigma: kept_call(
                        lambda: plocal2d.residual_norm_sq(
                            u, b, n, 1.0 / (n + 1), m, ro_, co, mcol=mcol,
                            red_only=ro, sigma=s), (u, b))))
    for dtype in (F32, torch.float64):
        a, xt = bench_bell(dtype)
        xn = xt.clone()
        xn[0, 5] = float("nan")
        xn[127, 100] = float("inf")
        xn[3, 127] = -float("inf")
        for m in (128, 8):
            for x, what in ((xt, ""), (xn, " NaN and Inf")):
                xm = x[:m].contiguous()
                calls.append((f"bell {dtype} bench m={m}{what}",
                              lambda a=a, xm=xm: kept_call(
                                  lambda: bell.spmm(a, xm), (xm,))))
    import numpy as np
    import scipy.sparse as sp

    rng = np.random.default_rng(17)
    dense = np.zeros((4 * 128, 3 * 128))
    for i, j in zip(*np.nonzero(rng.random((4, 3)) < 0.6)):
        dense[i * 128:(i + 1) * 128, j * 128:(j + 1) * 128] = \
            rng.standard_normal((128, 128))
    a = bell.bell_from_scipy(sp.csr_matrix(dense), dtype=torch.float64,
                             kmax=3, device="cuda")
    xt = torch.from_numpy(rng.standard_normal((16, 3 * 128))).cuda()
    calls.append(("bell float64 4x3 blocks m=16",
                  lambda: kept_call(lambda: bell.spmm(a, xt), (xt,))))
    return calls


def stencil_calls() -> list:
    """(label, make) of the float32 and float64 stencil2d and local2d
    residuals and sweeps and DIA SpMVs held bit for bit (step 2)."""
    from multigridcmt_tpu_torch.kernels import spmv, stencil2d
    from multigridcmt_tpu_torch.ops import sparse

    calls = []
    for dtype, n, modes in ((F32, 2047, (("residual", 0), ("rbgs", 1),
                                         ("rbgs", 4))),
                            (F32, 1023, (("jacobi", 8),)),
                            (torch.float64, 255, (("residual", 0),
                                                  ("rbgs", 4),
                                                  ("jacobi", 8)))):
        u, b = grid(n, dtype, 40 + n)
        h = 1.0 / (n + 1)
        for mode, nu in modes:
            for sigma in (0.0, SIGMA):
                if mode == "residual":
                    run = (lambda u=u, b=b, n=n, h=h, s=sigma:
                           stencil2d.residual(u, b, n, h, sigma=s))
                elif mode == "rbgs":
                    run = (lambda u=u, b=b, n=n, h=h, s=sigma, nu=nu:
                           stencil2d.rbgs_sweep(u, b, n, h, sigma=s,
                                                sweeps=nu))
                else:
                    run = (lambda u=u, b=b, n=n, h=h, s=sigma, nu=nu:
                           stencil2d.jacobi_sweep(u, b, n, h, OMEGA2,
                                                  sigma=s, sweeps=nu))
                calls.append((f"stencil2d {mode} {dtype} n={n} nu={nu} "
                              f"sigma={sigma}",
                              lambda run=run, u=u, b=b: Replay(run, (u, b))))
    for dtype, n, ranks, rank in ((F32, N2, (1, 0), (0, 0)),
                                  (F32, 2047, (2, 2), (1, 1)),
                                  (torch.float64, 255, (2, 0), (1, 0))):
        (u, b), (_, _, ro, co) = ext_tiles(n, dtype, ranks, rank, n + 50)
        h = 1.0 / (n + 1)
        for sigma in (0.0, SIGMA):
            for label, run in (
                    ("residual", lambda u=u, b=b, n=n, h=h, ro=ro, co=co,
                     s=sigma: local2d.residual(u, b, n, h, ro, co,
                                               sigma=s)),
                    ("rbgs nu=4", lambda u=u, b=b, n=n, h=h, ro=ro, co=co,
                     s=sigma: local2d.rbgs_sweep(u, b, n, h, ro, co,
                                                 sigma=s, sweeps=4)),
                    ("jacobi nu=8", lambda u=u, b=b, n=n, h=h, ro=ro, co=co,
                     s=sigma: local2d.jacobi_sweep(u, b, n, h, OMEGA2, ro,
                                                   co, sigma=s, sweeps=8))):
                calls.append((f"local2d {label} {dtype} n={n} rank {rank} "
                              f"of {ranks} sigma={sigma}",
                              lambda run=run, u=u, b=b: Replay(run, (u, b))))
    for dtype, n, ndim in ((F32, N2, 2), (torch.float64, 255, 3)):
        pk = spmv.pack_dia(sparse.laplacian_dia(n, ndim, 1.0 / (n + 1),
                                                dtype, device="cuda"))
        gen = torch.Generator(device="cuda").manual_seed(n + ndim)
        x = spmv.pack_x(torch.randn(pk.n, generator=gen, device="cuda",
                                    dtype=dtype), pk.halo)
        calls.append((f"spmv {dtype} {ndim}D n={n}",
                      lambda pk=pk, x=x: Replay(
                          lambda: spmv.spmv_packed(pk, x), (pk.diags, x))))
    return calls


def leg_calls() -> list:
    """(label, make) of the float32 and float64 row-streaming legs held bit
    for bit (step 2): fused2d's legs, the residual restriction, the packed
    legs."""
    from multigridcmt_tpu_torch.kernels import fused2d, transfer2d

    calls = []
    for dtype, n in ((F32, 2047), (torch.float64, 255)):
        u, b = grid(n, dtype, 60 + n)
        e = grid((n - 1) // 2, dtype, 61 + n)[0]
        h, nc = 1.0 / (n + 1), (n - 1) // 2
        for kind, nu, sigma in (("rbgs", 2, 0.0), ("jacobi", 3, SIGMA)):
            kw = dict(kind=kind, omega=1.0 if kind == "rbgs" else OMEGA2,
                      sweeps=nu, sigma=sigma)
            calls.append((
                f"fused2d down {dtype} n={n} {kind} nu={nu} sigma={sigma}",
                lambda u=u, b=b, n=n, h=h, kw=kw: Replay(
                    lambda: fused2d.smooth_residual_restrict(u, b, n, h,
                                                             **kw),
                    (u, b))))
            calls.append((
                f"fused2d up {dtype} n={n} {kind} nu={nu} sigma={sigma}",
                lambda u=u, b=b, e=e, n=n, nc=nc, h=h, kw=kw: Replay(
                    lambda: fused2d.prolong_add_smooth(u, e, b, n, nc, h,
                                                       **kw), (u, e, b))))
        calls.append((f"transfer2d residual_restrict {dtype} n={n}",
                       lambda u=u, b=b, n=n, h=h: Replay(
                           lambda: transfer2d.residual_restrict(u, b, n, h),
                           (u, b))))
    pu, pb = packed(N2, 62, F32)
    e = grid((N2 - 1) // 2, F32, 63)[0]
    h = 1.0 / (N2 + 1)
    calls.append(("packed2d down float32 n=4095 rbgs nu=2",
                  lambda: Replay(lambda: packed2d.smooth_residual_restrict(
                      pu, pb, N2, h, kind="rbgs", omega=1.0, sweeps=2),
                      (pu, pb))))
    calls.append(("packed2d up float32 n=4095 rbgs nu=2",
                  lambda: Replay(lambda: packed2d.prolong_add_smooth(
                      pu, e, pb, N2, (N2 - 1) // 2, h, kind="rbgs",
                      omega=1.0, sweeps=2), (pu, e, pb))))
    return calls


def check_bits(libs: dict) -> tuple:
    """(comparisons, failures): every bfloat16 case, every float32 and
    float64 case of float_calls, stencil_calls and leg_calls, and
    bf16_legs' bfloat16 storage modes of the row-streaming legs, in each
    library against this one."""
    u, b = cube(20)
    calls = []
    for sigma in (0.0, SIGMA):
        for out in (None, F32):
            calls.append((f"rbgs n={N3} sigma={sigma} out={out}",
                          lambda s=sigma, o=out: sweep_call(u, b, s, o)))
    for goff, roff, p, r in STACKS:
        su, sb = (g[goff:goff + p].contiguous() for g in (u, b))
        for out in (None, F32):
            calls.append((f"rbgs stack goff={goff} roff={roff} out={out}",
                          lambda su=su, sb=sb, o=out, g=goff, r_=roff:
                          sweep_call(su, sb, SIGMA, o, g, r_)))
    jstacks = [(stack, *(cut(g, *stack) for g in (u, b)))
               for stack in JACOBI_STACKS]
    for sigma in (0.0, SIGMA):
        calls.append((f"jacobi n={N3} sigma={sigma}",
                      lambda s=sigma: jacobi_call(u, b, s, None)))
        for (goff, roff, p, r), su, sb in jstacks:
            calls.append((f"jacobi stack goff={goff} roff={roff} p={p} "
                          f"r={r} sigma={sigma}",
                          lambda su=su, sb=sb, s=sigma, g=goff, r_=roff:
                          jacobi_call(su, sb, s, None, g, r_)))
        # Left on the scalar march: unchanged bits.
        calls.append((f"jacobi n={N3} sigma={sigma} out=float32",
                      lambda s=sigma: jacobi_call(u, b, s, F32)))
        calls.append((f"stencil3d residual n={N3} sigma={sigma}",
                      lambda s=sigma: stencil3d_residual_call(u, b, s)))
    for n in RESIDUAL_NS:
        pu, pb = packed(n, n)
        for sigma in (0.0, SIGMA):
            calls.append((f"residual n={n} sigma={sigma}",
                          lambda pu=pu, pb=pb, n=n, s=sigma:
                          residual_call(pu, pb, n, s)))
    calls += float_calls() + stencil_calls() + leg_calls()
    checks, fails = 0, []
    for what, make in calls:
        call = make()
        ref = call.replay(libs["this"])
        for label, lib in libs.items():
            if label == "this":
                continue
            checks += 1
            got = call.with_args(lib).replay(lib)
            if not all(torch.equal(bits(x), bits(y))
                       for x, y in zip(ref, got)):
                fails.append(f"bits {what}: {label} differs from this")
        del call
    torch.cuda.synchronize()
    whole, utile, ptile = bf16_legs.inputs()
    legs_checks, legs_fails = bf16_legs.check_bits(
        libs, {"packed2d": whole, "local2d": utile, "plocal2d": ptile})
    return checks + legs_checks, fails + legs_fails


def timed(libs: dict, first: str) -> dict:
    """The bfloat16 modes in turns in every library beside their float32
    twins; the main path's float32 kernels in this and the first OTHER's."""
    u, b = cube(21)
    fu, fb = u.float(), b.float()
    jacobi = {"": (u, b, fu, fb, {})}
    for (goff, roff, p, r), where in zip(JACOBI_STACKS, ("slab", "pencil")):
        su, sb = (cut(g, goff, roff, p, r) for g in (u, b))
        jacobi[" " + where] = (su, sb, su.float(), sb.float(),
                               dict(goff=goff, roff=roff))
    pu, pb = packed(N2, 22)
    fpu, fpb = pu.float(), pb.float()
    (tu, tb), (tm, _, t_off, _) = tile(N2, F32, (1, 0), (0, 0), 24)
    ab, xt = bench_bell(F32)
    h3, h2 = 1.0 / (N3 + 1), 1.0 / (N2 + 1)
    modes = {
        "stencil3d_rbgs_bf16": (sweep_call(u, b, 0.0, None),
                                lambda: stencil3d.rbgs_sweep(fu, fb, N3, h3),
                                (fu, fb)),
        "stencil3d_rbgs_bf16_f32": (sweep_call(u, b, 0.0, F32),
                                    lambda: stencil3d.rbgs_sweep(fu, fb, N3,
                                                                 h3),
                                    (fu, fb)),
        "packed2d_residual_bf16": (residual_call(pu, pb, N2, 0.0),
                                   lambda: packed2d.residual(fpu, fpb, N2,
                                                             h2),
                                   (fpu, fpb)),
    }
    for where, (ju, jb, jfu, jfb, off) in jacobi.items():
        modes["stencil3d_jacobi_bf16" + where] = (
            jacobi_call(ju, jb, 0.0, None, **off),
            lambda jfu=jfu, jfb=jfb, off=off: stencil3d.jacobi_sweep(
                jfu, jfb, N3, h3, OMEGA, **off), (jfu, jfb))
    times = {}
    for name, (call, twin, tin) in modes.items():
        fns = {label: call.with_args(lib).fn(lib)
               for label, lib in libs.items()}
        fns["f32 twin"] = Call(twin, tin).fn(libs["this"])
        row = in_turns(fns)
        row["bound_ms"] = call.nbytes / PEAK_BYTES_PER_S * 1e3
        times[name] = row
        log(f"time {name}: {fmt(row)}; bound {row['bound_ms']:.4f}")
    main = {
        "stencil3d_rbgs_f32": Call(lambda: stencil3d.rbgs_sweep(
            fu, fb, N3, h3), (fu, fb)),
        "stencil3d_residual_f32": Call(lambda: stencil3d.residual(
            fu, fb, N3, h3), (fu, fb)),
        "packed2d_residual_f32": Call(lambda: packed2d.residual(
            fpu, fpb, N2, h2), (fpu, fpb)),
        "packed2d_resnorm_f32": kept_call(lambda: packed2d.residual_norm_sq(
            fpu, fpb, N2, h2, red_only=True), (fpu, fpb)),
        "plocal2d_resnorm_f32": kept_call(lambda: plocal2d.residual_norm_sq(
            tu, tb, N2, h2, tm, t_off, red_only=True), (tu, tb)),
        "bell_spmm_f32": kept_call(lambda: bell.spmm(ab, xt), (xt,)),
    }
    for name, call in main.items():
        row = in_turns({label: call.fn(libs[label])
                        for label in ("this", first)})
        times[name] = row
        log(f"time {name}: {fmt(row)}")
    return times


def on_library(lib, fn):
    """fn, its launches going to lib; the scalar Jacobi march where lib has
    no paired one (its own wrapper's choice)."""
    def run():
        saved = _build.load_library, stencil3d.jacobi_pairs
        _build.load_library = lambda: lib
        if not lib._jacobi_pairs:
            stencil3d.jacobi_pairs = lambda *_: False
        try:
            return fn()
        finally:
            _build.load_library, stencil3d.jacobi_pairs = saved
    return run


def cycles(libs: dict) -> dict:
    """The mixed Jacobi paths' preconditioning cycle at 511^3 on each
    library in turns, beside the float32 cycle (step 4)."""
    import multigridcmt_tpu_torch as mt
    from multigridcmt_tpu_torch.parallel import sharded
    from multigridcmt_tpu_torch.utils.breakdown import world_of_one

    prob = mt.poisson3d(k=9, dtype=F32, smoother="jacobi", use_kernels=True,
                        device="cuda", precond_dtype=BF)
    cfg = prob.config
    groups = {"jacobi_ms": JACOBI_KERNELS}
    out = {}
    for label, kind in (("slab", "rows"), ("pencil", "block")):
        with world_of_one(kind) as mesh:
            solver = sharded.ShardedSolver(cfg, mesh)
            pd = sharded.mixed_slab_dtype(cfg, solver.decomp)
            if pd != BF:
                raise RuntimeError(f"mixed Jacobi {label}: the cast is {pd}")
            bt = sharded.shard_rhs(prob.b, solver.mesh, solver.decomp)

            def cycle(rp, odt):
                return sharded._sharded_v_cycle(
                    solver.hierarchy, cfg, solver.decomp,
                    torch.zeros_like(rp), rp, 0, 1, out_dtype=odt)

            fns = {f"bfloat16 {lib_label}": on_library(
                lib, lambda rp=bt.to(BF): cycle(rp, F32))
                for lib_label, lib in libs.items()}
            fns["float32 this"] = on_library(
                libs["this"], lambda rp=bt.to(F32): cycle(rp, None))
            row = {}
            order = list(fns)
            for key in order + order[::-1]:
                busy, ops, by = device_busy(fns[key], 3, groups)
                row.setdefault(key, []).append({
                    "chained_ms": chained_ms(fns[key], CYCLE_CHAIN),
                    "busy_ms": busy, "ops": ops, **by})
            out[label] = row
            log(f"cycle {label}: " + json.dumps(row))
            del solver, bt, fns
    return out


def trace_effect(libs: dict) -> dict:
    """The paired Jacobi sweep's device time a call before and after one
    profiling.trace window, beside its chained time (step 5)."""
    from multigridcmt_tpu_torch.utils.profiling import trace

    u, b = cube(23)
    fn = jacobi_call(u, b, 0.0, None).fn(libs["this"])
    out = {"chained_ms": chained_ms(fn, LEG_CHAIN),
           "before_ms": device_busy(fn, LEG_CHAIN)[0]}
    with tempfile.TemporaryDirectory() as tmp, trace(tmp):
        for _ in range(LEG_CHAIN):
            fn()
    out["after_ms"] = device_busy(fn, LEG_CHAIN)[0]
    out["chained_after_ms"] = chained_ms(fn, LEG_CHAIN)
    log("profiler after a trace: " + json.dumps(out))
    return out


# The native legs' levels (the k=11 bfloat16 solve's fused levels) and
# the parent chain's C argument types (csrc/native_bf16.cu before the row
# stream: the restriction took sigma and a shift flag, the prolongation-add
# an order flag).
NATIVE_NS = (2047, 1023, 511, 255)
_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
CHAIN_TYPES = {"mg_native2d_residual_restrict_bf16": [_P, _P, _P, _I, _D, _D,
                                                      _I, _P],
               "mg_native2d_prolong_add_bf16": [_P, _P, _P, _I, _I, _P]}


def chain_leg(lib, leg, x, e, b, n, c, kind, sweeps):
    """(fn, outputs) of the native leg as the parent's wrapper launched it
    in ``lib`` (its own chain of native_bf16.cu entry points): the down
    leg's sweeps into u' (u itself at 0 sweeps), then the restriction with
    sig u; the up leg's prolongation-add by rows first, then its sweeps."""
    from multigridcmt_tpu_torch.kernels import _build as build

    fns = {}
    for name in ("mg_native2d_sweep_bf16", *CHAIN_TYPES):
        f = getattr(lib, name)
        f.argtypes = CHAIN_TYPES.get(name, build.SIGNATURES[name])
        f.restype = ctypes.c_int
        fns[name] = f
    stream = torch.cuda.current_stream().cuda_stream
    out, tmp, mid = (torch.empty_like(x) for _ in range(3))
    nc = (n - 1) // 2
    rc = torch.empty((nc + 2, nc + 2), dtype=BF, device=x.device)
    code = build.KIND_CODES[kind]

    def sweep(src):
        return fns["mg_native2d_sweep_bf16"](
            src.data_ptr(), b.data_ptr(), out.data_ptr(), tmp.data_ptr(),
            n + 2, n + 2, n, 0, 0, *c, code, sweeps, stream)

    if leg == "down":
        def run():
            status = sweep(x) if sweeps else 0
            return status or fns["mg_native2d_residual_restrict_bf16"](
                (out if sweeps else x).data_ptr(), b.data_ptr(),
                rc.data_ptr(), n, c.inv_h2, c.sig, 1, stream)
        return run, ((out if sweeps else x), rc)

    def run():
        status = fns["mg_native2d_prolong_add_bf16"](
            x.data_ptr(), e.data_ptr(), mid.data_ptr(), n, 1, stream)
        return status or (sweep(mid) if sweeps else 0)
    return run, ((out if sweeps else mid),)


def native_grids(n: int, seed: int):
    """bfloat16 u (or x), b (of 1/h^2 size) and the coarse e."""
    u, b = grid(n, F32, seed)
    e = grid((n - 1) // 2, F32, seed + 1)[0]
    return u.to(BF), b.to(BF), e.to(BF)


def native_legs(libs: dict, first: str) -> tuple:
    """(times, comparisons, failures) of step 6."""
    from multigridcmt_tpu_torch.kernels import fused2d, native_bf16
    from multigridcmt_tpu_torch.utils.profiling import cuda_time_ms

    other = libs[first]
    has_chain = hasattr(other, "mg_native2d_residual_restrict_bf16") and \
        not hasattr(other, "mg_fused2d_down_native_bf16")
    times, checks, fails = {}, 0, []
    for n in NATIVE_NS:
        u, b, e = native_grids(n, 70 + n)
        h, nc = 1.0 / (n + 1), (n - 1) // 2
        for leg in ("down", "up"):
            for kind, nu, sigma in (("rbgs", 2, 0.0), ("jacobi", 2, SIGMA),
                                    ("rbgs", 0, SIGMA)):
                omega = 1.0 if kind == "rbgs" else OMEGA2
                kw = dict(kind=kind, omega=omega, sweeps=nu, sigma=sigma)
                if leg == "down":
                    call = Replay(lambda: fused2d.smooth_residual_restrict(
                        u, b, n, h, **kw), (u, b))
                else:
                    call = Replay(lambda: fused2d.prolong_add_smooth(
                        u, e, b, n, nc, h, **kw), (u, e, b))
                mine = call.replay(libs["this"])
                label = f"native {leg} n={n} {kind} nu={nu} sigma={sigma}"
                if has_chain:
                    c = native_bf16.constants(h, sigma, omega)
                    run, outs = chain_leg(other, leg, u, e, b, n, c, kind,
                                          nu)
                    if run():
                        raise RuntimeError(f"{label}: the chain failed")
                    checks += 1
                    if not all(torch.equal(bits(x), bits(y))
                               for x, y in zip(mine, outs)):
                        fails.append(f"bits {label}: the stream differs "
                                     f"from {first}'s chain")
                if (kind, nu, sigma) != ("rbgs", 2, 0.0):
                    continue
                fns = {"stream": call.fn(libs["this"])}
                if has_chain:
                    fns[f"{first} chain"] = run
                row = in_turns(fns)
                for key, fn in list(fns.items()) + list(fns.items())[::-1]:
                    row.setdefault(f"{key} single", []).append(
                        cuda_time_ms(fn))
                row["bound_ms"] = call.nbytes / PEAK_BYTES_PER_S * 1e3
                times[f"{leg}@{n}"] = row
                log(f"time native {leg} n={n}: {fmt(row)}; single "
                    + ", ".join(f"{k} {v}" for k, v in row.items()
                                if k.endswith("single"))
                    + f"; bound {row['bound_ms']:.4f}")
        del u, b, e
    torch.cuda.synchronize()
    return times, checks, fails


def fmt(row: dict) -> str:
    return ", ".join(f"{k} " + "/".join(f"{c:.4f}c {d:.4f}d" for c, d in v)
                     for k, v in row.items()
                     if k != "bound_ms" and not k.endswith("single"))


# Step 7: the C argument types of the first OTHER's native RB-GS sweeps and
# residual restriction when it launches them from csrc/native_bf16.cu (the
# tree before the row stream took them): u, b, out, tmp, R, C, n, row_off,
# col_off, the five constants, kind, sweeps, stream; u, b, rc, n, inv_h2,
# stream.
OLD_SWEEP_TYPES = [_P] * 4 + [_I] * 5 + [_D] * 5 + [_I, _I, _P]
OLD_RESTRICT_TYPES = [_P, _P, _P, _I, _D, _P]
# The native sweeps' counts held bit for bit, and those timed.
NATIVE_SWEEP_NUS = (1, 2, 3, 4)
NATIVE_SWEEP_TIMED = (4, 1)


def old_native(lib, what, u, b, n, c, sweeps=0):
    """(fn, output) of the native RB-GS sweeps (``what`` "sweep") or the
    residual restriction ("restrict") as the tree before the row stream
    launched them in ``lib``: native_bf16.cu's launch a colour a sweep, in
    place on out after the first, and its thread a coarse point."""
    stream = torch.cuda.current_stream().cuda_stream
    if what == "sweep":
        f = lib.mg_native2d_sweep_bf16
        f.argtypes, f.restype = OLD_SWEEP_TYPES, ctypes.c_int
        out = torch.empty_like(u)
        return (lambda: f(u.data_ptr(), b.data_ptr(), out.data_ptr(),
                          out.data_ptr(), n + 2, n + 2, n, 0, 0, *c,
                          _build.KIND_CODES["rbgs"], sweeps, stream)), out
    f = lib.mg_native2d_residual_restrict_bf16
    f.argtypes, f.restype = OLD_RESTRICT_TYPES, ctypes.c_int
    nc = (n - 1) // 2
    rc = torch.empty((nc + 2, nc + 2), dtype=BF, device=u.device)
    return (lambda: f(u.data_ptr(), b.data_ptr(), rc.data_ptr(), n,
                      c.inv_h2, stream)), rc


def native_streams(libs: dict, first: str) -> tuple:
    """(times, comparisons, failures) of step 7: this tree's native RB-GS
    sweep stream and residual-restriction stream (through the wrappers)
    against the first OTHER's launches of native_bf16.cu, where it still
    has them, at NATIVE_NS: bit for bit at every nu of NATIVE_SWEEP_NUS and
    sigma 0 and 11.5 (the restriction has no sigma), then in turns at sigma
    0 (the sweeps at NATIVE_SWEEP_TIMED): single, chained and device time,
    beside the bound (inputs read once, outputs written once)."""
    from multigridcmt_tpu_torch.kernels import (native_bf16, stencil2d,
                                               transfer2d)
    from multigridcmt_tpu_torch.utils.profiling import cuda_time_ms

    other = libs[first]
    has_old = not hasattr(other, "mg_stencil2d_sweep_native_bf16")
    times, checks, fails = {}, 0, []
    for n in NATIVE_NS:
        u, b, _ = native_grids(n, 90 + n)
        h = 1.0 / (n + 1)
        cases = [("sweep", nu, sigma) for nu in NATIVE_SWEEP_NUS
                 for sigma in (0.0, SIGMA)] + [("restrict", 0, 0.0)]
        for what, nu, sigma in cases:
            c = native_bf16.constants(h, sigma)
            if what == "sweep":
                call = Replay(lambda: stencil2d.rbgs_sweep(
                    u, b, n, h, sigma=sigma, sweeps=nu), (u, b))
            else:
                call = Replay(lambda: transfer2d.residual_restrict(
                    u, b, n, h), (u, b))
            mine, = call.replay(libs["this"])
            label = f"native {what} n={n} nu={nu} sigma={sigma}"
            if has_old:
                run, out = old_native(other, what, u, b, n, c, nu)
                if run():
                    raise RuntimeError(f"{label}: {first}'s launch failed")
                checks += 1
                if not torch.equal(bits(mine), bits(out)):
                    fails.append(f"bits {label}: the stream differs from "
                                 f"{first}'s native_bf16.cu launches")
            if sigma or (what == "sweep" and nu not in NATIVE_SWEEP_TIMED):
                continue
            fns = {"stream": call.fn(libs["this"])}
            if has_old:
                fns[f"{first} native_bf16.cu"] = run
            row = in_turns(fns)
            for key, fn in list(fns.items()) + list(fns.items())[::-1]:
                row.setdefault(f"{key} single", []).append(cuda_time_ms(fn))
            row["bound_ms"] = call.nbytes / PEAK_BYTES_PER_S * 1e3
            key = f"{what}@{n}" + (f" nu={nu}" if what == "sweep" else "")
            times[key] = row
            log(f"time native {key}: {fmt(row)}; single "
                + ", ".join(f"{k} {v}" for k, v in row.items()
                            if k.endswith("single"))
                + f"; bound {row['bound_ms']:.4f}")
        del u, b
    torch.cuda.synchronize()
    return times, checks, fails


# Step 8: the C argument types of the first OTHER's native prolongation-add
# when it launches it from csrc/native_bf16.cu (a thread a fine point): x,
# e, out, n, stream; its Jacobi sweeps of a whole grid take OLD_SWEEP_TYPES
# (a launch a sweep through a scratch grid).
OLD_PROLONG_TYPES = [_P, _P, _P, _I, _P]
# The native Jacobi sweeps' counts held bit for bit, and those timed
# (bf16_jacobi88's down leg: 8).
NATIVE_JACOBI_NUS = tuple(range(1, 9))
NATIVE_JACOBI_TIMED = (8, 1)


def old_jacobi_prolong(lib, what, u, b, e, n, c, sweeps=0):
    """(fn, output) of the native Jacobi sweeps of a whole grid (``what``
    "jacobi") or the prolongation-add ("prolong", x = u) as the tree before
    this one's kernels launched them in ``lib``: native_bf16.cu's launch a
    sweep (u' and a scratch grid in turns) and its thread a fine point."""
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty_like(u)
    if what == "jacobi":
        f = lib.mg_native2d_sweep_bf16
        f.argtypes, f.restype = OLD_SWEEP_TYPES, ctypes.c_int
        tmp = torch.empty_like(u)
        return (lambda: f(u.data_ptr(), b.data_ptr(), out.data_ptr(),
                          tmp.data_ptr(), n + 2, n + 2, n, 0, 0, *c,
                          _build.KIND_CODES["jacobi"], sweeps, stream)), out
    f = lib.mg_native2d_prolong_add_bf16
    f.argtypes, f.restype = OLD_PROLONG_TYPES, ctypes.c_int
    return (lambda: f(u.data_ptr(), e.data_ptr(), out.data_ptr(), n,
                      stream)), out


def native_jacobi_prolong(libs: dict, first: str) -> tuple:
    """(times, comparisons, failures) of step 8: this tree's native Jacobi
    sweep stream and prolongation-add block kernel (through the wrappers)
    against the first OTHER's launches of native_bf16.cu, where it still
    has them, at NATIVE_NS: bit for bit (the Jacobi sweeps at every nu of
    NATIVE_JACOBI_NUS, sigma 0 and 11.5; the prolongation-add once), then
    in turns at sigma 0 (the sweeps at NATIVE_JACOBI_TIMED; the
    prolongation-add, and its yardstick
    x + F.interpolate(e, bilinear, aligned corners) in bfloat16, not
    bit-equal: its relative difference logged): single, chained and device
    time, beside the bound (inputs read once, outputs written once)."""
    import torch.nn.functional as F

    from multigridcmt_tpu_torch.kernels import (native_bf16, stencil2d,
                                               transfer2d)
    from multigridcmt_tpu_torch.utils.profiling import cuda_time_ms

    other = libs[first]
    has_old = hasattr(other, "mg_native2d_prolong_add_bf16")
    times, checks, fails = {}, 0, []
    for n in NATIVE_NS:
        u, b, e = native_grids(n, 110 + n)
        h, nc = 1.0 / (n + 1), (n - 1) // 2
        cases = [("jacobi", nu, sigma) for nu in NATIVE_JACOBI_NUS
                 for sigma in (0.0, SIGMA)] + [("prolong", 0, 0.0)]
        for what, nu, sigma in cases:
            c = native_bf16.constants(h, sigma, OMEGA2)
            if what == "jacobi":
                call = Replay(lambda: stencil2d.jacobi_sweep(
                    u, b, n, h, OMEGA2, sigma=sigma, sweeps=nu), (u, b))
            else:
                call = Replay(lambda: transfer2d.prolong_add(u, e, n, nc),
                              (u, e))
            mine, = call.replay(libs["this"])
            label = f"native {what} n={n} nu={nu} sigma={sigma}"
            fns = {"this": call.fn(libs["this"])}
            if has_old:
                run, out = old_jacobi_prolong(other, what, u, b, e, n, c, nu)
                if run():
                    raise RuntimeError(f"{label}: {first}'s launch failed")
                checks += 1
                if not torch.equal(bits(mine), bits(out)):
                    fails.append(f"bits {label}: this tree's kernel differs "
                                 f"from {first}'s native_bf16.cu launches")
                fns[f"{first} native_bf16.cu"] = run
            if sigma or (what == "jacobi" and nu not in NATIVE_JACOBI_TIMED):
                continue
            if what == "prolong":
                def lib():
                    return u + F.interpolate(
                        e[None, None], size=(n + 2, n + 2), mode="bilinear",
                        align_corners=True)[0, 0]

                got = lib()
                fin = mine.isfinite() & got.isfinite()
                rel = float((got.float() - mine.float())[fin].abs().max()
                            / mine.float()[fin].abs().max())
                fns["F.interpolate"] = lib
            row = in_turns(fns)
            for key, fn in list(fns.items()) + list(fns.items())[::-1]:
                row.setdefault(f"{key} single", []).append(cuda_time_ms(fn))
            row["bound_ms"] = call.nbytes / PEAK_BYTES_PER_S * 1e3
            key = f"{what}@{n}" + (f" nu={nu}" if what == "jacobi" else "")
            log(f"time native {key}: {fmt(row)}; single "
                + ", ".join(f"{k} {v}" for k, v in row.items()
                            if k.endswith("single"))
                + f"; bound {row['bound_ms']:.4f}"
                + (f"; F.interpolate relative difference {rel:.1e}"
                   if what == "prolong" else ""))
            if what == "prolong":
                row["library_rel_diff"] = rel
            times[key] = row
        del u, b, e
    torch.cuda.synchronize()
    return times, checks, fails


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", nargs="+", type=Path)
    ap.add_argument("--json", type=Path)
    ap.add_argument("--steps", default="2,3,4,5,6,7,8",
                    help="the steps after the ptxas comparison to run, "
                         "comma-separated (default all)")
    opt = ap.parse_args()
    steps = {int(v) for v in opt.steps.split(",") if v}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    log(smi)
    report = {"card": smi, "fails": []}
    root = Path(__file__).resolve().parents[2]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        labels = [p.name for p in opt.others]
        roots = dict([("this", root), *zip(labels, opt.others)])
        libs, texts = {}, {}
        # A tree at a time: every source of two trees at once would start
        # some ninety nvcc processes.
        for label, r in roots.items():
            procs = start_build(r, Path(tmp) / label, False, tree_sources(r))
            libs[label], texts[label] = finish_build(procs,
                                                     Path(tmp) / label)
            march_flavour(libs[label], texts[label])
        log(f"built this tree and {', '.join(labels)} in "
            f"{time.perf_counter() - t0:.1f} s")
        # The port's wrappers launch into this tree's library.
        _build.load_library = lambda: libs["this"]
        for lib in libs.values():
            lib.mg_error_string.argtypes = [ctypes.c_int]
            lib.mg_error_string.restype = ctypes.c_char_p

        fails, bf16_lines = compare_ptxas(
            texts["this"], {k: v for k, v in texts.items() if k != "this"},
            labels[0])
        report["fails"] += fails
        report["ptxas_bf16"] = dict(sorted(bf16_lines.items()))
        for k, v in sorted(bf16_lines.items()):
            log(f"ptxas bf16 {k[:90]}: {v}")

        if 2 in steps:
            checks, fails = check_bits(libs)
            report["fails"] += fails
            log(f"bits: {checks} comparisons, {len(fails)} differ")
        if 6 in steps:
            report["native_legs"], checks, fails = native_legs(libs,
                                                               labels[0])
            report["fails"] += fails
            log(f"native legs: {checks} comparisons with {labels[0]}'s "
                f"chain, {len(fails)} differ")
        if 7 in steps:
            report["native_streams"], checks, fails = native_streams(
                libs, labels[0])
            report["fails"] += fails
            log(f"native sweeps and restriction: {checks} comparisons with "
                f"{labels[0]}'s native_bf16.cu launches, {len(fails)} "
                "differ")
        if 8 in steps:
            report["native_jacobi_prolong"], checks, fails = \
                native_jacobi_prolong(libs, labels[0])
            report["fails"] += fails
            log(f"native Jacobi sweeps and prolongation-add: {checks} "
                f"comparisons (with {labels[0]}'s native_bf16.cu "
                f"launches), {len(fails)} differ")
        if 3 in steps:
            report["times"] = timed(libs, labels[0])
        if 4 in steps:
            report["cycles"] = cycles(libs)
        if 5 in steps:
            report["trace_effect"] = trace_effect(libs)
    for f in report["fails"]:
        log(f"FAIL {f}")
    line = json.dumps(report)
    if opt.json:
        opt.json.parent.mkdir(parents=True, exist_ok=True)
        opt.json.write_text(line)
    print(line)
    return 1 if report["fails"] else 0


if __name__ == "__main__":
    sys.exit(main())
