"""3D 7-point kernels: the residual, weighted-Jacobi and RB-GS sweeps.

Replaces the three modes of the TPU kernel in
``multigridcmt_tpu/kernels/stencil3d.py`` (one ``pallas_call``) with
``csrc/stencil3d.cu``:
  * ``residual``: r = b - (A - sigma I) u, one launch;
  * ``jacobi_sweep``: weighted Jacobi, one launch a sweep;
  * ``rbgs_sweep``: one full red-then-black Gauss-Seidel sweep a launch,
    in one pass like the TPU kernel's two-colour pipeline: it reads u and
    b once and writes the output once, with no scratch grid;
    ``rbgs_launches`` counts one a sweep.

What bounds them on the card is device-memory traffic (12 bytes a point
in float32, for ~10-16 flops). The design (the note in the source) is a
z-march by warps: each warp owns a strip of columns by a band of rows and
marches along z over a chunk of planes, keeping its rows of the planes it
needs in registers and issuing each plane's loads a step ahead; x
neighbours are warp shuffles, so no shared memory and no barrier. The
RB-GS warp red-updates plane z + 1 and black-updates plane z at each step,
recomputing the red values on a one-point ring and on the planes just
past its chunk from the original u, so no warp needs another's output.
``march_geometry`` computes the strips, bands and chunks the kernel takes.

Grids: a stack of p planes of r x c points with c = n + 2 and p, r >= 3:
the logical padded (n+2)^3 grid of a level, or a slab or pencil stack
whose plane 0 is global plane ``goff`` and row 0 global row ``roff``, as
in the TPU kernel. Edge rule, all modes: an output plane is zero unless
it is neither the stack's first nor last and g + goff lies in [1, n]; in
such a plane a point is updated if its global row and column lie in
[1, n] and its row is not the stack's first or last. Elsewhere the
residual is zero and the sweeps keep u. (At a stack's edge rows the TPU
kernel rolls around to the other edge; the port leaves them alone, so a
chained sweep invalidates the edge rows' halo as it does the planes'.)
Red means (g + goff) + (y + roff) + x even.

The TPU module's aligned3 layout and its VMEM budgets (``fits_vmem``,
``_pick_pb``) are Mosaic artefacts with no counterpart on Hopper: every 3D
level at or above ``KERNEL3_MIN_N`` runs these kernels, whatever its size.

Mixed precision (the TPU module's ``_cdt`` rule): u and b may be stored in
bfloat16, the fine level of a mixed 3D cycle (``csrc/stencil3d_bf16.cu``).
Every load widens to float32 and the arithmetic runs in float32; the
residual always stores r in float32 (it feeds the coarse levels); the RB-GS
sweep rounds each red value to bfloat16 before the black stage reads it,
as the TPU kernel's red ring does; each sweep stores its output in
bfloat16, or the last sweep of a call in float32 (``out_dtype``, the
``_wrap.check_out_dtype`` rule). A bfloat16 b beside a wider u (the mixed
cycle's post-smoothing) is widened once, as the TPU module casts b to u's
dtype. The plain versions follow the same rule. The bfloat16 RB-GS sweep
runs on words of two points where the layout pairs them (``rbgs_pairs``:
every whole grid; ``rbgs_bf16_pairs_launches`` counts it), a lane of the
march holding an aligned 32-bit word of each row, and on the scalar march
elsewhere (a stack with goff + roff odd); both give the same bits. So does
the bfloat16 Jacobi sweep storing bfloat16 (``jacobi_pairs``: c odd, which
is every grid and stack of the port, whatever its offsets and rows;
``jacobi_bf16_pairs_launches`` counts it); the Jacobi sweep storing
float32 and the residual stay on the scalar march.

Each wrapper has its plain PyTorch version beside it, in the TPU kernel's
arithmetic order. Device rule (``_wrap``): a CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ._wrap import check_out_dtype, check_tensor, compute_dtype, launch_on, \
    on_cuda

# Launches of each CUDA kernel in this process (plain-version calls do not
# count; an RB-GS sweep counts once); the bfloat16 modes apart, the sweeps'
# float32 stores (out_dtype) apart again.
residual_launches = 0
jacobi_launches = 0
rbgs_launches = 0
residual_bf16_launches = 0
jacobi_bf16_launches = 0
jacobi_bf16_f32_launches = 0
rbgs_bf16_launches = 0
rbgs_bf16_f32_launches = 0
# Of the bfloat16 RB-GS launches (both outputs), those of the paired march
# (rbgs_pairs); of the bfloat16 Jacobi launches storing bfloat16, those of
# the paired Jacobi march (jacobi_pairs).
rbgs_bf16_pairs_launches = 0
jacobi_bf16_pairs_launches = 0

# The z-march (csrc/stencil3d.cuh). A unit is one warp of MARCH_LANES lanes,
# MARCH_WARPS to a block; each lane keeps rings of MARCH_SLOTS planes of its
# column's rows in registers. Rows of a band, by kernel ("rbgs", or "pass":
# the residual and Jacobi) and dtype. These are the kernel source's
# constants (kLanes, kWarps, kSlots, kRbgsRowsF32, ...), held against it by
# the CPU tests; bfloat16 storage computes in float32 registers and takes
# float32's rows. A unit marches over at most MARCH_CHUNK[kernel] planes (the
# chunks are balanced), fewer where that leaves the launch under
# MARCH_MIN_UNITS units: an H100 holds 1584-2112 warps of these kernels at
# once (132 SMs, 3 or 4 blocks of 4 warps at their 120-160 registers). The
# chunks come from utils/march_chunks.py on an H100 (PERF.md): the pass is
# fastest with 8 planes at 511^3 and 255^3. The sweep with 128 takes 103
# planes at 511^3, 2% faster than 32's 31 (64, 256 and 512 lose 4-18%);
# at 255^3 the unit count cuts 128 to 33 planes, 9% slower than 32's 29.
# Over a V-cycle's four sweeps at each level 128 comes out 0.03 ms ahead.
MARCH_LANES = 32
MARCH_WARPS = 4
MARCH_SLOTS = 4
MARCH_ROWS = {("rbgs", torch.float32): 8, ("rbgs", torch.float64): 4,
              ("pass", torch.float32): 8, ("pass", torch.float64): 8,
              ("rbgs", torch.bfloat16): 8, ("pass", torch.bfloat16): 8}
MARCH_CHUNK = {"rbgs": 128, "pass": 8}
MARCH_MIN_UNITS = 2048
# The bfloat16 sweeps' paired marches (rbgs_pairs_kernel,
# jacobi_pairs_kernel): a lane holds an aligned word of two points of each
# row, a strip MARCH_LANES words of which MARCH_PAIR_WORDS are owned (kLanes
# - 2: a word of halo each side), a band MARCH_PAIR_ROWS rows (kPairRows,
# even); chunks of an even number of planes, so that a plane's slot fixes
# its parity.
MARCH_PAIR_WORDS = MARCH_LANES - 2
MARCH_PAIR_ROWS = 4


def march_geometry(kernel: str, p: int, r: int, c: int, dtype,
                   paired: bool = False) -> tuple:
    """The 5 ints of the ``kernel`` ("rbgs", or "pass": the residual and
    Jacobi) march on a (p, r, c) stack of ``dtype``, as the kernel's Geom
    takes them: (strips, bands, chunks, width, chunk).

    Unit (sx, sy, sz), one warp, owns columns [sx * width, (sx + 1) *
    width), rows [sy * rows, (sy + 1) * rows) (rows = MARCH_ROWS[kernel,
    dtype]) and planes [sz * chunk, (sz + 1) * chunk), each clipped to the
    stack; its lanes start a halo of columns before its first (2 for the
    RB-GS sweep, whose red values on a one-point ring need u on a
    two-point one; 1 for the pass). Unit index sx + strips * (sy + bands *
    sz) is warp w of block bx, bx * MARCH_WARPS + w.

    ``paired`` (a bfloat16 sweep where ``rbgs_pairs`` or ``jacobi_pairs``
    holds; "pass" is then the Jacobi sweep's): the paired march's
    geometry. Strip sx owns the words [sx * MARCH_PAIR_WORDS, (sx + 1) *
    MARCH_PAIR_WORDS) of every row (width is their 2 MARCH_PAIR_WORDS
    columns; a row has (c + 1) // 2 words, its first or last one
    straddling into the next row), bands are MARCH_PAIR_ROWS rows and
    chunks an even number of planes.
    """
    if kernel not in ("rbgs", "pass"):
        raise ValueError(f"kernel {kernel!r}: rbgs or pass")
    if paired and dtype != torch.bfloat16:
        raise ValueError("the paired marches are the bfloat16 sweeps'")
    if paired:
        rows, width = MARCH_PAIR_ROWS, 2 * MARCH_PAIR_WORDS
        strips = -(-((c + 1) // 2) // MARCH_PAIR_WORDS)
    else:
        rows = MARCH_ROWS[kernel, dtype]
        width = MARCH_LANES - 2 * (2 if kernel == "rbgs" else 1)
        strips = -(-c // width)
    bands = -(-r // rows)
    chunk = MARCH_CHUNK[kernel]
    need = -(-MARCH_MIN_UNITS // (strips * bands))
    if -(-p // chunk) < need:
        chunk = max(1, p // need)
    chunk = -(-p // -(-p // chunk))          # balanced: the same chunks
    if paired:
        chunk += chunk % 2
    return (strips, bands, -(-p // chunk), width, chunk)


@functools.cache
def _launch_geometry(kernel: str, shape: tuple, dtype, paired=False):
    """The march's geometry as the kernel's int array, built once for each
    kernel, stack shape, dtype and march."""
    return (ctypes.c_int * 5)(*march_geometry(kernel, *shape, dtype,
                                              paired=paired))


def rbgs_pairs(u: torch.Tensor, b: torch.Tensor, out: torch.Tensor,
               goff: int = 0, roff: int = 0) -> bool:
    """Whether a bfloat16 RB-GS sweep of u (b, into out) takes the paired
    march: the layout rule of csrc/stencil3d.cuh's rbgs_pairs, which the
    launcher applies to the same pointers. r and c odd and goff + roff even
    (every 4-byte-aligned pair of points starts on a red one), u and b on a
    4-byte word and out on a pair of its dtype. Elsewhere (a stack with odd
    offsets, an odd pointer) the scalar march runs."""
    _, r, c = u.shape
    return (u.dtype == torch.bfloat16 and r % 2 == 1 and c % 2 == 1
            and (goff + roff) % 2 == 0 and u.data_ptr() % 4 == 0
            and b.data_ptr() % 4 == 0
            and out.data_ptr() % (2 * out.element_size()) == 0)


def jacobi_pairs(u: torch.Tensor, b: torch.Tensor,
                 out: torch.Tensor) -> bool:
    """Whether a bfloat16 Jacobi sweep of u (b, into out) takes the paired
    march: the layout rule of csrc/stencil3d.cuh's jacobi_pairs, which the
    launcher applies to the same pointers. u, b and out bfloat16, c odd
    (a row's first element then has the parity of q r + y, whatever r and
    the offsets), and each array on a 4-byte word. Elsewhere (an odd
    pointer; the sweep storing float32) the scalar march runs."""
    return (u.dtype == b.dtype == out.dtype == torch.bfloat16
            and u.shape[2] % 2 == 1 and u.data_ptr() % 4 == 0
            and b.data_ptr() % 4 == 0 and out.data_ptr() % 4 == 0)


def _check(u: torch.Tensor, b: torch.Tensor, n: int, what: str,
           out_dtype=None) -> torch.dtype:
    """Check a call's u and b (float32, float64, or bfloat16 storage, of one
    dtype) and return the dtype its output is stored in."""
    if u.ndim != 3 or min(u.shape[:2]) < 3 or u.shape[2] != n + 2:
        raise ValueError(f"{what}: u has shape {tuple(u.shape)}; expected a "
                         f"(p, r, {n + 2}) plane stack with p, r >= 3")
    check_tensor("u", u, tuple(u.shape), u, storage=True)
    check_tensor("b", b, tuple(u.shape), u, storage=True)
    return check_out_dtype(what, u, out_dtype)


def _widen_b(u: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """b as a sweep takes it: a bfloat16 b beside a wider u is widened to
    u's dtype (the TPU module's cast); any other b as it is."""
    if b.dtype == torch.bfloat16 and u.dtype != torch.bfloat16:
        return b.to(u.dtype)
    return b


# ----------------------------------------------------------------------------
# Plain versions
# ----------------------------------------------------------------------------

def _masks(u: torch.Tensor, n: int, goff: int, roff: int):
    """(valid planes (p, 1, 1), updatable points, red points) as bool
    tensors broadcastable to u's shape."""
    p, r, c = u.shape
    dev = u.device
    g = torch.arange(p, device=dev) + goff
    y = torch.arange(r, device=dev) + roff
    x = torch.arange(c, device=dev)
    zlocal = torch.arange(p, device=dev)
    ylocal = torch.arange(r, device=dev)
    zvalid = ((zlocal >= 1) & (zlocal <= p - 2) & (g >= 1)
              & (g <= n)).view(p, 1, 1)
    yok = ((ylocal >= 1) & (ylocal <= r - 2) & (y >= 1)
           & (y <= n)).view(1, r, 1)
    xok = ((x >= 1) & (x <= n)).view(1, 1, c)
    update = zvalid & yok & xok
    red = ((g % 2).view(p, 1, 1) ^ (y % 2).view(1, r, 1)
           ^ (x % 2).view(1, 1, c)) == 0
    return zvalid, update, red


def _nsum(u: torch.Tensor) -> torch.Tensor:
    """Sum of the six face neighbours at every point of u's core, in the
    TPU kernel's order."""
    return (((((u[:-2, 1:-1, 1:-1] + u[2:, 1:-1, 1:-1])
               + u[1:-1, :-2, 1:-1]) + u[1:-1, 2:, 1:-1])
             + u[1:-1, 1:-1, :-2]) + u[1:-1, 1:-1, 2:])


def _pad(core: torch.Tensor) -> torch.Tensor:
    return F.pad(core, (1, 1, 1, 1, 1, 1))


def _residual_core(u, b, h, sigma):
    inv_h2 = 1.0 / (h * h)
    zm = u[1:-1, 1:-1, 1:-1]
    au = (6.0 * zm - _nsum(u)) * inv_h2
    return b[1:-1, 1:-1, 1:-1] - au + sigma * zm


def _gs(u, b, h, sigma):
    """The Gauss-Seidel value at every point from u (padded, core only)."""
    h2 = h * h
    inv_den = 1.0 / (6.0 - sigma * h2)
    return _pad((h2 * b[1:-1, 1:-1, 1:-1] + _nsum(u)) * inv_den)


def residual_plain(u, b, n, h, sigma=0.0, goff=0, roff=0):
    """Plain PyTorch version of ``residual``: in the compute dtype, from u
    and b widened (float32 for bfloat16 storage)."""
    cdt = compute_dtype(u.dtype)
    u, b = u.to(cdt), b.to(cdt)
    _, update, _ = _masks(u, n, goff, roff)
    r = _pad(_residual_core(u, b, h, sigma))
    return torch.where(update, r, torch.zeros_like(r))


def jacobi_sweep_plain(u, b, n, h, omega, sigma=0.0, sweeps=1, goff=0,
                       roff=0, out_dtype=None):
    """Plain PyTorch version of ``jacobi_sweep``: each sweep in the compute
    dtype from u widened, stored in u's dtype (the last in ``out_dtype``)."""
    odt = check_out_dtype("stencil3d.jacobi_sweep_plain", u, out_dtype)
    sdt, cdt = u.dtype, compute_dtype(u.dtype)
    b = b.to(cdt)
    zvalid, update, _ = _masks(u, n, goff, roff)
    scale = omega / (6.0 * (1.0 / (h * h)) - sigma)
    for i in range(sweeps):
        uc = u.to(cdt)
        upd = uc + scale * _pad(_residual_core(uc, b, h, sigma))
        uc = torch.where(update, upd, uc)
        uc = torch.where(zvalid, uc, torch.zeros_like(uc))
        u = uc.to(odt if i == sweeps - 1 else sdt)
    return u.to(odt)


def rbgs_sweep_plain(u, b, n, h, sigma=0.0, sweeps=1, goff=0, roff=0,
                     out_dtype=None):
    """Plain PyTorch version of ``rbgs_sweep``: each sweep in the compute
    dtype from u widened, the red values rounded to u's dtype before the
    black stage reads them, stored in u's dtype (the last sweep in
    ``out_dtype``)."""
    odt = check_out_dtype("stencil3d.rbgs_sweep_plain", u, out_dtype)
    sdt, cdt = u.dtype, compute_dtype(u.dtype)
    b = b.to(cdt)
    zvalid, update, red = _masks(u, n, goff, roff)
    for i in range(sweeps):
        uc = u.to(cdt)
        uc = torch.where(update & red, _gs(uc, b, h, sigma), uc)
        uc = uc.to(sdt).to(cdt)
        uc = torch.where(update & ~red, _gs(uc, b, h, sigma), uc)
        uc = torch.where(zvalid, uc, torch.zeros_like(uc))
        u = uc.to(odt if i == sweeps - 1 else sdt)
    return u.to(odt)


# ----------------------------------------------------------------------------
# Kernel wrappers
# ----------------------------------------------------------------------------

def residual(u: torch.Tensor, b: torch.Tensor, n: int, h: float, sigma=0.0,
             goff: int = 0, roff: int = 0) -> torch.Tensor:
    """r = b - (A - sigma I) u on a plane stack (see the module's edge
    rule); one pass. r is stored in the compute dtype: u's, or float32 for
    bfloat16 u and b."""
    global residual_launches, residual_bf16_launches
    _check(u, b, n, "stencil3d.residual")
    if not on_cuda(u):
        return residual_plain(u, b, n, h, sigma=sigma, goff=goff, roff=roff)
    out = torch.empty_like(u, dtype=compute_dtype(u.dtype))
    launch_on(u, "stencil3d_residual", u.data_ptr(), b.data_ptr(),
              out.data_ptr(), *u.shape, n, float(h), float(sigma), int(goff),
              int(roff), _launch_geometry("pass", tuple(u.shape), u.dtype),
              writes=(out,))
    if u.dtype == torch.bfloat16:
        residual_bf16_launches += 1
    else:
        residual_launches += 1
    return out


def _count_sweep(kind: str, u: torch.Tensor, odt, paired: bool) -> None:
    """One launch of the ``kind`` sweep on u, stored in odt, on the paired
    march or not."""
    name = kind + ("" if u.dtype != torch.bfloat16 else
                   "_bf16" if odt == torch.bfloat16 else "_bf16_f32")
    globals()[name + "_launches"] += 1
    if paired:
        globals()[kind + "_bf16_pairs_launches"] += 1


def _sweeps(kind: str, kernel: str, u, b, n, args, sweeps: int, odt,
            offs=(0, 0)):
    """``sweeps`` launches of ``kernel`` (one a sweep), the last one storing
    odt; args are the entry point's scalars after n, before the geometry;
    offs the stack's (goff, roff), which pick a bfloat16 RB-GS sweep's
    march (rbgs_pairs); a bfloat16 Jacobi sweep's is jacobi_pairs'."""
    for i in range(sweeps):
        o = odt if i == sweeps - 1 else u.dtype
        out = torch.empty_like(u, dtype=o)
        paired = (rbgs_pairs(u, b, out, *offs) if kind == "rbgs"
                  else jacobi_pairs(u, b, out))
        geom = _launch_geometry("rbgs" if kind == "rbgs" else "pass",
                                tuple(u.shape), u.dtype, paired)
        launch_on(u, kernel, u.data_ptr(), b.data_ptr(), out.data_ptr(),
                  *u.shape, n, *args, geom, out_dtype=o, writes=(out,))
        _count_sweep(kind, u, o, paired)
        u = out
    return u.to(odt)


def jacobi_sweep(u: torch.Tensor, b: torch.Tensor, n: int, h: float,
                 omega: float, sigma=0.0, sweeps: int = 1, goff: int = 0,
                 roff: int = 0, out_dtype=None) -> torch.Tensor:
    """``sweeps`` weighted-Jacobi sweeps, u + omega/(6/h^2 - sigma) r, one
    pass (launch) each. Each sweep stores u's dtype, the last one
    ``out_dtype`` (float32 for bfloat16 u: the ``_wrap.check_out_dtype``
    rule); with no sweeps, u in ``out_dtype``."""
    b = _widen_b(u, b)
    odt = _check(u, b, n, "stencil3d.jacobi_sweep", out_dtype)
    if not on_cuda(u):
        return jacobi_sweep_plain(u, b, n, h, omega, sigma=sigma,
                                  sweeps=sweeps, goff=goff, roff=roff,
                                  out_dtype=out_dtype)
    return _sweeps("jacobi", "stencil3d_jacobi", u, b, n,
                   (float(h), float(sigma), float(omega), int(goff),
                    int(roff)), sweeps, odt)


def rbgs_sweep(u: torch.Tensor, b: torch.Tensor, n: int, h: float,
               sigma=0.0, sweeps: int = 1, goff: int = 0, roff: int = 0,
               out_dtype=None) -> torch.Tensor:
    """``sweeps`` full red-then-black Gauss-Seidel sweeps, one launch (one
    pass over u and b, no scratch grid) each. Each sweep stores u's dtype,
    the last one ``out_dtype`` (float32 for bfloat16 u); with no sweeps, u
    in ``out_dtype``."""
    b = _widen_b(u, b)
    odt = _check(u, b, n, "stencil3d.rbgs_sweep", out_dtype)
    if not on_cuda(u):
        return rbgs_sweep_plain(u, b, n, h, sigma=sigma, sweeps=sweeps,
                                goff=goff, roff=roff, out_dtype=out_dtype)
    return _sweeps("rbgs", "stencil3d_rbgs", u, b, n,
                   (float(h), float(sigma), int(goff), int(roff)), sweeps,
                   odt, (int(goff), int(roff)))
