"""Color-packed tier for the finest 2D levels (n >= ``PACK_MIN_N``).

A padded (n+2)^2 grid is stored as two planes (2, n+2, (n+3)//2): plane 0
the red points ((i+j) even), plane 1 the black ones, packed along each
row with a row-parity offset, as in ``multigridcmt_tpu/kernels/packed2d.py``:

    R[i, l] = u[i, 2l + i%2]        B[i, l] = u[i, 2l + 1 - i%2]

The lane past a row's last point of its colour is a pad and stays zero.
``pack``/``unpack`` convert at the solve's encode/decode boundary, once a
solve, in plain PyTorch.

Replaces five TPU kernels of that module with ``csrc/packed2d.cu`` (the
legs and sweeps in ``csrc/packed2d_legs.cuh``, instantiated by
``packed2d.cu``, ``packed2d_up*.cu`` and ``packed2d_sweep.cu``; see the
notes there on what bounds them and how they work on the card):
  * ``smooth_residual_restrict``: the whole down leg; after an RB-GS sweep
    the black residual is taken as zero (the closing black half-sweep
    zeroes it in exact arithmetic) and only the red residual is restricted;
  * ``prolong_add_smooth``: the whole up leg; the coarse correction may be
    logical or packed. Both legs stream rows through registers, a warp a
    strip; ``leg_geometry`` computes their launch geometry;
  * ``residual_norm_sq``: ||b - (A - sigma I) u||^2 without writing the
    residual, the convergence check; ``red_only`` sums the red plane only;
  * ``residual``: b - (A - sigma I) u on both planes, ghosts and pad lanes
    zero: the operator apply and the residual of MG-PCG on a packed level,
    and the residual applies of its Chebyshev and Jacobi smoothing;
  * ``rbgs_sweep``: up to ``max_fused_sweeps()`` RB-GS sweeps in one pass,
    the smoothing of a packed level whose leg has more sweeps than a fused
    leg takes: the up leg's row stream without its coarse operand
    (``leg_geometry("sweep", ...)``).

Each wrapper has its plain PyTorch version beside it: unpack, the ``ops/``
composition, pack. Device rule (``_wrap``): a CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.

Mixed precision (the TPU module's ``_cdt`` rule): the legs, the sweeps,
the residual and the norm also take bfloat16 grids, the fine level of a
mixed cycle (``csrc/packed2d_bf16.cu``, ``packed2d_sweep_bf16.cu``,
``packed2d_up_bf16.cu``, ``packed2d_up_bf16_f32.cu``). Every load widens to
float32, the sweeps and the residual run in float32 and each point is
rounded to bfloat16 once, on its store; the down leg's residual is that of
u' as stored, and its coarse right-hand side is float32, as is the up leg's
coarse correction. The up leg may store x' in float32 (``out_dtype``): the
top level of a mixed cycle does (``solvers/cycles.py``), where the TPU
module stores it in bfloat16. The fused residual norm returns a float32
sum; no mixed path of either package reaches it (direct calls). The plain
versions follow the same rule.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ..ops import laplacian, smoothers, transfer
from . import _build
from ._wrap import check_grid, check_out_dtype, check_tensor, \
    compute_dtype, launch_on, on_cuda

# Launches of each CUDA kernel in this process (plain-version calls do not
# count); the bfloat16 modes apart: the up leg's with a bfloat16 x' and with
# a float32 one (up_bf16_f32_launches).
down_launches = 0
up_launches = 0
resnorm_launches = 0
residual_launches = 0
rbgs_launches = 0
down_bf16_launches = 0
up_bf16_launches = 0
up_bf16_f32_launches = 0
residual_bf16_launches = 0
rbgs_bf16_launches = 0
resnorm_bf16_launches = 0
# Of residual_bf16_launches, those of the paired kernel (residual_pairs).
residual_bf16_pairs_launches = 0

# Blocks of the residual norm's first pass; each writes one float64
# partial sum, which the second pass adds in a fixed order.
RESNORM_BLOCKS = 1024


def packed_shape(n: int) -> tuple:
    """Shape of the packed form of an (n+2)^2 padded grid."""
    return (2, n + 2, (n + 3) // 2)


def is_packed(t: torch.Tensor) -> bool:
    """Packed 2D layout: two planes. A logical 3D grid is also of rank 3,
    but its leading extent is n + 2 >= 5."""
    return t.ndim == 3 and t.shape[0] == 2


def pack(u: torch.Tensor) -> torch.Tensor:
    """Logical (P, P) padded grid -> packed (2, P, (P+1)//2)."""
    p = u.shape[0]
    s = u.new_zeros((2, p, (p + 1) // 2))
    for plane, row0, col0 in ((0, 0, 0), (0, 1, 1), (1, 0, 1), (1, 1, 0)):
        part = u[row0::2, col0::2]
        s[plane, row0::2, : part.shape[1]] = part
    return s


def unpack(s: torch.Tensor) -> torch.Tensor:
    """Packed (2, P, (P+1)//2) -> logical (P, P) padded grid."""
    p = s.shape[1]
    u = s.new_zeros((p, p))
    for plane, row0, col0 in ((0, 0, 0), (0, 1, 1), (1, 0, 1), (1, 1, 0)):
        part = u[row0::2, col0::2]
        part.copy_(s[plane, row0::2, : part.shape[1]])
    return u


def max_down_sweeps(kind: str) -> int:
    """Sweeps one smooth_residual_restrict launch can fuse."""
    halo = _build.MAX_HALO
    return (halo - 2) // 2 if kind == "rbgs" else halo - 2


def max_up_sweeps(kind: str) -> int:
    """Sweeps one prolong_add_smooth launch can fuse."""
    halo = _build.MAX_HALO
    return halo // 2 if kind == "rbgs" else halo


def max_fused_sweeps() -> int:
    """RB-GS sweeps one rbgs_sweep launch fuses (2 stale rows a sweep)."""
    return _build.MAX_HALO // 2


def _check_schedule(kind: str, sweeps: int, cap: int) -> None:
    if kind not in _build.KIND_CODES:
        raise ValueError(f"packed legs run jacobi or rbgs, not {kind!r}")
    if not 0 <= sweeps <= cap:
        raise ValueError(f"{sweeps} {kind} sweeps: one packed leg takes 0 "
                         f"to {cap}")


def _check_fine(n: int) -> None:
    if n < 3 or n % 2 == 0:
        raise ValueError(f"fine n={n} must be odd and >= 3 (n = 2*nc + 1)")


# The row-streaming legs and sweeps (csrc/packed2d_legs.cuh down_kernel,
# up_kernel, sweep_kernel).
# Each warp streams its own strip of LEG_LANES lanes down a segment of rows,
# in registers: LEG_AHEAD rows loaded ahead, a window of LEG_WINDOW rows
# (and LEG_COARSE_WINDOW coarse rows in the up leg); these are the kernel
# source's constants (kWarp, kAhead, kWin, kCoarseWin), held against it by
# the CPU tests. A segment has at least LEG_MIN_SEG rows (fused2d names its
# own least segment); the launch aims at LEG_WARPS_PER_SM warps on each SM
# (16 measured best at 4095^2, PERF.md).
LEG_LANES = 32
LEG_AHEAD = 4
LEG_WINDOW = 16
LEG_COARSE_WINDOW = 8
LEG_MIN_SEG = 64
LEG_WARPS_PER_SM = 16


@dataclasses.dataclass(frozen=True)
class LegGeometry:
    """Launch geometry of a row-streaming leg or sweep stream (see
    csrc/packed2d.cu's note) on a frame: the whole packed grid, the whole
    unpacked grid (``fused2d.leg_geometry``: the same rows and lanes) or a
    shard's packed tile (``plocal2d.leg_geometry``).

    Rows are global rows: the frame's array rows are ``count`` rows from
    global row ``first``; rb is the even row at or above ``first``. Unit
    (sx, sy), one warp, owns the frame's lanes [sx * strip, (sx + 1) *
    strip) and rows [rb + sy * seg, rb + (sy + 1) * seg) (clipped to the
    frame's ``lanes`` and rows); its LEG_LANES lanes start ``halo_lanes``
    before its first. It streams the rows from ``top`` above its first
    (from rb at the first segment: a row above the frame reads as zeros)
    to ``bottom`` below its last. In step t row t has been loaded;
    smoothing stage k (an RB-GS half-sweep or a Jacobi sweep) works on row
    t - 1 - k, the down leg's residual (and store) on row t - out_lag and
    its restriction on fine row t - out_lag - 1, the up leg's (and the
    sweep stream's) store on row t - out_lag; stages run in that order
    within a step. Each lane keeps
    LEG_WINDOW rows (and LEG_COARSE_WINDOW coarse rows) in registers;
    nothing is in shared memory."""
    leg: str
    n: int
    stages: int
    strips: int
    segs: int
    strip: int
    seg: int
    halo_lanes: int
    top: int
    bottom: int
    out_lag: int
    first: int
    count: int
    lanes: int

    def ints(self) -> tuple:
        """The 7 ints the kernel takes (its LegGeom)."""
        return (self.strips, self.segs, self.strip, self.seg,
                self.halo_lanes, self.top, self.bottom)

    def rows(self, sy: int) -> tuple:
        """(first, end) of segment sy's rows and of the rows it streams,
        global."""
        rb = self.first & ~1
        yu = rb + sy * self.seg
        end = self.first + self.count
        y1 = min(yu + self.seg, end)
        return (max(yu, self.first), y1, max(rb, yu - self.top),
                min(end, y1 + self.bottom))

    def strip_lanes(self, sx: int) -> tuple:
        """(first, end) of strip sx's lanes."""
        l0 = sx * self.strip
        return l0, min(l0 + self.strip, self.lanes)

    def span(self) -> int:
        """Rows a lane holds at once: from the oldest row a step reads (the
        residual's row above its row, or the last stage's) to the newest
        one loaded."""
        oldest = self.out_lag + 1 if self.leg == "down" else self.stages + 1
        return oldest + LEG_AHEAD + 1


def leg_geometry(leg: str, n: int, kind: str, sweeps: int, *,
                 sm_count: int = 132, seg: int | None = None,
                 rows: int | None = None, first: int = 0,
                 lanes: int | None = None,
                 min_seg: int | None = None) -> LegGeometry:
    """Geometry of the down (``leg="down"``) or up leg, or of the sweep
    stream (``leg="sweep"``: the up leg without its coarse operand, on the
    up leg's halos and lags), with ``sweeps`` sweeps of ``kind`` on the
    packed (n+2)^2 grid, or on a frame of ``rows`` array rows from global
    row ``first`` and ``lanes`` lanes; ``seg`` overrides the segment rows
    the launch would choose for ``sm_count`` SMs, segments of at least
    ``min_seg`` rows (default LEG_MIN_SEG).

    Halos: each stage makes one more ring of a unit's tile stale, so the up
    leg's (and the sweep stream's) K stages need K rows above and below
    and ceil(K/2) lanes each side; the down leg also needs the residual one
    row past its rows (K + 2 above, K + 1 below, ceil((K + 2)/2) lanes).
    The rows above are rounded up to even, so each unit starts on an even
    row and the kernel knows every row's parity at compile time. Lags: a
    stage reads rows i - 1 .. i + 1 of the one before it, which reached row
    i + 1 earlier in the same step, so consecutive stages are one row
    apart."""
    stages = 2 * sweeps if kind == "rbgs" else sweeps
    p = n + 2 if rows is None else rows
    cp = (n + 3) // 2 if lanes is None else lanes
    if leg == "down":
        halo, top, bottom, out_lag = ((stages + 3) // 2, stages + 2,
                                      stages + 1, stages + 1)
    elif leg in ("up", "sweep"):
        halo, top, bottom, out_lag = ((stages + 1) // 2, stages, stages,
                                      stages)
    else:
        raise ValueError(f"leg {leg!r}: down, up or sweep")
    top += top & 1
    strip = LEG_LANES - 2 * halo
    strips = -(-cp // strip)
    # The streamed rows start at the even row at or above the frame's
    # first.
    span = p + (first & 1)
    if seg is None:
        units = sm_count * LEG_WARPS_PER_SM
        least = LEG_MIN_SEG if min_seg is None else min_seg
        seg = max(least, -(-span // max(1, units // strips)))
    seg += seg & 1
    return LegGeometry(leg=leg, n=n, stages=stages, strips=strips,
                       segs=-(-span // seg), strip=strip, seg=seg,
                       halo_lanes=halo, top=top, bottom=bottom,
                       out_lag=out_lag, first=first, count=p, lanes=cp)


def _sm_count(index: int) -> int:
    """SMs of card ``index``; raises where there is no card, as a launch
    does (in the card's context)."""
    with torch.cuda.device(index):
        return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _launch_geometry(leg: str, n: int, kind: str, sweeps: int, index: int,
                     rows: int | None = None, first: int = 0,
                     lanes: int | None = None, min_seg: int | None = None):
    """The leg's (or sweep stream's) geometry on card ``index``, as the
    kernel's int array, built once for each leg, frame (``leg_geometry``'s;
    the whole grid by default, the unpacked grid from ``fused2d``, a
    shard's tile from ``plocal2d``), schedule, least segment and card."""
    g = leg_geometry(leg, n, kind, sweeps, sm_count=_sm_count(index),
                     rows=rows, first=first, lanes=lanes, min_seg=min_seg)
    return (ctypes.c_int * 7)(*g.ints())


def _zero_black(r: torch.Tensor) -> torch.Tensor:
    """r with its black points ((i+j) odd) set to zero."""
    p = r.shape[0]
    idx = torch.arange(p, device=r.device)
    black = (idx[:, None] + idx[None, :]) % 2 == 1
    return r.masked_fill(black, 0.0)


def residual_restrict_plain(us, bs, n, h, *, red_only, sigma=0.0,
                            packed_coarse=False):
    """restrict(b - (A - sigma I) u) from packed grids, in the compute
    dtype (float32 for bfloat16 grids), the red residual only with
    ``red_only``: the down leg's coarse output for its stored u'."""
    cdt = compute_dtype(us.dtype)
    r = laplacian.residual(unpack(us).to(cdt), unpack(bs).to(cdt), h,
                           sigma=sigma)
    if red_only:
        r = _zero_black(r)
    rc = transfer.restrict(r)
    return pack(rc) if packed_coarse else rc


def smooth_residual_restrict_plain(s, bs, n, h, *, kind, omega, sweeps,
                                   sigma=0.0, packed_coarse=False):
    """Plain PyTorch version: unpack, smooth (in float32 for bfloat16
    grids), store u' in the grids' dtype, the residual of u' as stored (red
    only after an RB-GS sweep), restrict, pack."""
    cdt = compute_dtype(s.dtype)
    us = smoothers.smooth(unpack(s).to(cdt), unpack(bs).to(cdt), h,
                          kind=kind, omega=omega, sweeps=sweeps,
                          sigma=sigma)
    us = pack(us).to(s.dtype)
    return us, residual_restrict_plain(
        us, bs, n, h, red_only=kind == "rbgs" and sweeps >= 1, sigma=sigma,
        packed_coarse=packed_coarse)


def smooth_residual_restrict(s: torch.Tensor, bs: torch.Tensor, n: int,
                             h: float, *, kind: str, omega: float,
                             sweeps: int, sigma=0.0,
                             packed_coarse: bool = False):
    """(smooth^sweeps(u), restrict(b - (A - sigma I) u')) in one pass on
    packed grids.

    s, bs: packed (2, n+2, (n+3)//2), float32, float64 or bfloat16.
    Returns u' packed (in s's dtype) and the coarse right-hand side in the
    compute dtype (float32 for bfloat16 grids), logical ((n-1)/2 + 2)^2 or,
    with ``packed_coarse``, packed. Requires sweeps <= max_down_sweeps.
    """
    global down_launches, down_bf16_launches
    _check_schedule(kind, sweeps, max_down_sweeps(kind))
    _check_fine(n)
    check_tensor("u", s, packed_shape(n), s, storage=True)
    check_tensor("b", bs, packed_shape(n), s, storage=True)
    if not on_cuda(s):
        return smooth_residual_restrict_plain(
            s, bs, n, h, kind=kind, omega=omega, sweeps=sweeps, sigma=sigma,
            packed_coarse=packed_coarse)
    nc = (n - 1) // 2
    cdt = compute_dtype(s.dtype)
    u_out = torch.empty_like(s)
    # Packed: the coarse pad lanes are never written, so start from zeros.
    rc = (torch.zeros(packed_shape(nc), dtype=cdt, device=s.device)
          if packed_coarse else
          torch.empty((nc + 2, nc + 2), dtype=cdt, device=s.device))
    launch_on(s, "packed2d_down", s.data_ptr(), bs.data_ptr(),
              u_out.data_ptr(), rc.data_ptr(), n, float(h), float(sigma),
              _build.KIND_CODES[kind], float(omega), sweeps,
              int(packed_coarse),
              _launch_geometry("down", n, kind, sweeps, s.device.index or 0),
              writes=(u_out, rc))
    if s.dtype == torch.bfloat16:
        down_bf16_launches += 1
    else:
        down_launches += 1
    return u_out, rc


def prolong_add_smooth_plain(x, e, b, n, nc, h, *, kind, omega, sweeps,
                             sigma=0.0, out_dtype=None):
    """Plain PyTorch version: unpack, smooth^sweeps(x + P e) (in float32
    for bfloat16 grids), pack, store in ``out_dtype`` (default x's)."""
    cdt = compute_dtype(x.dtype)
    ec = unpack(e) if is_packed(e) else e
    xs = smoothers.smooth(unpack(x).to(cdt) + transfer.prolong(ec),
                          unpack(b).to(cdt), h, kind=kind, omega=omega,
                          sweeps=sweeps, sigma=sigma)
    return pack(xs).to(x.dtype if out_dtype is None else out_dtype)


def prolong_add_smooth(x: torch.Tensor, e: torch.Tensor, b: torch.Tensor,
                       n: int, nc: int, h: float, *, kind: str, omega: float,
                       sweeps: int, sigma=0.0, out_dtype=None) -> torch.Tensor:
    """smooth^sweeps(x + P e) in one pass on packed grids.

    x, b: packed (2, n+2, (n+3)//2), float32, float64 or bfloat16; e:
    logical (nc+2, nc+2) or packed, in the compute dtype (float32 for
    bfloat16 x), with n = 2*nc + 1. x' is stored in x's dtype, or with
    ``out_dtype=torch.float32`` for bfloat16 x, in float32. Requires
    sweeps <= max_up_sweeps.
    """
    global up_launches, up_bf16_launches, up_bf16_f32_launches
    _check_schedule(kind, sweeps, max_up_sweeps(kind))
    if n != 2 * nc + 1:
        raise ValueError(f"fine n={n} is not 2*nc+1 for nc={nc}")
    check_tensor("x", x, packed_shape(n), x, storage=True)
    out_dtype = check_out_dtype("packed2d.prolong_add_smooth", x,
                                out_dtype)
    cdt = compute_dtype(x.dtype)
    packed_e = is_packed(e)
    if packed_e:
        check_tensor("e", e, packed_shape(nc), x, cdt)
    else:
        check_grid("e", e, nc, x, cdt)
    check_tensor("b", b, packed_shape(n), x, storage=True)
    if not on_cuda(x):
        return prolong_add_smooth_plain(x, e, b, n, nc, h, kind=kind,
                                        omega=omega, sweeps=sweeps,
                                        sigma=sigma, out_dtype=out_dtype)
    out = torch.empty_like(x, dtype=out_dtype)
    launch_on(x, "packed2d_up", x.data_ptr(), e.data_ptr(), b.data_ptr(),
              out.data_ptr(), n, float(h), float(sigma),
              _build.KIND_CODES[kind], float(omega), sweeps, int(packed_e),
              _launch_geometry("up", n, kind, sweeps, x.device.index or 0),
              out_dtype=out_dtype, writes=(out,))
    if x.dtype != torch.bfloat16:
        up_launches += 1
    elif out_dtype == torch.bfloat16:
        up_bf16_launches += 1
    else:
        up_bf16_f32_launches += 1
    return out


def residual_norm_sq_plain(s, bs, n, h, *, red_only=False, sigma=0.0):
    """Plain PyTorch version: the sum of squares of the unpacked residual
    (its red points only with ``red_only``), in the compute dtype (from
    widened grids, summed in float32, for bfloat16 ones)."""
    cdt = compute_dtype(s.dtype)
    r = laplacian.residual(unpack(s).to(cdt), unpack(bs).to(cdt), h,
                           sigma=sigma)
    if red_only:
        r = _zero_black(r)
    return torch.sum(r * r)


def residual_norm_sq(s: torch.Tensor, bs: torch.Tensor, n: int, h: float, *,
                     red_only: bool = False, sigma=0.0) -> torch.Tensor:
    """||b - (A - sigma I) u||^2 on packed grids, without writing the
    residual; a 0-d tensor of the compute dtype (the grids' own, float32
    for bfloat16 grids, as the TPU kernel's). ``red_only`` sums the red
    points only, which is exact when u has just finished an RB-GS sweep."""
    global resnorm_launches, resnorm_bf16_launches
    _check_fine(n)
    check_tensor("u", s, packed_shape(n), s, storage=True)
    check_tensor("b", bs, packed_shape(n), s, storage=True)
    if not on_cuda(s):
        return residual_norm_sq_plain(s, bs, n, h, red_only=red_only,
                                      sigma=sigma)
    partial = torch.empty(RESNORM_BLOCKS, dtype=torch.float64,
                          device=s.device)
    out = torch.empty((), dtype=compute_dtype(s.dtype), device=s.device)
    launch_on(s, "packed2d_resnorm", s.data_ptr(), bs.data_ptr(),
              partial.data_ptr(), out.data_ptr(), n, float(h), float(sigma),
              int(red_only), RESNORM_BLOCKS, writes=(out,))
    if s.dtype == torch.bfloat16:
        resnorm_bf16_launches += 1
    else:
        resnorm_launches += 1
    return out


def residual_plain(s, bs, n, h, sigma=0.0):
    """Plain PyTorch version: unpack, the residual (in float32 for bfloat16
    grids), pack (pad lanes 0), store in the grids' dtype."""
    cdt = compute_dtype(s.dtype)
    r = laplacian.residual(unpack(s).to(cdt), unpack(bs).to(cdt), h,
                           sigma=sigma)
    return pack(r).to(s.dtype)


def residual_pairs(s: torch.Tensor, bs: torch.Tensor,
                   out: torch.Tensor) -> bool:
    """Whether the bfloat16 residual on these packed grids takes the
    paired kernel (words of two lanes), the layout rule of
    csrc/packed_tile.cuh's presidual_pairs: an odd number of lanes a row
    (n = 3 mod 4, every n = 2^k - 1), every array on a 4-byte word and its
    2 (n + 2) rows within a CUDA grid's y extent; else the scalar kernel,
    a thread a lane."""
    _, rows, lanes = s.shape
    return (lanes % 2 == 1 and 2 * rows <= 65535
            and all(t.data_ptr() % 4 == 0 for t in (s, bs, out)))


def residual(s: torch.Tensor, bs: torch.Tensor, n: int, h: float,
             sigma=0.0) -> torch.Tensor:
    """r = b - (A - sigma I) u on packed grids, one pass; ghosts and pad
    lanes of r are zero. bfloat16 grids: computed in float32, r stored in
    bfloat16, as the TPU kernel's."""
    global residual_launches, residual_bf16_launches, \
        residual_bf16_pairs_launches
    _check_fine(n)
    check_tensor("u", s, packed_shape(n), s, storage=True)
    check_tensor("b", bs, packed_shape(n), s, storage=True)
    if not on_cuda(s):
        return residual_plain(s, bs, n, h, sigma=sigma)
    out = torch.empty_like(s)
    launch_on(s, "packed2d_residual", s.data_ptr(), bs.data_ptr(),
              out.data_ptr(), n, float(h), float(sigma), writes=(out,))
    if s.dtype == torch.bfloat16:
        residual_bf16_launches += 1
        residual_bf16_pairs_launches += residual_pairs(s, bs, out)
    else:
        residual_launches += 1
    return out


def rbgs_sweep_plain(s, bs, n, h, *, sweeps=1, sigma=0.0):
    """Plain PyTorch version: unpack, ``sweeps`` RB-GS sweeps (in float32
    for bfloat16 grids), pack, store in the grids' dtype."""
    cdt = compute_dtype(s.dtype)
    return pack(smoothers.smooth(unpack(s).to(cdt), unpack(bs).to(cdt), h,
                                 kind="rbgs", omega=1.0, sweeps=sweeps,
                                 sigma=sigma)).to(s.dtype)


def rbgs_sweep(s: torch.Tensor, bs: torch.Tensor, n: int, h: float, *,
               sweeps: int = 1, sigma=0.0) -> torch.Tensor:
    """``sweeps`` (1 to ``max_fused_sweeps()``) red+black Gauss-Seidel
    sweeps on packed grids in one pass (the row-streaming sweep kernel);
    ghosts and pad lanes stay zero. bfloat16 grids: the sweeps run in
    float32, each point rounded once, on its store."""
    global rbgs_launches, rbgs_bf16_launches
    if not 1 <= sweeps <= max_fused_sweeps():
        raise ValueError(f"{sweeps} rbgs sweeps: one launch takes 1 to "
                         f"{max_fused_sweeps()}")
    _check_fine(n)
    check_tensor("u", s, packed_shape(n), s, storage=True)
    check_tensor("b", bs, packed_shape(n), s, storage=True)
    if not on_cuda(s):
        return rbgs_sweep_plain(s, bs, n, h, sweeps=sweeps, sigma=sigma)
    out = torch.empty_like(s)
    launch_on(s, "packed2d_rbgs", s.data_ptr(), bs.data_ptr(),
              out.data_ptr(), n, float(h), float(sigma), sweeps,
              _launch_geometry("sweep", n, "rbgs", sweeps,
                               s.device.index or 0), writes=(out,))
    if s.dtype == torch.bfloat16:
        rbgs_bf16_launches += 1
    else:
        rbgs_launches += 1
    return out
