"""Distributed multigrid over ``torch.distributed``: row and block
decompositions in 2D, slab and pencil ones in 3D, halo exchange, the
``local2d`` and ``stencil3d`` shard kernels and coarse-level agglomeration.

PyTorch port of ``multigridcmt_tpu.parallel.sharded``, with the same
partitioning and the
same arithmetic. Each rank is one process holding one tile; where JAX runs
one SPMD program under ``shard_map``, each rank here runs the same host code
on its own tile, and its coordinates on the mesh are plain ints.

Partitioning, per sharded axis (as in JAX): the padded fine grid has 2^k + 1
entries, ghost 0, interior 1..n, ghost n+1. Entries 1..2^k are sharded over
the D ranks of the axis, rank d owning m = 2^k / D entries, global d*m + 1 ..
(d+1)*m; the far ghost is a dead entry of the last rank that the masks keep
zero, and the near ghost is never stored: a rank with no neighbour on a side
receives zeros, the Dirichlet ghosts. Coarsening halves m per level. A 1D
mesh shards axis 0 (rows in 2D, planes in 3D: slabs), a 2D mesh axes 0 and
1 (blocks; pencils). Tiles hold the owned entries along sharded axes and the
full padded extent along the others.

The exchange: JAX's ``ppermute`` with ``_perm_down``/``_perm_up`` is
``_swap`` here, one ``dist.batch_isend_irecv`` with the neighbours along one
mesh axis (no call at all where a rank has none, as on a mesh of 1).
``psum`` is ``all_reduce``; the agglomeration's ``all_gather`` runs per mesh
axis, rows then columns. JAX overlaps the halo exchange with the stencil and
folds the arriving slabs in as additive fix-ups; the port exchanges first and
then computes, with the same fix-up arithmetic, so the results agree to the
ulp.

Routes, by level (read when called: ``kernels.KERNEL_MIN_N``,
``kernels.PACK_MIN_N``, ``kernels.KERNEL3_MIN_N``):
  * whole-leg levels (``_leg_level_ok``: RB-GS or Jacobi within the legs'
    sweep caps, n >= KERNEL_MIN_N, tiles at least HALO_ROWS deep): the cycle
    runs on extended tiles, one ``local2d.down_leg`` and one ``up_leg`` a
    level, with ghost-slab refreshes between (``_leg_cycle_ext``);
  * the colour-packed fine level (``_pack_level_ok``: a whole-leg finest
    level with n >= PACK_MIN_N): the same legs on packed extended tiles,
    ``plocal2d.down_leg`` and ``up_leg``; the tile's layout is its rank
    (rank 3: packed). The solve loops, sharded MG-PCG and ``v_cycles_fn``
    pack b and x once and carry them packed, the check is the fused
    ``plocal2d.residual_norm_sq`` and PCG's apply is ``plocal2d.apply_op``;
    the down leg emits the coarse right-hand side unpacked, so every
    coarser level is unchanged. ``v_cycle_fn`` (one cycle, owned tiles in
    and out) stays unpacked, as JAX's per-application entry does;
  * 3D extended-stack levels (``_slab3d_level``: RB-GS or Jacobi, n >=
    KERNEL3_MIN_N, tiles holding hz = ``_slab3d_hz_level`` ghost planes, and
    on a pencil mesh hz ghost rows): x and b are extended once a visit into
    plane stacks, the ``stencil3d`` sweeps and residual run on them at the
    stack's global (plane, row) offsets, the owned residual is restricted
    plainly, and the correction is added in place before a ghost refresh
    and the up smoothing;
  * other sharded levels: the owned-tile route, ``s_smooth``/``s_residual``
    (the ``local2d`` sweeps and residual on kernel-sized 2D tiles, the
    ``stencil3d`` ones on slab stacks of the stage's own halo, the plain
    halo-exchanging stencils below and on pencil meshes) and the plain
    ``s_restrict``/``s_prolong``. The stagewise slab stacks serve a kernel
    level whose slabs are too shallow for the extended-stack level
    (``_s_smooth_slab3d``, ``_s_smooth_residual_slab3d``): with the shipped
    KERNEL3_MIN_N and V(2,2) RB-GS that is 4 planes a rank at n >= 127,
    so 32 slab ranks or more, and no mesh of one or four cards takes it;
    the tests reach it by lowering KERNEL3_MIN_N. The 1-plane slab
    residual (``_s_residual_slab3d``) is the slab solve's check and PCG's
    and the eigensolvers' apply on every slab mesh;
  * levels too small to shard (``_is_sharded``): gathered onto every rank and
    solved there by the plain single-device cycle.
Full multigrid (``cycle="fmg"``, ``_sharded_fmg``) walks linearly only, as
JAX's does; the port refuses ``fmg_prolong="cubic"`` rather than ignore it.
The eigensolvers (``ShardedSolver.eigensolve``: inverse iteration, RQI,
LOBPCG) run ``solvers.eigen``'s outer loops over sharded primitives, as
JAX's do: Rayleigh quotients and Gram matrices summed over the mesh by
``all_reduce``, A applied as -residual(u, 0) on owned tiles, the II/RQI
inner solves on carried extended tiles (colour-packed where the fine level
packs) with the residual kernel summed over owned points as their check,
LOBPCG's preconditioner one owned-tile cycle from zero.
Mixed precision (``config.precond_dtype``, ``mixed_leg_dtype``): sharded
MG-PCG, the II/RQI inner solves (as iterative refinement) and LOBPCG's
preconditioner cast their cycles where the fine level runs the whole-leg
kernels, as JAX's do: the fine level's tiles are stored in bfloat16 (the
legs' bfloat16 modes, halo slabs exchanged in bfloat16), its down leg emits
the coarse levels in float32, its up leg stores the cycle's output in
float32 (``out_dtype``), and the outer recurrences, dots, applies and
residuals stay in ``config.dtype``. In 3D sharded MG-PCG casts where
JAX's ``mixed_slab_dtype`` does: the fine stack in bfloat16 (the stencil3d
kernels' bfloat16 modes), its residual and the levels below in float32,
the stack widened to float32 at the correction add, so that the up
smoothing runs the float32 kernels (where JAX adds the correction in
bfloat16: ROADMAP.md queue 3, F7, not copied). Everywhere else, and in
the solve by cycles, FMG, the eigensolvers in 3D, ``v_cycle_fn`` and
``v_cycles_fn``, precond_dtype is ignored, as in JAX.
JAX's ``*_pallas`` helpers are ``*_kernel`` here, and its ``_ext_aligned``
is ``_ext_tile``: the port keeps every tile at its logical extent, with no
alignment padding.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..config import SolverConfig
from ..grids import (Hierarchy, build_hierarchy, check_device, interior,
                     pad_interior)
from ..ops import laplacian, smoothers, transfer
from ..solvers import cycles, krylov


# ---------------------------------------------------------------------------
# Mesh and decomposition
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of a process group laid out row-major over ``shape``.

    ``coords``: this rank's position; ``ranks``: the global rank at each
    position, row-major; ``axis_groups``: per mesh axis, the process group
    of the ranks on this rank's line along that axis (in coordinate order);
    ``device``: where this rank's tiles live (a card for NCCL, the CPU for
    gloo)."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    coords: Tuple[int, ...]
    ranks: Tuple[int, ...]
    axis_groups: Tuple[Any, ...]
    group: Any
    device: torch.device

    def _axis(self, name: str) -> int:
        return self.axis_names.index(name)

    def coord(self, name: str) -> int:
        return self.coords[self._axis(name)]

    def neighbor(self, name: str, step: int) -> Optional[int]:
        """Global rank of the neighbour ``step`` along axis ``name``, or
        None past the mesh's end."""
        a = self._axis(name)
        c = list(self.coords)
        c[a] += step
        if not 0 <= c[a] < self.shape[a]:
            return None
        return self.ranks[sum(c[i] * math.prod(self.shape[i + 1:])
                              for i in range(len(c)))]

    def axis_group(self, name: str):
        return self.axis_groups[self._axis(name)]


def _require_dist() -> None:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "torch.distributed is not initialized: call "
            "torch.distributed.init_process_group (NCCL for ranks on cards, "
            "gloo for CPU processes) before making a mesh; one process is a "
            "mesh of 1")


def _mesh_device(device) -> torch.device:
    """The rank's device (None: its current card)."""
    device = check_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _group_ranks(group):
    size = dist.get_world_size(group)
    if group is None:
        return tuple(range(size))
    return tuple(dist.get_global_rank(group, r) for r in range(size))


def make_mesh(group=None, axis: str = "row", device=None) -> Mesh:
    """1D mesh over the process group (default: the world): row
    partitioning. ``device``: this rank's device (None: its current card;
    "cpu" for gloo ranks)."""
    _require_dist()
    ranks = _group_ranks(group)
    return Mesh(axis_names=(axis,), shape=(len(ranks),),
                coords=(dist.get_rank(group),), ranks=ranks,
                axis_groups=(group,), group=group,
                device=_mesh_device(device))


def make_block_mesh(shape: Tuple[int, int], group=None,
                    axes: Tuple[str, str] = ("row", "col"),
                    device=None) -> Mesh:
    """2D mesh: block partitioning. ``shape = (D_row, D_col)`` lays the
    group's ranks out row-major; array axis 0 is split over ``axes[0]``
    and axis 1 over ``axes[1]``. Each rank makes the process groups of its
    own row and column lines."""
    _require_dist()
    ranks = _group_ranks(group)
    shape = (int(shape[0]), int(shape[1]))
    if math.prod(shape) != len(ranks):
        raise ValueError(f"mesh shape {shape} needs {math.prod(shape)} "
                         f"ranks, the group has {len(ranks)}")
    r, c = divmod(dist.get_rank(group), shape[1])
    lines = ([ranks[i * shape[1] + c] for i in range(shape[0])],
             [ranks[r * shape[1] + j] for j in range(shape[1])])
    groups = tuple(group if len(line) == len(ranks)
                   else dist.new_group(line, use_local_synchronization=True)
                   for line in lines)
    return Mesh(axis_names=tuple(axes), shape=shape, coords=(r, c),
                ranks=ranks, axis_groups=groups, group=group,
                device=_mesh_device(device))


@dataclasses.dataclass(frozen=True)
class Decomp:
    """Which array axes are sharded over which mesh axes.

    ``axes`` maps array axis -> (mesh axis name, ranks along it); array
    axes are a prefix 0..len(axes)-1. ``mesh`` is the mesh the exchanges
    and collectives run on (JAX reads it from the shard_map context).
    """

    ndim: int
    axes: Tuple[Tuple[int, str, int], ...]
    mesh: Optional[Mesh] = None

    @property
    def mesh_axes(self) -> Tuple[str, ...]:
        return tuple(ma for _, ma, _ in self.axes)

    def info(self, arr_axis: int) -> Optional[Tuple[str, int]]:
        for a, ma, nd in self.axes:
            if a == arr_axis:
                return ma, nd
        return None


def decomp_from_mesh(mesh: Mesh, ndim: int) -> Decomp:
    """Shard the leading array axes over the mesh axes, in order."""
    names = mesh.axis_names
    if len(names) > ndim:
        raise ValueError(f"mesh has {len(names)} axes but the grid only "
                         f"{ndim}: at most one mesh axis per grid axis")
    return Decomp(ndim=ndim,
                  axes=tuple((a, names[a], int(mesh.shape[a]))
                             for a in range(len(names))),
                  mesh=mesh)


# ---------------------------------------------------------------------------
# Halo exchange and the owned-tile stencils
# ---------------------------------------------------------------------------

def _swap(to_upper, to_lower, mesh: Mesh, mesh_axis: str):
    """(near, far) along one mesh axis: near is the lower neighbour's
    ``to_upper`` slab (JAX's ppermute with _perm_down), far the upper
    neighbour's ``to_lower`` (_perm_up); zeros where there is no neighbour.
    Either slab may be None (not sent; None returned for it)."""
    lo, hi = mesh.neighbor(mesh_axis, -1), mesh.neighbor(mesh_axis, 1)
    near = None if to_upper is None else torch.zeros_like(
        to_upper, memory_format=torch.contiguous_format)
    far = None if to_lower is None else torch.zeros_like(
        to_lower, memory_format=torch.contiguous_format)
    ops = []
    if to_upper is not None:
        if hi is not None:
            ops.append(dist.P2POp(dist.isend, to_upper.contiguous(), hi))
        if lo is not None:
            ops.append(dist.P2POp(dist.irecv, near, lo))
    if to_lower is not None:
        if lo is not None:
            ops.append(dist.P2POp(dist.isend, to_lower.contiguous(), lo))
        if hi is not None:
            ops.append(dist.P2POp(dist.irecv, far, hi))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return near, far


def _pad_axes(x: torch.Tensor, widths) -> torch.Tensor:
    """Zero-pad axis a of x by widths[a] = (before, after)."""
    pads = []
    for lo, hi in reversed(widths):
        pads += [lo, hi]
    return F.pad(x, pads)


def _halo_extend_axis(u: torch.Tensor, arr_axis: int, mesh: Mesh,
                      mesh_axis: str) -> torch.Tensor:
    """Extend one array axis by its neighbours' edge slabs: m -> m+2; edge
    ranks receive zeros, the Dirichlet ghosts."""
    v = u.movedim(arr_axis, 0)
    near, far = _swap(v[-1:], v[:1], mesh, mesh_axis)
    return torch.cat([near, v, far], dim=0).movedim(0, arr_axis)


def halo_extend(u: torch.Tensor, mesh: Mesh, axis: str = "row"):
    """(m, ...) owned tile -> (m+2, ...) with neighbour halos on axis 0."""
    return _halo_extend_axis(u, 0, mesh, axis)


def _neighbor_sum(ext: torch.Tensor) -> torch.Tensor:
    """Sum of the 2*ndim face neighbours at every core point of a (locally)
    padded tile."""
    nd = ext.ndim
    out = None
    for a in range(nd):
        lo = tuple(slice(0, -2) if i == a else slice(1, -1)
                   for i in range(nd))
        hi = tuple(slice(2, None) if i == a else slice(1, -1)
                   for i in range(nd))
        t = ext[lo] + ext[hi]
        out = t if out is None else out + t
    return out


def _slice_unsharded(x: torch.Tensor, decomp: Decomp) -> torch.Tensor:
    """Take the interior 1:-1 along unsharded (padded) axes only."""
    idx = tuple(slice(None) if decomp.info(a) is not None else slice(1, -1)
                for a in range(x.ndim))
    return x[idx]


def _neighbor_sum_dd(u: torch.Tensor, decomp: Decomp) -> torch.Tensor:
    """Face-neighbour sum of an owned tile: the halo slabs are exchanged,
    the local sum runs with zero edges along sharded axes, and the slabs
    are added to the boundary slices afterwards (JAX's order of additions,
    which it overlaps with the exchange)."""
    nd = u.ndim
    slabs = []
    for a, ma, _ in decomp.axes:
        v = u.movedim(a, 0)
        near, far = _swap(v[-1:], v[:1], decomp.mesh, ma)
        slabs.append((a, near.movedim(0, a), far.movedim(0, a)))
    total = _neighbor_sum(_pad_axes(
        u, [(1, 1) if decomp.info(a) is not None else (0, 0)
            for a in range(nd)]))
    for a, near, far in slabs:
        m = total.shape[a]
        total.narrow(a, 0, 1).add_(_slice_unsharded(near, decomp))
        total.narrow(a, m - 1, 1).add_(_slice_unsharded(far, decomp))
    return total


def _pad_unsharded(x: torch.Tensor, decomp: Decomp) -> torch.Tensor:
    """Re-add the zero ghost ring along unsharded axes only."""
    return _pad_axes(x, [(0, 0) if decomp.info(a) is not None else (1, 1)
                         for a in range(x.ndim)])


def _global_ids(shape, decomp: Decomp, arr_axis: int, device=None):
    """Global padded-grid index of every local entry along one axis,
    broadcastable to ``shape``: d*m + 1 + i along a sharded axis (the near
    ghost 0 is never stored), the local index along an unsharded one."""
    view = [1] * len(shape)
    view[arr_axis] = shape[arr_axis]
    ids = torch.arange(shape[arr_axis], device=device).view(view)
    info = decomp.info(arr_axis)
    if info is not None:
        ids = ids + decomp.mesh.coord(info[0]) * shape[arr_axis] + 1
    return ids


def _interior_mask(n: int, shape, decomp: Decomp, device=None):
    mask = None
    for a in range(len(shape)):
        ids = _global_ids(shape, decomp, a, device)
        if decomp.info(a) is not None:
            cond = ids <= n          # ids >= 1 always on sharded axes
        else:
            cond = (ids >= 1) & (ids <= n)
        mask = cond if mask is None else mask & cond
    return mask


def _coord_sum(shape, decomp: Decomp, device=None):
    """Sum of global coordinates: the red/black colour of each point."""
    s = None
    for a in range(len(shape)):
        ids = _global_ids(shape, decomp, a, device)
        s = ids if s is None else s + ids
    return s


def s_residual(u, b, n, h, decomp: Decomp, sigma=0.0,
               use_kernels: bool = False):
    """r = b - (A - sigma I) u on owned tiles (one halo exchange round per
    axis)."""
    if use_kernels and _local_kernel_ok(u, n, "rbgs", decomp):
        return _s_residual_kernel(u, b, n, h, decomp, sigma)
    if use_kernels and _slab3d_ok(u, n, "rbgs", decomp, 1):
        return _s_residual_slab3d(u, b, n, h, decomp, sigma)
    nbr = _neighbor_sum_dd(u, decomp)
    ctr = _slice_unsharded(u, decomp)
    inv_h2 = 1.0 / (h * h)
    au = (2.0 * decomp.ndim * ctr - nbr) * inv_h2
    r = _slice_unsharded(b, decomp) - au + sigma * ctr
    return torch.where(_interior_mask(n, u.shape, decomp, u.device),
                       _pad_unsharded(r, decomp), torch.zeros_like(u))


def s_jacobi(u, b, n, h, omega, decomp: Decomp, sigma=0.0):
    r = s_residual(u, b, n, h, decomp, sigma)
    d = laplacian.diag_value(decomp.ndim, h, sigma)
    return u + (omega / d) * r


def s_rbgs(u, b, n, h, decomp: Decomp, sigma=0.0):
    """One full RB-GS sweep, equal to the single-device sweep: the halos
    are exchanged again between the red and black half-sweeps."""
    h2 = h * h
    den = 2.0 * decomp.ndim - sigma * h2
    colors = _coord_sum(u.shape, decomp, u.device) % 2
    imask = _interior_mask(n, u.shape, decomp, u.device)
    bcore = _slice_unsharded(b, decomp)
    for parity in (0, 1):
        vals = _pad_unsharded(
            (h2 * bcore + _neighbor_sum_dd(u, decomp)) / den, decomp)
        u = torch.where(imask & (colors == parity), vals, u)
    return u


def s_smooth(u, b, n, h, *, kind, omega, sweeps, decomp: Decomp, sigma=0.0,
             use_kernels: bool = False):
    if kind == "chebyshev":
        # Residual applies and elementwise updates only, so sharded ==
        # unsharded exactly.
        diag = laplacian.diag_value(decomp.ndim, h, sigma)
        return smoothers.chebyshev_generic(
            u, b, sweeps, diag,
            lambda uu, bb: s_residual(uu, bb, n, h, decomp, sigma,
                                      use_kernels=use_kernels))
    if use_kernels and _local_kernel_ok(u, n, kind, decomp):
        return _s_smooth_kernel(u, b, n, h, kind=kind, omega=omega,
                                sweeps=sweeps, decomp=decomp, sigma=sigma)
    if use_kernels and _slab3d_ok(u, n, kind, decomp,
                                  _slab3d_hz(kind, sweeps)):
        return _s_smooth_slab3d(u, b, n, h, kind=kind, omega=omega,
                                sweeps=sweeps, decomp=decomp, sigma=sigma)
    for _ in range(sweeps):
        if kind == "jacobi":
            u = s_jacobi(u, b, n, h, omega, decomp, sigma)
        elif kind == "rbgs":
            u = s_rbgs(u, b, n, h, decomp, sigma)
        else:
            raise ValueError(f"unknown smoother {kind!r}")
    return u


def s_restrict(r, n, decomp: Decomp):
    """Full weighting to the coarse owned tile, one separable pass per axis.
    Along a sharded axis coarse entry q reads fine entries 2q+1..2q+3, so
    only the far halo (the upper neighbour's first entry) is exchanged."""
    nc = (n - 1) // 2
    for a in transfer._axis_order(r.ndim):
        info = decomp.info(a)
        if info is None:
            r = transfer._restrict_axis(r, a)
            continue
        v = r.movedim(a, 0)
        m = v.shape[0]
        mc = m // 2
        _, far = _swap(None, v[:1], decomp.mesh, info[0])
        third = _pad_axes(v[2::2], [(0, 1)] + [(0, 0)] * (v.ndim - 1))
        w = 0.25 * (v[0:m - 1:2] + 2.0 * v[1:m:2] + third)
        w[mc - 1:mc] += 0.25 * far
        r = w.movedim(0, a)
    mask = _interior_mask(nc, r.shape, decomp, r.device)
    return torch.where(mask, r, torch.zeros_like(r)).contiguous()


def s_prolong(e, nc, decomp: Decomp):
    """Linear interpolation to the fine owned tile, one separable pass per
    axis. Along a sharded axis fine entry 0 (global odd) averages coarse
    entries on both sides of the boundary, so only the near halo is
    exchanged."""
    n = 2 * nc + 1
    for a in transfer._axis_order(e.ndim):
        info = decomp.info(a)
        if info is None:
            e = transfer._prolong_axis(e, a)
            continue
        v = e.movedim(a, 0)
        mc = v.shape[0]
        near, _ = _swap(v[-1:], None, decomp.mesh, info[0])
        prev = _pad_axes(v[:mc - 1], [(1, 0)] + [(0, 0)] * (v.ndim - 1))
        odd_f = 0.5 * (prev + v)                   # fine i = 0, 2, ...
        odd_f[0:1] += 0.5 * near
        out = torch.stack([odd_f, v], dim=1).reshape((2 * mc,) + v.shape[1:])
        e = out.movedim(0, a)
    mask = _interior_mask(n, e.shape, decomp, e.device)
    return torch.where(mask, e, torch.zeros_like(e)).contiguous()


def _psum(s: torch.Tensor, decomp: Decomp) -> torch.Tensor:
    """Sum of a fresh tensor over every rank, in place."""
    dist.all_reduce(s, group=decomp.mesh.group)
    return s


def _psum_sq(x, decomp: Decomp) -> torch.Tensor:
    """Sum of squares over every rank's tile (a 0-d tensor)."""
    return _psum(torch.sum(x * x), decomp)


def _rows(v: torch.Tensor) -> torch.Tensor:
    """A block of owned tiles (k, *tile) as (k, tile size) rows; the zero
    ghosts a tile holds (the far ghost, the unsharded padding) add
    nothing to a dot."""
    return v.reshape(v.shape[0], -1)


# ---------------------------------------------------------------------------
# The local2d kernel tier on extended tiles
# ---------------------------------------------------------------------------

def _local_kernel_ok(u, n, kind, decomp: Decomp) -> bool:
    """The local2d sweeps and residual serve this owned tile: 2D, RB-GS or
    Jacobi, n >= kernels.KERNEL_MIN_N, and every sharded axis deep enough
    (and even) to hold the HALO_ROWS-deep exchanged halo."""
    from .. import kernels
    from ..kernels.local2d import HALO_ROWS

    if not (u.ndim == 2 and kind in ("rbgs", "jacobi")
            and n >= kernels.KERNEL_MIN_N):
        return False
    for a, _, _ in decomp.axes:
        if u.shape[a] < HALO_ROWS or u.shape[a] % 2 != 0:
            return False
    return True


def _ext_tile(u, decomp: Decomp, hh: int):
    """Extend an owned tile by hh ghost entries on every sharded axis, rows
    first, then columns: the column slabs then carry the row ghosts, so the
    corner ghosts arrive without diagonal exchanges. Each axis is one cat
    along it (a cat of moved views would copy the tile twice more)."""
    for a, ma, _ in decomp.axes:
        m = u.shape[a]
        near, far = _swap(u.narrow(a, max(m - hh, 0), min(hh, m)),
                          u.narrow(a, 0, min(hh, m)), decomp.mesh, ma)
        u = torch.cat([near, u, far], dim=a)
    return u.contiguous()


def _refresh_ext(ue, decomp: Decomp, hh: int, ms):
    """Exchange the ghost slabs of an extended tile again, in place (after
    a kernel the owned region is exact and the ghosts are stale), rows
    first, then columns; ``ms``: owned extent per sharded axis. Returns
    ``ue``.

    A colour-packed tile (rank 3, ``kernels/plocal2d.py``) refreshes the
    same way: row slabs move on the plane axis + 1, column slabs are hh/2
    lanes of both planes (hh unpacked columns; a column neighbour's tile is
    mcol columns on, mcol even, so its packing phase is the same)."""
    if ue.ndim == 3:
        spans = [(1, hh, m) if a == 0 else (2, hh // 2, m // 2)
                 for (a, _, _), m in zip(decomp.axes, ms)]
    else:
        spans = [(a, hh, m) for (a, _, _), m in zip(decomp.axes, ms)]
    return _refresh_spans(ue, decomp, spans)


def _refresh_spans(ue, decomp: Decomp, spans):
    """Exchange ghost slabs in place along each sharded axis in turn;
    ``spans``: per mesh axis (array axis, ghost depth, owned extent)."""
    for (_, ma, _), (axis, hloc, mloc) in zip(decomp.axes, spans):
        v = ue.movedim(axis, 0)
        near, far = _swap(v[mloc:hloc + mloc], v[hloc:2 * hloc], decomp.mesh,
                          ma)
        v[0:hloc] = near
        v[hloc + mloc:2 * hloc + mloc] = far
    return ue


def _pack_level_ok(cfg: SolverConfig, decomp: Decomp, level: int) -> bool:
    """The level's extended tiles live colour-packed and run the plocal2d
    legs: the finest level, n >= kernels.PACK_MIN_N, on the whole-leg route.
    Exactly one level packs: the packed down leg emits its coarse
    right-hand side unpacked."""
    from .. import kernels

    return (level == 0 and 2 ** cfg.k - 1 >= kernels.PACK_MIN_N
            and _leg_level_ok(cfg, decomp, level))


def _cpar(decomp: Decomp) -> int:
    """Parity of a tile's global column offset, the packing phase
    (``plocal2d.pack_ext``): 0 when the columns carry the global padding
    (rows), 1 when they are sharded (col_off = d*mcol + 1 - hh, odd)."""
    return 1 if len(decomp.axes) == 2 else 0


def _packed_owned(decomp: Decomp, ms):
    """Owned slices of a packed extended tile: rows [hh, hh + m); all lanes
    on a row decomposition (the kernels zero the non-interior ones), the
    owned lanes [hh/2, hh/2 + mcol/2) on a block one."""
    from ..kernels.local2d import HALO_ROWS as hh

    lanes = (slice(hh // 2, hh // 2 + ms[1] // 2) if len(ms) == 2
             else slice(None))
    return (slice(None), slice(hh, hh + ms[0]), lanes)


class _Carried:
    """The tiles the solve loops, sharded PCG and ``v_cycles_fn`` carry on
    the whole-leg route: extended tiles, colour-packed when the fine level
    packs (``_pack_level_ok``), entered once and left once (JAX's
    ``_ext_aligned`` and ``pack_ext`` at a loop's start, ``unpack_ext`` and
    the owned slice at its end). ``x``: an owned fine tile."""

    def __init__(self, cfg: SolverConfig, decomp: Decomp, x):
        from ..kernels.local2d import HALO_ROWS

        self.decomp = decomp
        self.hh = HALO_ROWS
        self.packed = _pack_level_ok(cfg, decomp, 0)
        self.ms = tuple(x.shape[a] for a, _, _ in decomp.axes)
        self.mcol = self.ms[1] if len(self.ms) == 2 else 0
        self.row_off, self.col_off, self.owned = _local_offsets(
            x, decomp, self.hh)
        self.cols = self.mcol + 2 * self.hh if self.mcol else x.shape[1]
        self.cpar = _cpar(decomp)
        # The owned points of a carried tile (dots and norms).
        self.owned_carried = (_packed_owned(decomp, self.ms) if self.packed
                              else self.owned)

    def enter(self, t):
        from ..kernels import plocal2d

        e = _ext_tile(t, self.decomp, self.hh)
        return plocal2d.pack_ext(e, self.cpar) if self.packed else e

    def leave(self, e):
        from ..kernels import plocal2d

        if self.packed:
            e = plocal2d.unpack_ext(e, self.cols, self.cpar)
        return e[self.owned].contiguous()

    def refresh(self, e):
        return _refresh_ext(e, self.decomp, self.hh, self.ms)

    def residual(self, xe, be, n, h, sigma=0.0):
        """b - (A - sigma I) x on a refreshed carried tile (its layout's
        kernel)."""
        from ..kernels import local2d, plocal2d

        legs = plocal2d if self.packed else local2d
        return legs.residual(xe, be, n, h, self.row_off, self.col_off,
                             sigma=sigma)

    def residual_norm_sq(self, xe, be, n, h, red_only=False):
        """||b - A x||^2 over this rank's owned points of a refreshed
        carried tile: the fused norm on a packed tile (``red_only`` right
        after an RB-GS cycle), the residual and a sum otherwise."""
        from ..kernels import plocal2d

        if self.packed:
            return plocal2d.residual_norm_sq(
                xe, be, n, h, self.ms[0], self.row_off, self.col_off,
                mcol=self.mcol, red_only=red_only)
        ro = self.residual(xe, be, n, h)[self.owned]
        return torch.sum(ro * ro)


def _ext_coarse_tile(ec, decomp: Decomp, hh: int):
    """HALO_ROWS-extend an owned coarse tile on every sharded axis into the
    extended convention of ``local2d.up_leg``. A tile shallower than the
    halo (mc < hh) would need entries of ranks two hops away: those ghosts
    are zero instead (at ghost depth > mc on both sides), which the up
    leg's staleness budget allows (``local2d.max_up_sweeps``)."""
    for a, ma, _ in decomp.axes:
        v = ec.movedim(a, 0)
        hc = min(hh, v.shape[0])
        near, far = _swap(v[-hc:], v[:hc], decomp.mesh, ma)
        zpad = torch.zeros((hh - hc,) + v.shape[1:], dtype=v.dtype,
                           device=v.device)
        ec = torch.cat([zpad, near, v, far, zpad], dim=0).movedim(0, a)
    return ec.contiguous()


def _slice_coarse_ext(full, decomp: Decomp, hh: int):
    """Replicated full padded coarse grid -> this rank's extended coarse
    tile, a local slice (zeros past the grid's ends, the Dirichlet ghosts):
    the agglomeration-crossing twin of ``_ext_coarse_tile``."""
    for a, ma, nd in decomp.axes:
        mc = (full.shape[a] - 1) // nd
        d = decomp.mesh.coord(ma)
        padded = _pad_axes(full, [(hh, hh) if i == a else (0, 0)
                                  for i in range(full.ndim)])
        full = padded.narrow(a, d * mc + 1, mc + 2 * hh)
    return full.contiguous()


def _local_offsets(u, decomp: Decomp, hh: int):
    """(row_off, col_off, owned slices) of the extended tile of owned tile
    u: along a sharded axis owned entry 0 is global d*m + 1 and the ghosts
    shift it by hh; along an unsharded one the local index is global."""
    offs, sls = [], []
    for a in range(2):
        info = decomp.info(a)
        m = u.shape[a]
        if info is not None:
            offs.append(decomp.mesh.coord(info[0]) * m + 1 - hh)
            sls.append(slice(hh, hh + m))
        else:
            offs.append(0)
            sls.append(slice(0, m))
    return offs[0], offs[1], tuple(sls)


def _s_smooth_kernel(u, b, n, h, *, kind, omega, sweeps, decomp: Decomp,
                     sigma=0.0):
    """Smoothing by the local2d sweep kernel: one exchange of HALO_ROWS
    ghost entries a launch, up to max_fused_sweeps(kind) sweeps a launch
    (the ghosts recompute, so the owned entries equal the global sweep)."""
    from ..kernels import local2d

    hh = local2d.HALO_ROWS
    row_off, col_off, owned = _local_offsets(u, decomp, hh)
    while sweeps > 0:
        s = min(sweeps, local2d.max_fused_sweeps(kind))
        ue = _ext_tile(u, decomp, hh)
        be = _ext_tile(b, decomp, hh)
        if kind == "rbgs":
            out = local2d.rbgs_sweep(ue, be, n, h, row_off, col_off,
                                     sigma=sigma, sweeps=s)
        else:
            out = local2d.jacobi_sweep(ue, be, n, h, omega, row_off,
                                       col_off, sigma=sigma, sweeps=s)
        u = out[owned]
        sweeps -= s
    return u


def _s_residual_kernel(u, b, n, h, decomp: Decomp, sigma=0.0):
    """The local2d residual (a 1-deep halo would do; the HALO_ROWS-deep
    exchange keeps one tile layout)."""
    from ..kernels import local2d

    hh = local2d.HALO_ROWS
    row_off, col_off, owned = _local_offsets(u, decomp, hh)
    out = local2d.residual(_ext_tile(u, decomp, hh), _ext_tile(b, decomp, hh),
                           n, h, row_off, col_off, sigma=sigma)
    return out[owned]


def _s_smooth_residual_kernel(u, b, n, h, *, kind, omega, sweeps,
                              decomp: Decomp, sigma=0.0):
    """Down-leg pair (smooth^sweeps, residual) from one exchange: after s
    sweeps the ghosts are exact to depth HALO_ROWS - 2s (RB-GS) or - s
    (Jacobi), enough for the residual while that stays >= 1. Returns
    (u_smoothed, r), owned tiles."""
    from ..kernels import local2d

    hh = local2d.HALO_ROWS
    row_off, col_off, owned = _local_offsets(u, decomp, hh)
    ue = _ext_tile(u, decomp, hh)
    be = _ext_tile(b, decomp, hh)
    if kind == "rbgs":
        us = local2d.rbgs_sweep(ue, be, n, h, row_off, col_off, sigma=sigma,
                                sweeps=sweeps)
    else:
        us = local2d.jacobi_sweep(ue, be, n, h, omega, row_off, col_off,
                                  sigma=sigma, sweeps=sweeps)
    r = local2d.residual(us, be, n, h, row_off, col_off, sigma=sigma)
    return us[owned], r[owned]


# ---------------------------------------------------------------------------
# The stencil3d kernel tier on slab and pencil stacks
# ---------------------------------------------------------------------------
#
# A 3D tile extended by hz ghost planes (and, on a pencil mesh, hz ghost
# rows) is a plane stack of the stencil3d kernels: (m0 + 2 hz, n + 2, n + 2)
# on a slab mesh, (m0 + 2 hz, m1 + 2 hz, n + 2) on a pencil mesh, whose plane
# 0 is global plane goff = d0 m0 + 1 - hz and row 0 global row roff = d1 m1
# + 1 - hz (0 on slabs). The kernels leave the stack's edge planes and rows
# alone (zero the planes), so each chained sweep makes 2 ghost planes and
# rows a side stale (RB-GS: red reads +-1 around black's +-1), 1 for
# Jacobi; hz covers that, and the owned points come out as the global
# sweep's. JAX pads its stacks to its TPU layout (planes to 4, rows to 8,
# columns to 128); the port's kernels take the stack as it is.

def _slab3d_hz(kind: str, sweeps: int) -> int:
    """Ghost planes a side that ``sweeps`` chained sweeps make stale."""
    return 2 * sweeps if kind == "rbgs" else sweeps


def _slab3d_hz_level(cfg: SolverConfig) -> int:
    """Ghost planes (and pencil rows) of one extended-stack level visit:
    the down smoothing's staleness and one more plane for the residual,
    or the up smoothing's."""
    if cfg.smoother == "rbgs":
        return max(2 * cfg.nu1 + 1, 2 * cfg.nu2)
    return max(cfg.nu1 + 1, cfg.nu2)


def _slab3d_ok(u, n: int, kind: str, decomp: Decomp, hz: int) -> bool:
    """The stencil3d kernels serve this owned tile on a slab mesh with an
    hz-plane halo: 3D, planes sharded alone, RB-GS or Jacobi, n >=
    kernels.KERNEL3_MIN_N (read when called), the tile at least max(hz, 3)
    planes deep. JAX's gate also asks its TPU kernel's VMEM budget, which
    picks an implementation, not the arithmetic; the port has none."""
    from .. import kernels

    return (decomp.ndim == 3 and len(decomp.axes) == 1
            and decomp.axes[0][0] == 0 and kind in ("rbgs", "jacobi")
            and n >= kernels.KERNEL3_MIN_N and u.shape[0] >= max(hz, 3))


def _pencil3d_ok(u, n: int, cfg: SolverConfig, decomp: Decomp) -> bool:
    """The extended-stack level serves this owned tile on a pencil mesh:
    planes and rows sharded, RB-GS or Jacobi, n >= KERNEL3_MIN_N, the tile
    at least max(hz, 3) planes and hz rows deep (hz = _slab3d_hz_level)."""
    from .. import kernels

    if not (decomp.ndim == 3 and len(decomp.axes) == 2
            and decomp.axes[0][0] == 0 and decomp.axes[1][0] == 1
            and cfg.smoother in ("rbgs", "jacobi")
            and n >= kernels.KERNEL3_MIN_N):
        return False
    hz = _slab3d_hz_level(cfg)
    return u.shape[0] >= max(hz, 3) and u.shape[1] >= hz


def _stack_sweeps(kind, xe, be, n, h, omega, sigma, sweeps, goff, roff):
    """``sweeps`` stencil3d sweeps of ``kind`` on a plane stack."""
    from ..kernels import stencil3d

    if kind == "rbgs":
        return stencil3d.rbgs_sweep(xe, be, n, h, sigma=sigma, sweeps=sweeps,
                                    goff=goff, roff=roff)
    return stencil3d.jacobi_sweep(xe, be, n, h, omega, sigma=sigma,
                                  sweeps=sweeps, goff=goff, roff=roff)


def _s_smooth_slab3d(u, b, n, h, *, kind, omega, sweeps, decomp: Decomp,
                     sigma=0.0):
    """Slab smoothing by the stencil3d sweeps: one exchange of hz =
    _slab3d_hz(kind, sweeps) ghost planes, all sweeps on the stack, the
    owned planes back. (With no sweeps, u as it is: JAX's hz = 0 stack
    would take whole neighbour tiles.)"""
    if sweeps == 0:
        return u
    hz = _slab3d_hz(kind, sweeps)
    goff, _, owned = _local_offsets(u, decomp, hz)
    out = _stack_sweeps(kind, _ext_tile(u, decomp, hz),
                        _ext_tile(b, decomp, hz), n, h, omega, sigma, sweeps,
                        goff, 0)
    return out[owned].contiguous()


def _s_residual_slab3d(u, b, n, h, decomp: Decomp, sigma=0.0):
    """The slab residual by the stencil3d kernel on a 1-plane halo."""
    from ..kernels import stencil3d

    goff, _, owned = _local_offsets(u, decomp, 1)
    out = stencil3d.residual(_ext_tile(u, decomp, 1), _ext_tile(b, decomp, 1),
                             n, h, sigma=sigma, goff=goff)
    return out[owned].contiguous()


def _s_smooth_residual_slab3d(u, b, n, h, *, kind, omega, sweeps,
                              decomp: Decomp, sigma=0.0):
    """Down-leg pair (smooth^sweeps, residual) on one slab stack: one ghost
    plane past the smoothing's staleness, so the residual on the smoothed
    stack reads exact ghosts. Returns (u_smoothed, r), owned tiles."""
    from ..kernels import stencil3d

    hz = _slab3d_hz(kind, sweeps) + 1
    goff, _, owned = _local_offsets(u, decomp, hz)
    be = _ext_tile(b, decomp, hz)
    us = _stack_sweeps(kind, _ext_tile(u, decomp, hz), be, n, h, omega,
                       sigma, sweeps, goff, 0)
    r = stencil3d.residual(us, be, n, h, sigma=sigma, goff=goff)
    return us[owned].contiguous(), r[owned].contiguous()


def _slab3d_level(hier: Hierarchy, cfg: SolverConfig, decomp: Decomp, x, b,
                  level: int, gamma: int, sigma, cfg_repl):
    """One cycle level on a slab or pencil mesh with the extended stacks
    of x and b built once a visit: the down smoothing, the residual on the
    same stack, the plain restriction of its owned points, the coarse
    correction added in place, a ghost refresh (planes, then rows: the row
    slabs carry the refreshed plane ghosts, the corners), the up
    smoothing. Owned tiles in and out; the owned points equal the
    stagewise route's. A bfloat16 stack (the top of a mixed cycle) runs
    the kernels' bfloat16 modes down to its residual, which is float32, so
    the levels below run in float32; the correction add promotes x and b
    to float32, as the single-device ``x + P e`` does, and the up smoothing
    runs the float32 kernels. (JAX's level adds the correction in
    bfloat16 and stores only the last up sweep in float32: the mixed
    PCG's first step then makes the residual grow, ROADMAP.md queue 3,
    F7, which the port does not copy.)"""
    from ..kernels import stencil3d

    spec = hier.levels[level]
    n, h = spec.n, spec.h
    omega = cfg.effective_omega()
    hz = _slab3d_hz_level(cfg)
    goff, roff, owned = _local_offsets(x, decomp, hz)
    spans = [(a, hz, x.shape[a]) for a, _, _ in decomp.axes]
    xe, be = _ext_tile(x, decomp, hz), _ext_tile(b, decomp, hz)
    xe = _stack_sweeps(cfg.smoother, xe, be, n, h, omega, sigma, cfg.nu1,
                       goff, roff)
    r = stencil3d.residual(xe, be, n, h, sigma=sigma, goff=goff, roff=roff)
    rc = s_restrict(r[owned].contiguous(), n, decomp)
    del r
    corr = _coarse_correction(hier, cfg, decomp, rc, level, gamma, sigma,
                              cfg_repl)
    if xe.dtype != corr.dtype:
        xe, be = xe.to(corr.dtype), be.to(corr.dtype)
    xe[owned] += corr
    _refresh_spans(xe, decomp, spans)
    xe = _stack_sweeps(cfg.smoother, xe, be, n, h, omega, sigma, cfg.nu2,
                       goff, roff)
    return xe[owned].contiguous()


# ---------------------------------------------------------------------------
# The sharded cycle: sharded fine levels, agglomerated coarse levels
# ---------------------------------------------------------------------------

def _level_rows(k: int, level: int) -> int:
    """Sharded entry count (interior + far ghost) at a level: 2^(k-level)."""
    return 2 ** (k - level)


def _is_sharded(cfg: SolverConfig, decomp: Decomp, level: int) -> bool:
    # The coarsest level is always replicated (its direct solve runs on
    # every rank).
    if level >= len(cfg.level_sizes()) - 1:
        return False
    rows = _level_rows(cfg.k, level)
    for _, _, nd in decomp.axes:
        if rows % nd != 0 or rows // nd < max(cfg.agglom_rows, 2):
            return False
    return True


def _gather_full(u_local, decomp: Decomp):
    """Owned tiles -> the full padded grid on every rank (agglomeration):
    an all_gather along each mesh axis, rows then columns, then the near
    ghosts put back."""
    for a, ma, nd in decomp.axes:
        parts = [torch.empty_like(u_local) for _ in range(nd)]
        dist.all_gather(parts, u_local.contiguous(),
                        group=decomp.mesh.axis_group(ma))
        u_local = torch.cat(parts, dim=a)
    return _pad_axes(u_local, [(1, 0) if decomp.info(a) is not None
                               else (0, 0) for a in range(u_local.ndim)])


def _scatter_local(full, decomp: Decomp):
    """Full padded grid -> this rank's owned tile (a local slice)."""
    for a, ma, nd in decomp.axes:
        m = (full.shape[a] - 1) // nd
        full = full.narrow(a, decomp.mesh.coord(ma) * m + 1, m)
    return full.contiguous()


def _leg_level_ok(cfg: SolverConfig, decomp: Decomp, level: int) -> bool:
    """The whole-leg local2d kernels serve this level: 2D row or block
    decomposition, RB-GS or Jacobi within the legs' sweep caps, the level
    sharded, n >= kernels.KERNEL_MIN_N, tiles even and at least HALO_ROWS
    deep along every sharded axis."""
    from .. import kernels
    from ..kernels import local2d

    if not (cfg.use_kernels and cfg.ndim == 2
            and 1 <= len(decomp.axes) <= 2
            and all(decomp.axes[i][0] == i
                    for i in range(len(decomp.axes)))
            and cfg.smoother in ("rbgs", "jacobi")
            and cfg.nu1 <= local2d.max_down_sweeps(cfg.smoother)
            and cfg.nu2 <= local2d.max_up_sweeps(cfg.smoother)
            and level < cfg.k - 1
            and _is_sharded(cfg, decomp, level)):
        return False
    if 2 ** (cfg.k - level) - 1 < kernels.KERNEL_MIN_N:
        return False
    for _, _, nd in decomp.axes:
        ma = _level_rows(cfg.k, level) // nd
        if ma % 2 != 0 or ma < local2d.HALO_ROWS:
            return False
    return True


def _leg_cycle_ext(hier: Hierarchy, cfg: SolverConfig, decomp: Decomp,
                   xe, be, level: int, gamma: int, sigma,
                   fresh: bool = False, out_dtype=None):
    """One cycle level on the whole-leg route, in extended tiles: the down
    leg (smooth^nu1, residual, restrict) and the up leg (prolong, correct,
    smooth^nu2) are one local2d launch each; the down leg emits the coarse
    right-hand side in the extended convention, so a coarse leg level is
    one ghost refresh away, and its up leg's output is this level's
    correction operand. xe and be are unpacked extended tiles, or packed
    ones (rank 3) on a level that packs (``_pack_level_ok``): they run the
    plocal2d legs, whose coarse right-hand side is unpacked, so the levels
    below are the same either way. xe's ghosts may be stale unless
    ``fresh``; they are refreshed in place. Returns the post-smoothed
    extended tile (ghosts stale) in the level's layout. A bfloat16 level
    (the top of a mixed cycle, ``mixed_leg_dtype``) runs the legs'
    bfloat16 modes, its down leg emitting the levels below in float32;
    ``out_dtype`` stores this level's up leg output wider (float32), and
    is not passed on to the coarser levels."""
    from ..kernels import local2d, plocal2d

    hh = local2d.HALO_ROWS
    # The layout is the caller's (the tile's rank): the solve loops pack,
    # the one-cycle entries stay unpacked.
    legs = plocal2d if xe.ndim == 3 else local2d
    spec = hier.levels[level]
    n, h = spec.n, spec.h
    omega = cfg.effective_omega()
    rows = _level_rows(cfg.k, level)
    ax0 = decomp.axes[0]
    m = rows // ax0[2]
    mc = m // 2
    row_off = decomp.mesh.coord(ax0[1]) * m + 1 - hh
    if len(decomp.axes) == 2:
        ax1 = decomp.axes[1]
        mcol = rows // ax1[2]
        col_off = decomp.mesh.coord(ax1[1]) * mcol + 1 - hh
        ms, mcs = (m, mcol), (mc, mcol // 2)
    else:
        mcol, col_off = 0, 0
        ms, mcs = (m,), (mc,)
    if not fresh:
        xe = _refresh_ext(xe, decomp, hh, ms)
    us_ext, rc_ext = legs.down_leg(xe, be, n, h, m, row_off, col_off,
                                   kind=cfg.smoother, omega=omega,
                                   sweeps=cfg.nu1, sigma=sigma, mcol=mcol)
    ncoarse = hier.levels[level + 1].n

    def rc_owned():
        csl = (slice(hh, hh + mcol // 2) if mcol
               else slice(0, ncoarse + 2))
        return rc_ext[hh:hh + mc, csl].contiguous()

    if _leg_level_ok(cfg, decomp, level + 1):
        be_c = _refresh_ext(rc_ext, decomp, hh, mcs)
        ec = torch.zeros_like(be_c)
        for g in range(gamma):
            ec = _leg_cycle_ext(hier, cfg, decomp, ec, be_c, level + 1,
                                gamma, sigma, fresh=(g == 0))
        ee = _refresh_ext(ec, decomp, hh, mcs)
    elif _is_sharded(cfg, decomp, level + 1):
        # Sharded but below the kernel thresholds: owned-tile recursion.
        rc = rc_owned()
        ec = torch.zeros_like(rc)
        for _ in range(gamma):
            ec = _sharded_v_cycle(hier, cfg, decomp, ec, rc, level + 1,
                                  gamma, sigma)
        ee = _ext_coarse_tile(ec, decomp, hh)
    else:
        # Agglomerate: gather the coarse right-hand side, cycle on every
        # rank, and read this rank's extended slice of the result.
        cfg_repl = dataclasses.replace(cfg, use_kernels=False)
        rc_full = _gather_full(rc_owned(), decomp)
        ec_full = torch.zeros_like(rc_full)
        for _ in range(gamma):
            ec_full = cycles.v_cycle(hier, ec_full, rc_full, cfg_repl,
                                     level=level + 1, sigma=sigma,
                                     gamma=gamma)
        ee = _slice_coarse_ext(ec_full, decomp, hh)
    xe2 = _refresh_ext(us_ext, decomp, hh, ms)
    return legs.up_leg(xe2, ee, be, n, ncoarse, h, m, row_off, col_off,
                       kind=cfg.smoother, omega=omega, sweeps=cfg.nu2,
                       sigma=sigma, out_dtype=out_dtype, mcol=mcol)


def mixed_leg_dtype(cfg: SolverConfig, decomp: Decomp):
    """The dtype sharded MG-PCG casts its preconditioning cycle to, or
    None (it runs in ``cfg.dtype``): ``precond_dtype`` where the fine level
    runs the whole-leg kernels (``_leg_level_ok``: 2D rows and blocks,
    tiles at least HALO_ROWS deep), whose tiles widen to float32 in
    registers and whose down legs emit the coarse levels in float32; None
    elsewhere (the owned-tile route, shallow tiles, kernels off), where JAX
    skips the cast too (its ``mixed_leg_dtype``). A dtype the kernels do not
    store raises, as ``krylov.mixed_cycle_dtype`` does."""
    pd = cfg.precond_dtype if cfg.precond_dtype is not None else cfg.dtype
    if pd == cfg.dtype or not _leg_level_ok(cfg, decomp, 0):
        return None
    if pd not in krylov._CYCLE_DTYPES:
        raise NotImplementedError(
            f"sharded MG-PCG with precond_dtype={pd}: the kernels store "
            "bfloat16, float32 or float64 only")
    return pd


def mixed_slab_dtype(cfg: SolverConfig, decomp: Decomp):
    """The 3D twin of ``mixed_leg_dtype``: the dtype sharded MG-PCG casts
    its preconditioning cycle to on a slab or pencil mesh, or None. It is
    ``precond_dtype`` where JAX's ``mixed_slab_dtype`` casts: RB-GS or
    Jacobi with kernels on, the fine level on the stencil3d tier (n >=
    KERNEL3_MIN_N), sharded, its tiles holding the level's ghost budget,
    and JAX's TPU plane ring within its VMEM budget for the stack's plane
    (``krylov._jax_fits_vmem``: n + 2 rows on slabs, m1 + 2 hz on pencils).
    That budget says nothing about the H100; it is kept only so that the
    port casts exactly where JAX casts. A dtype the kernels do not store
    raises, as ``mixed_leg_dtype`` does."""
    from .. import kernels

    pd = cfg.precond_dtype if cfg.precond_dtype is not None else cfg.dtype
    if pd == cfg.dtype:
        return None
    if (cfg.ndim != 3 or not cfg.use_kernels
            or cfg.smoother not in ("rbgs", "jacobi")
            or len(decomp.axes) not in (1, 2)
            or any(decomp.axes[i][0] != i for i in range(len(decomp.axes)))):
        return None
    n = cfg.n
    hz = _slab3d_hz_level(cfg)
    m0 = 2 ** cfg.k // decomp.axes[0][2]
    if (n < kernels.KERNEL3_MIN_N or m0 < max(hz, 3)
            or not _is_sharded(cfg, decomp, 0)):
        return None
    rows = n + 2
    if len(decomp.axes) == 2:
        m1 = 2 ** cfg.k // decomp.axes[1][2]
        if m1 < hz:
            return None
        rows = m1 + 2 * hz
    if not krylov._jax_fits_vmem(rows, n + 2, pd):
        return None
    if pd not in krylov._CYCLE_DTYPES:
        raise NotImplementedError(
            f"sharded MG-PCG with precond_dtype={pd}: the kernels store "
            "bfloat16, float32 or float64 only")
    return pd


def _sharded_v_cycle_leg(hier: Hierarchy, cfg: SolverConfig,
                         decomp: Decomp, x, b, level: int, gamma: int,
                         sigma, out_dtype=None):
    """Owned tiles in and out of the extended whole-leg cycle (an entry for
    one cycle; the solve loop carries extended tiles across cycles).
    ``out_dtype``: the dtype the level's up leg stores (``_leg_cycle_ext``),
    float32 at the top of a mixed cycle."""
    from ..kernels import local2d

    hh = local2d.HALO_ROWS
    _, _, owned = _local_offsets(x, decomp, hh)
    out = _leg_cycle_ext(hier, cfg, decomp, _ext_tile(x, decomp, hh),
                         _ext_tile(b, decomp, hh), level, gamma, sigma,
                         fresh=True, out_dtype=out_dtype)
    return out[owned].contiguous()


def _sharded_v_cycle(hier: Hierarchy, cfg: SolverConfig, decomp: Decomp,
                     x, b, level: int, gamma: int = 1, sigma=0.0,
                     out_dtype=None):
    """Recursive cycle; tiles are owned tiles while the level is sharded
    and full grids on every rank below the agglomeration cutoff. ``sigma``
    shifts the operator to A - sigma I; ``out_dtype`` reaches a whole-leg
    level's up leg (``_sharded_v_cycle_leg``); an extended-stack level
    (``_slab3d_level``) promotes a bfloat16 stack at its correction add
    by itself."""
    from ..kernels.local2d import HALO_ROWS

    spec = hier.levels[level]
    n, h = spec.n, spec.h
    omega = cfg.effective_omega()
    # The replicated region holds full logical grids and is small by
    # construction: it runs the plain backend.
    cfg_repl = (dataclasses.replace(cfg, use_kernels=False)
                if cfg.use_kernels else cfg)
    if not _is_sharded(cfg, decomp, level):
        return cycles.v_cycle(hier, x, b, cfg_repl, level=level,
                              sigma=sigma, gamma=gamma)
    if _leg_level_ok(cfg, decomp, level):
        return _sharded_v_cycle_leg(hier, cfg, decomp, x, b, level, gamma,
                                    sigma, out_dtype=out_dtype)
    # A slab or pencil level whose tiles hold the level's ghost budget:
    # the extended stacks built once a visit.
    kind = cfg.smoother
    if cfg.use_kernels and (
            _slab3d_ok(x, n, kind, decomp, _slab3d_hz_level(cfg))
            or _pencil3d_ok(x, n, cfg, decomp)):
        return _slab3d_level(hier, cfg, decomp, x, b, level, gamma, sigma,
                             cfg_repl)
    # Smooth and residual share one exchange on the kernel tier while the
    # residual's ghost reads stay exact (2 nu1 < HALO_ROWS for RB-GS,
    # nu1 < HALO_ROWS for Jacobi; on slabs one plane past the smoothing's).
    stale = 2 * cfg.nu1 if kind == "rbgs" else cfg.nu1
    if (cfg.use_kernels and _local_kernel_ok(x, n, kind, decomp)
            and stale < HALO_ROWS):
        x, r = _s_smooth_residual_kernel(
            x, b, n, h, kind=kind, omega=omega, sweeps=cfg.nu1,
            decomp=decomp, sigma=sigma)
    elif cfg.use_kernels and _slab3d_ok(x, n, kind, decomp,
                                        _slab3d_hz(kind, cfg.nu1) + 1):
        x, r = _s_smooth_residual_slab3d(
            x, b, n, h, kind=kind, omega=omega, sweeps=cfg.nu1,
            decomp=decomp, sigma=sigma)
    else:
        x = s_smooth(x, b, n, h, kind=cfg.smoother, omega=omega,
                     sweeps=cfg.nu1, decomp=decomp, sigma=sigma,
                     use_kernels=cfg.use_kernels)
        r = s_residual(x, b, n, h, decomp, sigma,
                       use_kernels=cfg.use_kernels)
    rc = s_restrict(r, n, decomp)
    x = x + _coarse_correction(hier, cfg, decomp, rc, level, gamma, sigma,
                               cfg_repl)
    return s_smooth(x, b, n, h, kind=cfg.smoother, omega=omega,
                    sweeps=cfg.nu2, decomp=decomp, sigma=sigma,
                    use_kernels=cfg.use_kernels)


def _coarse_correction(hier, cfg, decomp, rc, level, gamma, sigma,
                       cfg_repl):
    """gamma coarse cycles on the restricted right-hand side, prolonged
    back to this level's owned tile."""
    nc = hier.levels[level + 1].n
    if not _is_sharded(cfg, decomp, level + 1):
        # Agglomerate: gather, cycle on every rank, prolong, keep my tile.
        rc_full = _gather_full(rc, decomp)
        ec_full = torch.zeros_like(rc_full)
        for _ in range(gamma):
            ec_full = cycles.v_cycle(hier, ec_full, rc_full, cfg_repl,
                                     level=level + 1, sigma=sigma,
                                     gamma=gamma)
        return _scatter_local(transfer.prolong(ec_full), decomp)
    ec = torch.zeros_like(rc)
    for _ in range(gamma):
        ec = _sharded_v_cycle(hier, cfg, decomp, ec, rc, level + 1, gamma,
                              sigma)
    return s_prolong(ec, nc, decomp)


def _sharded_fmg(hier: Hierarchy, cfg: SolverConfig, decomp: Decomp, b,
                 gamma: int = 1, n_vcycles: int = 1):
    """Distributed full multigrid: b restricted down the sharded levels
    (halo exchanges), gathered at the agglomeration cutoff, the coarsest
    level solved directly on every rank, and the solution walked back up by
    linear prolongation (scattered into owned tiles where it re-enters the
    sharded levels) with ``n_vcycles`` sharded cycles a level. Owned tiles
    in and out; the per-level cycles take the unpacked routes, as
    ``v_cycle_fn`` does."""
    bs = [b]
    for lev in range(hier.num_levels - 1):
        if _is_sharded(cfg, decomp, lev):
            if _is_sharded(cfg, decomp, lev + 1):
                bs.append(s_restrict(bs[-1], hier.levels[lev].n, decomp))
            else:                     # crossing the agglomeration cutoff
                bs.append(transfer.restrict(_gather_full(bs[-1], decomp)))
        else:
            bs.append(transfer.restrict(bs[-1]))
    # The coarsest level is always replicated (_is_sharded).
    x = cycles.coarse_solve(hier, bs[-1])
    for level in range(hier.num_levels - 2, -1, -1):
        if _is_sharded(cfg, decomp, level):
            if _is_sharded(cfg, decomp, level + 1):
                x = s_prolong(x, hier.levels[level + 1].n, decomp)
            else:                     # re-entering the sharded levels
                x = _scatter_local(transfer.prolong(x), decomp)
        else:
            x = transfer.prolong(x)
        for _ in range(n_vcycles):
            x = _sharded_v_cycle(hier, cfg, decomp, x, bs[level], level,
                                 gamma)
    return x


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def shard_rhs(b_padded, mesh: Mesh, decomp: Optional[Decomp] = None):
    """The full padded grid, which every rank holds, -> this rank's owned
    tile on the mesh's device. Along each sharded axis the near ghost is
    dropped and entries 1..n+1 are split over the ranks; unsharded axes
    keep the full padded extent."""
    b = torch.as_tensor(b_padded)
    if decomp is None:
        decomp = decomp_from_mesh(mesh, b.ndim)
    for a, ma, nd in decomp.axes:
        m = (b.shape[a] - 1) // nd
        b = b.narrow(a, 1 + mesh.coord(ma) * m, m)
    return b.contiguous().to(mesh.device)


def unshard(x_tiles, decomp: Decomp):
    """Owned tiles -> the full padded grid on every rank (near ghosts put
    back)."""
    return _gather_full(x_tiles, decomp)


class ShardedSolver:
    """Distributed V/W-cycle solver: domain-decomposed cycles to tolerance.

    The decomposition follows the mesh: a 1D mesh shards axis 0 (rows, or
    slabs in 3D), a 2D mesh axes 0 and 1 (blocks, or pencils). Every rank
    of the mesh constructs the solver and calls ``solve`` with the same
    full right-hand side.

    >>> mesh = make_mesh()              # rows, after init_process_group
    >>> s = ShardedSolver(SolverConfig(ndim=2, k=11, smoother="rbgs",
    ...                                use_kernels=True), mesh)
    >>> result = s.solve(b_padded)                # the full padded grid
    """

    def __init__(self, config: SolverConfig, mesh: Mesh,
                 hierarchy: Optional[Hierarchy] = None):
        if config.cycle == "fmg" and config.fmg_prolong != "linear":
            # JAX's distributed walk prolongs linearly whatever the config
            # says (ROADMAP.md queue 3, F4); the port does not run another
            # walk than the one asked for.
            raise ValueError(
                f"fmg_prolong={config.fmg_prolong!r}: the sharded FMG walk "
                "is linear only; use fmg_prolong='linear'")
        self.config = config
        self.mesh = mesh
        self.decomp = decomp_from_mesh(mesh, config.ndim)
        for _, ma, nd in self.decomp.axes:
            if (2 ** config.k) % nd != 0:
                raise ValueError(f"2^k must be divisible by the mesh size "
                                 f"along {ma!r} ({nd})")
        if not _is_sharded(config, self.decomp, 0):
            raise ValueError(
                f"fine level would be agglomerated: local tile of "
                f"{_level_rows(config.k, 0)} rows over the mesh is below "
                f"agglom_rows={config.agglom_rows}; raise k, shrink the "
                f"mesh, or lower agglom_rows")
        self.hierarchy = (hierarchy if hierarchy is not None
                          else build_hierarchy(config, device=mesh.device))

    def _solve_mg(self, b, x):
        """The solve loop on owned tiles: one host sync a cycle, as
        ``cycles.solve``; the same norm, guards and history as JAX's
        ``_build_solve``."""
        cfg, hier, decomp = self.config, self.hierarchy, self.decomp
        gamma = 2 if cfg.cycle == "w" else 1
        n, h = hier.fine.n, hier.fine.h
        b_norm = torch.sqrt(_psum_sq(b, decomp))
        b_norm = torch.where(b_norm == 0, torch.ones_like(b_norm), b_norm)
        tiles = None
        if _leg_level_ok(cfg, decomp, 0):
            # Extended tiles (colour-packed if the fine level packs)
            # carried across cycles: b's is built once, and the check runs
            # on the refreshed tile the next cycle takes.
            tiles = _Carried(cfg, decomp, x)
            be = tiles.enter(b)
            x = tiles.enter(x)

            def res_rel(xe, red_only=False):
                nrm2 = tiles.residual_norm_sq(xe, be, n, h, red_only)
                return torch.sqrt(_psum(nrm2, decomp)) / b_norm

            def one_cycle(xe):
                xe = _leg_cycle_ext(hier, cfg, decomp, xe, be, 0, gamma,
                                    0.0, fresh=True)
                return tiles.refresh(xe)
        else:
            def res_rel(xx, red_only=False):
                r = s_residual(xx, b, n, h, decomp,
                               use_kernels=cfg.use_kernels)
                return torch.sqrt(_psum_sq(r, decomp)) / b_norm

            def one_cycle(xx):
                return _sharded_v_cycle(hier, cfg, decomp, xx, b, 0, gamma)

        # After a cycle the closing black half-sweep of RB-GS zeroes the
        # black residual: the packed check sums the red points only.
        post_red = cfg.smoother == "rbgs" and cfg.nu2 >= 1
        hist = [res_rel(x)]
        rel = hist[0].item()                       # host sync
        stall = div = 0
        while (rel >= cfg.tol and len(hist) <= cfg.max_iters
               and cycles.guards_ok(stall, div)):
            x = one_cycle(x)
            hist.append(res_rel(x, red_only=post_red))
            new_rel = hist[-1].item()              # host sync, once a cycle
            stall, div = cycles.step_guards(new_rel, rel, stall, div)
            rel = new_rel
        iters = len(hist) - 1
        # Entries past `iters` repeat the final residual.
        hist += [hist[-1]] * (cfg.max_iters - iters)
        if tiles is not None:
            x = tiles.leave(x)
        return x, iters, torch.stack(hist), rel < cfg.tol

    def _solve_pcg(self, b, x0):
        """Sharded MG-PCG (JAX's ``_build_pcg``): ``krylov.cg_loop`` with
        one sharded cycle from zero as the preconditioner and every dot
        summed over the mesh. On the whole-leg route the whole recurrence
        runs on carried tiles (colour-packed when the fine level packs):
        linear combinations keep exact ghosts, each kernel refreshes its
        operand's ghost slabs first, and dots sum the owned points only.
        The apply is ``plocal2d.apply_op`` on a packed tile, -residual(p,
        0) on an unpacked one (the local2d kernel, or ``s_residual`` on
        owned tiles). Mixed precision (``mixed_leg_dtype`` in 2D,
        ``mixed_slab_dtype`` in 3D): the (refreshed) residual is cast to
        the preconditioner's dtype, the cycle stores its top level in
        float32 (in 2D JAX's ``out_dtype``, the repair of the final
        bfloat16 store's noise; in 3D the correction add promotes) and z is
        cast back; nothing else changes dtype."""
        from ..kernels import _wrap
        from ..solvers.krylov import cg_loop

        cfg, hier, decomp = self.config, self.hierarchy, self.decomp
        gamma = 2 if cfg.cycle == "w" else 1
        n, h = hier.fine.n, hier.fine.h
        pd = mixed_leg_dtype(cfg, decomp)
        if _leg_level_ok(cfg, decomp, 0):
            from ..kernels import plocal2d

            tiles = _Carried(cfg, decomp, x0)
            be = tiles.enter(b)
            xe = tiles.enter(x0)
            own = tiles.owned_carried

            def dot(u, v):
                return _psum(torch.sum(u[own] * v[own]), decomp)

            if tiles.packed:
                def apply_a(pe):
                    return plocal2d.apply_op(tiles.refresh(pe), n, h,
                                             tiles.row_off, tiles.col_off)
            else:
                zeros = torch.zeros_like(be)

                def apply_a(pe):
                    return -tiles.residual(tiles.refresh(pe), zeros, n, h)

            def precond(re):
                rp = tiles.refresh(re)
                if pd is not None:
                    rp = rp.to(pd)
                z = _leg_cycle_ext(
                    hier, cfg, decomp, torch.zeros_like(rp), rp, 0, gamma,
                    0.0, fresh=True,
                    out_dtype=None if pd is None else _wrap.compute_dtype(pd))
                return z.to(re.dtype)

            def residual(xx, bb):
                return tiles.residual(tiles.refresh(xx), bb, n, h)

            x, iters, hist, rel = cg_loop(
                xe, be, dot=dot, apply_a=apply_a, precond=precond,
                residual=residual, tol=cfg.tol, max_iters=cfg.max_iters)
            return tiles.leave(x), iters, hist, rel < cfg.tol

        def dot(u, v):
            return _psum(torch.sum(u * v), decomp)

        def apply_a(p):
            return -s_residual(p, torch.zeros_like(p), n, h, decomp,
                               use_kernels=cfg.use_kernels)

        pd3 = mixed_slab_dtype(cfg, decomp)

        def precond(r):
            rp = r if pd3 is None else r.to(pd3)
            z = _sharded_v_cycle(hier, cfg, decomp, torch.zeros_like(rp), rp,
                                 0, gamma)
            return z.to(r.dtype)

        def residual(xx, bb):
            return s_residual(xx, bb, n, h, decomp,
                              use_kernels=cfg.use_kernels)

        x, iters, hist, rel = cg_loop(
            x0, b, dot=dot, apply_a=apply_a, precond=precond,
            residual=residual, tol=cfg.tol, max_iters=cfg.max_iters)
        return x, iters, hist, rel < cfg.tol

    def solve(self, b_padded, x0=None, method: str = "mg"
              ) -> cycles.SolveResult:
        """Solve A x = b on the mesh, by cycles (``method="mg"``) or MG-PCG
        (``"pcg"``, one V- or W-cycle a preconditioning). Every rank passes
        the full padded right-hand side (a tensor or an array) and gets the
        full padded solution back. ``x0`` (the full padded grid)
        warm-starts the iteration. With ``cycle="fmg"`` the cycles start
        from one sharded FMG pass and polish it by V-cycles; a warm start
        skips the FMG pass (a resumed solve has done it)."""
        if method not in ("mg", "pcg"):
            raise ValueError(f"unknown solve method {method!r}")
        dtype = self.config.dtype
        b_sh = shard_rhs(torch.as_tensor(b_padded).to(dtype), self.mesh,
                         self.decomp)
        if x0 is None:
            x0_sh = torch.zeros_like(b_sh)
        else:
            # The ops rely on zero ghosts: strip whatever the caller gave.
            x0p = pad_interior(interior(torch.as_tensor(x0).to(dtype)))
            x0_sh = shard_rhs(x0p, self.mesh, self.decomp)
        if method == "mg" and self.config.cycle == "fmg" and x0 is None:
            x0_sh = _sharded_fmg(self.hierarchy, self.config, self.decomp,
                                 b_sh)
        run = self._solve_mg if method == "mg" else self._solve_pcg
        x, iters, hist, conv = run(b_sh, x0_sh)
        return cycles.SolveResult(x=unshard(x, self.decomp), iters=iters,
                                  res_history=hist, converged=conv)

    # -- eigensolvers --------------------------------------------------

    def _apply_rows(self, v):
        """A applied to each row of a block of owned tiles, as -residual(u,
        0): the local2d residual kernel on a kernel-sized tile, the plain
        halo-exchanging stencil otherwise."""
        n, h = self.hierarchy.fine.n, self.hierarchy.fine.h
        zeros = torch.zeros_like(v[0])
        return torch.stack([
            -s_residual(u, zeros, n, h, self.decomp,
                        use_kernels=self.config.use_kernels) for u in v])

    def _start_tiles(self, k: int, v0):
        """The start block as (k, *owned tile): the nested-iteration guess
        (``eigen.coarse_init``), broadcast from the mesh's first rank so that
        every rank starts from the same vectors (``eigh``'s signs are the
        LAPACK build's), or the caller's (k, *padded) block with its ghosts
        zeroed, which every rank passes alike, as it does b."""
        from ..solvers import eigen

        v = eigen._start_block(self.hierarchy, k, self.config.dtype, v0)
        if v0 is None and len(self.mesh.ranks) > 1:
            dist.broadcast(v, src=self.mesh.ranks[0], group=self.mesh.group)
        return torch.stack([shard_rhs(u, self.mesh, self.decomp) for u in v])

    def _eigen_result(self, v, lam, iters, hist, res, tol):
        """The result on every rank: the full padded eigenvectors, gathered
        one vector at a time."""
        from ..solvers import eigen

        vecs = torch.stack([unshard(u, self.decomp) for u in v])
        return eigen.EigenResult(eigenvalues=lam, eigenvectors=vecs,
                                 iters=iters, res_history=hist,
                                 converged=res < tol)

    def eigensolve(self, k: int = 1, method: str = "ii", tol: float = 1e-8,
                   max_iters: int = 100, inner_cycles: int = 30,
                   inner_tol: Optional[float] = None, v0=None):
        """The k smallest eigenpairs on the mesh (JAX's
        ``ShardedSolver.eigensolve``): block inverse iteration
        (``method="ii"``), RQI (``"rqi"``) or MG-preconditioned LOBPCG
        (``"lobpcg"``, ``_eigensolve_lobpcg``), by ``solvers.eigen``'s
        outer loops with every inner product summed over the mesh. Every
        rank gets the full padded eigenvectors (k, *padded). ``v0``: a
        (k, *padded) start block (every rank passes the same), else the
        nested-iteration guess.

        II/RQI: each outer step solves (A - sigma_i I) w_i = v_i row by row
        to relative residual ``inner_tol`` (default 200 eps of the dtype),
        at most ``inner_cycles`` cycles (always gamma 1, as JAX's), with
        one host sync a cycle, then takes a generalised Rayleigh-Ritz step
        (rows normalised, Gram matrices summed over the mesh, Cholesky,
        ``eigh``). On the whole-leg route the inner solve carries extended
        tiles (colour-packed where the fine level packs): the right-hand
        side is entered once, each cycle is ``_leg_cycle_ext`` from a
        refreshed iterate, and the check is the residual kernel summed over
        owned points. With ``mixed_leg_dtype`` the inner solve is iterative
        refinement: the refreshed full-dtype defect is cast down, a cycle
        from zero (float32 top-level store) gives the correction, and the
        residual kernel gives the next defect in ``config.dtype``.
        Elsewhere the inner cycles are ``_sharded_v_cycle`` on owned tiles
        and the check ``s_residual``. RQI's shifts are Python floats (an off
        shift is 0.0, the unshifted route; JAX's traced zero takes the
        shifted one: the two agree to rounding)."""
        from ..kernels import _wrap
        from ..solvers import eigen

        if method == "lobpcg":
            return self._eigensolve_lobpcg(k=k, tol=tol, max_iters=max_iters,
                                           v0=v0)
        if method not in ("ii", "rqi"):
            raise ValueError(f"unknown eigensolver method {method!r}")
        cfg, hier, decomp = self.config, self.hierarchy, self.decomp
        n, h = hier.fine.n, hier.fine.h
        dtype = cfg.dtype
        if inner_tol is None:
            inner_tol = 200.0 * torch.finfo(dtype).eps
        leg0 = _leg_level_ok(cfg, decomp, 0)
        pd = mixed_leg_dtype(cfg, decomp)

        def rayleigh(v):
            fv, fav = _rows(v), _rows(self._apply_rows(v))
            num, den = _psum(torch.stack([torch.sum(fv * fav, dim=1),
                                          torch.sum(fv * fv, dim=1)]), decomp)
            lam = num / den
            rr = fav - lam[:, None] * fv
            res = (torch.sqrt(_psum(torch.sum(rr * rr, dim=1), decomp))
                   / torch.abs(lam))
            return lam, torch.max(res)

        def one(rhs, sg: float):
            rn = torch.sqrt(_psum_sq(rhs, decomp))
            rn = torch.where(rn == 0, torch.ones_like(rn), rn)
            i, rel = 0, 1.0
            if not leg0:
                w = torch.zeros_like(rhs)
                while rel >= inner_tol and i < inner_cycles:
                    w = _sharded_v_cycle(hier, cfg, decomp, w, rhs, 0,
                                         sigma=sg)
                    r = s_residual(w, rhs, n, h, decomp, sg,
                                   use_kernels=cfg.use_kernels)
                    rel = (torch.sqrt(_psum_sq(r, decomp)) / rn).item()
                    i += 1
                return w
            tiles = _Carried(cfg, decomp, rhs)
            be = tiles.enter(rhs)
            we, re = torch.zeros_like(be), be
            while rel >= inner_tol and i < inner_cycles:
                if pd is None:
                    we = _leg_cycle_ext(hier, cfg, decomp, we, be, 0, 1, sg,
                                        fresh=True)
                else:
                    # be's ghosts are exact; a residual's are refreshed.
                    rp = (re if i == 0 else tiles.refresh(re)).to(pd)
                    dw = _leg_cycle_ext(
                        hier, cfg, decomp, torch.zeros_like(rp), rp, 0, 1,
                        sg, fresh=True, out_dtype=_wrap.compute_dtype(pd))
                    we = we + dw.to(dtype)
                we = tiles.refresh(we)
                re = tiles.residual(we, be, n, h, sigma=sg)
                ro = re[tiles.owned_carried]
                rel = (torch.sqrt(_psum(torch.sum(ro * ro), decomp))
                       / rn).item()                # host sync, once a cycle
                i += 1
            return tiles.leave(we)

        def inner_solve(v, sigma):
            return torch.stack([one(rhs, sg) for rhs, sg in zip(v, sigma)])

        def ritz(w):
            """Generalised Rayleigh-Ritz, H s = theta G s, on the rows
            normalised first (RQI's inner solves return rows of very
            different sizes, which would wreck G's Cholesky)."""
            kk = w.shape[0]
            nrm0 = torch.sqrt(_psum(torch.sum(_rows(w) ** 2, dim=1), decomp))
            w = w / torch.where(nrm0 == 0, torch.ones_like(nrm0),
                                nrm0).view((kk,) + (1,) * (w.ndim - 1))
            f, aw = _rows(w), _rows(self._apply_rows(w))
            g, hm = _psum(torch.stack([f @ f.T, f @ aw.T]), decomp)
            hm = 0.5 * (hm + hm.T)
            li = torch.linalg.solve_triangular(
                torch.linalg.cholesky(g),
                torch.eye(kk, dtype=dtype, device=g.device), upper=False)
            ht = li @ hm @ li.T
            lam, s = torch.linalg.eigh(0.5 * (ht + ht.T))
            f2 = (li.T @ s).T @ f                  # rows: the Ritz vectors
            nrm = torch.sqrt(_psum(torch.sum(f2 * f2, dim=1), decomp))
            return (f2 / nrm[:, None]).reshape(w.shape), lam

        v, lam, iters, hist, res = eigen.ii_loop(
            self._start_tiles(k, v0), rayleigh=rayleigh,
            inner_solve=inner_solve, ritz=ritz, method=method, tol=tol,
            max_iters=max_iters, rqi_backoff=eigen.RQI_BACKOFF)
        return self._eigen_result(v, lam, iters, hist, res, tol)

    def _eigensolve_lobpcg(self, k: int, tol: float, max_iters: int,
                           precond_cycles: int = 1, v0=None):
        """Sharded MG-preconditioned LOBPCG (JAX's ``_eigensolve_lobpcg``):
        ``eigen.lobpcg_loop`` on blocks of owned tiles, every Gram matrix
        summed over the mesh and the small (3k)^2 problem solved on every
        rank alike. The preconditioner is ``precond_cycles`` owned-tile
        cycles from zero a row (``_sharded_v_cycle``: unpacked at any
        PACK_MIN_N, as JAX's per-application entry); with
        ``mixed_leg_dtype`` they run in that dtype, cast at the
        preconditioner's boundary, the top level storing float32. A dead
        search direction becomes JAX's sharded fallback, a function of the
        global coordinates masked to the interior, the same on every
        rank."""
        from ..kernels import _wrap
        from ..solvers import eigen

        cfg, hier, decomp = self.config, self.hierarchy, self.decomp
        n = hier.fine.n
        dtype = cfg.dtype
        eps = torch.finfo(dtype).eps
        pd = mixed_leg_dtype(cfg, decomp)

        def lead(t, like):
            """t (rows,) shaped to broadcast over a block ``like``."""
            return t.view((like.shape[0],) + (1,) * (like.ndim - 1))

        def gram(f, g):
            return _psum(_rows(f) @ _rows(g).T, decomp)

        def rownorms(v):
            return torch.sqrt(_psum(torch.sum(_rows(v) ** 2, dim=1), decomp))

        def rq_res(v):
            """Rayleigh quotients and residual rows of an orthonormal
            block."""
            av = self._apply_rows(v)
            lam = _psum(torch.sum(_rows(v) * _rows(av), dim=1), decomp)
            r = av - lead(lam, v) * v
            return lam, r, torch.max(rownorms(r) / torch.abs(lam))

        # A mixed dtype implies the whole-leg route at level 0, so
        # _sharded_v_cycle runs _sharded_v_cycle_leg, its up leg storing
        # float32; the iterate is cast back to pd between cycles.
        odt = None if pd is None else _wrap.compute_dtype(pd)

        def tcycle(r):
            out = []
            for rhs in r:
                src = rhs if pd is None else rhs.to(pd)
                w = torch.zeros_like(src)
                for _ in range(precond_cycles):
                    w = _sharded_v_cycle(hier, cfg, decomp, w.to(src.dtype),
                                         src, 0, out_dtype=odt)
                out.append(w.to(dtype))
            return torch.stack(out)

        def combine(c, s):
            """The rows of c^T s as tiles: (m, j)^T x (m, *tile)."""
            return (c.T @ _rows(s)).reshape((c.shape[1],) + s.shape[1:])

        def project_out(f, basis):
            for _ in range(2):
                f = f - combine(gram(f, basis).T, basis)
            return f

        def safe_rownorm(v, salt: float):
            nrm = rownorms(v)
            shape, dev = v.shape[1:], v.device
            rows = lead(torch.arange(v.shape[0], dtype=dtype, device=dev), v)
            fb = (torch.sin((salt + 1.0) * (rows + 1.0) + 0.7391
                            * _coord_sum(shape, decomp, dev).to(dtype))
                  * _interior_mask(n, shape, decomp, dev).to(dtype))
            fb = fb / lead(rownorms(fb), v)
            good, nrm = lead(nrm > eps * eps, v), lead(nrm, v)
            return torch.where(
                good, v / torch.where(good, nrm, torch.ones_like(nrm)), fb)

        def jittered_li(g):
            """L^-1 of the Cholesky factor of g + 100 eps tr(g) I."""
            eye = torch.eye(g.shape[0], dtype=dtype, device=g.device)
            ell = torch.linalg.cholesky(g + (100.0 * eps * torch.trace(g))
                                        * eye)
            return torch.linalg.solve_triangular(ell, eye, upper=False)

        def rr(s, nkeep):
            fs = _rows(s)
            g, hm = _psum(torch.stack(
                [fs @ fs.T, fs @ _rows(self._apply_rows(s)).T]), decomp)
            li = jittered_li(g)
            ht = li @ (0.5 * (hm + hm.T)) @ li.T
            theta, y = torch.linalg.eigh(0.5 * (ht + ht.T))
            return li.T @ y[:, :nkeep], theta[:nkeep]

        v = self._start_tiles(k, v0)
        x = combine(jittered_li(gram(v, v)).T, v)   # orthonormal over the mesh
        x, lam, iters, hist, res = eigen.lobpcg_loop(
            x, k=k, rq_res=rq_res, tcycle=tcycle, project_out=project_out,
            safe_rownorm=safe_rownorm, rr=rr, combine=combine, tol=tol,
            max_iters=max_iters)
        return self._eigen_result(x, lam, iters, hist, res, tol)

    def v_cycle_fn(self):
        """One sharded cycle from the finest level, owned tiles in and out,
        unpacked at any PACK_MIN_N (JAX's per-application entry: packing
        a tile for one cycle costs more than the packed cycle saves)."""
        cfg, hier, decomp = self.config, self.hierarchy, self.decomp
        gamma = 2 if cfg.cycle == "w" else 1

        def one_cycle(x, b):
            return _sharded_v_cycle(hier, cfg, decomp, x, b, 0, gamma)

        return one_cycle

    def v_cycles_fn(self):
        """fn(x_tiles, b_tiles, m) -> x_tiles: m >= 1 chained cycles, what
        the solve loop runs between its checks. On the whole-leg route the
        chain carries the extended tile (colour-packed when
        ``_pack_level_ok`` holds): b's is built once, x is entered once,
        its ghost slabs are refreshed between cycles, and it is left once
        at the end. JAX's ``v_cycles_fn``, so the oracle for packed
        iterates."""
        cfg, hier, decomp = self.config, self.hierarchy, self.decomp
        gamma = 2 if cfg.cycle == "w" else 1

        def many(x, b, m: int):
            if m < 1:
                raise ValueError(f"v_cycles_fn runs m >= 1 cycles, got {m}")
            if _leg_level_ok(cfg, decomp, 0):
                tiles = _Carried(cfg, decomp, x)
                be = tiles.enter(b)
                xe = tiles.enter(x)
                for i in range(m):
                    xe = _leg_cycle_ext(hier, cfg, decomp, xe, be, 0, gamma,
                                        0.0, fresh=(i == 0))
                return tiles.leave(xe)
            for _ in range(m):
                x = _sharded_v_cycle(hier, cfg, decomp, x, b, 0, gamma)
            return x

        return many
