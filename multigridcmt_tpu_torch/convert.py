"""Carry configs, hierarchies, problems and sparse matrices across from
the JAX package.

The functions take objects of ``multigridcmt_tpu`` and read their arrays
with ``np.asarray``, so this module, like the rest of the port, never
imports ``jax``. Dtypes map through their NumPy names, and ``use_pallas``
maps to ``use_kernels``.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import numpy as np
import torch

from .api import Problem
from .config import SolverConfig
from .grids import Hierarchy, LevelSpec, check_device
from .ops.sparse import COO, CSR, DIA

if TYPE_CHECKING:
    from .kernels.bell import BELL
    from .kernels.spmv import PackedDIA
    from .parallel.sharded import Decomp


def _torch_dtype(dtype) -> torch.dtype:
    return getattr(torch, np.dtype(dtype).name)


def config_from_jax(cfg) -> SolverConfig:
    """The port's SolverConfig for a JAX ``SolverConfig``."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["dtype"] = _torch_dtype(fields["dtype"])
    if fields["precond_dtype"] is not None:
        fields["precond_dtype"] = _torch_dtype(fields["precond_dtype"])
    fields["use_kernels"] = fields.pop("use_pallas")
    return SolverConfig(**fields)


def _tensor(a, device) -> torch.Tensor:
    """A JAX (or NumPy) array as a tensor on ``device``. NumPy's bfloat16
    (``ml_dtypes``) has no torch counterpart in ``from_numpy``: it is
    widened to float32 and rounded back, both exact, so the same bits
    arrive."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(a).to(device)


def hierarchy_from_jax(hier, device=None) -> Hierarchy:
    """The port's Hierarchy for a JAX ``Hierarchy``, on ``device`` (None:
    the card)."""
    device = check_device(device)
    return Hierarchy(
        ndim=hier.ndim,
        levels=tuple(LevelSpec(n=lv.n, h=lv.h) for lv in hier.levels),
        coarse_inv=_tensor(hier.coarse_inv, device),
        coarse_dense=_tensor(hier.coarse_dense, device))


def problem_from_jax(prob, device=None) -> Problem:
    """The port's Problem for a JAX ``Problem``, on ``device`` (None: the
    card)."""
    device = check_device(device)
    return Problem(
        config=config_from_jax(prob.config),
        hierarchy=hierarchy_from_jax(prob.hierarchy, device),
        b=_tensor(prob.b, device),
        u_exact=(None if prob.u_exact is None
                 else _tensor(prob.u_exact, device)))


def csr_from_jax(a, device=None) -> CSR:
    """The port's CSR for a JAX ``ops.sparse.CSR``, on ``device`` (None:
    the card)."""
    device = check_device(device)
    return CSR(data=_tensor(a.data, device),
               indices=_tensor(a.indices, device),
               indptr=_tensor(a.indptr, device),
               row_ids=_tensor(a.row_ids, device), shape=tuple(a.shape))


def coo_from_jax(a, device=None) -> COO:
    """The port's COO for a JAX ``ops.sparse.COO``, on ``device``."""
    device = check_device(device)
    return COO(data=_tensor(a.data, device), row=_tensor(a.row, device),
               col=_tensor(a.col, device), shape=tuple(a.shape))


def dia_from_jax(a, device=None) -> DIA:
    """The port's DIA for a JAX ``ops.sparse.DIA``, on ``device``."""
    device = check_device(device)
    return DIA(diags=_tensor(a.diags, device), offsets=tuple(a.offsets),
               shape=tuple(a.shape))


def packed_dia_from_jax(a, device=None) -> PackedDIA:
    """The port's PackedDIA for a JAX ``kernels.spmv.PackedDIA``, on
    ``device``."""
    from .kernels.spmv import PackedDIA

    device = check_device(device)
    return PackedDIA(diags=_tensor(a.diags, device),
                     offsets=tuple(a.offsets), n=int(a.n))


def bell_from_jax(a, device=None) -> BELL:
    """The port's BELL for a JAX ``kernels.bell.BELL``, on ``device``."""
    from .kernels.bell import BELL

    device = check_device(device)
    return BELL(data=_tensor(a.data, device), cols=_tensor(a.cols, device),
                shape=tuple(a.shape), nnz_scalar=int(a.nnz_scalar))


def mesh_shape_from_jax(mesh) -> tuple:
    """The shape of a JAX ``Mesh`` (its device array's), for
    ``parallel.sharded.make_mesh`` / ``make_block_mesh``."""
    return tuple(int(d) for d in np.asarray(mesh.devices).shape)


def packed_tile_from_jax(s, rows: int, cols: int, device=None):
    """The port's colour-packed extended tile (2, rows, (cols + 1) // 2)
    (``kernels.plocal2d.pack_ext``) for a JAX one: JAX packs the tile
    embedded in its (16j, 128j) zero-padded layout into (2, 16j, 128j)
    planes, with the same lanes first. ``rows`` x ``cols``: the unpacked
    tile's logical extent. On ``device`` (None: the card)."""
    device = check_device(device)
    a = np.asarray(s)
    lanes = (cols + 1) // 2
    if a.ndim != 3 or a.shape[0] != 2 or a.shape[1] < rows \
            or a.shape[2] < lanes:
        raise ValueError(f"a packed JAX tile of at least (2, {rows}, "
                         f"{lanes}) expected, got shape {a.shape}")
    return _tensor(a[:, :rows, :lanes], device)


def tile_from_jax(x_sharded, decomp: Decomp, coords, device=None):
    """One rank's owned tile of a JAX sharded array of owned tiles (the
    layout of ``multigridcmt_tpu.parallel.sharded.shard_rhs``), on
    ``device`` (None: the card). ``coords``: the rank's position along
    ``decomp.axes``."""
    device = check_device(device)
    full = np.asarray(x_sharded)
    for (a, _, nd), c in zip(decomp.axes, coords):
        m = full.shape[a] // nd
        full = np.take(full, np.arange(c * m, (c + 1) * m), axis=a)
    return _tensor(full, device)


def slab_stack_from_jax(s, planes: int, rows: int, n: int, device=None):
    """The port's plane stack (planes, rows, n + 2) of a slab or pencil
    level (``parallel.sharded._slab3d_level``: m0 + 2 hz planes; n + 2 rows
    on a slab mesh, m1 + 2 hz on a pencil one) for a JAX extended stack,
    which embeds it in its TPU layout (planes to a multiple of 4, rows to
    one of 8, columns to one of 128) with the same entries first. On
    ``device`` (None: the card)."""
    device = check_device(device)
    a = np.asarray(s)
    if a.ndim != 3 or a.shape[0] < planes or a.shape[1] < rows \
            or a.shape[2] < n + 2:
        raise ValueError(f"a JAX plane stack of at least ({planes}, {rows}, "
                         f"{n + 2}) expected, got shape {a.shape}")
    return _tensor(a[:planes, :rows, :n + 2], device)
