"""BASELINE config 5: 4096^2-scale Poisson V-cycle domain-decomposed across
the ranks of a torch.distributed process group with halo exchanges and
coarse-level agglomeration.

--mesh ROWSxCOLS picks the decomposition: a 1D mesh gives row (2D) / slab
(3D) partitioning, a 2D mesh gives block / pencil partitioning (half the
halo surface per rank at the same rank count). --ndim 3 runs the 3D
7-point problem on the same runtime.

The process group: one already up in this process is used as it is;
otherwise one is started from torchrun's environment (one rank per card:
torchrun --nproc-per-node=4 -m multigridcmt_tpu_torch.examples.
distributed_vcycle); otherwise this process is a world of 1 (NCCL on the
card, gloo with --device cpu).
"""
import argparse
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

import multigridcmt_tpu_torch as mt
from multigridcmt_tpu_torch.config import SolverConfig
from multigridcmt_tpu_torch.grids import check_device
from multigridcmt_tpu_torch.parallel import sharded
from multigridcmt_tpu_torch.utils.metrics import is_host0


def _start_group(device: torch.device, rendezvous: str) -> bool:
    """Start the process group unless one is up: from torchrun's
    environment, else a world of 1 through a file under ``rendezvous``.
    Returns True if this call started it."""
    if dist.is_initialized():
        return False
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend)
    else:
        if backend == "gloo":
            # One process: its gloo device needs no interface but loopback.
            os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        dist.init_process_group(
            backend, init_method=f"file://{rendezvous}/rdv", world_size=1,
            rank=0)
    return True


def _mesh(spec, device):
    """(mesh, ranks along its longest axis) over the first ranks of the
    world that ``spec`` (None, "N" or "RxC") asks for; None for a rank
    outside the mesh."""
    world = dist.get_world_size()
    if spec and "x" in spec:
        shape = tuple(int(v) for v in spec.split("x"))
    elif spec:
        shape = (int(spec),)
    else:
        shape = (world,)
    size = int(np.prod(shape))
    if size > world:
        raise ValueError(f"--mesh {spec} needs {size} ranks, the world has "
                         f"{world}")
    group = (None if size == world
             else dist.new_group(list(range(size))))
    if dist.get_rank() >= size:
        return None, max(shape)
    if len(shape) == 2:
        return sharded.make_block_mesh(shape, group=group,
                                       device=device), max(shape)
    return sharded.make_mesh(group=group, device=device), shape[0]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--k", type=int, default=12, help="grid: (2^k - 1)^d")
    p.add_argument("--ndim", type=int, default=2, choices=[2, 3])
    p.add_argument("--mesh", default=None, metavar="RxC",
                   help="rank mesh shape, e.g. '8' (rows/slabs) or "
                        "'4x2' (blocks/pencils); default: all ranks, 1D")
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--cycle", default="v", choices=["v", "w", "fmg"])
    p.add_argument("--eigen", type=int, default=0, metavar="K",
                   help="instead of solving, find the K smallest "
                        "eigenpairs with the distributed eigensolver")
    p.add_argument("--eigen-method", default="ii",
                   choices=["ii", "rqi", "lobpcg"])
    p.add_argument("--f64", action="store_true")
    p.add_argument("--kernels", action="store_true",
                   help="shard-local CUDA kernels (kernels/local2d and "
                        "plocal2d, the whole-leg route; stencil3d in 3D)")
    p.add_argument("--device", default=None,
                   help="torch device (default: this rank's card)")
    args = p.parse_args(argv)

    device = check_device(args.device)
    with tempfile.TemporaryDirectory() as rendezvous:
        started = _start_group(device, rendezvous)
        try:
            return _run(args, device)
        finally:
            if started:
                dist.destroy_process_group()


def _run(args, device):
    dtype = torch.float64 if args.f64 else torch.float32
    mesh, max_dev = _mesh(args.mesh, device)
    if mesh is None:
        return None
    # Keep the fine level sharded on small demo grids: the production
    # agglomeration cutoff (64 rows/rank, measured on the TPU —
    # config.py) can exceed a toy problem's whole per-rank extent.
    agglom = max(2, min(64, 2 ** args.k // (2 * max_dev)))
    cfg = SolverConfig(ndim=args.ndim, k=args.k, dtype=dtype,
                       smoother="rbgs", cycle=args.cycle, tol=args.tol,
                       use_kernels=args.kernels, agglom_rows=agglom)
    solver = sharded.ShardedSolver(cfg, mesh)
    ndev = len(mesh.ranks)

    if args.eigen:
        res = solver.eigensolve(k=args.eigen, method=args.eigen_method,
                                tol=max(args.tol, 1e-9))
        if is_host0():
            lam = np.sort(res.eigenvalues.cpu().numpy())
            print(f"n={cfg.n}^{args.ndim} on {ndev} devices "
                  f"(mesh {mesh.shape}): iters={int(res.iters)} "
                  f"converged={bool(res.converged)}")
            print(f"eigenvalues: {lam}  (lambda_1 -> {args.ndim}*pi^2 = "
                  f"{args.ndim * np.pi ** 2:.6f} as h -> 0)")
        return res

    prob = mt.poisson(args.k, ndim=args.ndim, dtype=dtype, device=device)
    res = solver.solve(prob.b)
    if is_host0():
        rho = float(mt.convergence_factor(res))
        print(f"n={cfg.n}^{args.ndim} on {ndev} devices "
              f"(mesh {mesh.shape}): iters={int(res.iters)}"
              f"  converged={bool(res.converged)}  rho={rho:.4f}")
        err = (mt.interior(res.x) - mt.interior(prob.u_exact)).abs().max()
        print(f"max error vs analytic solution: {float(err):.3e}")
    return res


if __name__ == "__main__":
    main()
