"""BASELINE config 2: 2D Poisson 255^2, red-black Gauss-Seidel V-cycle,
5 levels (min_coarse picked so the hierarchy has exactly 5 levels)."""
import argparse

import torch

import multigridcmt_tpu_torch as mt
from multigridcmt_tpu_torch.utils.metrics import MetricsLogger


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--k", type=int, default=8, help="grid: (2^k - 1)^2")
    p.add_argument("--levels", type=int, default=5)
    p.add_argument("--tol", type=float, default=1e-8)
    p.add_argument("--plot", metavar="FILE", default=None,
                   help="write a residual-history PNG (reference-style)")
    p.add_argument("--kernels", action="store_true",
                   help="route the large levels through the CUDA kernels")
    p.add_argument("--method", choices=("mg", "pcg"), default="mg",
                   help="stationary V-cycles or MG-preconditioned CG")
    p.add_argument("--bf16-precond", action="store_true",
                   help="run the PCG V-cycle preconditioner in bfloat16 "
                        "(packed-kernel fine levels only — see "
                        "SolverConfig.precond_dtype)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)

    min_coarse = 2 ** (args.k - args.levels + 1) - 1
    prob = mt.poisson2d(k=args.k, smoother="rbgs", tol=args.tol,
                        min_coarse=min_coarse, use_kernels=args.kernels,
                        dtype=torch.float32,
                        precond_dtype=(torch.bfloat16 if args.bf16_precond
                                       else None),
                        device=args.device)
    if prob.hierarchy.num_levels != args.levels:
        raise ValueError(f"--k {args.k} gives {prob.hierarchy.num_levels} "
                         f"levels, not --levels {args.levels}")
    res = mt.MultigridSolver(prob).solve(method=args.method)
    if args.plot:
        from multigridcmt_tpu_torch.utils.plots import plot_residual_history
        plot_residual_history(
            {f"V(2,2) RBGS, n={prob.config.n}^2": res.res_history},
            args.plot, title="2D Poisson V-cycle residual history")
    MetricsLogger().log_solve_result(res, prob.config)
    rho = float(mt.convergence_factor(res))
    print(f"n={prob.config.n}^2  levels={args.levels}  "
          f"iters={int(res.iters)}  rho={rho:.4f}")
    return res


if __name__ == "__main__":
    main()
