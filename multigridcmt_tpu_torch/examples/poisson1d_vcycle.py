"""BASELINE config 1: 1D Poisson, 1023 points, V(2,2) weighted-Jacobi to
1e-8 — residual history + convergence factor (the reference's headline
demo)."""
import argparse

import torch

import multigridcmt_tpu_torch as mt
from multigridcmt_tpu_torch.utils.metrics import MetricsLogger


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--k", type=int, default=10, help="grid: 2^k - 1 points")
    p.add_argument("--tol", type=float, default=1e-8)
    p.add_argument("--omega", type=float, default=None)
    p.add_argument("--plot", metavar="FILE", default=None,
                   help="write a residual-history PNG (reference-style)")
    p.add_argument("--f32", action="store_true",
                   help="solve in float32 (stalls near ~1e-4 relative "
                        "residual; default float64 reaches the 1e-8 target)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)

    prob = mt.poisson1d(k=args.k, smoother="jacobi", nu1=2, nu2=2,
                        tol=args.tol, omega=args.omega,
                        dtype=torch.float32 if args.f32 else torch.float64,
                        device=args.device)
    res = mt.MultigridSolver(prob).solve()
    MetricsLogger().log_solve_result(res, prob.config)
    if args.plot:
        from multigridcmt_tpu_torch.utils.plots import plot_residual_history
        plot_residual_history(
            {f"V(2,2) w-Jacobi, n={prob.config.n}": res.res_history},
            args.plot, title="1D Poisson V-cycle residual history")
    rho = float(mt.convergence_factor(res))
    print(f"n={prob.config.n}  iters={int(res.iters)}  "
          f"converged={bool(res.converged)}  rho={rho:.4f}")
    return res


if __name__ == "__main__":
    main()
