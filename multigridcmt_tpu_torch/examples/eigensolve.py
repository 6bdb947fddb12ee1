"""BASELINE config 4: smallest eigenpair(s) of the 2D Laplacian 511^2 via
multigrid-preconditioned inverse iteration; the smallest eigenvalue
approaches 2 pi^2 (particle-in-a-box ground state — the reference's CMT
physics payload)."""
import argparse

import numpy as np
import torch

import multigridcmt_tpu_torch as mt


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--k", type=int, default=9, help="grid: (2^k - 1)^2")
    p.add_argument("--num", type=int, default=1, help="# eigenpairs")
    p.add_argument("--method", choices=["ii", "rqi", "lobpcg"], default="ii",
                   help="ii/rqi: (shifted) inverse iteration (reference "
                        "parity); lobpcg: MG-preconditioned LOBPCG (one "
                        "V-cycle per vector per step — fastest)")
    p.add_argument("--tol", type=float, default=1e-7)
    p.add_argument("--plot", metavar="FILE", default=None,
                   help="write an eigenmode-gallery PNG")
    p.add_argument("--f32", action="store_true",
                   help="float32 (eigen-residual floors near ~1e-5 and the "
                        "eigenvalue carries O(1e-2) roundoff; default f64)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)

    prob = mt.poisson2d(k=args.k, smoother="rbgs",
                        dtype=torch.float32 if args.f32 else torch.float64,
                        device=args.device)
    res = mt.MultigridSolver(prob).eigensolve(
        k=args.num, method=args.method, tol=args.tol)
    lams = np.sort(res.eigenvalues.cpu().numpy())
    print(f"n={prob.config.n}^2  iters={int(res.iters)}  "
          f"converged={bool(res.converged)}")
    for i, lam in enumerate(lams):
        print(f"  lambda_{i + 1} = {lam:.8f}")
    print(f"  (continuum lambda_1 = 2 pi^2 = {2 * np.pi ** 2:.8f})")
    if args.plot:
        from multigridcmt_tpu_torch.utils.plots import plot_eigenmodes
        plot_eigenmodes(res.eigenvectors[:, 1:-1, 1:-1],
                        prob.config.n, 2,
                        res.eigenvalues, args.plot)
    return res


if __name__ == "__main__":
    main()
