#!/usr/bin/env python3
"""Drive the PyTorch port (multigridcmt_tpu_torch) on one CUDA card.

Phases:
  1. set-up: the card's name and power limit, the CUDA version, and the
     build of the kernel library from the sources in this checkout;
  2. each CUDA kernel against its plain PyTorch version on the card;
  3. the main paths through the public entry points, each run with the
     launch counters set to 0 just before it and read just after:
       * the 4095^2 float32 RB-GS solve (launch counts, residual, error
         against the analytic solution), kernel against plain V-cycles,
         and float64 solves at k=10 and k=12 against the plain path;
       * the composed legs: the 4095^2 float32 Chebyshev V(2,2) solve (A),
         the 4095^2 RB-GS V(4,4) solve (B) and the 1023^2 Jacobi V(8,8)
         solve (C), with exact launch counts and the error against the
         analytic solution, float64 solves at k=10 against the plain path
         (Chebyshev, B and C with no rounding floor, and B again with its
         1023 level packed, PACK_MIN_N 1000, with a floor of 1e-12), and
         Chebyshev-preconditioned CG at 4095^2;
       * the 511^3 float32 RB-GS solve, the same checks, and a float64
         k=8 solve against the plain path;
       * MG-preconditioned CG at 4095^2 and 511^3 float32, and float64
         PCG against the plain path at 2D k=10 and 3D k=7;
       * the sharded 2D solve (parallel/sharded.py, ShardedSolver.solve)
         as a torch.distributed world of 1 over NCCL: S1 RB-GS V(2,2) at
         4095^2 on a row mesh at the default kernels.PACK_MIN_N (the 4095
         level colour-packed on the plocal2d kernels, as in JAX), by cycles
         and by MG-PCG (S1pcg), beside the single-device solve; S1 again
         with PACK_MIN_N raised above 4095 (S1unpacked, the local2d legs on
         4095); S2 RB-GS V(2,2) at 2047^2 on a (1, 1) block mesh, S3 RB-GS
         V(4,4) at 2047^2 and S4 Jacobi V(8,8) and Chebyshev V(2,2) at
         1023^2, each with exact local2d and plocal2d launch counts and the
         error against the analytic solution; float64 k=10 sharded solves
         against the single-device ones, unpacked and packed (PACK_MIN_N
         lowered to 1000 for that check), by cycles and by PCG, and on S3's
         and S4's composed routes (RB-GS V(4,4), Jacobi V(8,8): the local2d
         sweeps) against paths B's and C's single-device route, with
         exact local2d sweep and residual counts;
       * full multigrid, config 3: MultigridSolver.fmg at 1023^2 (fmg1023),
         float64 and float32, linear and cubic walks, on the kernel and the
         plain route, with exact launches, the float64 discrete-L2 error
         under 5 h^2, the error ratio in (3, 5) over k = 8, 9, 10, the
         kernel route's iterate within 1e-12 of the plain route's and the
         float32 error within twice the plain route's; solve(cycle="fmg")
         at 4095^2 float32 on the main path's route (fmg4095: b restricted
         and the walk prolonged by the zero-sweep packed legs), against the
         analytic solution and the V-cycle solve;
       * the eigensolvers, config 4: MultigridSolver.eigensolve(k=1) at
         511^2 float64 by inverse iteration, RQI and LOBPCG on both routes
         (eigen511), lambda_1 within 1e-8 of 2 eigenvalue_1d(1, 511, h)
         and the routes' eigenvalues within 1e-10, LOBPCG k=3 against the
         exact spectrum (the degenerate pair lambda(1,2) = lambda(2,1)),
         launches as a multiple of the V-cycles each run made (counted
         around cycles.v_cycle);
       * the sharded FMG: ShardedSolver.solve with cycle="fmg" at S1's
         4095^2 (S1fmg), against fmg4095, with exact local2d and plocal2d
         launches, and a float64 k=10 sharded FMG solve against the
         single-device one;
       * mixed precision on the packed 2D tier: MG-PCG at 4095^2 float32
         with precond_dtype=torch.bfloat16 on the V(2,2) RB-GS (mixed2d),
         RB-GS V(4,4) (mixedB) and Chebyshev V(2,2) (mixedA) routes, each
         against the float32 PCG on its route (converged, in at most
         ceil(1.2 x its iterations) + 1, error against the analytic
         solution) with exact launches of the packed level's bfloat16
         kernels; LOBPCG and II at 4095^2 float64 with a bfloat16
         preconditioner, lambda_1 within 1e-8 of the full-precision run's;
       * 3D mixed precision: MG-PCG at 511^3 float32 with
         precond_dtype=torch.bfloat16 (mixed3d) against the float32 PCG
         (converged, in at most ceil(1.2 x its iterations) + 1, max error
         against the analytic solution under 2e-3), with exact launches: a
         preconditioning cycle's two bfloat16 RB-GS sweeps and bfloat16
         residual at 511 and no float32 pre-smoothing there, all sweeps
         together PCG's float32 count; LOBPCG at 511^3 and II at 255^3
         float64 with a bfloat16 preconditioner, lambda_1 within 1e-8 of
         the full-precision runs' and of the exact discrete value, in at
         most 3 outer steps more;
       * sharded mixed precision: ShardedSolver.solve(method="pcg") with
         precond_dtype=torch.bfloat16 on a mesh of 1, float32 outer
         iterations, beside the float32 sharded PCG of the same mesh: S1's
         4095^2 RB-GS V(2,2) on a row mesh packed (S1mixed: the plocal2d
         legs' bfloat16 modes) and with PACK_MIN_N above 4095
         (S1unpacked-mixed: the local2d ones), S2's 2047^2 on a (1, 1)
         block mesh (S2mixed); converged, in at most ceil(1.2 x float32's
         iterations) + 1, max error against u_exact (and the float32
         PCG's) under 4e-3 packed, 1e-2 at S1unpacked-mixed and 5e-3 at
         S2mixed, exact launches; a float64 k=10 mixed sharded PCG
         within the same gate and rtol 1e-7, atol 1e-8 of the full-dtype
         one;
       * the sharded eigensolvers, float64 on a mesh of 1
         (ShardedSolver.eigensolve): S1eigen (S1's 4095^2, the fine level
         packed) by inverse iteration, RQI and LOBPCG at k=1, lambda_1
         within 1e-8 of 2 eigenvalue_1d(1, 4095, h) and within 1e-10 of the
         single-device float64 run at 4095^2, and LOBPCG k=3 against the
         exact lambda(1,1), lambda(1,2), lambda(2,1); S2eigen (S2's 2047^2
         block tile, unpacked) by inverse iteration; S1mixed-eigen, II and
         LOBPCG with precond_dtype=torch.bfloat16, lambda_1 within 1e-8 of
         S1eigen's; eigenvectors finite with zero ghosts; exact launches as
         a multiple of the whole-leg cycles each run made (counted around
         sharded._leg_cycle_ext) and of its outer steps;
       * sharded 3D, float32 V(2,2) at 511^3 on a mesh of 1
         (ShardedSolver with ndim=3; every kernel level on the extended
         stack): a slab (row) and a pencil ((1, 1) block) RB-GS solve by
         cycles and by PCG, in the single-device solve's iterations (by
         cycles with histories within 1e-2 plus its floor); a Jacobi slab solve; slab
         and pencil PCG with precond_dtype=torch.bfloat16, RB-GS and
         Jacobi, in the float32 PCG's iterations on the same mesh (the
         fine stack promoted to float32 at the correction add: JAX's
         bfloat16 add, ROADMAP.md F7, is not copied), the slab ones
         again on the plain stencil3d versions in as many iterations;
         float64 at 127^3 against the plain sharded route; inverse
         iteration at 255^3 float64 on a slab mesh; exact stencil3d
         launches derived from the route;
       * the utils on the main path (4095^2 float32 RB-GS V(2,2)): a solve
         bracketed by utils.profiling.Timer and its fence; the same solve
         under utils.profiling.trace, whose CUDA kernel events (the packed2d
         and fused2d legs and the packed norm, by name) equal the launch
         counters and whose mg_level_* ranges cover every level;
         utils.metrics.MetricsLogger's records of it (iters + 1 iteration
         records whose residuals are the history, one solve_done); a
         solve stopped after 3 cycles, saved by utils.checkpoint, loaded
         and resumed, bit for bit the iterate of as many uninterrupted
         cycles, in the cold solve's cycles (or, where the stall guard
         stops the cold solve, up to 2 more: the resume restarts the
         guard's count, as JAX's does); utils.debug.checked and debug_mode
         around the solve, bit for bit, and debug_mode naming the packed
         down leg as the first operation that produced a NaN planted in b;
         utils.comm_audit around S1's solve on the world of 1 (no message
         sent; ppermute, psum and all_gather counts as derived);
       * the example CLIs (multigridcmt_tpu_torch/examples) through their
         main(argv) at the BASELINE configs' widths: poisson1d_vcycle,
         poisson2d_rbgs --kernels (mg and pcg), fmg_accuracy --kernels
         (linear and cubic), eigensolve (ii and lobpcg), poisson3d at 511^3
         with the stencil3d kernels and with its defaults,
         distributed_vcycle --kernels at 4095^2 and with --eigen 1 at 511^2
         float64, each printing its line, with exact launches, and the
         iterations and values of phase 3's runs of the same problems
         (fmg1023, eigen511 at the example's tolerance, solve3d, S1);
       * the bfloat16 solves (config.dtype bfloat16, kernels on) at
         2047^2 (k=11, the widest whose levels all stay bfloat16): V(2,2)
         Jacobi and RB-GS on the native fused2d legs and RB-GS V(4,5) on
         the native sweeps and transfer2d kernels, with exact launches,
         each beside the same solve on the CPU (the plain versions): the
         same iterations, x bit for bit, the histories equal (one bfloat16
         ulp allowed where a replay shows only the norm's float32 sum
         parting); each diverges, as JAX's solve does;
       * the sparse path: the Poisson operator assembled as DIA at 4095^2
         and 255^3, packed, and applied 20 times in a chain by the DIA
         SpMV kernel (exactly 20 launches) against 20 plain applies; the
         float64 eigen-relation A u = lambda_h u as an oracle at both
         sizes; as_csr/as_coo at 1023^2 on the card, their SpMVs against
         the DIA kernel; the SpMV bench's blocked-ELL matrix (64 x 64
         blocks of 128^2, density 0.15, m = 128) through the BELL SpMM
         kernel against SciPy on the host;
     Phase 2 holds the packed2d legs against their plain versions also at
     n = 2999 (partial strips and segments of the row stream) and n = 61
     (one of each), and at every sweep count in float64 at n = 255; the
     fused2d legs (the same row stream on the unpacked grid) at every
     sweep count at n = 2999, 31, 15 and 7, float32 and float64, at n <= 31
     also with inputs off a pair of elements (the wrapper copies them); the
     row-streaming sweeps at every sweep count and both sigmas: stencil2d
     RB-GS and Jacobi at 2047, 1023, 511, 255, 2999, 31, 15 and 7 (float64
     at 1023, 255, 31, 15, 7; off a pair at n <= 31), the packed RB-GS
     sweep at 4095, 2999 and 61 (float64 at 255 and 61); the
     local2d kernels against their plain versions on
     each of S1-S4's own fine tiles with the sweeps that path runs, and on
     tiles with nonzero global offsets (a rank of an 8-way row split of
     4095^2, a rank of a 2x2 block split of 2047^2; the legs at RB-GS
     nu = 0...3 and Jacobi nu = 3 and 6), since a mesh of 1 has none, the
     local2d sweeps at every sweep count up to their caps, both sigmas,
     float32 and float64, on those tiles, on a 1023^2 tile at even offsets
     and on S3's and S4's fine tiles; the plocal2d kernels on the packed
     form of S1's fine tile and of
     those offset tiles (the block one has the other packing phase), in
     float64 on two 255^2 ranks (the legs at every sweep count), and the
     legs at every sweep count on a 2999^2 rank whose row stream ends in a
     partial strip and segment; transfer2d.residual_restrict (the row
     stream without a fine store) at 2047, 1023, 511 and 255 in float32 and
     float64, on a pair of elements and off one, bit for bit against its
     plain version; the BELL SpMM also in float64 at the bench shape and
     through the 8-row carrier, twice (the second call equal to the first
     bit for bit), and with NaN and Inf in Xt's first block column (where
     every zero padding block points) at m = 128 and 8, both dtypes, the
     non-finite values exactly where the plain version's are; the packed2d
     kernels' bfloat16 modes (the down leg, the up leg storing bfloat16 or
     float32, the RB-GS sweep, the residual) at 4095 (RB-GS nu = 0 and 2,
     Jacobi nu = 2, the 1- and 4-sweep sweep, both sigmas), 2999 and 61
     (every sweep count, logical and packed coarse grids), each bfloat16
     output within one bfloat16 ulp plus BF16_SCALE_TOL of the field's
     largest value, at most BF16_SHARE of the points differing; the
     stencil3d kernels' bfloat16 modes (the residual, storing float32; the
     Jacobi and RB-GS sweeps at 1 and 2 sweeps, storing bfloat16 or, by
     out_dtype, float32) at 511^3, both sigmas, on a slab-and-pencil
     stack of it and on the sharded 3D paths' fine slab and pencil
     stacks, by the same rule; the local2d and plocal2d legs'
     bfloat16 modes (the down leg, the up leg storing bfloat16 or float32)
     on bfloat16 forms of S1's fine tile, S2's block tile and the two offset
     tiles, unpacked and packed, at RB-GS nu = 2, Jacobi nu = 3 and RB-GS
     nu = 1 with sigma, by the same rule (the coarse right-hand side against
     the plain restriction of the kernel's own stored u'); the last
     bfloat16 modes of the _cdt kernels (compare_cdt_bf16): the plocal2d
     residual, apply and norm on bfloat16 forms of S1's packed tile and the
     two offset tiles, both sigmas, the whole grid's norm at 4095^2 (red
     only and both planes), the BELL SpMM on the bench matrix, its carrier,
     4 x 3 blocks with padding blocks and NaN and Inf in Xt, by the same
     rule (a norm, float32, to TOL[float32] of its value); the native
     bfloat16 modes (compare_native_bf16: the stencil2d residual at
     2047^2, its RB-GS at 2047^2, 1023^2, 511^2 and 255^2, nu = 1 to 4,
     its Jacobi at 1023^2, nu = 8, the local2d
     residual, RB-GS nu = 4 and Jacobi nu = 8 on S1's fine tile and S2's
     block tile, the DIA SpMV at 4095^2 with random values on its 5
     diagonals, sigma 0 and SIGMA; the stencil2d modes at 1023^2 and the
     SpMV also with NaN and +-Inf in their inputs) bit for bit against
     their plain versions, NaN where the plain version has NaN; the last
     native modes (compare_native_legs: the fused2d down and up legs on
     the row stream at every sweep count from 0 to their caps, RB-GS and
     Jacobi, and the transfer2d residual restriction and prolongation-add,
     at 2047^2, 1023^2, 511^2 and 255^2, sigma 0 and SIGMA, and at 1023^2
     with NaN and +-Inf in every input; the restriction also at 2047^2 on
     a residual of -0 where u > 0, whose bits the sigma u term it lacks
     would change) by the same rule;
  4. times (CUDA events, warm-up, median of 20): one V(2,2) RB-GS cycle at
     4095^2 and at 511^3 float32 and one Chebyshev V(2,2) and RB-GS V(4,4)
     cycle at 4095^2 on the kernel and the plain path, one PCG iteration
     at 4095^2, each kernel against its plain version (and, for
     prolong_add, the one PyTorch call that computes the same function)
     at the main paths' shapes, the packed kernels against their unpacked
     twins at 4095^2 (the four legs also as 20 chained calls between one
     pair of events, the time the packed legs' rows report, and by the
     profiler's device time, every leg row's device_ms, at nu = 0, 1, 2
     and the cap, and the fused2d legs so at 2047^2 too, beside the
     single-call time their rows report), the stencil3d kernels single
     and chained
     at 511^3, 255^3 and 127^3 (the 511^3 chained time is their rows'),
     the row-streaming sweeps single, chained and by device time at paths
     B's and C's levels (stencil2d RB-GS nu = 4 at 2047...255, Jacobi nu =
     8 at 1023...255, the packed sweep at 4095^2, nu = 4 and 1), the
     smoother figure (one packed RB-GS sweep at 4095^2: ms, GB/s, Gnnz/s,
     and by device time), the SpMV figure (a DIA apply at 4095^2 and
     255^3, from 20 chained applies: ms, Gnnz/s, GB/s) and the BELL figure
     (ms, TFLOP/s, Gnnz*vec/s, GB/s, and by device time; the 8-row SpMV
     carrier by device time beside its bytes bound over every stored
     block), residual_restrict by device time at 2047...255 beside the
     zero-sweep fused2d down leg and its bound, each beside its plain
     version and
     the library calls of the same operator (torch.mv and torch.sparse.mm
     on a CSR for the SpMV, torch.sparse.mm on a (128, 128) BSR for the
     BELL), one sharded V(2,2) cycle at S1 and S2 beside the single-device
     cycle at the same k, one S1 cycle in a chain of 20 (v_cycles_fn),
     packed and unpacked in turns, each local2d kernel at S1's fine tile
     against its plain version (and the local2d legs' device time at S1's
     4095 and 2047 tiles and S2's block tile, the local2d sweeps' at S3's
     tiles, RB-GS nu = 4 at 2047...255, and S4's, Jacobi nu = 8 at
     1023...255), each plocal2d kernel at S1's packed tile
     against its plain version and beside its local2d twin (the two legs
     and their twins also single and chained at nu = 0, 1, 2 and the cap),
     and the peak device memory of the solves; configs 3 and 4's first
     times: one FMG pass at 1023^2 (float32 and float64, with its device
     time and idle share) and at 4095^2, solve(cycle="fmg") at 4095^2,
     the 511^2 float64 eigensolve by each method (with its outer steps and
     V-cycles) and S1fmg (the solve and its FMG pass alone), each with its
     peak device memory; the bfloat16 modes at 4095^2 against their plain
     versions and beside their float32 twins (chained and device), and on
     each mixed route a preconditioning cycle's device busy and idle share
     and a PCG solve's wall, with a bfloat16 and a float32 cycle; the
     stencil3d bfloat16 modes at 511^3 so, beside their float32 twins and
     their bounds at bfloat16 bytes, and the mixed3d cycle's busy and idle
     and its PCG's wall; one preconditioning cycle of the sharded mixed
     Jacobi paths at 511^3 (slab and pencil, bfloat16 beside float32: busy,
     idle, the stencil3d Jacobi kernels' share); the local2d and plocal2d
     legs' bfloat16 modes at
     S1's fine tile beside their float32 twins and their bounds at bfloat16
     bytes, and on each sharded mixed path a preconditioning cycle's busy
     and idle share and a PCG solve's wall, with a bfloat16 and a float32
     fine level (right after the sharded cycles' times); S1eigen's II
     and LOBPCG walls beside the single-device float64 eigensolve at
     4095^2, each with the device busy time and idle share of an II outer
     step or a LOBPCG solve; the _cdt family's last bfloat16 modes beside
     their float32 twins and their bounds at bfloat16 bytes (the BELL
     mode's operations at the bfloat16 tensor-core rate), the BELL mode
     beside a bfloat16 BSR torch.sparse.mm where PyTorch runs it; the
     native bfloat16 modes at phase 2's main shapes against their plain
     versions (single, chained and by device time) beside their bounds at
     bfloat16 bytes, the SpMV beside a bfloat16 CSR torch.mv where
     PyTorch runs it, and the last native modes at 2047^2 so (the legs
     at RB-GS nu = 2 and the transfers also at 1023^2, 511^2 and 255^2,
     beside the whole grid's native RB-GS sweep stream at nu = 4 and 1
     at each of the four). Every
     kernel row also gets the profiler's
     device time a call (device_ms), and the sharded eigensolver runs'
     launches (sharded_eigen_launches) where it has some.

The main paths' kernels: at k=12 the 4095 level is color-packed
(kernels.PACK_MIN_N) and runs the packed2d down and up legs and the fused
residual norm of the convergence check; levels 2047..255 run the fused2d
legs; PCG's operator apply and residual there run the packed residual. A
leg that does not fuse (Chebyshev, or more sweeps than a fused leg takes)
is composed: on the packed level from the packed residual (Chebyshev) or
the packed RB-GS sweep and the zero-sweep packed legs, on levels
2047..255 from the stencil2d residual (Chebyshev) or sweeps and the
transfer2d residual-restrict and prolong-add. The sweeps are the legs'
row stream without its coarse operand, on the packed and the unpacked
frame. At k=9 in 3D the levels
511, 255 and 127 (n >= kernels.KERNEL3_MIN_N) run the stencil3d RB-GS
sweep and residual kernels; a single-device 3D Jacobi cycle takes the
plain route, as in the JAX package, and the stencil3d Jacobi sweep runs on
the sharded 3D paths' stacks. The sparse path calls its two kernels (kernels.spmv,
kernels.bell) directly, through ops/sparse.py's matrices.

The sharded paths (a mesh of 1): at S1 the 4095 level runs the plocal2d
down and up legs on the packed extended tile and the fused plocal2d norm
as the solve's check (S1pcg: the plocal2d residual once and the apply an
iteration), levels 2047..255 (all of them at S1unpacked and S2) the local2d
down and up legs on extended tiles, 127 and 63 the plain owned-tile route,
31 and below are gathered and run the plain single-device cycle; an
unpacked fine level's check is the local2d residual. V(4,4) RB-GS and
V(8,8) Jacobi exceed the legs' sweep caps and run the local2d sweeps and
residual on the owned tiles (the composed route); Chebyshev runs the
local2d residual.

Mixed precision: each bfloat16 preconditioning cycle at 4095^2 runs, on
the 4095 level, the bfloat16 down leg (nu = 2 on the fused route, nu = 0
after the 4-sweep bfloat16 sweep of V(4,4) or the bfloat16 residual
applies of Chebyshev's pre-smoothing) and the up leg with bfloat16 x and
b, a float32 correction and float32 x' (then, on the Chebyshev route, the
float32 residual applies of the post-smoothing); 2047..255 run the float32
kernels, as in a float32 cycle. The up leg storing bfloat16 (the TPU
kernel's own mode) runs on no path: direct calls. Each bfloat16
preconditioning cycle at 511^3 runs, on the 511 level, nu1 = 2 bfloat16
RB-GS sweeps and the bfloat16 residual (storing float32); the correction
add x + P e promotes 511 to float32 and the post-smoothing runs the
float32 sweeps; 255 and 127 run the float32 kernels, as in a float32
cycle. The sweeps storing float32 (out_dtype) and the bfloat16 Jacobi
modes run on no single-device path: direct calls. A sharded mixed 3D
cycle (slab511-mixed, pencil511-mixed and their Jacobi twins) runs on its
fine stack the nu1 = 2 bfloat16 sweeps (RB-GS, or Jacobi storing
bfloat16) and the bfloat16 residual, then promotes the stack at the
correction add and runs the float32 sweeps: the sweeps storing float32
run on no path. Each bfloat16 preconditioning cycle
of a sharded mixed PCG runs, on the fine level's carried tile, the
bfloat16 down leg and the up leg with bfloat16 x and b, a float32
correction and float32 x' (plocal2d at S1mixed, local2d at
S1unpacked-mixed and S2mixed), the float32 local2d legs on the levels
below; CG's residual and apply stay float32 (the plocal2d residual and
apply, or the local2d residual). The tile legs storing bfloat16 run on no
path: direct calls. Nor do the bfloat16 modes of the plocal2d residual,
apply and norm, the whole grid's norm and the BELL SpMM (JAX's _cdt rule:
float32 arithmetic, each output rounded once, the norms float32 sums):
phase 3's cdt_bf16_direct calls each once. The native bfloat16 modes
(the TPU kernels computing in bfloat16 itself, every operation rounded)
run on the bfloat16 solves: at 2047...255 the fused2d legs (V(2,2)) or
the stencil2d RB-GS sweeps and the transfer2d kernels (V(4,5)), and the
stencil2d residual as the check; each fused leg is one launch of the row
stream with the native arithmetic (no native sweep is launched from a
leg); levels below 255 run the plain counterparts of JAX's aligned-layout
stencils. The local2d modes and the DIA SpMV run on no
path, and phase 3's native_bf16_direct calls each of B1's modes once.

FMG and the eigensolvers add no kernel. An FMG walk's V-cycle started at a
level runs the legs of the kernel levels at and below it; b's restriction
and the walk's prolongation are the plain transfers, except from and onto
a packed level (the zero-sweep packed legs). An inverse-iteration or RQI
inner cycle at 511^2 runs the fused2d legs at 511 and 255 (shifted while
RQI's shift is on) and its check the stencil2d residual; LOBPCG's
preconditioner is one V-cycle a block vector; Rayleigh quotients apply A
by the plain stencil. The sharded FMG walk's cycles run the unpacked
local2d legs (as v_cycle_fn), its polishing cycles the packed route. A
sharded II or RQI inner cycle at S1 runs the plocal2d legs on the packed
4095 tile and the local2d legs at 2047..255, and its check the plocal2d
residual (the local2d one on S2's unpacked tile); LOBPCG's preconditioning
cycle runs the unpacked local2d legs at 4095..255; every row of A the
sharded eigensolvers apply (Rayleigh quotients, Ritz steps) is one local2d
residual on the owned tile. With a bfloat16 preconditioner the fine
level's legs are the bfloat16 down leg and the float32-storing up leg.

Phase 1 also reports ptxas's registers and spills of the row-streaming
legs and sweeps, the local2d sweeps (UTile) among them, the stencil3d
z-march kernels in every storage mode, the BELL SpMM kernels, the
residual-restriction stream, the native bfloat16 kernels and the DIA
SpMV in each type, the native fused2d legs a line a leg and kind, and the
native sweep and residual-restriction streams (from the build's
nvcc.log), and fails if one of the last six spills; and the residual
norm's first pass (presnorm_partial) in every storage mode, failing if a
float32 or float64 BELL SpMM, norm or residual-restriction kernel's line
differs from the parent tree's (PARENT_PTXAS): their storage type, or the
native restriction's choice of no sigma u term, must leave those kernels
as they were.

Run from the root of the repository:  python3 chip_smoke.py
Any failed check exits non-zero. Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result. The
line before the last is a JSON object with every kernel; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

MAIN_K = 12                 # 4095^2 fine grid
MAIN_K3 = 9                 # 511^3 fine grid
SIGMA = 11.5
# Kernel against plain on the card, as max|kernel - plain| / max|plain|
# (for the squared norms, |kernel - plain| / plain).
# float64: the kernels contract a*b+c into FMAs, multiply by 1/(4 -
# sigma h^2) where the plain version divides, and the packed kernels sum
# the neighbours in another order: a few ulp a sweep; 1e-12 leaves room for
# the residual's cancellation (up to ~4/h^2 |u| / |r|, 6/h^2 in 3D).
# float32: the same ulp-level differences, amplified by that cancellation
# in the restricted residual, stay near 1e-6 of its largest value at
# n=4095 for the inputs below; the norms differ by the plain version's
# float32 summation over up to 8.4M squares (the kernel sums in float64).
# 1e-5 bounds both, and the 3D kernels' FMA-level differences (~1e-7).
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
COMPARE_SHAPES = [(torch.float32, 4095), (torch.float32, 2047),
                  (torch.float32, 255), (torch.float32, 1023),
                  (torch.float64, 255), (torch.float64, 1023)]
# The packed2d legs also at the row stream's edge cases: 2999 leaves partial
# strips and segments (3001 rows of 1501 lanes), 61 lies inside one strip
# and one segment; every sweep count from 0 to the cap at one float64 size.
PACKED_LEG_SHAPES = [(torch.float32, 2999), (torch.float64, 61)]
PACKED_LEG_ALL_NU = (torch.float64, 255)
# The fused2d legs (the row stream on the unpacked grid) at every sweep
# count from 0 to the caps, where the row stream ends partly: 2999 (1501
# lanes, 3001 rows: partial strips and segments), and 31, 15 and 7 (one
# partial strip and segment; 7 is the least n the kernel tier runs with
# KERNEL_MIN_N lowered), float32 and float64.
FUSED_LEG_SHAPES = [(torch.float32, 2999), (torch.float32, 31),
                    (torch.float32, 15), (torch.float32, 7),
                    (torch.float64, 31), (torch.float64, 15),
                    (torch.float64, 7)]
# The sharded 3D paths' fine stacks at 511^3 on the world of 1, as (goff,
# roff, p, r) with whether a bfloat16 RB-GS sweep on them takes the paired
# march (stencil3d.rbgs_pairs: r odd, goff + roff even): the RB-GS V(2,2)
# slab (hz = 5: goff = 1 - hz, 512 + 2 hz planes) and pencil (rows too,
# passing both ends of the grid; 522 rows: the scalar march), the Jacobi
# V(2,2) slab and pencil (hz = 3). A bfloat16 Jacobi sweep storing
# bfloat16 takes its paired march on all four (stencil3d.jacobi_pairs: c
# odd, whatever r and the offsets).
SHARDED3D_STACKS = [((-4, 0, 522, 513), True), ((-4, -4, 522, 522), False),
                    ((-2, 0, 518, 513), True), ((-2, -2, 518, 518), False)]
STENCIL3D_SHAPES = [(torch.float32, 511), (torch.float32, 255),
                    (torch.float32, 127), (torch.float64, 127)]
# The stencil3d z-march's edge cases, as plane stacks (goff, roff, p, r) of
# an (n+2)^3 grid, by (dtype, n): 3 planes (units of one plane each); 64,
# 63 and 65 planes of the 511 grid (stencil3d.march_geometry: the sweep's
# two chunks of 32, three of 21 and three of 22, the last one short; the
# residual's chunks of 8 whole, the last one short, and one past with a
# chunk of one plane); whole grids whose c = n + 2 is one past a strip
# multiple (57 = 2 * 28 + 1, the sweep's strips; 61 = 2 * 30 + 1, the
# residual's); r = 17, one past a band multiple (8 rows in float32, 4 or 8
# in float64); and the sharded 3D paths' fine stacks on the world of 1
# (SHARDED3D_STACKS).
STENCIL3D_STACKS = {
    (torch.float32, 127): [(40, 0, 3, 129)],
    (torch.float32, 511): [(10, 0, 64, 513), (200, -1, 63, 513),
                           (440, 3, 65, 513),
                           *(s for s, _ in SHARDED3D_STACKS)],
    (torch.float32, 55): [(0, 0, 57, 57), (20, 10, 20, 17)],
    (torch.float32, 59): [(0, 0, 61, 61)],
    (torch.float64, 55): [(20, 10, 20, 17)],
    (torch.float64, 59): [(-1, -1, 65, 61)],
}
PACKED_RESIDUAL_SHAPES = [(torch.float32, 4095), (torch.float64, 255)]
# The composed legs' kernels: transfer2d at the largest unpacked level;
# float64 at 255. residual_restrict (the row stream without a fine store)
# at every level paths A-C run it, both dtypes, also off a pair of
# elements, bit for bit against its plain version (RR_SHAPES).
TRANSFER_SHAPES = [(torch.float32, 2047), (torch.float64, 255)]
RR_SHAPES = [(d, n) for d in (torch.float32, torch.float64)
             for n in (2047, 1023, 511, 255)]
# The row-streaming sweeps at every sweep count up to the caps: the
# stencil2d sweeps at path B's and C's levels (2047...255), where the
# stream ends partly (2999: 1501 lanes, 3001 rows) and at 31, 15 and 7 (one
# partial strip and segment), also off a pair of elements at n <= 31 (the
# wrapper copies); the packed RB-GS sweep at the packed level 4095, at 2999
# and 61 (one strip and segment).
SWEEP_SHAPES = [(torch.float32, 2047), (torch.float32, 1023),
                (torch.float32, 511), (torch.float32, 255),
                (torch.float32, 2999), (torch.float32, 31),
                (torch.float32, 15), (torch.float32, 7),
                (torch.float64, 1023), (torch.float64, 255),
                (torch.float64, 31), (torch.float64, 15), (torch.float64, 7)]
PACKED_SWEEP_SHAPES = [(torch.float32, 4095), (torch.float32, 2999),
                       (torch.float32, 61), (torch.float64, 255),
                       (torch.float64, 61)]
# Path C runs smaller (1023^2, no packed level), with the smoke's time in
# mind; the float64 Chebyshev solve is held against the plain path at it.
PATH_C_K = 10
# 5 V-cycles at 4095^2, kernel path against plain path, relative l2. The
# packed down leg restricts the red residual only (the black one is zero
# after an RB-GS sweep in exact arithmetic, as in the JAX package); the
# plain path also restricts the black residual's rounding. float32 is at
# its rounding floor after one cycle at this h (relative residual ~0.1):
# the iterates differ by that floor's noise, ~1e-3 of |x| (their error
# against u_exact is ~3e-3), so 1e-2. float64 has no such floor here, and
# the dropped rounding moves x by far less than 1e-9.
VCYCLE_RTOL = {torch.float32: 1e-2, torch.float64: 1e-9}
# The same at 511^3 float32. The 3D kernels sum the six neighbours before
# subtracting them from 6u, where the plain stencils subtract them one by
# one, and float32 is at its floor after three cycles here (relative
# residual ~3e-3): the plain route's iterate ends ~4x further from u_exact
# than the kernel route's (9.6e-4 against 2.3e-4, max error, on an H100),
# and the two differ by that, ~1e-3 of |x|; 1e-2, as in 2D.
VCYCLE3_RTOL = 1e-2
# Max error against u_exact of the float32 solves and V-cycles: the
# float32 floor. 2D k=12: ~3.3e-3 measured. 3D k=9: the discretisation
# error is only pi^2 h^2 / 12 ~ 3e-6, the floor 2.3e-4 (kernel route) and
# 9.6e-4 (plain route) measured; 2e-3. A wrong stencil gives O(1) errors.
MAXERR = {2: 1e-2, 3: 2e-3}
# The sharded paths' bound, set from two readings at 4095^2 float32 on the
# unpacked route (S1's local2d legs, and the single-device solve with the
# same PACK_MIN_N, on the fused2d legs; both logged in phase 3): 3.7e-3 and
# 3.8e-3, both stalling near a relative residual of 0.145. The packed
# single-device route stalls lower (0.10, 3.3e-3): its down leg restricts
# the red residual only, dropping the black residual's rounding noise.
SHARDED_MAXERR = 5e-3
# The packed sharded route's bound, set from three readings at 4095^2
# float32 on an H100 (all logged in phase 3): S1 at the default PACK_MIN_N
# 3.33e-3 (stalling at a relative residual of 0.1036, as the single-device
# packed route does: its down leg restricts the red residual only), its
# single-device twin 3.29e-3, S1pcg 2.13e-3. 4e-3 is the largest of them
# and a fifth.
PACKED_MAXERR = 4e-3
F64_TOL = 1e-8
# The float64 runs held against the plain path: (solve k, PCG k) per ndim.
F64_K = {2: (10, 10), 3: (8, 7)}
# Float64 histories, kernel path against plain path: rtol 1e-8 down to the
# rounding floor of the relative residual. In 2D the two paths round alike
# (0). In 3D the kernels sum the six neighbours before subtracting them
# from 6u and contract into FMAs, where the plain stencils subtract one by
# one: the computed residual moves by ~eps * 6/h^2 * |u| / |b|, ~3e-12 at
# h = 1/256, so 1e-11.
F64_FLOOR = {2: 0.0, 3: 1e-11}
# One NVIDIA H100 SXM at its full 700 W (NVIDIA's data sheet): device
# memory rate and float32 rate outside the tensor cores. Every kernel row
# below is float32.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# The sparse path at the JAX package's SpMV bench sizes (bench_spmv.py):
# the DIA SpMV at 4095^2 (and 255^3), the BELL SpMM on 64 x 64 blocks of
# 128^2 at density 0.15 (seed 1), m = 128 vectors.
SPMV_SIZES = ((2, 2 ** MAIN_K - 1, "spmv2d"), (3, 255, "spmv3d"))
SPMV_CHAIN = 20
BELL_BLOCKS, BELL_DENSITY, BELL_M, BELL_SEED = 64, 0.15, 128, 1
# The DIA kernel against its plain version: one apply as TOL; a chain of
# SPMV_CHAIN applies of the h = 1 operator (weights 4 and -1, so the
# largest value grows 8^20 ~ 1e18 and stays in float32's range, where the
# 1/h^2 operator would reach 1e162) adds at most ~1.5e-7 of the largest
# value an apply (five terms, half an ulp each, with and without FMA):
# ~3e-6 after 20, so 2e-5.
CHAIN_TOL = 2e-5
# The oracle A u_exact = lambda_h u_exact in float64, relative to
# lambda_h max|u|: f64 rounding of terms of size 8/h^2 ~ 1.3e8 against
# lambda_h ~ 19.7 leaves ~2e-9 at 4095^2 (float32 would leave no digits).
ORACLE_TOL = 1e-7
# The BELL product in float32 against SciPy's float64 one: sums of 2304
# products of N(0,1) values, ~1e-6 of the largest output; 1e-5.
BELL_SCIPY_TOL = 1e-5
# One H100 SXM's dense bfloat16 tensor-core rate at its full 700 W (NVIDIA's
# data sheet): the BELL SpMM's bfloat16 mode takes its operations' bound at
# it (the kernel itself runs FFMA: a tensor-core redesign is ROADMAP.md's).
PEAK_BF16_FLOPS = 989e12
# The BELL SpMM's bfloat16 mode on 4 x 3 blocks of 128^2 with kmax this
# far above the densest block row (padding blocks in every block row).
BELL_BF16_PAD = 2
# The native bfloat16 modes of slice B1 (the TPU kernels computing in
# bfloat16 itself: every operation rounded, sigma and the constants too),
# held bit for bit against their plain versions at full width:
# stencil2d's residual at 2047^2, its RB-GS (nu = 1 to 4) and Jacobi (nu =
# 1 to 8) at NATIVE_SWEEP_N, the local2d modes (RB-GS nu = 4, Jacobi nu =
# 8) on S1's fine tile and S2's block tile (col_off odd), the DIA SpMV at
# 4095^2 (5 diagonals, random values), sigma 0 and SIGMA; stencil2d's modes
# and the SpMV also on inputs seeded with NaN and +-Inf
# (NATIVE_NONFINITE_N). The main-path rows: 2047^2, the fine level of the
# bfloat16 solves.
NATIVE_STENCIL_N = {"residual": 2047, "rbgs": 2047, "jacobi": 2047}
NATIVE_SWEEPS = {"rbgs": (1, 2, 3, 4), "jacobi": tuple(range(1, 9))}
# The whole grid's RB-GS and Jacobi sweeps (the row stream with the native
# arithmetic, csrc/stencil2d_sweep_native_bf16.cu and
# stencil2d_jacobi_native_bf16.cu) are held at every level of the k=11
# bfloat16 solve, each nu of NATIVE_SWEEPS, both sigmas.
NATIVE_SWEEP_N = (2047, 1023, 511, 255)
# The sweep counts phase 4 times them at, at each level: RB-GS as
# bf16_rbgs45 launches it (4, and 4 + 1 at nu2 = 5), Jacobi as
# bf16_jacobi88's down leg (8).
NATIVE_RBGS_TIMED = (4, 1)
NATIVE_JACOBI_TIMED = (8,)
NATIVE_OMEGA = 0.8
NATIVE_TILES = {"S1": (2 ** MAIN_K - 1, (1, 0)), "S2": (2047, (1, 1))}
NATIVE_NONFINITE_N = 1023
# Operations a point (a sweep) of each native mode: the residual's 9
# (4u, four differences, the scaling, b - au, sigma u, the sum), the GS
# update's 6, the Jacobi step's 11; the SpMV's 2 a diagonal.
NATIVE_OPS = {"residual": 9, "rbgs": 6, "jacobi": 11}
# The native fused2d legs (the row stream, csrc/fused2d_native_bf16.cu and
# fused2d_up_native_bf16.cu) and transfer2d kernels (the row stream's
# csrc/transfer2d_native_bf16.cu, the block kernel
# csrc/transfer2d_prolong_native_bf16.cu) run on the bfloat16 solves
# (BF16_SOLVES). Phase 2 holds them bit for bit
# against their plain versions at each fused level of the k=11 solve,
# 2047^2, 1023^2, 511^2 and 255^2, sigma 0 and SIGMA, RB-GS and Jacobi
# (NATIVE_OMEGA) at every sweep count from 0 to each leg's cap, and all
# four at NATIVE_NONFINITE_N on inputs seeded with NaN and +-Inf; phase 4
# times the legs at each level.
NATIVE_LEG_N = (2047, 1023, 511, 255)
NATIVE_LEGS = ("fused2d_down_bf16", "fused2d_up_bf16",
               "transfer2d_residual_restrict_bf16",
               "transfer2d_prolong_add_bf16")
# Operations of the B2 modes for their bounds, counted as the function
# needs them (each fine residual once): the residual at every fine point
# (7: four differences, the scaling, b - au; 9 with sig u), the row
# weighting at the coarse rows (5 a point, n^2 / 2 points) and the column
# weighting at the coarse points (5, n^2 / 4); the interpolation's
# averages (3 a point: half the points a pass) and the add (1 a point).
NATIVE_RR_OPS = (7 + 5 / 2 + 5 / 4, 9 + 5 / 2 + 5 / 4)
NATIVE_PA_OPS = 3 * (1 / 4 + 1 / 2) + 1
# The bfloat16 solves (config.dtype bfloat16, kernels on) at k=11, the
# widest whose legs all stay bfloat16 (at k=12 the packed 4095 level's
# _cdt down leg emits the coarse levels in float32): V(2,2) Jacobi (the
# default smoother) and V(2,2) RB-GS on the fused legs at 2047...255;
# RB-GS V(4,5), whose legs both pass the fused caps (RB-GS: 3 down, 4 up),
# composed from the native sweeps (4 + 1 at nu2 = 5), the residual
# restriction and the prolongation-add; and Jacobi V(8,8) (path C's
# schedule), whose down leg passes the fused cap (Jacobi: 6 down, 8 up):
# the native Jacobi sweeps (nu = 8, one launch) and the residual
# restriction, then the fused up leg. Each diverges, as JAX's solve of the
# same problem does (bfloat16 cannot hold the residual at this h).
BF16_SOLVE_K = 11
BF16_SOLVES = {"bf16_jacobi22": dict(smoother="jacobi"),
               "bf16_rbgs22": dict(smoother="rbgs"),
               "bf16_rbgs45": dict(smoother="rbgs", nu1=4, nu2=5),
               "bf16_jacobi88": dict(smoother="jacobi", nu1=8, nu2=8)}


# The sharded paths: (k, mesh, config overrides) of S1-S4; S4 is Jacobi
# V(8,8) and, as "S4cheb", Chebyshev V(2,2).
SHARDED_PATHS = {
    "S1": (12, (1,), dict(smoother="rbgs")),
    "S2": (11, (1, 1), dict(smoother="rbgs")),
    "S3": (11, (1,), dict(smoother="rbgs", nu1=4, nu2=4)),
    "S4": (10, (1,), dict(smoother="jacobi", nu1=8, nu2=8)),
    "S4cheb": (10, (1,), dict(smoother="chebyshev")),
}
SHARDED_F64_K = 10
SHARDED_F64_FLOOR = 1e-12
# The float64 packed sharded check: PACK_MIN_N lowered so that k=10's 1023
# level packs, for that check only.
SHARDED_F64_PACK_MIN_N = 1000
# The same for path B's float64 packed check (the packed RB-GS sweep on a
# gated route). The packed frames sum a stencil's neighbours before adding
# them (the plain path one by one) and the norm sums the red residual only,
# so the histories part by rounding: an absolute floor, as the sharded
# packed check's.
F64_PACK_MIN_N = 1000
F64_PACKED_FLOOR = 1e-12
# local2d tiles with nonzero offsets for phase 2: (n, rank rows, row rank,
# rank columns, column rank); 0 columns: a row decomposition. The plocal2d
# kernels run on them too, packed.
LOCAL2D_TILES = ((2 ** MAIN_K - 1, 8, 3, 0, 0), (2 ** (MAIN_K - 1) - 1, 2, 1,
                                                 2, 1))
# A tile at even offsets, which no sharded solve cuts but the sweep and
# residual wrappers take (as JAX's traced offsets): (n, rows, cols,
# row_off, col_off) of 1023^2, rows above the grid, the columns past its
# last one, paired accesses on the odd rows (the pitch is even), partial
# strips and segments.
LOCAL2D_EVEN_TILE = (1023, 530, 700, -6, 400)
# plocal2d in float64 at a small size: a rank of a row split and of a block
# split of 255^2, each leg at every sweep count up to its cap.
PLOCAL2D_F64_TILES = ((255, 2, 1, 0, 0), (255, 2, 1, 2, 1))
# The plocal2d legs' row stream at its edge cases: an inner rank of a
# 4-way row split of 2999^2 (766 rows of 1501 lanes), whose last strip and
# last segment are partial at every sweep count (checked), in float32 at
# every sweep count up to the caps.
PLOCAL2D_EDGE_TILE = (2999, 4, 2, 0, 0)
# Mixed precision: the packed fine level stored in bfloat16 (the packed2d
# kernels' bfloat16 modes). A bfloat16 output against its plain version:
# both evaluate in float32, in other orders (as the float32 gates allow, to
# TOL[float32] of the field's largest value), then round once, so each
# point lies within one bfloat16 ulp of the plain value plus BF16_SCALE_TOL
# of max|plain|, and a one-ulp flip is rare: at most BF16_SHARE of the
# points differ (the Jacobi down leg at 4095^2, nu = 2, parted at 1.7e-3 of
# them on an H100: the kernel contracts the Jacobi step into an FMA, the
# plain version rounds it twice). A float32 output
# (the down leg's coarse right-hand side, the up leg's float32 store) to
# TOL[float32]; the coarse right-hand side against the plain restriction
# of the kernel's own stored u' (a one-ulp flip of u' moves the residual
# there by 4/h^2 of an ulp). Shapes: 4095 (the main path's), 2999 (partial
# strips and segments, every sweep count) and 61 (one strip and segment).
BF16_SCALE_TOL = 1e-5
BF16_SHARE = 1e-2
MIXED_SHAPES = (2 ** MAIN_K - 1, 2999, 61)
# Mixed PCG at 4095^2 float32 (precond_dtype=torch.bfloat16) on the main
# path's V(2,2) RB-GS route, RB-GS V(4,4) and Chebyshev V(2,2): converged,
# in at most ceil(MIXED_ITER_FACTOR x the float32 PCG's iterations) + 1 on
# the same route, max error against u_exact under MAXERR[2]. The mixed
# eigensolves at 4095^2 float64: lambda_1 within MIXED_EIGEN_RTOL of the
# full-precision run's.
MIXED_ITER_FACTOR = 1.2
MIXED_EIGEN_RTOL = 1e-8
MIXED_ROUTES = {"mixed2d": dict(smoother="rbgs"),
                "mixedB": dict(smoother="rbgs", nu1=4, nu2=4),
                "mixedA": dict(smoother="chebyshev")}
MIXED_EIGEN = ("lobpcg", "ii")
# 3D mixed precision: the stencil3d kernels' bfloat16 modes at 511^3, on
# one slab-and-pencil stack of it (goff, roff, p, r: global planes
# 200..262, rows -1..511, the sweep's three chunks of 21; the scalar
# march) and on the sharded paths' stacks (SHARDED3D_STACKS), each bfloat16
# output by the bfloat16 rule above; the sweeps' float32 outputs
# (out_dtype: red points rounded to bfloat16, black ones float32) by the
# same per-point bound, a point counting as differing where it parts by
# more than TOL[float32] of max|plain|; the residual's float32 output to
# TOL[float32]. Mixed PCG at 511^3 float32 (mixed3d) against the float32
# PCG as in 2D, max error under MAXERR[3]; the mixed eigensolves, float64,
# at (method, k): lambda_1 within MIXED_EIGEN_RTOL of the full run's and of
# the exact discrete value, in at most MIXED3D_EXTRA_STEPS outer steps more.
MIXED3D_STACK = (200, -1, 63, 513)
MIXED3D_STACKS = [(MIXED3D_STACK, False), *SHARDED3D_STACKS]
# Sharded mixed precision (the local2d and plocal2d legs' bfloat16 modes):
# phase 2 holds them on bfloat16 forms of the tiles of compare_local2d and
# compare_plocal2d (S1's fine tile unpacked and packed, S2's block tile
# unpacked and packed in the other phase, the two offset tiles) by the
# bfloat16 rule above, at MIXED_TILE_RUNS (kind, sweeps, sigma; the first
# is the main path's). Phase 3 runs sharded MG-PCG with
# precond_dtype=torch.bfloat16 on a sharded path's fine level, in the
# world of 1, beside the float32 PCG of the same mesh: label -> (sharded
# path, PACK_MIN_N or None for the default, max-error bound against
# u_exact), with MIXED_ITER_FACTOR's iteration gate; S1mixed packs 4095
# (plocal2d), S1unpacked-mixed and S2mixed run local2d's modes there.
# PCG on the unpacked 4095 route ends further from u_exact than the solve
# by cycles does (SHARDED_MAXERR's readings), in float32 as in mixed
# precision: 7.1813e-3 float32 and 6.8548e-3 with the bfloat16
# preconditioner on a CPU world of 1 (the plain versions, which the local2d
# legs equal bit for bit at sigma = 0), 6.8309e-3 mixed on an H100; so
# S1unpacked-mixed is held to MAXERR[2], the bound of the 2D float32 solves
# and of the single-device mixed PCG runs, and the float32 PCG beside it
# to the same bound. S2mixed (k=11: 1.8e-4 float32, 2.3e-4 mixed on the
# CPU) keeps SHARDED_MAXERR, S1mixed PACKED_MAXERR. And
# a float64 k=SHARDED_F64_K mixed sharded PCG within the same gate, x
# within MIXED_SHARDED_RTOL, MIXED_SHARDED_ATOL of the full-dtype sharded
# PCG (the JAX package's criterion, tests/test_mixed.py).
MIXED_TILE_RUNS = (("rbgs", 2, 0.0), ("jacobi", 3, 0.0), ("rbgs", 1, SIGMA))
MIXED_SHARDED = {"S1mixed": ("S1", None, PACKED_MAXERR),
                 "S1unpacked-mixed": ("S1", 2 ** MAIN_K, MAXERR[2]),
                 "S2mixed": ("S2", None, SHARDED_MAXERR)}
MIXED_SHARDED_RTOL, MIXED_SHARDED_ATOL = 1e-7, 1e-8
MIXED3D_EIGEN = (("lobpcg", MAIN_K3), ("ii", MAIN_K3 - 1))
MIXED3D_EXTRA_STEPS = 3
# Config 3 (BASELINE.json): one FMG pass at 1023^2, scored by its
# discrete-L2 error against the analytic solution, and second order over
# FMG_RATIO_K; config 4: the smallest eigenpair of the 511^2 Laplacian.
FMG_K = 10
FMG_RATIO_K = (8, 9, 10)
# Float64 FMG gates. The 5-point scheme's own discrete-L2 error is about
# (pi^2 / 6) h^2 ~ 1.6 h^2, and one FMG pass lands within a small factor of
# it: under 5 h^2, with an error ratio in (3, 5) between successive grids
# (second order). The kernel route's iterate within rtol 1e-12 of the
# plain route's: the fused2d legs round as the plain path at sigma = 0 and
# h = 2^-k, and the walk's transfers are the plain ones on both.
FMG_L2_FACTOR = 5.0
FMG_RATIO = (3.0, 5.0)
FMG_ROUTE_RTOL = 1e-12
# Float32 FMG sits at float32's rounding floor: the kernel route's error is
# held to twice the plain route's in the same run.
FMG_F32_FACTOR = 2.0
EIGEN_K = 9
# lambda_1 within 1e-8 of the exact discrete value 2 lambda_1d(1) (the
# eigen-residual tolerance is 1e-8 and the eigenvalue's error goes as its
# square); the kernel and plain routes' eigenvalues within 1e-10 (their
# inner solves agree to rounding, both near 200 eps).
EIGEN_RTOL = 1e-8
EIGEN_ROUTE_RTOL = 1e-10
EIGEN_METHODS = ("ii", "rqi", "lobpcg")
# LOBPCG's block of three: lambda(1,1) and the degenerate lambda(1,2) =
# lambda(2,1).
EIGEN_BLOCK = 3
HALO = 8                    # local2d.HALO_ROWS
# The sharded eigensolvers (ShardedSolver.eigensolve: config 4's eigensolve
# on config 5's sharded solver, a world of 1, float64): label -> (the
# SHARDED_PATHS path, bfloat16 preconditioner or not, runs as (method,
# block)). S1eigen: the 4095 level packed (the II/RQI inner cycles on the
# plocal2d legs, the plocal2d residual as their check), its lambda_1 within
# EIGEN_RTOL of the exact value and EIGEN_ROUTE_RTOL of the single-device
# float64 run of the same method at 4095^2 (paths_mixed's full runs; RQI
# against II's), LOBPCG's block of EIGEN_BLOCK against the exact spectrum;
# S2eigen: the 2047^2 block tile unpacked (the local2d residual as the
# check); S1mixed-eigen: a bfloat16 preconditioner (II's inner refinement,
# LOBPCG's preconditioner), lambda_1 within MIXED_EIGEN_RTOL of S1eigen's.
SHARDED_EIGEN = {
    "S1eigen": ("S1", None, (("ii", 1), ("rqi", 1), ("lobpcg", 1),
                             ("lobpcg", EIGEN_BLOCK))),
    "S2eigen": ("S2", None, (("ii", 1),)),
    "S1mixed-eigen": ("S1", torch.bfloat16, (("ii", 1), ("lobpcg", 1))),
}
SHARDED_EIGEN_RUNS = tuple(f"{label}_{m}{k}" for label, (_, _, ms)
                           in SHARDED_EIGEN.items() for m, k in ms)
# Sharded 3D (slabs and pencils; ShardedSolver with ndim=3) at the 3D
# headline's width, 511^3 (k = MAIN_K3), float32 V(2,2), on the world of 1:
# label -> (mesh shape, smoother, bfloat16 preconditioner). A slab mesh is
# a row mesh, a pencil mesh a (1, 1) block mesh; every level 511...127 runs
# the extended-stack level (_slab3d_level: the stencil3d kernels on
# (512 + 2 hz, 513, 513) and (522, 522, 513)-sized stacks at 511). The
# RB-GS paths by cycles and by PCG ("...pcg" runs) take the single-device
# solve's iterations, max error under MAXERR[3]; Jacobi by cycles (the
# single device runs a 3D Jacobi cycle plain: iterations not compared);
# the mixed paths are PCG with precond_dtype=torch.bfloat16 against the
# float32 PCG of the same mesh and smoother (MIXED_ITER_FACTOR's gate,
# MAXERR[3]). Launches exact, derived from the route.
SHARDED3D_PATHS = {
    "slab511": ((1,), "rbgs", None),
    "pencil511": ((1, 1), "rbgs", None),
    "slab511-jacobi": ((1,), "jacobi", None),
    "slab511-mixed": ((1,), "rbgs", torch.bfloat16),
    "slab511-mixed-jacobi": ((1,), "jacobi", torch.bfloat16),
    "pencil511-mixed": ((1, 1), "rbgs", torch.bfloat16),
    "pencil511-mixed-jacobi": ((1, 1), "jacobi", torch.bfloat16),
}
# Float64: at k = SHARDED3D_F64_K (the 127 level on the stencil3d kernels)
# the slab and pencil solves' histories, kernel route against the plain
# sharded route, within F64_TOL plus F64_FLOOR[3]; inverse iteration (k=1)
# at 255^3 (k = SHARDED3D_EIGEN_K) on a slab mesh, lambda_1 within
# EIGEN_RTOL of the exact discrete value ("slab-eigen").
SHARDED3D_F64_K = 7
SHARDED3D_EIGEN_K = 8
# The float32 solves by cycles against the single device
# (against_single3d): every common history entry within SHARDED3D_HIST_RTOL
# of the single device's plus its last entry (the float32 floor).
SHARDED3D_HIST_RTOL = 1e-2
# The mixed paths also run with the stencil3d wrappers swapped for their
# plain versions (plain_stencil3d), in as many iterations.
SHARDED3D_PLAIN_RUNS = ("slab511-mixed", "slab511-mixed-jacobi")
SHARDED3D_RUNS = ("slab511", "slab511pcg", "pencil511", "pencil511pcg",
                  "slab511-jacobi", "slab511-mixed", "slab511-mixed-jacobi",
                  "pencil511-mixed", "pencil511-mixed-jacobi", "slab-eigen")
# The example CLIs (multigridcmt_tpu_torch/examples) at the BASELINE
# configs' widths, each through main(argv) in-process: label -> (module,
# argv). Phase 3's runs of the same problems are their yardsticks:
# fmg1023 (ex_fmg: its 1023^2 error), eigen511 (ex_eigen_*: the plain
# route, the iterations its history takes to the example's tolerance,
# lambda_1), solve3d (ex_poisson3d), S1 (ex_distributed) and eigen511's
# kernel II (ex_distributed_eigen, the sharded II on a mesh of 1).
EXAMPLES = {
    "ex_poisson1d": ("poisson1d_vcycle", []),
    "ex_poisson2d": ("poisson2d_rbgs", ["--kernels"]),
    "ex_poisson2d_pcg": ("poisson2d_rbgs", ["--kernels", "--method", "pcg"]),
    "ex_fmg": ("fmg_accuracy", ["--kernels"]),
    "ex_fmg_cubic": ("fmg_accuracy", ["--kernels", "--cubic"]),
    "ex_eigen_ii": ("eigensolve", []),
    "ex_eigen_lobpcg": ("eigensolve", ["--method", "lobpcg"]),
    "ex_poisson3d": ("poisson3d", ["--k", str(MAIN_K3), "--smoother", "rbgs",
                                   "--kernels", "--f32"]),
    "ex_poisson3d_default": ("poisson3d", []),
    "ex_distributed": ("distributed_vcycle", ["--kernels"]),
    "ex_distributed_eigen": ("distributed_vcycle",
                             ["--kernels", "--k", str(EIGEN_K), "--f64",
                              "--eigen", "1"]),
}
# A float32 value an example prints against its phase-3 yardstick (the
# same computation on the same card): within this relative difference.
EXAMPLE_RTOL = 1e-6
# The utils on the main path: the checkpoint's partial solve stops after
# this many cycles.
CHECKPOINT_ITERS = 3

# Chained cycles a timing of v_cycles_fn runs (its time over this count).
CHAIN_CYCLES = 20
# The packed2d, fused2d and plocal2d legs are timed as single calls and as
# LEG_CHAIN back-to-back calls between one pair of events, at these sweep
# counts and at the cap.
LEG_CHAIN = 20
LEG_SWEEPS = (0, 1, 2)


class SmokeFailure(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def grids_on_card(n: int, dtype, seed: int, count: int, ndim: int = 2):
    """``count`` padded (n+2)^ndim grids with N(0,1) interiors, made on
    the card from ``seed``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    core = (slice(1, -1),) * ndim
    out = []
    for _ in range(count):
        g = torch.zeros((n + 2,) * ndim, dtype=dtype, device="cuda")
        g[core] = torch.randn((n,) * ndim, generator=gen, device="cuda",
                              dtype=torch.float64).to(dtype)
        out.append(g)
    return out


def leg_inputs(n: int, dtype, seed: int):
    """u, b, e for the legs: b is scaled by 1/h^2 so that h^2 b and the
    neighbour sum of the Gauss-Seidel update are of one size."""
    u, b = grids_on_card(n, dtype, seed, 2)
    (e,) = grids_on_card((n - 1) // 2, dtype, seed + 1, 1)
    return u, b * float((n + 1) ** 2), e


def cube_inputs(n: int, dtype, seed: int):
    """u, b on (n+2)^3, b scaled by 1/h^2 as in ``leg_inputs``."""
    u, b = grids_on_card(n, dtype, seed, 2, ndim=3)
    return u, b * float((n + 1) ** 2)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max abs error / max|want|)."""
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    return err, err / scale if scale > 0 else err


def ghosts_zero(t: torch.Tensor) -> bool:
    return all(bool((t.select(d, 0) == 0).all() and (t.select(d, -1) == 0)
                    .all()) for d in range(t.ndim))


def logical(t: torch.Tensor) -> torch.Tensor:
    """A 2D kernel output as a logical grid; raises if a packed output's
    pad lanes are not zero."""
    from multigridcmt_tpu_torch.kernels import packed2d

    if not packed2d.is_packed(t):
        return t
    u = packed2d.unpack(t)
    require(torch.equal(packed2d.pack(u), t), "packed pad lanes not zero")
    return u


def nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def phase_setup(rendezvous: str):
    import torch.distributed as dist

    from multigridcmt_tpu_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.load_library()
    log(f"kernel build+load: {time.perf_counter() - t0:.2f} s "
        f"({_build.BUILD_ROOT / _build.source_hash()}; ptxas's registers "
        f"and spills of each kernel in its {_build.LOG_NAME})")
    ptxas_report(_build.BUILD_ROOT / _build.source_hash() / _build.LOG_NAME)
    # The sharded paths' process group: a world of 1 over NCCL, its
    # rendezvous a file (no network).
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{rendezvous}",
                            world_size=1, rank=0)
    log(f"torch.distributed: {dist.get_backend()}, world of "
        f"{dist.get_world_size()}")
    return card


# A row-streaming leg or sweep kernel's mangled name: leg (or sweep), type
# (f float, d double), kind (0 Jacobi, 1 RB-GS), stages, frame, and the
# bfloat16 storage of the packed grid's modes (an f after it: the up leg's
# float32 store).
LEG_KERNEL = re.compile(r"(down|up|sweep)_kernelI([fd])Li(\d)ELi(\d+)E"
                        r"(?:Lb([01])E)?NS_\d+(Whole|Tile|Unpacked|UTile)E"
                        r"(13__nv_bfloat16(f)?)?")
# The bfloat16 rows leg_ptxas finds (frame, leg, storage, kind, packed e):
# on Whole the down leg's 2, the up leg's 8 (bfloat16 and float32 x', each
# kind, logical and packed e) and the RB-GS sweep's 1; on Tile and UTile
# the down leg's 2 and the up leg's 4 each. A renamed template must not
# make them disappear from the report.
BF16_LEG_ROWS = 2 + 8 + 1 + 2 * (2 + 4)


# The BELL SpMM kernel (accumulator type, storage type, m-tile) and the
# residual-restriction stream (type), whose ptxas report must show no
# spill.
OTHER_KERNEL = re.compile(r"(bell_spmm_kernel|residual_restrict_kernel)I([fd])"
                          r"(13__nv_bfloat16|[fd](?=Li))?(?:Li(\d+)E)?")
# The residual norm's first pass (compute type, update rule: Interior on a
# whole grid, InteriorBox on a tile, storage type).
PRESNORM_KERNEL = re.compile(r"presnorm_partialI([fd])NS_\d+([A-Za-z]+?)E"
                             r"(13__nv_bfloat16|[fd])?E")
# The float32 and float64 ptxas lines, (registers, spill bytes), of the
# kernels that took a storage type for their bfloat16 modes, as the parent
# tree (commit a2fa1c6) builds them on the card's nvcc: these must not
# move. Keys: (kernel, type, m-tile or update rule).
PARENT_PTXAS = {
    ("bell_spmm_kernel", "f32", 8): (94, 0),
    ("bell_spmm_kernel", "f32", 32): (128, 0),
    ("bell_spmm_kernel", "f32", 128): (208, 0),
    ("bell_spmm_kernel", "f64", 8): (133, 0),
    ("bell_spmm_kernel", "f64", 32): (162, 0),
    ("presnorm_partial", "f32", "Interior"): (26, 0),
    ("presnorm_partial", "f32", "InteriorBox"): (26, 0),
    ("presnorm_partial", "f64", "Interior"): (27, 0),
    ("presnorm_partial", "f64", "InteriorBox"): (27, 0),
    # The float residual-restriction stream, whose down stream took the
    # native restriction's compile-time choice of no sigma u term: as the
    # tree before it (commit 1bacba3) built it on the card.
    ("residual_restrict_kernel", "f32", 0): (114, 0),
    ("residual_restrict_kernel", "f64", 0): (183, 0),
}


# The native bfloat16 kernels of csrc/native_bf16.cu (the residual and a
# tile's RB-GS and Jacobi sweeps) and the DIA SpMV in each type (f, d,
# 13__nv_bfloat16), whose ptxas report must show no spill.
NATIVE_KERNEL = re.compile(r"native_(?:residual|rbgs|jacobi)_kernel|"
                           r"spmv_dia_kernelI(?:13__nv_bfloat16|[fd])E")
NATIVE_KERNELS = 3 + 3
# The native row streams of a whole grid's RB-GS sweeps (K = 2, 4, 6, 8
# half-sweeps; csrc/stencil2d_sweep_native_bf16.cu) and Jacobi sweeps (K =
# 1 .. 8; csrc/stencil2d_jacobi_native_bf16.cu), of the residual
# restriction (csrc/transfer2d_native_bf16.cu), and the prolongation-add's
# block kernel (csrc/transfer2d_prolong_native_bf16.cu); none may spill.
NATIVE_STREAM_KERNEL = re.compile(r"native_(jacobi_)?sweep_kernelILi(\d+)E|"
                                  r"native_residual_restrict_kernel|"
                                  r"native_prolong_add_kernel")
NATIVE_STREAM_KERNELS = 4 + 8 + 1 + 1
# The native fused2d legs on the row stream (leg, kind: 0 Jacobi, 1 RB-GS,
# stages), a kernel for each stage count: the down leg's RB-GS 0, 2, 4, 6
# and Jacobi 0 to 6, the up leg's RB-GS 0 to 8 by 2 and Jacobi 0 to 8;
# none may spill.
NATIVE_LEG_KERNEL = re.compile(r"native_(down|up)_kernelILi([01])ELi(\d+)E")
NATIVE_LEG_KERNELS = 4 + 7 + 5 + 9


# A stencil3d z-march kernel's mangled name: kernel, compute type, band
# rows, mode (the pass: 0 residual, 1 Jacobi), and the bfloat16 storage (an
# f after it: a float32 output).
# The paired marches (rbgs_pairs_kernel<O>: I13__nv_bfloat16 or If;
# jacobi_pairs_kernel<ROdd>: ILb1E or ILb0E) and the paired packed
# residual.
PAIR_KERNEL = re.compile(r"rbgs_pairs_kernelI(?:13__nv_bfloat16|f)|"
                         r"jacobi_pairs_kernelILb[01]E|"
                         r"presidual_pairs_kernel")
STENCIL3D_KERNEL = re.compile(r"(rbgs|pass)_kernelI([fd])Li(\d+)E"
                              r"(?:Li([01])E)?(13__nv_bfloat16(f)?)?")


def ptxas_props(text: str) -> dict:
    """{mangled kernel name: {"regs": registers, "spill": spill bytes}}
    from ptxas's -v output."""
    props = {}
    name = None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            props.setdefault(name, {})["spill"] = int(m.group(1)) + int(
                m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            props.setdefault(name, {})["regs"] = int(m.group(1))
    return props


def stencil3d_ptxas(props: dict) -> dict:
    """{(kernel, storage, mode): (registers, spill bytes)} of the stencil3d
    kernels among ``props``; storage "f32", "f64", "bf16" or "bf16
    f32-out"."""
    out = {}
    for mangled, prop in props.items():
        m = STENCIL3D_KERNEL.search(mangled)
        if not m or "regs" not in prop:
            continue
        kernel, ty, _, mode, bf16, f32_out = m.groups()
        storage = (("bf16" + (" f32-out" if f32_out else "")) if bf16
                   else "f32" if ty == "f" else "f64")
        what = {None: "sweep", "0": "residual", "1": "jacobi"}[mode]
        out[(kernel, storage, what)] = (prop["regs"], prop.get("spill", 0))
    return out


def leg_ptxas(props: dict) -> dict:
    """{(frame, leg, storage, kind, "packed e" or ""): [(stages,
    registers, spill bytes)]} of the row-streaming leg and sweep kernels
    among ``props``; storage "f32", "f64", "bf16" or "bf16 f32-out"."""
    rows = {}
    for mangled, prop in props.items():
        m = LEG_KERNEL.search(mangled)
        if not m or "regs" not in prop:
            continue
        leg, ty, kind, stages, packed_e, frame, bf16, f32_out = m.groups()
        key = (frame, leg, ("bf16" + (" f32-out" if f32_out else "")) if bf16
               else "f32" if ty == "f" else "f64",
               "rbgs" if kind == "1" else "jacobi",
               "packed e" if packed_e == "1" else "")
        rows.setdefault(key, []).append(
            (int(stages), prop["regs"], prop.get("spill", 0)))
    return {key: sorted(cells) for key, cells in rows.items()}


def ptxas_report(log_path) -> dict:
    """Log ptxas's registers and spill bytes of every row-streaming leg
    and sweep kernel, a line a frame, leg, type and kind (stage counts in
    order; the up leg's packed-e twins on the whole grid apart), of the
    stencil3d z-march kernels (a line a kernel and storage; returned, as
    stencil3d_ptxas gives them), and of the BELL SpMM kernels (a line a
    type, m-tiles in order) and the residual-restriction stream; fail if
    one of the last two spills."""
    props = ptxas_props(Path(log_path).read_text(encoding="utf-8",
                                                 errors="replace"))
    march = stencil3d_ptxas(props)
    require({k[1] for k in march} == {"f32", "f64", "bf16", "bf16 f32-out"},
            f"ptxas report lacks stencil3d kernels: {sorted(march)}")
    for key in sorted(march):
        regs, spill = march[key]
        log(f"ptxas stencil3d {' '.join(key)}: {regs}r"
            + (f" spill {spill}B" if spill else ""))
    pairs = {PAIR_KERNEL.search(k).group(0): prop for k, prop in props.items()
             if PAIR_KERNEL.search(k) and "regs" in prop}
    require(len(pairs) == 5, f"ptxas report has {sorted(pairs)}, not the "
            "paired RB-GS march's two kernels, the paired Jacobi march's "
            "two and the paired residual")
    for key, prop in sorted(pairs.items()):
        log(f"ptxas {key}: {prop['regs']}r"
            + (f" spill {prop['spill']}B" if prop.get("spill") else ""))
        require(not prop.get("spill"), f"ptxas: {key} spills")
    rows = leg_ptxas(props)
    for key in sorted(rows):
        cells = ", ".join(f"K={k} {r}r" + (f" spill {sp}B" if sp else "")
                          for k, r, sp in rows[key])
        log(f"ptxas {' '.join(x for x in key if x)}: {cells}")
    bf16_rows = sum(key[2].startswith("bf16") for key in rows)
    require(bf16_rows == BF16_LEG_ROWS,
            f"ptxas report has {bf16_rows} bfloat16 leg and sweep rows, not "
            f"{BF16_LEG_ROWS}")
    others, lines = {}, {}
    for mangled, prop in props.items():
        m = OTHER_KERNEL.search(mangled)
        if m and "regs" in prop:
            name, ty, storage, tile = m.groups()
            kind = ("bf16" if storage == "13__nv_bfloat16"
                    else "f32" if ty == "f" else "f64")
            others.setdefault((name, kind), []).append(
                (int(tile or 0), prop["regs"], prop.get("spill", 0)))
            lines[(name, kind, int(tile or 0))] = (prop["regs"],
                                                   prop.get("spill", 0))
        m = PRESNORM_KERNEL.search(mangled)
        if m and "regs" in prop:
            ty, upd, storage = m.groups()
            kind = ("bf16" if storage == "13__nv_bfloat16"
                    else "f32" if ty == "f" else "f64")
            lines[("presnorm_partial", kind, upd)] = (prop["regs"],
                                                      prop.get("spill", 0))
    require(set(others) == {(k, t) for k in ("bell_spmm_kernel",
                                             "residual_restrict_kernel")
                            for t in ("f32", "f64")}
            | {("bell_spmm_kernel", "bf16")},
            f"ptxas report lacks the BELL or residual-restriction kernels: "
            f"{sorted(others)}")
    for key in sorted(others):
        cells = ", ".join((f"MT={t} " if t else "") + f"{r}r"
                          + (f" spill {sp}B" if sp else "")
                          for t, r, sp in sorted(others[key]))
        log(f"ptxas {' '.join(key)}: {cells}")
        require(all(sp == 0 for *_, sp in others[key]),
                f"ptxas: {' '.join(key)} spills ({cells})")
    norms = sorted(k for k in lines if k[0] == "presnorm_partial")
    require(norms == [("presnorm_partial", t, u) for t in ("bf16", "f32",
                                                           "f64")
                      for u in ("Interior", "InteriorBox")],
            f"ptxas report lacks presnorm_partial kernels: {norms}")
    for key in norms:
        regs, spill = lines[key]
        log(f"ptxas {' '.join(key)}: {regs}r"
            + (f" spill {spill}B" if spill else ""))
    native = {NATIVE_KERNEL.search(k).group(0): prop
              for k, prop in props.items()
              if NATIVE_KERNEL.search(k) and "regs" in prop}
    require(len(native) == NATIVE_KERNELS, f"ptxas report has "
            f"{sorted(native)}, not native_bf16.cu's three kernels and the "
            "SpMV in three types")
    for key, prop in sorted(native.items()):
        log(f"ptxas {key}: {prop['regs']}r"
            + (f" spill {prop['spill']}B" if prop.get("spill") else ""))
        require(not prop.get("spill"), f"ptxas: {key} spills")
    native = {}
    for mangled, prop in props.items():
        m = NATIVE_STREAM_KERNEL.search(mangled)
        if m and "regs" in prop:
            jacobi, stages = m.groups()
            key = (f"native sweep {'jacobi' if jacobi else 'rbgs'} "
                   f"K={stages}" if stages
                   else "native prolongation-add" if "prolong" in m.group(0)
                   else "native residual restriction")
            native[key] = prop
    require(len(native) == NATIVE_STREAM_KERNELS, f"ptxas report has "
            f"{sorted(native)}, not the {NATIVE_STREAM_KERNELS} native "
            "sweep and restriction streams and prolongation-add kernels")
    for key, prop in sorted(native.items()):
        log(f"ptxas {key}: {prop['regs']}r"
            + (f" spill {prop['spill']}B" if prop.get("spill") else ""))
        require(not prop.get("spill"), f"ptxas: {key} spills")
    streams = {}
    for mangled, prop in props.items():
        m = NATIVE_LEG_KERNEL.search(mangled)
        if m and "regs" in prop:
            leg, kind, stages = m.groups()
            streams.setdefault((leg, "rbgs" if kind == "1" else "jacobi"),
                               []).append((int(stages), prop["regs"],
                                           prop.get("spill", 0)))
    require(sum(map(len, streams.values())) == NATIVE_LEG_KERNELS,
            f"ptxas report has {streams}, not the {NATIVE_LEG_KERNELS} "
            "native leg kernels")
    for key, cells in sorted(streams.items()):
        line = ", ".join(f"K={k} {r}r" + (f" spill {sp}B" if sp else "")
                         for k, r, sp in sorted(cells))
        log(f"ptxas native {' '.join(key)} leg: {line}")
        require(all(sp == 0 for *_, sp in cells),
                f"ptxas: native {' '.join(key)} leg spills ({line})")
    # The float32 and float64 kernels that took a storage type compile as
    # the parent's did.
    moved = {key: (lines.get(key), want) for key, want in PARENT_PTXAS.items()
             if lines.get(key) != want}
    log(f"ptxas against the parent's lines: {len(PARENT_PTXAS) - len(moved)}"
        f" of {len(PARENT_PTXAS)} equal")
    require(not moved, f"ptxas lines moved from the parent's (now, then): "
            f"{moved}")
    return march


def check_pair(label: str, got, want, tol: float, shape=None,
               ghosts: bool = True):
    """Hold a kernel output against its plain version; returns (max abs
    error, relative error, tol). Arrays: relative to max|want|, ghosts
    zero (unless ``ghosts`` is False: a plane stack's edge rows); 0-d:
    relative to |want|."""
    torch.cuda.synchronize()
    if got.ndim == 0:
        err = (got - want).abs().item()
        rel = err / max(want.abs().item(), 1e-300)
        ok = got.shape == want.shape
    else:
        g, w = logical(got), logical(want)
        err, rel = rel_err(g, w)
        ok = ((not ghosts or ghosts_zero(g))
              and (shape is None or tuple(g.shape) == shape)
              and bool(g.isfinite().all()))
    log(f"  {label}: rel {rel:.3e}")
    require(ok and rel <= tol, f"{label}: rel {rel:.3e} > {tol} or bad "
            "ghosts/shape/values")
    return err, rel, tol


def compare_2d(main_err: dict) -> None:
    from multigridcmt_tpu_torch.kernels import fused2d, packed2d, stencil2d

    packed, unpacked = 2 ** MAIN_K - 1, 2 ** (MAIN_K - 1) - 1
    for dtype, n in COMPARE_SHAPES:
        h = 1.0 / (n + 1)
        nc = (n - 1) // 2
        tol = TOL[dtype]
        u, b, e = leg_inputs(n, dtype, seed=n)
        su, sb = packed2d.pack(u), packed2d.pack(b)
        name = f"{str(dtype).split('.')[-1]} n={n}"
        main = dtype == torch.float32
        for sigma in (0.0, SIGMA):
            err = check_pair(
                f"residual {name} sigma={sigma}",
                stencil2d.residual(u, b, n, h, sigma=sigma),
                stencil2d.residual_plain(u, b, n, h, sigma=sigma), tol)
            if main and n == unpacked and sigma == 0.0:
                main_err["stencil2d_residual"] = err
            for red_only in (False, True):
                err = check_pair(
                    f"resnorm {name} red_only={red_only} sigma={sigma}",
                    packed2d.residual_norm_sq(su, sb, n, h, sigma=sigma,
                                              red_only=red_only),
                    packed2d.residual_norm_sq_plain(
                        su, sb, n, h, sigma=sigma, red_only=red_only), tol)
                if main and n == packed and red_only and sigma == 0.0:
                    main_err["packed2d_resnorm"] = err
            for kind, omega in (("rbgs", 1.0), ("jacobi", 0.8)):
                kw = dict(kind=kind, omega=omega, sigma=sigma)
                at_main = main and kind == "rbgs" and sigma == 0.0
                for sweeps in sorted({2, fused2d.max_down_sweeps(kind)}):
                    gu, grc = fused2d.smooth_residual_restrict(
                        u, b, n, h, sweeps=sweeps, **kw)
                    wu, wrc = fused2d.smooth_residual_restrict_plain(
                        u, b, n, h, sweeps=sweeps, **kw)
                    label = f"down {name} {kind} nu={sweeps} sigma={sigma}"
                    err = max(check_pair(label + " u'", gu, wu, tol),
                              check_pair(label + " r_c", grc, wrc, tol,
                                         (nc + 2, nc + 2)),
                              key=lambda t: t[1])
                    if at_main and n == unpacked and sweeps == 2:
                        main_err["fused2d_down"] = err
                for sweeps in sorted({2, fused2d.max_up_sweeps(kind)}):
                    err = check_pair(
                        f"up {name} {kind} nu={sweeps} sigma={sigma}",
                        fused2d.prolong_add_smooth(u, e, b, n, nc, h,
                                                   sweeps=sweeps, **kw),
                        fused2d.prolong_add_smooth_plain(
                            u, e, b, n, nc, h, sweeps=sweeps, **kw), tol)
                    if at_main and n == unpacked and sweeps == 2:
                        main_err["fused2d_up"] = err
        del u, b, e, su, sb


def off_pair(t: torch.Tensor) -> torch.Tensor:
    """t's values in a contiguous view that starts one element into a fresh
    buffer: not on a pair of elements."""
    buf = torch.zeros(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def compare_fused_legs() -> None:
    """The fused2d legs against their plain versions at FUSED_LEG_SHAPES,
    every sweep count from 0 to the cap, both kinds and both sigmas
    (compare_2d holds them at COMPARE_SHAPES at nu = 2 and the cap); at
    n <= 31 also with u and b off a pair of elements, which the kernels'
    paired accesses refuse and the wrappers copy onto a pair."""
    from multigridcmt_tpu_torch.kernels import fused2d

    for dtype, n, off in [(d, n, False) for d, n in FUSED_LEG_SHAPES] + [
            (d, n, True) for d, n in FUSED_LEG_SHAPES if n <= 31]:
        h = 1.0 / (n + 1)
        nc = (n - 1) // 2
        tol = TOL[dtype]
        u, b, e = leg_inputs(n, dtype, seed=n + 5)
        if off:
            u, b = off_pair(u), off_pair(b)
        name = f"{str(dtype).split('.')[-1]} n={n}" + (" off" if off else "")
        for sigma in (0.0, SIGMA):
            for kind, omega in (("rbgs", 1.0), ("jacobi", 0.8)):
                kw = dict(kind=kind, omega=omega, sigma=sigma)
                for sweeps in range(fused2d.max_down_sweeps(kind) + 1):
                    label = f"fused down {name} {kind} nu={sweeps} " \
                            f"sigma={sigma}"
                    gu, grc = fused2d.smooth_residual_restrict(
                        u, b, n, h, sweeps=sweeps, **kw)
                    wu, wrc = fused2d.smooth_residual_restrict_plain(
                        u, b, n, h, sweeps=sweeps, **kw)
                    check_pair(label + " u'", gu, wu, tol)
                    check_pair(label + " r_c", grc, wrc, tol,
                               (nc + 2, nc + 2))
                for sweeps in range(fused2d.max_up_sweeps(kind) + 1):
                    check_pair(
                        f"fused up {name} {kind} nu={sweeps} sigma={sigma}",
                        fused2d.prolong_add_smooth(u, e, b, n, nc, h,
                                                   sweeps=sweeps, **kw),
                        fused2d.prolong_add_smooth_plain(
                            u, e, b, n, nc, h, sweeps=sweeps, **kw), tol)
        del u, b, e


def compare_packed_legs(main_err: dict) -> None:
    """The packed2d legs against their plain versions: at COMPARE_SHAPES
    and PACKED_LEG_SHAPES (partial strips and segments; a grid inside one
    block) at nu = 2 and the cap, both kinds, both sigmas, logical and
    packed coarse grids; at PACKED_LEG_ALL_NU every sweep count from 0 to
    the cap, the row-stream lags being a function of it."""
    from multigridcmt_tpu_torch.kernels import packed2d

    for dtype, n in COMPARE_SHAPES + PACKED_LEG_SHAPES:
        h = 1.0 / (n + 1)
        nc = (n - 1) // 2
        tol = TOL[dtype]
        u, b, e = leg_inputs(n, dtype, seed=n)
        su, sb, se = packed2d.pack(u), packed2d.pack(b), packed2d.pack(e)
        del u, b
        name = f"{str(dtype).split('.')[-1]} n={n}"
        all_nu = (dtype, n) == PACKED_LEG_ALL_NU
        for sigma in (0.0, SIGMA):
            for kind, omega in (("rbgs", 1.0), ("jacobi", 0.8)):
                kw = dict(kind=kind, omega=omega, sigma=sigma)
                at_main = (dtype == torch.float32 and n == 2 ** MAIN_K - 1
                           and kind == "rbgs" and sigma == 0.0)
                down_cap = packed2d.max_down_sweeps(kind)
                for sweeps in (range(down_cap + 1) if all_nu
                               else sorted({2, down_cap})):
                    for pc in (False, True):
                        gu, grc = packed2d.smooth_residual_restrict(
                            su, sb, n, h, sweeps=sweeps, packed_coarse=pc,
                            **kw)
                        wu, wrc = packed2d.smooth_residual_restrict_plain(
                            su, sb, n, h, sweeps=sweeps, packed_coarse=pc,
                            **kw)
                        label = (f"packed down {name} {kind} nu={sweeps} "
                                 f"sigma={sigma} packed_coarse={pc}")
                        err = max(check_pair(label + " u'", gu, wu, tol),
                                  check_pair(label + " r_c", grc, wrc, tol,
                                             (nc + 2, nc + 2)),
                                  key=lambda t: t[1])
                        if at_main and sweeps == 2 and not pc:
                            main_err["packed2d_down"] = err
                up_cap = packed2d.max_up_sweeps(kind)
                for sweeps in (range(up_cap + 1) if all_nu
                               else sorted({2, up_cap})):
                    for ee in (e, se):
                        err = check_pair(
                            f"packed up {name} {kind} nu={sweeps} "
                            f"sigma={sigma} packed_e={ee is se}",
                            packed2d.prolong_add_smooth(
                                su, ee, sb, n, nc, h, sweeps=sweeps, **kw),
                            packed2d.prolong_add_smooth_plain(
                                su, ee, sb, n, nc, h, sweeps=sweeps, **kw),
                            tol)
                        if at_main and sweeps == 2 and ee is e:
                            main_err["packed2d_up"] = err
        del e, su, sb, se


def compare_packed_residual(main_err: dict) -> None:
    from multigridcmt_tpu_torch.kernels import packed2d

    for dtype, n in PACKED_RESIDUAL_SHAPES:
        h = 1.0 / (n + 1)
        u, b, _ = leg_inputs(n, dtype, seed=n + 3)
        su, sb = packed2d.pack(u), packed2d.pack(b)
        for sigma in (0.0, SIGMA):
            err = check_pair(
                f"packed residual {str(dtype).split('.')[-1]} n={n} "
                f"sigma={sigma}",
                packed2d.residual(su, sb, n, h, sigma=sigma),
                packed2d.residual_plain(su, sb, n, h, sigma=sigma),
                TOL[dtype])
            if n == 2 ** MAIN_K - 1 and sigma == 0.0:
                main_err["packed2d_residual"] = err
        del u, b, su, sb


def check_bf16(label: str, got, want, f32_out: bool = False,
               ghosts: bool = True):
    """Hold a bfloat16 kernel output against its plain version: each point
    within one bfloat16 ulp of the plain value plus BF16_SCALE_TOL of
    max|plain|, at most BF16_SHARE of the points not equal, ghosts and pad
    lanes zero (unless ``ghosts`` is False: a plane stack's edge rows).
    With ``f32_out`` both are float32 (a stencil3d sweep's out_dtype: red
    points rounded to bfloat16, black ones not) and a point counts as
    differing where it parts by more than TOL[float32] of max|plain|.
    Returns (max abs error, relative error, tol) as check_pair, tol the
    relative error the rule allows at the largest value (an ulp is at most
    2^-7 of a value)."""
    torch.cuda.synchronize()
    dtype = torch.float32 if f32_out else torch.bfloat16
    require(got.dtype == want.dtype == dtype,
            f"{label}: {got.dtype} against {want.dtype}, not {dtype}")
    g, w = logical(got).double(), logical(want).double()
    diff = (g - w).abs()
    scale = w.abs().max().item()
    _, ex = torch.frexp(w)
    ulp = torch.where(w != 0, torch.ldexp(torch.ones_like(w), ex - 8),
                      torch.zeros_like(w))
    excess = (diff - ulp - BF16_SCALE_TOL * scale).max().item()
    noise = TOL[torch.float32] * scale if f32_out else 0.0
    share = (diff > noise).double().mean().item()
    ulps = (diff / torch.where(ulp > 0, ulp, torch.full_like(ulp, math.inf))
            ).max().item()
    err = diff.max().item()
    rel = err / scale if scale > 0 else err
    log(f"  {label}: rel {rel:.3e}, {share:.2e} of the points differ, at "
        f"most {ulps:.3g} ulp")
    require((not ghosts or ghosts_zero(g)) and bool(g.isfinite().all())
            and excess <= 0 and share <= BF16_SHARE,
            f"{label}: {share:.3e} of the points differ (> {BF16_SHARE}), "
            f"or by more than an ulp + {BF16_SCALE_TOL} of the scale "
            f"({excess:.3e} past it), or bad ghosts/values")
    return err, rel, 2.0 ** -7 + BF16_SCALE_TOL


def bf16_inputs(n: int, seed: int):
    """leg_inputs rounded to bfloat16 (u and b; e, a coarse operand, stays
    float32)."""
    from multigridcmt_tpu_torch.kernels import packed2d

    u, b, e = leg_inputs(n, torch.float32, seed=seed)
    su = packed2d.pack(u).to(torch.bfloat16)
    sb = packed2d.pack(b).to(torch.bfloat16)
    return su, sb, e, packed2d.pack(e)


def compare_mixed(main_err: dict) -> None:
    """The packed2d kernels' bfloat16 modes against their plain versions at
    MIXED_SHAPES: at 4095 RB-GS nu = 0 and 2 and Jacobi nu = 2 legs (the up
    leg storing bfloat16 and float32), the 1- and 4-sweep RB-GS sweep and
    the residual, both sigmas; at 2999 and 61 every sweep count up to the
    caps, logical and packed coarse grids."""
    from multigridcmt_tpu_torch.kernels import packed2d

    f32 = torch.float32
    plain_down = packed2d.smooth_residual_restrict_plain
    for n in MIXED_SHAPES:
        h = 1.0 / (n + 1)
        nc = (n - 1) // 2
        su, sb, e, se = bf16_inputs(n, seed=n + 21)
        main = n == 2 ** MAIN_K - 1
        for sigma in ((0.0, SIGMA) if main else (SIGMA,) if n > 61
                      else (0.0,)):
            for kind, omega in (("rbgs", 1.0), ("jacobi", 0.8)):
                kw = dict(kind=kind, omega=omega, sigma=sigma)
                at_main = main and kind == "rbgs" and sigma == 0.0
                legs = {"down": packed2d.max_down_sweeps(kind),
                        "up": packed2d.max_up_sweeps(kind)}
                for leg, cap in legs.items():
                    nus = (((0, 2) if kind == "rbgs" else (2,)) if main
                           else range(cap + 1))
                    for nu in nus:
                        name = (f"bf16 packed {leg} n={n} {kind} nu={nu} "
                                f"sigma={sigma}")
                        if leg == "down":
                            for pc in ((False,) if main else (False, True)):
                                gu, grc = packed2d.smooth_residual_restrict(
                                    su, sb, n, h, sweeps=nu,
                                    packed_coarse=pc, **kw)
                                wu, _ = plain_down(su, sb, n, h, sweeps=nu,
                                                   packed_coarse=pc, **kw)
                                label = f"{name} packed_coarse={pc}"
                                require(grc.dtype == f32,
                                        f"{label}: r_c is {grc.dtype}")
                                want = packed2d.residual_restrict_plain(
                                    gu, sb, n, h, sigma=sigma,
                                    red_only=kind == "rbgs" and nu >= 1,
                                    packed_coarse=pc)
                                err = max(check_bf16(label + " u'", gu, wu),
                                          check_pair(label + " r_c", grc,
                                                     want, TOL[f32],
                                                     (nc + 2, nc + 2)),
                                          key=lambda t: t[1])
                                if at_main and nu == 2:
                                    main_err["packed2d_down_bf16"] = err
                            continue
                        for ee in ((e,) if main else (e, se)):
                            for out in (torch.bfloat16, f32):
                                label = (f"{name} packed_e={ee is se} "
                                         f"out={str(out).split('.')[-1]}")
                                got = packed2d.prolong_add_smooth(
                                    su, ee, sb, n, nc, h, sweeps=nu,
                                    out_dtype=out, **kw)
                                want = packed2d.prolong_add_smooth_plain(
                                    su, ee, sb, n, nc, h, sweeps=nu,
                                    out_dtype=out, **kw)
                                err = (check_bf16(label, got, want)
                                       if out == torch.bfloat16 else
                                       check_pair(label, got, want,
                                                  TOL[f32]))
                                require(got.dtype == out,
                                        f"{label}: x' is {got.dtype}")
                                if at_main and nu == 2:
                                    main_err["packed2d_up_bf16" + (
                                        "" if out == torch.bfloat16
                                        else "_f32")] = err
            for nu in ((1, 4) if main else range(1, 5)):
                err = check_bf16(
                    f"bf16 packed rbgs sweep n={n} nu={nu} sigma={sigma}",
                    packed2d.rbgs_sweep(su, sb, n, h, sweeps=nu,
                                        sigma=sigma),
                    packed2d.rbgs_sweep_plain(su, sb, n, h, sweeps=nu,
                                              sigma=sigma))
                if main and nu == 4 and sigma == 0.0:
                    main_err["packed2d_rbgs_bf16"] = err
            # The paired kernel where cp is odd (4095, 2999), the scalar
            # one elsewhere (61): both against the plain version.
            before = packed2d.residual_bf16_pairs_launches
            err = check_bf16(
                f"bf16 packed residual n={n} sigma={sigma}",
                packed2d.residual(su, sb, n, h, sigma=sigma),
                packed2d.residual_plain(su, sb, n, h, sigma=sigma))
            paired = packed2d.residual_bf16_pairs_launches - before
            require(paired == (packed2d.packed_shape(n)[2] % 2),
                    f"bf16 packed residual n={n}: {paired} paired launches")
            if main and sigma == 0.0:
                main_err["packed2d_residual_bf16"] = err
        del su, sb, e, se
        torch.cuda.empty_cache()


def compare_mixed_sharded(main_err: dict) -> None:
    """The local2d and plocal2d legs' bfloat16 modes (the down leg; the
    up leg storing bfloat16 and float32) against their plain versions on
    bfloat16 forms of S1's fine tile (4112 x 4097, a row tile: paired
    accesses on its odd rows), S2's block tile (2064 x 2064, odd column
    offset: none) and the two offset tiles of compare_local2d, each
    unpacked and packed, at MIXED_TILE_RUNS; the coarse right-hand side
    against the plain restriction of the kernel's own stored u' (the red
    residual only after an RB-GS sweep on a packed tile). The main-path
    error of each mode is S1's fine tile's (unpacked: local2d, packed:
    plocal2d) at the first run."""
    from multigridcmt_tpu_torch.kernels import local2d, plocal2d

    bf, f32 = torch.bfloat16, torch.float32
    tiles = [(2 ** MAIN_K - 1, 1, 0, 0, 0),
             (2 ** SHARDED_PATHS["S2"][0] - 1, 1, 0, 1, 0)]
    tiles += list(LOCAL2D_TILES)
    for n, dr, r, dc, c in tiles:
        ue, be, e, t = local2d_tile(n, f32, n + r + c + 51, (dr, dc), (r, c))
        ue, be = ue.to(bf), be.to(bf)
        h, nc, m, mcol = 1.0 / (n + 1), (n - 1) // 2, t["m"], t["mcol"]
        offs = (t["row_off"], t["col_off"])
        cols, cpar = ue.shape[1], 1 if mcol else 0
        main = (n, dr, dc) == (2 ** MAIN_K - 1, 1, 0)
        for packed in (False, True):
            mod = plocal2d if packed else local2d
            if packed:
                su, sb = plocal2d.pack_ext(ue, cpar), plocal2d.pack_ext(be,
                                                                        cpar)
            else:
                su, sb = ue, be

            def view(x):
                return unpacked_tile(x, cols, cpar) if packed else x

            name = "plocal2d" if packed else "local2d"
            label = (f"bf16 {name} n={n} tile {tuple(ue.shape)} offsets "
                     f"{offs}")
            for run, (kind, nu, sigma) in enumerate(MIXED_TILE_RUNS):
                kw = dict(kind=kind, omega=0.8 if kind == "jacobi" else 1.0,
                          sweeps=nu, sigma=sigma, mcol=mcol)
                what = f"{label} {kind} nu={nu} sigma={sigma}"
                gu, grc = mod.down_leg(su, sb, n, h, m, *offs, **kw)
                wu, _ = mod.down_leg_plain(su, sb, n, h, m, *offs, **kw)
                require(gu.dtype == bf and grc.dtype == f32,
                        f"{what}: u' {gu.dtype}, r_c {grc.dtype}")
                want = mod.residual_restrict_plain(
                    gu, sb, n, h, m, *offs, sigma=sigma, mcol=mcol,
                    red_only=packed and kind == "rbgs" and nu >= 1)
                errs = {"down_bf16": max(
                    check_bf16(f"{what} down u'", view(gu), view(wu),
                               ghosts=False),
                    check_pair(f"{what} down r_c", grc, want, TOL[f32],
                               tuple(e.shape), ghosts=False),
                    key=lambda v: v[1])}
                for out in (bf, f32):
                    got = mod.up_leg(su, e, sb, n, nc, h, m, *offs,
                                     out_dtype=out, **kw)
                    want = mod.up_leg_plain(su, e, sb, n, nc, h, m, *offs,
                                            out_dtype=out, **kw)
                    require(got.dtype == out, f"{what}: x' is {got.dtype}")
                    tag = "up_bf16" if out == bf else "up_bf16_f32"
                    errs[tag] = (
                        check_bf16(f"{what} up out=bf16", view(got),
                                   view(want), ghosts=False)
                        if out == bf else
                        check_pair(f"{what} up out=float32", view(got),
                                   view(want), TOL[f32], ghosts=False))
                if main and run == 0:
                    main_err.update({f"{name}_{k}": v
                                     for k, v in errs.items()})
            del su, sb
        del ue, be, e
        torch.cuda.empty_cache()


def check_norm_f32(label: str, got, want):
    """A bfloat16 mode's norm: a 0-d float32 tensor, within TOL[float32]
    of its plain version's value (check_pair's 0-d rule)."""
    require(got.dtype == want.dtype == torch.float32 and got.shape == (),
            f"{label}: {got.dtype} {tuple(got.shape)}, not a float32 scalar")
    return check_pair(label, got, want, TOL[torch.float32])


def bell_bf16_bench():
    """The bench's BELL matrix and Xt (``bell_bench``) rounded to
    bfloat16."""
    _, ab, xt = bell_bench()
    return (dataclasses.replace(ab, data=ab.data.to(torch.bfloat16)),
            xt.to(torch.bfloat16))


def compare_cdt_bf16(main_err: dict) -> None:
    """The last bfloat16 modes of the _cdt family (no path runs them)
    against their plain versions by check_bf16's rule, a norm (a float32
    scalar) to TOL[float32] of its value: the plocal2d residual, apply and
    norm (red only and both planes) on the bfloat16 form of S1's packed
    fine tile (2 x 4112 x 2049) and of LOCAL2D_TILES' packed tiles (an
    8-way row rank, a 2x2 block rank with col_off odd), sigma 0 and SIGMA;
    the whole grid's norm at 4095^2, red only and both planes, both sigmas;
    the BELL SpMM on the bench matrix in bfloat16 (m = 128, twice: the
    second call bit for bit the first), its 8-row carrier (bell.spmv), 4 x 3
    blocks of 128^2 with kmax BELL_BF16_PAD above the densest block row (m
    = 16), and NaN and Inf in Xt's first block column (m = 128 and 8). The
    main-path errors: S1's tile at sigma 0 (the norm's larger of its two
    modes), the whole grid red only at sigma 0, the bench at m = 128."""
    from multigridcmt_tpu_torch.kernels import bell, packed2d, plocal2d

    bf, f32 = torch.bfloat16, torch.float32
    for n, dr, r, dc, c in ((2 ** MAIN_K - 1, 1, 0, 0, 0), *LOCAL2D_TILES):
        ue, be, _, t = local2d_tile(n, f32, n + r + c + 71, (dr, dc), (r, c))
        cols, cpar = ue.shape[1], 1 if t["mcol"] else 0
        su, sb = (plocal2d.pack_ext(g, cpar).to(bf) for g in (ue, be))
        del ue, be
        h, m, mcol = 1.0 / (n + 1), t["m"], t["mcol"]
        offs = (t["row_off"], t["col_off"])
        label = (f"bf16 plocal2d n={n} tile {tuple(su.shape)} offsets "
                 f"{offs}")

        def tile(x):
            return unpacked_tile(x, cols, cpar)

        for sigma in (0.0, SIGMA):
            what = f"{label} sigma={sigma}"
            errs = {
                "plocal2d_residual_bf16": check_bf16(
                    f"{what} residual",
                    tile(plocal2d.residual(su, sb, n, h, *offs,
                                           sigma=sigma)),
                    tile(plocal2d.residual_plain(su, sb, n, h, *offs,
                                                 sigma=sigma)),
                    ghosts=False),
                "plocal2d_apply_bf16": check_bf16(
                    f"{what} apply",
                    tile(plocal2d.apply_op(su, n, h, *offs, sigma=sigma)),
                    tile(plocal2d.apply_op_plain(su, n, h, *offs,
                                                 sigma=sigma)),
                    ghosts=False),
                "plocal2d_resnorm_bf16": max((check_norm_f32(
                    f"{what} norm red_only={ro}",
                    plocal2d.residual_norm_sq(su, sb, n, h, m, *offs,
                                              mcol=mcol, red_only=ro,
                                              sigma=sigma),
                    plocal2d.residual_norm_sq_plain(su, sb, n, h, m, *offs,
                                                    mcol=mcol, red_only=ro,
                                                    sigma=sigma))
                    for ro in (False, True)), key=lambda v: v[1])}
            if (n, dr, dc) == (2 ** MAIN_K - 1, 1, 0) and sigma == 0.0:
                main_err.update(errs)
        del su, sb
        torch.cuda.empty_cache()

    n = 2 ** MAIN_K - 1
    h = 1.0 / (n + 1)
    su, sb, _, _ = bf16_inputs(n, seed=n + 77)
    for sigma in (0.0, SIGMA):
        for ro in (True, False):
            err = check_norm_f32(
                f"bf16 packed2d norm n={n} red_only={ro} sigma={sigma}",
                packed2d.residual_norm_sq(su, sb, n, h, red_only=ro,
                                          sigma=sigma),
                packed2d.residual_norm_sq_plain(su, sb, n, h, red_only=ro,
                                                sigma=sigma))
            if ro and sigma == 0.0:
                main_err["packed2d_resnorm_bf16"] = err
    del su, sb
    torch.cuda.empty_cache()

    torch.backends.cuda.matmul.allow_tf32 = False     # as compare_sparse
    ab, xt = bell_bf16_bench()
    want = bell.spmm_plain(ab, xt)
    got = bell.spmm(ab, xt)
    main_err["bell_spmm_bf16"] = check_bf16(
        f"bf16 bell_spmm bench kmax={ab.kmax} m={BELL_M}", got, want,
        ghosts=False)
    require(torch.equal(bell.spmm(ab, xt), got),
            "bf16 bell_spmm: a second call differs from the first")
    check_bf16("bf16 bell spmv carrier bench", bell.spmv(ab, xt[0]),
               want[0, :ab.shape[0]], ghosts=False)
    xn = xt.clone()
    xn[0, 5] = float("nan")
    xn[BELL_M - 1, 100] = float("inf")
    xn[3, 127] = -float("inf")
    for m in (BELL_M, 8):
        xm = xn[:m].contiguous()
        check_nonfinite(f"bf16 bell_spmm bench m={m}, NaN and Inf in block "
                        "column 0", bell.spmm(ab, xm).float(),
                        bell.spmm_plain(ab, xm).float(),
                        2.0 ** -7 + BF16_SCALE_TOL)
    del ab, xt, want, got, xn, xm
    a_sp, rng = blocks_4x3(29)
    need = bell.bell_from_scipy(a_sp, device="cpu").kmax
    ab = bell.bell_from_scipy(a_sp, dtype=bf, kmax=need + BELL_BF16_PAD,
                              device="cuda")
    xt = torch.from_numpy(rng.standard_normal((16, 3 * 128))).to(
        device="cuda", dtype=bf)
    check_bf16(f"bf16 bell_spmm 4x3 blocks kmax={ab.kmax} (densest "
               f"{need}) m=16", bell.spmm(ab, xt), bell.spmm_plain(ab, xt),
               ghosts=False)


def check_native_bits(label: str, got, want):
    """A native bfloat16 kernel output equal to its plain version's bit
    for bit, NaN exactly where the plain version has NaN (a NaN's payload
    aside). Returns (max abs error, relative error, tol) as check_pair: 0
    where equal, tol 0."""
    torch.cuda.synchronize()
    require(got.dtype == want.dtype == torch.bfloat16
            and got.shape == want.shape,
            f"{label}: {got.dtype} {tuple(got.shape)} against {want.dtype} "
            f"{tuple(want.shape)}")
    nan = want.isnan()
    differ = int(((got.view(torch.int16) != want.view(torch.int16))
                  & ~nan).sum())
    same_nan = torch.equal(got.isnan(), nan)
    fin = want.isfinite() & got.isfinite()
    err, rel = rel_err(got[fin].double(), want[fin].double())
    log(f"  {label}: {differ} of {want.numel()} differ, NaN where plain's: "
        f"{same_nan} ({int((~want.isfinite()).sum())} non-finite)")
    require(differ == 0 and same_nan, f"{label}: {differ} points differ "
            f"from the plain version, NaN where plain's: {same_nan}")
    return err, rel, 0.0


def native_grids(n: int, seed: int, nonfinite: bool = False):
    """leg_inputs' u and b (b of 1/h^2 size) in bfloat16; with
    ``nonfinite`` u holds a NaN and a +Inf and b a -Inf in the interior."""
    u, b, _ = leg_inputs(n, torch.float32, seed)
    u, b = u.to(torch.bfloat16), b.to(torch.bfloat16)
    if nonfinite:
        u[n // 3, n // 2] = float("nan")
        u[2 * n // 3, 7] = float("inf")
        b[n // 2, n - 3] = -float("inf")
    return u, b


def native_tile(label: str, seed: int):
    """The bfloat16 form of sharded path ``label``'s fine tile
    (NATIVE_TILES: S1's row tile, S2's block tile) and its geometry."""
    n, ranks = NATIVE_TILES[label]
    ue, be, _, t = local2d_tile(n, torch.float32, seed, ranks)
    return ue.to(torch.bfloat16), be.to(torch.bfloat16), t


def native_dia(seed: int, nonfinite: bool = False):
    """The 4095^2 Poisson operator's DIA pattern with N(0,1) bfloat16
    values where it has entries, its packed form, and a packed N(0,1)
    bfloat16 x (with ``nonfinite``, a NaN and a +-Inf in it)."""
    from multigridcmt_tpu_torch.kernels import spmv

    a, _ = dia_on_card(2 ** MAIN_K - 1, 2, torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    vals = torch.randn(a.diags.shape, generator=gen, device="cuda")
    a = dataclasses.replace(a, diags=torch.where(
        a.diags != 0, vals, torch.zeros_like(vals)).to(torch.bfloat16))
    pk = spmv.pack_dia(a)
    x = vector_on_card(a.shape[0], torch.float32, seed + 1)
    if nonfinite:
        size = x.shape[0]
        x[size // 5], x[size // 2], x[3 * size // 4] = (
            float("nan"), float("inf"), -float("inf"))
    return a, pk, spmv.pack_x(x.to(torch.bfloat16), pk.halo)


def native_stencil_calls(mode: str, u, b, n: int, sigma: float,
                         sweeps: int = 0):
    """(kernel, plain) of stencil2d's native ``mode`` on (n+2)^2 grids."""
    from multigridcmt_tpu_torch.kernels import native_bf16, stencil2d

    h = 1.0 / (n + 1)
    c = native_bf16.constants(h, sigma, NATIVE_OMEGA)
    if mode == "residual":
        return (lambda: stencil2d.residual(u, b, n, h, sigma=sigma),
                lambda: native_bf16.residual_plain(u, b, n, c))
    if mode == "rbgs":
        return (lambda: stencil2d.rbgs_sweep(u, b, n, h, sigma=sigma,
                                             sweeps=sweeps),
                lambda: native_bf16.sweep_plain("rbgs", u, b, n, c, sweeps))
    return (lambda: stencil2d.jacobi_sweep(u, b, n, h, NATIVE_OMEGA,
                                           sigma=sigma, sweeps=sweeps),
            lambda: native_bf16.sweep_plain("jacobi", u, b, n, c, sweeps))


def native_local_calls(mode: str, ue, be, t: dict, sigma: float,
                       sweeps: int = 0):
    """(kernel, plain) of local2d's native ``mode`` on an extended tile."""
    from multigridcmt_tpu_torch.kernels import local2d, native_bf16

    n = t["n"]
    h = 1.0 / (n + 1)
    offs = (t["row_off"], t["col_off"])
    c = native_bf16.constants(h, sigma, NATIVE_OMEGA)
    if mode == "residual":
        return (lambda: local2d.residual(ue, be, n, h, *offs, sigma=sigma),
                lambda: native_bf16.residual_plain(ue, be, n, c, *offs))
    if mode == "rbgs":
        return (lambda: local2d.rbgs_sweep(ue, be, n, h, *offs, sigma=sigma,
                                           sweeps=sweeps),
                lambda: native_bf16.sweep_plain("rbgs", ue, be, n, c, sweeps,
                                                *offs))
    return (lambda: local2d.jacobi_sweep(ue, be, n, h, NATIVE_OMEGA, *offs,
                                         sigma=sigma, sweeps=sweeps),
            lambda: native_bf16.sweep_plain("jacobi", ue, be, n, c, sweeps,
                                            *offs))


def compare_native_bf16(main_err: dict) -> None:
    """The native bfloat16 modes against their plain versions on the card,
    bit for bit (check_native_bits), at NATIVE_STENCIL_N (the sweeps at
    every level of NATIVE_SWEEP_N), NATIVE_TILES and the 4095^2 SpMV, both
    sigmas, every sweep count of NATIVE_SWEEPS; the stencil2d modes at
    NATIVE_NONFINITE_N (the sweeps at every count and both sigmas) and the
    SpMV on inputs holding NaN and +-Inf. The main-path errors: 2047^2,
    sigma 0, RB-GS nu = 4, Jacobi nu = 8, the local2d modes on S1's
    tile."""
    from multigridcmt_tpu_torch.kernels import spmv

    for mode, n0 in NATIVE_STENCIL_N.items():
        for n in NATIVE_SWEEP_N if mode in NATIVE_SWEEPS else (n0,):
            u, b = native_grids(n, n + 301)
            for sigma in (0.0, SIGMA):
                for nu in NATIVE_SWEEPS.get(mode, (0,)):
                    kernel, plain = native_stencil_calls(mode, u, b, n,
                                                         sigma, nu)
                    err = check_native_bits(
                        f"native stencil2d {mode} n={n} nu={nu} "
                        f"sigma={sigma}", kernel(), plain())
                    if n == n0 and sigma == 0.0 and nu == max(
                            NATIVE_SWEEPS.get(mode, (0,))):
                        main_err[f"stencil2d_{mode}_bf16"] = err
            del u, b
    n = NATIVE_NONFINITE_N
    u, b = native_grids(n, n + 302, nonfinite=True)
    for mode in NATIVE_STENCIL_N:
        for sigma in (0.0, SIGMA) if mode in NATIVE_SWEEPS else (SIGMA,):
            for nu in NATIVE_SWEEPS.get(mode, (0,)):
                kernel, plain = native_stencil_calls(mode, u, b, n, sigma,
                                                     nu)
                check_native_bits(f"native stencil2d {mode} n={n} nu={nu} "
                                  f"sigma={sigma} with NaN and Inf",
                                  kernel(), plain())
    del u, b
    for label in NATIVE_TILES:
        ue, be, t = native_tile(label, 303)
        for mode in NATIVE_STENCIL_N:
            for sigma in (0.0, SIGMA):
                nu = max(NATIVE_SWEEPS.get(mode, (0,)))
                kernel, plain = native_local_calls(mode, ue, be, t, sigma,
                                                   nu)
                err = check_native_bits(
                    f"native local2d {mode} {label} tile "
                    f"{tuple(ue.shape)} offsets ({t['row_off']}, "
                    f"{t['col_off']}) nu={nu} sigma={sigma}",
                    kernel(), plain())
                if label == "S1" and sigma == 0.0:
                    main_err[f"local2d_{mode}_bf16"] = err
        del ue, be
        torch.cuda.empty_cache()
    for nonfinite in (False, True):
        _, pk, xp = native_dia(304, nonfinite)
        err = check_native_bits(
            f"native spmv_dia n={2 ** MAIN_K - 1} ndiag="
            f"{len(pk.offsets)}" + (" with NaN and Inf" if nonfinite else ""),
            spmv.spmv_packed(pk, xp), spmv.spmv_packed_plain(pk, xp))
        if not nonfinite:
            main_err["spmv_dia_bf16"] = err
        del pk, xp
    torch.cuda.empty_cache()


def native_leg_calls(name: str, u, b, x, e, n: int, sigma: float,
                     kind: str = "rbgs", sweeps: int = 0):
    """(kernel, plain) of a B2 native mode (NATIVE_LEGS) on (n+2)^2 grids
    and the coarse e."""
    from multigridcmt_tpu_torch.kernels import fused2d, native_bf16, \
        transfer2d

    h, nc = 1.0 / (n + 1), (n - 1) // 2
    omega = NATIVE_OMEGA if kind == "jacobi" else 1.0
    c = native_bf16.constants(h, sigma, omega)
    if name == "fused2d_down_bf16":
        return (lambda: fused2d.smooth_residual_restrict(
                    u, b, n, h, kind=kind, omega=omega, sweeps=sweeps,
                    sigma=sigma),
                lambda: native_bf16.down_leg_plain(u, b, n, c, kind, sweeps))
    if name == "fused2d_up_bf16":
        return (lambda: fused2d.prolong_add_smooth(
                    x, e, b, n, nc, h, kind=kind, omega=omega, sweeps=sweeps,
                    sigma=sigma),
                lambda: native_bf16.up_leg_plain(x, e, b, n, nc, c, kind,
                                                 sweeps))
    if name == "transfer2d_residual_restrict_bf16":
        c0 = native_bf16.constants(h)
        return (lambda: transfer2d.residual_restrict(u, b, n, h),
                lambda: native_bf16.residual_restrict_plain(u, b, n, c0,
                                                            False))
    return (lambda: transfer2d.prolong_add(x, e, n, nc),
            lambda: native_bf16.prolong_add_plain(x, e, n, nc, False))


def native_leg_inputs(n: int, seed: int, nonfinite: bool = False):
    """u, b, x on the (n+2)^2 grid and e on the coarse grid, bfloat16
    (native_grids); with ``nonfinite`` each holds NaN and +-Inf."""
    u, b = native_grids(n, seed, nonfinite)
    x, _ = native_grids(n, seed + 1, nonfinite)
    nc = (n - 1) // 2
    e, _ = native_grids(nc, seed + 2, nonfinite)
    return u, b, x, e


def native_leg_cases(name: str):
    """(kind, sweeps) of every schedule of a B2 mode: each leg's sweeps
    from 0 to its cap, RB-GS and Jacobi (each its own kernel at 0 sweeps
    too); one for the transfers."""
    from multigridcmt_tpu_torch.kernels import fused2d

    cap = {"fused2d_down_bf16": fused2d.max_down_sweeps,
           "fused2d_up_bf16": fused2d.max_up_sweeps}.get(name)
    if cap is None:
        return [("rbgs", 0)]
    return [(kind, nu) for kind in ("rbgs", "jacobi")
            for nu in range(cap(kind) + 1)]


def check_native_outputs(label: str, got, want):
    """check_native_bits on each output of a mode (a down leg has two);
    returns the first's."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return [check_native_bits(f"{label} out{i}", g, w)
            for i, (g, w) in enumerate(zip(got, want))][0]


def compare_native_legs(main_err: dict) -> None:
    """The native fused2d legs and transfer2d kernels (slice B2) against
    their plain versions on the card, bit for bit (check_native_bits), at
    NATIVE_LEG_N, sigma 0 and SIGMA, every schedule of native_leg_cases;
    at NATIVE_NONFINITE_N on inputs with NaN and +-Inf (each leg at its cap
    in both smoothers). The main-path errors: 2047^2, sigma 0, RB-GS nu =
    2 for the legs."""
    for n in NATIVE_LEG_N:
        u, b, x, e = native_leg_inputs(n, n + 331)
        for name in NATIVE_LEGS:
            for sigma in (0.0, SIGMA):
                if name.startswith("transfer2d") and sigma:
                    continue
                for kind, nu in native_leg_cases(name):
                    kernel, plain = native_leg_calls(name, u, b, x, e, n,
                                                     sigma, kind, nu)
                    err = check_native_outputs(
                        f"native {name} n={n} {kind} nu={nu} sigma={sigma}",
                        kernel(), plain())
                    if n == NATIVE_LEG_N[0] and sigma == 0.0 and (
                            name.startswith("transfer2d")
                            or (kind, nu) == ("rbgs", 2)):
                        main_err[name] = err
        del u, b, x, e
    n = NATIVE_NONFINITE_N
    u, b, x, e = native_leg_inputs(n, n + 332, nonfinite=True)
    for name in NATIVE_LEGS:
        cases = native_leg_cases(name)
        for kind in sorted({k for k, _ in cases}):
            nu = max(v for k, v in cases if k == kind)
            kernel, plain = native_leg_calls(name, u, b, x, e, n, SIGMA,
                                             kind, nu)
            check_native_outputs(f"native {name} n={n} {kind} nu={nu} "
                                 "with NaN and Inf", kernel(), plain())
    del u, b, x, e
    signed_zero_restriction()
    torch.cuda.empty_cache()


def signed_zero_restriction() -> None:
    """The native residual restriction's dropped sigma u term, in bits: at
    NATIVE_LEG_N[0] with u = 1 and b = -0 on a block (au = +0 there, so the
    residual is -0 at points where u > 0) the kernel equals the plain
    version without the term, -0 on the block's coarse points, where the
    plain version with the term (-0 + 0 u = +0) has +0."""
    from multigridcmt_tpu_torch.kernels import native_bf16, transfer2d

    n = NATIVE_LEG_N[0]
    h = 1.0 / (n + 1)
    u, b = native_grids(n, n + 333)
    u[8:n - 7, 8:n - 7] = 1.0
    b[9:n - 8, 9:n - 8] = -0.0
    c = native_bf16.constants(h)
    got = transfer2d.residual_restrict(u, b, n, h)
    want = native_bf16.residual_restrict_plain(u, b, n, c, False)
    check_native_bits(f"native transfer2d_residual_restrict_bf16 n={n} "
                      "with a residual of -0 where u > 0", got, want)
    neg = (want == 0) & want.signbit()
    shifted = native_bf16.residual_restrict_plain(u, b, n, c, True)
    log(f"  {int(neg.sum())} coarse points -0 without sigma u, of them "
        f"{int(shifted[neg].signbit().sum())} -0 with it")
    require(int(neg.sum()) > 0 and not bool(shifted[neg].signbit().any()),
            "the signed-zero case does not tell the residual without sigma "
            "u from the one with it")
    del u, b, got, want, shifted


def compare_mixed3d(main_err: dict) -> None:
    """The stencil3d kernels' bfloat16 modes against their plain versions at
    511^3 (both sigmas) and on MIXED3D_STACKS (sigma = SIGMA): the residual
    (float32 out), Jacobi and RB-GS at 1 and 2 sweeps, each storing
    bfloat16 and, by out_dtype, float32 on its last sweep. A 2-sweep call's
    output is held against one plain sweep of the kernel's own first sweep
    (a launch apiece): its first sweep stores bfloat16, so a one-ulp flip
    there (the kernels contract into FMAs where the plain versions round
    twice) moves its neighbours' second sweep by ~omega/6 of that ulp,
    several ulp of a small value."""
    from multigridcmt_tpu_torch.kernels import stencil3d

    f32 = torch.float32
    n = 2 ** MAIN_K3 - 1
    h = 1.0 / (n + 1)
    u, b = cube_inputs(n, f32, seed=3 * n + 17)
    su, sb = u.to(torch.bfloat16), b.to(torch.bfloat16)
    del u, b
    # (wrapper, arguments, main_err key: at sigma = 0 on the whole grid;
    # the cycle's RB-GS call takes nu = 2 sweeps, the others one launch)
    modes = [("residual", {}, "stencil3d_residual_bf16")]
    for mode, kw in (("jacobi_sweep", dict(omega=omega3())),
                     ("rbgs_sweep", {})):
        for nu in (1, 2):
            for out in (None, f32):
                key = ("stencil3d_" + mode.split("_")[0] + "_bf16"
                       + ("" if out is None else "_f32"))
                main = nu == (2 if key == "stencil3d_rbgs_bf16" else 1)
                modes.append((mode, dict(kw, sweeps=nu, out_dtype=out),
                              key if main else None))
    for stack, pairs in ((None, True), *MIXED3D_STACKS):
        whole = stack is None
        if whole:
            where, (uu, bb), off = f"n={n}", (su, sb), {}
        else:
            goff, roff, p, r = stack
            where = f"n={n} stack p={p} r={r} goff={goff} roff={roff}"
            uu, bb = (cut_stack(g, n, goff, roff, p, r) for g in (su, sb))
            off = dict(goff=goff, roff=roff)
        for sigma in ((0.0, SIGMA) if whole else (SIGMA,)):
            for mode, kw, key in modes:
                label = f"bf16 stencil3d {mode} {where} sigma={sigma} {kw}"
                fn = getattr(stencil3d, mode)
                before = (stencil3d.rbgs_bf16_pairs_launches,
                          stencil3d.jacobi_bf16_pairs_launches)
                got = fn(uu, bb, n, h, sigma=sigma, **off, **kw)
                # The RB-GS sweeps take the paired march on the whole grid
                # and on the stacks MIXED3D_STACKS names; the Jacobi
                # sweeps storing bfloat16 on every grid and stack (c odd).
                paired = (stencil3d.rbgs_bf16_pairs_launches - before[0],
                          stencil3d.jacobi_bf16_pairs_launches - before[1])
                nu = kw.get("sweeps", 1)
                stored = nu - (kw.get("out_dtype") is not None)
                want_paired = ((nu if pairs else 0, 0)
                               if mode == "rbgs_sweep" else
                               (0, stored) if mode == "jacobi_sweep"
                               else (0, 0))
                require(paired == want_paired,
                        f"{label}: (RB-GS, Jacobi) paired launches "
                        f"{paired}, not {want_paired}")
                start, pkw = uu, kw
                if kw.get("sweeps", 1) == 2:
                    start = fn(uu, bb, n, h, sigma=sigma, **off,
                               **dict(kw, sweeps=1, out_dtype=None))
                    pkw = dict(kw, sweeps=1)
                want = getattr(stencil3d, mode + "_plain")(
                    start, bb, n, h, sigma=sigma, **off, **pkw)
                if mode == "residual":
                    require(got.dtype == f32, f"{label}: r is {got.dtype}")
                    err = check_pair(label, got, want, TOL[f32],
                                     ghosts=whole)
                else:
                    err = check_bf16(label, got, want,
                                     f32_out=kw["out_dtype"] is not None,
                                     ghosts=whole)
                if whole and sigma == 0.0 and key is not None:
                    main_err[key] = err
        del uu, bb
    # The scalar march, which the Jacobi sweep storing bfloat16 launches
    # where an array is off a 4-byte word (jacobi_pairs): u and b one
    # element off one. It gives the paired march's bits.
    ou, ob = (torch.empty(g.numel() + 1, dtype=g.dtype,
                          device=g.device)[1:].view(g.shape).copy_(g)
              for g in (su, sb))
    for sigma in (0.0, SIGMA):
        label = f"bf16 stencil3d jacobi_sweep n={n} sigma={sigma} off a word"
        before = (stencil3d.jacobi_bf16_launches,
                  stencil3d.jacobi_bf16_pairs_launches)
        got = stencil3d.jacobi_sweep(ou, ob, n, h, omega3(), sigma=sigma)
        runs = (stencil3d.jacobi_bf16_launches - before[0],
                stencil3d.jacobi_bf16_pairs_launches - before[1])
        require(runs == (1, 0), f"{label}: (launches, paired) {runs}, not "
                "(1, 0)")
        want = stencil3d.jacobi_sweep_plain(ou, ob, n, h, omega3(),
                                            sigma=sigma)
        check_bf16(label, got, want, f32_out=False, ghosts=True)
        paired = stencil3d.jacobi_sweep(su, sb, n, h, omega3(), sigma=sigma)
        require(torch.equal(got.view(torch.int16), paired.view(torch.int16)),
                f"{label}: the scalar march's bits are not the paired one's")
    del ou, ob, su, sb
    torch.cuda.empty_cache()


def compare_composed(main_err: dict) -> None:
    """The transfer2d kernels of the composed legs (compare_sweeps holds
    their sweeps): residual_restrict at RR_SHAPES, with u and b on a pair
    of elements and off one (the wrapper copies), equal to its plain
    version bit for bit (sigma is 0 and h = 2^-k: the row stream sums as
    the plain ops do, which the float64 B and C history gates rest on),
    and within TOL; prolong_add at TRANSFER_SHAPES. Main-path rows: float32
    at 2047."""
    from multigridcmt_tpu_torch.kernels import transfer2d

    for dtype, n in RR_SHAPES:
        h = 1.0 / (n + 1)
        nc = (n - 1) // 2
        u, b, _ = leg_inputs(n, dtype, seed=n + 5)
        want = transfer2d.residual_restrict_plain(u, b, n, h)
        for off in (False, True):
            name = (f"{str(dtype).split('.')[-1]} n={n}"
                    + (" off" if off else ""))
            uu, bb = (off_pair(u), off_pair(b)) if off else (u, b)
            got = transfer2d.residual_restrict(uu, bb, n, h)
            err = check_pair(f"residual_restrict {name}", got, want,
                             TOL[dtype], (nc + 2, nc + 2))
            require(torch.equal(got, want),
                    f"residual_restrict {name}: not bit-equal to plain "
                    f"(max abs diff {err[0]:.3e})")
            if dtype == torch.float32 and n == 2 ** (MAIN_K - 1) - 1 \
                    and not off:
                main_err["transfer2d_residual_restrict"] = err
        del u, b, want
    for dtype, n in TRANSFER_SHAPES:
        h = 1.0 / (n + 1)
        nc = (n - 1) // 2
        u, b, e = leg_inputs(n, dtype, seed=n + 5)
        name = f"{str(dtype).split('.')[-1]} n={n}"
        main = dtype == torch.float32
        err = check_pair(f"prolong_add {name}",
                         transfer2d.prolong_add(u, e, n, nc),
                         transfer2d.prolong_add_plain(u, e, n, nc),
                         TOL[dtype], (n + 2, n + 2))
        if main:
            main_err["transfer2d_prolong_add"] = err
        del u, b, e
    torch.cuda.empty_cache()


def compare_sweeps(main_err: dict) -> None:
    """The row-streaming sweeps against their plain versions at every sweep
    count, both sigmas: stencil2d RB-GS (1 to 4) and Jacobi (1 to 8) at
    SWEEP_SHAPES, at n <= 31 also with u and b off a pair of elements; the
    packed RB-GS sweep (1 to 4) at PACKED_SWEEP_SHAPES. Main-path rows:
    float32, sigma = 0; RB-GS 4 sweeps at 2047 (path B), Jacobi 8 sweeps
    at 1023 (path C), the packed RB-GS 4 sweeps at 4095 (B)."""
    from multigridcmt_tpu_torch.kernels import packed2d, stencil2d

    jacobi_omega = 0.8
    for dtype, n, off in [(d, n, False) for d, n in SWEEP_SHAPES] + [
            (d, n, True) for d, n in SWEEP_SHAPES if n <= 31]:
        h = 1.0 / (n + 1)
        u, b, _ = leg_inputs(n, dtype, seed=n + 6)
        if off:
            u, b = off_pair(u), off_pair(b)
        name = f"{str(dtype).split('.')[-1]} n={n}" + (" off" if off else "")
        main = dtype == torch.float32 and not off
        main_b = main and n == 2 ** (MAIN_K - 1) - 1
        main_c = main and n == 2 ** PATH_C_K - 1
        for sigma in (0.0, SIGMA):
            for sweeps in range(1, stencil2d.max_fused_sweeps("rbgs") + 1):
                err = check_pair(
                    f"stencil2d rbgs {name} nu={sweeps} sigma={sigma}",
                    stencil2d.rbgs_sweep(u, b, n, h, sigma=sigma,
                                         sweeps=sweeps),
                    stencil2d.rbgs_sweep_plain(u, b, n, h, sigma=sigma,
                                               sweeps=sweeps), TOL[dtype])
                if main_b and sweeps == 4 and sigma == 0.0:
                    main_err["stencil2d_rbgs"] = err
            for sweeps in range(1, stencil2d.max_fused_sweeps("jacobi") + 1):
                err = check_pair(
                    f"stencil2d jacobi {name} nu={sweeps} sigma={sigma}",
                    stencil2d.jacobi_sweep(u, b, n, h, jacobi_omega,
                                           sigma=sigma, sweeps=sweeps),
                    stencil2d.jacobi_sweep_plain(u, b, n, h, jacobi_omega,
                                                 sigma=sigma, sweeps=sweeps),
                    TOL[dtype])
                if main_c and sweeps == 8 and sigma == 0.0:
                    main_err["stencil2d_jacobi"] = err
        del u, b
    for dtype, n in PACKED_SWEEP_SHAPES:
        h = 1.0 / (n + 1)
        u, b, _ = leg_inputs(n, dtype, seed=n + 7)
        su, sb = packed2d.pack(u), packed2d.pack(b)
        del u, b
        name = f"{str(dtype).split('.')[-1]} n={n}"
        for sigma in (0.0, SIGMA):
            for sweeps in range(1, packed2d.max_fused_sweeps() + 1):
                err = check_pair(
                    f"packed rbgs {name} nu={sweeps} sigma={sigma}",
                    packed2d.rbgs_sweep(su, sb, n, h, sweeps=sweeps,
                                        sigma=sigma),
                    packed2d.rbgs_sweep_plain(su, sb, n, h, sweeps=sweeps,
                                              sigma=sigma), TOL[dtype])
                if (dtype == torch.float32 and n == 2 ** MAIN_K - 1
                        and sweeps == 4 and sigma == 0.0):
                    main_err["packed2d_rbgs"] = err
        del su, sb
    torch.cuda.empty_cache()


def omega3() -> float:
    """The 3D weighted-Jacobi default (6/7), as a solve would take it."""
    from multigridcmt_tpu_torch.config import SolverConfig

    return SolverConfig(ndim=3, smoother="jacobi").effective_omega()


def compare_stencil3d(main_err: dict) -> None:
    from multigridcmt_tpu_torch.kernels import stencil3d

    w = omega3()
    # (wrapper, kernel, arguments, at the main path's call): the cycle
    # calls rbgs_sweep with nu = 2 sweeps; Jacobi is timed a sweep.
    modes = [("residual", "stencil3d_residual", {}, True),
             ("jacobi_sweep", "stencil3d_jacobi", dict(omega=w), True),
             ("jacobi_sweep", "stencil3d_jacobi", dict(omega=w, sweeps=2),
              False),
             ("rbgs_sweep", "stencil3d_rbgs", {}, False),
             ("rbgs_sweep", "stencil3d_rbgs", dict(sweeps=2), True)]
    for dtype, n in STENCIL3D_SHAPES:
        h = 1.0 / (n + 1)
        tol = TOL[dtype]
        u, b = cube_inputs(n, dtype, seed=3 * n)
        name = f"{str(dtype).split('.')[-1]} n={n}"
        at_main = dtype == torch.float32 and n == 2 ** MAIN_K3 - 1
        for sigma in (0.0, SIGMA):
            for mode, key, kw, main in modes:
                err = check_pair(
                    f"{key} {name} sigma={sigma} {kw}",
                    getattr(stencil3d, mode)(u, b, n, h, sigma=sigma, **kw),
                    getattr(stencil3d, mode + "_plain")(u, b, n, h,
                                                        sigma=sigma, **kw),
                    tol, shape=(n + 2,) * 3)
                if at_main and main and sigma == 0.0:
                    main_err[key] = err
        if dtype == torch.float64:
            # A slab-and-pencil stack: global planes 100..139 (past the
            # ghost plane 128 they are zero) and rows -2..57 of the grid.
            compare_stack(u, b, n, 100, -2, 40, 60, modes, tol)
        del u, b
        torch.cuda.empty_cache()
    for (dtype, n), stacks in STENCIL3D_STACKS.items():
        u, b = cube_inputs(n, dtype, seed=n + 1)
        for goff, roff, p, r in stacks:
            compare_stack(u, b, n, goff, roff, p, r, modes, TOL[dtype])
        del u, b
        torch.cuda.empty_cache()


def cut_stack(g, n, goff, roff, p, r) -> torch.Tensor:
    """Planes goff .. goff + p - 1 and rows roff .. roff + r - 1 of the
    (n+2)^3 grid g, zero where they leave it."""
    s = torch.zeros((p, r, n + 2), dtype=g.dtype, device="cuda")
    z, y = max(0, -goff), max(0, roff)
    planes = g[max(goff, 0):goff + p, y:roff + r]
    s[z:z + planes.shape[0], y - roff:y - roff + planes.shape[1]] = planes
    return s


def compare_stack(u, b, n, goff, roff, p, r, modes, tol) -> None:
    """Each stencil3d mode on planes goff .. goff + p - 1 and rows roff ..
    roff + r - 1 of the grid u, b (zero where they leave it), sigma =
    SIGMA."""
    from multigridcmt_tpu_torch.kernels import stencil3d

    su, sb = (cut_stack(g, n, goff, roff, p, r) for g in (u, b))
    name = f"{str(u.dtype).split('.')[-1]} n={n}"
    for mode, key, kw, _ in modes:
        check_pair(
            f"{key} {name} stack p={p} r={r} goff={goff} roff={roff} {kw}",
            getattr(stencil3d, mode)(su, sb, n, 1.0 / (n + 1), sigma=SIGMA,
                                     goff=goff, roff=roff, **kw),
            getattr(stencil3d, mode + "_plain")(
                su, sb, n, 1.0 / (n + 1), sigma=SIGMA, goff=goff, roff=roff,
                **kw), tol, shape=(p, r, n + 2), ghosts=False)


def vector_on_card(size: int, dtype, seed: int) -> torch.Tensor:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(size, generator=gen, device="cuda",
                       dtype=torch.float64).to(dtype)


def dia_on_card(n: int, ndim: int, dtype, h=None):
    """The Poisson operator as DIA on the card (h = 1/(n+1) unless given)
    and its packed form."""
    from multigridcmt_tpu_torch.kernels import spmv
    from multigridcmt_tpu_torch.ops import sparse

    a = sparse.laplacian_dia(n, ndim, 1.0 / (n + 1) if h is None else h,
                             dtype, device="cuda")
    return a, spmv.pack_dia(a)


def require_packed_zeros(label: str, y: torch.Tensor, pk) -> None:
    """The packed output's skirts and rows past N are zero."""
    from multigridcmt_tpu_torch.kernels import spmv

    flat = y.reshape(-1)
    base = pk.halo * spmv.LANES
    require(not flat[:base].any().item()
            and not flat[base + pk.n:].any().item(),
            f"{label}: skirts or rows past N not zero")


@functools.cache
def bell_bench_host():
    """The SpMV bench's blocked-ELL matrix and multivector on the host
    (bench_spmv.py:105-118): 64 x 64 blocks of 128^2 N(0,1) values at
    density 0.15 plus the block diagonal, seed 1; Xt (m, 8192) float32."""
    import numpy as np
    import scipy.sparse as sp

    nbr = nbc = BELL_BLOCKS
    rng = np.random.default_rng(BELL_SEED)
    mask = rng.random((nbr, nbc)) < BELL_DENSITY
    mask[np.arange(nbr), np.arange(nbr) % nbc] = True
    blocks = {(i, j): rng.standard_normal((128, 128)).astype(np.float32)
              for i, j in zip(*np.nonzero(mask))}
    a_sp = sp.bmat([[sp.csr_matrix(blocks[(i, j)]) if (i, j) in blocks
                     else None for j in range(nbc)] for i in range(nbr)],
                   format="csr")
    xt = rng.standard_normal((BELL_M, nbc * 128)).astype(np.float32)
    return a_sp, xt


@functools.cache
def bell_bench():
    """``bell_bench_host`` as a BELL matrix and Xt on the card."""
    from multigridcmt_tpu_torch.kernels import bell

    a_sp, xt = bell_bench_host()
    return a_sp, bell.bell_from_scipy(a_sp, device="cuda"), \
        torch.from_numpy(xt).cuda()


def compare_sparse(main_err: dict) -> None:
    """The DIA SpMV at 4095^2 and 255^3 float32 and 1D 4097 and 2D 63^2
    float64 (skirts and rows past N zero); the BELL SpMM at the bench
    shape (float32, m = 128), on 4 x 3 blocks in float64 (m = 16), and its
    8-row SpMV carrier. Main-path rows: the DIA SpMV at 4095^2, the BELL
    SpMM at the bench shape."""
    from multigridcmt_tpu_torch.kernels import bell, spmv

    for dtype, n, ndim in ((torch.float32, 2 ** MAIN_K - 1, 2),
                           (torch.float32, 255, 3), (torch.float64, 4097, 1),
                           (torch.float64, 63, 2)):
        a, pk = dia_on_card(n, ndim, dtype)
        xp = spmv.pack_x(vector_on_card(a.shape[0], dtype, n + ndim),
                         pk.halo)
        label = f"spmv_dia {str(dtype).split('.')[-1]} {ndim}D n={n}"
        y = spmv.spmv_packed(pk, xp)
        err = check_pair(label, y, spmv.spmv_packed_plain(pk, xp), TOL[dtype],
                         shape=tuple(xp.shape), ghosts=False)
        require_packed_zeros(label, y, pk)
        if dtype == torch.float32 and ndim == 2:
            main_err["spmv_dia"] = err
        del a, pk, xp, y
    torch.cuda.empty_cache()

    # The plain BELL product is an einsum (a cuBLAS batched product on the
    # card): with TF32 on it would keep ~3 digits and could not stand for
    # the JAX kernel's Precision.HIGHEST. The package pins it off; set it
    # here as well, so this comparison does not depend on that.
    torch.backends.cuda.matmul.allow_tf32 = False
    a_sp, ab, xt = bell_bench()
    want = bell.spmm_plain(ab, xt)
    got = bell.spmm(ab, xt)
    err = check_pair(f"bell_spmm float32 bench kmax={ab.kmax} m={BELL_M}",
                     got, want, TOL[torch.float32], ghosts=False)
    main_err["bell_spmm"] = err
    # The cluster sums its partial tiles in a fixed order: a second call
    # repeats the first bit for bit.
    require(torch.equal(bell.spmm(ab, xt), got),
            "bell_spmm: a second call differs from the first")
    # The 8-row carrier of bell.spmv against row 0 of the plain product
    # (the bench's Xt is exactly n_cols wide).
    check_pair("bell spmv carrier float32 bench", bell.spmv(ab, xt[0]),
               want[0, :ab.shape[0]], TOL[torch.float32], ghosts=False)
    del got, want
    # float64 at the bench shape (m = 128: four m-tiles of 32) and through
    # the carrier (m = 8); then NaN and Inf in Xt's first block column, where
    # every zero padding block points (the bench's block row 0 also has a
    # real block there): the kernel skips a slice's FMAs only where its A
    # values are all zero and its X values all finite, so each NaN lands
    # where the plain version's does, at m = 128 and m = 8, both dtypes.
    ab64 = bell.bell_from_scipy(a_sp, dtype=torch.float64, device="cuda")
    require(bool((ab64.cols[:, -1] == 0).any())
            and bool((ab64.data[ab64.cols == 0] != 0).any()),
            "bell bench: no padding block or no real block at column 0")
    xt64 = xt.double()
    want = bell.spmm_plain(ab64, xt64)
    check_pair(f"bell_spmm float64 bench m={BELL_M}", bell.spmm(ab64, xt64),
               want, TOL[torch.float64], ghosts=False)
    check_pair("bell spmv carrier float64 bench", bell.spmv(ab64, xt64[0]),
               want[0, :ab64.shape[0]], TOL[torch.float64], ghosts=False)
    for a_, x_ in ((ab, xt), (ab64, xt64)):
        xn = x_.clone()
        xn[0, 5] = float("nan")
        xn[BELL_M - 1, 100] = float("inf")
        xn[3, 127] = -float("inf")
        for m in (BELL_M, 8):
            xm = xn[:m].contiguous()
            check_nonfinite(f"bell_spmm {str(x_.dtype).split('.')[-1]} "
                            f"bench m={m}, NaN and Inf in block column 0",
                            bell.spmm(a_, xm), bell.spmm_plain(a_, xm),
                            TOL[x_.dtype])
    del ab64, xt64, want, xn, xm
    a_sp, rng = blocks_4x3(17)
    ab64 = bell.bell_from_scipy(a_sp, dtype=torch.float64, device="cuda")
    xt64 = torch.from_numpy(rng.standard_normal((16, 3 * 128))).cuda()
    check_pair("bell_spmm float64 4x3 blocks m=16", bell.spmm(ab64, xt64),
               bell.spmm_plain(ab64, xt64), TOL[torch.float64], ghosts=False)


def blocks_4x3(seed: int):
    """(a 4 x 3-block SciPy matrix of N(0,1) blocks of 128^2 at density
    0.6, block (0, 0) always populated; the generator, to draw Xt from)."""
    import numpy as np
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    dense = np.zeros((4 * 128, 3 * 128))
    for i, j in zip(*np.nonzero(rng.random((4, 3)) < 0.6)):
        dense[i * 128:(i + 1) * 128, j * 128:(j + 1) * 128] = \
            rng.standard_normal((128, 128))
    dense[:128, :128] = rng.standard_normal((128, 128))
    return sp.csr_matrix(dense), rng


def check_nonfinite(label: str, got, want, tol: float) -> None:
    """NaN and +-Inf exactly where ``want`` has them (there must be some);
    the finite values within ``tol`` of max|want| over them."""
    torch.cuda.synchronize()
    fin = want.isfinite()
    same = (torch.equal(got.isnan(), want.isnan())
            and torch.equal(got.isposinf(), want.isposinf())
            and torch.equal(got.isneginf(), want.isneginf()))
    err, rel = rel_err(got[fin], want[fin])
    log(f"  {label}: {int((~fin).sum())} non-finite, where plain's: {same}; "
        f"rel {rel:.3e}")
    require(same and not bool(fin.all()) and rel <= tol,
            f"{label}: non-finite values elsewhere than plain's, or rel "
            f"{rel:.3e} > {tol}")


def cut_tile(g: torch.Tensor, rows: int, cols: int, row_off: int,
             col_off: int) -> torch.Tensor:
    """The rows x cols tile of the padded grid g at global (row_off,
    col_off), zeros off the grid."""
    out = torch.zeros((rows, cols), dtype=g.dtype, device=g.device)
    r0, c0 = max(row_off, 0), max(col_off, 0)
    r1 = min(row_off + rows, g.shape[0])
    c1 = min(col_off + cols, g.shape[1])
    out[r0 - row_off:r1 - row_off, c0 - col_off:c1 - col_off] = \
        g[r0:r1, c0:c1]
    return out


def local2d_tile(n: int, dtype, seed: int, ranks=(1, 0), rank=(0, 0)):
    """One rank's extended tiles of u and b (b scaled by 1/h^2, as in
    ``leg_inputs``) in a row split (``ranks[1] == 0``) or block split of the
    padded n^2 grid, cut on the card with zero ghosts past the grid's ends;
    a random coarse correction in the extended convention; and the tile's
    geometry."""
    u, b = grids_on_card(n, dtype, seed, 2)
    b = b * float((n + 1) ** 2)
    m = (n + 1) // ranks[0]
    mcol = (n + 1) // ranks[1] if ranks[1] else 0
    row_off = rank[0] * m + 1 - HALO
    col_off = rank[1] * mcol + 1 - HALO if ranks[1] else 0
    cols = mcol + 2 * HALO if ranks[1] else n + 2

    def cut(g):
        return cut_tile(g, m + 2 * HALO, cols, row_off, col_off)

    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    cshape = (m // 2 + 2 * HALO,
              mcol // 2 + 2 * HALO if mcol else (n - 1) // 2 + 2)
    e = torch.randn(cshape, generator=gen, device="cuda",
                    dtype=torch.float64).to(dtype)
    return cut(u), cut(b), e, dict(n=n, m=m, mcol=mcol, row_off=row_off,
                                   col_off=col_off)


def local2d_main_checks(label: str):
    """(n, mcol > 0, [(kernel, kind, sweeps)]) of sharded path ``label``'s
    fine tile on a mesh of 1: the whole legs with the path's nu where they
    fit, else the composed route's sweeps; the residual (the solve's check,
    and the composed route's) on every path."""
    from multigridcmt_tpu_torch.kernels import local2d

    k, shape, cfg = SHARDED_PATHS[label]
    kind, nu = cfg["smoother"], cfg.get("nu1", 2)
    runs = [("residual", None, 0)]
    if kind != "chebyshev" and nu <= local2d.max_down_sweeps(kind):
        runs += [("down", kind, nu), ("up", kind, cfg.get("nu2", 2))]
    elif kind != "chebyshev":
        runs.append((kind, kind, nu))
    return 2 ** k - 1, len(shape) == 2, runs


def check_local2d(label: str, ue, be, e, t, dtype, sigma, runs) -> dict:
    """Hold each of ``runs`` ((kernel, kind, sweeps) as local2d_main_checks
    gives) against its plain version on one tile; returns the error of
    each kernel (of a down leg's two outputs, the one with the larger
    relative error)."""
    from multigridcmt_tpu_torch.kernels import local2d

    n = t["n"]
    h = 1.0 / (n + 1)
    offs = (t["row_off"], t["col_off"])
    tol = TOL[dtype]
    errs = {}
    for name, kind, nu in runs:
        what = f"local2d {name} {label} sigma={sigma} nu={nu}"
        kw = dict(kind=kind, omega=0.8, sigma=sigma, mcol=t["mcol"],
                  sweeps=nu)
        if name == "residual":
            err = check_pair(
                what, local2d.residual(ue, be, n, h, *offs, sigma=sigma),
                local2d.residual_plain(ue, be, n, h, *offs, sigma=sigma),
                tol, ghosts=False)
        elif name == "rbgs":
            err = check_pair(
                what, local2d.rbgs_sweep(ue, be, n, h, *offs, sigma=sigma,
                                         sweeps=nu),
                local2d.rbgs_sweep_plain(ue, be, n, h, *offs, sigma=sigma,
                                         sweeps=nu), tol, ghosts=False)
        elif name == "jacobi":
            err = check_pair(
                what, local2d.jacobi_sweep(ue, be, n, h, 0.8, *offs,
                                           sigma=sigma, sweeps=nu),
                local2d.jacobi_sweep_plain(ue, be, n, h, 0.8, *offs,
                                           sigma=sigma, sweeps=nu),
                tol, ghosts=False)
        elif name == "down":
            gu, grc = local2d.down_leg(ue, be, n, h, t["m"], *offs, **kw)
            wu, wrc = local2d.down_leg_plain(ue, be, n, h, t["m"], *offs,
                                             **kw)
            err = max(check_pair(f"{what} {kind} u'", gu, wu, tol,
                                 ghosts=False),
                      check_pair(f"{what} {kind} r_c", grc, wrc, tol,
                                 tuple(e.shape), ghosts=False),
                      key=lambda v: v[1])
        else:
            nc = (n - 1) // 2
            err = check_pair(
                f"{what} {kind}",
                local2d.up_leg(ue, e, be, n, nc, h, t["m"], *offs, **kw),
                local2d.up_leg_plain(ue, e, be, n, nc, h, t["m"], *offs,
                                     **kw), tol, ghosts=False)
        errs[f"local2d_{name}"] = max(errs.get(f"local2d_{name}", err), err,
                                      key=lambda v: v[1])
    return errs


def compare_local2d(main_err: dict) -> None:
    """The local2d kernels against their plain versions: on a rank of an
    8-way row split of 4095^2 (rank 3, m = 512) and of a 2x2 block split of
    2047^2 (rank (1, 1), mcol > 0), float32 and float64, sigma 0 and
    SIGMA: the only place on the card where nonzero offsets and their
    parity run (the row stream takes paired accesses on the row tile's odd
    rows and none on the block tile; odd and even stage counts put its
    stores on either parity); the residual and both sweeps on
    LOCAL2D_EVEN_TILE (even offsets: no zero row above the tile) and on S3's
    and S4's fine tiles (2064 x 2049, 1040 x 1025), the sweeps at every
    sweep count up to their caps on all of these; and on each sharded path's
    own fine tile (a mesh of 1, float32, offsets -7; S4cheb's residual is
    S4's) with the kernels and sweeps that path runs there. Each kernel's
    main-path error is that of the path the kernels line names for it.
    Whole tiles are compared: the plain versions define the ghost rows
    too."""
    from multigridcmt_tpu_torch.kernels import local2d

    sweeps = [(kind, kind, nu) for kind in ("rbgs", "jacobi")
              for nu in range(1, local2d.max_fused_sweeps(kind) + 1)]
    off_path = [("residual", None, 0)] + sweeps
    off_path += [(leg, kind, nu) for kind, nu in (("rbgs", 0), ("rbgs", 1),
                                                  ("rbgs", 2), ("rbgs", 3),
                                                  ("jacobi", 3), ("jacobi", 6))
                 for leg in ("down", "up")]
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split('.')[-1]
        for n, dr, r, dc, c in LOCAL2D_TILES:
            ue, be, e, t = local2d_tile(n, dtype, n + r + c, (dr, dc),
                                        (r, c))
            offs = (t["row_off"], t["col_off"])
            label = (f"{name} n={n} rank ({r}, {c}) of ({dr}, {dc or 1}) "
                     f"offsets {offs}")
            for sigma in (0.0, SIGMA):
                check_local2d(label, ue, be, e, t, dtype, sigma, off_path)
            del ue, be, e
        n, rows, cols, row_off, col_off = LOCAL2D_EVEN_TILE
        u, b = grids_on_card(n, dtype, n + 5, 2)
        ue = cut_tile(u, rows, cols, row_off, col_off)
        be = cut_tile(b * float((n + 1) ** 2), rows, cols, row_off, col_off)
        t = dict(n=n, m=0, mcol=0, row_off=row_off, col_off=col_off)
        for sigma in (0.0, SIGMA):
            check_local2d(f"{name} n={n} tile {tuple(ue.shape)} at even "
                          f"offsets {(row_off, col_off)}", ue, be, None, t,
                          dtype, sigma, [("residual", None, 0)] + sweeps)
        del u, b, ue, be
        for path in ("S3", "S4"):
            n = 2 ** SHARDED_PATHS[path][0] - 1
            ue, be, e, t = local2d_tile(n, dtype, n + 3)
            for sigma in (0.0, SIGMA):
                check_local2d(f"{name} {path} fine tile {tuple(ue.shape)}",
                              ue, be, e, t, dtype, sigma, sweeps)
            del ue, be, e
    for path in ("S1", "S2", "S3", "S4"):
        n, block, runs = local2d_main_checks(path)
        ue, be, e, t = local2d_tile(n, torch.float32, n + len(path),
                                    (1, 1 if block else 0))
        label = (f"{path} fine tile {tuple(ue.shape)} n={n} offsets "
                 f"{(t['row_off'], t['col_off'])}")
        errs = check_local2d(label, ue, be, e, t, torch.float32, 0.0, runs)
        for name, err in errs.items():
            if KERNELS[name][4] == path:
                main_err[name] = err
        del ue, be, e
    torch.cuda.empty_cache()


def unpacked_tile(s: torch.Tensor, cols: int, cpar: int) -> torch.Tensor:
    """A plocal2d output as its unpacked extended tile; raises if its pad
    lanes are not zero."""
    from multigridcmt_tpu_torch.kernels import plocal2d

    u = plocal2d.unpack_ext(s, cols, cpar)
    require(torch.equal(plocal2d.pack_ext(u, cpar), s),
            "packed tile's pad lanes not zero")
    return u


def check_plocal2d(label: str, ue, be, e, t, dtype, sigma, runs) -> dict:
    """Hold each of ``runs`` ((kernel, kind, sweeps); kernel one of
    residual, apply, resnorm, down, up) against its plain version on the
    packed form of one extended tile; returns the error of each kernel (of
    a down leg's two outputs and the norm's two modes, the larger
    relative one). Whole tiles are compared, unpacked, pad lanes zero."""
    from multigridcmt_tpu_torch.kernels import plocal2d

    n, m, mcol = t["n"], t["m"], t["mcol"]
    h = 1.0 / (n + 1)
    offs = (t["row_off"], t["col_off"])
    cols, cpar = ue.shape[1], 1 if mcol else 0
    su, sb = plocal2d.pack_ext(ue, cpar), plocal2d.pack_ext(be, cpar)
    tol = TOL[dtype]

    def pair(what, got, want, **kw):
        return check_pair(what, unpacked_tile(got, cols, cpar),
                          unpacked_tile(want, cols, cpar), tol,
                          ghosts=False, **kw)

    errs = {}
    for name, kind, nu in runs:
        what = f"plocal2d {name} {label} sigma={sigma} nu={nu}"
        kw = dict(kind=kind, omega=0.8, sigma=sigma, mcol=mcol, sweeps=nu)
        if name == "residual":
            err = pair(what, plocal2d.residual(su, sb, n, h, *offs,
                                               sigma=sigma),
                       plocal2d.residual_plain(su, sb, n, h, *offs,
                                               sigma=sigma))
        elif name == "apply":
            err = pair(what, plocal2d.apply_op(su, n, h, *offs, sigma=sigma),
                       plocal2d.apply_op_plain(su, n, h, *offs, sigma=sigma))
        elif name == "resnorm":
            err = max((check_pair(
                f"{what} red_only={ro}",
                plocal2d.residual_norm_sq(su, sb, n, h, m, *offs, mcol=mcol,
                                          red_only=ro, sigma=sigma),
                plocal2d.residual_norm_sq_plain(su, sb, n, h, m, *offs,
                                                mcol=mcol, red_only=ro,
                                                sigma=sigma), tol)
                for ro in (False, True)), key=lambda v: v[1])
        elif name == "down":
            gu, grc = plocal2d.down_leg(su, sb, n, h, m, *offs, **kw)
            wu, wrc = plocal2d.down_leg_plain(su, sb, n, h, m, *offs, **kw)
            err = max(pair(f"{what} {kind} u'", gu, wu),
                      check_pair(f"{what} {kind} r_c", grc, wrc, tol,
                                 tuple(e.shape), ghosts=False),
                      key=lambda v: v[1])
        else:
            nc = (n - 1) // 2
            err = pair(f"{what} {kind}",
                       plocal2d.up_leg(su, e, sb, n, nc, h, m, *offs, **kw),
                       plocal2d.up_leg_plain(su, e, sb, n, nc, h, m, *offs,
                                             **kw))
        errs[f"plocal2d_{name}"] = max(errs.get(f"plocal2d_{name}", err),
                                       err, key=lambda v: v[1])
    return errs


def compare_plocal2d(main_err: dict) -> None:
    """The plocal2d kernels against their plain versions, on packed tiles:
    S1's own fine tile (a mesh of 1, 4112 x 4097 float32, offsets -7 and 0)
    with RB-GS and Jacobi nu = 2, sigma 0 and SIGMA (the main-path error:
    RB-GS, sigma 0); the offset tiles of compare_local2d in float32 (a row
    rank with row_off 1529, a block rank with odd col_off: the other
    packing phase), each with every kernel and the legs' sweep caps;
    PLOCAL2D_F64_TILES in float64 with every kernel and the legs at every
    sweep count; and the legs at every sweep count on PLOCAL2D_EDGE_TILE,
    whose row stream ends in a partial strip and segment."""
    from multigridcmt_tpu_torch.kernels import local2d, packed2d, plocal2d

    every = [("residual", None, 0), ("apply", None, 0), ("resnorm", None, 0)]
    legs = [(leg, kind, nu) for kind, nus in (("rbgs", (0, 2, 3)),
                                              ("jacobi", (2, 6)))
            for nu in nus for leg in ("down", "up")]
    # Every sweep count up to the caps (local2d's, both legs).
    all_nu = [(leg, kind, nu) for kind in ("rbgs", "jacobi")
              for nu in range(local2d.max_down_sweeps(kind) + 1)
              for leg in ("down", "up")]
    n = 2 ** SHARDED_PATHS["S1"][0] - 1
    ue, be, e, t = local2d_tile(n, torch.float32, n + 31)
    label = (f"S1 fine tile {tuple(ue.shape)} n={n} offsets "
             f"{(t['row_off'], t['col_off'])}")
    main = every + [("down", "rbgs", 2), ("up", "rbgs", 2)]
    main_err.update(check_plocal2d(label, ue, be, e, t, torch.float32, 0.0,
                                   main))
    check_plocal2d(label, ue, be, e, t, torch.float32, 0.0,
                   [("down", "jacobi", 2), ("up", "jacobi", 2)])
    check_plocal2d(label, ue, be, e, t, torch.float32, SIGMA,
                   main + [("down", "jacobi", 2), ("up", "jacobi", 2)])
    del ue, be, e
    for dtype, tiles, runs in (
            (torch.float32, LOCAL2D_TILES, every + legs),
            (torch.float64, PLOCAL2D_F64_TILES, every + all_nu),
            (torch.float32, (PLOCAL2D_EDGE_TILE,), all_nu)):
        for n, dr, r, dc, c in tiles:
            ue, be, e, t = local2d_tile(n, dtype, n + r + c + 41, (dr, dc),
                                        (r, c))
            offs = (t["row_off"], t["col_off"])
            label = (f"{str(dtype).split('.')[-1]} n={n} rank ({r}, {c}) of "
                     f"({dr}, {dc or 1}) offsets {offs}")
            if (n, dr, r, dc, c) == PLOCAL2D_EDGE_TILE:
                card = ue.device.index or 0
                for leg, kind, nu in all_nu:
                    # The geometry the wrapper launches on this card.
                    g = plocal2d.leg_geometry(
                        leg, *ue.shape, n, *offs, kind, nu,
                        sm_count=packed2d._sm_count(card))
                    launched = tuple(packed2d._launch_geometry(
                        leg, n, kind, nu, card,
                        **plocal2d._frame(*ue.shape, *offs)))
                    require(g.ints() == launched,
                            f"{label}: {leg} {kind} nu={nu}: geometry "
                            f"{g.ints()} is not the launched {launched}")
                    require(g.strips * g.strip > g.lanes
                            and g.segs * g.seg > ue.shape[0] + 1,
                            f"{label}: {leg} {kind} nu={nu}: last strip or "
                            f"segment not partial ({g.ints()})")
            for sigma in (0.0, SIGMA):
                check_plocal2d(label, ue, be, e, t, dtype, sigma, runs)
            del ue, be, e
    torch.cuda.empty_cache()


def phase_compare():
    """Each kernel against its plain version on the card. Returns (max abs
    error, relative error, tolerance) per kernel at the main paths' shapes
    (float32, sigma=0; the legs RB-GS nu=2: packed at n=4095, fused2d and
    stencil2d at n=2047, stencil3d at n=511 (Jacobi: one sweep); the
    composed legs' kernels as compare_composed and compare_sweeps say; the
    sparse kernels as compare_sparse says; local2d and plocal2d as
    compare_local2d and compare_plocal2d say); of a leg's two outputs, the
    one with the larger relative error."""
    main_err = {}
    compare_2d(main_err)
    compare_fused_legs()
    compare_packed_legs(main_err)
    compare_packed_residual(main_err)
    compare_composed(main_err)
    compare_sweeps(main_err)
    compare_stencil3d(main_err)
    compare_sparse(main_err)
    compare_local2d(main_err)
    compare_plocal2d(main_err)
    compare_mixed(main_err)
    compare_mixed3d(main_err)
    compare_mixed_sharded(main_err)
    compare_cdt_bf16(main_err)
    compare_native_bf16(main_err)
    compare_native_legs(main_err)
    return main_err


# Kernel -> (counter module, counter, CUDA source, the TPU kernel it
# replaces, the run of phase 3 whose launches it reports).
KERNELS = {
    "packed2d_down": ("packed2d", "down_launches",
                      "multigridcmt_tpu_torch/kernels/csrc/packed2d_legs.cuh",
                      "multigridcmt_tpu/kernels/packed2d.py:839", "solve2d"),
    "packed2d_up": ("packed2d", "up_launches",
                    "multigridcmt_tpu_torch/kernels/csrc/packed2d_legs.cuh",
                    "multigridcmt_tpu/kernels/packed2d.py:1067", "solve2d"),
    "packed2d_resnorm": ("packed2d", "resnorm_launches",
                         "multigridcmt_tpu_torch/kernels/csrc/packed2d.cu",
                         "multigridcmt_tpu/kernels/packed2d.py:553",
                         "solve2d"),
    "fused2d_down": ("fused2d", "down_launches",
                     "multigridcmt_tpu_torch/kernels/csrc/fused2d.cu",
                     "multigridcmt_tpu/kernels/fused2d.py:289", "solve2d"),
    "fused2d_up": ("fused2d", "up_launches",
                   "multigridcmt_tpu_torch/kernels/csrc/fused2d_up.cu",
                   "multigridcmt_tpu/kernels/fused2d.py:479", "solve2d"),
    "packed2d_residual": ("packed2d", "residual_launches",
                          "multigridcmt_tpu_torch/kernels/csrc/packed2d.cu",
                          "multigridcmt_tpu/kernels/packed2d.py:440",
                          "pcg2d"),
    "stencil3d_rbgs": ("stencil3d", "rbgs_launches",
                       "multigridcmt_tpu_torch/kernels/csrc/stencil3d.cu",
                       "multigridcmt_tpu/kernels/stencil3d.py:510",
                       "solve3d"),
    "stencil3d_residual": ("stencil3d", "residual_launches",
                           "multigridcmt_tpu_torch/kernels/csrc/stencil3d.cu",
                           "multigridcmt_tpu/kernels/stencil3d.py:474",
                           "solve3d"),
    "stencil2d_residual": ("stencil2d", "launches",
                           "multigridcmt_tpu_torch/kernels/csrc/stencil2d.cu",
                           "multigridcmt_tpu/kernels/stencil2d.py:304",
                           "chebyshev2d"),
    "transfer2d_residual_restrict": (
        "transfer2d", "residual_restrict_launches",
        "multigridcmt_tpu_torch/kernels/csrc/transfer2d.cu",
        "multigridcmt_tpu/kernels/transfer2d.py:371", "chebyshev2d"),
    "transfer2d_prolong_add": (
        "transfer2d", "prolong_add_launches",
        "multigridcmt_tpu_torch/kernels/csrc/transfer2d.cu",
        "multigridcmt_tpu/kernels/transfer2d.py:204", "chebyshev2d"),
    "stencil2d_rbgs": ("stencil2d", "rbgs_launches",
                       "multigridcmt_tpu_torch/kernels/csrc/"
                       "stencil2d_sweep.cu",
                       "multigridcmt_tpu/kernels/stencil2d.py:284",
                       "rbgs44"),
    "stencil2d_jacobi": ("stencil2d", "jacobi_launches",
                         "multigridcmt_tpu_torch/kernels/csrc/"
                         "stencil2d_sweep.cu",
                         "multigridcmt_tpu/kernels/stencil2d.py:295",
                         "jacobi88"),
    "packed2d_rbgs": ("packed2d", "rbgs_launches",
                      "multigridcmt_tpu_torch/kernels/csrc/packed2d_sweep.cu",
                      "multigridcmt_tpu/kernels/packed2d.py:305", "rbgs44"),
    # A single-device 3D Jacobi cycle takes the plain route (as in JAX);
    # the sharded one runs the kernel on its slab stacks (slab511-jacobi).
    # The row also reports the direct calls' launches apart.
    "stencil3d_jacobi": ("stencil3d", "jacobi_launches",
                         "multigridcmt_tpu_torch/kernels/csrc/stencil3d.cu",
                         "multigridcmt_tpu/kernels/stencil3d.py:485",
                         "slab511-jacobi"),
    "spmv_dia": ("spmv", "launches",
                 "multigridcmt_tpu_torch/kernels/csrc/spmv.cu",
                 "multigridcmt_tpu/kernels/spmv.py:254", "spmv2d"),
    "bell_spmm": ("bell", "launches",
                  "multigridcmt_tpu_torch/kernels/csrc/bell.cu",
                  "multigridcmt_tpu/kernels/bell.py:180", "bell"),
    "local2d_down": ("local2d", "down_launches",
                     "multigridcmt_tpu_torch/kernels/csrc/local2d_legs.cu",
                     "multigridcmt_tpu/kernels/local2d.py:616", "S1"),
    "local2d_up": ("local2d", "up_launches",
                   "multigridcmt_tpu_torch/kernels/csrc/local2d_legs.cu",
                   "multigridcmt_tpu/kernels/local2d.py:843", "S1"),
    "local2d_residual": ("local2d", "residual_launches",
                         "multigridcmt_tpu_torch/kernels/csrc/local2d.cu",
                         "multigridcmt_tpu/kernels/local2d.py:289", "S2"),
    "local2d_rbgs": ("local2d", "rbgs_launches",
                     "multigridcmt_tpu_torch/kernels/csrc/local2d_sweep.cu",
                     "multigridcmt_tpu/kernels/local2d.py:263", "S3"),
    "local2d_jacobi": ("local2d", "jacobi_launches",
                       "multigridcmt_tpu_torch/kernels/csrc/"
                       "local2d_sweep.cu",
                       "multigridcmt_tpu/kernels/local2d.py:278", "S4"),
    "plocal2d_down": ("plocal2d", "down_launches",
                      "multigridcmt_tpu_torch/kernels/csrc/plocal2d_legs.cu",
                      "multigridcmt_tpu/kernels/plocal2d.py:501", "S1"),
    "plocal2d_up": ("plocal2d", "up_launches",
                    "multigridcmt_tpu_torch/kernels/csrc/plocal2d_legs.cu",
                    "multigridcmt_tpu/kernels/plocal2d.py:708", "S1"),
    "plocal2d_resnorm": ("plocal2d", "resnorm_launches",
                         "multigridcmt_tpu_torch/kernels/csrc/plocal2d.cu",
                         "multigridcmt_tpu/kernels/plocal2d.py:855", "S1"),
    "plocal2d_residual": ("plocal2d", "residual_launches",
                          "multigridcmt_tpu_torch/kernels/csrc/plocal2d.cu",
                          "multigridcmt_tpu/kernels/plocal2d.py:262",
                          "S1pcg"),
    "plocal2d_apply": ("plocal2d", "apply_launches",
                       "multigridcmt_tpu_torch/kernels/csrc/plocal2d.cu",
                       "multigridcmt_tpu/kernels/plocal2d.py:982", "S1pcg"),
    # The bfloat16 modes of the packed2d kernels (mixed precision). The
    # up leg's two: x' stored in float32 (the top level of a mixed cycle)
    # and in bfloat16 (the TPU kernel's own mode, which no solver of the
    # port runs: direct calls only).
    "packed2d_down_bf16": ("packed2d", "down_bf16_launches",
                           "multigridcmt_tpu_torch/kernels/csrc/"
                           "packed2d_bf16.cu",
                           "multigridcmt_tpu/kernels/packed2d.py:839",
                           "mixed2d"),
    "packed2d_up_bf16_f32": ("packed2d", "up_bf16_f32_launches",
                             "multigridcmt_tpu_torch/kernels/csrc/"
                             "packed2d_up_bf16_f32.cu",
                             "multigridcmt_tpu/kernels/packed2d.py:1067",
                             "mixed2d"),
    "packed2d_rbgs_bf16": ("packed2d", "rbgs_bf16_launches",
                           "multigridcmt_tpu_torch/kernels/csrc/"
                           "packed2d_sweep_bf16.cu",
                           "multigridcmt_tpu/kernels/packed2d.py:305",
                           "mixedB"),
    "packed2d_residual_bf16": ("packed2d", "residual_bf16_launches",
                               "multigridcmt_tpu_torch/kernels/csrc/"
                               "packed2d_bf16.cu",
                               "multigridcmt_tpu/kernels/packed2d.py:440",
                               "mixedA"),
    "packed2d_up_bf16": ("packed2d", "up_bf16_launches",
                         "multigridcmt_tpu_torch/kernels/csrc/"
                         "packed2d_up_bf16.cu",
                         "multigridcmt_tpu/kernels/packed2d.py:1067", None),
    # The bfloat16 modes of the stencil3d kernels (3D mixed precision): the
    # residual (float32 out) and the RB-GS sweep storing bfloat16 run on
    # the mixed 3D cycle's fine level, the Jacobi sweep storing bfloat16 on
    # the sharded mixed Jacobi cycle's (a single-device 3D Jacobi cycle
    # runs plain); the sweeps storing float32 (the TPU kernels'
    # out_dtype) on no path: every mixed 3D cycle promotes its fine level
    # at the correction add and runs the float32 sweeps after it. Their
    # rows also report direct calls.
    "stencil3d_residual_bf16": ("stencil3d", "residual_bf16_launches",
                                "multigridcmt_tpu_torch/kernels/csrc/"
                                "stencil3d_bf16.cu",
                                "multigridcmt_tpu/kernels/stencil3d.py:474",
                                "mixed3d"),
    "stencil3d_rbgs_bf16": ("stencil3d", "rbgs_bf16_launches",
                            "multigridcmt_tpu_torch/kernels/csrc/"
                            "stencil3d_bf16.cu",
                            "multigridcmt_tpu/kernels/stencil3d.py:510",
                            "mixed3d"),
    "stencil3d_rbgs_bf16_f32": ("stencil3d", "rbgs_bf16_f32_launches",
                                "multigridcmt_tpu_torch/kernels/csrc/"
                                "stencil3d_bf16.cu",
                                "multigridcmt_tpu/kernels/stencil3d.py:510",
                                None),
    "stencil3d_jacobi_bf16": ("stencil3d", "jacobi_bf16_launches",
                              "multigridcmt_tpu_torch/kernels/csrc/"
                              "stencil3d_bf16.cu",
                              "multigridcmt_tpu/kernels/stencil3d.py:485",
                              "slab511-mixed-jacobi"),
    "stencil3d_jacobi_bf16_f32": ("stencil3d", "jacobi_bf16_f32_launches",
                                  "multigridcmt_tpu_torch/kernels/csrc/"
                                  "stencil3d_bf16.cu",
                                  "multigridcmt_tpu/kernels/stencil3d.py:485",
                                  None),
    # The bfloat16 modes of the shard tile legs (sharded mixed precision):
    # the down leg and the up leg storing float32 run on a sharded mixed
    # cycle's fine level (S1mixed packed, S1unpacked-mixed unpacked); the up
    # leg storing bfloat16 (the TPU kernel's own mode) on no path: direct
    # calls only.
    "local2d_down_bf16": ("local2d", "down_bf16_launches",
                          "multigridcmt_tpu_torch/kernels/csrc/"
                          "local2d_legs_bf16.cu",
                          "multigridcmt_tpu/kernels/local2d.py:616",
                          "S1unpacked-mixed"),
    "local2d_up_bf16_f32": ("local2d", "up_bf16_f32_launches",
                            "multigridcmt_tpu_torch/kernels/csrc/"
                            "local2d_up_bf16_f32.cu",
                            "multigridcmt_tpu/kernels/local2d.py:843",
                            "S1unpacked-mixed"),
    "local2d_up_bf16": ("local2d", "up_bf16_launches",
                        "multigridcmt_tpu_torch/kernels/csrc/"
                        "local2d_legs_bf16.cu",
                        "multigridcmt_tpu/kernels/local2d.py:843", None),
    "plocal2d_down_bf16": ("plocal2d", "down_bf16_launches",
                           "multigridcmt_tpu_torch/kernels/csrc/"
                           "plocal2d_legs_bf16.cu",
                           "multigridcmt_tpu/kernels/plocal2d.py:501",
                           "S1mixed"),
    "plocal2d_up_bf16_f32": ("plocal2d", "up_bf16_f32_launches",
                             "multigridcmt_tpu_torch/kernels/csrc/"
                             "plocal2d_up_bf16_f32.cu",
                             "multigridcmt_tpu/kernels/plocal2d.py:708",
                             "S1mixed"),
    "plocal2d_up_bf16": ("plocal2d", "up_bf16_launches",
                         "multigridcmt_tpu_torch/kernels/csrc/"
                         "plocal2d_legs_bf16.cu",
                         "multigridcmt_tpu/kernels/plocal2d.py:708", None),
    # The last bfloat16 modes of the JAX package's _cdt kernels (float32
    # arithmetic, each output rounded once, the norms float32 sums): the
    # packed tile's residual, apply and norm, the whole grid's norm and the
    # BELL SpMM. No path of either package runs them: direct calls only.
    "plocal2d_residual_bf16": ("plocal2d", "residual_bf16_launches",
                               "multigridcmt_tpu_torch/kernels/csrc/"
                               "plocal2d_bf16.cu",
                               "multigridcmt_tpu/kernels/plocal2d.py:262",
                               None),
    "plocal2d_apply_bf16": ("plocal2d", "apply_bf16_launches",
                            "multigridcmt_tpu_torch/kernels/csrc/"
                            "plocal2d_bf16.cu",
                            "multigridcmt_tpu/kernels/plocal2d.py:982", None),
    "plocal2d_resnorm_bf16": ("plocal2d", "resnorm_bf16_launches",
                              "multigridcmt_tpu_torch/kernels/csrc/"
                              "plocal2d_bf16.cu",
                              "multigridcmt_tpu/kernels/plocal2d.py:855",
                              None),
    "packed2d_resnorm_bf16": ("packed2d", "resnorm_bf16_launches",
                              "multigridcmt_tpu_torch/kernels/csrc/"
                              "packed2d_bf16.cu",
                              "multigridcmt_tpu/kernels/packed2d.py:553",
                              None),
    "bell_spmm_bf16": ("bell", "bf16_launches",
                       "multigridcmt_tpu_torch/kernels/csrc/bell.cu",
                       "multigridcmt_tpu/kernels/bell.py:180", None),
    # The native bfloat16 modes (the TPU kernels computing in bfloat16
    # itself: every operation rounded) of slice B1: direct calls; the
    # bfloat16 solves (BF16_SOLVES) also run the stencil2d residual and
    # RB-GS and Jacobi sweeps (on the composed route; a whole grid's sweeps
    # are the row stream, the rest native_bf16.cu's kernels).
    "stencil2d_residual_bf16": ("stencil2d", "residual_bf16_launches",
                                "multigridcmt_tpu_torch/kernels/csrc/"
                                "native_bf16.cu",
                                "multigridcmt_tpu/kernels/stencil2d.py:304",
                                None),
    "stencil2d_rbgs_bf16": ("stencil2d", "rbgs_bf16_launches",
                            "multigridcmt_tpu_torch/kernels/csrc/"
                            "stencil2d_sweep_native_bf16.cu",
                            "multigridcmt_tpu/kernels/stencil2d.py:284",
                            None),
    "stencil2d_jacobi_bf16": ("stencil2d", "jacobi_bf16_launches",
                              "multigridcmt_tpu_torch/kernels/csrc/"
                              "stencil2d_jacobi_native_bf16.cu",
                              "multigridcmt_tpu/kernels/stencil2d.py:295",
                              None),
    "local2d_residual_bf16": ("local2d", "residual_bf16_launches",
                              "multigridcmt_tpu_torch/kernels/csrc/"
                              "native_bf16.cu",
                              "multigridcmt_tpu/kernels/local2d.py:289",
                              None),
    "local2d_rbgs_bf16": ("local2d", "rbgs_bf16_launches",
                          "multigridcmt_tpu_torch/kernels/csrc/"
                          "native_bf16.cu",
                          "multigridcmt_tpu/kernels/local2d.py:263", None),
    "local2d_jacobi_bf16": ("local2d", "jacobi_bf16_launches",
                            "multigridcmt_tpu_torch/kernels/csrc/"
                            "native_bf16.cu",
                            "multigridcmt_tpu/kernels/local2d.py:278", None),
    "spmv_dia_bf16": ("spmv", "bf16_launches",
                      "multigridcmt_tpu_torch/kernels/csrc/spmv.cu",
                      "multigridcmt_tpu/kernels/spmv.py:254", None),
    # The last native modes (slice B2), on the bfloat16 solves' path
    # (BF16_SOLVES: launches summed over MAIN_RUNS).
    "fused2d_down_bf16": ("fused2d", "down_bf16_launches",
                          "multigridcmt_tpu_torch/kernels/csrc/"
                          "fused2d_native_bf16.cu",
                          "multigridcmt_tpu/kernels/fused2d.py:289", None),
    "fused2d_up_bf16": ("fused2d", "up_bf16_launches",
                        "multigridcmt_tpu_torch/kernels/csrc/"
                        "fused2d_up_native_bf16.cu",
                        "multigridcmt_tpu/kernels/fused2d.py:479", None),
    "transfer2d_residual_restrict_bf16": (
        "transfer2d", "residual_restrict_bf16_launches",
        "multigridcmt_tpu_torch/kernels/csrc/transfer2d_native_bf16.cu",
        "multigridcmt_tpu/kernels/transfer2d.py:371", None),
    "transfer2d_prolong_add_bf16": (
        "transfer2d", "prolong_add_bf16_launches",
        "multigridcmt_tpu_torch/kernels/csrc/"
        "transfer2d_prolong_native_bf16.cu",
        "multigridcmt_tpu/kernels/transfer2d.py:204", None),
}
# A kernel's launches by one variant -> (counter module, counter, the
# KERNELS entries whose launches they are part of): the bfloat16 RB-GS
# sweep's paired march (both outputs), the bfloat16-storing Jacobi sweep's
# paired march and the packed residual's paired kernel, which their
# launchers take where the layout pairs (every whole grid of the mixed
# paths; for Jacobi every stack too) and the scalar kernels elsewhere.
VARIANTS = {
    "stencil3d_rbgs_bf16_pairs": ("stencil3d", "rbgs_bf16_pairs_launches",
                                  ("stencil3d_rbgs_bf16",
                                   "stencil3d_rbgs_bf16_f32")),
    "stencil3d_jacobi_bf16_pairs": ("stencil3d",
                                    "jacobi_bf16_pairs_launches",
                                    ("stencil3d_jacobi_bf16",)),
    "packed2d_residual_bf16_pairs": ("packed2d",
                                     "residual_bf16_pairs_launches",
                                     ("packed2d_residual_bf16",)),
}
# The runs of phase 3 that drive a main path through the public API.
MAIN_RUNS = ("solve2d", "pcg2d", "chebyshev2d", "rbgs44", "jacobi88",
             "solve3d", "pcg3d", "spmv2d", "spmv3d", "bell", "S1", "S1pcg",
             "S1unpacked", "S2", "S3", "S4", "S4cheb", "fmg1023", "fmg4095",
             "eigen511_ii", "eigen511_rqi", "eigen511_lobpcg", "S1fmg",
             "mixed2d", "mixedB", "mixedA", "mixed_lobpcg", "mixed_ii",
             "mixed3d", "mixed3d_lobpcg", "mixed3d_ii", "S1mixed",
             "S1unpacked-mixed", "S2mixed", "sharded_mixed_f64",
             *SHARDED_EIGEN_RUNS, *SHARDED3D_RUNS, *BF16_SOLVES)
# Direct calls of kernels that no single-device path launches (the
# sharded 3D paths launch them since).
DIRECT_RUNS = {"stencil3d_jacobi": "jacobi3d",
               "packed2d_up_bf16": "up_bf16_direct",
               "stencil3d_rbgs_bf16_f32": "mixed3d_direct",
               "stencil3d_jacobi_bf16": "mixed3d_direct",
               "stencil3d_jacobi_bf16_f32": "mixed3d_direct",
               "local2d_up_bf16": "sharded_up_bf16_direct",
               "plocal2d_up_bf16": "sharded_up_bf16_direct",
               "plocal2d_residual_bf16": "cdt_bf16_direct",
               "plocal2d_apply_bf16": "cdt_bf16_direct",
               "plocal2d_resnorm_bf16": "cdt_bf16_direct",
               "packed2d_resnorm_bf16": "cdt_bf16_direct",
               "bell_spmm_bf16": "cdt_bf16_direct",
               **{name: "native_bf16_direct" for name in (
                   "stencil2d_residual_bf16", "stencil2d_rbgs_bf16",
                   "stencil2d_jacobi_bf16", "local2d_residual_bf16",
                   "local2d_rbgs_bf16", "local2d_jacobi_bf16",
                   "spmv_dia_bf16")}}


def kernel_module(mod: str):
    return importlib.import_module(f"multigridcmt_tpu_torch.kernels.{mod}")


def reset_counts() -> None:
    for mod, attr, *_ in (*KERNELS.values(), *VARIANTS.values()):
        setattr(kernel_module(mod), attr, 0)


def read_counts() -> dict:
    """Each kernel's launches and each variant's (VARIANTS)."""
    return {name: getattr(kernel_module(mod), attr)
            for name, (mod, attr, *_) in (*KERNELS.items(),
                                          *VARIANTS.items())}


def counted(fn):
    """(fn(), launches of each kernel in that call, wall seconds): the
    counters are set to 0 just before and read just after."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, read_counts(), wall


def entry_counts(fn):
    """(fn(), {C entry point: calls} of the kernel launches fn makes)."""
    from multigridcmt_tpu_torch.kernels import _build

    tally, orig = {}, _build.launch

    def launch(name, *args):
        tally[name] = tally.get(name, 0) + 1
        orig(name, *args)

    _build.launch = launch
    try:
        return fn(), tally
    finally:
        _build.launch = orig


def require_counts(label: str, got: dict, **want) -> None:
    """Every kernel and variant launched exactly as ``want`` says, every
    other one not at all."""
    full = {name: want.get(name, 0) for name in (*KERNELS, *VARIANTS)}
    log(f"  launches {label}: { {k: v for k, v in got.items() if v} }")
    require(got == full, f"{label}: launches {got}, expected {full}")


def check_solve(label: str, prob, solver, res, wall: float, ndim: int,
                peak=None, bound=None) -> None:
    """A float32 solve's shape, residual drop and error against u_exact
    (below ``bound``, MAXERR[ndim] unless given)."""
    bound = MAXERR[ndim] if bound is None else bound
    x = res.x
    maxerr = (x - prob.u_exact).abs().max().item()
    hist = res.res_history[: res.iters + 1].tolist()
    mem = "" if peak is None else f", peak memory {peak / 2**20:.1f} MiB"
    log(f"{label}: iters {res.iters}, converged {res.converged}, final rel "
        f"residual {hist[-1]:.4e}, max error vs u_exact {maxerr:.4e}, l2 "
        f"error {solver.discrete_l2_error(x).item():.4e}, wall {wall:.3f} s"
        f"{mem}")
    log(f"  history {[f'{v:.3e}' for v in hist]}")
    require(tuple(x.shape) == tuple(prob.b.shape)
            and bool(x.isfinite().all()),
            f"{label}: solution has the wrong shape or non-finite values")
    require(res.iters >= 2 and hist[-1] < 0.5 * hist[0],
            f"{label}: the solve did not reduce the residual: {hist}")
    require(maxerr < bound, f"{label}: max error vs u_exact "
            f"{maxerr:.3e} >= {bound}")


def vcycles_against_plain(label: str, build, rtol: float) -> None:
    """Five V-cycles from x = 0 on the kernel path and on the plain path,
    both on the card, through MultigridSolver.v_cycle."""
    import multigridcmt_tpu_torch as mt

    pk, pp = build(True), build(False)
    sk, sp = mt.MultigridSolver(pk), mt.MultigridSolver(pp)
    xk = torch.zeros_like(pk.b)
    xp = torch.zeros_like(pp.b)
    for _ in range(5):
        xk = sk.v_cycle(xk, pk.b)
        xp = sp.v_cycle(xp, pp.b)
    diff = (torch.linalg.vector_norm(xk - xp)
            / torch.linalg.vector_norm(xp)).item()
    errs = [(x - pk.u_exact).abs().max().item() for x in (xk, xp)]
    bound = MAXERR[pk.config.ndim]
    log(f"5 V-cycles {label}, kernel vs plain: rel l2 {diff:.3e}, max abs "
        f"{(xk - xp).abs().max().item():.3e}; max error vs u_exact "
        f"{errs[0]:.3e} (kernel), {errs[1]:.3e} (plain)")
    require(diff <= rtol and max(errs) < bound,
            f"{label} V-cycles differ: {diff:.3e} > {rtol}, or error vs "
            f"u_exact {errs} >= {bound}")


def f64_against_plain(label: str, build, hist_rtol: float, method="mg",
                      floor=None):
    """A float64 solve on the kernel path and the plain path: both
    converge, in equal iterations, with histories within ``hist_rtol``
    plus ``floor`` (default the dimension's ``F64_FLOOR``). Returns the
    kernel path's result and launches."""
    import multigridcmt_tpu_torch as mt

    out = {}
    for use_kernels in (True, False):
        p = build(use_kernels)
        res, counts, _ = counted(
            lambda: mt.MultigridSolver(p).solve(method=method))
        out[use_kernels] = (p, res, counts)
    (pk, rk, ck), (_, rp, _) = out[True], out[False]
    hk = rk.res_history[: rk.iters + 1]
    hp = rp.res_history[: rp.iters + 1]
    err64 = (rk.x - pk.u_exact).abs().max().item()
    log(f"{label} float64: kernel iters {rk.iters} converged {rk.converged}, "
        f"plain iters {rp.iters}; final {hk[-1].item():.3e}; max error vs "
        f"u_exact {err64:.3e}")
    require(rk.converged and rp.converged and rk.iters == rp.iters,
            f"{label} float64: {rk.iters}/{rk.converged} vs "
            f"{rp.iters}/{rp.converged}")
    hdiff = ((hk - hp).abs() / hp).tolist()
    log(f"  history rel diff {[f'{v:.1e}' for v in hdiff]}")
    floor = F64_FLOOR[pk.config.ndim] if floor is None else floor
    require(bool(((hk - hp).abs() <= hist_rtol * hp + floor).all()),
            f"{label} float64 histories differ by {max(hdiff):.3e} > "
            f"{hist_rtol} (+ {floor})")
    # The discretisation error is pi^2 h^2 / 12 to leading order; below
    # k = 9 it passes 1e-5.
    bound = max(1e-5, 1.5 * math.pi ** 2 * pk.config.h ** 2 / 12)
    require(err64 < bound, f"{label} float64 max error vs u_exact "
            f"{err64:.3e} >= {bound:.3e}")
    return rk, ck


def fused_levels(prob) -> int:
    """Levels of a 2D problem that run the fused2d legs."""
    from multigridcmt_tpu_torch import kernels

    return sum(kernels.KERNEL_MIN_N <= lv.n < kernels.PACK_MIN_N
               for lv in prob.hierarchy.levels[:-1])


def paths_2d(runs: dict) -> None:
    import multigridcmt_tpu_torch as mt
    from multigridcmt_tpu_torch import kernels

    def build(k, dtype, use_kernels=True, **kw):
        return mt.poisson2d(k=k, dtype=dtype, smoother="rbgs",
                            use_kernels=use_kernels, device="cuda", **kw)

    prob = build(MAIN_K, torch.float32)
    solver = mt.MultigridSolver(prob)
    packed_levels = sum(lv.n >= kernels.PACK_MIN_N
                        for lv in prob.hierarchy.levels[:-1])
    fused = fused_levels(prob)
    require((packed_levels, fused) == (1, 4),
            f"{packed_levels} packed and {fused} fused2d levels, not 1 and 4")
    torch.cuda.reset_peak_memory_stats()
    res, counts, wall = counted(solver.solve)
    runs["peak2d"] = torch.cuda.max_memory_allocated()
    # The float32 solve stalls near 1e-1 relative residual at this h (the
    # 1/h^2 cancellation); the iterate is still close to the analytic
    # solution.
    check_solve(f"solve k={MAIN_K} float32 rbgs", prob, solver, res, wall, 2,
                runs["peak2d"])
    runs["x2d"] = res.x                      # fmg4095's yardstick
    i = res.iters
    require_counts("solve2d", counts, packed2d_down=i, packed2d_up=i,
                   packed2d_resnorm=i + 1, fused2d_down=fused * i,
                   fused2d_up=fused * i)
    runs["solve2d"] = counts

    # MG-PCG: CG's first residual and its operator apply (one an
    # iteration) run the packed residual; each preconditioning cycle (one
    # from the start and one an iteration) the packed and fused2d legs.
    res, counts, wall = counted(lambda: solver.solve(method="pcg"))
    check_solve(f"pcg k={MAIN_K} float32 rbgs", prob, solver, res, wall, 2)
    i = res.iters
    require_counts("pcg2d", counts, packed2d_residual=1 + i,
                   packed2d_down=i + 1, packed2d_up=i + 1,
                   fused2d_down=fused * (i + 1),
                   fused2d_up=fused * (i + 1))
    runs["pcg2d"] = counts
    del prob, solver, res

    for dtype, rtol in VCYCLE_RTOL.items():
        vcycles_against_plain(
            f"{str(dtype).split('.')[-1]} k={MAIN_K}",
            lambda use_kernels: build(MAIN_K, dtype, use_kernels), rtol)

    # float64: kernel path against plain path. k=10 (fused2d legs, the
    # stencil2d check) must agree to rtol 1e-8 in its history. At k=12 the
    # kernel path's check sums the red residual only; near the float64
    # floor (~1e-9 relative at this h) that differs from the plain path's
    # full norm by up to a few 1e-3 of the value, so the histories are held
    # to 1e-2 there and the cycle counts must agree.
    k_solve, k_pcg = F64_K[2]
    for k, hist_rtol in ((k_solve, 1e-8), (MAIN_K, 1e-2)):
        rk, ck = f64_against_plain(
            f"solve k={k}", lambda use_kernels: build(
                k, torch.float64, use_kernels, tol=F64_TOL), hist_rtol)
        if k == k_solve:
            fused = fused_levels(build(k, torch.float64))
            require_counts("f64_2d", ck, stencil2d_residual=rk.iters + 1,
                           fused2d_down=fused * rk.iters,
                           fused2d_up=fused * rk.iters)
    # float64 PCG on an unpacked fine level: the stencil2d residual is CG's
    # first residual and its operator apply.
    rk, ck = f64_against_plain(
        f"pcg k={k_pcg}", lambda use_kernels: build(
            k_pcg, torch.float64, use_kernels, tol=F64_TOL), F64_TOL, "pcg")
    fused = fused_levels(build(k_pcg, torch.float64))
    require_counts(f"pcg f64 k={k_pcg}", ck, stencil2d_residual=1 + rk.iters,
                   fused2d_down=fused * (rk.iters + 1),
                   fused2d_up=fused * (rk.iters + 1))


def paths_composed(runs: dict) -> None:
    """Paths A-C: the legs that do not fuse, composed on both tiers."""
    import multigridcmt_tpu_torch as mt

    def build(k, dtype, smoother, use_kernels=True, **kw):
        return mt.poisson2d(k=k, dtype=dtype, smoother=smoother,
                            use_kernels=use_kernels, device="cuda", **kw)

    # A: Chebyshev V(2,2) at 4095^2. Per cycle, the packed level smooths
    # from the packed residual (nu1 + nu2 applies) and runs the zero-sweep
    # down and up legs; each of the 4 unpacked kernel-tier levels smooths
    # from the stencil2d residual and runs residual_restrict and
    # prolong_add. The check sums both colours (red_only is off).
    prob = build(MAIN_K, torch.float32, "chebyshev")
    solver = mt.MultigridSolver(prob)
    deg = prob.config.nu1 + prob.config.nu2
    lv = fused_levels(prob)
    res, counts, wall = counted(solver.solve)
    check_solve(f"A: solve k={MAIN_K} float32 chebyshev", prob, solver, res,
                wall, 2)
    i = res.iters
    require_counts("chebyshev2d", counts, packed2d_residual=deg * i,
                   packed2d_down=i, packed2d_up=i, packed2d_resnorm=i + 1,
                   stencil2d_residual=lv * deg * i,
                   transfer2d_residual_restrict=lv * i,
                   transfer2d_prolong_add=lv * i)
    runs["chebyshev2d"] = counts
    # Chebyshev-preconditioned CG: CG's first residual and its operator
    # apply run the packed residual, and so does each preconditioning
    # cycle's packed smoothing.
    res, counts, wall = counted(lambda: solver.solve(method="pcg"))
    check_solve(f"pcg k={MAIN_K} float32 chebyshev", prob, solver, res,
                wall, 2)
    c = res.iters + 1                         # preconditioning cycles
    require_counts("pcg chebyshev2d", counts,
                   packed2d_residual=res.iters + 1 + deg * c,
                   packed2d_down=c, packed2d_up=c,
                   stencil2d_residual=lv * deg * c,
                   transfer2d_residual_restrict=lv * c,
                   transfer2d_prolong_add=lv * c)
    del prob, solver, res

    # B: RB-GS V(4,4) at 4095^2. The pre-smooth exceeds the down legs' cap
    # (3): the packed level runs one 4-sweep packed RB-GS launch and the
    # zero-sweep down leg, the unpacked levels one 4-sweep stencil2d launch
    # and residual_restrict; the up legs fuse (4 <= their cap).
    prob = build(MAIN_K, torch.float32, "rbgs", nu1=4, nu2=4)
    solver = mt.MultigridSolver(prob)
    lv = fused_levels(prob)
    res, counts, wall = counted(solver.solve)
    check_solve(f"B: solve k={MAIN_K} float32 rbgs V(4,4)", prob, solver,
                res, wall, 2)
    i = res.iters
    require_counts("rbgs44", counts, packed2d_rbgs=i, packed2d_down=i,
                   packed2d_up=i, packed2d_resnorm=i + 1,
                   stencil2d_rbgs=lv * i,
                   transfer2d_residual_restrict=lv * i, fused2d_up=lv * i)
    runs["rbgs44"] = counts
    del prob, solver, res

    # C: Jacobi V(8,8) at 1023^2 (no packed level): 8 sweeps in one
    # stencil2d launch and residual_restrict on 1023, 511 and 255; the up
    # legs fuse (8 <= their cap); the check is the stencil2d residual.
    prob = build(PATH_C_K, torch.float32, "jacobi", nu1=8, nu2=8)
    solver = mt.MultigridSolver(prob)
    lv = fused_levels(prob)
    require(lv == 3, f"{lv} kernel-tier levels at k={PATH_C_K}, not 3")
    res, counts, wall = counted(solver.solve)
    check_solve(f"C: solve k={PATH_C_K} float32 jacobi V(8,8)", prob,
                solver, res, wall, 2)
    i = res.iters
    require_counts("jacobi88", counts, stencil2d_jacobi=lv * i,
                   transfer2d_residual_restrict=lv * i, fused2d_up=lv * i,
                   stencil2d_residual=i + 1)
    runs["jacobi88"] = counts
    del prob, solver, res

    # float64 B and C at k=10, kernel path against plain path: every level
    # below 1023 is unpacked, and the unpacked sweeps (RB-GS and Jacobi) and
    # legs, the transfer2d kernels and the stencil2d residual round as the
    # plain ops do at sigma = 0 with h a power of two, so the histories are
    # held to 1e-8 with no rounding floor. Then B again with the 1023 level
    # packed (the packed RB-GS sweep, legs and norm, which sum in their own
    # order), with a floor of F64_PACKED_FLOOR.
    paths_f64_composed()

    # float64 Chebyshev at k=10, kernel path against plain path: with h a
    # power of two the stencil2d residual and the transfer2d kernels round
    # as the plain ops do (sigma = 0), so the histories are held to 1e-8.
    rk, ck = f64_against_plain(
        f"chebyshev k={PATH_C_K}", lambda use_kernels: build(
            PATH_C_K, torch.float64, "chebyshev", use_kernels, tol=F64_TOL),
        1e-8)
    i = rk.iters
    lv = fused_levels(build(PATH_C_K, torch.float64, "chebyshev"))
    require_counts(f"chebyshev f64 k={PATH_C_K}", ck,
                   stencil2d_residual=lv * deg * i + i + 1,
                   transfer2d_residual_restrict=lv * i,
                   transfer2d_prolong_add=lv * i)


def paths_f64_composed() -> None:
    """The float64 k=10 history gates of paths B and C (see
    paths_composed), with their exact launches."""
    import multigridcmt_tpu_torch as mt
    from multigridcmt_tpu_torch import kernels

    def build(smoother, nu, use_kernels=True):
        return mt.poisson2d(k=PATH_C_K, dtype=torch.float64,
                            smoother=smoother, nu1=nu, nu2=nu,
                            use_kernels=use_kernels, device="cuda",
                            tol=F64_TOL)

    lv = fused_levels(build("rbgs", 4))
    rk, ck = f64_against_plain(f"B rbgs V(4,4) k={PATH_C_K}",
                               lambda uk: build("rbgs", 4, uk), 1e-8)
    i = rk.iters
    require_counts(f"B f64 k={PATH_C_K}", ck, stencil2d_rbgs=lv * i,
                   transfer2d_residual_restrict=lv * i, fused2d_up=lv * i,
                   stencil2d_residual=i + 1)
    rk, ck = f64_against_plain(f"C jacobi V(8,8) k={PATH_C_K}",
                               lambda uk: build("jacobi", 8, uk), 1e-8)
    i = rk.iters
    require_counts(f"C f64 k={PATH_C_K}", ck, stencil2d_jacobi=lv * i,
                   transfer2d_residual_restrict=lv * i, fused2d_up=lv * i,
                   stencil2d_residual=i + 1)
    saved = kernels.PACK_MIN_N
    kernels.PACK_MIN_N = F64_PACK_MIN_N
    try:
        lv = fused_levels(build("rbgs", 4))
        rk, ck = f64_against_plain(
            f"B rbgs V(4,4) k={PATH_C_K} PACK_MIN_N {F64_PACK_MIN_N}",
            lambda uk: build("rbgs", 4, uk), 1e-8, floor=F64_PACKED_FLOOR)
    finally:
        kernels.PACK_MIN_N = saved
    i = rk.iters
    require_counts(f"B f64 packed k={PATH_C_K}", ck, packed2d_rbgs=i,
                   packed2d_down=i, packed2d_up=i, packed2d_resnorm=i + 1,
                   stencil2d_rbgs=lv * i,
                   transfer2d_residual_restrict=lv * i, fused2d_up=lv * i)


def tier3(prob) -> int:
    """Levels of a 3D problem that run the stencil3d kernels."""
    from multigridcmt_tpu_torch import kernels

    return sum(lv.n >= kernels.KERNEL3_MIN_N
               for lv in prob.hierarchy.levels[:-1])


def paths_3d(runs: dict) -> None:
    import multigridcmt_tpu_torch as mt
    from multigridcmt_tpu_torch.kernels import stencil3d
    from multigridcmt_tpu_torch.ops import laplacian

    def build(k, dtype, use_kernels=True, **kw):
        return mt.poisson3d(k=k, dtype=dtype, smoother="rbgs",
                            use_kernels=use_kernels, device="cuda", **kw)

    prob = build(MAIN_K3, torch.float32)
    solver = mt.MultigridSolver(prob)
    cfg = prob.config
    sweeps = cfg.nu1 + cfg.nu2
    tier = tier3(prob)
    require(tier == 3, f"{tier} stencil3d levels at k={MAIN_K3}, not 3")
    torch.cuda.reset_peak_memory_stats()
    res, counts, wall = counted(solver.solve)
    runs["peak3d"] = torch.cuda.max_memory_allocated()
    check_solve(f"solve 3D k={MAIN_K3} float32 rbgs", prob, solver, res,
                wall, 3, runs["peak3d"])
    # Per cycle: nu1 + nu2 sweeps (one launch each) and the down leg's
    # residual on each kernel level; the solve's check once a cycle and
    # once before the first.
    i = res.iters
    require_counts("solve3d", counts,
                   stencil3d_rbgs=tier * sweeps * i,
                   stencil3d_residual=tier * i + (i + 1))
    runs["solve3d"] = counts
    runs["solve3d_result"] = (res.iters, mt.convergence_factor(res),
                              solver.discrete_l2_error(res.x).item())

    res, counts, wall = counted(lambda: solver.solve(method="pcg"))
    check_solve(f"pcg 3D k={MAIN_K3} float32 rbgs", prob, solver, res, wall,
                3)
    i = res.iters
    require_counts("pcg3d", counts,
                   stencil3d_rbgs=tier * sweeps * (i + 1),
                   stencil3d_residual=1 + i + tier * (i + 1))
    runs["pcg3d"] = counts

    # The Jacobi kernel, off the path: nu1 sweeps on the main problem's b
    # from a random start. Weighted Jacobi with omega = 6/7 damps the
    # oscillatory error that dominates such a start, so the residual must
    # fall well below its first value.
    n, h = cfg.n, cfg.h
    (x0,) = grids_on_card(n, torch.float32, MAIN_K3, 1, ndim=3)
    x, counts, _ = counted(lambda: stencil3d.jacobi_sweep(
        x0, prob.b, n, h, omega3(), sweeps=cfg.nu1))
    require_counts("jacobi3d", counts, stencil3d_jacobi=cfg.nu1)
    runs["jacobi3d"] = counts
    r0, r1 = (torch.linalg.vector_norm(laplacian.residual(v, prob.b, h))
              .item() for v in (x0, x))
    log(f"3D Jacobi x{cfg.nu1} from a random start at k={MAIN_K3}: ||r|| "
        f"{r0:.4e} -> {r1:.4e}")
    require(bool(x.isfinite().all()) and r1 < 0.9 * r0,
            f"3D Jacobi sweeps did not reduce the residual: {r0} -> {r1}")
    del prob, solver, res, x0, x

    vcycles_against_plain(
        f"float32 3D k={MAIN_K3}",
        lambda use_kernels: build(MAIN_K3, torch.float32, use_kernels),
        VCYCLE3_RTOL)
    k_solve, k_pcg = F64_K[3]
    rk, ck = f64_against_plain(
        f"solve 3D k={k_solve}", lambda use_kernels: build(
            k_solve, torch.float64, use_kernels, tol=F64_TOL), F64_TOL)
    tier = tier3(build(k_solve, torch.float64))
    i = rk.iters
    require_counts(f"f64 3D k={k_solve}", ck, stencil3d_rbgs=tier * sweeps * i,
                   stencil3d_residual=tier * i + i + 1)
    rk, ck = f64_against_plain(
        f"pcg 3D k={k_pcg}", lambda use_kernels: build(
            k_pcg, torch.float64, use_kernels, tol=F64_TOL), F64_TOL, "pcg")
    tier = tier3(build(k_pcg, torch.float64))
    i = rk.iters
    require_counts(f"pcg f64 3D k={k_pcg}", ck,
                   stencil3d_rbgs=tier * sweeps * (i + 1),
                   stencil3d_residual=1 + i + tier * (i + 1))


def paths_sparse(runs: dict) -> None:
    """The sparse path through ops/sparse.py and the two kernels' public
    functions."""
    import numpy as np

    import multigridcmt_tpu_torch as mt
    from multigridcmt_tpu_torch import grids
    from multigridcmt_tpu_torch.kernels import bell, spmv
    from multigridcmt_tpu_torch.ops import sparse

    for ndim, n, run in SPMV_SIZES:
        x = vector_on_card(n ** ndim, torch.float32, 100 + n)

        # Assemble (h = 1: see CHAIN_TOL), pack once, 20 chained applies in
        # the packed layout, unpack.
        def chain():
            a = sparse.laplacian_dia(n, ndim, 1.0, torch.float32,
                                     device="cuda")
            pk = spmv.pack_dia(a)
            yp = spmv.pack_x(x, pk.halo)
            for _ in range(SPMV_CHAIN):
                yp = spmv.spmv_packed(pk, yp)
            return a, pk, yp, spmv.unpack_y(yp, pk.n, pk.halo)

        (a, pk, yp, y), counts, wall = counted(chain)
        require_counts(run, counts, spmv_dia=SPMV_CHAIN)
        runs[run] = counts
        want = spmv.pack_x(x, pk.halo)
        for _ in range(SPMV_CHAIN):
            want = spmv.spmv_packed_plain(pk, want)
        err, rel = rel_err(yp, want)
        require_packed_zeros(run, yp, pk)
        log(f"{run}: {ndim}D n={n}, N={pk.n}, nnz={a.nnz}, halo {pk.halo} "
            f"rows, {SPMV_CHAIN} chained applies in {wall:.3f} s (assembly "
            f"included); against {SPMV_CHAIN} plain applies rel {rel:.3e} "
            f"(max |y| {want.abs().max().item():.3e})")
        require(tuple(y.shape) == (n ** ndim,) and bool(y.isfinite().all())
                and rel <= CHAIN_TOL,
                f"{run}: chained applies differ from plain by {rel:.3e} > "
                f"{CHAIN_TOL}, or bad shape/values")
        del a, pk, yp, y, want, x

        # The oracle: float64, A u = lambda_h u for u = prod sin(pi x_i).
        h = 1.0 / (n + 1)
        a = sparse.laplacian_dia(n, ndim, h, torch.float64, device="cuda")
        u = torch.ones((n,) * ndim, dtype=torch.float64, device="cuda")
        for c in grids.grid_coords(n, ndim, torch.float64, device="cuda"):
            u = u * torch.sin(math.pi * c)
        u = u.reshape(-1)
        au, counts, _ = counted(lambda: spmv.spmv_dia(a, u))
        require_counts(run + " oracle", counts, spmv_dia=1)
        lam = 4.0 / h ** 2 * ndim * math.sin(math.pi * h / 2) ** 2
        dev = ((au - lam * u).abs().max() / (lam * u.abs().max())).item()
        log(f"{run} oracle float64: max|A u - lambda_h u| / (lambda_h max|u|)"
            f" = {dev:.3e} (lambda_h = {lam:.10f})")
        require(dev <= ORACLE_TOL, f"{run} oracle: {dev:.3e} > {ORACLE_TOL}")
        del a, u, au
        torch.cuda.empty_cache()

    # as_csr/as_coo on the card, their SpMVs against the DIA kernel
    # (float64; at 4095^2 the host lexsort of 84M entries takes tens of
    # seconds, so 1023^2).
    prob = mt.poisson2d(k=10, dtype=torch.float64, device="cuda")
    n, h = prob.config.n, prob.config.h
    x = vector_on_card(n * n, torch.float64, 5)

    def api():
        solver = mt.MultigridSolver(prob)
        csr, coo = solver.as_csr(), solver.as_coo()
        dia = sparse.laplacian_dia(n, 2, h, torch.float64, device="cuda")
        return (csr, coo, sparse.spmv(csr, x), sparse.spmv_coo(coo, x),
                spmv.spmv_dia(dia, x))

    (csr, coo, ycsr, ycoo, ydia), counts, wall = counted(api)
    require_counts("sparse_api", counts, spmv_dia=1)
    nnz = 5 * n * n - 4 * n
    rels = [rel_err(yy, ydia)[1] for yy in (ycsr, ycoo)]
    log(f"as_csr/as_coo k=10 float64 on {csr.data.device}: nnz {csr.nnz}/"
        f"{coo.nnz} (5n^2-4n = {nnz}), SpMV against the DIA kernel rel "
        f"{rels[0]:.3e} (CSR) {rels[1]:.3e} (COO), wall {wall:.3f} s")
    require(csr.data.is_cuda and coo.row.is_cuda and csr.nnz == coo.nnz
            == nnz and max(rels) <= TOL[torch.float64],
            f"as_csr/as_coo: nnz {csr.nnz}/{coo.nnz} != {nnz}, or SpMV rel "
            f"{rels} > {TOL[torch.float64]}")
    del prob, x, csr, coo, ycsr, ycoo, ydia

    # The bench's BELL matrix through the public functions: SpMM of all
    # m vectors and the single-vector SpMV, against SciPy in float64.
    a_sp, xt_host = bell_bench_host()

    def bell_run():
        ab = bell.bell_from_scipy(a_sp, device="cuda")
        xt = torch.from_numpy(xt_host).cuda()
        return ab, bell.spmm(ab, xt), bell.spmv(ab, xt[0, :a_sp.shape[1]])

    (ab, yt, y), counts, wall = counted(bell_run)
    require_counts("bell", counts, bell_spmm=2)
    runs["bell"] = counts
    want = np.asarray(a_sp.astype(np.float64)
                      @ xt_host.T.astype(np.float64)).T
    got = yt.cpu().numpy()[:, :a_sp.shape[0]]
    scale = np.abs(want).max()
    rel = np.abs(got - want).max() / scale
    rel1 = np.abs(y.cpu().numpy() - want[0]).max() / scale
    log(f"bell: {BELL_BLOCKS}x{BELL_BLOCKS} blocks, {a_sp.nnz // 128 ** 2} "
        f"populated, kmax {ab.kmax}, n_stored {ab.n_stored}, nnz "
        f"{ab.nnz_scalar}, m {BELL_M}; against SciPy float64 rel {rel:.3e} "
        f"(SpMM), {rel1:.3e} (SpMV); wall {wall:.3f} s (assembly included)")
    require(tuple(yt.shape) == (BELL_M, ab.nbr * 128)
            and not yt[:, a_sp.shape[0]:].any().item()
            and max(rel, rel1) <= BELL_SCIPY_TOL,
            f"bell: rel {rel:.3e}/{rel1:.3e} > {BELL_SCIPY_TOL} or bad shape")


def sharded_mesh(shape):
    from multigridcmt_tpu_torch.parallel import sharded

    return (sharded.make_mesh() if len(shape) == 1
            else sharded.make_block_mesh(shape))


def sharded_levels(prob, solver) -> tuple:
    """(whole-leg levels, owned-tile levels on the local2d kernels) of a
    sharded problem, from the solver's own routing predicates."""
    from multigridcmt_tpu_torch import kernels
    from multigridcmt_tpu_torch.parallel import sharded

    cfg, dec = prob.config, solver.decomp
    legs = sum(sharded._leg_level_ok(cfg, dec, lv)
               for lv in range(len(prob.hierarchy.levels)))
    owned = sum(sharded._is_sharded(cfg, dec, lv)
                and not sharded._leg_level_ok(cfg, dec, lv)
                and prob.hierarchy.levels[lv].n >= kernels.KERNEL_MIN_N
                for lv in range(len(prob.hierarchy.levels)))
    return legs, owned


def sharded_against_single(label: str, res, ref) -> None:
    """A float64 sharded solve against the single-device one: both
    converge in equal iterations, with histories within rtol 1e-8 down to
    SHARDED_F64_FLOOR (the two routes round differently: restriction and
    neighbour sums in other orders, by ~3e-14 of |b| near the end of the
    solve, which is 3e-5 of a relative residual of ~1e-9)."""
    hs, hr = (r.res_history[: r.iters + 1] for r in (res, ref))
    same = res.iters == ref.iters
    diff = ((hs - hr).abs() / hr).max().item() if same else float("inf")
    over = ((hs - hr).abs() - 1e-8 * hr).max().item() if same \
        else float("inf")
    log(f"{label}: iters {res.iters} (single device {ref.iters}), converged "
        f"{res.converged}, history rel diff {diff:.2e}, past rtol 1e-8 by at "
        f"most {over:.2e} (floor {SHARDED_F64_FLOOR})")
    require(res.converged and ref.converged and same
            and over <= SHARDED_F64_FLOOR,
            f"{label} against single device: iters {res.iters}/{ref.iters}, "
            f"rel {diff}, over {over}")


def paths_sharded(runs: dict) -> None:
    """S1-S4 through ShardedSolver.solve on a mesh of 1 (the world of 1
    over NCCL that phase 1 made): S1 at the default PACK_MIN_N (its 4095
    level colour-packed on plocal2d) by cycles and by PCG (S1pcg) beside
    the single-device solve, S1 again with PACK_MIN_N above 4095 (the
    unpacked route, S1unpacked), S2-S4; and float64 sharded solves against
    single-device ones, unpacked and packed."""
    import multigridcmt_tpu_torch as mt
    from multigridcmt_tpu_torch import kernels
    from multigridcmt_tpu_torch.parallel import sharded

    def build(label, dtype=torch.float32, **kw):
        k, shape, cfg = SHARDED_PATHS[label]
        prob = mt.poisson2d(k=k, dtype=dtype, use_kernels=True,
                            device="cuda", **cfg, **kw)
        return prob, sharded.ShardedSolver(prob.config, sharded_mesh(shape))

    def describe(label, prob, solver, method="mg"):
        cfg = prob.config
        return (f"{label}: sharded {method} k={cfg.k} float32 {cfg.smoother} "
                f"V({cfg.nu1},{cfg.nu2}) mesh {solver.mesh.shape}")

    # S1 on the packed route: the 4095 level runs the plocal2d legs and the
    # fused norm (the check: full before the first cycle, red only after
    # each), levels 2047..255 the local2d legs; PCG adds its first residual
    # and one operator apply an iteration on plocal2d, and runs one cycle
    # from the start and one an iteration.
    prob, solver = build("S1")
    legs, owned = sharded_levels(prob, solver)
    packs = sharded._pack_level_ok(prob.config, solver.decomp, 0)
    require(packs and (legs, owned) == (5, 0),
            f"S1: packed {packs}, {legs} leg and {owned} owned kernel "
            "levels, not True, 5 and 0")
    single = mt.MultigridSolver(prob)
    torch.cuda.reset_peak_memory_stats()
    res, counts, wall = counted(lambda: solver.solve(prob.b))
    runs["peakS1"] = torch.cuda.max_memory_allocated()
    check_solve(describe("S1", prob, solver) + " (packed)", prob, single,
                res, wall, 2, runs["peakS1"], PACKED_MAXERR)
    i = res.iters
    require_counts("S1", counts, plocal2d_down=i, plocal2d_up=i,
                   plocal2d_resnorm=i + 1, local2d_down=(legs - 1) * i,
                   local2d_up=(legs - 1) * i)
    runs["S1"] = counts
    runs["S1_result"] = (res.iters, mt.convergence_factor(res),
                         (res.x - prob.u_exact).abs().max().item())
    # Beside it, the single-device solve on the same packed route.
    ref, _, ref_wall = counted(single.solve)
    check_solve(f"S1's single-device twin: k={prob.config.k} float32, "
                f"PACK_MIN_N {kernels.PACK_MIN_N}", prob, single, ref,
                ref_wall, 2, bound=PACKED_MAXERR)
    res, counts, wall = counted(lambda: solver.solve(prob.b, method="pcg"))
    check_solve(describe("S1pcg", prob, solver, "pcg") + " (packed)", prob,
                single, res, wall, 2, None, PACKED_MAXERR)
    c = res.iters + 1                          # preconditioning cycles
    require_counts("S1pcg", counts, plocal2d_residual=1,
                   plocal2d_apply=res.iters, plocal2d_down=c, plocal2d_up=c,
                   local2d_down=(legs - 1) * c, local2d_up=(legs - 1) * c)
    runs["S1pcg"] = counts
    del prob, solver, single, res, ref
    torch.cuda.empty_cache()

    saved = kernels.PACK_MIN_N
    kernels.PACK_MIN_N = 2 ** MAIN_K
    log(f"S1unpacked: kernels.PACK_MIN_N set to {kernels.PACK_MIN_N} for "
        "this run only, so that the 4095 level takes the unpacked route (the "
        "local2d legs and the local2d residual as the check): the packing "
        "comparison")
    try:
        for label in ("S1unpacked", "S2", "S3", "S4", "S4cheb"):
            prob, solver = build("S1" if label == "S1unpacked" else label)
            legs, owned = sharded_levels(prob, solver)
            res, counts, wall = counted(lambda: solver.solve(prob.b))
            cfg = prob.config
            check_solve(describe(label, prob, solver), prob,
                        mt.MultigridSolver(prob), res, wall, 2, None,
                        SHARDED_MAXERR)
            i = res.iters
            checks = i + 1
            # Per cycle: one down and one up leg a leg level (S1 4095..255,
            # S2 2047..255); on the composed route two sweep launches (pre
            # and post) and one residual an owned kernel level, Chebyshev
            # nu1 + nu2 + 1 residuals there; the check is the residual.
            want = {"S1unpacked": dict(local2d_down=legs * i,
                                       local2d_up=legs * i,
                                       local2d_residual=checks),
                    "S2": dict(local2d_down=legs * i, local2d_up=legs * i,
                               local2d_residual=checks),
                    "S3": dict(local2d_rbgs=2 * owned * i,
                               local2d_residual=owned * i + checks),
                    "S4": dict(local2d_jacobi=2 * owned * i,
                               local2d_residual=owned * i + checks),
                    "S4cheb": dict(local2d_residual=(cfg.nu1 + cfg.nu2 + 1)
                                   * owned * i + checks)}[label]
            expect = {"S1unpacked": (5, 0), "S2": (4, 0), "S3": (0, 4),
                      "S4": (0, 3), "S4cheb": (0, 3)}[label]
            require((legs, owned) == expect,
                    f"{label}: {legs} leg and {owned} owned kernel levels, "
                    f"not {expect}")
            require_counts(label, counts, **want)
            runs[label] = counts
            del prob, solver, res
            torch.cuda.empty_cache()
    finally:
        kernels.PACK_MIN_N = saved

    # float64 at k=10, unpacked (the default PACK_MIN_N): the sharded solve
    # (local2d legs on 1023..255, the owned-tile route on 127 and 63)
    # against the single-device one (fused2d legs).
    prob = mt.poisson2d(k=SHARDED_F64_K, dtype=torch.float64,
                        smoother="rbgs", use_kernels=True, tol=F64_TOL,
                        device="cuda")
    solver = sharded.ShardedSolver(prob.config, sharded_mesh((1,)))
    res, counts, _ = counted(lambda: solver.solve(prob.b))
    ref = mt.MultigridSolver(prob).solve()
    legs, _ = sharded_levels(prob, solver)
    sharded_against_single(f"sharded float64 k={SHARDED_F64_K}", res, ref)
    err64 = (res.x - prob.u_exact).abs().max().item()
    log(f"  max error vs u_exact {err64:.3e}")
    require_counts("sharded f64", counts, local2d_down=legs * res.iters,
                   local2d_up=legs * res.iters,
                   local2d_residual=res.iters + 1)
    del solver, res, ref

    # float64 at k=10 on the packed route (PACK_MIN_N lowered so that 1023
    # packs, for this check only): the sharded solve and sharded PCG
    # against the single-device packed solve and PCG.
    kernels.PACK_MIN_N = SHARDED_F64_PACK_MIN_N
    try:
        solver = sharded.ShardedSolver(prob.config, sharded_mesh((1,)))
        require(sharded._pack_level_ok(prob.config, solver.decomp, 0),
                f"k={SHARDED_F64_K} does not pack at PACK_MIN_N "
                f"{kernels.PACK_MIN_N}")
        for method in ("mg", "pcg"):
            res, counts, _ = counted(
                lambda: solver.solve(prob.b, method=method))
            ref = mt.MultigridSolver(prob).solve(method=method)
            sharded_against_single(
                f"sharded packed float64 {method} k={SHARDED_F64_K}, "
                f"PACK_MIN_N {kernels.PACK_MIN_N}", res, ref)
            i = res.iters
            want = (dict(plocal2d_down=i, plocal2d_up=i,
                         plocal2d_resnorm=i + 1,
                         local2d_down=(legs - 1) * i,
                         local2d_up=(legs - 1) * i) if method == "mg" else
                    dict(plocal2d_residual=1, plocal2d_apply=i,
                         plocal2d_down=i + 1, plocal2d_up=i + 1,
                         local2d_down=(legs - 1) * (i + 1),
                         local2d_up=(legs - 1) * (i + 1)))
            require_counts(f"sharded packed f64 {method}", counts, **want)
            del res, ref
    finally:
        kernels.PACK_MIN_N = saved
    del prob, solver
    torch.cuda.empty_cache()

    # float64 at k=10 on the composed routes: S3's RB-GS V(4,4) and S4's
    # Jacobi V(8,8), whose sharded solve smooths 1023..255 with the local2d
    # sweeps (beside the local2d residual), against the single-device solve
    # of the same problem (paths B's and C's composed route: the stencil2d
    # sweeps and the transfer2d kernels).
    for label, counter in (("S3", "local2d_rbgs"), ("S4", "local2d_jacobi")):
        prob = mt.poisson2d(k=SHARDED_F64_K, dtype=torch.float64,
                            use_kernels=True, tol=F64_TOL, device="cuda",
                            **SHARDED_PATHS[label][2])
        solver = sharded.ShardedSolver(prob.config, sharded_mesh((1,)))
        legs, owned = sharded_levels(prob, solver)
        require((legs, owned) == (0, 3),
                f"{label} float64 k={SHARDED_F64_K}: {legs} leg and {owned} "
                "owned kernel levels, not 0 and 3")
        res, counts, _ = counted(lambda: solver.solve(prob.b))
        ref = mt.MultigridSolver(prob).solve()
        cfg = prob.config
        sharded_against_single(
            f"sharded float64 {label} route k={SHARDED_F64_K} {cfg.smoother} "
            f"V({cfg.nu1},{cfg.nu2})", res, ref)
        i = res.iters
        require_counts(f"sharded f64 {label}", counts,
                       **{counter: 2 * owned * i},
                       local2d_residual=owned * i + i + 1)
        del prob, solver, res, ref
        torch.cuda.empty_cache()


def paths_mixed_sharded(runs: dict) -> None:
    """Sharded MG-PCG with precond_dtype=torch.bfloat16 through
    ShardedSolver.solve(method="pcg") on a mesh of 1, at MIXED_SHARDED's
    paths beside the float32 PCG of the same mesh: converged, in at most
    ceil(MIXED_ITER_FACTOR x its iterations) + 1, max error against u_exact
    under the path's bound, with exact launches (each preconditioning
    cycle: the fine level's bfloat16 down leg and float32-out up leg, the
    float32 local2d legs below; CG's residual and apply at float32, as
    S1pcg's and the unpacked route's); a float64 k=SHARDED_F64_K mixed
    sharded PCG within the same gate and MIXED_SHARDED_RTOL/ATOL of the
    full-dtype one; and one direct call of each bfloat16-storing up leg,
    which no solver runs."""
    import multigridcmt_tpu_torch as mt
    from multigridcmt_tpu_torch import kernels
    from multigridcmt_tpu_torch.kernels import local2d, plocal2d
    from multigridcmt_tpu_torch.parallel import sharded

    bf = torch.bfloat16

    def build(path, dtype, pd, **kw):
        k, shape, cfg = SHARDED_PATHS[path]
        prob = mt.poisson2d(k=k, dtype=dtype, use_kernels=True,
                            device="cuda", precond_dtype=pd, **cfg, **kw)
        return prob, sharded.ShardedSolver(prob.config, sharded_mesh(shape))

    def want_counts(packed, legs, i):
        # c preconditioning cycles; the residual once and the apply an
        # iteration (-residual(p, 0) unpacked, apply_op packed).
        c = i + 1
        fine = "plocal2d" if packed else "local2d"
        want = {f"{fine}_down_bf16": c, f"{fine}_up_bf16_f32": c,
                "local2d_down": (legs - 1) * c, "local2d_up": (legs - 1) * c}
        if packed:
            want.update(plocal2d_residual=1, plocal2d_apply=i)
        else:
            want.update(local2d_residual=1 + i)
        return want

    saved = kernels.PACK_MIN_N
    try:
        for label, (path, pack_min_n, bound) in MIXED_SHARDED.items():
            kernels.PACK_MIN_N = saved if pack_min_n is None else pack_min_n
            prob, solver = build(path, torch.float32, None)
            full, _, full_wall = counted(
                lambda: solver.solve(prob.b, method="pcg"))
            prob, solver = build(path, torch.float32, bf)
            cfg, dec = prob.config, solver.decomp
            packed = sharded._pack_level_ok(cfg, dec, 0)
            legs, owned = sharded_levels(prob, solver)
            expect = (label == "S1mixed", 5 if path == "S1" else 4)
            require(sharded.mixed_leg_dtype(cfg, dec) == bf
                    and (packed, legs) == expect and owned == 0,
                    f"{label}: cast {sharded.mixed_leg_dtype(cfg, dec)}, "
                    f"packed {packed}, {legs} leg and {owned} owned kernel "
                    f"levels, not {bf}, {expect} and 0")
            torch.cuda.reset_peak_memory_stats()
            res, counts, wall = counted(
                lambda: solver.solve(prob.b, method="pcg"))
            runs[f"peak_{label}"] = torch.cuda.max_memory_allocated()
            check_solve(f"{label}: sharded mixed pcg k={cfg.k} float32, "
                        f"precond bfloat16, mesh {solver.mesh.shape}, "
                        f"PACK_MIN_N {kernels.PACK_MIN_N}", prob,
                        mt.MultigridSolver(prob), res, wall, 2,
                        runs[f"peak_{label}"], bound)
            gate = math.ceil(MIXED_ITER_FACTOR * full.iters) + 1
            full_err = (full.x - prob.u_exact).abs().max().item()
            log(f"  float32 sharded pcg on the same mesh: {full.iters} "
                f"iterations, converged {full.converged}, max error vs "
                f"u_exact {full_err:.4e}, wall {full_wall:.3f} s; gate "
                f"{gate}")
            require(full.converged and res.converged and res.iters <= gate
                    and full_err < bound,
                    f"{label}: mixed pcg {res.iters} iterations (converged "
                    f"{res.converged}) against float32's {full.iters} "
                    f"(converged {full.converged}, max error {full_err:.3e}):"
                    f" gate {gate}, bound {bound}")
            require_counts(label, counts, **want_counts(packed, legs,
                                                        res.iters))
            runs[label] = counts
            runs[f"{label}_walls"] = {
                "float32_s": full_wall, "mixed_s": wall,
                "float32_iters": full.iters, "mixed_iters": res.iters,
                "float32_maxerr": full_err,
                "mixed_maxerr": (res.x - prob.u_exact).abs().max().item()}
            del prob, solver, res, full
            torch.cuda.empty_cache()
    finally:
        kernels.PACK_MIN_N = saved

    # float64 at k=10 on a row mesh (the default PACK_MIN_N: 1023 on the
    # local2d legs' bfloat16 modes), against the full-dtype sharded PCG.
    out = {}
    for pd in (None, bf):
        prob = mt.poisson2d(k=SHARDED_F64_K, dtype=torch.float64,
                            smoother="rbgs", use_kernels=True, tol=F64_TOL,
                            device="cuda", precond_dtype=pd)
        solver = sharded.ShardedSolver(prob.config, sharded_mesh((1,)))
        out[pd] = counted(lambda: solver.solve(prob.b, method="pcg"))
    (full, _, _), (res, counts, _) = out[None], out[bf]
    legs, _ = sharded_levels(prob, solver)
    gate = math.ceil(MIXED_ITER_FACTOR * full.iters) + 1
    diff = (res.x - full.x).abs()
    over = (diff - MIXED_SHARDED_RTOL * full.x.abs()).max().item()
    log(f"sharded mixed float64 k={SHARDED_F64_K}: {res.iters} iterations "
        f"(full dtype {full.iters}, gate {gate}), converged {res.converged}; "
        f"x against the full-dtype x: max abs {diff.max().item():.3e}, past "
        f"rtol {MIXED_SHARDED_RTOL} by {over:.3e} (atol "
        f"{MIXED_SHARDED_ATOL})")
    require(full.converged and res.converged and res.iters <= gate
            and over <= MIXED_SHARDED_ATOL,
            f"sharded mixed float64: {res.iters}/{res.converged} against "
            f"{full.iters}/{full.converged}, gate {gate}; x past rtol by "
            f"{over:.3e} > {MIXED_SHARDED_ATOL}")
    require_counts("sharded mixed f64", counts,
                   **want_counts(False, legs, res.iters))
    runs["sharded_mixed_f64"] = counts
    del prob, solver, out, full, res

    # The bfloat16-storing up legs (the TPU kernels' own mode): direct calls.
    n = 2 ** MAIN_K - 1
    ue, be, e, t = local2d_tile(n, torch.float32, seed=61)
    ue, be = ue.to(bf), be.to(bf)
    args = (n, (n - 1) // 2, 1.0 / (n + 1), t["m"], t["row_off"])
    kw = dict(kind="rbgs", omega=1.0, sweeps=2)
    _, counts, _ = counted(lambda: (
        local2d.up_leg(ue, e, be, *args, **kw),
        plocal2d.up_leg(plocal2d.pack_ext(ue, 0), e, plocal2d.pack_ext(be, 0),
                        *args, **kw)))
    require_counts("sharded bf16 up legs direct", counts, local2d_up_bf16=1,
                   plocal2d_up_bf16=1)
    runs["sharded_up_bf16_direct"] = counts
    del ue, be, e
    torch.cuda.empty_cache()


def fmg_walk_crossings(prob) -> int:
    """fused2d launches of each leg in one FMG walk: the V-cycle started at
    level l crosses the fused2d levels l...L-2."""
    from multigridcmt_tpu_torch import kernels

    fused = [kernels.KERNEL_MIN_N <= lv.n < kernels.PACK_MIN_N
             for lv in prob.hierarchy.levels[:-1]]
    return sum(sum(fused[lv:]) for lv in range(len(fused)))


def sharded_walk_crossings(prob, solver) -> int:
    """local2d launches of each leg in one sharded FMG walk: the cycle
    started at a whole-leg level l runs the legs of the whole-leg levels
    from l down to the first that is not one."""
    from multigridcmt_tpu_torch.parallel import sharded

    cfg, dec = prob.config, solver.decomp
    total = 0
    for start in range(len(prob.hierarchy.levels) - 1):
        lv = start
        while sharded._leg_level_ok(cfg, dec, lv):
            total += 1
            lv += 1
    return total


def fmg_gates(walk: str, out: dict, h: float) -> None:
    """Config 3's gates on one walk: out[(dtype, use_kernels)] = (x,
    discrete-L2 error)."""
    (x64k, e64k), (x64p, e64p) = (out[(torch.float64, u)]
                                  for u in (True, False))
    diff = (x64k - x64p).abs().max().item() / x64p.abs().max().item()
    log(f"fmg1023 {walk} float64: l2 error {e64k:.6e} (kernel), {e64p:.6e} "
        f"(plain), {e64k / h ** 2:.4f} h^2; kernel vs plain max rel "
        f"{diff:.2e}")
    require(e64k < FMG_L2_FACTOR * h * h,
            f"fmg1023 {walk} float64 l2 error {e64k:.3e} >= "
            f"{FMG_L2_FACTOR} h^2")
    require(diff <= FMG_ROUTE_RTOL, f"fmg1023 {walk} float64 kernel vs plain "
            f"{diff:.3e} > {FMG_ROUTE_RTOL}")
    e32k, e32p = (out[(torch.float32, u)][1] for u in (True, False))
    log(f"fmg1023 {walk} float32: l2 error {e32k:.6e} (kernel), {e32p:.6e} "
        "(plain)")
    require(e32k <= FMG_F32_FACTOR * e32p,
            f"fmg1023 {walk} float32 l2 error {e32k:.3e} > "
            f"{FMG_F32_FACTOR} x the plain route's {e32p:.3e}")


def paths_fmg(runs: dict) -> None:
    """Config 3: MultigridSolver.fmg at 1023^2 (float64 and float32, linear
    and cubic walks, kernel and plain routes) with its error gates and
    exact launches, the error ratio over FMG_RATIO_K; solve(cycle="fmg")
    at 4095^2 float32 on the main path's route (fmg4095)."""
    import multigridcmt_tpu_torch as mt

    def build(k, dtype, use_kernels=True, **kw):
        return mt.poisson2d(k=k, dtype=dtype, smoother="rbgs",
                            use_kernels=use_kernels, device="cuda", **kw)

    for walk in ("linear", "cubic"):
        out = {}
        for dtype in (torch.float64, torch.float32):
            for use_kernels in (True, False):
                prob = build(FMG_K, dtype, use_kernels, fmg_prolong=walk)
                solver = mt.MultigridSolver(prob)
                torch.cuda.reset_peak_memory_stats()
                x, counts, wall = counted(solver.fmg)
                peak = torch.cuda.max_memory_allocated()
                err = solver.discrete_l2_error(x).item()
                require(tuple(x.shape) == tuple(prob.b.shape)
                        and bool(x.isfinite().all()) and ghosts_zero(x),
                        f"fmg1023 {walk}: bad shape, values or ghosts")
                label = (f"fmg1023 {walk} {str(dtype).split('.')[-1]} "
                         f"{'kernel' if use_kernels else 'plain'}")
                log(f"{label}: l2 error {err:.6e}, wall {wall:.3f} s, peak "
                    f"memory {peak / 2**20:.1f} MiB")
                # One FMG pass: each V-cycle of the walk crosses the fused2d
                # levels at and below its start (k=10: 1023, 511, 255, so
                # 3 + 2 + 1); b's restriction and the walk's prolongation
                # are the plain transfers on unpacked levels, and nothing
                # checks a residual.
                want = ({} if not use_kernels else dict(
                    fused2d_down=fmg_walk_crossings(prob),
                    fused2d_up=fmg_walk_crossings(prob)))
                require_counts(label, counts, **want)
                if use_kernels and dtype == torch.float32 \
                        and walk == "linear":
                    runs["fmg1023"] = counts
                    runs["peak_fmg1023"] = peak
                runs.setdefault("fmg1023_err", {})[
                    (walk, dtype, use_kernels)] = err
                out[(dtype, use_kernels)] = (x, err)
                del prob, solver
        fmg_gates(walk, out, 1.0 / 2 ** FMG_K)
        errs = []
        for k in FMG_RATIO_K:
            if k == FMG_K:
                errs.append(out[(torch.float64, True)][1])
                continue
            solver = mt.MultigridSolver(build(k, torch.float64,
                                              fmg_prolong=walk))
            errs.append(solver.discrete_l2_error(solver.fmg()).item())
        ratios = [a / b for a, b in zip(errs, errs[1:])]
        log(f"fmg {walk} float64 l2 errors at k={FMG_RATIO_K}: "
            f"{[f'{e:.6e}' for e in errs]}, ratios "
            f"{[f'{r:.4f}' for r in ratios]}")
        require(all(FMG_RATIO[0] < r < FMG_RATIO[1] for r in ratios),
                f"fmg {walk} error ratios {ratios} outside {FMG_RATIO}")
        del out
    torch.cuda.empty_cache()

    # fmg4095: one FMG pass, then V-cycles to tol (the stall guard ends
    # them at float32's floor). b's restriction from the packed 4095 level
    # and the walk's prolongation onto it are zero-sweep packed legs; the
    # walk's cycle at 4095 one packed leg each and the fused2d legs at
    # 2047...255; then each polishing cycle one packed and four fused2d
    # legs each, and the fused norm once before the first and once a
    # cycle.
    prob = build(MAIN_K, torch.float32, cycle="fmg")
    solver = mt.MultigridSolver(prob)
    torch.cuda.reset_peak_memory_stats()
    res, counts, wall = counted(solver.solve)
    runs["peak_fmg4095"] = torch.cuda.max_memory_allocated()
    x = res.x
    maxerr = (x - prob.u_exact).abs().max().item()
    hist = res.res_history[: res.iters + 1].tolist()
    x2d = runs["x2d"]
    err2d = (x2d - prob.u_exact).abs().max().item()
    diff = (x - x2d).abs().max().item()
    log(f"fmg4095: solve(cycle='fmg') k={MAIN_K} float32: {res.iters} "
        f"polishing cycles, converged {res.converged}, history "
        f"{[f'{v:.3e}' for v in hist]}, max error vs u_exact {maxerr:.4e}, "
        f"l2 error {solver.discrete_l2_error(x).item():.4e}, wall {wall:.3f} "
        f"s, peak memory {runs['peak_fmg4095'] / 2**20:.1f} MiB; against the "
        f"V-cycle solve (solve2d, max error {err2d:.4e}): max abs {diff:.4e}")
    require(tuple(x.shape) == tuple(prob.b.shape)
            and bool(x.isfinite().all()) and maxerr < MAXERR[2],
            f"fmg4095: bad solution or max error {maxerr:.3e} >= "
            f"{MAXERR[2]}")
    # The V-cycle solve from zero stalls at float32's floor 3.3e-3 from
    # u_exact (PACKED_MAXERR bounds that route's error), FMG's iterate far
    # closer (7.4e-4 on an H100): the two differ by about the former.
    require(diff < PACKED_MAXERR,
            f"fmg4095 against solve2d: {diff:.3e} >= the packed route's "
            f"float32 error bound {PACKED_MAXERR}")
    i, walk = res.iters, fmg_walk_crossings(prob)
    require_counts("fmg4095", counts, packed2d_down=2 + i,
                   packed2d_up=2 + i, packed2d_resnorm=i + 1,
                   fused2d_down=walk + 4 * i, fused2d_up=walk + 4 * i)
    runs["fmg4095"] = counts
    runs["x_fmg4095"] = (x, maxerr)
    del prob, solver, res, x
    torch.cuda.empty_cache()


def paths_eigen(runs: dict) -> None:
    """Config 4: MultigridSolver.eigensolve(k=1) at 511^2 float64 by
    inverse iteration, RQI and LOBPCG on the kernel and the plain routes,
    against the exact discrete eigenvalue, and LOBPCG k=3 against the
    exact spectrum, each with launches as a multiple of its cycles."""
    import multigridcmt_tpu_torch as mt
    from multigridcmt_tpu_torch.ops import laplacian
    from multigridcmt_tpu_torch.utils.profiling import count_cycles

    def build(use_kernels):
        return mt.poisson2d(k=EIGEN_K, dtype=torch.float64, smoother="rbgs",
                            use_kernels=use_kernels, device="cuda")

    n = 2 ** EIGEN_K - 1
    h = 1.0 / (n + 1)
    exact = 2 * laplacian.eigenvalue_1d(1, n, h)
    spectrum = sorted(laplacian.eigenvalue_2d(a, b, n, h)
                      for a, b in ((1, 1), (1, 2), (2, 1)))
    fused = fused_levels(build(True))
    cases = [(m, 1, u) for m in EIGEN_METHODS for u in (True, False)]
    cases.append(("lobpcg", EIGEN_BLOCK, True))
    lam = {}
    for method, k, use_kernels in cases:
        prob = build(use_kernels)
        solver = mt.MultigridSolver(prob)
        torch.cuda.reset_peak_memory_stats()
        with count_cycles() as cyc:
            res, counts, wall = counted(
                lambda: solver.eigensolve(k=k, method=method))
        peak = torch.cuda.max_memory_allocated()
        vals = res.eigenvalues.tolist()
        want = [exact] if k == 1 else spectrum
        rel = max(abs(v - w) / w for v, w in zip(vals, want))
        route = "kernel" if use_kernels else "plain"
        label = f"eigen511 {method} k={k} {route}"
        log(f"{label}: {res.iters} outer steps, {cyc.count} cycles, "
            f"converged {res.converged}, eigenvalues "
            f"{[f'{v:.12f}' for v in vals]}, rel error vs exact {rel:.2e}, "
            f"final residual {res.res_history[res.iters].item():.3e}, wall "
            f"{wall:.3f} s, peak memory {peak / 2**20:.1f} MiB")
        require(res.converged and rel < EIGEN_RTOL,
                f"{label}: converged {res.converged}, rel error {rel:.3e}")
        require(tuple(res.eigenvectors.shape) == (k,) + tuple(prob.b.shape)
                and bool(res.eigenvectors.isfinite().all()),
                f"{label}: bad eigenvectors")
        c = cyc.count
        if not use_kernels:
            require_counts(label, counts)
        elif method == "lobpcg":
            # One preconditioning V-cycle a block vector a step, iteration
            # 0 included; each crosses the fused2d levels 511 and 255.
            require(c == k * res.iters,
                    f"{label}: {c} cycles, not {k} x {res.iters}")
            require_counts(label, counts, fused2d_down=fused * c,
                           fused2d_up=fused * c)
        else:
            # Each inner cycle: the fused2d legs at 511 and 255, and the
            # inner solve's check, the stencil2d residual at 511.
            require_counts(label, counts, fused2d_down=fused * c,
                           fused2d_up=fused * c, stencil2d_residual=c)
        if use_kernels and k == 1:
            runs[f"eigen511_{method}"] = counts
            runs[f"peak_eigen511_{method}"] = peak
        lam[(method, k, use_kernels)] = vals
        if k == 1:
            runs[f"eigen511_{method}_{route}_run"] = (
                res.res_history[: res.iters + 1].tolist(), vals[0])
        del prob, solver, res
    for method in EIGEN_METHODS:
        lk, lp = lam[(method, 1, True)][0], lam[(method, 1, False)][0]
        rel = abs(lk - lp) / lp
        log(f"eigen511 {method}: kernel vs plain eigenvalue rel {rel:.2e}")
        require(rel <= EIGEN_ROUTE_RTOL, f"eigen511 {method} kernel vs "
                f"plain {rel:.3e} > {EIGEN_ROUTE_RTOL}")
    torch.cuda.empty_cache()


def paths_mixed(runs: dict) -> None:
    """Mixed precision on the packed 2D tier: MG-PCG at 4095^2 float32 with
    precond_dtype=torch.bfloat16 on each MIXED_ROUTES route beside the
    float32 PCG on the same route, with exact launches (the packed level's
    bfloat16 kernels in each preconditioning cycle, no float32 packed leg
    there, the float32 packed residual as CG's residual and apply), and
    MultigridSolver.eigensolve(k=1) at 4095^2 float64 by LOBPCG and II
    with a bfloat16 preconditioner against the full-precision runs; and one
    direct call of the bfloat16-storing up leg, which no solver runs."""
    import multigridcmt_tpu_torch as mt
    from multigridcmt_tpu_torch.kernels import packed2d
    from multigridcmt_tpu_torch.utils.profiling import count_cycles

    def build(dtype, pd=None, **kw):
        return mt.poisson2d(k=MAIN_K, dtype=dtype, use_kernels=True,
                            device="cuda", precond_dtype=pd, **kw)

    for name, kw in MIXED_ROUTES.items():
        full = mt.MultigridSolver(build(torch.float32, **kw)).solve(
            method="pcg")
        prob = build(torch.float32, torch.bfloat16, **kw)
        solver = mt.MultigridSolver(prob)
        torch.cuda.reset_peak_memory_stats()
        res, counts, wall = counted(lambda: solver.solve(method="pcg"))
        runs[f"peak_{name}"] = torch.cuda.max_memory_allocated()
        check_solve(f"{name}: mixed pcg k={MAIN_K} float32 {kw}", prob,
                    solver, res, wall, 2, runs[f"peak_{name}"])
        bound = math.ceil(MIXED_ITER_FACTOR * full.iters) + 1
        log(f"  float32 pcg on the same route: {full.iters} iterations, "
            f"converged {full.converged}; bound {bound}")
        require(full.converged and res.converged and res.iters <= bound,
                f"{name}: mixed pcg {res.iters} iterations (converged "
                f"{res.converged}) against float32's {full.iters}: bound "
                f"{bound}")
        i, lv = res.iters, fused_levels(prob)
        c = i + 1                           # preconditioning cycles
        if name == "mixed2d":
            # The fused legs: a bfloat16 down leg and a bfloat16-in,
            # float32-out up leg on 4095, the fused2d legs below.
            require_counts(name, counts, packed2d_residual=1 + i,
                           packed2d_down_bf16=c, packed2d_up_bf16_f32=c,
                           fused2d_down=lv * c, fused2d_up=lv * c)
        elif name == "mixedB":
            # The pre-smooth is one 4-sweep bfloat16 sweep and the
            # zero-sweep bfloat16 down leg; the up leg fuses (float32 out).
            require_counts(name, counts, packed2d_residual=1 + i,
                           packed2d_rbgs_bf16=c, packed2d_down_bf16=c,
                           packed2d_up_bf16_f32=c, stencil2d_rbgs=lv * c,
                           transfer2d_residual_restrict=lv * c,
                           fused2d_up=lv * c)
        else:
            # Chebyshev: nu1 bfloat16 residual applies, the zero-sweep
            # bfloat16 down leg and float32-out up leg, then nu2 float32
            # residual applies on the widened level.
            cfg = prob.config
            require_counts(name, counts,
                           packed2d_residual=1 + i + cfg.nu2 * c,
                           packed2d_residual_bf16=cfg.nu1 * c,
                           packed2d_residual_bf16_pairs=cfg.nu1 * c,
                           packed2d_down_bf16=c, packed2d_up_bf16_f32=c,
                           stencil2d_residual=lv * (cfg.nu1 + cfg.nu2) * c,
                           transfer2d_residual_restrict=lv * c,
                           transfer2d_prolong_add=lv * c)
        runs[name] = counts
        del full, prob, solver, res
        torch.cuda.empty_cache()

    for method in MIXED_EIGEN:
        out = {}
        for pd in (None, torch.bfloat16):
            prob = build(torch.float64, pd, smoother="rbgs")
            solver = mt.MultigridSolver(prob)
            with count_cycles() as cyc:
                res, counts, wall = counted(
                    lambda: solver.eigensolve(k=1, method=method))
            label = (f"mixed eigen{2 ** MAIN_K - 1} {method} float64 "
                     f"precond_dtype={pd}")
            lam = res.eigenvalues[0].item()
            log(f"{label}: {res.iters} outer steps, {cyc.count} cycles, "
                f"converged {res.converged}, lambda_1 {lam:.12f}, final "
                f"residual {res.res_history[res.iters].item():.3e}, wall "
                f"{wall:.3f} s")
            require(res.converged and bool(res.eigenvectors.isfinite().all()),
                    f"{label}: converged {res.converged}")
            out[pd] = (lam, res.iters, cyc.count, counts, wall)
            del prob, solver, res
        (lf, sf, *_), (lm, sm, c, counts, _) = out[None], out[torch.bfloat16]
        runs.setdefault("eigen4095_lambda", {})[method] = lf
        rel = abs(lm - lf) / lf
        log(f"mixed eigen {method}: lambda_1 bfloat16-preconditioned vs "
            f"full rel {rel:.2e}; steps {sm} against {sf}")
        require(rel <= MIXED_EIGEN_RTOL, f"mixed eigen {method}: lambda_1 "
                f"{rel:.3e} from the full run's > {MIXED_EIGEN_RTOL}")
        lv = fused_levels(build(torch.float64))
        # Each bfloat16 cycle: the bfloat16 down leg and float32-out up leg
        # on 4095, the fused2d legs below; II's inner check (and its
        # refinement's defect) is the float64 packed residual, once a cycle.
        require_counts(f"mixed_{method}", counts, packed2d_down_bf16=c,
                       packed2d_up_bf16_f32=c, fused2d_down=lv * c,
                       fused2d_up=lv * c,
                       packed2d_residual=c if method == "ii" else 0)
        runs[f"mixed_{method}"] = counts
        runs[f"mixed_{method}_walls"] = (out[None][4], out[torch.bfloat16][4])
        torch.cuda.empty_cache()

    # The bfloat16-storing up leg (the TPU kernel's own mode): direct calls.
    n = 2 ** MAIN_K - 1
    su, sb, e, _ = bf16_inputs(n, seed=31)
    _, counts, _ = counted(lambda: packed2d.prolong_add_smooth(
        su, e, sb, n, (n - 1) // 2, 1.0 / (n + 1), kind="rbgs", omega=1.0,
        sweeps=2))
    require_counts("packed2d_up_bf16 direct", counts, packed2d_up_bf16=1)
    runs["up_bf16_direct"] = counts
    del su, sb, e


def paths_cdt_bf16(runs: dict) -> None:
    """Direct calls (cdt_bf16_direct) of the _cdt family's bfloat16 modes
    that no path of either package runs: the plocal2d residual, apply and
    red-only norm on the bfloat16 form of S1's packed fine tile, the whole
    4095^2 grid's red-only norm and the BELL SpMM on the bench matrix, each
    launched exactly once; outputs finite, in bfloat16, the norms float32
    scalars."""
    from multigridcmt_tpu_torch.kernels import bell, packed2d, plocal2d

    bf, f32 = torch.bfloat16, torch.float32
    n = 2 ** MAIN_K - 1
    h = 1.0 / (n + 1)
    ue, be, _, t = local2d_tile(n, f32, seed=67)
    su, sb = (plocal2d.pack_ext(g, 0).to(bf) for g in (ue, be))
    del ue, be
    gu, gb, _, _ = bf16_inputs(n, seed=68)
    ab, xt = bell_bf16_bench()
    offs = (t["row_off"], t["col_off"])
    out, counts, _ = counted(lambda: (
        plocal2d.residual(su, sb, n, h, *offs),
        plocal2d.apply_op(su, n, h, *offs),
        plocal2d.residual_norm_sq(su, sb, n, h, t["m"], *offs,
                                  red_only=True),
        packed2d.residual_norm_sq(gu, gb, n, h, red_only=True),
        bell.spmm(ab, xt)))
    dtypes = [o.dtype for o in out]
    require(dtypes == [bf, bf, f32, f32, bf]
            and all(bool(o.isfinite().all()) for o in out)
            and out[2].shape == out[3].shape == (),
            f"cdt bf16 direct: outputs {dtypes} or not finite")
    require_counts("cdt bf16 direct", counts, plocal2d_residual_bf16=1,
                   plocal2d_apply_bf16=1, plocal2d_resnorm_bf16=1,
                   packed2d_resnorm_bf16=1, bell_spmm_bf16=1)
    runs["cdt_bf16_direct"] = counts
    del su, sb, gu, gb, ab, xt, out
    torch.cuda.empty_cache()


def paths_native_bf16(runs: dict) -> None:
    """Direct calls (native_bf16_direct) of slice B1's native bfloat16
    modes (of which the bfloat16 solves run two): each launched once at its
    NATIVE_STENCIL_N or on S1's tile (RB-GS nu = 4, Jacobi nu = 8) or at
    the 4095^2 SpMV, sigma 0; outputs bfloat16 of the input's shape,
    finite."""
    from multigridcmt_tpu_torch.kernels import spmv

    calls = {}
    for mode, n in NATIVE_STENCIL_N.items():
        u, b = native_grids(n, n + 311)
        calls[f"stencil2d_{mode}_bf16"] = (native_stencil_calls(
            mode, u, b, n, 0.0, max(NATIVE_SWEEPS.get(mode, (0,))))[0], u)
    ue, be, t = native_tile("S1", 312)
    for mode in NATIVE_STENCIL_N:
        calls[f"local2d_{mode}_bf16"] = (native_local_calls(
            mode, ue, be, t, 0.0, max(NATIVE_SWEEPS.get(mode, (0,))))[0], ue)
    _, pk, xp = native_dia(313)
    calls["spmv_dia_bf16"] = (lambda: spmv.spmv_packed(pk, xp), xp)
    out, counts, _ = counted(lambda: {k: fn() for k, (fn, _) in
                                      calls.items()})
    for k, (_, like) in calls.items():
        require(out[k].dtype == torch.bfloat16 and out[k].shape == like.shape
                and bool(out[k].isfinite().all()),
                f"native bf16 direct {k}: {out[k].dtype} "
                f"{tuple(out[k].shape)} or not finite")
    require_counts("native bf16 direct", counts, **{k: 1 for k in calls})
    runs["native_bf16_direct"] = counts
    del calls, out, ue, be, pk, xp
    torch.cuda.empty_cache()


def bf16_solve_counts(label: str, prob, iters: int) -> dict:
    """The native launches of BF16_SOLVES[label] with ``iters`` cycles:
    the convergence check (the stencil2d residual, once before the first
    cycle and once after each); at each fused level (2047...255) a cycle's
    legs, each counted by its own cap as kernels/__init__.py routes it: a
    leg that fuses is one launch of the row stream (no native sweep
    launched from it); a down leg that does not is its sweeps (one launch
    of the sweep stream a chunk of stencil2d.max_fused_sweeps: RB-GS 4,
    Jacobi 8) and a residual restriction (one launch of its stream), an up
    leg that does not a prolongation-add (one launch of the block kernel)
    and its sweeps. So V(4,5) RB-GS: 1 + 2 sweep launches, a restriction
    and a prolongation-add; Jacobi V(8,8): 1 sweep launch (the down leg's),
    a restriction and a fused up leg."""
    from multigridcmt_tpu_torch.kernels import fused2d, stencil2d

    cfg = prob.config
    kind = cfg.smoother
    per = fused_levels(prob) * iters
    cap = stencil2d.max_fused_sweeps(kind)
    want = {"stencil2d_residual_bf16": iters + 1}
    sweeps = 0
    if cfg.nu1 <= fused2d.max_down_sweeps(kind):
        want["fused2d_down_bf16"] = per
    else:
        sweeps += -(-cfg.nu1 // cap)
        want["transfer2d_residual_restrict_bf16"] = per
    if cfg.nu2 <= fused2d.max_up_sweeps(kind):
        want["fused2d_up_bf16"] = per
    else:
        sweeps += -(-cfg.nu2 // cap)
        want["transfer2d_prolong_add_bf16"] = per
    if sweeps:
        want[f"stencil2d_{kind}_bf16"] = per * sweeps
    return want


def paths_bf16_solves(runs: dict) -> None:
    """The bfloat16 solves (BF16_SOLVES) through MultigridSolver.solve at
    k = BF16_SOLVE_K on the card, with exact native launches
    (bf16_solve_counts), and the same solves on the CPU, where every
    wrapper runs its plain version: the same iterations and x bit for bit;
    the histories equal, or one bfloat16 ulp apart at an entry only where
    the two devices' iterates and residuals there are equal bit for bit
    (the norm's float32 sum parts; a replay of the cycles finds which).
    Both devices take the CPU's b (the card's sin may differ)."""
    import multigridcmt_tpu_torch as mt

    bf = torch.bfloat16
    for label, kw in BF16_SOLVES.items():
        cpu = mt.poisson2d(k=BF16_SOLVE_K, dtype=bf, use_kernels=True,
                           device="cpu", **kw)
        card = mt.poisson2d(k=BF16_SOLVE_K, dtype=bf, use_kernels=True,
                            device="cuda", **kw)
        b = cpu.b.to("cuda")
        same_b = torch.equal(card.b.view(torch.int16), b.view(torch.int16))
        (res, counts, wall), entries = entry_counts(lambda: counted(
            lambda: mt.MultigridSolver(card).solve(b=b)))
        start = time.perf_counter()
        ref = mt.MultigridSolver(cpu).solve()
        cpu_wall = time.perf_counter() - start
        hist = res.res_history[: res.iters + 1].cpu()
        want = ref.res_history[: ref.iters + 1]
        log(f"{label}: iters {res.iters} (CPU {ref.iters}), history "
            f"{hist.float().tolist()} (CPU {want.float().tolist()}), wall "
            f"{wall:.3f} s (CPU {cpu_wall:.3f} s); the card's own b equals "
            f"the CPU's: {same_b}")
        require(res.iters == ref.iters and res.x.dtype == bf,
                f"{label}: {res.iters} iterations against the CPU's "
                f"{ref.iters}, or x {res.x.dtype}")
        require(torch.equal(res.x.cpu().view(torch.int16),
                            ref.x.view(torch.int16)),
                f"{label}: x differs from the CPU's on "
                f"{int((res.x.cpu().view(torch.int16) != ref.x.view(torch.int16)).sum())} points")
        ulps = (hist.view(torch.int16).int()
                - want.view(torch.int16).int()).abs()
        apart = ulps.nonzero().flatten().tolist()
        if apart:
            require(int(ulps.max()) <= 1, f"{label}: history entries "
                    f"{apart} differ by {ulps.tolist()} bfloat16 ulp")
            bf16_replay(label, card, cpu, b, apart)
        require_counts(label, counts,
                       **bf16_solve_counts(label, card, res.iters))
        # The RB-GS and Jacobi sweeps and the residual restriction run the
        # row streams' entry points, the prolongation-add the block kernel's,
        # one launch a call, and native_bf16.cu's sweeps (a launch a colour
        # or a sweep) never.
        streams = {"mg_stencil2d_sweep_native_bf16":
                       counts["stencil2d_rbgs_bf16"],
                   "mg_stencil2d_jacobi_native_bf16":
                       counts["stencil2d_jacobi_bf16"],
                   "mg_native2d_residual_restrict_bf16":
                       counts["transfer2d_residual_restrict_bf16"],
                   "mg_transfer2d_prolong_add_native_bf16":
                       counts["transfer2d_prolong_add_bf16"],
                   "mg_native2d_sweep_bf16": 0}
        log(f"  entry points {label}: {entries}")
        require({k: entries.get(k, 0) for k in streams} == streams,
                f"{label}: entry points {entries}, expected {streams}")
        runs[label] = counts
        del cpu, card, b, res, ref
    torch.cuda.empty_cache()


def bf16_replay(label: str, card, cpu, b, apart) -> None:
    """Replay the cycles of a bfloat16 solve on both devices: at each
    history entry in ``apart`` the iterates and the fine residuals must be
    equal bit for bit (so only the norm's float32 sum parts there)."""
    from multigridcmt_tpu_torch.solvers import cycles

    out = {}
    for dev, prob, rhs in (("card", card, b), ("cpu", cpu, cpu.b)):
        cfg, hier = prob.config, prob.hierarchy
        bk = cycles.get_backend(cfg)
        x = torch.zeros_like(rhs)
        seen = []
        log(f"  {label} ||b|| on the {dev}: {float(cycles._norm(rhs))}")
        for i in range(max(apart) + 1):
            if i:
                x = cycles.cycle(hier, x, rhs, cfg)
            r = bk.residual(x, rhs, cfg.n, hier.fine.h)
            seen.append((x.cpu(), r.cpu(), cycles._norm(r).cpu()))
        out[dev] = seen
    for i in apart:
        (xc, rc, nc), (xp, rp, np_) = out["card"][i], out["cpu"][i]
        same = (torch.equal(xc.view(torch.int16), xp.view(torch.int16))
                and torch.equal(rc.view(torch.int16), rp.view(torch.int16)))
        log(f"  {label} history entry {i}: iterates and residuals equal "
            f"{same}; residual norms {float(nc)} (card) against "
            f"{float(np_)} (CPU)")
        require(same, f"{label}: history entry {i} parts with the iterate "
                "or the residual, not only the norm's sum")


def paths_mixed3d(runs: dict) -> None:
    """3D mixed precision: MG-PCG at 511^3 float32 with
    precond_dtype=torch.bfloat16 (mixed3d) beside the float32 PCG, with
    exact launches (each preconditioning cycle's nu1 bfloat16 RB-GS sweeps
    and bfloat16 residual at 511, no float32 pre-smoothing there, the
    float32 kernels after the correction add and below; all sweeps together
    PCG's float32 count); MultigridSolver.eigensolve(k=1) in float64 with a
    bfloat16 preconditioner at MIXED3D_EIGEN against the full-precision
    runs and the exact discrete lambda_1; and one direct call of each
    bfloat16 mode that no solver runs."""
    import multigridcmt_tpu_torch as mt
    from multigridcmt_tpu_torch.kernels import stencil3d
    from multigridcmt_tpu_torch.ops import laplacian
    from multigridcmt_tpu_torch.utils.profiling import count_cycles

    f32, bf16 = torch.float32, torch.bfloat16

    def build(k, dtype, pd=None):
        return mt.poisson3d(k=k, dtype=dtype, smoother="rbgs",
                            use_kernels=True, device="cuda",
                            precond_dtype=pd)

    full = mt.MultigridSolver(build(MAIN_K3, f32)).solve(method="pcg")
    prob = build(MAIN_K3, f32, bf16)
    solver = mt.MultigridSolver(prob)
    torch.cuda.reset_peak_memory_stats()
    res, counts, wall = counted(lambda: solver.solve(method="pcg"))
    runs["peak_mixed3d"] = torch.cuda.max_memory_allocated()
    check_solve(f"mixed3d: mixed pcg 3D k={MAIN_K3} float32 rbgs", prob,
                solver, res, wall, 3, runs["peak_mixed3d"])
    bound = math.ceil(MIXED_ITER_FACTOR * full.iters) + 1
    log(f"  float32 pcg: {full.iters} iterations, converged "
        f"{full.converged}, max error vs u_exact "
        f"{(full.x - prob.u_exact).abs().max().item():.4e}; bound {bound}")
    require(full.converged and res.converged and res.iters <= bound,
            f"mixed3d: {res.iters} iterations (converged {res.converged}) "
            f"against float32's {full.iters}: bound {bound}")
    cfg, tier = prob.config, tier3(prob)
    i = res.iters
    c = i + 1                               # preconditioning cycles

    def cycle_counts(c: int, tier: int, checks: int = 0) -> dict:
        """c mixed cycles on ``tier`` kernel levels: on the fine one nu1
        bfloat16 sweeps and the bfloat16 residual, nu2 float32 sweeps after
        the correction add; on the others the float32 sweeps and residual;
        ``checks`` more float32 (or float64) residuals on the fine one."""
        return dict(stencil3d_rbgs_bf16=cfg.nu1 * c,
                    stencil3d_rbgs_bf16_pairs=cfg.nu1 * c,
                    stencil3d_residual_bf16=c,
                    stencil3d_rbgs=(cfg.nu2 + (tier - 1) * (cfg.nu1
                                                            + cfg.nu2)) * c,
                    stencil3d_residual=(tier - 1) * c + checks)

    # CG's residual once and its operator apply an iteration at 511.
    require_counts("mixed3d", counts, **cycle_counts(c, tier, 1 + i))
    sweeps = counts["stencil3d_rbgs"] + counts["stencil3d_rbgs_bf16"]
    require(sweeps == tier * (cfg.nu1 + cfg.nu2) * c,
            f"mixed3d: {sweeps} sweeps, not PCG's float32 count")
    runs["mixed3d"] = counts
    del full, prob, solver, res
    torch.cuda.empty_cache()

    for method, k in MIXED3D_EIGEN:
        n = 2 ** k - 1
        exact = 3 * laplacian.eigenvalue_1d(1, n, 1.0 / (n + 1))
        out = {}
        for pd in (None, bf16):
            prob = build(k, torch.float64, pd)
            solver = mt.MultigridSolver(prob)
            torch.cuda.reset_peak_memory_stats()
            with count_cycles() as cyc:
                res, counts, wall = counted(
                    lambda: solver.eigensolve(k=1, method=method))
            peak = torch.cuda.max_memory_allocated()
            lam = res.eigenvalues[0].item()
            label = (f"mixed3d eigen{n} {method} float64 precond_dtype={pd}")
            log(f"{label}: {res.iters} outer steps, {cyc.count} cycles, "
                f"converged {res.converged}, lambda_1 {lam:.12f} (exact "
                f"rel {abs(lam - exact) / exact:.2e}), final residual "
                f"{res.res_history[res.iters].item():.3e}, wall {wall:.3f} "
                f"s, peak memory {peak / 2**20:.1f} MiB")
            require(res.converged and bool(res.eigenvectors.isfinite().all())
                    and abs(lam - exact) / exact <= EIGEN_RTOL,
                    f"{label}: converged {res.converged}, lambda_1 {lam} "
                    f"against exact {exact}")
            out[pd] = (lam, res.iters, cyc.count, counts, wall, peak)
            tier = tier3(prob)
            del prob, solver, res
            torch.cuda.empty_cache()
        (lf, sf, *_), (lm, sm, c, counts, *_) = out[None], out[bf16]
        rel = abs(lm - lf) / lf
        log(f"mixed3d eigen {method}: lambda_1 bfloat16-preconditioned vs "
            f"full rel {rel:.2e}; steps {sm} against {sf}")
        require(rel <= MIXED_EIGEN_RTOL and sm <= sf + MIXED3D_EXTRA_STEPS,
                f"mixed3d eigen {method}: lambda_1 {rel:.3e} from the full "
                f"run's (> {MIXED_EIGEN_RTOL}) or {sm} steps against {sf}")
        # II's inner check and refinement defect: a float64 residual at the
        # fine level each cycle; LOBPCG applies A by the plain stencil.
        require_counts(f"mixed3d_{method}", counts,
                       **cycle_counts(c, tier, c if method == "ii" else 0))
        runs[f"mixed3d_{method}"] = counts
        runs[f"mixed3d_{method}_stats"] = {
            "full": dict(zip(("lambda1", "steps", "cycles"), out[None][:3]),
                         wall_s=out[None][4], peak_bytes=out[None][5]),
            "bf16": dict(zip(("lambda1", "steps", "cycles"), out[bf16][:3]),
                         wall_s=out[bf16][4], peak_bytes=out[bf16][5])}

    # The bfloat16 modes no solver runs: direct calls.
    n = 2 ** MAIN_K3 - 1
    h = 1.0 / (n + 1)
    u, b = cube_inputs(n, f32, seed=41)
    su, sb = u.to(bf16), b.to(bf16)
    del u, b

    def direct():
        stencil3d.rbgs_sweep(su, sb, n, h, out_dtype=f32)
        stencil3d.jacobi_sweep(su, sb, n, h, omega3())
        stencil3d.jacobi_sweep(su, sb, n, h, omega3(), out_dtype=f32)

    _, counts, _ = counted(direct)
    require_counts("stencil3d bf16 direct", counts,
                   stencil3d_rbgs_bf16_f32=1, stencil3d_rbgs_bf16_pairs=1,
                   stencil3d_jacobi_bf16=1, stencil3d_jacobi_bf16_pairs=1,
                   stencil3d_jacobi_bf16_f32=1)
    runs["mixed3d_direct"] = counts
    del su, sb
    torch.cuda.empty_cache()


def paths_sharded_fmg(runs: dict) -> None:
    """S1fmg: ShardedSolver.solve with cycle="fmg" at config 5's 4095^2
    on a row mesh of 1, float32, against fmg4095, with exact local2d and
    plocal2d launches; and a float64 k=10 sharded FMG solve against the
    single-device FMG solve."""
    import multigridcmt_tpu_torch as mt
    from multigridcmt_tpu_torch.parallel import sharded

    k, shape, cfg_kw = SHARDED_PATHS["S1"]
    prob = mt.poisson2d(k=k, dtype=torch.float32, use_kernels=True,
                        device="cuda", cycle="fmg", **cfg_kw)
    solver = sharded.ShardedSolver(prob.config, sharded_mesh(shape))
    legs, _ = sharded_levels(prob, solver)
    require(sharded._pack_level_ok(prob.config, solver.decomp, 0)
            and legs == 5, f"S1fmg: {legs} leg levels, not 5, or unpacked")
    torch.cuda.reset_peak_memory_stats()
    res, counts, wall = counted(lambda: solver.solve(prob.b))
    runs["peak_S1fmg"] = torch.cuda.max_memory_allocated()
    x = res.x
    maxerr = (x - prob.u_exact).abs().max().item()
    xf, errf = runs["x_fmg4095"]
    diff = (x - xf).abs().max().item()
    hist = res.res_history[: res.iters + 1].tolist()
    log(f"S1fmg: sharded solve(cycle='fmg') k={k} float32 mesh {shape}: "
        f"{res.iters} polishing cycles, converged {res.converged}, history "
        f"{[f'{v:.3e}' for v in hist]}, max error vs u_exact {maxerr:.4e}, "
        f"wall {wall:.3f} s, peak memory {runs['peak_S1fmg'] / 2**20:.1f} "
        f"MiB; against fmg4095 (max error {errf:.4e}): max abs {diff:.4e}")
    require(tuple(x.shape) == tuple(prob.b.shape)
            and bool(x.isfinite().all()) and maxerr < PACKED_MAXERR,
            f"S1fmg: bad solution or max error {maxerr:.3e} >= "
            f"{PACKED_MAXERR}")
    require(diff <= max(maxerr, errf), f"S1fmg against fmg4095: {diff:.3e} "
            f"> the float32 error {max(maxerr, errf):.3e}")
    # The walk's cycles run the unpacked local2d legs on every leg level
    # from their start (4095...255: 5 + 4 + 3 + 2 + 1); the polishing
    # cycles run the packed plocal2d legs at 4095 and local2d at 2047...255,
    # the fused plocal2d norm once before the first and once a cycle.
    i, walk = res.iters, sharded_walk_crossings(prob, solver)
    require_counts("S1fmg", counts, local2d_down=walk + (legs - 1) * i,
                   local2d_up=walk + (legs - 1) * i, plocal2d_down=i,
                   plocal2d_up=i, plocal2d_resnorm=i + 1)
    runs["S1fmg"] = counts
    del prob, solver, res, x, xf
    runs.pop("x_fmg4095")
    runs.pop("x2d")
    torch.cuda.empty_cache()

    # float64 k=10: the sharded FMG solve (local2d legs on 1023...255, the
    # owned-tile route on 127 and 63, the rest gathered) against the
    # single-device FMG solve (fused2d legs).
    prob = mt.poisson2d(k=SHARDED_F64_K, dtype=torch.float64,
                        smoother="rbgs", use_kernels=True, tol=F64_TOL,
                        cycle="fmg", device="cuda")
    solver = sharded.ShardedSolver(prob.config, sharded_mesh((1,)))
    res, counts, _ = counted(lambda: solver.solve(prob.b))
    ref = mt.MultigridSolver(prob).solve()
    legs, _ = sharded_levels(prob, solver)
    sharded_against_single(f"sharded FMG float64 k={SHARDED_F64_K}", res,
                           ref)
    err64 = mt.MultigridSolver(prob).discrete_l2_error(res.x).item()
    log(f"  l2 error vs u_exact {err64:.4e}")
    require(err64 < FMG_L2_FACTOR / 4 ** SHARDED_F64_K,
            f"sharded FMG float64 l2 error {err64:.3e} >= {FMG_L2_FACTOR} "
            "h^2")
    i, walk = res.iters, sharded_walk_crossings(prob, solver)
    require_counts("sharded FMG f64", counts,
                   local2d_down=walk + legs * i, local2d_up=walk + legs * i,
                   local2d_residual=i + 1)
    del prob, solver, res, ref
    torch.cuda.empty_cache()


def sharded3d_levels(prob, solver) -> tuple:
    """(extended-stack levels, stagewise slab levels) of a sharded 3D
    problem on the stencil3d kernels, from the solver's own routing
    predicates."""
    from multigridcmt_tpu_torch.parallel import sharded

    cfg, dec = prob.config, solver.decomp
    stack = stage = 0
    for lv, spec in enumerate(prob.hierarchy.levels):
        if not sharded._is_sharded(cfg, dec, lv):
            continue
        rows = sharded._level_rows(cfg.k, lv)
        tile = torch.empty((rows // dec.axes[0][2],
                            rows // dec.axes[1][2] if len(dec.axes) == 2
                            else spec.n + 2, spec.n + 2), device="meta")
        if (sharded._slab3d_ok(tile, spec.n, cfg.smoother, dec,
                               sharded._slab3d_hz_level(cfg))
                or sharded._pencil3d_ok(tile, spec.n, cfg, dec)):
            stack += 1
        elif sharded._slab3d_ok(tile, spec.n, cfg.smoother, dec, 1):
            stage += 1
    return stack, stage


def stack_pairs(solver, n: int) -> bool:
    """Whether the bfloat16 RB-GS sweeps on the fine stack of a mesh of 1
    take the paired march (stencil3d.rbgs_pairs: rows odd, goff + roff
    even): the slab stack's 513 rows pair, the pencil's 522 do not."""
    from multigridcmt_tpu_torch.parallel import sharded

    hz = sharded._slab3d_hz_level(solver.config)
    rows = n + 2 if len(solver.decomp.axes) == 1 else n + 1 + 2 * hz
    offs = (1 - hz) + (1 - hz if len(solver.decomp.axes) == 2 else 0)
    return rows % 2 == 1 and offs % 2 == 0


class count_level0_calls:                                   # noqa: N801
    """Counts the cycles started at the finest level while active: calls
    of the function ``name`` of ``sharded`` at level 0 (its recursion
    passes level + 1). ``_sharded_v_cycle`` counts the owned-tile and
    extended-stack cycles, ``_leg_cycle_ext`` the whole-leg ones (the
    II/RQI inner cycles and LOBPCG's preconditioning cycles alike)."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        from multigridcmt_tpu_torch.parallel import sharded

        self.count = 0
        self._orig = orig = getattr(sharded, self.name)

        def counting(*args, **kwargs):
            self.count += (args[5] if len(args) > 5 else kwargs["level"]) == 0
            return orig(*args, **kwargs)

        setattr(sharded, self.name, counting)
        return self

    def __exit__(self, *exc):
        from multigridcmt_tpu_torch.parallel import sharded

        setattr(sharded, self.name, self._orig)
        return False


class plain_stencil3d:                                      # noqa: N801
    """While active, the stencil3d wrappers are their plain versions (no
    launch, no count)."""

    NAMES = ("residual", "jacobi_sweep", "rbgs_sweep")

    def __enter__(self):
        from multigridcmt_tpu_torch.kernels import stencil3d

        self._orig = {m: getattr(stencil3d, m) for m in self.NAMES}
        for m in self.NAMES:
            setattr(stencil3d, m, getattr(stencil3d, m + "_plain"))
        return self

    def __exit__(self, *exc):
        from multigridcmt_tpu_torch.kernels import stencil3d

        for m, fn in self._orig.items():
            setattr(stencil3d, m, fn)
        return False


def against_single3d(label: str, res, ref, method: str) -> None:
    """A float32 sharded 3D solve against the single-device one: the same
    iterations, and the same convergence. PCG converges (a relative
    residual of 1e-9 at 511^3); its recurrence carries each apply's
    rounding (~eps 6/h^2 |p| / |A p|, some 1e-3 of it at 511^3), so a
    route that applies A in another order (the pencil's owned-tile
    residual) parts from the single device's history by several percent
    in its tail: only logged. By cycles float32 stalls at its floor (the
    check's own rounding, ~3e-3 at 511^3) and the stall guard ends the
    solve: every common history entry within SHARDED3D_HIST_RTOL of the
    single device's plus its last entry."""
    hs, hr = res.res_history, ref.res_history
    last = hr[ref.iters].item()
    common = range(min(res.iters, ref.iters) + 1)
    over = max(abs(hs[j].item() - hr[j].item())
               - SHARDED3D_HIST_RTOL * hr[j].item() - last for j in common)
    rel = max(abs(hs[j].item() - hr[j].item()) / hr[j].item()
              for j in common)
    log(f"  single device: {ref.iters} iterations, converged "
        f"{ref.converged}, last {last:.3e}; history rel diff at most "
        f"{rel:.3e}, past rtol {SHARDED3D_HIST_RTOL} plus the last entry "
        f"by at most {over:.3e}, over {len(common)} entries")
    require(res.iters == ref.iters and res.converged == ref.converged
            and (method == "pcg" or over <= 0.0), f"{label}: {res.iters} "
            f"iterations (converged {res.converged}), the single device's "
            f"{ref.iters} ({ref.converged}); history over by {over:.3e}")


def paths_sharded3d(runs: dict) -> None:
    """Sharded 3D through ShardedSolver (ndim=3) on the world of 1 at
    SHARDED3D_PATHS: slab and pencil RB-GS solves by cycles and by PCG
    beside the single-device solve, the Jacobi slab solve, the mixed PCG
    runs beside the float32 PCG of the same mesh (SHARDED3D_PLAIN_RUNS
    again on the plain stencil3d versions), each with exact stencil3d
    launches; float64 kernel-against-plain histories at k =
    SHARDED3D_F64_K; inverse iteration at 255^3 float64 (slab-eigen)."""
    import multigridcmt_tpu_torch as mt
    from multigridcmt_tpu_torch.ops import laplacian
    from multigridcmt_tpu_torch.parallel import sharded

    def build(shape, smoother, dtype=torch.float32, k=MAIN_K3, **kw):
        prob = mt.poisson3d(k=k, dtype=dtype, smoother=smoother,
                            use_kernels=True, device="cuda", **kw)
        return prob, sharded.ShardedSolver(prob.config, sharded_mesh(shape))

    def describe(label, prob, solver, method):
        cfg = prob.config
        return (f"{label}: sharded {method} 3D k={cfg.k} float32 "
                f"{cfg.smoother} V({cfg.nu1},{cfg.nu2}) mesh "
                f"{solver.mesh.shape}")

    def want(method, slab, i, tier, kind="rbgs", pd=None, pairs=False):
        """Launches of a solve: per cycle nu1 + nu2 = 4 sweep launches and
        one residual a kernel level (the fine level under a mixed
        preconditioner: its nu1 = 2 down sweeps and its residual in
        bfloat16, then the correction add promotes the stack and its nu2
        = 2 up sweeps run in float32); the slab check residual (1 plane)
        before the first cycle and after each, or PCG's first residual
        and one apply an iteration; none on a pencil mesh. The 2 bfloat16
        RB-GS sweeps are paired where ``pairs`` holds, the 2 bfloat16
        Jacobi sweeps on every stack (jacobi_pairs: c odd)."""
        c = i if method == "mg" else i + 1
        checks = (i + 1) if slab else 0
        out = {f"stencil3d_{kind}": 4 * tier * c,
               "stencil3d_residual": tier * c + checks}
        if pd is not None:
            out = {f"stencil3d_{kind}": (4 * (tier - 1) + 2) * c,
                   "stencil3d_residual": (tier - 1) * c + checks,
                   f"stencil3d_{kind}_bf16": 2 * c,
                   "stencil3d_residual_bf16": c}
            if pairs or kind == "jacobi":
                out[f"stencil3d_{kind}_bf16_pairs"] = 2 * c
        return out

    full = {}
    for label, (shape, smoother, pd) in SHARDED3D_PATHS.items():
        slab = len(shape) == 1
        prob, solver = build(shape, smoother, precond_dtype=pd)
        tier, stage = sharded3d_levels(prob, solver)
        mixed = sharded.mixed_slab_dtype(prob.config, solver.decomp)
        require((tier, stage, mixed) == (tier3(prob), 0, pd),
                f"{label}: {tier} stack and {stage} stagewise levels, mixed "
                f"{mixed}; not {tier3(prob)}, 0, {pd}")
        single = mt.MultigridSolver(prob)
        if pd is None:
            methods = ("mg", "pcg") if smoother == "rbgs" else ("mg",)
        else:
            methods = ("pcg",)
        for method in methods:
            run = label + ("pcg" if method == "pcg" and pd is None else "")
            if run == "slab511":
                torch.cuda.reset_peak_memory_stats()
            res, counts, wall = counted(
                lambda: solver.solve(prob.b, method=method))
            peak = None
            if run == "slab511":
                peak = runs["peak_slab511"] = torch.cuda.max_memory_allocated()
            check_solve(describe(run, prob, solver, method), prob, single,
                        res, wall, 3, peak)
            i = res.iters
            if pd is None and smoother == "rbgs":
                against_single3d(run, res, single.solve(method=method),
                                 method)
            if pd is None:
                if method == "pcg":
                    full[(shape, smoother)] = res
            else:
                ref = full.get((shape, smoother))
                if ref is None:
                    _, ref_solver = build(shape, smoother)
                    ref = full[(shape, smoother)] = ref_solver.solve(
                        prob.b, method="pcg")
                    del ref_solver
                # The correction add promotes the stack (F7 not copied):
                # the mixed run takes the float32 run's iterations.
                log(f"  float32 sharded pcg: {ref.iters} iterations, "
                    f"converged {ref.converged}")
                require(ref.converged and res.converged and i == ref.iters,
                        f"{run}: {i} iterations (converged {res.converged}) "
                        f"against float32's {ref.iters}")
            if run in SHARDED3D_PLAIN_RUNS:
                # The same solve on the plain stencil3d versions: the
                # kernels' roundings do not set the iteration count.
                with plain_stencil3d():
                    pres, pcounts, pwall = counted(
                        lambda: solver.solve(prob.b, method=method))
                hist = res.res_history[: i + 1]
                diff = ((hist - pres.res_history[: i + 1]).abs()
                        / hist).max().item() if pres.iters == i else None
                log(f"  plain stencil3d: {pres.iters} iterations, converged "
                    f"{pres.converged}, history rel diff {diff}, wall "
                    f"{pwall:.3f} s")
                require(pres.converged and pres.iters == i
                        and not any(pcounts.values()),
                        f"{run} on plain stencil3d: {pres.iters} iterations "
                        f"against the kernels' {i}, launches "
                        f"{ {k: v for k, v in pcounts.items() if v} }")
                del pres
            require_counts(run, counts, **want(
                method, slab, i, tier, smoother, pd,
                pd is not None and smoother == "rbgs"
                and stack_pairs(solver, prob.config.n)))
            runs[run] = counts
            runs[f"{run}_stats"] = dict(iters=i, wall_s=wall)
            del res
        del prob, solver, single
        torch.cuda.empty_cache()
    del full

    # float64 at k = SHARDED3D_F64_K: kernel route against the plain
    # sharded route (use_kernels=False), slab and pencil.
    for shape in ((1,), (1, 1)):
        out = {}
        for use_kernels in (True, False):
            prob = mt.poisson3d(k=SHARDED3D_F64_K, dtype=torch.float64,
                                smoother="rbgs", use_kernels=use_kernels,
                                tol=F64_TOL, device="cuda")
            solver = sharded.ShardedSolver(prob.config, sharded_mesh(shape))
            res, counts, _ = counted(lambda: solver.solve(prob.b))
            out[use_kernels] = (res, counts, sharded3d_levels(prob, solver))
        (rk, ck, (tier, _)), (rp, _, _) = out[True], out[False]
        hk, hp = (r.res_history[: r.iters + 1] for r in (rk, rp))
        label = (f"sharded 3D float64 k={SHARDED3D_F64_K} mesh {shape}, "
                 "kernel against plain")
        same = rk.iters == rp.iters
        over = (((hk - hp).abs() - F64_TOL * hp).max().item() if same
                else float("inf"))
        log(f"{label}: iters {rk.iters}/{rp.iters}, converged "
            f"{rk.converged}/{rp.converged}, past rtol {F64_TOL} by at most "
            f"{over:.2e} (floor {F64_FLOOR[3]})")
        require(rk.converged and rp.converged and same
                and over <= F64_FLOOR[3], f"{label}: {rk.iters}/{rp.iters}, "
                f"over {over}")
        require_counts(label, ck, **want("mg", len(shape) == 1, rk.iters,
                                         tier))
        del prob, solver, out, rk, rp
    torch.cuda.empty_cache()

    # Inverse iteration at 255^3 float64 on a slab mesh: II's inner cycles
    # (counted around sharded._sharded_v_cycle) each launch the sweeps and
    # residual on both kernel levels and the slab check residual; the
    # Rayleigh quotients and Ritz steps apply A as the slab residual, one
    # before the first step and two a step.
    prob, solver = build((1,), "rbgs", torch.float64, SHARDED3D_EIGEN_K)
    tier, _ = sharded3d_levels(prob, solver)
    n = prob.config.n
    exact = 3 * laplacian.eigenvalue_1d(1, n, 1.0 / (n + 1))
    torch.cuda.reset_peak_memory_stats()
    with count_level0_calls("_sharded_v_cycle") as cyc:
        res, counts, wall = counted(lambda: solver.eigensolve(k=1))
    peak = torch.cuda.max_memory_allocated()
    lam, it, c = res.eigenvalues[0].item(), res.iters, cyc.count
    rel = abs(lam - exact) / exact
    log(f"slab-eigen: sharded eigensolve ii k=1 float64 {n}^3 mesh (1,): "
        f"{it} outer steps, {c} cycles, converged {res.converged}, lambda_1 "
        f"{lam:.12f} (exact rel {rel:.2e}), wall {wall:.3f} s, peak memory "
        f"{peak / 2**20:.1f} MiB")
    require(res.converged and rel <= EIGEN_RTOL
            and bool(res.eigenvectors.isfinite().all()),
            f"slab-eigen: converged {res.converged}, rel error {rel:.3e}")
    require_counts("slab-eigen", counts, stencil3d_rbgs=4 * tier * c,
                   stencil3d_residual=tier * c + c + 2 * it + 1)
    runs["slab-eigen"] = counts
    runs["slab-eigen_stats"] = dict(outer_steps=it, cycles=c, wall_s=wall,
                                    peak_bytes=peak, lambda1=lam)
    del prob, solver, res
    torch.cuda.empty_cache()


def paths_sharded_eigen(runs: dict) -> None:
    """ShardedSolver.eigensolve at SHARDED_EIGEN's paths on a mesh of 1,
    float64: each run converged, its eigenvalues against the exact ones (and
    S1eigen's against the single-device run's, the mixed runs' against
    S1eigen's), eigenvectors finite with zero ghosts, and exact launches as
    a multiple of the whole-leg cycles it ran (count_level0_calls around
    sharded._leg_cycle_ext) and of its outer steps."""
    import multigridcmt_tpu_torch as mt
    from multigridcmt_tpu_torch.ops import laplacian
    from multigridcmt_tpu_torch.parallel import sharded

    lam_full = {}
    for label, (path, pd, methods) in SHARDED_EIGEN.items():
        k, shape, cfg_kw = SHARDED_PATHS[path]
        prob = mt.poisson2d(k=k, dtype=torch.float64, use_kernels=True,
                            device="cuda", precond_dtype=pd, **cfg_kw)
        solver = sharded.ShardedSolver(prob.config, sharded_mesh(shape))
        legs, owned = sharded_levels(prob, solver)
        packs = sharded._pack_level_ok(prob.config, solver.decomp, 0)
        mixed = sharded.mixed_leg_dtype(prob.config, solver.decomp)
        require((legs, owned, packs, mixed) == ((5, 0, True, pd) if path
                                                 == "S1" else (4, 0, False,
                                                               None)),
                f"{label}: {legs} leg and {owned} owned kernel levels, "
                f"packed {packs}, mixed {mixed}")
        n = 2 ** k - 1
        h = 1.0 / (n + 1)
        spectrum = sorted(laplacian.eigenvalue_2d(a, b, n, h)
                          for a, b in ((1, 1), (1, 2), (2, 1)))
        for method, block in methods:
            run = f"{label}_{method}{block}"
            torch.cuda.reset_peak_memory_stats()
            with count_level0_calls("_leg_cycle_ext") as cyc:
                res, counts, wall = counted(
                    lambda: solver.eigensolve(k=block, method=method))
            peak = torch.cuda.max_memory_allocated()
            vals = res.eigenvalues.tolist()
            rel = max(abs(v - w) / w for v, w in zip(vals, spectrum))
            vecs = res.eigenvectors
            ghosts = vecs.clone()
            ghosts[:, 1:-1, 1:-1] = 0
            c, it = cyc.count, res.iters
            log(f"{run}: sharded eigensolve {method} k={block} float64 "
                f"{n}^2 mesh {shape} precond_dtype={pd}: {it} outer steps, "
                f"{c} cycles, converged {res.converged}, eigenvalues "
                f"{[f'{v:.12f}' for v in vals]}, rel error vs exact "
                f"{rel:.2e}, final residual "
                f"{res.res_history[it].item():.3e}, wall {wall:.3f} s, peak "
                f"memory {peak / 2**20:.1f} MiB")
            require(res.converged and rel < EIGEN_RTOL,
                    f"{run}: converged {res.converged}, rel error {rel:.3e}")
            require(tuple(vecs.shape) == (block,) + tuple(prob.b.shape)
                    and bool(vecs.isfinite().all()) and not ghosts.any(),
                    f"{run}: bad eigenvectors")
            if label == "S1eigen" and block == 1:
                single = runs["eigen4095_lambda"][
                    "lobpcg" if method == "lobpcg" else "ii"]
                route = abs(vals[0] - single) / single
                log(f"  against the single-device float64 run at {n}^2: "
                    f"rel {route:.2e}")
                require(route <= EIGEN_ROUTE_RTOL, f"{run}: {route:.3e} "
                        f"from the single-device run > {EIGEN_ROUTE_RTOL}")
                lam_full[method] = vals[0]
            if pd is not None:
                full = lam_full[method]
                drift = abs(vals[0] - full) / full
                log(f"  against S1eigen's float64-preconditioned run: rel "
                    f"{drift:.2e}")
                require(drift <= MIXED_EIGEN_RTOL, f"{run}: lambda_1 "
                        f"{drift:.3e} from the full run's > "
                        f"{MIXED_EIGEN_RTOL}")
            # Launches. A row of A (Rayleigh quotients, Ritz, LOBPCG's
            # rq_res and rr) is one local2d residual on the owned tile: II
            # and RQI apply k rows before the first step and 2k a step,
            # LOBPCG 2k a step (rq_res twice) plus 2k rows at iteration 0's
            # Rayleigh-Ritz and 3k at each later one. A cycle runs one down
            # and one up leg a leg level; II/RQI's carry the fine tile
            # (packed on S1: the plocal2d legs and the plocal2d residual as
            # the check; unpacked on S2: local2d and the local2d residual),
            # LOBPCG's preconditioner is one unpacked cycle a row a step.
            # With a bfloat16 preconditioner the fine level's legs are the
            # bfloat16 down leg and the float32-storing up leg.
            top_down, top_up = (("down_bf16", "up_bf16_f32") if pd
                                else ("down", "up"))
            fine = "plocal2d" if packs and method != "lobpcg" else "local2d"
            if method == "lobpcg":
                require(c == block * it,
                        f"{run}: {c} cycles, not {block} x {it}")
                want = {"local2d_residual": block * (5 * it - 1)}
            elif packs:
                want = {"plocal2d_residual": c,
                        "local2d_residual": block * (2 * it + 1)}
            else:
                want = {"local2d_residual": c + block * (2 * it + 1)}
            want[f"{fine}_{top_down}"] = c
            want[f"{fine}_{top_up}"] = c
            # The leg levels below the fine one (2047...255 on S1, 1023...255
            # on S2), float32 legs under a bfloat16 fine level.
            for leg in ("down", "up"):
                want[f"local2d_{leg}"] = (want.get(f"local2d_{leg}", 0)
                                          + (legs - 1) * c)
            require_counts(run, counts, **want)
            runs[run] = counts
            runs[f"{run}_stats"] = dict(outer_steps=it, cycles=c, wall_s=wall,
                                        peak_bytes=peak, eigenvalues=vals)
            del res, vecs, ghosts
            torch.cuda.empty_cache()
        del prob, solver
        torch.cuda.empty_cache()


def trace_events(logdir: str) -> tuple:
    """(bytes, events) of the one Chrome trace ``profiling.trace`` wrote
    into ``logdir``."""
    (path,) = Path(logdir).glob("*.pt.trace.json")
    return path.stat().st_size, json.loads(path.read_text())["traceEvents"]


# The trace's kernel events counted against the launch counters: the
# packed2d and fused2d legs by name (utils/breakdown.py's patterns) and
# the packed norm's first pass (one a launch; its second pass sums the
# partials).
TRACE_GROUPS = {"packed2d legs": ("packed2d_down", "packed2d_up"),
                "fused2d legs": ("fused2d_down", "fused2d_up"),
                "packed2d norm": ("packed2d_resnorm",)}


def leg_levels(cfg, decomp) -> int:
    """Whole-leg levels from the finest down."""
    from multigridcmt_tpu_torch.parallel import sharded

    lv = 0
    while sharded._leg_level_ok(cfg, decomp, lv):
        lv += 1
    return lv


def owned_levels(cfg, decomp) -> int:
    """Sharded levels below the whole-leg ones (the owned-tile route)."""
    from multigridcmt_tpu_torch.parallel import sharded

    lv = leg_levels(cfg, decomp)
    owned = 0
    while sharded._is_sharded(cfg, decomp, lv + owned):
        owned += 1
    return owned


def paths_utils(runs: dict) -> None:
    """The utils on the main path (4095^2 float32 RB-GS V(2,2), kernels on):
    a solve bracketed by Timer and its fence (the yardstick), the same
    solve traced (its CUDA kernel events by name against the launch
    counters, an mg_level_* range for every level) with its MetricsLogger
    records, a checkpoint stopped at CHECKPOINT_ITERS cycles, saved, loaded
    and resumed (bit for bit the uninterrupted iterate, the cycles adding
    up), checked() and debug_mode() around the solve (bit for bit, and
    their cost), debug_mode() naming the kernel that first produced a NaN
    planted in b, and comm_audit around S1's solve on the world of 1."""
    import io

    import multigridcmt_tpu_torch as mt
    from multigridcmt_tpu_torch.parallel import sharded
    from multigridcmt_tpu_torch.solvers import cycles
    from multigridcmt_tpu_torch.utils import checkpoint, debug, metrics
    from multigridcmt_tpu_torch.utils.breakdown import ROUTE_KERNELS
    from multigridcmt_tpu_torch.utils.comm_audit import comm_audit
    from multigridcmt_tpu_torch.utils.profiling import Timer, trace

    def build(**kw):
        return mt.poisson2d(k=MAIN_K, dtype=torch.float32, smoother="rbgs",
                            use_kernels=True, device="cuda", **kw)

    prob = build()
    solver = mt.MultigridSolver(prob)
    fused = fused_levels(prob)
    stats = {}
    with Timer() as timer:
        cold = solver.solve()
        total = Timer.fence(cold.x)
    i = cold.iters
    stats["timer_s"] = timer.elapsed
    log(f"utils Timer: solve k={MAIN_K} float32 rbgs {timer.elapsed:.3f} s "
        f"to the fence (sum of x {total:.6e}), {i} cycles")
    require(timer.elapsed > 0 and total == cold.x.sum().item(),
            f"Timer: elapsed {timer.elapsed}, fence {total}")
    want = dict(packed2d_down=i, packed2d_up=i, packed2d_resnorm=i + 1,
                fused2d_down=fused * i, fused2d_up=fused * i)

    with tempfile.TemporaryDirectory() as tmp:
        def traced():
            with trace(tmp):
                return solver.solve()

        res, counts, wall = counted(traced)
        require_counts("utils_trace", counts, **want)
        size, events = trace_events(tmp)
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    patterns = dict(ROUTE_KERNELS, **{
        "packed2d norm": re.compile(r"(?<!\w)presnorm_partial<")})
    seen = {g: sum(1 for name in kernels if patterns[g].search(name))
            for g in TRACE_GROUPS}
    names = {e.get("name") for e in events}
    levels = [f"mg_level_{lv}" for lv in range(prob.hierarchy.num_levels)]
    stats.update(trace_bytes=size, trace_kernel_events=len(kernels),
                 trace_events=len(events), trace_wall_s=wall, **{
                     f"trace_{g.replace(' ', '_')}": c
                     for g, c in seen.items()})
    log(f"utils trace: {size} bytes, {len(events)} events, {len(kernels)} "
        f"kernel events; by name {seen}; wall {wall:.3f} s (untraced "
        f"{timer.elapsed:.3f} s); levels {[lv in names for lv in levels]}")
    for g, parts in TRACE_GROUPS.items():
        require(seen[g] == sum(counts[p] for p in parts),
                f"trace: {seen[g]} {g} kernel events, the counters say "
                f"{sum(counts[p] for p in parts)}")
    require(all(lv in names for lv in levels),
            f"trace: missing level ranges {set(levels) - names}")
    require(res.iters == i and torch.equal(res.x, cold.x),
            "the traced solve differs from the untraced one")

    buf = io.StringIO()
    metrics.MetricsLogger(buf).log_solve_result(res, prob.config)
    recs = [json.loads(line) for line in buf.getvalue().splitlines()]
    its = [r for r in recs if r["event"] == "iteration"]
    done = [r for r in recs if r["event"] == "solve_done"]
    hist = res.res_history[: i + 1].tolist()
    log(f"utils MetricsLogger: {len(its)} iteration records, "
        f"{len(done)} solve_done: {done}")
    require(len(its) == i + 1 and len(done) == 1 and len(recs) == i + 2
            and [r["residual"] for r in its] == hist
            and done[0]["iters"] == i
            and done[0]["final_residual"] == hist[-1],
            f"MetricsLogger records {recs} against the history {hist}")

    part = mt.MultigridSolver(build(max_iters=CHECKPOINT_ITERS)).solve()
    require(part.iters == CHECKPOINT_ITERS and not part.converged,
            f"checkpoint: the partial solve ran {part.iters} cycles")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "snapshot.pt")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.save_state(path, part.x, part.res_history, part.iters)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        state = checkpoint.load_state(path)
        t_load = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        resumed, counts, wall = counted(
            lambda: checkpoint.resume_solve(solver, path))
    stats.update(checkpoint_bytes=nbytes, save_s=t_save, load_s=t_load,
                 resume_wall_s=wall)
    r = resumed.iters
    # The uninterrupted iterate of as many cycles, from zero.
    x = torch.zeros_like(prob.b)
    for _ in range(CHECKPOINT_ITERS + r):
        x = solver.v_cycle(x, prob.b)
    extra = CHECKPOINT_ITERS + r - i
    stats.update(resumed_cycles=r, cold_cycles=i)
    log(f"utils checkpoint at {CHECKPOINT_ITERS} cycles: {nbytes} bytes, "
        f"save {t_save:.3f} s, load {t_load:.3f} s, resumed {r} cycles "
        f"(cold {i}, converged {cold.converged}) in {wall:.3f} s; resumed "
        f"against {CHECKPOINT_ITERS + r} uninterrupted cycles: equal "
        f"{torch.equal(resumed.x, x)}; against the cold solve: max abs "
        f"{(resumed.x - cold.x).abs().max().item():.3e}")
    require(state["kind"] == "solve" and state["iters"] == CHECKPOINT_ITERS
            and torch.equal(state["x"], part.x.cpu()),
            "checkpoint: the snapshot read back differs")
    require(torch.equal(resumed.x, x), f"checkpoint: the resumed iterate "
            f"differs from {CHECKPOINT_ITERS + r} uninterrupted cycles'")
    # A solve the tolerance stops resumes to the cold solve's cycles and
    # iterate. One the stall guard stops (float32 at its floor) restarts
    # the guard's count at the resume, as JAX's resume does: up to
    # STALL_PATIENCE - 1 cycles more.
    require(extra == 0 or (not cold.converged
                           and 0 < extra < cycles.STALL_PATIENCE),
            f"checkpoint: {CHECKPOINT_ITERS} + {r} cycles against the cold "
            f"solve's {i} (converged {cold.converged})")
    require(extra != 0 or torch.equal(resumed.x, cold.x),
            "checkpoint: the resumed iterate differs from the cold solve's")
    require_counts("utils_resume", counts, packed2d_down=r, packed2d_up=r,
                   packed2d_resnorm=r + 1, fused2d_down=fused * r,
                   fused2d_up=fused * r)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xc = debug.checked(lambda: solver.solve().x)()
    stats["checked_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with debug.debug_mode():
        xd = solver.solve().x
    torch.cuda.synchronize()
    stats["debug_mode_s"] = time.perf_counter() - t0
    log(f"utils checked(solve) {stats['checked_s']:.3f} s, debug_mode "
        f"solve {stats['debug_mode_s']:.3f} s, untraced solve "
        f"{timer.elapsed:.3f} s")
    require(torch.equal(xc, cold.x) and torch.equal(xd, cold.x),
            "checked() or debug_mode() changed the iterate")

    b = prob.b.clone()
    nan_at = (prob.config.n // 2, prob.config.n // 4)
    b[nan_at] = math.nan
    be = cycles.get_backend(prob.config).encode(b)
    raised = None
    try:
        with debug.debug_mode():
            mt.v_cycle(prob.hierarchy, torch.zeros_like(be), be,
                       prob.config)
    except debug.NumericError as exc:
        raised = str(exc)
    log(f"utils debug_mode with a NaN planted in b at {nan_at}: {raised}")
    require(raised is not None and "kernel mg_packed2d_down_f32" in raised,
            f"debug_mode did not name the packed down leg: {raised}")
    del prob, solver, cold, res, part, resumed, x, xc, xd, b, be
    torch.cuda.empty_cache()

    # comm_audit around S1's solve on the world of 1 (JAX's units: a slab
    # offered is a ppermute, with or without a neighbour there).
    k, shape, cfg_kw = SHARDED_PATHS["S1"]
    s1 = mt.poisson2d(k=k, dtype=torch.float32, use_kernels=True,
                      device="cuda", **cfg_kw)
    solver = sharded.ShardedSolver(s1.config, sharded_mesh(shape))
    legs, _ = sharded_levels(s1, solver)
    owned = owned_levels(s1.config, solver.decomp)
    with comm_audit() as audit:
        res, counts, wall = counted(lambda: solver.solve(s1.b))
    rep = audit.report()
    i = res.iters
    nu = s1.config.nu1
    # The entry extends b and x (2 pairs); a cycle: the leg levels' 3L - 2
    # pairs, one more into the owned-tile levels (_ext_coarse_tile), their
    # S(8 nu + 3) + (S - 1) slabs, and the carried tile's refresh (1 pair).
    cycle = (2 * (3 * legs - 2 + (1 if owned else 0) + 1)
             + owned * (8 * nu + 3) + max(owned - 1, 0))
    want_audit = {"ppermute": 4 + cycle * i, "psum": i + 2,
                  "all_gather": i + 1}
    log(f"utils comm_audit S1 ({legs} leg levels, {owned} owned-tile "
        f"levels, {i} cycles): {rep}; derived counts {want_audit}")
    require(rep["sent"] == {"messages": 0, "bytes": 0},
            f"comm_audit: a mesh of 1 sent {rep['sent']}")
    require(rep["counts"] == want_audit,
            f"comm_audit counts {rep['counts']}, derived {want_audit}")
    stats["comm_audit"] = rep
    runs["utils_stats"] = stats
    del s1, solver, res
    torch.cuda.empty_cache()


def same_printed(label: str, printed: str, value: float, fmt: str) -> None:
    """``printed`` (a number printed as ``fmt``) within one unit of its
    last digit of ``value`` printed the same way."""
    got, ref = float(printed), float(format(value, fmt))
    digits = int(fmt.split(".")[1][0])
    exp = (math.floor(math.log10(abs(ref))) if "e" in fmt and ref else 0)
    unit = 10.0 ** (exp - digits)
    require(abs(got - ref) <= unit * (1 + 1e-9),
            f"{label}: printed {printed}, the yardstick {value} gives "
            f"{format(value, fmt)}")


def first_below(hist, tol: float, least: int = 0) -> int:
    """The outer step at which a run whose residual history is ``hist``
    stops at ``tol`` (its first residual under tol, at least ``least``)."""
    for step, res in enumerate(hist):
        if res < tol and step >= least:
            return step
    raise SmokeFailure(f"the history {hist} never falls under {tol}")


def run_example(label: str):
    """(what main returned, launches, wall, stdout) of one example run
    in-process through its main(argv)."""
    import contextlib
    import io

    module, argv = EXAMPLES[label]
    main = importlib.import_module(
        f"multigridcmt_tpu_torch.examples.{module}").main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out, counts, wall = counted(lambda: main(list(argv)))
    text = buf.getvalue()
    log(f"{label}: python -m multigridcmt_tpu_torch.examples.{module} "
        f"{' '.join(argv)}  ({wall:.3f} s)")
    for line in text.splitlines():
        log(f"  | {line}")
    return out, counts, wall, text


def grab(label: str, pattern: str, text: str):
    found = re.search(pattern, text, flags=re.M)
    require(found is not None, f"{label}: no line {pattern!r} in {text!r}")
    return found


def paths_examples(runs: dict) -> None:
    """The six example CLIs at the BASELINE configs' widths (EXAMPLES):
    each prints its line, launches exactly what its route derives, and
    where phase 3 ran the same problem through the API takes its
    iterations and prints its values."""
    import multigridcmt_tpu_torch as mt
    from multigridcmt_tpu_torch import kernels
    from multigridcmt_tpu_torch.config import SolverConfig
    from multigridcmt_tpu_torch.ops import laplacian
    from multigridcmt_tpu_torch.parallel import sharded

    def fused(k, levels=None):
        cfg = SolverConfig(ndim=2, k=k, min_coarse=(
            3 if levels is None else 2 ** (k - levels + 1) - 1))
        return [kernels.KERNEL_MIN_N <= n < kernels.PACK_MIN_N
                for n in cfg.level_sizes()[:-1]]

    stats = {}
    launches = {}

    def record(label, counts, wall, **want):
        require_counts(label, counts, **want)
        launches[label] = {k: v for k, v in counts.items() if v}
        stats[label] = {"wall_s": wall}

    res, counts, wall, text = run_example("ex_poisson1d")
    grab("ex_poisson1d", rf"^n=1023  iters={res.iters}  converged=True  "
         r"rho=\S+$", text)
    require(res.converged, "ex_poisson1d did not converge")
    record("ex_poisson1d", counts, wall)
    stats["ex_poisson1d"]["iters"] = res.iters

    for label, method in (("ex_poisson2d", "mg"), ("ex_poisson2d_pcg",
                                                   "pcg")):
        res, counts, wall, text = run_example(label)
        f = sum(fused(8, 5))
        require(f == 1, f"{label}: {f} fused2d levels, not 1 (255)")
        grab(label, rf"^n=255\^2  levels=5  iters={res.iters}  rho=\S+$",
             text)
        i = res.iters
        if method == "mg":
            record(label, counts, wall, fused2d_down=i, fused2d_up=i,
                   stencil2d_residual=i + 1)
        else:
            record(label, counts, wall, fused2d_down=i + 1,
                   fused2d_up=i + 1, stencil2d_residual=i + 1)
        stats[label]["iters"] = i

    for label, walk in (("ex_fmg", "linear"), ("ex_fmg_cubic", "cubic")):
        (ns, errs), counts, wall, text = run_example(label)
        require(ns == [2 ** k - 1 for k in FMG_RATIO_K],
                f"{label}: grids {ns}")
        for n, err in zip(ns, errs):
            grab(label, rf"^n=\s*{n}  discrete-L2 error={err:.3e}", text)
        # The example's default is float32, whose error sits at float32's
        # rounding floor at these sizes (the ratios near 1; phase 3 holds
        # the float64 ratios): the 1023^2 error is held to fmg1023's.
        yard = runs["fmg1023_err"][(walk, torch.float32, True)]
        ratios = [a / b for a, b in zip(errs, errs[1:])]
        log(f"  {label}: 1023^2 error {errs[-1]:.6e}, fmg1023's "
            f"{yard:.6e}; ratios {[f'{r:.4f}' for r in ratios]}")
        require(abs(errs[-1] - yard) <= EXAMPLE_RTOL * yard,
                f"{label}: 1023^2 error {errs[-1]} against fmg1023's {yard}")
        walks = sum(sum(f[lv:]) for f in (fused(k) for k in FMG_RATIO_K)
                    for lv in range(len(f)))
        record(label, counts, wall, fused2d_down=walks, fused2d_up=walks)
        stats[label]["errors"] = errs

    n = 2 ** EIGEN_K - 1
    exact = 2 * laplacian.eigenvalue_1d(1, n, 1.0 / (n + 1))
    for label, method in (("ex_eigen_ii", "ii"), ("ex_eigen_lobpcg",
                                                  "lobpcg")):
        res, counts, wall, text = run_example(label)
        hist, lam3 = runs[f"eigen511_{method}_plain_run"]
        want = first_below(hist, 1e-7, 1 if method == "lobpcg" else 0)
        lam = res.eigenvalues[0].item()
        grab(label, rf"^n={n}\^2  iters={res.iters}  converged=True$", text)
        grab(label, rf"^  lambda_1 = {lam:.8f}$", text)
        log(f"  {label}: {res.iters} outer steps (eigen511 {method} plain "
            f"reaches 1e-7 at {want}), lambda_1 {lam:.12f}, eigen511's "
            f"{lam3:.12f}, exact {exact:.12f}")
        require(res.converged and res.iters == want,
                f"{label}: {res.iters} outer steps, eigen511's history "
                f"reaches the tolerance at {want}")
        require(abs(lam - lam3) <= EIGEN_RTOL * lam3
                and abs(lam - exact) <= EIGEN_RTOL * exact,
                f"{label}: lambda_1 {lam} against {lam3} (exact {exact})")
        record(label, counts, wall)
        stats[label].update(iters=res.iters, lambda_1=lam)

    res, counts, wall, text = run_example("ex_poisson3d")
    it3, rho3, err3 = runs["solve3d_result"]
    i = res.iters
    rho = mt.convergence_factor(res)
    line = grab("ex_poisson3d", r"^  discrete-L2 error vs analytic: (\S+)",
                text)
    grab("ex_poisson3d", rf"^  iters={i}  converged={res.converged}  "
         rf"rho={rho:.4f}$", text)
    log(f"  ex_poisson3d: {i} cycles (solve3d {it3}), rho {rho:.6f} "
        f"({rho3:.6f}), l2 error {line[1]} ({err3:.6e})")
    require(i == it3 and abs(rho - rho3) <= EXAMPLE_RTOL * rho3,
            f"ex_poisson3d: {i} cycles, rho {rho} against solve3d's {it3}, "
            f"{rho3}")
    same_printed("ex_poisson3d", line[1], err3, ".3e")
    record("ex_poisson3d", counts, wall, stencil3d_rbgs=3 * 4 * i,
           stencil3d_residual=3 * i + i + 1)
    stats["ex_poisson3d"]["iters"] = i

    res, counts, wall, text = run_example("ex_poisson3d_default")
    grab("ex_poisson3d_default", rf"^  iters={res.iters}  converged=True  ",
         text)
    require(res.converged, "ex_poisson3d_default did not converge")
    record("ex_poisson3d_default", counts, wall)
    stats["ex_poisson3d_default"]["iters"] = res.iters

    res, counts, wall, text = run_example("ex_distributed")
    it1, rho1, err1 = runs["S1_result"]
    i = res.iters
    rho = mt.convergence_factor(res)
    line = grab("ex_distributed", rf"^n={2 ** MAIN_K - 1}\^2 on 1 devices "
                rf"\(mesh \(1,\)\): iters={i}  converged={res.converged}  "
                rf"rho={rho:.4f}$", text)
    err = grab("ex_distributed", r"^max error vs analytic solution: (\S+)$",
               text)[1]
    log(f"  ex_distributed: {i} cycles (S1 {it1}), rho {rho:.6f} "
        f"({rho1:.6f}), max error {err} ({err1:.6e})")
    require(i == it1 and abs(rho - rho1) <= EXAMPLE_RTOL * rho1,
            f"ex_distributed: {i} cycles, rho {rho} against S1's {it1}, "
            f"{rho1}")
    same_printed("ex_distributed", err, err1, ".3e")
    dec = sharded.decomp_from_mesh(sharded_mesh((1,)), 2)
    legs1 = leg_levels(SolverConfig(ndim=2, k=MAIN_K, smoother="rbgs",
                                    use_kernels=True), dec)
    record("ex_distributed", counts, wall, plocal2d_down=i, plocal2d_up=i,
           plocal2d_resnorm=i + 1, local2d_down=(legs1 - 1) * i,
           local2d_up=(legs1 - 1) * i)
    stats["ex_distributed"]["iters"] = i

    label = "ex_distributed_eigen"
    with count_level0_calls("_leg_cycle_ext") as cyc:
        res, counts, wall, text = run_example(label)
    c, it = cyc.count, res.iters
    legs = leg_levels(SolverConfig(ndim=2, k=EIGEN_K, smoother="rbgs",
                                   use_kernels=True, agglom_rows=64), dec)
    hist, lam3 = runs["eigen511_ii_kernel_run"]
    want = first_below(hist, 1e-6)
    lam = res.eigenvalues[0].item()
    grab(label, rf"^n={n}\^2 on 1 devices \(mesh \(1,\)\): iters={it} "
         r"converged=True$", text)
    grab(label, r"^eigenvalues: \[\S+\]", text)
    log(f"  {label}: {it} outer steps, {c} cycles on {legs} leg levels "
        f"(eigen511 ii kernel reaches 1e-6 at {want}), lambda_1 "
        f"{lam:.12f} (eigen511's {lam3:.12f}, exact {exact:.12f})")
    require(legs == 2, f"{label}: {legs} leg levels, not 2 (511, 255)")
    require(res.converged and it == want,
            f"{label}: {it} outer steps, eigen511's history reaches the "
            f"tolerance at {want}")
    require(abs(lam - lam3) <= EIGEN_RTOL * lam3
            and abs(lam - exact) <= EIGEN_RTOL * exact,
            f"{label}: lambda_1 {lam} against {lam3} (exact {exact})")
    # The sharded II on an unpacked fine tile (S2eigen's derivation): a
    # cycle runs the local2d legs on each leg level and the local2d
    # residual as its check; A's rows are the local2d residual, 1 before
    # the first step and 2 a step.
    record(label, counts, wall, local2d_down=legs * c, local2d_up=legs * c,
           local2d_residual=c + 2 * it + 1)
    stats[label].update(iters=it, cycles=c, lambda_1=lam)
    log("example launches: " + json.dumps(launches))
    runs["examples_stats"] = stats
    torch.cuda.empty_cache()


def phase_main_path():
    """The slice's paths through the public entry points. Returns, per
    run, its launch counts, and the peak device memory of the solves."""
    runs = {}
    paths_2d(runs)
    start = time.perf_counter()
    paths_utils(runs)
    log(f"utils on the main path: {time.perf_counter() - start:.1f} s")
    paths_composed(runs)
    paths_3d(runs)
    paths_sparse(runs)
    paths_sharded(runs)
    start = time.perf_counter()
    paths_mixed_sharded(runs)
    log(f"sharded mixed-precision paths: {time.perf_counter() - start:.1f} "
        "s")
    start = time.perf_counter()
    paths_fmg(runs)
    paths_eigen(runs)
    paths_sharded_fmg(runs)
    log(f"FMG and eigensolver paths: {time.perf_counter() - start:.1f} s")
    start = time.perf_counter()
    paths_mixed(runs)
    paths_cdt_bf16(runs)
    paths_native_bf16(runs)
    log(f"mixed-precision paths: {time.perf_counter() - start:.1f} s")
    start = time.perf_counter()
    paths_bf16_solves(runs)
    log(f"bfloat16 solves: {time.perf_counter() - start:.1f} s")
    start = time.perf_counter()
    paths_sharded_eigen(runs)
    log(f"sharded eigensolver paths: {time.perf_counter() - start:.1f} s")
    start = time.perf_counter()
    paths_mixed3d(runs)
    log(f"3D mixed-precision paths: {time.perf_counter() - start:.1f} s")
    start = time.perf_counter()
    paths_sharded3d(runs)
    log(f"sharded 3D paths: {time.perf_counter() - start:.1f} s")
    start = time.perf_counter()
    paths_examples(runs)
    log(f"example CLIs: {time.perf_counter() - start:.1f} s")
    return runs


# Readings of a kernel's device time time_pair takes before it falls back
# to the chained events' time.
DEVICE_READS = 3


def time_pair(name: str, kernel, plain, device: bool = True) -> dict:
    """Plain, kernel, kernel, plain: compare within one window (single
    calls, the wrapper's host work inside); with ``device``, also the
    kernels' device time a call of ``kernel`` from the profiler
    (device_ms)."""
    from multigridcmt_tpu_torch.utils.breakdown import device_busy
    from multigridcmt_tpu_torch.utils.profiling import (chained_ms,
                                                       cuda_time_ms)

    p1 = cuda_time_ms(plain)
    k1 = cuda_time_ms(kernel)
    k2 = cuda_time_ms(kernel)
    p2 = cuda_time_ms(plain)
    out = {"ms": min(k1, k2), "plain_ms": min(p1, p2)}
    dev = ""
    if device:
        # The profiler now and then records no kernel in most of a reading's
        # windows (PERF.md §7), which reads 0: read again, and after
        # DEVICE_READS such readings take the chained events' time a call.
        for _ in range(DEVICE_READS):
            out["device_ms"] = device_busy(kernel, LEG_CHAIN)[0]
            if out["device_ms"] > 0:
                break
        else:
            out["device_ms"] = chained_ms(kernel, LEG_CHAIN)
            out["device_note"] = ("the profiler recorded no kernel in "
                                  f"{DEVICE_READS} readings: chained events")
            log(f"  {name}: {out['device_note']}")
        dev = f", device {out['device_ms']:.4f} ms"
    log(f"time {name}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} "
        f"ms{dev}")
    return out


def timed_legs(times: dict) -> None:
    """The row-streaming legs, float32, RB-GS, sigma = 0, at every sweep
    count in LEG_SWEEPS and at the cap: the packed2d legs at 4095^2 and the
    fused2d legs on the unpacked 4095^2 and 2047^2 grids, each as a single
    call (cuda_time_ms, whose start event precedes the wrapper's host work),
    as LEG_CHAIN chained calls and by the kernel's device time a call from
    the profiler (at 2047^2 a chained fused2d leg can read the host's
    launch rate)."""
    from multigridcmt_tpu_torch.kernels import fused2d, packed2d
    from multigridcmt_tpu_torch.utils.breakdown import device_busy
    from multigridcmt_tpu_torch.utils.profiling import (chained_ms,
                                                       cuda_time_ms)

    out = {}
    kw = dict(kind="rbgs", omega=1.0)
    for k in (MAIN_K, MAIN_K - 1):
        n = 2 ** k - 1
        nc = (n - 1) // 2
        h = 1.0 / (n + 1)
        u, b, e = leg_inputs(n, torch.float32, seed=7)
        legs = {
            "fused2d_down": (fused2d.max_down_sweeps("rbgs"), lambda nu: (
                lambda: fused2d.smooth_residual_restrict(
                    u, b, n, h, sweeps=nu, **kw))),
            "fused2d_up": (fused2d.max_up_sweeps("rbgs"), lambda nu: (
                lambda: fused2d.prolong_add_smooth(u, e, b, n, nc, h,
                                                   sweeps=nu, **kw))),
        }
        if k == MAIN_K:
            su, sb = packed2d.pack(u), packed2d.pack(b)
            legs.update({
                "packed2d_down": (packed2d.max_down_sweeps("rbgs"),
                                  lambda nu: (
                    lambda: packed2d.smooth_residual_restrict(
                        su, sb, n, h, sweeps=nu, **kw))),
                "packed2d_up": (packed2d.max_up_sweeps("rbgs"), lambda nu: (
                    lambda: packed2d.prolong_add_smooth(
                        su, e, sb, n, nc, h, sweeps=nu, **kw))),
            })
        for name, (cap, make) in legs.items():
            for nu in sorted({*LEG_SWEEPS, cap}):
                fn = make(nu)
                row = {"single_ms": cuda_time_ms(fn),
                       "chained_ms": chained_ms(fn, LEG_CHAIN),
                       "device_ms": device_busy(fn, LEG_CHAIN)[0]}
                out[f"{name}@{n} nu={nu}"] = row
                log(f"leg {name} n={n} nu={nu}: single "
                    f"{row['single_ms']:.4f} ms, chained x{LEG_CHAIN} "
                    f"{row['chained_ms']:.4f} ms, device "
                    f"{row['device_ms']:.4f} ms")
        del legs, u, b, e
        torch.cuda.empty_cache()
    times["legs"] = out


# Arithmetic each function needs per fine interior point, counted from its
# formula (adds, multiplies, the two halves of an FMA): residual 2D 8, 3D
# 10, the apply (A - sigma I) u 7; a Gauss-Seidel update 2D 6, 3D 8;
# Jacobi 2D 10, 3D 12; a down leg 6 a sweep + 12 (residual and full
# weighting), an up leg 6 a sweep + 3 (prolongation and the add); the
# red-only norm 5 (half the points, square and add). Every kernel row
# computes in float32 (the bfloat16 modes too) and is bound by bytes by a
# wide margin.
def flops_per_point(name: str, sweeps: int = 2) -> int:
    return {"stencil2d_residual": 8, "packed2d_residual": 8,
            "packed2d_resnorm": 5, "stencil3d_residual": 10,
            "stencil3d_jacobi": 12, "stencil3d_rbgs": 8,
            "fused2d_down": 6 * sweeps + 12, "packed2d_down": 6 * sweeps + 12,
            "fused2d_up": 6 * sweeps + 3,
            "packed2d_up": 6 * sweeps + 3,
            "transfer2d_residual_restrict": 12, "transfer2d_prolong_add": 3,
            "stencil2d_rbgs": 6 * sweeps, "packed2d_rbgs": 6 * sweeps,
            "stencil2d_jacobi": 10 * sweeps,
            "local2d_down": 6 * sweeps + 12, "local2d_up": 6 * sweeps + 3,
            "local2d_residual": 8, "local2d_rbgs": 6 * sweeps,
            "local2d_jacobi": 10 * sweeps,
            "plocal2d_down": 6 * sweeps + 12, "plocal2d_up": 6 * sweeps + 3,
            "plocal2d_residual": 8, "plocal2d_apply": 7,
            "plocal2d_resnorm": 5,
            "packed2d_down_bf16": 6 * sweeps + 12,
            "packed2d_up_bf16": 6 * sweeps + 3,
            "packed2d_up_bf16_f32": 6 * sweeps + 3,
            "packed2d_rbgs_bf16": 6 * sweeps, "packed2d_residual_bf16": 8,
            "stencil3d_residual_bf16": 10, "stencil3d_rbgs_bf16": 8,
            "stencil3d_rbgs_bf16_f32": 8, "stencil3d_jacobi_bf16": 12,
            "stencil3d_jacobi_bf16_f32": 12,
            "local2d_down_bf16": 6 * sweeps + 12,
            "local2d_up_bf16": 6 * sweeps + 3,
            "local2d_up_bf16_f32": 6 * sweeps + 3,
            "plocal2d_down_bf16": 6 * sweeps + 12,
            "plocal2d_up_bf16": 6 * sweeps + 3,
            "plocal2d_up_bf16_f32": 6 * sweeps + 3,
            "plocal2d_residual_bf16": 8, "plocal2d_apply_bf16": 7,
            "plocal2d_resnorm_bf16": 5, "packed2d_resnorm_bf16": 5,
            }[name]


def timed_2d(times: dict) -> None:
    from multigridcmt_tpu_torch.kernels import fused2d, packed2d, stencil2d

    kw = dict(kind="rbgs", omega=1.0, sweeps=2)
    unpacked = ("fused2d_down", "fused2d_up", "stencil2d_residual")
    # (n, key suffix, kernels timed): every 2D kernel at 4095, the packed
    # level; the unpacked ones also at 2047, their main-path shape.
    for n, tag, names in ((2 ** MAIN_K - 1, "@4095", None),
                          (2 ** (MAIN_K - 1) - 1, "", unpacked)):
        nc = (n - 1) // 2
        h = 1.0 / (n + 1)
        u, b, e = leg_inputs(n, torch.float32, seed=7)
        su, sb = packed2d.pack(u), packed2d.pack(b)
        rc = torch.empty((nc + 2, nc + 2), device="cuda")
        # name -> (kernel, plain, bytes read once and written once)
        pairs = {
            "fused2d_down": (
                lambda: fused2d.smooth_residual_restrict(u, b, n, h, **kw),
                lambda: fused2d.smooth_residual_restrict_plain(u, b, n, h,
                                                               **kw),
                nbytes(u, b, u, rc)),
            "fused2d_up": (
                lambda: fused2d.prolong_add_smooth(u, e, b, n, nc, h, **kw),
                lambda: fused2d.prolong_add_smooth_plain(u, e, b, n, nc, h,
                                                         **kw),
                nbytes(u, e, b, u)),
            "stencil2d_residual": (
                lambda: stencil2d.residual(u, b, n, h),
                lambda: stencil2d.residual_plain(u, b, n, h),
                nbytes(u, b, u)),
            "stencil2d_residual+norm": (
                lambda: torch.linalg.vector_norm(
                    stencil2d.residual(u, b, n, h)),
                lambda: torch.linalg.vector_norm(
                    stencil2d.residual_plain(u, b, n, h)), None),
            "packed2d_down": (
                lambda: packed2d.smooth_residual_restrict(su, sb, n, h,
                                                          **kw),
                lambda: packed2d.smooth_residual_restrict_plain(
                    su, sb, n, h, **kw), nbytes(su, sb, su, rc)),
            "packed2d_up": (
                lambda: packed2d.prolong_add_smooth(su, e, sb, n, nc, h,
                                                    **kw),
                lambda: packed2d.prolong_add_smooth_plain(
                    su, e, sb, n, nc, h, **kw), nbytes(su, e, sb, su)),
            # Red-only: u's two planes and b's red plane.
            "packed2d_resnorm": (
                lambda: packed2d.residual_norm_sq(su, sb, n, h,
                                                  red_only=True),
                lambda: packed2d.residual_norm_sq_plain(su, sb, n, h,
                                                        red_only=True),
                nbytes(su, sb[0])),
            "packed2d_residual": (
                lambda: packed2d.residual(su, sb, n, h),
                lambda: packed2d.residual_plain(su, sb, n, h),
                nbytes(su, sb, su)),
        }
        for name, (kernel, plain, moved) in pairs.items():
            if names is not None and name not in names:
                continue
            t = time_pair(f"{name} n={n}", kernel, plain)
            if moved is not None:
                t.update(bytes=moved,
                         flops=flops_per_point(name) * n * n)
            times[name + tag] = t
        del pairs, u, b, e, su, sb, rc
    # The four legs at 4095^2 and the fused2d legs at 2047^2 as single
    # calls, as LEG_CHAIN chained calls (the time the packed rows report;
    # the fused2d rows report time_pair's) and by the profiler's kernel
    # time a call, also at nu = 0, 1 and the cap.
    timed_legs(times)
    for name in ("packed2d_down", "packed2d_up", "fused2d_down",
                 "fused2d_up"):
        leg = times["legs"][f"{name}@4095 nu=2"]
        times[name + "@4095"].update(ms=leg["chained_ms"],
                                     single_ms=leg["single_ms"],
                                     device_ms=leg["device_ms"])
    for name in ("fused2d_down", "fused2d_up"):
        leg = times["legs"][f"{name}@{2 ** (MAIN_K - 1) - 1} nu=2"]
        times[name].update(chained_ms=leg["chained_ms"],
                           device_ms=leg["device_ms"])
    log(f"packed against unpacked at 4095^2 (chained): down "
        f"{times['packed2d_down@4095']['ms']:.4f} vs "
        f"{times['fused2d_down@4095']['ms']:.4f} ms, up "
        f"{times['packed2d_up@4095']['ms']:.4f} vs "
        f"{times['fused2d_up@4095']['ms']:.4f} ms, check "
        f"{times['packed2d_resnorm@4095']['ms']:.4f} vs residual+norm "
        f"{times['stencil2d_residual+norm@4095']['ms']:.4f} ms")


def timed_composed(times: dict) -> None:
    """The composed legs' kernels at their main-path shapes (float32,
    sigma = 0): transfer2d at 2047 (residual_restrict also at 1023, 511
    and 255, by device time beside the zero-sweep fused2d down leg, the
    same stream with the store of u', and its bound), then the sweeps
    (timed_sweeps)."""
    import torch.nn.functional as F

    from multigridcmt_tpu_torch.kernels import fused2d, transfer2d
    from multigridcmt_tpu_torch.utils.breakdown import device_busy
    from multigridcmt_tpu_torch.utils.profiling import cuda_time_ms

    levels = {}
    for k in range(MAIN_K - 1, MAIN_K - 5, -1):
        n = 2 ** k - 1
        nc = (n - 1) // 2
        h = 1.0 / (n + 1)
        u, b, _ = leg_inputs(n, torch.float32, seed=11 + k)
        rc = torch.empty((nc + 2, nc + 2), device="cuda")
        rr = lambda: transfer2d.residual_restrict(u, b, n, h)
        down = lambda: fused2d.smooth_residual_restrict(
            u, b, n, h, kind="rbgs", omega=1.0, sweeps=0)
        t = time_pair(f"transfer2d_residual_restrict n={n}", rr,
                      lambda: transfer2d.residual_restrict_plain(u, b, n, h))
        t.update(bytes=nbytes(u, b, rc),
                 flops=flops_per_point("transfer2d_residual_restrict") * n * n)
        row = {"device_ms": t["device_ms"],
               "fused2d_down_nu0_device_ms": device_busy(down, LEG_CHAIN)[0],
               "device_ms_again": device_busy(rr, LEG_CHAIN)[0],
               "bound_ms": t["bytes"] / PEAK_BYTES_PER_S * 1e3,
               "down_bound_ms": nbytes(u, b, u, rc) / PEAK_BYTES_PER_S * 1e3}
        log(f"time residual_restrict n={n}: device {row['device_ms']:.4f}/"
            f"{row['device_ms_again']:.4f} ms, the zero-sweep fused2d down "
            f"leg {row['fused2d_down_nu0_device_ms']:.4f} ms; bound "
            f"{row['bound_ms']:.4f} ms ({row['down_bound_ms']:.4f} with "
            f"u')")
        levels[n] = row
        if k == MAIN_K - 1:
            times["transfer2d_residual_restrict"] = t
        del u, b, rc
    times["residual_restrict_levels"] = levels
    n = 2 ** (MAIN_K - 1) - 1
    nc = (n - 1) // 2
    h = 1.0 / (n + 1)
    u, b, e = leg_inputs(n, torch.float32, seed=11)
    rc = torch.empty((nc + 2, nc + 2), device="cuda")
    t = time_pair(f"transfer2d_prolong_add n={n}",
                  lambda: transfer2d.prolong_add(u, e, n, nc),
                  lambda: transfer2d.prolong_add_plain(u, e, n, nc))
    # The one PyTorch call pair that computes x + P e: P is exact bilinear
    # interpolation with aligned corners (fine i sits at coarse i/2), ghost
    # to ghost.
    t["library_ms"] = cuda_time_ms(lambda: u + F.interpolate(
        e[None, None], size=(n + 2, n + 2), mode="bilinear",
        align_corners=True)[0, 0])
    got = u + F.interpolate(e[None, None], size=(n + 2, n + 2),
                            mode="bilinear", align_corners=True)[0, 0]
    lib_err = rel_err(got, transfer2d.prolong_add(u, e, n, nc))[1]
    log(f"time prolong_add library (add + interpolate): "
        f"{t['library_ms']:.4f} ms, rel diff from the kernel {lib_err:.1e}")
    require(lib_err <= TOL[torch.float32],
            f"interpolate differs from prolong_add by {lib_err}")
    t.update(bytes=nbytes(u, e, u),
             flops=flops_per_point("transfer2d_prolong_add") * n * n)
    times["transfer2d_prolong_add"] = t
    del u, b, e, rc
    timed_sweeps(times)


def timed_sweeps(times: dict) -> None:
    """The row-streaming sweeps, float32, sigma = 0, against their plain
    versions at their main-path shapes (RB-GS 4 sweeps at 2047, path B;
    Jacobi 8 sweeps at 1023, path C; the packed RB-GS 4 sweeps at 4095,
    B), and each as a single call, LEG_CHAIN chained calls and by the
    profiler's device time a call at B's and C's levels (stencil2d RB-GS
    nu = 4 at 2047...255, Jacobi nu = 8 at 1023...255; the packed sweep at
    nu = 4 and 1); and the smoother figure, one packed RB-GS sweep at 4095
    (single call, GB/s and Gnnz/s as bench.py counts them; also by device
    time)."""
    from multigridcmt_tpu_torch.kernels import packed2d, stencil2d
    from multigridcmt_tpu_torch.utils.breakdown import device_busy
    from multigridcmt_tpu_torch.utils.profiling import (chained_ms,
                                                       cuda_time_ms)

    def three(fn):
        return {"single_ms": cuda_time_ms(fn),
                "chained_ms": chained_ms(fn, LEG_CHAIN),
                "device_ms": device_busy(fn, LEG_CHAIN)[0]}

    out = {}
    for k in range(MAIN_K - 1, MAIN_K - 5, -1):
        n = 2 ** k - 1
        h = 1.0 / (n + 1)
        u, b, _ = leg_inputs(n, torch.float32, seed=11 + k)
        # name -> (sweeps, kernel, plain)
        calls = {"stencil2d_rbgs": (
            4, lambda: stencil2d.rbgs_sweep(u, b, n, h, sweeps=4),
            lambda: stencil2d.rbgs_sweep_plain(u, b, n, h, sweeps=4))}
        if k <= PATH_C_K:
            calls["stencil2d_jacobi"] = (
                8, lambda: stencil2d.jacobi_sweep(u, b, n, h, 0.8, sweeps=8),
                lambda: stencil2d.jacobi_sweep_plain(u, b, n, h, 0.8,
                                                     sweeps=8))
        for name, (nu, kernel, plain) in calls.items():
            row = three(kernel)
            out[f"{name}@{n} nu={nu}"] = row
            log(f"sweep {name} n={n} nu={nu}: single {row['single_ms']:.4f} "
                f"ms, chained x{LEG_CHAIN} {row['chained_ms']:.4f} ms, device "
                f"{row['device_ms']:.4f} ms, bound "
                f"{nbytes(u, b, u) / PEAK_BYTES_PER_S * 1e3:.4f} ms")
            if n == 2 ** (MAIN_K - 1) - 1 or (name == "stencil2d_jacobi"
                                              and k == PATH_C_K):
                t = time_pair(f"{name} n={n} nu={nu}", kernel, plain,
                              device=False)
                t.update(bytes=nbytes(u, b, u),
                         flops=flops_per_point(name, nu) * n * n,
                         single_ms=row["single_ms"],
                         chained_ms=row["chained_ms"],
                         device_ms=row["device_ms"])
                times[name] = t
        del u, b, calls
        torch.cuda.empty_cache()

    n = 2 ** MAIN_K - 1
    h = 1.0 / (n + 1)
    u, b, _ = leg_inputs(n, torch.float32, seed=13)
    su, sb = packed2d.pack(u), packed2d.pack(b)
    del u, b
    for nu in (4, 1):
        row = three(lambda: packed2d.rbgs_sweep(su, sb, n, h, sweeps=nu))
        out[f"packed2d_rbgs@{n} nu={nu}"] = row
        log(f"sweep packed2d_rbgs n={n} nu={nu}: single "
            f"{row['single_ms']:.4f} ms, chained x{LEG_CHAIN} "
            f"{row['chained_ms']:.4f} ms, device {row['device_ms']:.4f} ms")
    times["sweeps"] = out
    t = time_pair(f"packed2d_rbgs n={n} nu=4",
                  lambda: packed2d.rbgs_sweep(su, sb, n, h, sweeps=4),
                  lambda: packed2d.rbgs_sweep_plain(su, sb, n, h, sweeps=4),
                  device=False)
    row = out[f"packed2d_rbgs@{n} nu=4"]
    t.update(bytes=nbytes(su, sb, su),
             flops=flops_per_point("packed2d_rbgs", 4) * n * n,
             single_ms=row["single_ms"], chained_ms=row["chained_ms"],
             device_ms=row["device_ms"])
    times["packed2d_rbgs"] = t
    # The smoother figure of bench.py: one packed RB-GS sweep, as GB/s
    # (three packed arrays over the time) and Gnnz/s (2 * 5 n^2 over it),
    # from a single call and from the device time.
    ms = cuda_time_ms(lambda: packed2d.rbgs_sweep(su, sb, n, h, sweeps=1))
    dev = out[f"packed2d_rbgs@{n} nu=1"]["device_ms"]
    gbps = 3 * nbytes(su) / (ms * 1e-3) / 1e9
    gnnz = 2 * 5 * n * n / (ms * 1e-3) / 1e9
    times["smoother"] = {"ms": ms, "gb_per_s": gbps, "gnnz_per_s": gnnz,
                         "device_ms": dev,
                         "device_gb_per_s": 3 * nbytes(su) / (dev * 1e-3)
                         / 1e9,
                         "bound_ms": 3 * nbytes(su) / PEAK_BYTES_PER_S * 1e3}
    log(f"smoother: one packed RB-GS sweep at {n}^2 float32 {ms:.4f} ms, "
        f"{gbps:.1f} GB/s ({100 * gbps * 1e9 / PEAK_BYTES_PER_S:.1f}% of "
        f"3.35 TB/s), {gnnz:.2f} Gnnz/s; device {dev:.4f} ms, "
        f"{times['smoother']['device_gb_per_s']:.1f} GB/s")
    del su, sb
    torch.cuda.empty_cache()


def timed_3d(times: dict) -> None:
    """The stencil3d kernels at 511^3 float32 against their plain versions
    (single calls, in turns), and at 511^3, 255^3 and 127^3 (the 3D
    cycle's kernel levels) single and LEG_CHAIN chained: a row's ms is the
    chained time at 511^3, its single_ms the single one."""
    from multigridcmt_tpu_torch.kernels import stencil3d
    from multigridcmt_tpu_torch.utils.profiling import (chained_ms,
                                                       cuda_time_ms)

    w = omega3()
    # One call = one launch count: the residual, one Jacobi sweep, one
    # RB-GS sweep; each reads u and b and writes one grid.
    kernels3 = (("stencil3d_residual", "residual", {}),
                ("stencil3d_jacobi", "jacobi_sweep", dict(omega=w)),
                ("stencil3d_rbgs", "rbgs_sweep", {}))
    levels = {}
    for k in range(MAIN_K3, MAIN_K3 - 3, -1):
        n = 2 ** k - 1
        h = 1.0 / (n + 1)
        u, b = cube_inputs(n, torch.float32, seed=k)
        for name, mode, kw in kernels3:
            fn = functools.partial(getattr(stencil3d, mode), u, b, n, h, **kw)
            row = {"single_ms": cuda_time_ms(fn),
                   "chained_ms": chained_ms(fn, LEG_CHAIN),
                   "bound_ms": nbytes(u, b, u) / PEAK_BYTES_PER_S * 1e3}
            levels[f"{name}@{n}"] = row
            log(f"{name} n={n}: single {row['single_ms']:.4f} ms, chained "
                f"x{LEG_CHAIN} {row['chained_ms']:.4f} ms, bound "
                f"{row['bound_ms']:.4f} ms")
            if k == MAIN_K3:
                t = time_pair(
                    f"{name} n={n}", fn,
                    lambda: getattr(stencil3d, mode + "_plain")(u, b, n, h,
                                                                **kw))
                t.update(single_ms=t["ms"], ms=row["chained_ms"],
                         bytes=nbytes(u, b, u),
                         flops=flops_per_point(name) * n ** 3)
                times[name] = t
        del u, b
        torch.cuda.empty_cache()
    times["stencil3d_levels"] = levels


def timed_solves(times: dict) -> None:
    """One V(2,2) cycle at 4095^2 and 511^3 float32 on both routes, and one
    PCG iteration at 4095^2 (the difference of 6 and 2 iterations with
    tol = 0, so neither stops early, over 4: a spread of one iteration
    drowned in the host's noise and once read negative)."""
    import multigridcmt_tpu_torch as mt
    from multigridcmt_tpu_torch.solvers import krylov
    from multigridcmt_tpu_torch.utils.profiling import cuda_time_ms

    for label, ndim, k in (("", 2, MAIN_K), ("3d", 3, MAIN_K3)):
        for use_kernels in (True, False):
            prob = mt.poisson(k=k, ndim=ndim, dtype=torch.float32,
                              smoother="rbgs", use_kernels=use_kernels,
                              device="cuda")
            solver = mt.MultigridSolver(prob)
            x = torch.zeros_like(prob.b)
            key = "cycle" + label + ("" if use_kernels else "_plain")
            times[key] = cuda_time_ms(lambda: solver.v_cycle(x, prob.b))
            del prob, solver, x
        log(f"time V(2,2) cycle {ndim}D k={k} float32: kernel path "
            f"{times['cycle' + label]:.3f} ms, plain path "
            f"{times['cycle' + label + '_plain']:.3f} ms")
        torch.cuda.empty_cache()
    # The composed cycles at 4095^2: Chebyshev V(2,2) (path A) and RB-GS
    # V(4,4) (path B).
    for label, kw in (("cheb", dict(smoother="chebyshev")),
                      ("rbgs44", dict(smoother="rbgs", nu1=4, nu2=4))):
        for use_kernels in (True, False):
            prob = mt.poisson2d(k=MAIN_K, dtype=torch.float32,
                                use_kernels=use_kernels, device="cuda", **kw)
            solver = mt.MultigridSolver(prob)
            x = torch.zeros_like(prob.b)
            key = f"cycle_{label}" + ("" if use_kernels else "_plain")
            times[key] = cuda_time_ms(lambda: solver.v_cycle(x, prob.b))
            del prob, solver, x
        log(f"time {label} cycle 2D k={MAIN_K} float32: kernel path "
            f"{times['cycle_' + label]:.3f} ms, plain path "
            f"{times['cycle_' + label + '_plain']:.3f} ms")
        torch.cuda.empty_cache()
    prob = mt.poisson2d(k=MAIN_K, dtype=torch.float32, smoother="rbgs",
                        use_kernels=True, device="cuda")
    pcg = {}
    for iters in (2, 6):
        cfg = dataclasses.replace(prob.config, tol=0.0, max_iters=iters)
        pcg[iters] = cuda_time_ms(
            lambda: krylov.solve_pcg(prob.hierarchy, prob.b, cfg))
    times["pcg_iter"] = (pcg[6] - pcg[2]) / 4
    log(f"time PCG k={MAIN_K} float32: 2 iterations {pcg[2]:.3f} ms, 6 "
        f"iterations {pcg[6]:.3f} ms, one iteration {times['pcg_iter']:.3f}"
        " ms")


def dia_to_torch_csr(a) -> torch.Tensor:
    """The DIA matrix as a torch sparse CSR tensor (int32 indices), built
    on the card; the yardstick's operand, never used by the port."""
    n = a.shape[0]
    i = torch.arange(n, device=a.diags.device)
    rows, cols, vals = [], [], []
    for k, off in enumerate(a.offsets):
        keep = a.diags[k] != 0
        rows.append(i[keep])
        cols.append(i[keep] + off)
        vals.append(a.diags[k][keep])
    r, c, v = torch.cat(rows), torch.cat(cols), torch.cat(vals)
    order = torch.argsort(r * n + c)
    crow = torch.zeros(n + 1, dtype=torch.int64, device=a.diags.device)
    crow[1:] = torch.cumsum(torch.bincount(r, minlength=n), 0)
    return torch.sparse_csr_tensor(crow.to(torch.int32),
                                   c[order].to(torch.int32), v[order],
                                   size=(n, n))


def timed_sparse(times: dict) -> None:
    """The SpMV figure: one DIA apply at 4095^2 and 255^3 float32, as 20
    chained applies over 20 (bench_spmv.py:84-91), beside 20 plain applies
    and torch.mv and torch.sparse.mm of the same operator as CSR
    (cuSPARSE); and the BELL figure at the bench shape, beside the plain
    version and torch.sparse.mm of the same matrix as (128, 128)-block
    BSR."""
    import numpy as np
    import torch.nn.functional as F

    from multigridcmt_tpu_torch.kernels import bell, spmv
    from multigridcmt_tpu_torch.utils.profiling import cuda_time_ms

    for ndim, n, _ in SPMV_SIZES:
        a, pk = dia_on_card(n, ndim, torch.float32, h=1.0)
        x = vector_on_card(a.shape[0], torch.float32, 200 + n)
        xp = spmv.pack_x(x, pk.halo)

        def chain(apply):
            v = xp
            for _ in range(SPMV_CHAIN):
                v = apply(pk, v)
            return v

        t = time_pair(f"spmv_dia {ndim}D n={n}, {SPMV_CHAIN} chained",
                      lambda: chain(spmv.spmv_packed),
                      lambda: chain(spmv.spmv_packed_plain))
        t = {key: v / SPMV_CHAIN for key, v in t.items()}
        # Two library calls on the CSR: torch.mv (cuSPARSE SpMV) and
        # torch.sparse.mm with a one-column matrix (cuSPARSE SpMM); the
        # faster is the yardstick.
        csr = dia_to_torch_csr(a)
        xcol = x[:, None].contiguous()
        y_ref = spmv.spmv_dia(a, x)
        lib = {"mv": lambda: torch.mv(csr, x),
               "sparse.mm": lambda: torch.sparse.mm(csr, xcol)[:, 0]}
        lib_ms = {}
        for key, call in lib.items():
            lib_ms[key] = cuda_time_ms(call)
            lib_rel = rel_err(call(), y_ref)[1]
            require(lib_rel <= TOL[torch.float32],
                    f"CSR torch.{key} differs from the kernel by {lib_rel}")
        t["library_ms"] = min(lib_ms.values())
        nnz = a.nnz
        moved = nbytes(pk.diags, xp, xp)
        sec = t["ms"] * 1e-3
        fig = {"n": n, "ndim": ndim, "nnz": nnz, "ms": t["ms"],
               "plain_ms": t["plain_ms"], "library_ms": t["library_ms"],
               "csr_mv_ms": lib_ms["mv"],
               "csr_sparse_mm_ms": lib_ms["sparse.mm"],
               "gnnz_per_s": nnz / sec / 1e9,
               "gb_per_s": moved / sec / 1e9,
               "roofline_share": moved / sec / PEAK_BYTES_PER_S,
               "bound_ms": moved / PEAK_BYTES_PER_S * 1e3}
        log(f"SpMV figure {ndim}D n={n} float32: {t['ms']:.4f} ms an apply, "
            f"{fig['gnnz_per_s']:.1f} Gnnz/s, {fig['gb_per_s']:.1f} GB/s "
            f"({100 * fig['roofline_share']:.1f}% of 3.35 TB/s; bound "
            f"{fig['bound_ms']:.4f} ms); plain {t['plain_ms']:.4f} ms; "
            f"CSR torch.mv {lib_ms['mv']:.4f} ms, torch.sparse.mm (one "
            f"column) {lib_ms['sparse.mm']:.4f} ms")
        times["spmv_figure" if ndim == 2 else "spmv_figure3d"] = fig
        if ndim == 2:
            t.update(bytes=moved, flops=2 * nnz)
            times["spmv_dia"] = t
        del a, pk, x, xp, csr, xcol
        torch.cuda.empty_cache()

    a_sp, ab, xt = bell_bench()
    yt = bell.spmm(ab, xt)
    t = time_pair(f"bell_spmm bench kmax={ab.kmax} m={BELL_M}",
                  lambda: bell.spmm(ab, xt), lambda: bell.spmm_plain(ab, xt))
    # int32 indices, as SciPy makes them: with int64 indices the same call
    # took ~4.6x as long on an H100 80GB HBM3 at 700 W (9.32 against 2.04
    # ms).
    bsr_h = a_sp.tobsr(blocksize=(128, 128))
    bsr = torch.sparse_bsr_tensor(
        torch.from_numpy(bsr_h.indptr.astype(np.int32)).cuda(),
        torch.from_numpy(bsr_h.indices.astype(np.int32)).cuda(),
        torch.from_numpy(bsr_h.data).cuda(), size=a_sp.shape)
    x_cols = xt.T.contiguous()
    t["library_ms"] = cuda_time_ms(lambda: torch.sparse.mm(bsr, x_cols))
    lib_rel = rel_err(torch.sparse.mm(bsr, x_cols).T,
                      yt[:, :a_sp.shape[0]])[1]
    require(lib_rel <= TOL[torch.float32],
            f"BSR torch.sparse.mm differs from the kernel by {lib_rel}")
    # The bound counts the populated blocks only: the zero padding blocks
    # (kmax per block row less the populated ones) need no work, and a
    # kernel could skip them. Bytes: the populated blocks and their column
    # indices, Xt and Yt.
    blocks = int(bsr_h.indices.shape[0])
    blk = ab.data.shape[-1]
    flops = 2 * blocks * blk * blk * BELL_M
    moved = (blocks * (blk * blk * ab.data.element_size()
                       + ab.cols.element_size()) + nbytes(xt, yt))
    # The bench's own figure (bench_spmv.py): every stored block, padding
    # included, over the time.
    dense_flops = 2 * ab.n_stored * BELL_M
    sec = t["ms"] * 1e-3
    streamed = 4 * (ab.n_stored + 2 * BELL_M * xt.shape[1])
    t.update(bytes=moved, flops=flops)
    times["bell_spmm"] = t
    fig = {
        "ms": t["ms"], "plain_ms": t["plain_ms"],
        "library_ms": t["library_ms"], "kmax": ab.kmax,
        "blocks": blocks, "n_stored": ab.n_stored, "nnz": ab.nnz_scalar,
        "m": BELL_M, "tflop_per_s": flops / sec / 1e12,
        "bench_dense_block_tflop_per_s": dense_flops / sec / 1e12,
        "gnnz_vec_per_s": ab.nnz_scalar * BELL_M / sec / 1e9,
        "gb_per_s": streamed / sec / 1e9,
        "bound_ms": max(flops / PEAK_F32_FLOPS,
                        moved / PEAK_BYTES_PER_S) * 1e3}
    fig["bound_share"] = fig["bound_ms"] / t["ms"]
    fig["device_ms"] = t["device_ms"]
    fig["device_bound_share"] = fig["bound_ms"] / t["device_ms"]
    times["bell_figure"] = fig
    log(f"BELL figure float32: {t['ms']:.4f} ms, {fig['tflop_per_s']:.2f} "
        f"TFLOP/s on the {blocks} populated blocks "
        f"({fig['bench_dense_block_tflop_per_s']:.2f} dense-block, the "
        f"bench's figure), {fig['gnnz_vec_per_s']:.1f} Gnnz*vec/s, "
        f"{fig['gb_per_s']:.1f} GB/s streamed; bound "
        f"{fig['bound_ms']:.4f} ms (operations, "
        f"{100 * fig['bound_share']:.1f}% of it); plain "
        f"{t['plain_ms']:.4f} ms; torch.sparse.mm BSR (128, 128) "
        f"{t['library_ms']:.4f} ms (rel diff {lib_rel:.1e})")
    # The m = 8 carrier (bell.spmv: row 0 of an 8-row Xt live), by device
    # time: its bound is the bytes of every stored block (a kernel must
    # read a block to know it is zero), the carrier and the result.
    x = xt[0]
    y = bell.spmv(ab, x)
    t8 = time_pair(f"bell spmv carrier m=8 kmax={ab.kmax}",
                   lambda: bell.spmv(ab, x), lambda: bell.spmm_plain(
                       ab, F.pad(x[None], (0, 0, 0, 7))))
    moved8 = nbytes(ab.data, ab.cols) + 8 * nbytes(x) + 8 * nbytes(yt[0])
    flops8 = 2 * blocks * blk * blk * 8
    t8.update(bound_ms=max(moved8 / PEAK_BYTES_PER_S,
                           flops8 / PEAK_F32_FLOPS) * 1e3,
              bound_by="bytes (every stored block)")
    t8["bound_share"] = t8["bound_ms"] / t8["device_ms"]
    times["bell_carrier"] = t8
    log(f"BELL carrier m=8 float32: device {t8['device_ms']:.4f} ms, bound "
        f"{t8['bound_ms']:.4f} ms ({100 * t8['bound_share']:.1f}% of it); "
        f"single {t8['ms']:.4f} ms, plain {t8['plain_ms']:.4f} ms")
    del yt, y, x, bsr, x_cols
    torch.cuda.empty_cache()


def timed_sharded(times: dict) -> None:
    """One sharded V(2,2) RB-GS cycle at S1 and S2 (``v_cycle_fn``: owned
    tiles in and out; it runs the unpacked legs at any PACK_MIN_N, as JAX's
    per-application entry does) beside the single-device cycle at the same
    k, in turns; each local2d kernel at S1's fine tile (4112 x 4097
    float32, a mesh of 1) against its plain version; and the local2d legs'
    device time a call (RB-GS nu = 2) at S1's 4095 and 2047 tiles and at
    S2's 2047^2 block tile."""
    import multigridcmt_tpu_torch as mt
    from multigridcmt_tpu_torch.kernels import local2d
    from multigridcmt_tpu_torch.parallel import sharded
    from multigridcmt_tpu_torch.utils.breakdown import device_busy
    from multigridcmt_tpu_torch.utils.profiling import cuda_time_ms

    for label in ("S1", "S2"):
        k, shape, kw = SHARDED_PATHS[label]
        prob = mt.poisson2d(k=k, dtype=torch.float32, use_kernels=True,
                            device="cuda", **kw)
        solver = sharded.ShardedSolver(prob.config, sharded_mesh(shape))
        cycle = solver.v_cycle_fn()
        b_t = sharded.shard_rhs(prob.b, solver.mesh, solver.decomp)
        x_t = torch.zeros_like(b_t)
        single = mt.MultigridSolver(prob)
        x = torch.zeros_like(prob.b)
        t = time_pair(f"cycle {label} k={k} mesh {shape}: sharded "
                      "(kernel), single device (plain)",
                      lambda: cycle(x_t, b_t),
                      lambda: single.v_cycle(x, prob.b), device=False)
        times["cycle_" + label] = {"sharded_ms": t["ms"],
                                   "single_ms": t["plain_ms"]}
        del prob, solver, b_t, x_t, single, x
        torch.cuda.empty_cache()

    n = 2 ** MAIN_K - 1
    h = 1.0 / (n + 1)
    ue, be, e, t = local2d_tile(n, torch.float32, seed=21)
    m, offs = t["m"], (t["row_off"], t["col_off"])
    rc = torch.empty_like(e)
    kw = dict(kind="rbgs", omega=1.0, sweeps=2)
    nc = (n - 1) // 2
    # name -> (kernel, plain, bytes read once and written once, sweeps)
    pairs = {
        "local2d_down": (
            lambda: local2d.down_leg(ue, be, n, h, m, *offs, **kw),
            lambda: local2d.down_leg_plain(ue, be, n, h, m, *offs, **kw),
            nbytes(ue, be, ue, rc), 2),
        "local2d_up": (
            lambda: local2d.up_leg(ue, e, be, n, nc, h, m, *offs, **kw),
            lambda: local2d.up_leg_plain(ue, e, be, n, nc, h, m, *offs,
                                         **kw), nbytes(ue, e, be, ue), 2),
        "local2d_residual": (
            lambda: local2d.residual(ue, be, n, h, *offs),
            lambda: local2d.residual_plain(ue, be, n, h, *offs),
            nbytes(ue, be, ue), 0),
        "local2d_rbgs": (
            lambda: local2d.rbgs_sweep(ue, be, n, h, *offs, sweeps=4),
            lambda: local2d.rbgs_sweep_plain(ue, be, n, h, *offs, sweeps=4),
            nbytes(ue, be, ue), 4),
        "local2d_jacobi": (
            lambda: local2d.jacobi_sweep(ue, be, n, h, 0.8, *offs, sweeps=8),
            lambda: local2d.jacobi_sweep_plain(ue, be, n, h, 0.8, *offs,
                                               sweeps=8),
            nbytes(ue, be, ue), 8),
    }
    for name, (kernel, plain, moved, sweeps) in pairs.items():
        tt = time_pair(f"{name} {tuple(ue.shape)} nu={sweeps}", kernel,
                       plain)
        tt.update(bytes=moved, flops=flops_per_point(name, sweeps) * n * n)
        times[name] = tt
    del ue, be, e, rc, pairs
    torch.cuda.empty_cache()

    legs = {}
    for label, k, ranks in (("S1 4095", MAIN_K, (1, 0)),
                            ("S1 2047", MAIN_K - 1, (1, 0)),
                            ("S2 block", SHARDED_PATHS["S2"][0], (1, 1))):
        n = 2 ** k - 1
        h, nc = 1.0 / (n + 1), (n - 1) // 2
        ue, be, e, t = local2d_tile(n, torch.float32, seed=22, ranks=ranks)
        m, offs = t["m"], (t["row_off"], t["col_off"])
        kw.update(mcol=t["mcol"])
        for leg, fn in (
                ("down", lambda: local2d.down_leg(ue, be, n, h, m, *offs,
                                                  **kw)),
                ("up", lambda: local2d.up_leg(ue, e, be, n, nc, h, m, *offs,
                                              **kw))):
            key = f"local2d_{leg}@{label} {tuple(ue.shape)}"
            legs[key] = device_busy(fn, LEG_CHAIN)[0]
            log(f"leg {key} nu=2: device {legs[key]:.4f} ms")
        del ue, be, e
        torch.cuda.empty_cache()
    times["local2d_legs"] = legs

    # The sweeps as S3 and S4 run them, on rank 0's tile of a row mesh of 1
    # at each of their levels: RB-GS nu = 4 at 2047...255, Jacobi nu = 8 at
    # 1023...255; device time a call beside the bound (u, b in, u' out).
    sweeps = {}
    for k in range(SHARDED_PATHS["S3"][0], SHARDED_PATHS["S3"][0] - 4, -1):
        n = 2 ** k - 1
        h = 1.0 / (n + 1)
        ue, be, _, t = local2d_tile(n, torch.float32, seed=23)
        offs = (t["row_off"], t["col_off"])
        calls = {"local2d_rbgs nu=4": lambda: local2d.rbgs_sweep(
            ue, be, n, h, *offs, sweeps=4)}
        if k <= SHARDED_PATHS["S4"][0]:
            calls["local2d_jacobi nu=8"] = lambda: local2d.jacobi_sweep(
                ue, be, n, h, 0.8, *offs, sweeps=8)
        bound = nbytes(ue, be, ue) / PEAK_BYTES_PER_S * 1e3
        for name, fn in calls.items():
            key = f"{name}@{n} {tuple(ue.shape)}"
            sweeps[key] = {"device_ms": device_busy(fn, LEG_CHAIN)[0],
                           "bound_ms": bound}
            log(f"sweep {key}: device {sweeps[key]['device_ms']:.4f} ms, "
                f"bound {bound:.4f} ms")
        del ue, be, calls
        torch.cuda.empty_cache()
    times["local2d_sweeps"] = sweeps


def timed_mixed_sharded(times: dict) -> None:
    """The local2d and plocal2d legs' bfloat16 modes on S1's fine tile
    (4112 x 4097 unpacked, 2 x 4112 x 2049 packed), RB-GS nu = 2, sigma =
    0, each against its plain version in turns (single calls), as LEG_CHAIN
    chained calls and by the profiler's device time a call, beside its
    float32 twin on the same values (chained and device) and its bound at
    bfloat16 bytes; and at each MIXED_SHARDED path, one preconditioning
    cycle as sharded MG-PCG runs it (the fine level's carried tile, from
    zero) with a bfloat16 and a float32 fine level: device busy, ops, idle
    share, and a PCG solve's wall."""
    import multigridcmt_tpu_torch as mt
    from multigridcmt_tpu_torch import kernels
    from multigridcmt_tpu_torch.kernels import local2d, plocal2d
    from multigridcmt_tpu_torch.parallel import sharded
    from multigridcmt_tpu_torch.utils.breakdown import device_busy
    from multigridcmt_tpu_torch.utils.profiling import (chained_ms,
                                                       cuda_time_ms)

    bf, f32 = torch.bfloat16, torch.float32
    n = 2 ** MAIN_K - 1
    h, nc = 1.0 / (n + 1), (n - 1) // 2
    ue, be, e, t = local2d_tile(n, f32, seed=24)
    m, offs = t["m"], (t["row_off"], t["col_off"])
    rc = torch.empty_like(e)
    kw = dict(kind="rbgs", omega=1.0, sweeps=2)
    for mod in (local2d, plocal2d):
        name = mod.__name__.split(".")[-1]
        su, sb = ue.to(bf), be.to(bf)
        if mod is plocal2d:
            su, sb = plocal2d.pack_ext(su, 0), plocal2d.pack_ext(sb, 0)
        fu, fb = su.float(), sb.float()
        # name -> (kernel, plain, float32 twin on (u, b), bytes read once
        # and written once)
        cases = {
            f"{name}_down_bf16": (
                lambda: mod.down_leg(su, sb, n, h, m, *offs, **kw),
                lambda: mod.down_leg_plain(su, sb, n, h, m, *offs, **kw),
                lambda u, b: mod.down_leg(u, b, n, h, m, *offs, **kw),
                nbytes(su, sb, su, rc)),
            f"{name}_up_bf16_f32": (
                lambda: mod.up_leg(su, e, sb, n, nc, h, m, *offs,
                                   out_dtype=f32, **kw),
                lambda: mod.up_leg_plain(su, e, sb, n, nc, h, m, *offs,
                                         out_dtype=f32, **kw),
                lambda u, b: mod.up_leg(u, e, b, n, nc, h, m, *offs, **kw),
                nbytes(su, sb, e, fu)),
            f"{name}_up_bf16": (
                lambda: mod.up_leg(su, e, sb, n, nc, h, m, *offs, **kw),
                lambda: mod.up_leg_plain(su, e, sb, n, nc, h, m, *offs,
                                         **kw),
                lambda u, b: mod.up_leg(u, e, b, n, nc, h, m, *offs, **kw),
                nbytes(su, sb, e, su)),
        }
        for key, (kernel, plain, twin, nb) in cases.items():
            pair = time_pair(f"{key} {tuple(su.shape)} nu=2", kernel, plain)
            row = {"ms": chained_ms(kernel, LEG_CHAIN),
                   "single_ms": pair["ms"], "plain_ms": pair["plain_ms"],
                   "device_ms": pair["device_ms"],
                   "f32_chained_ms": chained_ms(lambda: twin(fu, fb),
                                                LEG_CHAIN),
                   "f32_device_ms": device_busy(lambda: twin(fu, fb),
                                                LEG_CHAIN)[0],
                   "bytes": nb, "flops": flops_per_point(key) * n * n}
            row["chained_ms"] = row["ms"]
            log(f"bf16 {key} {tuple(su.shape)} nu=2: chained x{LEG_CHAIN} "
                f"{row['ms']:.4f} ms, device {row['device_ms']:.4f} ms; "
                f"float32 twin chained {row['f32_chained_ms']:.4f} ms, "
                f"device {row['f32_device_ms']:.4f} ms; bound "
                f"{nb / PEAK_BYTES_PER_S * 1e3:.4f} ms")
            times[key] = row
        del su, sb, fu, fb, cases
    del ue, be, e, rc
    torch.cuda.empty_cache()

    out = {}
    saved = kernels.PACK_MIN_N
    try:
        for label, (path, pack_min_n, _) in MIXED_SHARDED.items():
            kernels.PACK_MIN_N = saved if pack_min_n is None else pack_min_n
            k, shape, cfg = SHARDED_PATHS[path]
            prob = mt.poisson2d(k=k, dtype=f32, use_kernels=True,
                                device="cuda", **cfg)
            mesh = sharded_mesh(shape)
            solver = sharded.ShardedSolver(prob.config, mesh)
            b_t = sharded.shard_rhs(prob.b, mesh, solver.decomp)
            tiles = sharded._Carried(prob.config, solver.decomp, b_t)
            re = tiles.enter(b_t)
            row = {}
            for pd in (f32, bf):
                rp = re.to(pd)

                def cycle():
                    return sharded._leg_cycle_ext(
                        prob.hierarchy, prob.config, solver.decomp,
                        torch.zeros_like(rp), rp, 0, 1, 0.0, fresh=True,
                        out_dtype=None if pd == f32 else f32)

                busy, ops, _ = device_busy(cycle, 5)
                cycle_ms = cuda_time_ms(cycle)
                run = sharded.ShardedSolver(dataclasses.replace(
                    prob.config, precond_dtype=pd), mesh)
                pcg_ms = cuda_time_ms(lambda: run.solve(prob.b,
                                                        method="pcg"),
                                      reps=3, warmup=1)
                row[str(pd).split(".")[-1]] = {
                    "cycle_ms": cycle_ms, "busy_ms": busy, "ops": ops,
                    "idle": 1.0 - busy / cycle_ms, "pcg_ms": pcg_ms}
            log(f"mixed sharded {label}: " + json.dumps(row))
            out[label] = row
            del prob, solver, b_t, tiles, re, rp, run
            torch.cuda.empty_cache()
    finally:
        kernels.PACK_MIN_N = saved
    times["mixed_sharded_cycles"] = out


def timed_chains(times: dict) -> None:
    """One S1 cycle as v_cycles_fn runs it (CHAIN_CYCLES chained cycles over
    CHAIN_CYCLES, CUDA events, median of 5): packed (the default
    PACK_MIN_N) and unpacked (PACK_MIN_N above 4095), in turns."""
    import multigridcmt_tpu_torch as mt
    from multigridcmt_tpu_torch import kernels
    from multigridcmt_tpu_torch.parallel import sharded
    from multigridcmt_tpu_torch.utils.profiling import cuda_time_ms

    k, shape, kw = SHARDED_PATHS["S1"]
    prob = mt.poisson2d(k=k, dtype=torch.float32, use_kernels=True,
                        device="cuda", **kw)
    solver = sharded.ShardedSolver(prob.config, sharded_mesh(shape))
    b_t = sharded.shard_rhs(prob.b, solver.mesh, solver.decomp)
    x_t = torch.zeros_like(b_t)
    many = solver.v_cycles_fn()
    saved = kernels.PACK_MIN_N

    def chain(pack_min_n):
        # v_cycles_fn reads PACK_MIN_N when called.
        kernels.PACK_MIN_N = pack_min_n
        try:
            return many(x_t, b_t, CHAIN_CYCLES)
        finally:
            kernels.PACK_MIN_N = saved

    got = {"packed": [], "unpacked": []}
    for route in ("packed", "unpacked", "unpacked", "packed"):
        pmin = saved if route == "packed" else 2 ** MAIN_K
        got[route].append(cuda_time_ms(lambda: chain(pmin), reps=5,
                                       warmup=1) / CHAIN_CYCLES)
    times["cycle_S1_chain"] = {"packed_ms": min(got["packed"]),
                               "unpacked_ms": min(got["unpacked"])}
    log(f"time S1 cycle in a chain of {CHAIN_CYCLES} (v_cycles_fn): packed "
        f"{got['packed'][0]:.3f}/{got['packed'][1]:.3f} ms, unpacked "
        f"{got['unpacked'][0]:.3f}/{got['unpacked'][1]:.3f} ms")
    del prob, solver, b_t, x_t
    torch.cuda.empty_cache()


def timed_plocal2d(times: dict) -> None:
    """Each plocal2d kernel at S1's packed fine tile (2 x 4112 x 2049
    float32, RB-GS nu = 2, sigma = 0) against its plain version and, for
    the legs and the residual, beside its local2d twin on the same
    unpacked tile; the apply beside the plocal2d residual. The legs, as
    timed_legs times the packed2d ones, single, LEG_CHAIN chained and by
    the profiler's device time at every sweep count in LEG_SWEEPS and at
    the cap, their local2d twins beside them; their rows report the chained
    time at nu = 2."""
    from multigridcmt_tpu_torch.kernels import local2d, plocal2d
    from multigridcmt_tpu_torch.utils.breakdown import device_busy
    from multigridcmt_tpu_torch.utils.profiling import (chained_ms,
                                                       cuda_time_ms)

    n = 2 ** MAIN_K - 1
    h = 1.0 / (n + 1)
    ue, be, e, t = local2d_tile(n, torch.float32, seed=23)
    m, offs = t["m"], (t["row_off"], t["col_off"])
    su, sb = plocal2d.pack_ext(ue, 0), plocal2d.pack_ext(be, 0)
    rc = torch.empty_like(e)
    kw = dict(kind="rbgs", omega=1.0, sweeps=2)
    nc = (n - 1) // 2
    # name -> (kernel, plain, local2d twin or None, bytes read once and
    # written once)
    pairs = {
        "plocal2d_down": (
            lambda: plocal2d.down_leg(su, sb, n, h, m, *offs, **kw),
            lambda: plocal2d.down_leg_plain(su, sb, n, h, m, *offs, **kw),
            lambda: local2d.down_leg(ue, be, n, h, m, *offs, **kw),
            nbytes(su, sb, su, rc)),
        "plocal2d_up": (
            lambda: plocal2d.up_leg(su, e, sb, n, nc, h, m, *offs, **kw),
            lambda: plocal2d.up_leg_plain(su, e, sb, n, nc, h, m, *offs,
                                          **kw),
            lambda: local2d.up_leg(ue, e, be, n, nc, h, m, *offs, **kw),
            nbytes(su, e, sb, su)),
        "plocal2d_residual": (
            lambda: plocal2d.residual(su, sb, n, h, *offs),
            lambda: plocal2d.residual_plain(su, sb, n, h, *offs),
            lambda: local2d.residual(ue, be, n, h, *offs),
            nbytes(su, sb, su)),
        "plocal2d_apply": (
            lambda: plocal2d.apply_op(su, n, h, *offs),
            lambda: plocal2d.apply_op_plain(su, n, h, *offs), None,
            nbytes(su, su)),
        # Red only, as after each cycle: u's two planes and b's red one.
        "plocal2d_resnorm": (
            lambda: plocal2d.residual_norm_sq(su, sb, n, h, m, *offs,
                                              red_only=True),
            lambda: plocal2d.residual_norm_sq_plain(su, sb, n, h, m, *offs,
                                                    red_only=True), None,
            nbytes(su, sb[0])),
    }
    for name, (kernel, plain, twin, moved) in pairs.items():
        tt = time_pair(f"{name} {tuple(su.shape)} nu=2", kernel, plain)
        tt.update(bytes=moved, flops=flops_per_point(name) * n * n)
        if twin is not None:
            tt["local2d_ms"] = cuda_time_ms(twin)
            log(f"  {name} beside its local2d twin: {tt['ms']:.4f} vs "
                f"{tt['local2d_ms']:.4f} ms")
        times[name] = tt
    log(f"  apply_op {times['plocal2d_apply']['ms']:.4f} ms beside the "
        f"plocal2d residual {times['plocal2d_residual']['ms']:.4f} ms")

    legs = {
        "plocal2d_down": lambda nu: (
            lambda: plocal2d.down_leg(su, sb, n, h, m, *offs, kind="rbgs",
                                      omega=1.0, sweeps=nu)),
        "local2d_down": lambda nu: (
            lambda: local2d.down_leg(ue, be, n, h, m, *offs, kind="rbgs",
                                     omega=1.0, sweeps=nu)),
        "plocal2d_up": lambda nu: (
            lambda: plocal2d.up_leg(su, e, sb, n, nc, h, m, *offs,
                                    kind="rbgs", omega=1.0, sweeps=nu)),
        "local2d_up": lambda nu: (
            lambda: local2d.up_leg(ue, e, be, n, nc, h, m, *offs,
                                   kind="rbgs", omega=1.0, sweeps=nu)),
    }
    cap = local2d.max_down_sweeps("rbgs")
    out = {}
    for nu in sorted({*LEG_SWEEPS, cap}):
        for name, make in legs.items():
            fn = make(nu)
            row = {"single_ms": cuda_time_ms(fn),
                   "chained_ms": chained_ms(fn, LEG_CHAIN),
                   "device_ms": device_busy(fn, LEG_CHAIN)[0]}
            out[f"{name}@S1 nu={nu}"] = row
            log(f"leg {name} S1 tile nu={nu}: single "
                f"{row['single_ms']:.4f} ms, chained x{LEG_CHAIN} "
                f"{row['chained_ms']:.4f} ms, device "
                f"{row['device_ms']:.4f} ms")
    times["tile_legs"] = out
    for name in ("plocal2d_down", "plocal2d_up"):
        leg = out[f"{name}@S1 nu=2"]
        times[name].update(ms=leg["chained_ms"], single_ms=leg["single_ms"],
                           device_ms=leg["device_ms"])
    del ue, be, e, su, sb, rc, pairs, legs
    torch.cuda.empty_cache()


def timed_mixed(times: dict) -> None:
    """The packed2d kernels' bfloat16 modes at 4095^2, RB-GS, sigma = 0
    (the legs at nu = 2, the sweep at nu = 4), each against its plain
    version in turns (single calls), as LEG_CHAIN chained calls and by the
    profiler's device time a call, beside its float32 twin on the same
    values (chained and device) and, by device time, on float32 values
    that bfloat16 does not hold (the twin's time does not depend on the
    values); and on each MIXED_ROUTES route at 4095^2 float32, one
    preconditioning cycle's device busy, ops and idle share and one PCG
    solve's wall, with a bfloat16 and a float32 cycle."""
    import multigridcmt_tpu_torch as mt
    from multigridcmt_tpu_torch.kernels import packed2d
    from multigridcmt_tpu_torch.solvers import cycles
    from multigridcmt_tpu_torch.utils.breakdown import device_busy
    from multigridcmt_tpu_torch.utils.profiling import (chained_ms,
                                                       cuda_time_ms)

    n = 2 ** MAIN_K - 1
    nc = (n - 1) // 2
    h = 1.0 / (n + 1)
    su, sb, e, _ = bf16_inputs(n, seed=7)
    fu, fb = su.float(), sb.float()
    u, b, _ = leg_inputs(n, torch.float32, seed=7)
    ru, rb = packed2d.pack(u), packed2d.pack(b)
    del u, b
    rc = torch.empty((nc + 2, nc + 2), device="cuda")
    kw = dict(kind="rbgs", omega=1.0)
    down, up = packed2d.smooth_residual_restrict, packed2d.prolong_add_smooth
    f32 = torch.float32
    # name -> (sweeps, kernel, plain, float32 twin on (u, b), bytes read
    # once and written once)
    cases = {
        "packed2d_down_bf16": (
            2, lambda: down(su, sb, n, h, sweeps=2, **kw),
            lambda: packed2d.smooth_residual_restrict_plain(
                su, sb, n, h, sweeps=2, **kw),
            lambda u, b: down(u, b, n, h, sweeps=2, **kw),
            nbytes(su, sb, su, rc)),
        "packed2d_up_bf16_f32": (
            2, lambda: up(su, e, sb, n, nc, h, sweeps=2, out_dtype=f32, **kw),
            lambda: packed2d.prolong_add_smooth_plain(
                su, e, sb, n, nc, h, sweeps=2, out_dtype=f32, **kw),
            lambda u, b: up(u, e, b, n, nc, h, sweeps=2, **kw),
            nbytes(su, sb, e, fu)),
        "packed2d_up_bf16": (
            2, lambda: up(su, e, sb, n, nc, h, sweeps=2, **kw),
            lambda: packed2d.prolong_add_smooth_plain(
                su, e, sb, n, nc, h, sweeps=2, **kw),
            lambda u, b: up(u, e, b, n, nc, h, sweeps=2, **kw),
            nbytes(su, sb, e, su)),
        "packed2d_rbgs_bf16": (
            4, lambda: packed2d.rbgs_sweep(su, sb, n, h, sweeps=4),
            lambda: packed2d.rbgs_sweep_plain(su, sb, n, h, sweeps=4),
            lambda u, b: packed2d.rbgs_sweep(u, b, n, h, sweeps=4),
            nbytes(su, sb, su)),
        "packed2d_residual_bf16": (
            0, lambda: packed2d.residual(su, sb, n, h),
            lambda: packed2d.residual_plain(su, sb, n, h),
            lambda u, b: packed2d.residual(u, b, n, h), nbytes(su, sb, su)),
    }
    for name, (nu, kernel, plain, twin, nb) in cases.items():
        pair = time_pair(f"{name} n={n} nu={nu}", kernel, plain)
        t = {"ms": chained_ms(kernel, LEG_CHAIN), "single_ms": pair["ms"],
             "plain_ms": pair["plain_ms"], "device_ms": pair["device_ms"],
             "f32_chained_ms": chained_ms(lambda: twin(fu, fb), LEG_CHAIN),
             "f32_device_ms": device_busy(lambda: twin(fu, fb),
                                          LEG_CHAIN)[0],
             "f32_other_device_ms": device_busy(lambda: twin(ru, rb),
                                                LEG_CHAIN)[0],
             "bytes": nb, "flops": flops_per_point(name, nu) * n * n}
        t["chained_ms"] = t["ms"]
        log(f"bf16 {name} n={n} nu={nu}: chained x{LEG_CHAIN} {t['ms']:.4f} "
            f"ms, device {t['device_ms']:.4f} ms; float32 twin chained "
            f"{t['f32_chained_ms']:.4f} ms, device {t['f32_device_ms']:.4f} "
            f"ms ({t['f32_other_device_ms']:.4f} ms on values bfloat16 does "
            f"not hold); bound {nb / PEAK_BYTES_PER_S * 1e3:.4f} ms")
        times[name] = t
    del cases, su, sb, e, fu, fb, ru, rb, rc
    torch.cuda.empty_cache()

    out = {}
    for route, rkw in MIXED_ROUTES.items():
        prob = mt.poisson2d(k=MAIN_K, dtype=torch.float32, use_kernels=True,
                            device="cuda", **rkw)
        bk = cycles.get_backend(prob.config)
        r = bk.encode(prob.b)
        row = {}
        for pd in (torch.float32, torch.bfloat16):
            rp = r.to(pd)
            busy, ops, _ = device_busy(lambda: cycles.cycle(
                prob.hierarchy, torch.zeros_like(rp), rp, prob.config), 5)
            cycle_ms = cuda_time_ms(lambda: cycles.cycle(
                prob.hierarchy, torch.zeros_like(rp), rp, prob.config))
            solver = mt.MultigridSolver(dataclasses.replace(
                prob, config=dataclasses.replace(
                    prob.config, precond_dtype=pd)))
            solve_ms = cuda_time_ms(lambda: solver.solve(method="pcg"),
                                    reps=5, warmup=1)
            row[str(pd).split(".")[-1]] = {
                "cycle_ms": cycle_ms, "busy_ms": busy, "ops": ops,
                "idle": 1.0 - busy / cycle_ms, "pcg_ms": solve_ms}
        log(f"mixed {route}: " + json.dumps(row))
        out[route] = row
        del prob, r, rp, solver
        torch.cuda.empty_cache()
    times["mixed_cycles"] = out


def timed_cdt_bf16(times: dict) -> None:
    """The _cdt family's last bfloat16 modes at their float32 twins' shapes
    (sigma 0): the plocal2d residual, apply and red-only norm at S1's packed
    fine tile, the whole grid's red-only norm at 4095^2, the BELL SpMM on
    the bench matrix (m = 128), each against its plain version in turns
    (single calls), as LEG_CHAIN chained calls and by the profiler's device
    time a call, beside its float32 twin on the widened values (chained
    and device); the BELL mode beside torch.sparse.mm on the same matrix
    as a (128, 128)-block bfloat16 BSR with int32 indices, where PyTorch
    runs it (else its error is logged and library_ms is null, the reason in
    library_note); the 8-row carrier (bell.spmv) by device time beside its
    float32 twin (cdt_bf16_carrier). Bounds at bfloat16 bytes; the BELL
    mode's operations at PEAK_BF16_FLOPS."""
    import numpy as np
    import torch.nn.functional as F

    from multigridcmt_tpu_torch.kernels import bell, packed2d, plocal2d
    from multigridcmt_tpu_torch.utils.breakdown import device_busy
    from multigridcmt_tpu_torch.utils.profiling import (chained_ms,
                                                       cuda_time_ms)

    bf, f32 = torch.bfloat16, torch.float32
    n = 2 ** MAIN_K - 1
    h = 1.0 / (n + 1)
    ue, be, _, t = local2d_tile(n, f32, seed=23)
    m, offs = t["m"], (t["row_off"], t["col_off"])
    su, sb = (plocal2d.pack_ext(g, 0).to(bf) for g in (ue, be))
    del ue, be
    fu, fb = su.float(), sb.float()
    gu, gb, _, _ = bf16_inputs(n, seed=7)
    gfu, gfb = gu.float(), gb.float()
    a_sp, ab32, xt32 = bell_bench()
    ab, xt = bell_bf16_bench()
    yt = bell.spmm(ab, xt)
    blocks = int(a_sp.tobsr(blocksize=(128, 128)).indices.shape[0])
    blk = ab.data.shape[-1]
    # name -> (kernel, plain, float32 twin, bytes read once and written
    # once, operations, their peak)
    cases = {
        "plocal2d_residual_bf16": (
            lambda: plocal2d.residual(su, sb, n, h, *offs),
            lambda: plocal2d.residual_plain(su, sb, n, h, *offs),
            lambda: plocal2d.residual(fu, fb, n, h, *offs),
            nbytes(su, sb, su), 8 * n * n, PEAK_F32_FLOPS),
        "plocal2d_apply_bf16": (
            lambda: plocal2d.apply_op(su, n, h, *offs),
            lambda: plocal2d.apply_op_plain(su, n, h, *offs),
            lambda: plocal2d.apply_op(fu, n, h, *offs),
            nbytes(su, su), 7 * n * n, PEAK_F32_FLOPS),
        "plocal2d_resnorm_bf16": (
            lambda: plocal2d.residual_norm_sq(su, sb, n, h, m, *offs,
                                              red_only=True),
            lambda: plocal2d.residual_norm_sq_plain(su, sb, n, h, m, *offs,
                                                    red_only=True),
            lambda: plocal2d.residual_norm_sq(fu, fb, n, h, m, *offs,
                                              red_only=True),
            nbytes(su, sb[0]), 5 * n * n, PEAK_F32_FLOPS),
        "packed2d_resnorm_bf16": (
            lambda: packed2d.residual_norm_sq(gu, gb, n, h, red_only=True),
            lambda: packed2d.residual_norm_sq_plain(gu, gb, n, h,
                                                    red_only=True),
            lambda: packed2d.residual_norm_sq(gfu, gfb, n, h, red_only=True),
            nbytes(gu, gb[0]), 5 * n * n, PEAK_F32_FLOPS),
        # The populated blocks and their column indices, Xt and Yt, as the
        # float32 row counts them.
        "bell_spmm_bf16": (
            lambda: bell.spmm(ab, xt), lambda: bell.spmm_plain(ab, xt),
            lambda: bell.spmm(ab32, xt32),
            blocks * (blk * blk * ab.data.element_size()
                      + ab.cols.element_size()) + nbytes(xt, yt),
            2 * blocks * blk * blk * BELL_M, PEAK_BF16_FLOPS),
    }
    for name, (kernel, plain, twin, nb, flops, peak) in cases.items():
        pair = time_pair(f"{name} n={n}", kernel, plain)
        row = {"ms": chained_ms(kernel, LEG_CHAIN), "single_ms": pair["ms"],
               "plain_ms": pair["plain_ms"], "device_ms": pair["device_ms"],
               "f32_chained_ms": chained_ms(twin, LEG_CHAIN),
               "f32_device_ms": device_busy(twin, LEG_CHAIN)[0],
               "bytes": nb, "flops": flops, "peak_flops": peak}
        row["chained_ms"] = row["ms"]
        if peak != PEAK_F32_FLOPS:
            row["peak"] = "bfloat16 tensor cores, 989 TFLOP/s dense"
        bound = max(nb / PEAK_BYTES_PER_S, flops / peak) * 1e3
        log(f"bf16 {name}: chained x{LEG_CHAIN} {row['ms']:.4f} ms, device "
            f"{row['device_ms']:.4f} ms; float32 twin chained "
            f"{row['f32_chained_ms']:.4f} ms, device "
            f"{row['f32_device_ms']:.4f} ms; bound {bound:.4f} ms "
            f"({100 * bound / row['device_ms']:.1f}% of the device time)")
        times[name] = row

    # The library's call of the same function: a bfloat16 BSR of int32
    # indices (the float32 row's yardstick) times X.
    row = times["bell_spmm_bf16"]
    row["library_ms"] = None
    try:
        bsr_h = a_sp.tobsr(blocksize=(128, 128))
        bsr = torch.sparse_bsr_tensor(
            torch.from_numpy(bsr_h.indptr.astype(np.int32)).cuda(),
            torch.from_numpy(bsr_h.indices.astype(np.int32)).cuda(),
            torch.from_numpy(bsr_h.data).cuda().to(bf), size=a_sp.shape)
        x_cols = xt.T.contiguous()
        lib_out = torch.sparse.mm(bsr, x_cols).T
        lib_rel = rel_err(lib_out.float(), yt[:, :a_sp.shape[0]].float())[1]
        row["library_ms"] = cuda_time_ms(lambda: torch.sparse.mm(bsr,
                                                                 x_cols))
        log(f"  bf16 BSR torch.sparse.mm (128, 128) int32: "
            f"{row['library_ms']:.4f} ms (rel diff {lib_rel:.1e})")
        del bsr, x_cols, lib_out
    except (RuntimeError, NotImplementedError, TypeError) as exc:
        row["library_note"] = (f"torch.sparse.mm on a bfloat16 BSR raised "
                               f"{type(exc).__name__}: {exc}"[:300])
        log(f"  {row['library_note']}")

    # The m = 8 carrier by device time: its bound is the bytes of every
    # stored block, the carrier and the result.
    x, x32 = xt[0], xt32[0]
    carrier = time_pair(f"bf16 bell spmv carrier m=8 kmax={ab.kmax}",
                        lambda: bell.spmv(ab, x), lambda: bell.spmm_plain(
                            ab, F.pad(x[None], (0, 0, 0, 7))))
    carrier["f32_device_ms"] = device_busy(lambda: bell.spmv(ab32, x32),
                                           LEG_CHAIN)[0]
    moved8 = nbytes(ab.data, ab.cols) + 8 * nbytes(x) + 8 * nbytes(yt[0])
    carrier["bound_ms"] = max(moved8 / PEAK_BYTES_PER_S,
                              2 * blocks * blk * blk * 8
                              / PEAK_BF16_FLOPS) * 1e3
    carrier["bound_share"] = carrier["bound_ms"] / carrier["device_ms"]
    times["cdt_bf16_carrier"] = carrier
    log(f"bf16 BELL carrier m=8: device {carrier['device_ms']:.4f} ms, float32 "
        f"twin {carrier['f32_device_ms']:.4f} ms, bound "
        f"{carrier['bound_ms']:.4f} ms ({100 * carrier['bound_share']:.1f}% "
        "of it)")
    del su, sb, fu, fb, gu, gb, gfu, gfb, ab, xt, yt, cases
    torch.cuda.empty_cache()


def timed_native_bf16(times: dict) -> None:
    """The native bfloat16 modes at sigma 0: stencil2d's at
    NATIVE_STENCIL_N (RB-GS nu = 4, Jacobi nu = 8), local2d's on S1's fine
    tile, the SpMV at 4095^2; each against its plain version in turns
    (single calls), as LEG_CHAIN chained calls and by the profiler's device
    time a call. Bounds: the inputs read once and the output written once
    in bfloat16, or the operations (NATIVE_OPS) at the float32 rate. The
    SpMV beside torch.mv on its matrix as a bfloat16 CSR (cuSPARSE), where
    PyTorch runs it (else library_ms is null, the reason in
    library_note)."""
    from multigridcmt_tpu_torch.kernels import spmv
    from multigridcmt_tpu_torch.utils.profiling import (chained_ms,
                                                       cuda_time_ms)

    cases = {}
    for mode, n in NATIVE_STENCIL_N.items():
        u, b = native_grids(n, n + 321)
        nu = max(NATIVE_SWEEPS.get(mode, (1,)))
        kernel, plain = native_stencil_calls(mode, u, b, n, 0.0, nu)
        cases[f"stencil2d_{mode}_bf16"] = (kernel, plain, nbytes(u, b, u),
                                           NATIVE_OPS[mode] * nu * n * n)
    ue, be, t = native_tile("S1", 322)
    n = t["n"]
    for mode in NATIVE_STENCIL_N:
        nu = max(NATIVE_SWEEPS.get(mode, (1,)))
        kernel, plain = native_local_calls(mode, ue, be, t, 0.0, nu)
        cases[f"local2d_{mode}_bf16"] = (kernel, plain, nbytes(ue, be, ue),
                                         NATIVE_OPS[mode] * nu * n * n)
    a, pk, xp = native_dia(323)
    cases["spmv_dia_bf16"] = (
        lambda: spmv.spmv_packed(pk, xp),
        lambda: spmv.spmv_packed_plain(pk, xp),
        nbytes(pk.diags, pk.offset_tensor, xp, xp),
        2 * len(pk.offsets) * pk.n)
    for name, (kernel, plain, nb, flops) in cases.items():
        pair = time_pair(f"{name} native", kernel, plain)
        row = {"ms": chained_ms(kernel, LEG_CHAIN), "single_ms": pair["ms"],
               "plain_ms": pair["plain_ms"], "device_ms": pair["device_ms"],
               "bytes": nb, "flops": flops, "library_ms": None,
               **{k: pair[k] for k in ("device_note",) if k in pair}}
        row["chained_ms"] = row["ms"]
        bound = max(nb / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS) * 1e3
        log(f"native {name}: chained x{LEG_CHAIN} {row['ms']:.4f} ms, device "
            f"{row['device_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms; "
            f"bound {bound:.4f} ms ({100 * bound / row['device_ms']:.1f}% "
            "of the device time)")
        times[name] = row
    # The library's call of the same product: torch.mv on the matrix as a
    # bfloat16 CSR of int32 indices.
    row = times["spmv_dia_bf16"]
    try:
        x = spmv.unpack_y(xp, pk.n, pk.halo)
        csr = dia_to_torch_csr(a)
        lib_out = torch.mv(csr, x)
        want = spmv.unpack_y(spmv.spmv_packed(pk, xp), pk.n, pk.halo)
        lib_rel = rel_err(lib_out.float(), want.float())[1]
        row["library_ms"] = cuda_time_ms(lambda: torch.mv(csr, x))
        log(f"  bf16 CSR torch.mv: {row['library_ms']:.4f} ms (rel diff "
            f"{lib_rel:.1e})")
        del csr, lib_out
    except (RuntimeError, NotImplementedError, TypeError) as exc:
        row["library_note"] = (f"torch.mv on a bfloat16 CSR raised "
                               f"{type(exc).__name__}: {exc}"[:300])
        log(f"  {row['library_note']}")
    del cases, ue, be, a, pk, xp
    torch.cuda.empty_cache()


def timed_native_legs(times: dict) -> None:
    """The B2 native modes at sigma 0 (the legs RB-GS nu = 2, as the
    bf16_rbgs22 path runs them; the transfers as bf16_rbgs45 does), each
    against its plain version in turns (single calls), as LEG_CHAIN chained
    calls and by the profiler's device time a call: the rows at 2047^2, and
    at every fused level of the k=11 solve (times["native_leg_levels"]) the
    legs, the transfers and the whole grid's native sweep streams, RB-GS at
    NATIVE_RBGS_TIMED (the nu of bf16_rbgs45's launches) and Jacobi at
    NATIVE_JACOBI_TIMED (bf16_jacobi88's). Bounds: the inputs read once and
    the outputs written once in bfloat16, or the operations (NATIVE_OPS a
    sweep, NATIVE_RR_OPS, NATIVE_PA_OPS a fine point) at the float32 rate.
    No single PyTorch call computes these functions with every operation
    rounded to bfloat16: library_ms null, but for the prolongation-add's
    yardstick, x + F.interpolate(e, bilinear, aligned corners) in bfloat16
    (the float32 row's call pair, which rounds elsewhere: its relative
    difference from the kernel logged, not gated)."""
    import torch.nn.functional as F

    from multigridcmt_tpu_torch.utils.profiling import (chained_ms,
                                                       cuda_time_ms)

    nu = 2
    levels = {}
    for n in NATIVE_LEG_N:
        u, b, x, e = native_leg_inputs(n, n + 341)
        rc = torch.empty(((n - 1) // 2 + 2,) * 2, dtype=torch.bfloat16,
                         device="cuda")
        rr, rr_shift = (k * n * n for k in NATIVE_RR_OPS)
        cases = {
            "fused2d_down_bf16": (nbytes(u, b, u, rc),
                                  NATIVE_OPS["rbgs"] * nu * n * n
                                  + rr_shift, "rbgs", nu),
            "fused2d_up_bf16": (nbytes(x, e, b, x),
                                NATIVE_PA_OPS * n * n
                                + NATIVE_OPS["rbgs"] * nu * n * n, "rbgs",
                                nu)}
        cases.update({
            "transfer2d_residual_restrict_bf16": (nbytes(u, b, rc), rr,
                                                  "rbgs", 0),
            "transfer2d_prolong_add_bf16": (nbytes(x, e, x),
                                            NATIVE_PA_OPS * n * n, "rbgs",
                                            0)})
        for kind, timed in (("rbgs", NATIVE_RBGS_TIMED),
                            ("jacobi", NATIVE_JACOBI_TIMED)):
            for sweeps in timed:
                cases[f"stencil2d_{kind}_bf16 nu={sweeps}"] = (
                    nbytes(u, b, u), NATIVE_OPS[kind] * sweeps * n * n,
                    kind, sweeps)
        for name, (nb, flops, kind, sweeps) in cases.items():
            if name.startswith("stencil2d"):
                kernel, plain = native_stencil_calls(kind, u, b, n, 0.0,
                                                     sweeps)
            else:
                kernel, plain = native_leg_calls(name, u, b, x, e, n, 0.0,
                                                 kind, sweeps)
            pair = time_pair(f"{name} native n={n}", kernel, plain)
            row = {"ms": chained_ms(kernel, LEG_CHAIN),
                   "single_ms": pair["ms"], "plain_ms": pair["plain_ms"],
                   "device_ms": pair["device_ms"], "bytes": nb,
                   "flops": flops, "library_ms": None,
                   "library_note": "no PyTorch call computes it with every "
                                   "operation rounded to bfloat16",
                   **{k: pair[k] for k in ("device_note",) if k in pair}}
            row["chained_ms"] = row["ms"]
            if name == "transfer2d_prolong_add_bf16":
                def lib():
                    return x + F.interpolate(
                        e[None, None], size=(n + 2, n + 2), mode="bilinear",
                        align_corners=True)[0, 0]

                row["library_ms"] = cuda_time_ms(lib)
                lib_rel = rel_err(lib().float(), kernel().float())[1]
                row["library_note"] = (
                    "x + F.interpolate(e, bilinear, align_corners) in "
                    "bfloat16: a yardstick, not bit-equal (relative "
                    f"difference from the kernel {lib_rel:.1e})")
                log(f"  {name} n={n} library {row['library_ms']:.4f} ms; "
                    f"{row['library_note']}")
            bound = max(nb / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS) * 1e3
            log(f"native {name} n={n} nu={sweeps}: chained x{LEG_CHAIN} "
                f"{row['ms']:.4f} ms, device {row['device_ms']:.4f} ms, "
                f"plain {row['plain_ms']:.4f} ms; bound {bound:.4f} ms "
                f"({100 * bound / row['device_ms']:.1f}% of the device "
                "time)")
            if n == NATIVE_LEG_N[0] and not name.startswith("stencil2d"):
                times[name] = row
            levels[f"{name}@{n}"] = {
                "single_ms": row["single_ms"],
                "chained_ms": row["chained_ms"],
                "device_ms": row["device_ms"], "plain_ms": row["plain_ms"],
                "bound_ms": bound,
                **{k: row[k] for k in ("device_note",) if k in row},
                **({"library_ms": row["library_ms"]}
                   if row["library_ms"] is not None else {})}
        del u, b, x, e, rc
    times["native_leg_levels"] = levels
    torch.cuda.empty_cache()


def timed_mixed3d(times: dict) -> None:
    """The stencil3d kernels' bfloat16 modes at 511^3, sigma = 0, one
    launch a call, each against its plain version in turns (single calls),
    as LEG_CHAIN chained calls and by the profiler's device time a call,
    beside its float32 twin on the same values (chained and device) and its
    bound at bfloat16 bytes (6 a point, 8 with a float32 output); and at
    511^3 float32 one preconditioning cycle's device busy, ops and idle
    share and one PCG solve's wall (mixed3d), with a bfloat16 and a float32
    cycle."""
    import multigridcmt_tpu_torch as mt
    from multigridcmt_tpu_torch.kernels import stencil3d
    from multigridcmt_tpu_torch.solvers import cycles
    from multigridcmt_tpu_torch.utils.breakdown import device_busy
    from multigridcmt_tpu_torch.utils.profiling import (chained_ms,
                                                       cuda_time_ms)

    f32, bf16 = torch.float32, torch.bfloat16
    n = 2 ** MAIN_K3 - 1
    h = 1.0 / (n + 1)
    w = omega3()
    u, b = cube_inputs(n, f32, seed=9)
    su, sb = u.to(bf16), b.to(bf16)
    fu, fb = su.float(), sb.float()
    del u, b
    res3, jac3, rb3 = stencil3d.residual, stencil3d.jacobi_sweep, \
        stencil3d.rbgs_sweep
    # name -> (kernel, plain, float32 twin on (fu, fb), bytes a point)
    cases = {
        "stencil3d_residual_bf16": (
            lambda: res3(su, sb, n, h),
            lambda: stencil3d.residual_plain(su, sb, n, h),
            lambda: res3(fu, fb, n, h), 8),
        "stencil3d_rbgs_bf16": (
            lambda: rb3(su, sb, n, h),
            lambda: stencil3d.rbgs_sweep_plain(su, sb, n, h),
            lambda: rb3(fu, fb, n, h), 6),
        "stencil3d_rbgs_bf16_f32": (
            lambda: rb3(su, sb, n, h, out_dtype=f32),
            lambda: stencil3d.rbgs_sweep_plain(su, sb, n, h, out_dtype=f32),
            lambda: rb3(fu, fb, n, h), 8),
        "stencil3d_jacobi_bf16": (
            lambda: jac3(su, sb, n, h, w),
            lambda: stencil3d.jacobi_sweep_plain(su, sb, n, h, w),
            lambda: jac3(fu, fb, n, h, w), 6),
        "stencil3d_jacobi_bf16_f32": (
            lambda: jac3(su, sb, n, h, w, out_dtype=f32),
            lambda: stencil3d.jacobi_sweep_plain(su, sb, n, h, w,
                                                 out_dtype=f32),
            lambda: jac3(fu, fb, n, h, w), 8),
    }
    for name, (kernel, plain, twin, per_point) in cases.items():
        pair = time_pair(f"{name} n={n}", kernel, plain)
        nb = per_point * (n + 2) ** 3
        t = {"ms": chained_ms(kernel, LEG_CHAIN), "single_ms": pair["ms"],
             "plain_ms": pair["plain_ms"], "device_ms": pair["device_ms"],
             "f32_chained_ms": chained_ms(twin, LEG_CHAIN),
             "f32_device_ms": device_busy(twin, LEG_CHAIN)[0],
             "bytes": nb, "flops": flops_per_point(name) * n ** 3}
        t["chained_ms"] = t["ms"]
        log(f"bf16 {name} n={n}: chained x{LEG_CHAIN} {t['ms']:.4f} ms, "
            f"device {t['device_ms']:.4f} ms; float32 twin chained "
            f"{t['f32_chained_ms']:.4f} ms, device {t['f32_device_ms']:.4f} "
            f"ms; bound {nb / PEAK_BYTES_PER_S * 1e3:.4f} ms")
        times[name] = t
    del cases, su, sb, fu, fb
    torch.cuda.empty_cache()

    prob = mt.poisson3d(k=MAIN_K3, dtype=f32, smoother="rbgs",
                        use_kernels=True, device="cuda")
    r = cycles.get_backend(prob.config).encode(prob.b)
    row = {}
    for pd in (f32, bf16):
        rp = r.to(pd)

        def one_cycle():
            return cycles.cycle(prob.hierarchy, torch.zeros_like(rp), rp,
                                prob.config)

        busy, ops, _ = device_busy(one_cycle, 5)
        cycle_ms = cuda_time_ms(one_cycle)
        solver = mt.MultigridSolver(dataclasses.replace(
            prob, config=dataclasses.replace(prob.config, precond_dtype=pd)))
        solve_ms = cuda_time_ms(lambda: solver.solve(method="pcg"), reps=5,
                                warmup=1)
        row[str(pd).split(".")[-1]] = {
            "cycle_ms": cycle_ms, "busy_ms": busy, "ops": ops,
            "idle": 1.0 - busy / cycle_ms, "pcg_ms": solve_ms,
            "pcg_iters": solver.solve(method="pcg").iters}
    log("mixed3d: " + json.dumps(row))
    times["mixed3d_cycles"] = row
    del prob, r, rp, solver
    torch.cuda.empty_cache()


def timed_fmg_eigen(times: dict) -> None:
    """Configs 3 and 4's first times on the card (CUDA events, warm-up,
    medians) with each run's peak device memory: one FMG pass at 1023^2
    (float32 and float64, also its device time and idle share) and at
    4095^2 float32, and solve(cycle="fmg") at 4095^2; the eigensolve at
    511^2 float64 by each method (wall, outer steps, cycles); S1fmg, the
    sharded FMG solve at 4095^2 on a row mesh of 1, and its FMG pass
    alone."""
    import multigridcmt_tpu_torch as mt
    from multigridcmt_tpu_torch.parallel import sharded
    from multigridcmt_tpu_torch.utils.breakdown import device_busy
    from multigridcmt_tpu_torch.utils.profiling import (count_cycles,
                                                       cuda_time_ms)

    out = {}

    def timed(key, fn, reps, warmup=1, **extra):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_time_ms(fn, reps=reps, warmup=warmup)
        out[key] = dict(ms=ms, peak_bytes=torch.cuda.max_memory_allocated(),
                        **extra)
        log(f"time {key}: " + json.dumps(out[key]))

    for k, dtypes in ((FMG_K, (torch.float32, torch.float64)),
                      (MAIN_K, (torch.float32,))):
        for dtype in dtypes:
            prob = mt.poisson2d(k=k, dtype=dtype, smoother="rbgs",
                                use_kernels=True, device="cuda")
            solver = mt.MultigridSolver(prob)
            name = f"fmg{2 ** k - 1} {str(dtype).split('.')[-1]}"
            extra = {}
            if k == FMG_K:
                busy, ops, _ = device_busy(solver.fmg, 3)
                extra = dict(device_ms=busy, device_ops=ops)
            timed(name, solver.fmg, 10 if k == FMG_K else 5, **extra)
            if k == FMG_K:
                out[name]["idle_share"] = 1 - busy / out[name]["ms"]
            del prob, solver
    prob = mt.poisson2d(k=MAIN_K, dtype=torch.float32, smoother="rbgs",
                        use_kernels=True, device="cuda", cycle="fmg")
    solver = mt.MultigridSolver(prob)
    timed("solve fmg4095 float32", solver.solve, 3,
          polishing_cycles=solver.solve().iters)
    del prob, solver
    torch.cuda.empty_cache()

    prob = mt.poisson2d(k=EIGEN_K, dtype=torch.float64, smoother="rbgs",
                        use_kernels=True, device="cuda")
    solver = mt.MultigridSolver(prob)
    for method in EIGEN_METHODS:
        # The counted run warms up; II and RQI take seconds a run, so the
        # median of 2 there (of 3 for LOBPCG).
        with count_cycles() as cyc:
            res = solver.eigensolve(k=1, method=method)
        timed(f"eigen511 {method} float64",
              lambda: solver.eigensolve(k=1, method=method),
              3 if method == "lobpcg" else 2, warmup=0,
              outer_steps=res.iters, cycles=cyc.count)
    del prob, solver
    torch.cuda.empty_cache()

    k, shape, cfg_kw = SHARDED_PATHS["S1"]
    prob = mt.poisson2d(k=k, dtype=torch.float32, use_kernels=True,
                        device="cuda", cycle="fmg", **cfg_kw)
    solver = sharded.ShardedSolver(prob.config, sharded_mesh(shape))
    b_t = sharded.shard_rhs(prob.b, solver.mesh, solver.decomp)
    timed("S1fmg solve", lambda: solver.solve(prob.b), 3,
          polishing_cycles=solver.solve(prob.b).iters)
    timed("S1fmg fmg pass", lambda: sharded._sharded_fmg(
        solver.hierarchy, prob.config, solver.decomp, b_t), 5)
    del prob, solver, b_t
    torch.cuda.empty_cache()
    times["fmg_eigen"] = out


def timed_sharded3d(times: dict) -> None:
    """One V(2,2) RB-GS cycle at 511^3 float32 on a slab mesh and on a
    pencil mesh of 1 (``v_cycle_fn``: owned tiles in and out, the
    extended stacks built a level visit) beside the single-device cycle, in
    turns (single, slab, pencil, single): its time by CUDA
    events, the profiler's device busy time, ops and idle share a cycle,
    and of the busy time the stencil3d kernels' and the cat and copy
    kernels' (the stacks' extension and owned slices, and the plain
    transfers' copies on either route). Then one preconditioning cycle of
    the mixed Jacobi paths (slab511-mixed-jacobi, pencil511-mixed-jacobi:
    the cycle their PCG runs on the defect cast to bfloat16, its top level
    storing float32) beside the float32 cycle on the float32 defect, in
    turns: the same readings and the stencil3d Jacobi kernels' share of the
    busy time (timed_mixed_jacobi3d)."""
    import multigridcmt_tpu_torch as mt
    from multigridcmt_tpu_torch.parallel import sharded
    from multigridcmt_tpu_torch.utils.breakdown import (SHARDED3D_KERNELS,
                                                        device_busy)
    from multigridcmt_tpu_torch.utils.profiling import cuda_time_ms

    prob = mt.poisson3d(k=MAIN_K3, dtype=torch.float32, smoother="rbgs",
                        use_kernels=True, device="cuda")
    single = mt.MultigridSolver(prob)
    x = torch.zeros_like(prob.b)
    fns = {"single": lambda: single.v_cycle(x, prob.b)}
    keep = []
    for label, shape in (("slab", (1,)), ("pencil", (1, 1))):
        solver = sharded.ShardedSolver(prob.config, sharded_mesh(shape))
        bt = sharded.shard_rhs(prob.b, solver.mesh, solver.decomp)
        xt = torch.zeros_like(bt)
        keep.append((solver, bt, xt))
        fns[label] = functools.partial(solver.v_cycle_fn(), xt, bt)
    row = {}
    for label in ("single", "slab", "pencil", "single"):
        ms = cuda_time_ms(fns[label], reps=10)
        busy, ops, by = device_busy(fns[label], 3, SHARDED3D_KERNELS)
        t = {"cycle_ms": ms, "busy_ms": busy, "ops": ops,
             "idle": 1.0 - busy / ms, **by}
        log(f"cycle 3D k={MAIN_K3} {label}: " + json.dumps(t))
        row.setdefault(label, []).append(t)
    times["sharded3d_cycles"] = row
    del prob, single, x, fns, keep
    torch.cuda.empty_cache()
    timed_mixed_jacobi3d(times)


# The stencil3d Jacobi kernels by the profiler's name: the paired march and
# the scalar pass_kernel in its Jacobi mode (MODE 1), any storage.
STENCIL3D_JACOBI = re.compile(r"(?<!\w)(jacobi_pairs_kernel<|"
                              r"pass_kernel<(float|double), \d+, 1,)")


def timed_mixed_jacobi3d(times: dict) -> None:
    """One preconditioning cycle at 511^3 of slab511-mixed-jacobi and
    pencil511-mixed-jacobi (ShardedSolver's PCG preconditioner: a sharded
    cycle from zero on the defect in bfloat16, promoted to float32 at the
    fine level's correction add) beside
    the float32 cycle on the same defect in float32, in turns (float32,
    bfloat16, bfloat16, float32 a mesh): time by CUDA events, device busy,
    ops, idle share, and the stencil3d kernels', the stencil3d Jacobi
    kernels' and the cat and copy kernels' device time a cycle."""
    import multigridcmt_tpu_torch as mt
    from multigridcmt_tpu_torch.parallel import sharded
    from multigridcmt_tpu_torch.utils.breakdown import (SHARDED3D_KERNELS,
                                                        device_busy)
    from multigridcmt_tpu_torch.utils.profiling import cuda_time_ms

    bf16 = torch.bfloat16
    groups = {**SHARDED3D_KERNELS,
              "stencil3d Jacobi kernels": STENCIL3D_JACOBI}
    prob = mt.poisson3d(k=MAIN_K3, dtype=torch.float32, smoother="jacobi",
                        use_kernels=True, device="cuda", precond_dtype=bf16)
    cfg = prob.config
    out = {}
    for label, shape in (("slab", (1,)), ("pencil", (1, 1))):
        solver = sharded.ShardedSolver(cfg, sharded_mesh(shape))
        pd = sharded.mixed_slab_dtype(cfg, solver.decomp)
        require(pd == bf16, f"mixed Jacobi {label}: the cast is {pd}")
        bt = sharded.shard_rhs(prob.b, solver.mesh, solver.decomp)

        def cycle(rp, solver=solver):
            return sharded._sharded_v_cycle(
                solver.hierarchy, cfg, solver.decomp, torch.zeros_like(rp),
                rp, 0, 1)

        fns = {dt: functools.partial(cycle, bt.to(dt))
               for dt in (torch.float32, bf16)}
        row = {}
        for dt in (torch.float32, bf16, bf16, torch.float32):
            ms = cuda_time_ms(fns[dt], reps=10)
            busy, ops, by = device_busy(fns[dt], 3, groups)
            t = {"cycle_ms": ms, "busy_ms": busy, "ops": ops,
                 "idle": 1.0 - busy / ms, **by,
                 "jacobi_share": by["stencil3d Jacobi kernels"] / busy}
            key = str(dt).split(".")[-1]
            log(f"mixed Jacobi cycle 3D k={MAIN_K3} {label} {key}: "
                + json.dumps(t))
            row.setdefault(key, []).append(t)
        out[label] = row
        del solver, bt, fns
    times["mixed_jacobi3d_cycles"] = out
    del prob
    torch.cuda.empty_cache()


def timed_sharded_eigen(times: dict) -> None:
    """S1eigen's walls beside the single-device float64 eigensolve at
    4095^2 (the same method; CUDA events after a warm-up run, the median of
    3 runs), and apart from those windows each one's device busy time and
    idle share by the profiler: an II outer step cut to 10
    inner cycles (max_iters=1, inner_cycles=10: a whole step's 30 cycles
    hold ~37000 kernels, which the profiler takes minutes to read) and a
    whole LOBPCG solve, each beside its own events time."""
    import multigridcmt_tpu_torch as mt
    from multigridcmt_tpu_torch.parallel import sharded
    from multigridcmt_tpu_torch.utils.breakdown import device_busy
    from multigridcmt_tpu_torch.utils.profiling import cuda_time_ms

    k, shape, cfg_kw = SHARDED_PATHS["S1"]
    prob = mt.poisson2d(k=k, dtype=torch.float64, use_kernels=True,
                        device="cuda", **cfg_kw)
    solvers = {"sharded": sharded.ShardedSolver(prob.config,
                                                sharded_mesh(shape)),
               "single": mt.MultigridSolver(prob)}
    out = {}
    for method in ("ii", "lobpcg"):
        for route, solver in solvers.items():
            def run(**kw):
                return solver.eigensolve(k=1, method=method, **kw)

            key = f"{route} {method}"
            torch.cuda.reset_peak_memory_stats()
            steps = run().iters                    # the warm-up run
            wall = cuda_time_ms(run, reps=3, warmup=0)
            peak = torch.cuda.max_memory_allocated()
            part = run if method == "lobpcg" else (
                lambda: run(max_iters=1, inner_cycles=10))
            part_ms = cuda_time_ms(part, reps=3, warmup=1)
            busy, ops, _ = device_busy(part, 1)
            out[key] = dict(ms=wall, outer_steps=steps, peak_bytes=peak,
                            part="solve" if method == "lobpcg"
                            else "one outer step of 10 inner cycles",
                            part_ms=part_ms,
                            device_ms=busy, device_ops=ops,
                            idle_share=1 - busy / part_ms)
            log(f"time S1eigen {key} float64 {2 ** k - 1}^2: "
                + json.dumps(out[key]))
    del prob, solvers
    torch.cuda.empty_cache()
    times["sharded_eigen"] = out


def phase_times():
    """Times on the card, float32, RB-GS, nu = 2, sigma = 0: the cycles,
    one PCG iteration, each kernel against its plain version at its
    main-path shape (packed: 4095; fused2d and stencil2d: 2047, the largest
    unpacked level; stencil3d: 511; the SpMV at 4095^2, the BELL SpMM at
    the bench shape), and the packed kernels against their unpacked twins
    at 4095."""
    times = {}
    timed_solves(times)
    timed_2d(times)
    start = time.perf_counter()
    timed_mixed(times)
    timed_cdt_bf16(times)
    timed_native_bf16(times)
    timed_native_legs(times)
    timed_mixed3d(times)
    log(f"mixed-precision times: {time.perf_counter() - start:.1f} s")
    timed_composed(times)
    timed_3d(times)
    # Early in the phase: device_busy reads low when run last (PERF.md,
    # P16-2); this cycle's kernel counts read short there too.
    start = time.perf_counter()
    timed_sharded3d(times)
    log(f"sharded 3D times: {time.perf_counter() - start:.1f} s")
    timed_sparse(times)
    timed_sharded(times)
    start = time.perf_counter()
    timed_mixed_sharded(times)
    log(f"sharded mixed-precision times: {time.perf_counter() - start:.1f} "
        "s")
    timed_chains(times)
    timed_plocal2d(times)
    start = time.perf_counter()
    timed_fmg_eigen(times)
    log(f"FMG and eigensolver times: {time.perf_counter() - start:.1f} s")
    start = time.perf_counter()
    timed_sharded_eigen(times)
    log(f"sharded eigensolver times: {time.perf_counter() - start:.1f} s")
    return times


# Kernel -> the key of its time in phase 4 (its main-path shape).
TIME_KEY = {"packed2d_down": "packed2d_down@4095",
            "packed2d_up": "packed2d_up@4095",
            "packed2d_resnorm": "packed2d_resnorm@4095",
            "packed2d_residual": "packed2d_residual@4095"}


def kernel_rows(names, runs, errs, times):
    """The JSON rows. max_abs_err is in the output's own units (the legs'
    inputs carry b ~ 1/h^2 ~ 1.7e7 and the norm is a sum of ~8e6 such
    squares); rel_err is it over max|plain| (|plain| for the norm), held
    to tol. bound_ms is the larger of the bytes the function moves (each
    input read once, each output written once) over the card's memory
    rate and its operations over the float32 rate (for the BELL SpMM, the
    populated blocks' work). library_ms is the time of the PyTorch call
    that computes the same function where there is one (prolong_add: an
    add and a bilinear interpolate; the SpMV: the faster of torch.mv and a
    one-column torch.sparse.mm on a CSR; the BELL SpMM: a BSR
    torch.sparse.mm); no single call
    computes the others (b - Au, a whole leg, a sweep, the residual's
    restriction), so theirs is null. A kernel that no main path runs
    reports its launches summed over all main-path runs (0) and those of
    its direct calls as direct_launches. The packed2d and plocal2d legs'
    (the packed2d bfloat16 modes' too) and the stencil3d kernels' ms is the
    time a call of LEG_CHAIN chained calls, their single_ms that of one
    call timed alone (the wrapper's host work inside); a bfloat16 mode's
    f32_chained_ms and f32_device_ms are its float32 twin's on the same
    values, f32_other_device_ms the twin's on values bfloat16 does not
    hold. The fused2d
    legs' ms (at 2047^2) is time_pair's, their chained_ms as above (at
    2047^2 a chained call can read the host's launch rate). Every leg row's
    device_ms is the kernel's device time a call from the profiler."""
    rows = []
    for name in names:
        *_, src, rep, run = KERNELS[name]
        t = times[TIME_KEY.get(name, name)]
        by_bytes = t["bytes"] / PEAK_BYTES_PER_S * 1e3
        by_ops = t["flops"] / t.get("peak_flops", PEAK_F32_FLOPS) * 1e3
        launches = (runs[run][name] if run is not None
                    else sum(runs[r][name] for r in MAIN_RUNS))
        row = {
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches, "max_abs_err": errs[name][0],
            "rel_err": errs[name][1], "tol": errs[name][2],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": t.get("library_ms"), "run": run}
        for key in ("single_ms", "chained_ms", "device_ms", "f32_chained_ms",
                    "f32_device_ms", "f32_other_device_ms", "peak",
                    "library_note"):
            if key in t:
                row[key] = t[key]
        if name in DIRECT_RUNS:
            row["direct_launches"] = runs[DIRECT_RUNS[name]][name]
        eigen = {r: runs[r][name] for r in SHARDED_EIGEN_RUNS
                 if runs[r][name]}
        if eigen:
            row["sharded_eigen_launches"] = eigen
        slabs = {r: runs[r][name] for r in SHARDED3D_RUNS if runs[r][name]}
        if slabs:
            row["sharded3d_launches"] = slabs
        for variant, (*_, parts) in VARIANTS.items():
            if name in parts:     # the same run's launches by the variant
                row["pairs_launches"] = (
                    runs[run][variant] if run is not None
                    else runs[DIRECT_RUNS[name]][variant])
        rows.append(row)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    try:
        import multigridcmt_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}",
              file=sys.stderr)
        return 1
    t0 = time.perf_counter()

    def phase(name, fn):
        start = time.perf_counter()
        out = fn()
        log(f"phase {name}: {time.perf_counter() - start:.1f} s")
        return out

    import torch.distributed as dist

    try:
        with tempfile.TemporaryDirectory() as tmp:
            card = phase("setup", lambda: phase_setup(
                os.path.join(tmp, "rendezvous")))
            errs = phase("kernels against plain", phase_compare)
            runs = phase("main paths", phase_main_path)
            times = phase("times", phase_times)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        return 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    log(f"peak device memory: 4095^2 solve {runs['peak2d']} bytes, 511^3 "
        f"solve {runs['peak3d']} bytes, sharded S1 {runs['peakS1']} bytes, "
        f"fmg1023 {runs['peak_fmg1023']} bytes, fmg4095 "
        f"{runs['peak_fmg4095']} bytes, eigen511 "
        + ", ".join(f"{m} {runs['peak_eigen511_' + m]} bytes"
                    for m in EIGEN_METHODS)
        + f", S1fmg {runs['peak_S1fmg']} bytes; card: {card}")
    for label in ("S1", "S2", "S1_chain"):
        log(f"cycle_{label}: " + json.dumps(times["cycle_" + label]))
    log("smoother: " + json.dumps(times["smoother"]))
    log("sweeps: " + json.dumps(times["sweeps"]))
    log("legs: " + json.dumps(times["legs"]))
    log("tile_legs: " + json.dumps(times["tile_legs"]))
    log("local2d_legs: " + json.dumps(times["local2d_legs"]))
    log("local2d_sweeps: " + json.dumps(times["local2d_sweeps"]))
    log("stencil3d_levels: " + json.dumps(times["stencil3d_levels"]))
    log("mixed_cycles: " + json.dumps(times["mixed_cycles"]))
    log("cdt_bf16_carrier: " + json.dumps(times["cdt_bf16_carrier"]))
    log("native_leg_levels: " + json.dumps(times["native_leg_levels"]))
    for method in MIXED_EIGEN:
        log(f"mixed_{method} walls (float64, full and bfloat16-"
            f"preconditioned, s): {runs['mixed_' + method + '_walls']}")
    log("mixed3d_cycles: " + json.dumps(times["mixed3d_cycles"]))
    log("mixed_sharded_cycles: "
        + json.dumps(times["mixed_sharded_cycles"]))
    for label in MIXED_SHARDED:
        log(f"{label} walls and iterations: "
            + json.dumps(runs[f"{label}_walls"]))
    log(f"mixed3d solve peak device memory: {runs['peak_mixed3d']} bytes")
    for method, _ in MIXED3D_EIGEN:
        log(f"mixed3d_{method}: "
            + json.dumps(runs[f"mixed3d_{method}_stats"]))
    for key in ("spmv_figure", "spmv_figure3d", "bell_figure",
                "bell_carrier", "residual_restrict_levels", "fmg_eigen",
                "sharded_eigen"):
        log(f"{key}: " + json.dumps(times[key]))
    for run in SHARDED_EIGEN_RUNS:
        log(f"{run}: " + json.dumps(runs[f"{run}_stats"]))
    log(f"slab511 solve peak device memory: {runs['peak_slab511']} bytes "
        f"(single-device 511^3 solve {runs['peak3d']} bytes)")
    for run in SHARDED3D_RUNS:
        log(f"{run}: " + json.dumps(runs[f"{run}_stats"]))
    log("sharded3d_cycles: " + json.dumps(times["sharded3d_cycles"]))
    log("mixed_jacobi3d_cycles: "
        + json.dumps(times["mixed_jacobi3d_cycles"]))
    log("utils_stats: " + json.dumps(runs["utils_stats"]))
    log("examples_stats: " + json.dumps(runs["examples_stats"]))
    log(f"chip_smoke wall time: {time.perf_counter() - t0:.1f} s")
    log(card)
    print(json.dumps({"kernels": kernel_rows(KERNELS, runs, errs, times)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
