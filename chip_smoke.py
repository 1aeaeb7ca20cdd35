#!/usr/bin/env python3
"""Smoke run of the PyTorch port (admm_tpu_torch) on one CUDA GPU.

Run from the repository root:  python3 chip_smoke.py

It builds the port's GPU kernels from the sources in this checkout, checks
each against its plain PyTorch version, then drives the port's main paths
through the functions a user calls and checks what comes out:

  1. device: nvidia-smi's name and power limit, torch's device name;
  2. K1: the z/u mode of the CUDA C++ kernel ``csrc/zu_tail.cu`` against
     ``_fused_torch`` at several sizes in f32 and f64 (bar: bit-for-bit
     equal), and its time against the plain version's at n = 5000;
  2b. K1b: the tail mode of the same kernel (``fused_zu_tail``: the z/u
     pass with the engine's norms, flags, history write and freeze select
     in one launch) against ``_fused_zu_tail_torch`` at n in {1, 7, 1000,
     5000, 70000}, f32 and f64 (70000 reduces through the ticket, the
     others in one cluster), on a stepping state, a stopping one, the
     last step, frozen ones (done, k = N), nodualerror, domaxiters and a
     NaN under nanguard (bars: x, z, u, state bit for bit; the four norms
     within 1e-5 relative in f32 and 1e-12 in f64; flags and history slot
     equal, the cases built away from pnorm = perr ties; only that slot
     written; the same bits from two launches), and its time per call at
     n = 5000 f32 against the plain version's;
  2c. K1b-D: the tail mode's difference-operator mode (``fused_diff_tail``,
     1-D TV's tail: A = D) against ``_fused_zu_tail_torch(...,
     op=DiffOp(n))`` with 2b's cases and bars at n in {1, 2, 257, 4097,
     65536, 65537} (the block and tile edges, and TV (f)'s length), f32
     and f64, and its time per call at n = 65536 in f32 and f64 against
     the plain version's;
  3. K4: the CUDA C++ cyclic-reduction kernel (``cr_solve``) against
     ``_cr_solve_torch`` in f32 and f64 on the TV system and on a random
     diagonally dominant one, pure masked and with the hybrid dense tail
     (bar: bit-for-bit equal; the tail is the same torch.matmul call on
     the same contiguous operand in both), at the tile boundaries of the
     hybrid form too, and its time per solve against the plain version's
     at (B, n) = (1, 8192), (1, 65536), (128, 8192);
  4. the LASSO slice (the headline fat LASSO, 1500 x 5000 in float32):
     (a) 16384 steps under domaxiters, unroll 64, fused kernel: steps ==
         16384, K1b launched >= 16384 times in this run, finite xopt of
         shape (5000,);
     (b) the same without the kernel: max|xopt_a - xopt_b| <= 1e-6 ||xopt||_inf;
     (c) steps to an RMS primal residual of 1e-6 from (a)'s history,
         equal within one step to a NumPy float64 run of the same update
         sequence;
     (d) a converging run (maxiters 2000, unroll 16): steps < 2000 and
         equal with and without the kernel, or within one with the
         pnorm/perr margin of the deciding step printed (K1b sums its norms
         in another order than torch); and the same solve through a user
         ``fused_zu`` hook that calls ``fused_soft_threshold_dual`` (the
         engine's generic tail with the z/u mode, K1's path), the z/u mode
         launched at least once per step;
     (e) iter/s of (a) and (b), best of 3 each, taken in turns;
  5. the TV slice (1-D staircase signal + 0.5 noise, lambda 0.5, float32):
     (f) n = 65536, solver 'auto' (the hybrid cyclic reduction),
         maxiters 2000, standard stop: K4 and K1b-D launched at least
         once per step, finite xopt of shape (65536,), steps equal within
         one to a NumPy float64 run of the same update sequence;
     (g) the same run with the b-phase in the plain PyTorch version on
         the card: equal steps, max|xopt_f - xopt_g| <= 1e-6 ||xopt||_inf;
     (h) n = 8192, pure masked cyclic reduction: as (f) and (g), with
         xopt bit for bit equal between the two;
     (i) iter/s of (f) and (g), best of 3 each, taken in turns over
         2000 steps under domaxiters ((f) itself stops within ~50);
     (j) 2-D TV of a 512 x 512 blocky image: converges before maxiters,
         finite, and lowers the objective below the noisy image's;
  6. K2: the CUDA C++ GEMV-pair kernel (``gemv_pair``) against
     ``_gemv_pair_torch`` at (m, n) in {(1, 1), (7, 33), (48, 160),
     (1500, 5000), (5000, 1500)}, K in {1, 64}, f32 and bf16 streams, on
     the GEMV-pair probe's draws (for K = 64 with D^T = E^T / lambda_max,
     a chain that contracts onto one direction; ``k2_operands``) (bars:
     K = 1 max|dx| <= 1e-5 ||x||_inf in f32 and 1e-3 in bf16; K = 64
     ||dx|| / ||x|| <= 1e-4 in f32 and 2e-2 in bf16); at (1500, 5000) the
     same bits from three launches (K = 1 and 64, f32 and bf16) and, with
     bf16 streams, from an f32 b and from b rounded to bf16 beforehand;
     its time against the plain version's (CUDA events) at (1500, 5000)
     for K = 1 and K = 64 in f32 and bf16, and against
     ``torch.linalg.multi_dot([Dt, E, b])`` in f32, the one library call
     for the pair (timed as a yardstick; the port never calls it);
  7. K3: the resident fat-LASSO kernel (``resident_lasso``) through the
     prototype's entry point (``experiments/resident_iter_proto.run``:
     the headline problem, K = 64, then 8 chained launches): z and u
     against a NumPy f64 run and against ``_resident_lasso_torch`` on the
     card (bar: max|dz| <= 1e-4 ||z||_inf, same for u), and a relaunch
     from the same state giving the same bits; its history
     against run (a)'s first 64 pnorm^2 (relative 1e-3 where pnorm^2 >=
     1e-7 pnorm^2[0], and |sqrt(pn2) - pnorm| <= 1e-3 pnorm + 1e-6 ||xopt||
     at every step); µs per step of K3 and of the plain loop;
  8. the bf16-stream slice (the headline problem with
     ``stream_dtype=torch.bfloat16``):
     (k) 16384 steps under domaxiters, unroll 64: steps == 16384, K2
         launched >= 16384 times, finite xopt of shape (5000,) on the card,
         ||xopt_k - xopt_a|| <= 2e-2 ||xopt_a||;
     (l) iter/s, best of 3 over 4096 steps, bf16 and f32 taken in turns;
     (m) elasticnet (alpha 0.5), nnls and grouplasso (50 equal groups),
         maxiters 2000, the standard stop, in f32 and with bf16 streams:
         the f32 run converges before maxiters; the bf16 run is finite,
         launches K2 at least once per step, and its objective is within
         2e-2 of the f32 run's (relative to the f32 objective; for NNLS,
         whose optimum on a fat D is ~0, relative to the objective at
         z = 0).  The bf16 run's steps are printed, not held to the stop:
         the default tolerances lie below bf16's noise floor, as
         admm_tpu's own bf16 runs show.
  9. the engine variants (slice 2) on the headline problem, maxiters 2000,
     unroll 16:
     (n) rbadaptive lasso with the fused hook: K1's z/u mode launched at
         least once per step and K1b never; steps equal within one, and
         rho_final equal, to the solve without the kernel (the margin of
         the deciding step printed) and to the solve with the z/u mode's
         plain version; max|dxopt| <= 1e-5 ||xopt||_inf against both;
     (o) anderson=5 with the fused hook: K1 once per step, converges
         before maxiters, objective within 1e-4 of (d)'s plain solve;
     (p) fast weak and fasttype='strong' with bf16 streams: K2 once per
         step; dvals, avals and restarted (strong: avals) recorded;
         ||dxopt|| / ||xopt|| <= 2e-2 against f32 streams, for strong
         over its first STRONG_STEPS steps (alg 1 has no restart and LASSO
         is not strongly convex, so its run drifts in any precision);
     (q) adaptive rho with convtest and stopcond 'both', stopcond
         'hnorm', stallwindow 20, record_iterates over 200 steps under
         domaxiters and quiet=False: finite, traces of the expected
         shapes, rho moved, one printed row per step;
     (r) the synchronising calls of (n)-(p), counted with
         torch.cuda.set_sync_debug_mode("warn"): none inside a sub-step,
         at most one per chunk plus SYNCS_OUTSIDE outside the loop.
 10. the families of slices 3 and 4 at admm_tpu/benchmarks/matrix.py's
     sizes in f32, each timed over FAMILY_TIMED_STEPS steps under
     domaxiters (unroll 'auto'; the fused lasso over FL_TIMED_STEPS) and
     held to matrix.py's f32 oracle bars (its oracle settings ORACLE:
     abstol 1e-7, reltol 1e-6, stall window 100):
     (s) basis pursuit, D 512 x 2048, x_true 10% nonzero, s = D x_true:
         the reference tester's rules, ||xopt||_1 <= ||x_true||_1 and
         mean|(D xopt - s) / D xopt| <= 1e-4 (matrix.py's f32 bar);
         ||xopt_f32 - xopt_f64|| <= 1e-3 ||xopt_f64|| against the same
         solve in f64 on the card (the stall window stops both at one step
         short of the optimum, so this measures f32's drift along the
         path); ||xopt - x_true|| / ||x_true|| printed (L1 does not
         recover x_true at this density);
     (t) the fused lasso on matrix.py's staircase, n = 8192, lam1 0.1,
         lam2 0.5: lam2 = 0 within 1e-3 of the closed-form soft threshold,
         lam1 = 0 within 2e-2 of the port's totalvariation (relative
         norms);
     (u)-(w) LAD, Huber fitting and quantile regression (tau 0.8), D
         4096 x 512, s N(0, 1): objective within 1e-2, 1e-3 and 1e-2 of
         the same solve in f64 on the card;
     (x) the linear SVM (hinge, C = 1), D 4096 x 512, ell = sign(D w0 +
         0.1 noise): objective within 1e-3 of f64 on the card;
     (y) the SVM oracle of tests/test_linearsvm.py (128 + 128 points,
         separation 0.5), hinge and 0-1 loss: slope error <= 0.05 and an
         objective below the one at x = [1, -1].
     Every run of (s)-(y) on the main path: xopt on the card, no K1-K4
     launch (these families run the generic step and no kernel), no
     synchronising call inside a sub-step and at most one per chunk plus
     SYNCS_OUTSIDE.
 11. slice 5 and the spectral half of slice 7 at matrix.py's widths in
     f32 (``programs_phase``), the timed runs under domaxiters with unroll
     'auto', the others at ORACLE:
     (z1), (z2) the LP, n = 1024, D |N(0, 1)| with n/2 rows (matrix.py's
         square D is printed beside: its f32 solve diverges), s = D |x|,
         b in [0.5, 1.5), kkt_mode 'affine' and 'chol', PROGRAM_TIMED_STEPS
         timed steps: objective within 1e-4 of f64 on the card;
     (z3) the standard-form QP, P = G G^T + n I, D N(0, 1)/sqrt(n), n/2
         rows (the square D printed beside), and (z4) the bounded QP,
         n = 2048, box [-1, 1]: x within 5e-3 of f64 on the card;
     (z5) covariance selection, D (4n, n) N(0, 1), lambda 0.1, n = 256,
         eigh and ns, and (z6) n = 512, ns, ns_fast (ns_iters 14) and
         eigh: each objective within 1e-3 of the same solve in f64 on the
         card, ns and ns_fast within 1e-3 of eigh on the card, with the
         float32 matmul mode that matmul_precision('default') selects
         measured and printed;
     (z7) the max-cut SDP (A = 'diag', 10% edges, n = 512), eigh and ns
         (ns_iters 16): Z within 1e-4 of the same steps in f64 on the card;
         (z8) the dense SDP, random_sdp_instance(128, 512, 32): Z within
         1e-3 of the same steps in f64, A(X) = b within 1e4 eps of
         rounding in f32 and f64; for both, one f32 PSD projection within
         1e-5 of f64, torch's own f32 eigh and a bf16 input printed beside
         as controls;
     (z9) matrix.py's SDP gap on random_sdp_instance(16, 24, 6): eigh
         within 1e-3, ns (ns_iters 30) within 1e-2;
     (z10) matrix.py's badly scaled LP (48 x 144, scales 10^+-2) with
         precondition=True within 2e-3 of scipy's HiGHS optimum, the steps
         without preconditioning printed.
     Every run on the main path: xopt on the card, no K1-K4 launch, no
     synchronising call inside a sub-step except the eigh proxes' (one
     each, cuSOLVER's info read back; counted and printed, not held), at
     most one per chunk plus SYNCS_OUTSIDE outside.
 12. slice 7b in f32 (``spectral_phase``), timed over SPECTRAL_TIMED_STEPS
     steps under domaxiters:
     (z11) robust PCA of rank 8 + 5% sparse at 256 x 256 (matrix.py:528-539),
         exact SVT and the randomized SVT (rank 16): L within 1e-3 of the
         same steps in f64 on the card; matrix.py's recovery oracle (96 x
         96, rank 4) within 1e-3; one f32 SVT of the rpca iterate and of a
         graded spectrum (10^0..10^-7) through every cuSOLVER route
         and of the rank-8 f64 solution (decomposed in f64, gesvd,
         gesvdj, gesvda, torch's choice) against LAPACK f64, with its time
         and syncs per call: the port's route (f64, ``ops/prox.thin_svd``)
         converges and lands within SVD_ROUTE_SLACK of the most accurate,
         the others are printed as controls (a route that fails to
         converge prints as failed);
     (z12) matrix completion of rank 8 at 512 x 512, 30% observed: the exact
         form with the randomized SVT recovers M0 within 1e-3; the exact,
         noisy (mu 20) and randomized forms within MC_BAR of the same
         MC_STEPS steps in f64; the route probe on the completion iterate
         and on an 18 x 512 sketch;
     (z13) logistic regression 4096 x 256 (matrix.py:541-570), dense Newton
         and Newton-CG: z within 1e-3 of the same steps in f64;
         logregtest's 256 x 24 instance at ORACLE within matrix.py's f32
         KKT bar 5e-3; ``logreg_batch`` with 8 one-vs-all lanes, CG and
         dense, within 1e-3 of f64.
     The SVT runs read cuSOLVER's info back in every SVD (counted and
     printed); every other run, no synchronising call inside a sub-step.
 13. slice 8 (``batch_phase``, (z14)), the lanes of matrix.py:656-800 in
     f32, each timed under domaxiters: ``lasso_path`` (128 lambdas on the
     1500 x 5000 headline-style D, 300 steps), ``lasso_batch`` (128
     signals), ``tv_batch`` (128 random walks, n = 8192, solver 'cr': the
     hybrid form), ``basispursuit_batch`` (128 at 512 x 2048),
     ``qp_batch`` (64 QPs at n = 1024, 1000 steps), ``covsel_batch`` (32
     at n = 128, ns and ns_fast, 200 steps) and ``sdp_batch`` (16 max-cut
     relaxations at n = 128, eigh and ns, 100 steps): instance-iterations
     per second, sub-steps per second and CUDA launches per step
     (torch.profiler), synchronising calls counted (none inside a
     sub-step but the batched eigh's); for CHECK_LANES lanes of each, the
     f64 batch against the port's serial f64 solves on the card (equal
     steps, x to 1e-9) and the f32 lanes against the f64 lanes within
     matrix.py's f32 bar of the family; ``tv_batch`` launches K4 exactly
     once per sub-step on (128, 8192), and the converging run equals the
     run with the plain b-phase (equal per-lane steps, x within 1e-6
     ||x||_inf).
 14. slice 9 and slice 11's single-device half (``hypergradient_phase``,
     (z15)), after one untimed warm-up:
     (z15a) the TV hypergradient d MSE(x*, truth) / d(lam, s) through
         ``make_implicit_solver`` (Neumann, ``mode='vjp'``) on
         ``staircase_pair(65536)``, lam 0.5, the hybrid cyclic reduction,
         f32: K4 in the forward, K4 in the backward once per J^T
         application plus 3 (the linearization at w*, the data VJP's
         primal and pullback) and no other kernel, the backward's host
         reads its only synchronising calls; the same gradients with the
         plain b-phase (``_prox_f_cr_plain``, no K4) within 1e-5, f32
         within 1e-3 of f64 on the card, the f64 d/dlam within 2e-4 of a
         central difference of two f64 solves, and ``mode='jvp'`` within
         1e-6 of ``mode='vjp'`` in f64; wall times, adjoint steps and host
         reads printed;
     (z15b) per-lane d loss_i / d lam_i through ``make_implicit_batch_solver``
         on 128 random walks plus noise (n = 8192, ``tv_batch``'s hybrid
         form), f64: K4 once per J^T application of all lanes plus 2, lanes
         0, 63 and 127 equal to the serial f64 gradients to 1e-9;
     (z15c) d sum(x*^2) / d lam of the headline LASSO (1500 x 5000, the
         cuBLAS pair, no kernel) in f32 within 1e-3 of f64; with bf16
         streams within 2e-2 of f32, K2 in the forward and in the
         backward once per J^T application (its transposed pair) plus 2,
         no other kernel there;
     (z15d) every tester of ``testers/problems.py`` passes its default
         instance on the card in f64, ``solvertester('lasso', 4, 6,
         trials=2, seed=0)`` reports no failure, ``showresults`` prints its
         text, ``iteration_rate`` and ``trace`` run (the trace goes to
         build/z15_trace/).
     K4's launches in (z15a)'s f32 and (z15b)'s forward and backward, and
     K2's in (z15c)'s bf16 forward and backward, join their rows of the
     JSON line (``launches_by_path``).
 15. slice 11b (``slice11b_phase``, (z16)) through the CLI and the examples:
     (z16a) ``python -m admm_tpu_torch matrix --steps 50``: every
         timing row of admm_tpu/benchmarks/matrix.py at its width, the
         twelve sharded rows among them with their shards stacked on the
         card (its 40-16000 timed steps cut to at most 50), each printed
         with its bound, ran to a finite result; K1b, K2 and K4 launched
         on their rows (the fused, the bf16-stream and the
         cyclic-reduction TV rows);
     (z16b) the same command's f32 accuracy rows at their own settings,
         each within admm_tpu's bar (``_F32_ERRTOL``, unchanged);
     (z16c) ``sweep --smoke``: the ten families, exit 0 only when all pass;
     (z16d) ``mnistsvm()`` at its defaults (6000 x 400, ten digits, hinge
         and 0-1 loss on ``svm_batch``'s lanes), a lane equal to the serial
         solve in f64;
     (z16e) each other example once at its defaults (the acceleration
         example's step caps cut from 20000 / 40000 to 6000 / 20000), with
         its own test's checks.
     Rows that fail on the card are recorded faults (ROADMAP.md queue 3),
     named in ``Z16_KNOWN_*``; any other failure fails the script.  The
     matrix and sweep documents go to chiprun_out/.
 16. slice 10a, the distributed layer with its W shards stacked on the
     card (``slice10a_phase``, (z17)):
     (z17a) ``consensus_lasso`` in f32, W = 8 shards of Z17_ROWS = 65536
         rows, n = 1024 (D 2 GiB on the card, drawn from a seeded
         generator there; lambda = 0.1 ||D^T s||_inf): a converging solve
         with the same steps as the same solve in f64 on the card (or one
         step apart, the deciding step's margin printed) and an objective
         within 1e-2 of the serial f64 ``lasso`` on the same D
         (tests/test_parallel.py's bar); Z17_TIMED_STEPS steps under
         domaxiters timed: iter/s, synchronising calls per sub-step
         (none); then one run of the same steps on the per-shard set-up
         built once beforehand (``consensus_admm``) under torch.profiler:
         its CUDA launches per step and the device's busy share (its
         kernel time over that run's own loop wall time), the bound
         printed with the L2 note where the Minv stack fits in L2;
     (z17b) the other runners at matrix.py's widths in f32, each on the
         main path and against its own oracle: ``linearsvm_sharded``
         (4096 x 512, 8 shards) within 1e-3 of the serial ``linearsvm``'s
         hinge objective; ``exchange_quadratic`` (8 agents, 512 x 256)
         within 1e-3 of the f64 market equilibrium; ``sdp_sharded``
         (random_sdp_instance(128, 512, 32), 8 shards) within 1e-3 of the
         serial ``sdp``'s objective; ``consensus_covsel`` eigh and ns
         (p = 256, 4096 samples, 8 shards) within 1e-3 of the serial
         ``covarianceselection``'s objective; ``consensus_logreg`` (4096 x
         256, 8 shards) within 5e-3 of the serial ``logreg``'s objective;
         ``consensus_lasso_batch`` (8 lanes), ``svm_batch_sharded`` (10
         lanes) and ``consensus_covsel_batch`` (2 lanes, p = 64) in f64,
         lanes equal to their single solves (steps, x to 1e-9); a sliced
         ``admm(parallel='both')`` (n = 2048, 8 slices) equal to the
         unsliced solve in f64.
     No run of (z17) launches K1-K4 (the z-steps are soft thresholds on
     the aggregate, a per-shard solve is a batched GEMV); none reads the
     host inside a sub-step but the eigh proxes (counted and printed).
 17. slice 10b, the shard axis over processes (``slice10b_phase``, (z18)):
     (z18a) a one-rank NCCL process group in this process
         (``initialize_cluster(backend="nccl")``, ``global_mesh()``) running
         (z17a)'s converging solve: steps, x, z, u, xi, ui and every
         history equal to (z17a)'s stacked run bit for bit, 2 all_reduce a
         step (2n + 1 floats) and one all_gather; Z18_TIMED_STEPS steps
         timed (iter/s beside (z17a)'s) and profiled as (z17a)'s (CUDA
         launches and device us a step beside (z17a)'s); the NCCL
         all_reduce at a step's payloads (``collective_microbench``);
     (z18b) two gloo ranks spawned on the one card (``Z18B_WORKER``), each
         its block of 4 of the 8 shards: (z17a)'s consensus LASSO
         (converging, then timed), the gloo all_reduce at a step's
         payloads, and ``z18b_runs`` in f64: ``linearsvm_sharded``,
         ``exchange_quadratic``, ``sdp_sharded``, a sliced
         ``admm(parallel='both')``, ``consensus_lasso_batch`` on a 2-D
         mesh (each rank its lane row) and the implicit consensus solver's
         gradient (rho ``IMPLICIT_RHO``, Z18B_ADJOINT_STEPS Neumann steps);
         every result the same
         bits on both ranks, the
         stacked run's steps (or one apart, the deciding pnorm printed),
         the objective (or gradient) within 1e-5 of the stacked run's and
         within (z17b)'s bar of serial f64 (``Z18B_BARS``); the same five
         runners in f32, the same bits on both ranks and within
         ``Z18B_F32_BAR`` of serial f64, their steps and objective printed
         beside the stacked f32 run's and beside a stacked f32 run of the
         same data with the shard blocks in reverse order (the witness of
         how far the order of a shard sum alone moves an f32 stop);
     (z18c) the same consensus LASSO over two NCCL ranks, a card each,
         where the machine has two cards; else one line saying it did not
         run and why;
     (z18d) ``python -m admm_tpu_torch scaling --devices 8 --iters 50`` and
         ``scaling --predict``, each exit 0.
     The sliced solve's inputs are made on the card, so over the ranks it
     equals the stacked run bit for bit, in f64 and in f32.
     No run of (z18) launches K1-K4 (each gloo rank checks its own).
 18. slice 10c (``slice10c_phase``, (z19)):
     (z19a) ``consensus_lasso_batch`` at full width (4 lanes of (z17a)'s
         8 x 65536 x 1024 f32 problem, lambdas ``Z19_LANES`` times its
         own) on ``make_mesh2d(1, 8)`` over two gloo ranks on the card
         (``Z19_WORKER``), each rank 4 shards of every lane, the shard-axis
         means over the lane row's group: the stacked 4 x 8 run's steps,
         each lane's objective within 1e-5 of it (the f32 spread printed),
         the collectives a sub-step from ``Mesh.stats``, iter/s a rank;
     (z19b) the implicit consensus LASSO's gradient (8 shards of 512 x 64,
         f64, rho ``IMPLICIT_RHO``) with ``vjp_method='gmres'`` over the two
         ranks: within 1e-10 of the stacked GMRES gradient and 1e-5 of the
         stacked Neumann gradient;
     (z19c) ``vmap(grad(loss))`` over the serial TV implicit solve at
         n = 65536 f32 for the four lambdas of ``Z19C_LAMS``: each lane
         within 1e-5 of the serial gradient, one K4 launch of all lanes
         per J^T application of the backward;
     (z19d) ``totalvariation(solver='cr_packed')`` at n = 65536 in f32 and
         f64 against the hybrid (f64: its steps, 1e-9; f32: 1e-4), K1b-D
         launched once per sub-step and no other kernel, and one packed
         solve's device time beside K4's;
     (z19e) NumPy's inverse of a 2048-square matrix in this process and in
         a rank with one thread: how many f32 entries differ (why (z18b)
         makes the sliced solve's inputs on the card).

Kernel times are device times: CUDA events around replays of a CUDA
graph that holds several calls (``graph_ms``), so that the host's time per
call, which the short calls would otherwise show, drops out; the
host-issued times are printed beside them.  Every failed check raises, so
the script exits non-zero.  It prints, on
lines before the last, the card's name and power limit and one JSON line
``{"kernels": [...]}`` with each kernel's launches on its main path, its
error against its plain version, its time, the plain version's, the
library call's where there is one, and its bound: the larger of the bytes
it must move (each input read once, each output written once) over
3.35 TB/s and its operations over 67 TFLOP/s (f32 outside the tensor
cores), the H100 SXM's data-sheet peaks; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It exits non-zero, printing no result, when no CUDA device is visible.
The CUDA kernels build into build/kernels/ in the checkout.
"""

import contextlib
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
KERNEL_SIZES = (64, 1000, 5000, 8192, 70000, 2**20)
HEADLINE_STEPS = 16384
# K4 cases: (lanes, n, dense_cutoff).
K4_CASES = ([(1, n, None) for n in (1, 2, 3, 7, 64, 255, 1000, 8192)]
            + [(8, 8192, None), (128, 8192, None), (1, 5000, 63), (1, 65536, 1023)]
            # The tile boundaries of the hybrid form (tiles of 512 rows or
            # more, halo 2^k - 1), the batched lanes, and one lane too long
            # for shared memory in f64.
            + [(1, 3077, 63), (3, 3072, 63), (1, 2049, 7), (3, 65537, 1023),
               (128, 8192, 1023), (3, 20000, None)])
# Timed K4 shapes: TV (h)'s pure masked solve, TV (f)'s hybrid solve (the
# one the JSON line reports), and the batched TV lanes' hybrid solve.
K4_TIMED = ((1, 8192, None), (1, 65536, 1023), (128, 8192, 1023))
TV_MAXITERS = 2000
TV_TIMED_STEPS = 2000
TV_LAM = 0.5
K1B_SIZES = (1, 7, 1000, 5000, 70000)
K1B_D_SIZES = (1, 2, 257, 4097, 65536, 65537)  # 2c: block and tile edges, TV (f)'s n
K1B_N = 12  # maxiters of K1b's test state
K2_SHAPES = ((1, 1), (7, 33), (48, 160), (1500, 5000), (5000, 1500))
K2_DEEP = 64
BF16_TIMED_STEPS = 4096
FAMILY_MAXITERS = 2000
VARIANT_MAXITERS = 2000  # slice 2's runs (n)-(q)
STRONG_STEPS = 10  # (p): alg 1's bar, before its momentum's drift dominates
RECORD_STEPS = 200  # (q): record_iterates under domaxiters
SYNCS_OUTSIDE = 64  # (r): the set-up's and the results' synchronising calls
# (s), (u)-(x): matrix.py times these rows over 8000 steps; cut to 2000 to
# keep the script's time (each generic step issues ~70 launches from the
# host).
FAMILY_TIMED_STEPS = 2000
FL_TIMED_STEPS = 2000  # (t): matrix.py's dense-TV rows at this width run 500-8000
BP_SHAPE = (512, 2048)
REG_SHAPE = (4096, 512)
FL_N = 8192
# matrix.py's f32 oracle settings (accuracy_matrix, _beyond_reference_accuracy).
ORACLE = dict(maxiters=20000, abstol=1e-7, reltol=1e-6, stallwindow=100, unroll="auto")
# (z1)-(z10): matrix.py's widths; its timed steps cut to keep the script's
# time (LP 16000 and bounded QP 8000 to 2000).
LP_N = 1024
QPB_N = 2048
PROGRAM_TIMED_STEPS = 2000
COVSEL_N = (256, 512)  # (z5) eigh and ns, (z6) ns and ns_fast against eigh
COVSEL_TIMED_STEPS = 200
SDP_DIAG_N = 512
SDP_DIAG_TIMED_STEPS = 40
SDP_DENSE = (128, 512, 32)
SDP_DENSE_TIMED_STEPS = 100
# Slice 11b (z16): matrix.py's timed steps (40-16000 a row) cut to at most
# Z16_STEPS to keep the script's time; its rows, and the faults the card has
# shown (ROADMAP.md queue 3), by name.
Z16_STEPS = 50
# The acceleration example's caps, 20000 and 40000, cut (its plain LASSO
# converges in ~5400 steps, its fast one and its plain LPs burn the cap).
Z16_LADDER_STEPS, Z16_LP_STEPS = 6000, 20000
Z16_TIMED_ROWS, Z16_ACCURACY_ROWS = 59, 26
Z16_KNOWN_TIMING_FAULTS = set()
Z16_KNOWN_F32_FAULTS = set()
# The standard QP's f32 bar at 2^5 (seed 7): admm_tpu's own f32 sweep fails
# the same cell (ROADMAP.md queue 3).
Z16_KNOWN_SWEEP_FAULTS = {"quadraticprogram"}
# Slice 10a (z17): the stacked consensus LASSO of (z17a), rows per shard
# and columns, its timed steps, and (z17b)'s converging settings.
Z17_W, Z17_ROWS, Z17_N = 8, 65536, 1024
Z17_TIMED_STEPS = 2000
Z17_ORACLE = dict(maxiters=5000, abstol=1e-7, reltol=1e-6, stallwindow=100, unroll="auto")
# Slice 10b (z18): the timed steps of (z18a) and of each gloo rank's
# full-width run, the ranks' time limit, and (z18b)'s bars against serial
# f64 ((z17b)'s objective gaps, the exchange's cost against its f64
# equilibrium's; the f64 sliced solve and lanes 1e-9; the gradient has none).
Z18_TIMED_STEPS = 500
Z18B_TIMEOUT_S = 600
Z18B_ADJOINT_STEPS = 100  # the gradient's Neumann steps (the same cap on every run)
# The implicit consensus gradients' rho ((z18b), (z19b)): the forward
# converges in tens of steps and Neumann in hundreds (at rho = 1 the
# forward ran its 4000-step cap, 24 s over the gloo ranks).
IMPLICIT_RHO = 30.0
Z18B_BARS = {"linearsvm_sharded": 1e-3, "exchange_quadratic": 1e-3, "sdp_sharded": 1e-3,
             "sliced_both": 1e-9, "consensus_lasso_batch": 1e-9, "implicit_consensus": None}
# The f32 runs of (z18b)'s runners against serial f64: (z17b)'s 1e-3 bar of
# the f32 SVM, exchange and SDP, for the sliced solve and the lanes too.
Z18B_F32_RUNNERS = ("linearsvm_sharded", "exchange_quadratic", "sdp_sharded", "sliced_both",
                    "consensus_lasso_batch")
Z18B_F32_BAR = 1e-3
# The f32 exchange's steps, cut from the oracle's 5000 for time (it stalls
# at none and ran all 5000 in (z17b)).
Z18B_F32_EXCHANGE_STEPS = 3000
# Slice 7b (z11)-(z13) and slice 8 (z14).
# Slice 10c, (z19): lanes x shards over ranks, GMRES over a group, vmap
# over the implicit solvers, the packed cyclic reduction.
Z19_LANES = (0.5, 1.0, 1.5, 2.0)     # (z19a): the lanes' lambdas, in units of (z17a)'s
Z19_TIMED_STEPS = 200
Z19B_VJP_TOL = 1e-10
Z19B_VJP_MAXITERS = {"gmres": 50, "neumann": 20000}   # restart cycles; Neumann steps
Z19C_LAMS = (0.3, 0.4, 0.5, 0.6)     # about TV_LAM, (z15a)'s
Z19D_BARS = {"float32": 1e-4, "float64": 1e-9}
Z19E_N = 2048                         # the sliced solve's order ((z18b))

RPCA_N = 256
RPCA_RANK = 16
SPECTRAL_TIMED_STEPS = 200
SVD_ROUTES = ("f64", "gesvd", "gesvdj", "gesvda", None)
SVD_ROUTE_SLACK = 2.0
MC_N, MC_RANK, MC_P = 512, 8, 0.3
MC_STEPS = 30
# Set from its readings on an H100 80GB HBM3 at 700 W: 7.3e-7 (exact, noisy), 2.2e-6 (rsvd).
MC_BAR = 1e-5
LOGREG_SHAPE = (4096, 256)
LANES = 128
LANE_STEPS = 300
PATH_SHAPE = (1500, 5000)
TV_BATCH_N = 8192
QP_LANES, QP_N, QP_STEPS = 64, 1024, 1000
COVSEL_LANES, COVSEL_BN, COVSEL_STEPS = 32, 128, 200
SDP_LANES, SDP_BN, SDP_STEPS = 16, 128, 100
CHECK_LANES = 4
CHECK_MAXITERS = 2000
# The SDP lanes' checks stop early to bound the phase's time (the batched f64
# eigh loops over the lanes' matrices; ns takes ~500 steps to converge).
CHECK_STEPS = {"sdp_batch eigh": 50, "sdp_batch ns": 200}
# (z15): slice 9's implicit differentiation and slice 11's harness.  The
# f32 stop and adjoint tolerances sit above f32's floor (an f32 Neumann
# adjoint of the headline lasso stalls near 1e-6 relative), f64's far below.
HG_N = 65536
HG_LANES, HG_LANE_N = 128, 8192
HG_CHECK = (0, 63, 127)
HG_MAXITERS = 5000
HG_STOP = {"float32": dict(abstol=1e-6, reltol=1e-6), "float64": dict(abstol=1e-10, reltol=1e-10)}
# bf16 streams: the adjoint's residual floors near 4e-3 relative (its J^T
# applications round to bf16), so it stops at 1e-2.
HG_VJP_TOL = {"float32": 1e-5, "float64": 1e-10, "bfloat16": 1e-2}
HG_VJP_MAXITERS = 5000
HG_LANE_TOL = 1e-12  # (z15b)'s f64 stop and adjoint tolerance
HG_FD_H = 2e-5
# H100 SXM peaks from NVIDIA's data sheet.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def bound(nbytes, flops):
    """(ms, 'bytes' or 'operations'): the least time the card could take
    to move ``nbytes`` and do ``flops`` f32 operations, whichever is
    longer."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")
    print(f"  ok: {what}")


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps):
    """Mean device time of one call of fn over reps calls (CUDA events),
    after a warm-up."""
    import torch

    for _ in range(10):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def kernel_phase(dev):
    """K1, the z/u mode of ``csrc/zu_tail.cu``, against its plain version;
    returns (max_abs_err, ms, plain_ms, (bound_ms, bound_by))."""
    import torch

    from admm_tpu_torch.benchmarks.timing import graph_ms
    from admm_tpu_torch.ops.kernels import _fused_torch, fused_soft_threshold_dual

    print("kernel: fused_soft_threshold_dual (CUDA C++, z/u mode) vs _fused_torch")
    worst = 0.0
    for dtype in (torch.float32, torch.float64):
        for n in KERNEL_SIZES:
            rng = np.random.default_rng(n)
            x = torch.from_numpy(rng.standard_normal(n)).to(dev, dtype)
            u = torch.from_numpy(rng.standard_normal(n)).to(dev, dtype)
            t = torch.tensor(0.37, dtype=dtype, device=dev)
            z_k, u_k = fused_soft_threshold_dual(x, u, t)
            torch.cuda.synchronize()
            z_t, u_t = _fused_torch(x, u, t)
            dz = float(torch.max(torch.abs(z_k - z_t)))
            du = float(torch.max(torch.abs(u_k - u_t)))
            print(f"  {str(dtype):14s} n={n:8d}  max_abs_diff z={dz:.3e} u'={du:.3e}")
            check(dz == 0.0 and du == 0.0 and torch.isfinite(z_k).all(),
                  f"kernel == twin bit for bit ({dtype}, n={n})")
            worst = max(worst, dz, du)

    n = 5000  # the headline's vector length, f32
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(n)).to(dev, torch.float32)
    u = torch.from_numpy(rng.standard_normal(n)).to(dev, torch.float32)
    t = torch.tensor(0.37, dtype=torch.float32, device=dev)
    kernel = lambda: fused_soft_threshold_dual(x, u, t)  # noqa: E731
    plain = lambda: _fused_torch(x, u, t)  # noqa: E731
    host = [time_ms(f, 2000) for f in (kernel, plain, plain, kernel)]
    dev_t = [graph_ms(f, 2000) for f in (kernel, plain, plain, kernel)]
    # x, u and t in, z and u out; |v| - t, max, sign, product, two adds.
    bound_ms = bound(4 * n * 4 + 4, 6 * n)
    print(f"  n=5000 f32 per call, device (graph replay): kernel {dev_t[0]:.6f} / "
          f"{dev_t[3]:.6f} ms, plain {dev_t[1]:.6f} / {dev_t[2]:.6f} ms; host-issued: "
          f"kernel {host[0]:.5f} / {host[3]:.5f} ms, plain {host[1]:.5f} / {host[2]:.5f} ms "
          f"(CUDA events, 2000 calls each); bound {bound_ms[0]:.6f} ms ({bound_ms[1]})")
    return worst, min(dev_t[0], dev_t[3]), min(dev_t[1], dev_t[2]), bound_ms


def _same(a, b):
    """Equal values, NaN where the other has NaN."""
    import torch

    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


# K1b's checks: (state k, done, abstol, the tail's flags, a NaN in x_new).
K1B_CASES = {
    "step": (3, 0, 1e-4, {}, False),
    "stop": (3, 0, 1e3, {}, False),
    "last": (K1B_N - 1, 0, 1e-4, {}, False),
    "done": (3, 1, 1e-4, {}, False),
    "k = N": (K1B_N, 0, 1e-4, {}, False),
    "nodualerror": (3, 0, 1e3, {"nodualerror": True}, False),
    "domaxiters": (3, 0, 1e3, {"domaxiters": True}, False),
    "nan": (3, 0, 1e-4, {}, True),
}


def k1b_inputs(dev, dtype, n, k, done, abstol, nan, seed=0):
    """One K1b call's operands from a seed: (x_new, x, z, u, lam, rho,
    state, hist) and the tail's tolerances."""
    import torch

    rng = np.random.default_rng(seed + n)
    vecs = [torch.from_numpy(rng.standard_normal(n)).to(dev, dtype) for _ in range(4)]
    if nan:
        vecs[0][n // 2] = float("nan")
    lam = torch.tensor(0.3, dtype=dtype, device=dev)
    rho = torch.tensor(1.7, dtype=dtype, device=dev)
    state = torch.tensor([k, done, 0], dtype=torch.int64, device=dev)
    hist = torch.full((4, K1B_N + 1), float("nan"), dtype=dtype, device=dev)
    tol = dict(perr_abs=float(np.sqrt(n)) * abstol, derr_abs=float(np.sqrt(n)) * abstol,
               reltol=1e-3)
    return [*vecs, lam, rho, state, hist], tol


def k1b_phase(dev, diff=False):
    """K1b, the tail mode of ``csrc/zu_tail.cu`` (``diff``: its
    difference-operator mode K1b-D, ``fused_diff_tail``), against its plain
    version; returns (max_abs_err over x, z, u and the norms, [(ms,
    plain_ms, (bound_ms, bound_by))]), the times at n = 5000 f32 (K1b-D:
    at n = 65536, f32 then f64)."""
    import torch

    from admm_tpu_torch.benchmarks.timing import graph_ms
    from admm_tpu_torch.linop import DiffOp
    from admm_tpu_torch.ops.kernels import (_fused_zu_tail_torch, fused_diff_tail,
                                            fused_zu_tail, zu_tail_scratch)

    tag, fused = ("K1b-D", fused_diff_tail) if diff else ("K1b", fused_zu_tail)

    def twin(*ops, **kw):
        _fused_zu_tail_torch(*ops, op=DiffOp(ops[0].numel()) if diff else None, **kw)

    print(f"kernel: {fused.__name__} (CUDA C++, tail mode {tag}) vs _fused_zu_tail_torch"
          f"{' with op=DiffOp(n)' if diff else ''}")
    worst = 0.0
    sizes = K1B_D_SIZES if diff else K1B_SIZES
    for dtype in (torch.float32, torch.float64):
        rtol = 1e-5 if dtype == torch.float32 else 1e-12
        bits = torch.int32 if dtype == torch.float32 else torch.int64
        worst_rel = 0.0
        for n in sizes:
            for case, (k, done, abstol, flags, nan) in K1B_CASES.items():
                ops, tol = k1b_inputs(dev, dtype, n, k, done, abstol, nan)
                kw = dict(tol, domaxiters=False, nodualerror=False, nanguard=True)
                kw.update(flags)
                plain, kern, again = ([t.clone() for t in ops] for _ in range(3))
                twin(*plain, **kw)
                fused(*kern, **kw)
                fused(*again, **kw)
                torch.cuda.synchronize()
                what = f"({dtype}, n={n}, {case})"
                check(all(_same(a, b) for a, b in zip(kern[1:4], plain[1:4]))
                      and torch.equal(kern[6], plain[6]),
                      f"{tag} x, z, u and state == plain bit for bit {what}")
                # The norms: the written column within rtol, NaN where the
                # plain version has NaN, so every other column untouched.
                hk, hp = kern[7], plain[7]
                nan_p = torch.isnan(hp)
                diff_ = torch.abs(hk - hp)[~nan_p]
                rel = diff_ / torch.abs(hp)[~nan_p]
                worst_rel = max(worst_rel, float(rel.max()) if rel.numel() else 0.0)
                worst = max(worst, float(diff_.max()) if diff_.numel() else 0.0)
                check(torch.equal(torch.isnan(hk), nan_p) and bool(torch.all(rel <= rtol)),
                      f"{tag} norms within {rtol} of plain, same slot {what}")
                check(all(torch.equal(a.view(bits), b.view(bits))
                          for a, b in zip(kern[1:4] + kern[7:], again[1:4] + again[7:]))
                      and torch.equal(kern[6], again[6]), f"{tag} same bits on two launches {what}")
                if not nan:
                    # Away from ties: pnorm and perr (dnorm and derr) lie far
                    # more than rtol apart, so the values decide the flags.
                    col = hp[:, ~nan_p.all(0)].double().cpu().numpy()[:, 0]
                    check(abs(col[0] - col[2]) > 1e3 * rtol * col[2]
                          and (np.isnan(col[1]) or abs(col[1] - col[3]) > 1e3 * rtol * col[3]),
                          f"{tag} case away from a stop tie {what}")
        print(f"  {dtype}: max relative norm error {worst_rel:.3e} over "
              f"{len(sizes) * len(K1B_CASES)} cases")

    # Time per call at the headline's n in f32 (K1b-D: TV's n, f32 and
    # f64), under domaxiters on a history long enough that no call of the
    # timing freezes.
    rows = []
    for n, dtype in ((65536, torch.float32), (65536, torch.float64)) if diff else (
            (5000, torch.float32),):
        ops, tol = k1b_inputs(dev, dtype, n, 0, 0, 1e-4, False)
        ops[7] = torch.full((4, 10**6 + 1), float("nan"), dtype=dtype, device=dev)
        tol.update(domaxiters=True, nodualerror=False, nanguard=True)
        scratch = zu_tail_scratch(n, dtype, dev, diff=diff)
        kernel = lambda: fused(*ops, scratch=scratch, **tol)  # noqa: E731
        plain = lambda: twin(*ops, **tol)  # noqa: E731
        dev_t = [graph_ms(f, 2000) for f in (kernel, plain, plain, kernel)]
        host = time_ms(kernel, 2000)
        k, done, _ = ops[6].tolist()
        check(done == 0 and 2000 <= k < 10**6, f"{tag} timing state never froze (k = {k})")
        # x_new, z, u read (the freeze keeps x by not writing it); x, z, u
        # written; ~20 operations an element (~30 with K1b-D's stencils).
        bound_ms = bound(6 * n * dtype.itemsize, (30 if diff else 20) * n)
        dn = str(dtype).split(".")[-1]
        print(f"  n={n} {dn} per call, device (graph replay): kernel {dev_t[0]:.6f} / "
              f"{dev_t[3]:.6f} ms, plain {dev_t[1]:.6f} / {dev_t[2]:.6f} ms; host-issued kernel "
              f"{host:.5f} ms (CUDA events, 2000 calls each); bound {bound_ms[0]:.6f} ms "
              f"({bound_ms[1]})")
        rows.append((min(dev_t[0], dev_t[3]), min(dev_t[1], dev_t[2]), bound_ms))
    return worst, rows


def slice_phase(dev):
    """The main path; returns K1b's launch count in run (a), the z/u mode's
    in (d)'s user-hook run, run (a) itself and (d)'s plain run."""
    import torch

    from admm_tpu_torch import ADMMConfig, Hooks, admm, lasso
    from admm_tpu_torch.benchmarks.headline import (
        make_problem, numpy_lasso_pnorm, steps_to_rms_residual)
    from admm_tpu_torch.config import matmul_precision
    from admm_tpu_torch.models.lasso import make_prox_ops
    from admm_tpu_torch.ops.kernels import fused_soft_threshold_dual as k1
    from admm_tpu_torch.ops.kernels import fused_zu_tail as k1b

    D, s, lam = make_problem()
    m, n = D.shape
    cfg = ADMMConfig(maxiters=HEADLINE_STEPS, domaxiters=True, unroll=64)
    print(f"slice: lasso {m}x{n} f32, lam={lam:.6g}, {cfg.maxiters} steps, unroll {cfg.unroll}")

    # (a) the main path, counted.
    k1b.launches = 0
    a = lasso(D, s, lam, cfg, use_fused_kernel=True, device=dev)
    torch.cuda.synchronize()
    launches = k1b.launches
    print(f"  (a) fused: steps={a.steps} K1b launches={launches} runtime={a.runtime:.4f}s "
          f"setup+solve={a.solverruntime:.4f}s")
    check(a.steps == HEADLINE_STEPS, f"(a) steps == {HEADLINE_STEPS}")
    check(launches >= HEADLINE_STEPS, f"(a) K1b launches {launches} >= {HEADLINE_STEPS}")
    check(a.xopt.device.type == "cuda" and tuple(a.xopt.shape) == (n,),
          "(a) xopt on the card with shape (5000,)")
    check(bool(torch.isfinite(a.xopt).all()) and not a.diverged, "(a) xopt finite")

    # (b) the same without the kernel.
    b = lasso(D, s, lam, cfg, use_fused_kernel=False, device=dev)
    diff = float(torch.max(torch.abs(a.xopt - b.xopt)))
    xinf = float(torch.max(torch.abs(a.xopt)))
    print(f"  (b) plain: steps={b.steps} runtime={b.runtime:.4f}s; "
          f"max|xopt_a - xopt_b| = {diff:.3e}, ||xopt||_inf = {xinf:.6g}, "
          f"ratio {diff / xinf:.3e}")
    check(b.steps == HEADLINE_STEPS, f"(b) steps == {HEADLINE_STEPS}")
    check(diff <= 1e-6 * xinf, "(b) max|xopt_fused - xopt_plain| <= 1e-6 ||xopt||_inf")

    # (c) steps to an RMS residual of 1e-6 against NumPy float64.
    steps_port = steps_to_rms_residual(a.pnorm, n)
    ref_pnorm = numpy_lasso_pnorm(D.astype(np.float64), s.astype(np.float64),
                                  lam, cfg.rho, iters=200)
    steps_np = steps_to_rms_residual(ref_pnorm, n)
    print(f"  (c) steps_to_rms_residual_1e-6: port f32 {steps_port}, "
          f"NumPy f64 {steps_np} (admm_tpu BENCH_r05.json records 60)")
    check(steps_port is not None and steps_np is not None
          and abs(steps_port - steps_np) <= 1, "(c) equal within one step")

    # (d) a converging run, stop rule on.
    cfg_d = ADMMConfig(maxiters=2000, unroll=16)
    d_fused = lasso(D, s, lam, cfg_d, use_fused_kernel=True, device=dev)
    d_plain = lasso(D, s, lam, cfg_d, use_fused_kernel=False, device=dev)
    # The same solve through a user hook: the generic tail and K1's z/u mode.
    with matmul_precision("highest"):
        prox_f, prox_g, _, data = make_prox_ops(
            torch.as_tensor(D, device=dev), torch.as_tensor(s, device=dev), lam, cfg_d)
    k1.launches = 0
    d_hook = admm(prox_f, prox_g, cfg_d, m=n, nA=n, nB=n, data=data, dtype=torch.float32,
                  hooks=Hooks(fused_zu=lambda x, u, rho, d: k1(x, u, d["lam"] / rho)))
    torch.cuda.synchronize()
    zu_launches = k1.launches
    print(f"  (d) converging: steps fused={d_fused.steps} plain={d_plain.steps} "
          f"user hook={d_hook.steps} (z/u mode launches {zu_launches})")
    check(d_fused.steps < 2000 and not d_fused.diverged, "(d) converges before 2000")
    for name, r in (("fused", d_fused), ("user hook", d_hook)):
        if r.steps != d_plain.steps:
            # The stop fell one step apart: print the margin that decided it.
            k = min(r.steps, d_plain.steps) - 1
            print(f"  (d) {name} vs plain at step {k + 1}: pnorm/perr "
                  f"{r.pnorm[k]:.9g}/{r.perr[k]:.9g} vs "
                  f"{d_plain.pnorm[k]:.9g}/{d_plain.perr[k]:.9g}, dnorm/derr "
                  f"{r.dnorm[k]:.9g}/{r.derr[k]:.9g} vs "
                  f"{d_plain.dnorm[k]:.9g}/{d_plain.derr[k]:.9g}")
        check(abs(r.steps - d_plain.steps) <= 1, f"(d) {name} and plain steps within one")
    check(zu_launches >= d_hook.steps, f"(d) z/u mode launches {zu_launches} >= steps "
          f"{d_hook.steps}")
    check(bool(torch.isfinite(d_fused.xopt).all()), "(d) xopt finite")

    # (e) iter/s, best of 3 each, in turns (a is the first fused run).
    fused_t, plain_t = [a.runtime], [b.runtime]
    for fused, times in ((False, plain_t), (True, fused_t), (True, fused_t),
                         (False, plain_t)):
        r = lasso(D, s, lam, cfg, use_fused_kernel=fused, device=dev)
        times.append(r.runtime)
    print(f"  (e) runtimes s: fused {['%.4f' % t for t in fused_t]}, "
          f"plain {['%.4f' % t for t in plain_t]}")
    print(f"  (e) iter/s best of 3: fused {HEADLINE_STEPS / min(fused_t):.1f}, "
          f"plain {HEADLINE_STEPS / min(plain_t):.1f}")
    return launches, zu_launches, a, d_plain


@contextlib.contextmanager
def counting_syncs():
    """Count the synchronising CUDA calls of a solve, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them: yields a dict
    whose "steps" counts those inside the engine's sub-steps, "substeps"
    the sub-steps, "chunks" the chunks (each ends in one read of the stop
    flag) and, on exit, "solve" all of the solve's, set-up included."""
    import warnings

    import torch

    from admm_tpu_torch import engine

    got = {"steps": 0, "substeps": 0, "chunks": 0, "solve": 0}
    run_chunks = engine._run_chunks
    tally = [0, 0]  # warnings looked at, synchronising calls among them
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")

        def syncs():
            tally[1] += sum("called a synchronizing" in str(w.message) for w in seen[tally[0]:])
            tally[0] = len(seen)
            return tally[1]

        def counted(step, flags, N, K, table=None, graph=None, **kw):
            def one_step():
                before = syncs()
                step()
                got["steps"] += syncs() - before
                got["substeps"] += 1

            def read():
                got["chunks"] += 1
                return flags()

            if graph is None:
                return run_chunks(one_step, read, N, K, table, **kw)

            def chunk(step_, flags_, K_):
                # Replays run the K sub-steps without host code: count them.
                got["chunks"] += 1
                before = got["substeps"]
                out = graph(step_, flags_, K_)
                got["substeps"] = before + K_
                return out

            return run_chunks(one_step, flags, N, K, table, graph=chunk, **kw)

        engine._run_chunks = counted
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield got
        finally:
            torch.cuda.set_sync_debug_mode("default")
            engine._run_chunks = run_chunks
            got["solve"] = syncs()


def lasso_objective(D, s, lam, z):
    """LASSO's objective at z in NumPy f64."""
    z = z.double().cpu().numpy()
    return 0.5 * np.sum((D @ z - s) ** 2) + lam * np.sum(np.abs(z))


def variants_phase(dev, d_plain):
    """Slice 2, the engine variants, on the headline problem (n)-(r);
    returns {kernel: {path: launches}} for K1's z/u mode and K2."""
    import contextlib as _contextlib
    import io

    import torch

    from admm_tpu_torch import ADMMConfig, Hooks, admm, lasso
    from admm_tpu_torch.benchmarks.headline import make_problem
    from admm_tpu_torch.config import matmul_precision
    from admm_tpu_torch.models.lasso import make_prox_ops
    from admm_tpu_torch.ops.gemv_pair import gemv_pair as k2
    from admm_tpu_torch.ops.kernels import _fused_torch
    from admm_tpu_torch.ops.kernels import fused_soft_threshold_dual as k1
    from admm_tpu_torch.ops.kernels import fused_zu_tail as k1b

    D, s, lam = make_problem()
    D64, s64 = D.astype(np.float64), s.astype(np.float64)
    n = D.shape[1]
    bf16 = torch.bfloat16
    launches = {"k1": {}, "k2": {}}
    syncs = {}
    print(f"slice 2: engine variants on lasso {D.shape[0]}x{n} f32, lam={lam:.6g}")

    def counted(tag, solve):
        """Run ``solve`` with every launch count at 0 just before it and
        read just after, its synchronising calls counted."""
        k1.launches = k1b.launches = k2.launches = 0
        with counting_syncs() as sy:
            r = solve()
            torch.cuda.synchronize()
        syncs[tag] = sy
        return r, k1.launches, k1b.launches, k2.launches

    # (n) residual balancing with the fused hook: K1's z/u mode each step,
    # never K1b, whose tail knows no rho update.
    cfg_n = ADMMConfig(maxiters=VARIANT_MAXITERS, unroll=16, rbadaptive=True)
    nk, zu, tail, _ = counted("n", lambda: lasso(D, s, lam, cfg_n, use_fused_kernel=True,
                                                 device=dev))
    launches["k1"]["n"] = zu
    plain = lasso(D, s, lam, cfg_n, use_fused_kernel=False, device=dev)
    # The same solve with the z/u mode's plain version in the hook's place.
    with matmul_precision("highest"):
        pf, pg, obj, data = make_prox_ops(torch.as_tensor(D, device=dev),
                                          torch.as_tensor(s, device=dev), lam, cfg_n)
    twin = admm(pf, pg, cfg_n, m=n, nA=n, nB=n, data=data, dtype=torch.float32,
                hooks=Hooks(fused_zu=lambda x, u, rho, d: _fused_torch(x, u, d["lam"] / rho)))
    xinf = float(torch.max(torch.abs(nk.xopt)))
    dx_plain = float(torch.max(torch.abs(nk.xopt - plain.xopt)))
    dx_twin = float(torch.max(torch.abs(nk.xopt - twin.xopt)))
    print(f"  (n) rbadaptive, fused: steps={nk.steps} rho_final={nk.rho_final:.9g} "
          f"z/u launches={zu} K1b launches={tail} runtime={nk.runtime:.4f}s; without the "
          f"kernel (prox_g): steps={plain.steps} rho_final={plain.rho_final:.9g}, "
          f"max|dxopt| = {dx_plain:.3e}; with the z/u mode's plain version: "
          f"steps={twin.steps} rho_final={twin.rho_final:.9g}, max|dxopt| = {dx_twin:.3e}; "
          f"||xopt||_inf = {xinf:.6g}")
    k = min(nk.steps, plain.steps) - 1
    print(f"  (n) stop margin at step {k + 1}: pnorm/perr {nk.pnorm[k]:.9g}/{nk.perr[k]:.9g} "
          f"(plain {plain.pnorm[k]:.9g}/{plain.perr[k]:.9g}), dnorm/derr "
          f"{nk.dnorm[k]:.9g}/{nk.derr[k]:.9g} (plain {plain.dnorm[k]:.9g}/"
          f"{plain.derr[k]:.9g})")
    check(nk.steps < VARIANT_MAXITERS and not nk.diverged and bool(torch.isfinite(nk.xopt).all()),
          f"(n) converges before {VARIANT_MAXITERS}, finite")
    check(zu >= nk.steps and tail == 0, f"(n) z/u mode launches {zu} >= steps {nk.steps}, "
          f"K1b launches {tail} == 0")
    check(abs(nk.steps - plain.steps) <= 1, "(n) steps equal within one to the solve without "
          "the kernel")
    check(nk.rho_final == plain.rho_final == twin.rho_final, "(n) rho_final equal")
    check(dx_plain <= 1e-5 * xinf and dx_twin <= 1e-5 * xinf,
          "(n) max|dxopt| <= 1e-5 ||xopt||_inf against both")
    check(twin.steps == nk.steps, "(n) steps equal to the z/u plain-version solve")

    # (o) Anderson acceleration with the fused hook.
    cfg_o = ADMMConfig(maxiters=VARIANT_MAXITERS, unroll=16, anderson=5)
    ok_, zu, tail, _ = counted("o", lambda: lasso(D, s, lam, cfg_o, use_fused_kernel=True,
                                                  device=dev))
    launches["k1"]["o"] = zu
    f_o = lasso_objective(D64, s64, lam, ok_.zopt)
    f_d = lasso_objective(D64, s64, lam, d_plain.zopt)
    print(f"  (o) anderson=5, fused: steps={ok_.steps} (d) plain steps={d_plain.steps}; "
          f"z/u launches={zu} K1b launches={tail}; objective {f_o:.9g} vs (d) {f_d:.9g}, "
          f"rel {abs(f_o - f_d) / abs(f_d):.3e}")
    check(ok_.steps < VARIANT_MAXITERS and not ok_.diverged, f"(o) converges before "
          f"{VARIANT_MAXITERS}")
    check(zu >= ok_.steps and tail == 0, f"(o) z/u mode launches {zu} >= steps {ok_.steps}, "
          "no K1b")
    check(abs(f_o - f_d) <= 1e-4 * abs(f_d), "(o) objective within 1e-4 of (d)'s plain solve")

    # (p) fast (alg 2, weak) and fasttype='strong' with bf16 streams: K2
    # computes the x-update each step.
    for tag, kw, bar_steps in (("p weak", dict(fast=True), VARIANT_MAXITERS),
                               ("p strong", dict(fast=True, fasttype="strong"), STRONG_STEPS)):
        cfg_p = ADMMConfig(maxiters=VARIANT_MAXITERS, unroll=16, **kw)
        r, _, _, cnt = counted(tag, lambda: lasso(D, s, lam, cfg_p, stream_dtype=bf16,
                                                  device=dev))
        launches["k2"][tag] = cnt
        f32 = lasso(D, s, lam, cfg_p, device=dev)
        rel = float(torch.linalg.norm(r.xopt - f32.xopt) / torch.linalg.norm(f32.xopt))
        traces = sorted(k for k in ("dvals", "avals", "restarted") if k in r.hist)
        print(f"  ({tag}) bf16: steps={r.steps} K2 launches={cnt} runtime={r.runtime:.4f}s "
              f"iter/s {r.steps / r.runtime:.1f}; f32: steps={f32.steps}; "
              f"||dxopt||/||xopt|| = {rel:.3e}; traces {traces}"
              + (f", restarts {int(r.restarted.sum())}" if r.restarted is not None else ""))
        check(cnt >= r.steps and bool(torch.isfinite(r.xopt).all()) and not r.diverged,
              f"({tag}) K2 launches {cnt} >= steps {r.steps}, finite")
        want = ["avals", "dvals", "restarted"] if "strong" not in tag else ["avals"]
        check(traces == want and all(len(r.trace(t)) == r.steps for t in want),
              f"({tag}) {', '.join(want)} recorded, one per step")
        if bar_steps != VARIANT_MAXITERS:
            # alg 1 has no restart and LASSO is not strongly convex, so its
            # momentum grows and the run drifts in any precision: the bar
            # holds over the first steps, before the drift dominates.
            cfg_b = ADMMConfig(maxiters=bar_steps, domaxiters=True, **kw)
            r = lasso(D, s, lam, cfg_b, stream_dtype=bf16, device=dev)
            f32 = lasso(D, s, lam, cfg_b, device=dev)
            rel = float(torch.linalg.norm(r.xopt - f32.xopt) / torch.linalg.norm(f32.xopt))
            print(f"  ({tag}) after {bar_steps} steps: ||dxopt||/||xopt|| = {rel:.3e}")
        check(rel <= 2e-2, f"({tag}) ||xopt_bf16 - xopt_f32|| <= 2e-2 ||xopt_f32|| "
              f"after {r.steps} steps")

    # (q) each once, finite, trace shapes checked.
    q_cases = {
        "adaptive": (dict(adaptive=True, convtest=True, stopcond="both"), {}),
        "hnorm": (dict(stopcond="hnorm"), dict(use_fused_kernel=True)),
        "stallwindow": (dict(stallwindow=20), dict(use_fused_kernel=True)),
        "record_iterates": (dict(maxiters=RECORD_STEPS, domaxiters=True, record_iterates=True),
                            dict(use_fused_kernel=True)),
        "quiet": (dict(quiet=False), dict(use_fused_kernel=True)),
    }
    for tag, (kw, extra) in q_cases.items():
        cfg_q = ADMMConfig(**dict(dict(maxiters=VARIANT_MAXITERS, unroll=16), **kw))
        out = io.StringIO()
        with _contextlib.redirect_stdout(out):
            r = lasso(D, s, lam, cfg_q, device=dev, **extra)
        rows = [ln for ln in out.getvalue().splitlines() if "\tpnorm " in ln]
        shapes = {k: tuple(v.shape) for k, v in r.hist.items()}
        print(f"  (q) {tag}: steps={r.steps} rho_final={r.rho_final:.9g} diverged={r.diverged} "
              f"stalled={r.stalled} runtime={r.runtime:.4f}s; traces {shapes}")
        check(bool(torch.isfinite(r.xopt).all()) and r.xopt.device.type == "cuda",
              f"(q) {tag} xopt finite on the card")
        check(all(v.shape[0] == cfg_q.maxiters for v in r.hist.values()),
              f"(q) {tag} traces of maxiters rows")
        if tag == "adaptive":
            check("Hnormsq" in r.hist and r.rho_final != cfg_q.rho, "(q) adaptive: H-norms "
                  f"recorded, rho moved to {r.rho_final:.6g}")
        elif tag == "hnorm":
            H = r.Hnormsq
            check(r.steps < cfg_q.maxiters and len(H) == r.steps and H[-1] <= cfg_q.hnormtol,
                  "(q) hnorm stops on H-norm^2 <= hnormtol")
        elif tag == "record_iterates":
            check(r.steps == RECORD_STEPS and r.wvals.shape == (RECORD_STEPS, 3 * n)
                  and r.trace("xvals").shape == (RECORD_STEPS, n)
                  and np.isfinite(r.wvals).all(), "(q) record_iterates: x/z/u/w traces of "
                  f"{RECORD_STEPS} steps, finite")
            w = r.wvals[-1]
            check(np.array_equal(w[:n], r.xopt.cpu().numpy()), "(q) the last w starts with xopt")
        elif tag == "quiet":
            check(len(rows) == r.steps and rows[-1].startswith(f"{r.steps}\t"),
                  f"(q) quiet=False printed {len(rows)} rows for {r.steps} steps")

    # (r) host reads per solve.
    for tag, sy in syncs.items():
        outside = sy["solve"] - sy["steps"] - sy["chunks"]
        print(f"  (r) ({tag}) synchronising calls: {sy['solve']} in the solve, "
              f"{sy['steps']} inside its sub-steps, {sy['chunks']} chunk reads, "
              f"{outside} outside the loop (set-up and results)")
        check(sy["steps"] == 0, f"(r) ({tag}) no synchronising call inside a sub-step")
        check(sy["solve"] <= sy["chunks"] + SYNCS_OUTSIDE,
              f"(r) ({tag}) at most one per chunk plus {SYNCS_OUTSIDE} outside the loop")
    return launches


def k2_operands(m, n, dev, dtype, K):
    """The GEMV-pair probe's draws at (m, n).  For a chain (K > 1) D^T is
    E^T / lambda, lambda the top eigenvalue of E^T E (a NumPy f64 power
    iteration): the chain then contracts onto one direction at a steady
    norm.  The probe's independent E and D^T make a chain that amplifies
    one flipped bf16 rounding of b or t some 700-fold over 64 steps, so a
    bar there would measure that chain's conditioning, not the kernel."""
    import torch

    from admm_tpu_torch.experiments.gemv_pair_probe import make_operands
    from admm_tpu_torch.ops.gemv_pair import aligned_rows

    b, E, Dt = make_operands(m, n, torch.device("cpu"), torch.float32)
    if K > 1:
        E64 = E.double().numpy()
        v = b.double().numpy()
        for _ in range(100):
            w = E64.T @ (E64 @ v)
            lam = np.linalg.norm(w) / np.linalg.norm(v)
            v = w / np.linalg.norm(w)
        Dt = torch.from_numpy((E64.T / lam).astype(np.float32))
    return (b.to(dev, dtype), aligned_rows(E.to(dev, dtype)),
            aligned_rows(Dt.to(dev, dtype)))


def k2_phase(dev):
    """K2 (CUDA C++) against its plain version, the pair and the transposed
    pair of its backward; returns (max_abs_err, ms, plain_ms, library_ms,
    (bound_ms, bound_by)) of one K = 1 f32 call at (1500, 5000), the
    library call being ``torch.linalg.multi_dot``, and the times of the
    backward's bf16 launch."""
    import torch

    from admm_tpu_torch.benchmarks.timing import graph_ms
    from admm_tpu_torch.experiments.gemv_pair_probe import make_operands
    from admm_tpu_torch.ops.gemv_pair import (StreamPair, _gemv_pair_torch, aligned_rows,
                                              gemv_pair)

    print("kernel: gemv_pair (CUDA C++) vs _gemv_pair_torch")
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for m, n in K2_SHAPES:
            for K in (1, K2_DEEP):
                b, E, Dt = k2_operands(m, n, dev, dtype, K)
                x = gemv_pair(b, E, Dt, K)
                torch.cuda.synchronize()
                ref = _gemv_pair_torch(b, E, Dt, K)
                dmax = float(torch.max(torch.abs(x - ref)))
                xinf = float(torch.max(torch.abs(ref)))
                rel = float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref))
                print(f"  {str(dtype):14s} m={m:5d} n={n:5d} K={K:2d}  max_abs_diff "
                      f"{dmax:.3e} (||x||_inf {xinf:.4g}), rel norm {rel:.3e}")
                check(bool(torch.isfinite(x).all()), f"K2 finite ({dtype}, {m}x{n}, K={K})")
                if K == 1:
                    bar = 1e-5 if dtype == torch.float32 else 1e-3
                    check(dmax <= bar * xinf, f"K2 max|dx| <= {bar} ||x||_inf "
                          f"({dtype}, {m}x{n}, K=1)")
                else:
                    bar = 1e-4 if dtype == torch.float32 else 2e-2
                    check(rel <= bar, f"K2 ||dx||/||x|| <= {bar} ({dtype}, {m}x{n}, K={K})")
                worst = max(worst, dmax)

    # The same bits from every launch, and an f32 b with bf16 streams
    # rounded as b.to(bf16) rounds it.
    for dtype in (torch.float32, torch.bfloat16):
        for K in (1, K2_DEEP):
            b, E, Dt = k2_operands(1500, 5000, dev, dtype, K)
            first = gemv_pair(b, E, Dt, K)
            same = all(torch.equal(gemv_pair(b, E, Dt, K), first) for _ in range(2))
            check(same, f"K2 gives the same bits on three launches ({dtype}, K={K})")
    b, E, Dt = k2_operands(1500, 5000, dev, torch.bfloat16, 1)
    b32 = torch.from_numpy(np.random.default_rng(3).standard_normal(E.shape[1]))
    b32 = b32.to(dev, torch.float32)
    check(torch.equal(gemv_pair(b32, E, Dt), gemv_pair(b32.to(torch.bfloat16), E, Dt)),
          "K2 with bf16 streams: an f32 b gives the bits of b.to(bf16)")

    # The backward's transposed pair (the kernel's bmode 2: g read in f32,
    # x rounded to the stream type as written) against its plain version.
    # Bars: the forward's, plus one rounding of each element to bf16 (the
    # f32 sums' order can move x_i across a bf16 rounding boundary).
    for dtype in (torch.float32, torch.bfloat16):
        for K in (1, K2_DEEP):
            b, E, Dt = k2_operands(1500, 5000, dev, dtype, K)
            T = StreamPair(E, Dt).transposed()
            g = torch.from_numpy(np.random.default_rng(4).standard_normal(T.E.shape[1]))
            g = g.to(dev, torch.float32)
            x = T.launch(g, K)
            torch.cuda.synchronize()
            ref = _gemv_pair_torch(g, T.E, T.Dt, K, exact=True)
            ulp = 0.0 if dtype == torch.float32 else 2.0**-8
            bar = (1e-5 if dtype == torch.float32 else 1e-3) if K == 1 else (
                1e-4 if dtype == torch.float32 else 2e-2)
            xinf = float(torch.max(torch.abs(ref)))
            excess = torch.abs(x - ref) - ulp * torch.abs(ref)
            dmax = float(torch.max(torch.abs(x - ref)))
            rel = float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref))
            print(f"  transposed pair {str(dtype):14s} K={K:2d}  max_abs_diff {dmax:.3e} "
                  f"(||x||_inf {xinf:.4g}), rel norm {rel:.3e}; x in the stream type: "
                  f"{bool(torch.equal(x, x.to(dtype).float()))}")
            check(bool(torch.equal(x, x.to(dtype).float())),
                  f"K2 transposed pair rounds x to the stream type ({dtype}, K={K})")
            if K == 1:
                check(float(torch.max(excess)) <= bar * xinf,
                      f"K2 transposed pair |dx_i| <= {bar} ||x||_inf + {ulp} |x_i| ({dtype}, K=1)")
            else:
                check(rel <= bar, f"K2 transposed pair ||dx||/||x|| <= {bar} ({dtype}, K={K})")

    # Times at (1500, 5000) in the solver's layout (rows on 16-byte
    # boundaries), kernel and plain version and, in f32, multi_dot in turns.
    times = {}
    for dtype, K, reps in ((torch.float32, 1, 200), (torch.bfloat16, 1, 200),
                           (torch.float32, K2_DEEP, 20), (torch.bfloat16, K2_DEEP, 20)):
        b, E, Dt = make_operands(1500, 5000, dev, dtype)
        E, Dt = aligned_rows(E), aligned_rows(Dt)
        fns = {"kernel": lambda: gemv_pair(b, E, Dt, K),
               "plain": lambda: _gemv_pair_torch(b, E, Dt, K)}
        if dtype == torch.float32 and K == 1:
            fns["multi_dot"] = lambda: torch.linalg.multi_dot([Dt, E, b])
        got = {name: [] for name in fns}
        for name in list(fns) + list(fns)[::-1]:
            got[name].append(graph_ms(fns[name], reps, per_graph=10 if K == 1 else 2))
        host = time_ms(fns["kernel"], reps)
        times[(dtype, K)] = {name: min(v) for name, v in got.items()}
        m, n = E.shape
        size = E.element_size()
        nbytes = K * 2 * m * n * size + n * size + n * 4  # E, Dt each step; b in, x out
        times[(dtype, K)]["bound"] = bound(nbytes, K * 4 * m * n)
        print(f"  (1500, 5000) {str(dtype):14s} K={K:2d} per call: "
              + ", ".join(f"{name} {' / '.join('%.5f' % t for t in v)} ms"
                          for name, v in got.items())
              + f" (device: CUDA events around graph replays, {reps} calls each; "
              f"host-issued kernel {host:.5f} ms); kernel {min(got['kernel']) * 1e3 / K:.2f} "
              f"us per step, {nbytes / (min(got['kernel']) * 1e-3) / 1e12:.2f} TB/s; "
              f"bound {times[(dtype, K)]['bound'][0] * 1e3 / K:.2f} us per step")
    # The backward's launch: the transposed pair of the bf16 solver pair.
    b, E, Dt = make_operands(1500, 5000, dev, torch.bfloat16)
    T = StreamPair(aligned_rows(E), aligned_rows(Dt)).transposed()
    g = torch.randn(T.E.shape[1], device=dev)
    bwd = [graph_ms(fn, 200) for fn in (lambda: T.launch(g, 1),
                                        lambda: _gemv_pair_torch(g, T.E, T.Dt, 1, True))]
    m, n = T.E.shape
    times["backward"] = {"kernel": bwd[0], "plain": bwd[1],
                         "bound": bound(2 * m * n * 2 + n * 4 + m * 4, 4 * m * n)}
    print(f"  backward (transposed pair, bf16, K=1, ({m}, {n})): kernel {bwd[0]:.5f} ms, plain "
          f"{bwd[1]:.5f} ms (device, graph replays); bound "
          f"{times['backward']['bound'][0]:.5f} ms ({times['backward']['bound'][1]})")
    md = times[(torch.float32, 1)]["multi_dot"]
    print(f"  per step against multi_dot f32 ({md * 1e3:.2f} us): K2 f32 K=1 "
          f"{times[(torch.float32, 1)]['kernel'] * 1e3:.2f} us, K=64 "
          f"{times[(torch.float32, K2_DEEP)]['kernel'] * 1e3 / K2_DEEP:.2f} us; "
          f"bf16 K=1 {times[(torch.bfloat16, 1)]['kernel'] * 1e3:.2f} us, K=64 "
          f"{times[(torch.bfloat16, K2_DEEP)]['kernel'] * 1e3 / K2_DEEP:.2f} us")
    f32 = times[(torch.float32, 1)]
    return worst, f32["kernel"], f32["plain"], md, f32["bound"], times["backward"]


def k3_phase(dev, a):
    """K3 (CUDA C++) through the prototype's entry point, against its plain
    version, NumPy f64 and run (a)'s history; returns (launches,
    max_abs_err, ms, plain_ms, (bound_ms, bound_by)) with the times per
    launch of K steps."""
    import torch

    from admm_tpu_torch.benchmarks.timing import graph_ms
    from admm_tpu_torch.experiments import resident_iter_proto as proto
    from admm_tpu_torch.ops.gemv_pair import _resident_lasso_torch, resident_lasso

    K = proto.K
    print(f"kernel: resident_lasso (CUDA C++), the headline problem, K={K}, "
          f"{proto.CALLS} chained launches")
    resident_lasso.launches = 0
    r = proto.run(dev)
    torch.cuda.synchronize()
    launches = resident_lasso.launches
    print(f"  launches {launches}; z err vs NumPy f64 {r['z_err']:.3e}, u err "
          f"{r['u_err']:.3e}, pn2 rel err at step {K} {r['pn2_err']:.3e}; "
          f"{r['us_per_iter']:.2f} us/iter, {r['iters_per_sec']:.0f} iter/s (host clock)")
    check(launches >= 1 + proto.CALLS, f"K3 launched {launches} >= {1 + proto.CALLS} times")
    check(r["z_err"] <= 1e-4 and r["u_err"] <= 1e-4,
          "K3 z, u vs NumPy f64: max|d| <= 1e-4 ||.||_inf")

    op = proto.setup(dev)
    args = (op["Dts"], op["E"], op["Dt"], op["rho"], op["kappa"], K)
    n = op["Dts"].numel()
    zp = torch.zeros(n, dtype=torch.float32, device=dev)
    up = torch.zeros_like(zp)
    _resident_lasso_torch(zp, up, *args)
    dz = float(torch.max(torch.abs(r["z"] - zp)))
    du = float(torch.max(torch.abs(r["u"] - up)))
    print(f"  vs _resident_lasso_torch on the card: max|dz| {dz:.3e}, max|du| {du:.3e}")
    check(dz <= 1e-4 * float(torch.max(torch.abs(zp)))
          and du <= 1e-4 * float(torch.max(torch.abs(up))),
          "K3 z, u vs plain: max|d| <= 1e-4 ||.||_inf")

    pn2 = r["hist"][:, 0].double().cpu().numpy()
    pnorm = np.asarray(a.pnorm[:K], np.float64)
    ref = pnorm**2
    big = ref >= 1e-7 * ref[0]
    rel = np.abs(pn2 - ref) / ref
    xnorm = float(torch.linalg.norm(a.xopt))
    gap = np.abs(np.sqrt(pn2) - pnorm) - 1e-3 * pnorm
    print(f"  history vs run (a): max rel pn2 {rel[big].max():.3e} over the {big.sum()} "
          f"steps with pnorm^2 >= 1e-7 pnorm^2[0]; max over all {K} steps of "
          f"|sqrt(pn2) - pnorm| - 1e-3 pnorm: {gap.max():.3e} (bar 1e-6 ||xopt|| = "
          f"{1e-6 * xnorm:.3e})")
    check(bool(np.all(rel[big] <= 1e-3)) and big.sum() >= 20,
          "K3 history pn2 within 1e-3 of run (a)'s pnorm^2 where pnorm^2 >= 1e-7 pnorm^2[0]")
    check(bool(np.all(gap <= 1e-6 * xnorm)),
          "K3 |sqrt(pn2) - pnorm| <= 1e-3 pnorm + 1e-6 ||xopt|| at every step")

    # A relaunch from the same state gives the same bits (fixed-order sums).
    z1, u1 = torch.zeros_like(zp), torch.zeros_like(up)
    h1 = resident_lasso(z1, u1, *args)
    z2, u2 = torch.zeros_like(zp), torch.zeros_like(up)
    h2 = resident_lasso(z2, u2, *args)
    check(torch.equal(h1, h2) and torch.equal(z1, z2) and torch.equal(u1, u2),
          "K3 gives the same bits on two launches")

    m = op["E"].shape[0]
    # E and D^T each step; z, u, D^T s in, z and u out, the history.
    bound_ms = bound(K * 2 * m * n * 4 + 5 * n * 4 + K * 8, K * (4 * m * n + 16 * n))
    zc, uc = torch.zeros_like(zp), torch.zeros_like(up)
    ks = [graph_ms(lambda: resident_lasso(zc, uc, *args), 20, per_graph=2)]
    ps = [graph_ms(lambda: _resident_lasso_torch(zc, uc, *args), 3, per_graph=1)]
    ps.append(graph_ms(lambda: _resident_lasso_torch(zc, uc, *args), 3, per_graph=1))
    ks.append(graph_ms(lambda: resident_lasso(zc, uc, *args), 20, per_graph=2))
    print(f"  per launch of {K} steps: kernel {ks[0]:.5f} / {ks[1]:.5f} ms, plain loop "
          f"{ps[0]:.5f} / {ps[1]:.5f} ms (device: CUDA events around graph replays); per step kernel "
          f"{min(ks) * 1e3 / K:.2f} us, plain {min(ps) * 1e3 / K:.2f} us; bound "
          f"{bound_ms[0] * 1e3 / K:.2f} us per step ({bound_ms[1]})")
    return launches, max(dz, du), min(ks), min(ps), bound_ms


def _family_objective(family, D, s, lam, z):
    """The objective at z in NumPy f64 (each model's own formula)."""
    z = z.double().cpu().numpy()
    fit = 0.5 * np.sum((D @ z - s) ** 2)
    if family == "elasticnet":
        return fit + lam * (0.5 * np.sum(np.abs(z)) + 0.25 * np.sum(z**2))
    if family == "grouplasso":
        return fit + lam * np.sum(np.sqrt(np.sum(z.reshape(50, -1) ** 2, axis=1)))
    return fit


def bf16_phase(dev, a):
    """The bf16-stream slice (k)-(m); returns K2's launch count in run (k)."""
    import torch

    from admm_tpu_torch import ADMMConfig, elasticnet, grouplasso, lasso, nnls
    from admm_tpu_torch.benchmarks.headline import make_problem
    from admm_tpu_torch.ops.gemv_pair import gemv_pair

    D, s, lam = make_problem()
    n = D.shape[1]
    bf16 = torch.bfloat16
    cfg = ADMMConfig(maxiters=HEADLINE_STEPS, domaxiters=True, unroll=64)
    print(f"slice: lasso {D.shape[0]}x{n} with bf16 streams, {cfg.maxiters} steps, "
          f"unroll {cfg.unroll}, fused z/u kernel")

    # (k) the main path of this slice, counted.
    gemv_pair.launches = 0
    k = lasso(D, s, lam, cfg, use_fused_kernel=True, stream_dtype=bf16, device=dev)
    torch.cuda.synchronize()
    launches = gemv_pair.launches
    rel = float(torch.linalg.norm(k.xopt - a.xopt) / torch.linalg.norm(a.xopt))
    print(f"  (k) bf16: steps={k.steps} K2 launches={launches} runtime={k.runtime:.4f}s; "
          f"||xopt_k - xopt_a|| / ||xopt_a|| = {rel:.3e}")
    check(k.steps == HEADLINE_STEPS, f"(k) steps == {HEADLINE_STEPS}")
    check(launches >= HEADLINE_STEPS, f"(k) K2 launches {launches} >= {HEADLINE_STEPS}")
    check(k.xopt.device.type == "cuda" and tuple(k.xopt.shape) == (n,),
          "(k) xopt on the card with shape (5000,)")
    check(bool(torch.isfinite(k.xopt).all()) and not k.diverged, "(k) xopt finite")
    check(rel <= 2e-2, "(k) ||xopt_bf16 - xopt_a|| <= 2e-2 ||xopt_a||")

    # (l) iter/s, best of 3 each, in turns.
    cfg_l = ADMMConfig(maxiters=BF16_TIMED_STEPS, domaxiters=True, unroll=64)
    times = {bf16: [], None: []}
    for sd in (bf16, None, None, bf16, bf16, None):
        r = lasso(D, s, lam, cfg_l, use_fused_kernel=True, stream_dtype=sd, device=dev)
        check(r.steps == BF16_TIMED_STEPS, f"(l) {BF16_TIMED_STEPS} steps")
        times[sd].append(r.runtime)
    print(f"  (l) {BF16_TIMED_STEPS}-step runtimes s: bf16 "
          f"{['%.4f' % t for t in times[bf16]]}, f32 {['%.4f' % t for t in times[None]]}")
    print(f"  (l) iter/s best of 3: bf16 {BF16_TIMED_STEPS / min(times[bf16]):.1f}, "
          f"f32 {BF16_TIMED_STEPS / min(times[None]):.1f}")

    # (m) the other three families on the same D.
    D64, s64 = D.astype(np.float64), s.astype(np.float64)
    cfg_m = ADMMConfig(maxiters=FAMILY_MAXITERS)
    solvers = {
        "elasticnet": lambda **kw: elasticnet(D, s, lam, 0.5, cfg_m, device=dev, **kw),
        "nnls": lambda **kw: nnls(D, s, cfg_m, device=dev, **kw),
        "grouplasso": lambda **kw: grouplasso(D, s, lam, 50, None, cfg_m, device=dev, **kw),
    }
    for family, solve in solvers.items():
        f32 = solve()
        gemv_pair.launches = 0
        r = solve(stream_dtype=bf16)
        torch.cuda.synchronize()
        count = gemv_pair.launches
        f_32 = _family_objective(family, D64, s64, lam, f32.zopt)
        f_16 = _family_objective(family, D64, s64, lam, r.zopt)
        scale = 0.5 * np.sum(s64**2) if family == "nnls" else abs(f_32)
        rel = abs(f_16 - f_32) / scale
        print(f"  (m) {family}: f32 steps={f32.steps} objective {f_32:.8g}; bf16 "
              f"steps={r.steps} K2 launches={count} objective {f_16:.8g}; "
              f"|df| / {'(1/2)||s||^2' if family == 'nnls' else '|f_f32|'} = {rel:.3e}")
        check(f32.steps < FAMILY_MAXITERS and not f32.diverged,
              f"(m) {family} f32 converges before {FAMILY_MAXITERS}")
        check(bool(torch.isfinite(r.zopt).all()) and not r.diverged, f"(m) {family} bf16 finite")
        check(count >= r.steps, f"(m) {family} K2 launches {count} >= steps {r.steps}")
        check(rel <= 2e-2, f"(m) {family} bf16 objective within 2e-2 of f32")
    return launches


def _tv_system(n):
    """I + rho D^T D of the 1-D TV model at rho = 1, as (dl, d, du)."""
    from admm_tpu_torch.models.totalvariation import tv_system

    return tv_system(n, 1.0)


def _random_system(n, seed=9):
    """A random diagonally dominant tridiagonal (tests/test_tridiag.py)."""
    rng = np.random.default_rng(seed)
    return (np.r_[0.0, rng.standard_normal(n - 1)], 4.0 + np.abs(rng.standard_normal(n)),
            np.r_[rng.standard_normal(n - 1), 0.0])


def k4_phase(dev):
    """K4 (CUDA C++) against its plain version; returns (max_abs_err, ms,
    plain_ms, (bound_ms, bound_by)), the times at TV (f)'s shape
    (1, 65536) with the hybrid tail."""
    import torch

    from admm_tpu_torch.benchmarks.timing import graph_ms
    from admm_tpu_torch.ops.tridiag import (
        CyclicReductionSolver, _cr_solve_torch, compact_stacks, cr_solve)

    print("kernel: cr_solve (CUDA C++) vs _cr_solve_torch")

    def problem(lanes, n, cutoff, system, dtype):
        sol = CyclicReductionSolver.from_tridiag(*system(n), dense_cutoff=cutoff,
                                                 device=dev, dtype=dtype)
        N = sol.alphas.shape[1]
        rng = np.random.default_rng(lanes * n)
        bb = torch.zeros((lanes, N), dtype=dtype, device=dev)
        bb[:, :n] = torch.from_numpy(rng.standard_normal((lanes, n))).to(dev, dtype)
        return sol, bb

    worst = 0.0
    for dtype in (torch.float32, torch.float64):
        for system in (_tv_system, _random_system):
            for lanes, n, cutoff in K4_CASES:
                sol, bb = problem(lanes, n, cutoff, system, dtype)
                x_k = cr_solve(bb, sol)
                torch.cuda.synchronize()
                x_p = _cr_solve_torch(bb, sol)
                diff = float(torch.max(torch.abs(x_k - x_p)))
                print(f"  {str(dtype):14s} {system.__name__:14s} B={lanes:3d} n={n:6d} "
                      f"cutoff={cutoff}  max_abs_diff {diff:.3e}")
                check(torch.equal(x_k, x_p) and bool(torch.isfinite(x_k).all()),
                      f"K4 == plain bit for bit ({dtype}, {system.__name__}, "
                      f"B={lanes}, n={n}, cutoff={cutoff})")
                worst = max(worst, diff)

    times = {}
    for lanes, n, cutoff in K4_TIMED:
        sol, bb = problem(lanes, n, cutoff, _tv_system, torch.float32)
        ks, ps = [], []
        for kernel in (True, False, False, True):
            fn = (lambda: cr_solve(bb, sol)) if kernel else (lambda: _cr_solve_torch(bb, sol))
            (ks if kernel else ps).append(graph_ms(fn, 200))
        host = time_ms(lambda: cr_solve(bb, sol), 200)
        # bb in, x out, the active coefficients and the tail's inverse.
        stacks = compact_stacks(sol)
        N = bb.shape[1]
        f_rows, b_rows = stacks[0].numel(), stacks[2].numel()
        M = 0 if sol.Tinv is None else sol.Tinv.shape[0]
        nbytes = (2 * bb.numel() + sum(s.numel() for s in stacks) + M * M) * 4
        bound_ms = bound(nbytes, lanes * (4 * f_rows + 5 * b_rows + 2 * M * M))
        times[(lanes, n)] = (min(ks), min(ps), bound_ms)
        print(f"  B={lanes} n={n} (N={N}) cutoff={cutoff} f32 per solve, device (CUDA "
              f"events around graph replays, 200 calls each): kernel {ks[0]:.5f} / "
              f"{ks[1]:.5f} ms, plain {ps[0]:.5f} / {ps[1]:.5f} ms; host-issued kernel "
              f"{host:.5f} ms; bound {bound_ms[0]:.6f} ms ({bound_ms[1]})")
    return worst, *times[(1, 65536)]


def staircase_pair(n, seed=0):
    """admm_tpu/benchmarks/matrix.py's TV signal: (blocks of 64, the blocks
    plus noise of standard deviation 0.5), in float32."""
    rng = np.random.default_rng(seed)
    stair = np.repeat(rng.standard_normal(max(n // 64, 1)), 64)[:n]
    return stair.astype(np.float32), (stair + 0.5 * rng.standard_normal(n)).astype(np.float32)


def staircase(n, seed=0):
    """The noisy signal of ``staircase_pair``."""
    return staircase_pair(n, seed)[1]


def numpy_tv_steps(sig, lam, cfg):
    """Steps to the standard stop of the TV iteration in NumPy float64,
    with the update sequence and Boyd rule of admm_tpu_torch's engine
    (A = D, B = -1, c = 0) and the x-update by scipy's banded solve."""
    from scipy.linalg import solve_banded

    s = np.asarray(sig, np.float64)
    n, rho, t = s.size, cfg.rho, lam / cfg.rho
    ab = np.zeros((3, n))
    ab[0, 1:] = -rho
    ab[1] = 1.0 + rho * np.r_[1.0, 2.0 * np.ones(n - 1)]
    ab[2, :-1] = -rho

    def dmv(v):
        return v - np.r_[v[1:], 0.0]

    def drmv(v):
        return v - np.r_[0.0, v[:-1]]

    x, z, u = np.zeros(n), np.zeros(n), np.zeros(n)
    sqn_abstol = np.sqrt(n) * cfg.abstol
    for k in range(1, cfg.maxiters + 1):
        zprev = z
        x = solve_banded((1, 1), ab, s + rho * drmv(z - u))
        dx = dmv(x)
        v = u + dx
        z = np.sign(v) * np.maximum(np.abs(v) - t, 0.0)
        u = u + dx - z
        pnorm = np.linalg.norm(dx - z)
        dnorm = np.linalg.norm(rho * drmv(z - zprev))
        perr = sqn_abstol + cfg.reltol * max(np.linalg.norm(dx), np.linalg.norm(z))
        derr = sqn_abstol + cfg.reltol * np.linalg.norm(rho * drmv(u))
        if pnorm < perr and dnorm < derr:
            return k
    return cfg.maxiters


def tv_phase(dev):
    """The TV main path; returns K4's and K1b-D's launch counts in run (f)."""
    import torch

    from admm_tpu_torch import ADMMConfig, totalvariation, totalvariation2d
    from admm_tpu_torch.models.totalvariation import make_prox_ops
    from admm_tpu_torch.ops.kernels import fused_diff_tail
    from admm_tpu_torch.ops.tridiag import cr_solve

    cfg = ADMMConfig(maxiters=TV_MAXITERS, unroll="auto")
    launches = None
    signals = {}
    for n, tag, bar in ((65536, "(f)/(g)", 1e-6), (8192, "(h)", 0.0)):
        sig = staircase(n)
        *_, data, _ = make_prox_ops(torch.from_numpy(sig), TV_LAM, cfg)
        hybrid = data["cr"].Tinv is not None
        print(f"slice: totalvariation n={n} f32, lam={TV_LAM}, auto -> cr "
              f"({'hybrid, cut stride %d' % data['cr'].cut_stride if hybrid else 'masked'}), "
              f"maxiters {cfg.maxiters}")
        check(hybrid == (n > 16384), f"{tag} auto resolves to the "
              f"{'hybrid' if n > 16384 else 'pure masked'} cyclic reduction")

        cr_solve.launches = fused_diff_tail.launches = 0
        k = totalvariation(sig, TV_LAM, cfg, device=dev)
        torch.cuda.synchronize()
        count, tails = cr_solve.launches, fused_diff_tail.launches
        if launches is None:
            launches = count, tails  # run (f): the main path
        print(f"  {tag} kernel: steps={k.steps} launches K4 {count}, K1b-D {tails}, "
              f"runtime={k.runtime:.4f}s iter/s {k.steps / k.runtime:.1f}")
        check(count >= k.steps, f"{tag} K4 launches {count} >= steps {k.steps}")
        check(tails >= k.steps, f"{tag} K1b-D launches {tails} >= steps {k.steps}")
        check(k.xopt.device.type == "cuda" and tuple(k.xopt.shape) == (n,),
              f"{tag} xopt on the card with shape ({n},)")
        check(bool(torch.isfinite(k.xopt).all()) and not k.diverged, f"{tag} xopt finite")
        check(k.steps < cfg.maxiters, f"{tag} converges before {cfg.maxiters}")
        steps_np = numpy_tv_steps(sig, TV_LAM, cfg)
        print(f"  {tag} steps: port f32 {k.steps}, NumPy f64 {steps_np}")
        check(abs(k.steps - steps_np) <= 1, f"{tag} steps equal NumPy f64 within one")

        p = totalvariation(sig, TV_LAM, cfg, device=dev, _plain_cr=True)
        diff = float(torch.max(torch.abs(k.xopt - p.xopt)))
        xinf = float(torch.max(torch.abs(k.xopt)))
        print(f"  {tag} plain: steps={p.steps} runtime={p.runtime:.4f}s iter/s "
              f"{p.steps / p.runtime:.1f}; max|xopt_kernel - xopt_plain| = {diff:.3e}, "
              f"||xopt||_inf = {xinf:.6g}")
        check(p.steps == k.steps, f"{tag} equal steps kernel and plain")
        check(diff <= bar * xinf, f"{tag} max|xopt_kernel - xopt_plain| <= {bar} ||xopt||_inf")
        signals[n] = sig

    # (i) iter/s of (f) and (g), best of 3 each, in turns.  (f) stops
    # after a few dozen steps, too few to time, so the rate is taken over
    # TV_TIMED_STEPS steps of the same path under domaxiters.
    sig = signals[65536]
    cfg_i = ADMMConfig(maxiters=TV_TIMED_STEPS, domaxiters=True, unroll="auto")
    kernel_t, plain_t = [], []
    for plain in (False, True, True, False, False, True):
        r = totalvariation(sig, TV_LAM, cfg_i, device=dev, _plain_cr=plain)
        check(r.steps == TV_TIMED_STEPS and bool(torch.isfinite(r.xopt).all()),
              f"(i) {TV_TIMED_STEPS} steps, finite ({'plain' if plain else 'kernel'})")
        (plain_t if plain else kernel_t).append(r.runtime)
    print(f"  (i) {TV_TIMED_STEPS}-step runtimes s: kernel {['%.4f' % t for t in kernel_t]}, "
          f"plain {['%.4f' % t for t in plain_t]}")
    print(f"  (i) iter/s best of 3: kernel {TV_TIMED_STEPS / min(kernel_t):.1f}, "
          f"plain {TV_TIMED_STEPS / min(plain_t):.1f}")

    # (j) 2-D TV of a blocky image.
    m = 512
    rng = np.random.default_rng(2)
    truth = np.ones((m, m))
    truth[m // 8: m // 2, m // 4: 3 * m // 4] = 5.0
    truth[5 * m // 8: 7 * m // 8, m // 8: m // 2] = 3.0
    S = torch.from_numpy((truth + rng.standard_normal((m, m))).astype(np.float32)).to(dev)
    cfg2 = ADMMConfig(maxiters=3000, unroll="auto")
    r = totalvariation2d(S, 1.0, cfg2)

    def objective(X):
        tv = torch.sum(torch.abs(torch.diff(X, dim=0))) + torch.sum(torch.abs(torch.diff(X, dim=1)))
        return float(0.5 * torch.sum((X - S) ** 2) + tv)

    print(f"  (j) totalvariation2d {m}x{m} f32: steps={r.steps} runtime={r.runtime:.4f}s "
          f"iter/s {r.steps / r.runtime:.1f}; objective {objective(r.xopt):.6g} "
          f"(noisy image {objective(S):.6g})")
    check(r.steps < cfg2.maxiters and not r.diverged, f"(j) converges before {cfg2.maxiters}")
    check(tuple(r.xopt.shape) == (m, m) and bool(torch.isfinite(r.xopt).all()),
          "(j) xopt finite with shape (512, 512)")
    check(objective(r.xopt) < objective(S), "(j) objective below the noisy image's")
    return launches


def svm_instance(seed, mpos, mneg, sep):
    """tests/test_linearsvm.py's instance (testers/linearsvmtest.m:130-200):
    two classes around the line x1 = x2 with margin ``sep``; (D, ell)."""
    rng = np.random.default_rng(seed)
    base_p = np.linspace(0, 2, mpos)
    base_n = np.linspace(0, 2, mneg)
    pos = np.stack([base_p + rng.random(mpos) - sep * rng.random(mpos),
                    base_p - rng.random(mpos) + sep * rng.random(mpos)], axis=1)
    neg = np.stack([base_n - rng.random(mneg) + sep * rng.random(mneg),
                    base_n + rng.random(mneg) - sep * rng.random(mneg)], axis=1)
    return np.concatenate([pos, neg], axis=0), np.concatenate([np.ones(mpos), -np.ones(mneg)])


def family_objective(family, D, s, x, tau=0.8, C=1.0):
    """Each family's objective at x in NumPy f64 (s is ell for the SVMs)."""
    x = x.double().cpu().numpy()
    r = D @ x - s
    if family == "lad":
        return np.sum(np.abs(r))
    if family == "huberfit":
        a = np.abs(r)
        return np.sum(np.where(a <= 1.0, 0.5 * r * r, a - 0.5))
    if family == "quantile":
        return np.sum(np.maximum(tau * r, (tau - 1.0) * r))
    v = s * (D @ x)
    loss = np.maximum(1.0 - v, 0.0) if family == "hinge" else np.maximum(np.sign(1.0 - v), 0.0)
    return 0.5 * np.sum(x * x) + C * np.sum(loss)


def main_path(tag, solve, eigh=False, reads="eigh", once=None, tally=None):
    """Run ``solve`` with every kernel's count (K1-K4) at 0 just before it
    and read just after (added into ``tally`` where given), its
    synchronising calls counted, and check that
    none launched (``once``, a kernel's name: that it launched exactly once
    per sub-step and nothing else), that its xopt is finite on the card and that no
    synchronising call ran inside a sub-step (``eigh``: the calls of
    ``torch.linalg.eigh`` or, as ``reads`` names them, of
    ``torch.linalg.svd``, which read cuSOLVER's info back every call, are
    counted and printed instead), and at most one per chunk plus
    SYNCS_OUTSIDE outside the loop.  A batched solve (per-lane steps)
    prints the lanes' steps, the instance-iterations per second (the
    lanes' steps summed over the loop's wall time) and the sub-steps per
    second."""
    import torch

    kernels = kernel_counts()
    reset_counts()
    with counting_syncs() as sy:
        r = solve()
        torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
    if tally is not None:
        for name, v in launches.items():
            tally[name] += v
    outside = sy["solve"] - sy["steps"] - sy["chunks"]
    if torch.is_tensor(r.steps):
        steps = r.steps.cpu()
        rate = (f"{steps.numel()} lanes, steps {int(steps.min())}-{int(steps.max())}, "
                f"runtime {r.runtime:.4f}s: inst-iter/s {float(steps.sum()) / r.runtime:.1f}, "
                f"sub-steps/s {sy['substeps'] / r.runtime:.1f}")
        diverged = False
    else:
        rate = (f"steps={r.steps} runtime={r.runtime:.4f}s iter/s {r.steps / r.runtime:.1f} "
                f"(setup+solve {r.solverruntime:.4f}s)")
        diverged = r.diverged
    print(f"  ({tag}) {rate}; kernel launches {launches}; synchronising calls: {sy['steps']} "
          f"inside {sy['substeps']} sub-steps, {sy['chunks']} chunk reads, {outside} outside "
          f"the loop")
    check(r.xopt.device.type == "cuda" and bool(torch.isfinite(r.xopt).all())
          and not diverged, f"({tag}) xopt finite on the card")
    if once:
        check(launches[once] == sy["substeps"] and sum(launches.values()) == launches[once],
              f"({tag}) {once} launched once per sub-step ({launches[once]} for "
              f"{sy['substeps']}), no other kernel")
    else:
        check(not any(launches.values()), f"({tag}) no K1-K4 launch")
    if eigh:
        print(f"  ({tag}) {reads}: {sy['steps'] / sy['substeps']:.3f} synchronising calls per "
              f"sub-step (reported, not held)")
    else:
        check(sy["steps"] == 0, f"({tag}) no synchronising call inside a sub-step")
    check(sy["solve"] <= sy["chunks"] + sy["steps"] + SYNCS_OUTSIDE,
          f"({tag}) at most one per chunk plus {SYNCS_OUTSIDE} outside the loop")
    return r


def against_f64(tag, solve, bar, measure, eigh=False):
    """The converging f32 solve on the main path and the same in f64 on
    the card; checks measure(f32 run, f64 run) <= bar."""
    import torch

    r32 = main_path(tag, lambda: solve(torch.float32), eigh)
    r64 = solve(torch.float64)
    err = measure(r32, r64)
    print(f"  ({tag}) f32: steps={r32.steps} stalled={r32.stalled}; f64: steps={r64.steps} "
          f"stalled={r64.stalled}; error {err:.3e} (bar {bar})")
    check(err <= bar, f"({tag}) f32 within {bar} of f64 on the card")
    return r32, r64


def rel(a, b):
    """||a - b|| / ||b|| of two tensors, in f64."""
    import torch

    return float(torch.linalg.norm(a.double() - b.double()) / torch.linalg.norm(b.double()))


def families_phase(dev):
    """Slices 3 and 4, (s)-(y): none of their runs may launch K1-K4."""
    import torch

    from admm_tpu_torch import (ADMMConfig, basispursuit, fusedlasso, huberfit, lad, linearsvm,
                                quantile, totalvariation)

    timed = ADMMConfig(maxiters=FAMILY_TIMED_STEPS, domaxiters=True, unroll="auto")
    oracle = ADMMConfig(**ORACLE)

    print(f"slices 3 and 4: the generic step's families in f32, {FAMILY_TIMED_STEPS} timed "
          f"steps (fused lasso {FL_TIMED_STEPS}), oracle settings {ORACLE}")

    # (s) basis pursuit.
    rng = np.random.default_rng(3)
    m, n = BP_SHAPE
    D = rng.standard_normal((m, n)).astype(np.float32)
    x_true = rng.standard_normal(n) * (rng.random(n) < 0.1)
    s = (D @ x_true).astype(np.float32)
    Dd = torch.from_numpy(D).to(dev)
    sd = torch.from_numpy(s).to(dev)
    print(f"  (s) basispursuit {m}x{n}, {int(np.sum(x_true != 0))} nonzeros planted")
    main_path("s timed", lambda: basispursuit(Dd, sd, timed))
    # The stall window stops f32 and f64 at the same step short of the
    # optimum: their distance is f32's drift along the path (1.0e-4 on an
    # H100 80GB HBM3 at 700 W), so it is held at 1e-3; the tester's own
    # rules follow.
    r32, r64 = against_f64("s", lambda dt: basispursuit(Dd.to(dt), sd.to(dt), oracle),
                           1e-3, lambda a, b: rel(a.xopt, b.xopt))
    l1, l1_true = float(torch.sum(torch.abs(r32.xopt.double()))), float(np.sum(np.abs(x_true)))
    print(f"  (s) ||xopt - x_true|| / ||x_true|| = "
          f"{np.linalg.norm(r32.xopt.double().cpu().numpy() - x_true) / np.linalg.norm(x_true):.3e}"
          f"; ||xopt||_1 {l1:.6f} (f64 {float(torch.sum(torch.abs(r64.xopt))):.6f}), "
          f"||x_true||_1 {l1_true:.6f}")
    check(l1 <= l1_true * (1 + 1e-6) + 1e-8, "(s) ||xopt||_1 <= ||x_true||_1")
    # The reference tester's error (testers/problems.py basispursuittest),
    # to which matrix.py's f32 bar of 1e-4 applies.
    Dx = D.astype(np.float64) @ r32.xopt.double().cpu().numpy()
    relerror = float(np.mean(np.abs((Dx - s) / Dx)))
    print(f"  (s) mean|(D xopt - s) / D xopt| = {relerror:.3e} (bar 1e-4)")
    check(relerror <= 1e-4, "(s) the tester's constraint error within 1e-4")

    # (t) the fused lasso on the staircase.
    sig = staircase(FL_N)
    sigd = torch.from_numpy(sig).to(dev)
    print(f"  (t) fusedlasso n={FL_N}, lam1 0.1, lam2 0.5")
    main_path("t timed", lambda: fusedlasso(
        sigd, 0.1, 0.5, ADMMConfig(maxiters=FL_TIMED_STEPS, domaxiters=True, unroll="auto")))
    soft = main_path("t lam2=0", lambda: fusedlasso(sigd, 0.1, 0.0, oracle))
    truth = np.sign(sig) * np.maximum(np.abs(sig) - 0.1, 0.0)
    err = np.linalg.norm(soft.xopt.double().cpu().numpy() - truth) / np.linalg.norm(truth)
    print(f"  (t) lam2 = 0 against the soft threshold: {err:.3e} (bar 1e-3)")
    check(err <= 1e-3, "(t) lam2 = 0 within 1e-3 of the closed form")
    fused = main_path("t lam1=0", lambda: fusedlasso(sigd, 0.0, 0.5, oracle))
    tv = totalvariation(sigd, 0.5, oracle)
    err = rel(fused.xopt, tv.xopt)
    print(f"  (t) lam1 = 0 against totalvariation (steps {tv.steps}): {err:.3e} (bar 2e-2)")
    check(err <= 2e-2, "(t) lam1 = 0 within 2e-2 of totalvariation")

    # (u)-(w) the normal-equations families on one D.
    rng = np.random.default_rng(4)
    m, n = REG_SHAPE
    D = rng.standard_normal((m, n)).astype(np.float32)
    s = rng.standard_normal(m).astype(np.float32)
    D64, s64 = D.astype(np.float64), s.astype(np.float64)
    Dd, sd = torch.from_numpy(D).to(dev), torch.from_numpy(s).to(dev)
    solvers = {"lad": (lambda D_, s_, c: lad(D_, s_, c), 1e-2),
               "huberfit": (lambda D_, s_, c: huberfit(D_, s_, c), 1e-3),
               "quantile": (lambda D_, s_, c: quantile(D_, s_, 0.8, c), 1e-2)}
    for tag, (family, (solve, bar)) in zip("uvw", solvers.items()):
        print(f"  ({tag}) {family} {m}x{n}")
        main_path(f"{tag} timed", lambda: solve(Dd, sd, timed))
        against_f64(tag, lambda dt: solve(Dd.to(dt), sd.to(dt), oracle), bar,
                    lambda a, b: abs(family_objective(family, D64, s64, a.xopt)
                                     - family_objective(family, D64, s64, b.xopt))
                    / abs(family_objective(family, D64, s64, b.xopt)))

    # (x) the linear SVM at matrix.py's size.
    rng = np.random.default_rng(5)
    D = rng.standard_normal((m, n)).astype(np.float32)
    ell = np.sign(D @ rng.standard_normal(n) + 0.1 * rng.standard_normal(m)).astype(np.float32)
    D64, ell64 = D.astype(np.float64), ell.astype(np.float64)
    Dd, elld = torch.from_numpy(D).to(dev), torch.from_numpy(ell).to(dev)
    print(f"  (x) linearsvm {m}x{n}, hinge, C = 1")
    main_path("x timed", lambda: linearsvm(Dd, elld, 1.0, timed))
    against_f64("x", lambda dt: linearsvm(Dd.to(dt), elld.to(dt), 1.0, oracle), 1e-3,
                lambda a, b: abs(family_objective("hinge", D64, ell64, a.xopt)
                                 - family_objective("hinge", D64, ell64, b.xopt))
                / abs(family_objective("hinge", D64, ell64, b.xopt)))

    # (y) the linear-SVM oracle.
    D, ell = svm_instance(0, 128, 128, 0.5)
    D32, ell32 = (torch.from_numpy(a.astype(np.float32)).to(dev) for a in (D, ell))
    for loss in ("hinge", "01"):
        r = main_path(f"y {loss}", lambda: linearsvm(
            D32, ell32, 1.0, ADMMConfig(objevals=True, maxiters=1000), loss=loss))
        x = r.xopt.double().cpu().numpy()
        slope = abs(1.0 - (-x[1] / x[0]))
        f, f_ref = (family_objective(loss, D, ell, torch.from_numpy(v))
                    for v in (x, np.array([1.0, -1.0])))
        print(f"  (y) {loss}: slope error {slope:.4f} (bar 0.05), objective {f:.6f} "
              f"(at [1, -1]: {f_ref:.6f})")
        check(slope <= 0.05 and f < f_ref, f"(y) {loss}: slope within 0.05, objective below "
              "the one at [1, -1]")


def medium_precision_mode(dev):
    """What ``config.matmul_precision('default')`` (torch's 'medium') makes
    of a float32 matmul on this card, against 'highest' and f64: the
    relative error of a 512 x 512 product, and the mode it points to."""
    import torch

    from admm_tpu_torch.config import matmul_precision

    g = torch.Generator(device=dev).manual_seed(0)
    a, b = (torch.randn(512, 512, device=dev, generator=g) for _ in range(2))
    ref = a.double() @ b.double()
    errs = {}
    for mode in ("highest", "default"):
        with matmul_precision(mode):
            errs[mode] = rel(a @ b, ref)
            torch_mode = torch.get_float32_matmul_precision()
    name = ("full f32" if errs["default"] < 1e-5 else
            "TF32 (tensor cores, 10-bit mantissa)" if errs["default"] < 1.5e-3 else
            "bf16 passes")
    print(f"  matmul_precision('default') -> torch '{torch_mode}': a 512x512 f32 product is "
          f"{errs['default']:.3e} from f64 ('highest': {errs['highest']:.3e}), i.e. {name}")
    return name


def _covsel_objective(S64, lam, r):
    """tr(S X) - logdet X + lam ||Z||_1 in NumPy f64."""
    X, Z = (v.double().cpu().numpy() for v in (r.xopt, r.zopt))
    sign, logdet = np.linalg.slogdet(X)
    return np.trace(S64 @ X) - logdet + lam * np.sum(np.abs(Z)) if sign > 0 else np.inf


def _projection_controls(tag, W64):
    """Hold the port's f32 PSD projection of ``W64`` (``ops/prox.psd_project``)
    within 1e-5 of the f64 one, and print two controls beside it: torch's
    own f32 eigh (cuSOLVER's Jacobi syevj) and W rounded to bf16."""
    import torch

    from admm_tpu_torch.ops.prox import _sym, psd_project

    ref = psd_project(W64)
    port = rel(psd_project(W64.float()), ref)
    e, Q = torch.linalg.eigh(_sym(W64.float()))
    syevj = rel((Q * torch.clamp_min(e, 0.0).unsqueeze(-2)) @ Q.T, ref)
    bf16 = rel(psd_project(W64.to(torch.bfloat16).double()), ref)
    print(f"  ({tag}) one f32 PSD projection of X + U from the f64 run, against f64: "
          f"{port:.3e} (bar 1e-5); controls: torch's f32 eigh {syevj:.3e}, W in bf16 {bf16:.3e}")
    check(port <= 1e-5, f"({tag}) the f32 PSD projection within 1e-5 of f64")


def programs_phase(dev):
    """Slice 5 and the spectral half of slice 7, (z1)-(z10): none of their
    runs may launch K1-K4."""
    import torch

    from admm_tpu_torch import (ADMMConfig, covarianceselection, linearprogram,
                                quadraticprogram, sdp)
    from admm_tpu_torch.config import matmul_precision
    from admm_tpu_torch.models.sdp import random_sdp_instance

    oracle = ADMMConfig(**ORACLE)
    t0 = time.perf_counter()

    def timed(steps):
        return ADMMConfig(maxiters=steps, domaxiters=True, unroll="auto")

    def on_card(*arrays):
        return [torch.from_numpy(np.asarray(a, np.float32)).to(dev) for a in arrays]

    print(f"slices 5 and 7 (spectral half): LP, QP, covariance selection and SDP in f32, "
          f"timed under domaxiters, oracle settings {ORACLE}")

    # (z1), (z2) the LP at matrix.py's width, affine and factored KKT.
    rng = np.random.default_rng(6)
    n = LP_N
    x_true = np.abs(rng.standard_normal(n))
    D = np.abs(rng.standard_normal((n // 2, n)))
    s, b = D @ x_true, rng.random(n) + 0.5
    Dd, sd, bd = on_card(D, s, b)
    b64 = b.astype(np.float32).astype(np.float64)
    lp_obj = lambda r: float(b64 @ r.xopt.double().cpu().numpy())  # noqa: E731
    for tag, mode in (("z1", "affine"), ("z2", "chol")):
        print(f"  ({tag}) linearprogram n={n}, D |N(0,1)| {n // 2}x{n}, kkt_mode={mode!r}")
        main_path(f"{tag} timed", lambda: linearprogram(bd, Dd, sd, timed(PROGRAM_TIMED_STEPS),
                                                        kkt_mode=mode))
        r32, r64 = against_f64(
            tag, lambda dt: linearprogram(bd.to(dt), Dd.to(dt), sd.to(dt), oracle,
                                          kkt_mode=mode), 1e-4,
            lambda a, c: abs(lp_obj(a) - lp_obj(c)) / abs(lp_obj(c)))
        print(f"  ({tag}) ||x_f32 - x_f64|| / ||x_f64|| = {rel(r32.xopt, r64.xopt):.3e}; "
              f"||D x_f32 - s|| / ||s|| = {rel(Dd @ r32.xopt, sd):.3e}")
    # matrix.py's own LP is square (n x n): print what f32 makes of it.
    Dsq = np.abs(rng.standard_normal((n, n)))
    ssq = Dsq @ x_true
    (Dsq_d, ssq_d) = on_card(Dsq, ssq)
    info = int(torch.linalg.cholesky_ex(Dsq_d.double() @ Dsq_d.double().T)[1])
    with matmul_precision("highest"):
        info32 = int(torch.linalg.cholesky_ex(Dsq_d @ Dsq_d.T)[1])
    sq = linearprogram(bd, Dsq_d, ssq_d, ADMMConfig(maxiters=200))
    print(f"  (z2) matrix.py's square {n}x{n} D: cond(D) {np.linalg.cond(Dsq):.3e}; Cholesky "
          f"of D D^T info f64 {info}, f32 {info32} (0: factored); an f32 solve stops after "
          f"{sq.steps} steps, diverged={sq.diverged}, stalled={sq.stalled} (printed, not held)")

    # (z3) the standard-form QP, (z4) the bounded QP.
    G = rng.standard_normal((n, n))
    P = G @ G.T + n * np.eye(n)
    q = rng.standard_normal(n)
    Dq = rng.standard_normal((n // 2, n)) / np.sqrt(n)
    Pd, qd, Dqd, sqd = on_card(P, q, Dq, Dq @ x_true)
    print(f"  (z3) quadraticprogram standard n={n}, P = G G^T + n I, D N(0,1)/sqrt(n) "
          f"{n // 2}x{n}")
    main_path("z3 timed", lambda: quadraticprogram(Pd, qd, 0.0, Dqd, sqd,
                                                   timed(PROGRAM_TIMED_STEPS)))
    against_f64("z3", lambda dt: quadraticprogram(Pd.to(dt), qd.to(dt), 0.0, Dqd.to(dt),
                                                  sqd.to(dt), oracle), 5e-3,
                lambda a, c: rel(a.xopt, c.xopt))
    # matrix.py's QP constraint block is square too: print its f32 error.
    Dsq = rng.standard_normal((n, n)) / np.sqrt(n)
    Dsq_d, ssq_d = on_card(Dsq, Dsq @ x_true)
    sq = [quadraticprogram(Pd.to(dt), qd.to(dt), 0.0, Dsq_d.to(dt), ssq_d.to(dt), oracle)
          for dt in (torch.float32, torch.float64)]
    print(f"  (z3) matrix.py's square {n}x{n} D: cond(D) {np.linalg.cond(Dsq):.3e}; f32 "
          f"{sq[0].steps} steps (diverged={sq[0].diverged}, stalled={sq[0].stalled}), f64 "
          f"{sq[1].steps}; "
          f"||x_f32 - x_f64|| / ||x_f64|| = {rel(sq[0].xopt, sq[1].xopt):.3e} (printed, not held)")
    n2 = QPB_N
    G = rng.standard_normal((n2, n2))
    Pb, qb = G @ G.T + n2 * np.eye(n2), rng.standard_normal(n2)
    Pbd, qbd, lbd, ubd = on_card(Pb, qb, -np.ones(n2), np.ones(n2))
    print(f"  (z4) quadraticprogram bounded n={n2}, box [-1, 1]")
    main_path("z4 timed", lambda: quadraticprogram(Pbd, qbd, 0.0, lbd, ubd,
                                                   timed(PROGRAM_TIMED_STEPS)))
    against_f64("z4", lambda dt: quadraticprogram(Pbd.to(dt), qbd.to(dt), 0.0, lbd.to(dt),
                                                  ubd.to(dt), oracle), 5e-3,
                lambda a, c: rel(a.xopt, c.xopt))

    # (z5) covariance selection at n = 256, eigh and ns; (z6) at n = 512,
    # ns and ns_fast, with eigh as their reference on the card.  Each
    # converging run is held against the same solve in f64 on the card.
    mode = medium_precision_mode(dev)
    for tag, nc, methods in (("z5", COVSEL_N[0], ("eigh", "ns")),
                             ("z6", COVSEL_N[1], ("ns", "ns_fast", "eigh"))):
        Dc = rng.standard_normal((4 * nc, nc)).astype(np.float32)
        S64 = np.cov(Dc.astype(np.float64), rowvar=False)
        (Dcd,) = on_card(Dc)
        obj = lambda r: _covsel_objective(S64, 0.1, r)  # noqa: E731
        runs = {}
        for method in methods:
            eigh = method == "eigh"
            kw = {"ns_iters": 14} if method == "ns_fast" else {}
            print(f"  ({tag}) covarianceselection n={nc}, D ({4 * nc}, {nc}), lambda 0.1, "
                  f"prox_method={method!r} {kw}")
            if tag == "z5" or not eigh:
                main_path(f"{tag} {method} timed", lambda: covarianceselection(
                    Dcd, 0.1, timed(COVSEL_TIMED_STEPS), prox_method=method, **kw), eigh)
            runs[method], _ = against_f64(
                f"{tag} {method}", lambda dt: covarianceselection(
                    Dcd.to(dt), 0.1, oracle, prox_method=method, **kw), 1e-3,
                lambda a, c: abs(obj(a) - obj(c)) / abs(obj(c)), eigh)
        ref = runs["eigh"]
        for method, r in runs.items():
            if method == "eigh":
                continue
            err = abs(obj(r) - obj(ref)) / abs(obj(ref))
            print(f"  ({tag}) {method} against eigh on the card: objective {err:.3e} (bar 1e-3),"
                  f" ||dX|| / ||X|| {rel(r.xopt, ref.xopt):.3e}, steps {r.steps} / {ref.steps}"
                  + (f"; square-root steps in {mode}" if method == "ns_fast" else ""))
            check(err <= 1e-3, f"({tag}) {method} within 1e-3 of eigh")

    # (z7) the max-cut SDP (diag constraint), eigh and ns; (z8) the dense
    # constraint stack.
    ns_ = SDP_DIAG_N
    W = np.triu(rng.random((ns_, ns_)) < 0.1, 1).astype(np.float64)
    W = W + W.T
    (Cd,) = on_card(-0.25 * (np.diag(W.sum(-1)) - W))
    ones = torch.ones(ns_, device=dev)
    sdp_obj = lambda r: float(torch.sum(Cd.double() * r.zopt.double()))  # noqa: E731
    # Held against the same steps in f64 on the card: ~4e-6 is what a
    # sound f32 run reads (Newton-Schulz here, LAPACK's f32 eigh on the
    # host), 3.5e-3 what torch's own f32 eigh (cuSOLVER's syevj) reads,
    # which is why ops/prox.sym_eigh decomposes f32 matrices in f64.
    for method, kw in (("eigh", {}), ("ns", {"ns_iters": 16})):
        print(f"  (z7) sdp max-cut n={ns_}, 10% edges, A='diag', prox_method={method!r} {kw}")
        r = main_path(f"z7 {method} timed", lambda: sdp(
            Cd, "diag", ones, timed(SDP_DIAG_TIMED_STEPS), prox_method=method, **kw),
            method == "eigh")
        r64 = sdp(Cd.double(), "diag", ones.double(), timed(SDP_DIAG_TIMED_STEPS),
                  prox_method=method, **kw)
        err = rel(r.zopt, r64.zopt)
        print(f"  (z7) {method}: <C, Z> = {sdp_obj(r):.6f}, the same steps in f64 "
              f"{sdp_obj(r64):.6f}; ||Z_f32 - Z_f64|| / ||Z_f64|| = {err:.3e} (bar 1e-4)")
        check(err <= 1e-4, f"(z7) {method}: Z within 1e-4 of the same steps in f64")
        if method == "eigh":
            _projection_controls("z7", r64.xopt + r64.uopt)
    # The dense stack's drift comes from the affine projection's rounding
    # (||C|| / rho is large beside ||X||): 3.5e-4 with LAPACK's f32 eigh on
    # the host, 1.6e-3 with torch's f32 eigh on the card.
    C, A, b, *_ = random_sdp_instance(*SDP_DENSE, rng, dtype=np.float32)
    Cd, Ad, bd_ = on_card(C, A, b)
    print(f"  (z8) sdp dense, random_sdp_instance{SDP_DENSE}: A {tuple(A.shape)}")
    r = main_path("z8 timed", lambda: sdp(Cd, Ad, bd_, timed(SDP_DENSE_TIMED_STEPS)), True)
    r64 = sdp(Cd.double(), Ad.double(), bd_.double(), timed(SDP_DENSE_TIMED_STEPS))
    err = rel(r.zopt, r64.zopt)
    print(f"  (z8) <C, Z> = {sdp_obj(r):.6f}, the same steps in f64 {sdp_obj(r64):.6f}; "
          f"||Z_f32 - Z_f64|| / ||Z_f64|| = {err:.3e} (bar 1e-3)")
    check(err <= 1e-3, "(z8) Z within 1e-3 of the same steps in f64")
    _projection_controls("z8", r64.xopt + r64.uopt)
    # X is the affine projection: A(X) = b to rounding, as a backward error.
    Af, b64 = Ad.double().reshape(Ad.shape[0], -1), bd_.double()
    normA = float(torch.linalg.matrix_norm(Af, 2))
    for res in (r, r64):
        X = res.xopt.double()
        back = float(torch.linalg.norm(Af @ X.reshape(-1) - b64)
                     / (normA * torch.linalg.norm(X) + torch.linalg.norm(b64)))
        eps = torch.finfo(res.xopt.dtype).eps
        print(f"  (z8) {res.xopt.dtype}: ||A(X) - b|| / (||A|| ||X|| + ||b||) = {back:.3e} "
              f"= {back / eps:.0f} eps (bar 1e4 eps)")
        check(back <= 1e4 * eps, f"(z8) {res.xopt.dtype}: A(X) = b within 1e4 eps")

    # (z9) matrix.py's SDP gap oracle.
    C, A, b, Xs, *_ = random_sdp_instance(16, 24, 6, rng, dtype=np.float32)
    pstar = float(np.sum(C.astype(np.float64) * Xs.astype(np.float64)))
    Cd, Ad, bd_ = on_card(C, A, b)
    for method, bar in (("eigh", 1e-3), ("ns", 1e-2)):
        r = main_path(f"z9 {method}", lambda: sdp(Cd, Ad, bd_, oracle, prox_method=method,
                                                  ns_iters=30), method == "eigh")
        gap = abs(float(np.sum(C.astype(np.float64) * r.zopt.double().cpu().numpy())) - pstar)
        gap /= max(1.0, abs(pstar))
        print(f"  (z9) sdp gap, random_sdp_instance(16, 24, 6), {method}: {gap:.3e} (bar {bar})")
        check(gap <= bar, f"(z9) {method} gap within {bar}")

    # (z10) matrix.py's badly scaled LP, preconditioned, against HiGHS.
    from scipy.optimize import linprog

    m, n = 48, 144
    D = rng.standard_normal((m, n))
    s = D @ np.abs(rng.standard_normal(n))
    b = np.abs(rng.standard_normal(n)) + 0.1
    Gs, Fs = 10.0 ** rng.uniform(-2, 2, m), 10.0 ** rng.uniform(-2, 2, n)
    Dbad = (Gs[:, None] * D * Fs[None, :]).astype(np.float32)
    sbad, bbad = (Gs * s).astype(np.float32), (Fs * b).astype(np.float32)
    out = linprog(bbad.astype(np.float64), A_eq=Dbad.astype(np.float64),
                  b_eq=sbad.astype(np.float64), bounds=[(0, None)] * n, method="highs")
    Dd, sd, bd = on_card(Dbad, sbad, bbad)
    r = main_path("z10 precondition", lambda: linearprogram(bd, Dd, sd, oracle,
                                                            precondition=True))
    plain = linearprogram(bd, Dd, sd, oracle)
    err = abs(float(bbad.astype(np.float64) @ r.xopt.double().cpu().numpy()) - out.fun)
    err /= 1.0 + abs(out.fun)
    print(f"  (z10) preconditioned LP {m}x{n} against HiGHS ({out.fun:.6f}): {err:.3e} "
          f"(bar 2e-3), {r.steps} steps (stalled={r.stalled}); without preconditioning "
          f"{plain.steps} steps (stalled={plain.stalled})")
    check(err <= 2e-3, "(z10) the preconditioned LP within 2e-3 of HiGHS")
    print(f"  (z1)-(z10) took {time.perf_counter() - t0:.1f}s")


def svt_route(V, thresh, route):
    """One SVT of V through ``route``: "f64" decomposes in float64 and
    rounds the factors back (``ops/prox.thin_svd``'s route for f32 on the
    card); otherwise the cuSOLVER driver of that name, or torch's choice
    for None."""
    import torch

    if route == "f64":
        u, s, vt = (t.to(V.dtype) for t in torch.linalg.svd(V.double(), full_matrices=False))
    else:
        u, s, vt = torch.linalg.svd(V, full_matrices=False, driver=route)
    return (u * torch.clamp_min(s - thresh, 0.0).unsqueeze(-2)) @ vt


def svd_route_probe(tag, cases):
    """The port's f32 SVT (``matrixcompletion.svt`` on ``ops/prox.thin_svd``)
    and each route's of each case's V64, against LAPACK's f64 SVT of the
    same matrix on the host, with its host-issued time per call (CUDA
    events around 20 calls, each reading cuSOLVER's info back) and its
    synchronising calls per call; ``cases`` holds (name, V64, threshold).
    A route that fails to converge on a case (cuSOLVER's info, raised by
    torch) is printed as failed.  Checks that the port's SVT converges and
    lands within SVD_ROUTE_SLACK of the most accurate route's error on
    every case; the routes are printed as controls."""
    import warnings

    import torch

    from admm_tpu_torch.models.matrixcompletion import svt

    routes = {r or "torch default": (lambda V, t, r=r: svt_route(V, t, r)) for r in SVD_ROUTES}
    routes["port"] = svt
    for name, V64, thresh in cases:
        ref = svt_route(V64.cpu(), thresh, None)
        V32 = V64.float()
        out = {}
        for route, fn in routes.items():
            try:
                got = fn(V32, thresh)
            except torch.linalg.LinAlgError:
                out[route] = (float("inf"), float("nan"), 0)
                continue
            err = float(torch.linalg.norm(got.double().cpu() - ref) / torch.linalg.norm(ref))
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    fn(V32, thresh)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            syncs = sum("called a synchronizing" in str(w.message) for w in seen)
            out[route] = (err, time_ms(lambda: fn(V32, thresh), 20), syncs)
        print(f"  ({tag}) SVT, {name} f32 {tuple(V64.shape)} against LAPACK f64 on the host "
              f"(||SVT - SVT_f64|| / ||SVT_f64||, ms per call, syncs per call): "
              + ", ".join(f"{r} " + (f"{e:.3e} {t:.3f} ms {y}" if e < float("inf") else "failed")
                          for r, (e, t, y) in out.items()))
        best = min(e for r, (e, _, _) in out.items() if r != "port")
        check(out["port"][0] <= SVD_ROUTE_SLACK * best,
              f"({tag}) {name}: the port's SVT converges within {SVD_ROUTE_SLACK}x the most "
              f"accurate route's error")


def _graded(n, seed):
    """An (n, n) f64 matrix with singular values 10^0 .. 10^-7 and random
    singular vectors: the conditioning an approximate route is weakest
    at."""
    import torch

    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.standard_normal((n, n)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return torch.from_numpy((U * np.logspace(0, -7, n)) @ V.T)


def launches_per_step(solve):
    """CUDA kernel launches per step of ``solve(steps)`` under
    torch.profiler: the launches of a 20-step run less those of a 10-step
    run, over 10 (the set-up's launches cancel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    counts = []
    for steps in (10, 20):
        solve(steps)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            solve(steps)
            torch.cuda.synchronize()
        counts.append(sum(e.count for e in prof.key_averages()
                          if str(e.device_type).endswith("CUDA")))
    return (counts[1] - counts[0]) / 10


def spectral_phase(dev):
    """Slice 7b, (z11)-(z13): robust PCA, matrix completion and sparse
    logistic regression in f32 at matrix.py's widths."""
    import torch

    from admm_tpu_torch import ADMMConfig, logreg, logreg_batch, matrixcompletion, rpca

    t0 = time.perf_counter()
    oracle = ADMMConfig(**ORACLE)

    def timed(steps):
        return ADMMConfig(maxiters=steps, domaxiters=True, unroll="auto")

    def on_card(*arrays):
        return [torch.from_numpy(np.asarray(a, np.float32)).to(dev) for a in arrays]

    print(f"slice 7b: robust PCA, matrix completion and logistic regression in f32, "
          f"{SPECTRAL_TIMED_STEPS} timed steps under domaxiters")

    # (z11) robust PCA, matrix.py:528-539.
    rng = np.random.default_rng(8)
    n = RPCA_N
    L = rng.standard_normal((n, 8)) @ rng.standard_normal((8, n))
    S = (rng.random((n, n)) < 0.05) * 5 * rng.standard_normal((n, n))
    (Md,) = on_card(L + S)
    for method, kw in (("exact", {}), ("rsvd", dict(prox_method="rsvd", rank=RPCA_RANK))):
        print(f"  (z11) rpca {n}x{n}, rank 8 + 5% sparse, {method}")
        r = main_path(f"z11 {method}", lambda: rpca(Md, config=timed(SPECTRAL_TIMED_STEPS), **kw),
                      True, "svd")
        r64 = rpca(Md.double(), config=timed(SPECTRAL_TIMED_STEPS), **kw)
        err = rel(r.xopt, r64.xopt)
        print(f"  (z11) {method}: ||L_f32 - L_f64|| / ||L_f64|| after the same "
              f"{SPECTRAL_TIMED_STEPS} steps = {err:.3e} (bar 1e-3)")
        check(err <= 1e-3, f"(z11) {method}: L within 1e-3 of the same steps in f64")
        if method == "exact":
            V_rpca = Md.double() - r64.zopt - r64.uopt
    svd_route_probe("z11", [("rpca iterate", V_rpca, 1.0),
                            ("graded spectrum", _graded(n, 1).to(dev), 1e-3),
                            ("rank-8 SVT output", r64.xopt, 1.0)])
    # matrix.py:1071-1080's recovery oracle.
    L0 = rng.standard_normal((96, 4)) @ rng.standard_normal((4, 96))
    S0 = (rng.random((96, 96)) < 0.05) * 5 * rng.standard_normal((96, 96))
    (M96,) = on_card(L0 + S0)
    r = main_path("z11 recovery", lambda: rpca(M96, config=oracle), True, "svd")
    err = np.linalg.norm(r.xopt.double().cpu().numpy() - L0) / np.linalg.norm(L0)
    print(f"  (z11) rpca 96x96 rank 4: ||L - L0|| / ||L0|| = {err:.3e} (bar 1e-3)")
    check(err <= 1e-3, "(z11) recovery within 1e-3")

    # (z12) matrix completion, 512 x 512, rank 8, 30% observed.
    rng = np.random.default_rng(9)
    m = MC_N
    M0 = rng.standard_normal((m, MC_RANK)) @ rng.standard_normal((MC_RANK, m))
    mask = rng.random((m, m)) < MC_P
    Mo, maskd = on_card(M0 * mask, mask)
    rec = main_path("z12 recovery", lambda: matrixcompletion(
        Mo, maskd, config=oracle, prox_method="rsvd", rank=MC_RANK), True, "svd")
    err = np.linalg.norm(rec.zopt.double().cpu().numpy() - M0) / np.linalg.norm(M0)
    print(f"  (z12) matrixcompletion {m}x{m} rank {MC_RANK}, {MC_P:.0%} observed, exact form "
          f"(rsvd rank {MC_RANK}): ||Z - M0|| / ||M0|| = {err:.3e} (bar 1e-3)")
    check(err <= 1e-3, "(z12) exact-form recovery within 1e-3")
    for form, mu, kw in (("exact", None, {}), ("noisy", 20.0, {}),
                         ("rsvd", None, dict(prox_method="rsvd", rank=MC_RANK))):
        r = main_path(f"z12 {form}", lambda: matrixcompletion(
            Mo, maskd, mu, config=timed(MC_STEPS), **kw), True, "svd")
        r64 = matrixcompletion(Mo.double(), maskd.double(), mu, config=timed(MC_STEPS), **kw)
        err = rel(r.zopt, r64.zopt)
        print(f"  (z12) {form}: ||Z_f32 - Z_f64|| / ||Z_f64|| after the same {MC_STEPS} steps "
              f"= {err:.3e} (bar {MC_BAR})")
        check(err <= MC_BAR, f"(z12) {form}: Z within {MC_BAR} of the same steps in f64")
        if form == "exact":
            V_mc = r64.xopt + r64.uopt
    svd_route_probe("z12", [("completion iterate", V_mc, 1.0),
                            ("rsvd sketch (18, 512)", V_mc[:18].contiguous(), 1.0)])

    # (z13) logistic regression, matrix.py:541-570, and logregtest's oracle.
    rng = np.random.default_rng(10)
    m, n = LOGREG_SHAPE
    D = rng.standard_normal((m, n))
    p = 1.0 / (1.0 + np.exp(-(D @ rng.standard_normal(n))))
    ell = np.where(rng.random(m) < p, 1.0, -1.0)
    Dd, elld = on_card(D, ell)
    for inner in ("newton", "newton_cg"):
        print(f"  (z13) logreg {m}x{n}, lam 0.1, inner {inner!r}")
        r = main_path(f"z13 {inner}", lambda: logreg(Dd, elld, 0.1,
                                                     timed(SPECTRAL_TIMED_STEPS), inner=inner))
        r64 = logreg(Dd.double(), elld.double(), 0.1, timed(SPECTRAL_TIMED_STEPS), inner=inner)
        err = rel(r.zopt, r64.zopt)
        print(f"  (z13) {inner}: ||z_f32 - z_f64|| / ||z_f64|| after the same steps = {err:.3e} "
              f"(bar 1e-3)")
        check(err <= 1e-3, f"(z13) {inner}: z within 1e-3 of the same steps in f64")
    rng = np.random.default_rng(0)
    Dk = rng.standard_normal((256, 24))
    w = rng.standard_normal(24) * (rng.random(24) < 0.5)
    ellk = np.where(rng.random(256) < 1.0 / (1.0 + np.exp(-(Dk @ w))), 1.0, -1.0)
    Y = Dk * ellk[:, None]
    lam = 0.1 * float(np.max(np.abs(Y.T @ np.full(256, 0.5))))
    Dkd, ellkd = on_card(Dk, ellk)
    for inner in ("newton", "newton_cg"):
        r = main_path(f"z13 kkt {inner}", lambda: logreg(Dkd, ellkd, lam, oracle, inner=inner))
        z = r.zopt.double().cpu().numpy()
        g = -Y.T @ (1.0 / (1.0 + np.exp(Y @ z)))
        act = np.abs(z) > 1e-8
        kkt = max(float(np.max(np.abs(g[act] + lam * np.sign(z[act])))) if act.any() else 0.0,
                  float(max(np.max(np.abs(g[~act])) - lam, 0.0)) if (~act).any() else 0.0)
        print(f"  (z13) logregtest 256x24 f32 {inner}: KKT residual {kkt:.3e} (bar 5e-3)")
        check(kkt <= 5e-3, f"(z13) {inner}: KKT within matrix.py's f32 bar 5e-3")
    y8 = np.random.default_rng(11).integers(0, 8, size=m)
    ell8 = np.stack([np.where(y8 == k, 1.0, -1.0) for k in range(8)])
    (ell8d,) = on_card(ell8)
    for inner in ("newton_cg", "newton"):
        r = main_path(f"z13 batch {inner}", lambda: logreg_batch(
            Dd, ell8d, 0.1, timed(SPECTRAL_TIMED_STEPS), inner=inner))
        r64 = logreg_batch(Dd.double(), ell8d.double(), 0.1, timed(SPECTRAL_TIMED_STEPS),
                           inner=inner)
        err = rel(r.zopt, r64.zopt)
        print(f"  (z13) logreg_batch B=8 one-vs-all {inner}: ||z_f32 - z_f64|| / ||z_f64|| "
              f"= {err:.3e} (bar 1e-3)")
        check(err <= 1e-3, f"(z13) logreg_batch {inner}: within 1e-3 of f64")
    print(f"  (z11)-(z13) took {time.perf_counter() - t0:.1f}s")


def batch_phase(dev):
    """Slice 8, (z14): the paths and instance batches at matrix.py's sizes
    (matrix.py:656-800); returns K4's launches in the tv_batch cell's
    timed run."""
    import torch

    import admm_tpu_torch as T
    from admm_tpu_torch import ADMMConfig, Hooks, admm
    from admm_tpu_torch.models.covarianceselection import make_prox_ops as covsel_ops
    from admm_tpu_torch.ops.tridiag import cr_solve

    t0 = time.perf_counter()
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    rng = np.random.default_rng(12)
    B = LANES

    def covsel_serial(S, lam, cfg, **kw):
        pf, pg, obj, data = covsel_ops(S, lam, cfg, **kw)
        n = S.shape[0]
        return admm(pf, pg, cfg, A=1.0, B=-1.0, c=0.0, shape_x=(n, n), shape_z=(n, n),
                    hooks=Hooks(obj=obj), dtype=S.dtype, data=data)

    # Each cell: (tag, timed steps, batch(operands, cfg) on lanes `idx`,
    # serial(operands, cfg, lane), operands, the f32 bar, K4 expected,
    # the cuSOLVER reads expected).
    m, n = PATH_SHAPE
    Dp = rng.standard_normal((m, n))
    Dp /= np.sqrt(np.sum(Dp**2, axis=0, keepdims=True))
    sp = Dp @ (rng.standard_normal(n) * (rng.random(n) < 0.1))
    lmax = float(np.max(np.abs(Dp.T @ sp)))
    lams = np.geomspace(0.001 * lmax, 0.5 * lmax, B)
    Xb = rng.standard_normal((B, n)) * (rng.random((B, n)) < 0.1)
    Sb = Xb @ Dp.T + 0.03 * rng.standard_normal((B, m))
    lamb = float(0.1 * np.median(np.max(np.abs(Sb @ Dp), axis=1)))
    Sig = np.cumsum(rng.standard_normal((B, TV_BATCH_N)), axis=1)
    Dbp = rng.standard_normal(BP_SHAPE)
    Sbp = (rng.standard_normal((B, BP_SHAPE[1])) * (rng.random((B, BP_SHAPE[1])) < 0.05)) @ Dbp.T
    nq, mq = QP_N, QP_N // 4
    Rq = rng.standard_normal((nq, 2 * nq))
    Pq = Rq @ Rq.T / (2 * nq) + 0.1 * np.eye(nq)
    Dq = rng.standard_normal((mq, nq))
    Ssq = np.abs(rng.standard_normal((QP_LANES, nq))) @ Dq.T
    Qsq = rng.standard_normal((QP_LANES, nq))
    nc = COVSEL_BN
    Zc = rng.standard_normal((COVSEL_LANES, nc, 4 * nc))
    Sc = Zc @ np.swapaxes(Zc, 1, 2) / (4 * nc) + 0.1 * np.eye(nc)
    Wadj = np.triu((rng.random((SDP_LANES, SDP_BN, SDP_BN)) < 0.1).astype(np.float64), 1)
    Wadj = Wadj + np.swapaxes(Wadj, 1, 2)
    Lap = np.stack([np.diag(w.sum(-1)) for w in Wadj]) - Wadj
    ones = np.ones(SDP_BN)
    cells = [
        ("lasso_path", LANE_STEPS, (Dp, sp, lams), 1e-3,
         lambda o, c, i: T.lasso_path(o[0], o[1], o[2][i], c),
         lambda o, c, j: T.lasso(o[0], o[1], o[2][j], c), None),
        ("lasso_batch", LANE_STEPS, (Dp, Sb), 1e-3,
         lambda o, c, i: T.lasso_batch(o[0], o[1][i], lamb, c),
         lambda o, c, j: T.lasso(o[0], o[1][j], lamb, c), None),
        ("tv_batch", LANE_STEPS, (Sig,), 0.02,
         lambda o, c, i: T.tv_batch(o[0][i], 1.0, c, solver="cr"),
         lambda o, c, j: T.totalvariation(o[0][j], 1.0, c, solver="cr"), None),
        ("basispursuit_batch", LANE_STEPS, (Dbp, Sbp), 1e-4,
         lambda o, c, i: T.basispursuit_batch(o[0], o[1][i], c),
         lambda o, c, j: T.basispursuit(o[0], o[1][j], c), None),
        ("qp_batch", QP_STEPS, (Pq, Qsq, Dq, Ssq), 5e-3,
         lambda o, c, i: T.qp_batch(o[0], o[1][i], 0.0, o[2], o[3][i], c),
         lambda o, c, j: T.quadraticprogram(o[0], o[1][j], 0.0, o[2], o[3][j], c), None),
        ("covsel_batch ns", COVSEL_STEPS, (Sc,), 1e-3,
         lambda o, c, i: T.covsel_batch(o[0][i], 0.05, c),
         lambda o, c, j: covsel_serial(o[0][j], 0.05, c, prox_method="ns"), None),
        ("covsel_batch ns_fast", COVSEL_STEPS, (Sc,), 1e-3,
         lambda o, c, i: T.covsel_batch(o[0][i], 0.05, c, prox_method="ns_fast", ns_iters=14),
         lambda o, c, j: covsel_serial(o[0][j], 0.05, c, prox_method="ns_fast", ns_iters=14),
         None),
        ("sdp_batch eigh", SDP_STEPS, (-0.25 * Lap, ones), 1e-3,
         lambda o, c, i: T.sdp_batch(o[0][i], "diag", o[1], c),
         lambda o, c, j: T.sdp(o[0][j], "diag", o[1], c), "eigh"),
        ("sdp_batch ns", SDP_STEPS, (-0.25 * Lap, ones), 1e-3,
         lambda o, c, i: T.sdp_batch(o[0][i], "diag", o[1], c, prox_method="ns", ns_iters=16),
         lambda o, c, j: T.sdp(o[0][j], "diag", o[1], c, prox_method="ns", ns_iters=16), None),
    ]
    print(f"slice 8: paths and instance batches in f32 at matrix.py's sizes (B = {B}; qp "
          f"{QP_LANES}, covsel {COVSEL_LANES}, sdp {SDP_LANES}), timed under domaxiters; "
          f"{CHECK_LANES} lanes of each held in f64 against the serial solve")
    tv_launches = None
    for tag, steps, arrays, bar, batch, serial, reads in cells:
        t1 = time.perf_counter()
        o32 = [f32(a) for a in arrays]
        o64 = [a.double() for a in o32]
        every = slice(None)
        timed = ADMMConfig(maxiters=steps, domaxiters=True)
        r = main_path(f"z14 {tag}", lambda: batch(o32, timed, every), reads is not None,
                      reads, once="K4" if tag == "tv_batch" else None)
        check(int(r.steps.min()) == steps, f"(z14 {tag}) every lane ran {steps} steps")
        lanes = r.steps.numel()
        if tag == "tv_batch":
            tv_launches = cr_solve.launches
        per_step = launches_per_step(lambda k: batch(
            o32, ADMMConfig(maxiters=k, domaxiters=True), every))
        print(f"  (z14 {tag}) {lanes} lanes: {per_step:.1f} CUDA launches per step "
              f"(torch.profiler, 20-step run less 10-step run)")
        # CHECK_LANES lanes in f64 against the serial f64 solves, and the
        # same lanes in f32 against f64.
        idx = list(range(lanes - 1, -1, -(lanes // CHECK_LANES)))[:CHECK_LANES]
        cfg = ADMMConfig(maxiters=CHECK_STEPS.get(tag, CHECK_MAXITERS))
        b64 = batch(o64, cfg, idx)
        b32 = batch(o32, cfg, idx)
        worst = 0.0
        for k, j in enumerate(idx):
            solo = serial(o64, cfg, j)
            check(int(b64.steps[k]) == solo.steps,
                  f"(z14 {tag}) lane {j}: f64 steps {int(b64.steps[k])} == serial {solo.steps}")
            scale = float(solo.xopt.abs().max()) or 1.0
            worst = max(worst, float((b64.xopt[k] - solo.xopt).abs().max()) / scale)
        err = rel(b32.xopt, b64.xopt)
        print(f"  (z14 {tag}) lanes {idx}: f64 steps {b64.steps.tolist()} (f32 "
              f"{b32.steps.tolist()}), max|x_lane - x_serial| / ||x_serial||_inf = "
              f"{worst:.3e} (bar 1e-9); ||x_f32 - x_f64|| / ||x_f64|| = {err:.3e} (bar {bar})")
        check(worst <= 1e-9, f"(z14 {tag}) f64 lanes equal the serial f64 solves to 1e-9")
        check(err <= bar, f"(z14 {tag}) f32 lanes within {bar} of f64")
        if tag == "tv_batch":
            # The whole batch converging, with K4 and with the plain b-phase.
            conv = ADMMConfig(maxiters=CHECK_MAXITERS)
            k_run = main_path("z14 tv_batch converging", lambda: batch(o32, conv, every),
                              once="K4")
            p_run = T.tv_batch(o32[0], 1.0, conv, solver="cr", _plain_cr=True)
            diff = float((k_run.xopt - p_run.xopt).abs().max())
            xinf = float(k_run.xopt.abs().max())
            print(f"  (z14 tv_batch) plain b-phase: steps equal {torch.equal(k_run.steps, p_run.steps)}, "
                  f"max|x_kernel - x_plain| = {diff:.3e}, ||x||_inf = {xinf:.6g}")
            check(torch.equal(k_run.steps, p_run.steps), "(z14 tv_batch) per-lane steps equal "
                  "with the plain b-phase")
            check(diff <= 1e-6 * xinf, "(z14 tv_batch) x within 1e-6 ||x||_inf of the plain "
                  "b-phase's")
        print(f"  (z14 {tag}) took {time.perf_counter() - t1:.1f}s")
    print(f"  (z14) took {time.perf_counter() - t0:.1f}s")
    return tv_launches



@contextlib.contextmanager
def syncs_in():
    """Count the synchronising CUDA calls of a block, as
    torch.cuda.set_sync_debug_mode("warn") reports them: yields a dict
    whose "n" is set on exit."""
    import warnings

    import torch

    got = {"n": 0}
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield got
        finally:
            torch.cuda.set_sync_debug_mode("default")
            got["n"] = sum("called a synchronizing" in str(w.message) for w in seen)


def kernel_counts():
    """Every kernel wrapper's launch count (K1-K4), as a dict."""
    from admm_tpu_torch.ops.gemv_pair import gemv_pair, resident_lasso
    from admm_tpu_torch.ops.kernels import fused_diff_tail, fused_soft_threshold_dual, fused_zu_tail
    from admm_tpu_torch.ops.tridiag import cr_solve

    return {"K1": fused_soft_threshold_dual, "K1b": fused_zu_tail, "K1b-D": fused_diff_tail,
            "K2": gemv_pair, "K3": resident_lasso, "K4": cr_solve}


def reset_counts():
    for k in kernel_counts().values():
        k.launches = 0


def read_counts():
    return {name: k.launches for name, k in kernel_counts().items()}


def forward_and_backward(loss, *args):
    """``loss(*args)``'s value and its gradient with respect to every arg
    through ``torch.func.vjp``, with the kernels' launches, the wall times
    and the synchronising calls of the forward and of the backward
    counted apart."""
    import torch

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    val, pull = torch.func.vjp(loss, *args)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fwd = read_counts()
    reset_counts()
    with syncs_in() as sy:
        grads = pull(torch.ones_like(val))
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    return val, grads, {"fwd": fwd, "bwd": read_counts(), "t_fwd": t1 - t0, "t_bwd": t2 - t1,
                        "bwd_syncs": sy["n"]}


def hypergradient_phase(dev):
    """Slice 9 and the single-device half of slice 11, (z15a)-(z15d):
    hypergradients through ``make_implicit_solver`` and
    ``make_implicit_batch_solver`` on the card, K4's backward and tangent
    among them, K2's backward, and the tester harness.  Returns K4's and
    K2's launches by path."""
    import torch

    from admm_tpu_torch import (ADMMConfig, lasso, make_implicit_batch_solver,
                                make_implicit_solver, testers)
    from admm_tpu_torch.benchmarks.headline import make_problem
    from admm_tpu_torch.linop import DiffOp
    from admm_tpu_torch.models.lasso import make_prox_ops as lasso_ops
    from admm_tpu_torch.models.totalvariation import _prox_f_cr_plain, make_prox_ops
    from admm_tpu_torch.utils import showresults
    from admm_tpu_torch.utils.profiling import iteration_rate, trace

    t0 = time.perf_counter()
    name = lambda dt: str(dt).split(".")[-1]  # noqa: E731
    launches = {"K4": {}, "K2": {}}

    def rel_err(a, b):
        return float(torch.linalg.norm((a - b).double()) / torch.linalg.norm(b.double()))

    # (z15a) the TV hypergradient at n = 65536, the hybrid cyclic reduction.
    n = HG_N
    truth, sig = staircase_pair(n)

    def tv(dtype, plain=False, mode="vjp"):
        cfg = ADMMConfig(maxiters=HG_MAXITERS, unroll="auto", **HG_STOP[name(dtype)])
        pf, pg, _, data, _ = make_prox_ops(torch.from_numpy(sig).to(dev, dtype), TV_LAM, cfg,
                                           solver="cr")
        check(data["cr"].Tinv is not None, f"(z15a) n={n} 'cr' is the hybrid form")
        solve = make_implicit_solver(_prox_f_cr_plain if plain else pf, pg, cfg, A=DiffOp(n),
                                     nA=n, nB=n, mode=mode, vjp_tol=HG_VJP_TOL[name(dtype)],
                                     vjp_maxiters=HG_VJP_MAXITERS)
        t = torch.from_numpy(truth).to(dev, dtype)
        loss = lambda lam, s: torch.mean((solve(dict(data, lam=lam, s=s))[0] - t) ** 2)  # noqa: E731
        return solve, data, loss

    runs = {}
    _, _, loss = tv(torch.float32)  # warm-up: the first call pays the card's lazy set-up
    forward_and_backward(loss, torch.tensor(TV_LAM, device=dev),
                         torch.from_numpy(sig).to(dev))
    for dtype, plain in ((torch.float32, False), (torch.float32, True), (torch.float64, False)):
        solve, data, loss = tv(dtype, plain)
        val, (g_lam, g_s), c = forward_and_backward(loss, data["lam"], data["s"])
        st = solve.stats
        tag = f"{name(dtype)}{' plain b-phase' if plain else ''}"
        print(f"  (z15a) {tag}: loss {float(val):.8g}, dloss/dlam {float(g_lam):.8g}, "
              f"||dloss/ds|| {float(torch.linalg.norm(g_s)):.6g}; forward {c['t_fwd']:.3f}s, "
              f"K4 {c['fwd']['K4']}; backward {c['t_bwd']:.3f}s, {st['steps'][0]} adjoint "
              f"steps, {st['applies']} J^T applications, K4 {c['bwd']['K4']}, host reads "
              f"{st['reads']} ({c['bwd_syncs']} synchronising calls)")
        if plain:
            check(c["fwd"]["K4"] == 0 and c["bwd"]["K4"] == 0,
                  "(z15a) the plain b-phase launches no K4")
        else:
            check(c["fwd"]["K4"] > 0, f"(z15a) {tag} forward through K4")
            check(c["bwd"]["K4"] == st["applies"] + 3,
                  f"(z15a) {tag} backward: K4 once per J^T application plus 3 "
                  f"({c['bwd']['K4']} for {st['applies']})")
            check(sum(v for k, v in c["bwd"].items() if k != "K4") == 0,
                  f"(z15a) {tag} backward launches no other kernel")
            check(c["bwd_syncs"] == st["reads"],
                  f"(z15a) {tag} backward: its {st['reads']} host reads are its only "
                  f"synchronising calls")
        check(bool(torch.isfinite(g_s).all()) and bool(torch.isfinite(g_lam)),
              f"(z15a) {tag} gradients finite")
        runs[tag] = (g_lam, g_s, c, solve, data, loss)
        if tag == "float32":
            launches["K4"]["z15a forward"] = c["fwd"]["K4"]
            launches["K4"]["z15a backward"] = c["bwd"]["K4"]
    k32, p32, k64 = (runs[t] for t in ("float32", "float32 plain b-phase", "float64"))
    e_lam = abs(float(k32[0] - p32[0])) / abs(float(p32[0]))
    e_s = rel_err(k32[1], p32[1])
    print(f"  (z15a) f32 kernel against the plain b-phase: dlam {e_lam:.3e}, ds {e_s:.3e} "
          f"(bar 1e-5)")
    check(max(e_lam, e_s) <= 1e-5, "(z15a) f32 gradients through K4 within 1e-5 of the plain "
          "b-phase's")
    e_lam = abs(float(k32[0]) - float(k64[0])) / abs(float(k64[0]))
    e_s = rel_err(k32[1], k64[1])
    print(f"  (z15a) f32 against f64: dlam {e_lam:.3e}, ds {e_s:.3e} (bar 1e-3)")
    check(max(e_lam, e_s) <= 1e-3, "(z15a) f32 gradients within 1e-3 of f64")
    g_lam64, _, _, _, data64, loss64 = k64
    with torch.no_grad():
        lam = float(data64["lam"])
        fd = (loss64(data64["lam"] + HG_FD_H, data64["s"])
              - loss64(data64["lam"] - HG_FD_H, data64["s"])) / (2 * HG_FD_H)
    e_fd = abs(float(g_lam64) - float(fd)) / abs(float(fd))
    print(f"  (z15a) f64 dloss/dlam {float(g_lam64):.10g} against a central difference "
          f"(h {HG_FD_H} at lam {lam}) {float(fd):.10g}: {e_fd:.3e} (bar 2e-4)")
    check(abs(float(g_lam64) - float(fd)) <= 2e-4 * abs(float(fd)) + 1e-8,
          "(z15a) f64 dloss/dlam within 2e-4 of finite differences")
    solve_j, data_j, loss_j = tv(torch.float64, mode="jvp")
    reset_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, dot = torch.func.jvp(lambda l: loss_j(l, data_j["s"]), (data_j["lam"],),
                            (torch.ones_like(data_j["lam"]),))
    torch.cuda.synchronize()
    e_j = abs(float(dot) - float(g_lam64)) / abs(float(g_lam64))
    print(f"  (z15a) f64 mode='jvp': {float(dot):.12g} in {time.perf_counter() - t1:.3f}s "
          f"({solve_j.stats['steps'][0]} tangent steps, K4 {read_counts()['K4']}); against "
          f"mode='vjp' {e_j:.3e} (bar 1e-6)")
    check(e_j <= 1e-6, "(z15a) f64 forward mode within 1e-6 of reverse mode")

    # (z15b) per-lane hypergradients on tv_batch's lanes, f64.
    B, n = HG_LANES, HG_LANE_N
    rng = np.random.default_rng(15)
    W = np.cumsum(rng.standard_normal((B, n)), axis=1)
    S = torch.from_numpy(W + 0.5 * rng.standard_normal((B, n))).to(dev)
    Wt = torch.from_numpy(W).to(dev)
    lams = torch.from_numpy(np.geomspace(0.25, 4.0, B)).to(dev)
    cfg = ADMMConfig(maxiters=HG_MAXITERS, abstol=HG_LANE_TOL, reltol=HG_LANE_TOL, unroll="auto")
    pf, pg, _, data, _ = make_prox_ops(S[0], 1.0, cfg, solver="cr", batched=True)
    kw = dict(A=DiffOp(n), nA=n, nB=n, vjp_tol=HG_LANE_TOL, vjp_maxiters=HG_VJP_MAXITERS)
    batch = make_implicit_batch_solver(pf, pg, cfg, mapped={"s", "lam"}, **kw)
    loss_b = lambda l: torch.sum(torch.mean((batch(dict(data, s=S, lam=l))[0] - Wt) ** 2, dim=1))  # noqa: E731
    _, (g,), c = forward_and_backward(loss_b, lams)
    st = batch.stats
    print(f"  (z15b) {B} lanes n={n} f64: forward {c['t_fwd']:.3f}s, K4 {c['fwd']['K4']}; "
          f"backward {c['t_bwd']:.3f}s, adjoint steps {min(st['steps'])}-{max(st['steps'])}, "
          f"{st['applies']} J^T applications, K4 {c['bwd']['K4']}, host reads {st['reads']} "
          f"({c['bwd_syncs']} synchronising calls)")
    check(c["bwd"]["K4"] == st["applies"] + 2,
          f"(z15b) backward: one K4 solve of all {B} lanes per J^T application plus 2 "
          f"({c['bwd']['K4']} for {st['applies']})")
    check(c["bwd_syncs"] == st["reads"],
          f"(z15b) backward: its {st['reads']} host reads are its only synchronising calls")
    launches["K4"]["z15b forward"], launches["K4"]["z15b backward"] = c["fwd"]["K4"], c["bwd"]["K4"]
    serial = make_implicit_solver(pf, pg, cfg, **kw)
    for i in HG_CHECK:
        gi = torch.func.grad(lambda li: torch.mean(
            (serial(dict(data, s=S[i], lam=li))[0] - Wt[i]) ** 2))(lams[i])
        e = abs(float(g[i]) - float(gi)) / abs(float(gi))
        print(f"  (z15b) lane {i}: lanes {float(g[i]):.15g}, serial {float(gi):.15g}, rel {e:.3e}")
        check(e <= 1e-9, f"(z15b) lane {i} equals the serial f64 gradient to 1e-9")

    # (z15c) the LASSO hypergradient at the headline width (cuBLAS, no kernel).
    D, s, lam = make_problem()
    grads = {}
    for dtype in (torch.float32, torch.float64):
        cfg = ADMMConfig(maxiters=HG_MAXITERS, unroll="auto", **HG_STOP[name(dtype)])
        Dd, sd = (torch.from_numpy(a).to(dev, dtype) for a in (D, s))
        pf, pg, _, data = lasso_ops(Dd, sd, lam, cfg)
        m_ = D.shape[1]
        solve = make_implicit_solver(pf, pg, cfg, nA=m_, nB=m_, m=m_,
                                     vjp_tol=HG_VJP_TOL[name(dtype)], vjp_maxiters=HG_VJP_MAXITERS)
        val, (g_l,), c = forward_and_backward(
            lambda l: torch.sum(solve(dict(data, lam=l))[0] ** 2), data["lam"])
        grads[dtype] = float(g_l)
        print(f"  (z15c) lasso {D.shape[0]}x{m_} {name(dtype)}: dloss/dlam {float(g_l):.10g}; "
              f"forward {c['t_fwd']:.3f}s, backward {c['t_bwd']:.3f}s, {solve.stats['steps'][0]} "
              f"adjoint steps, host reads {solve.stats['reads']}; kernel launches {c['bwd']}")
        check(not any(c["fwd"].values()) and not any(c["bwd"].values()),
              f"(z15c) {name(dtype)} runs no kernel")
    e = abs(grads[torch.float32] - grads[torch.float64]) / abs(grads[torch.float64])
    print(f"  (z15c) f32 against f64: {e:.3e} (bar 1e-3)")
    check(e <= 1e-3, "(z15c) f32 dloss/dlam within 1e-3 of f64")
    # bf16 streams: K2 in the forward, and its transposed pair in every
    # adjoint step (the pair's backward).
    cfg = ADMMConfig(maxiters=HG_MAXITERS, unroll="auto", **HG_STOP["float32"])
    pf, pg, _, data = lasso_ops(*(torch.from_numpy(a).to(dev) for a in (D, s)), lam, cfg,
                                stream_dtype=torch.bfloat16)
    m_ = D.shape[1]
    solve = make_implicit_solver(pf, pg, cfg, nA=m_, nB=m_, m=m_, vjp_tol=HG_VJP_TOL["bfloat16"],
                                 vjp_maxiters=HG_VJP_MAXITERS)
    val, (g_b,), c = forward_and_backward(
        lambda l: torch.sum(solve(dict(data, lam=l))[0] ** 2), data["lam"])
    st = solve.stats
    e = abs(float(g_b) - grads[torch.float32]) / abs(grads[torch.float32])
    print(f"  (z15c) lasso bf16 streams: dloss/dlam {float(g_b):.10g}; forward {c['t_fwd']:.3f}s, "
          f"K2 {c['fwd']['K2']}; backward {c['t_bwd']:.3f}s, {st['steps'][0]} adjoint steps, "
          f"{st['applies']} J^T applications, K2 {c['bwd']['K2']}, host reads {st['reads']}; "
          f"against f32 {e:.3e} (bar 2e-2)")
    check(bool(np.isfinite(float(g_b))), "(z15c) bf16-stream gradient finite")
    check(c["fwd"]["K2"] > 0, "(z15c) bf16 forward through K2")
    check(c["bwd"]["K2"] == st["applies"] + 2,
          f"(z15c) bf16 backward: K2 once per J^T application plus 2, the linearization's "
          f"primal and the data VJP's ({c['bwd']['K2']} for {st['applies']})")
    check(sum(v for k, v in c["bwd"].items() if k != "K2") == 0,
          "(z15c) bf16 backward launches no other kernel")
    check(e <= 2e-2, "(z15c) bf16 dloss/dlam within 2e-2 of f32")
    launches["K2"]["z15c forward"], launches["K2"]["z15c backward"] = c["fwd"]["K2"], c["bwd"]["K2"]

    # (z15d) the harness on the card, f64.
    t1 = time.perf_counter()
    for tester in (testers.modeltest, testers.lassotest, testers.basispursuittest,
                   testers.totalvariationtest, testers.ladtest, testers.huberfittest,
                   testers.linearprogramtest, testers.quadraticprogramtest,
                   lambda: testers.quadraticprogramtest(form="bounded"),
                   testers.covarianceselectiontest, testers.logregtest):
        res, test = tester()
        check(res.xopt.device.type == "cuda" and not test["failed"],
              f"(z15d) {test['solver']}{' ' + test.get('form', '') if 'form' in test else ''} "
              f"tester passes on the card ({res.steps} steps) {test['failreason']}")
    res_h, res_01, test = testers.linearsvmtest()
    check(not test["failed"], "(z15d) linearsvm tester passes on the card")
    rep = testers.solvertester("lasso", 4, 6, trials=2, seed=0)
    print("  (z15d) " + rep.summary().replace("\n", "\n  (z15d) "))
    check(not rep.any_failed, "(z15d) solvertester('lasso', 4, 6, trials=2) reports no failure")
    res, test = testers.lassotest()
    text = showresults(res, test, print_fn=lambda *_: None)
    print("  (z15d) " + text.replace("\n", "\n  (z15d) "))
    check("ADMM results" in text and "PASSED: True" in text, "(z15d) showresults prints its text")
    Dh, sh = (torch.from_numpy(a).to(dev) for a in make_problem(smoke=True)[:2])
    rate = iteration_rate(lambda: lasso(Dh, sh, 0.1, ADMMConfig(maxiters=100, domaxiters=True)))
    logdir = ROOT / "build" / "z15_trace"
    with trace(str(logdir)):
        lasso(Dh, sh, 0.1, ADMMConfig(maxiters=20, domaxiters=True))
    size = (logdir / "trace.json").stat().st_size
    print(f"  (z15d) iteration_rate {rate:.2f} solves/s; trace.json {size} bytes; harness "
          f"{time.perf_counter() - t1:.1f}s")
    check(rate > 0 and size > 0, "(z15d) iteration_rate and trace run")
    print(f"  (z15) took {time.perf_counter() - t0:.1f}s")
    return launches


def slice11b_phase(dev):
    """Slice 11b, (z16a)-(z16e), through the CLI and the examples a user
    calls; returns the launches of K1b, K1b-D, K2 and K4 on their paths."""
    import torch

    from admm_tpu_torch.__main__ import main as cli
    from admm_tpu_torch.examples import (acceleration, convergencechecking,
                                         fasteradmmcomparison, hnormdemo, maxcut, mnistsvm,
                                         mpc_qp, portfolio, relaxationexample, stepsizetesting)

    t0 = time.perf_counter()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)

    # (z16a), (z16b) python -m admm_tpu_torch matrix: every single-device
    # timing row at its width, steps cut to Z16_STEPS, then the accuracy rows.
    print(f"slice 11b: python -m admm_tpu_torch matrix --steps {Z16_STEPS}")
    reset_counts()
    t1 = time.perf_counter()
    check(cli(["matrix", "--steps", str(Z16_STEPS), "--out", str(out / "z16_matrix.json")]) == 0,
          "(z16a) the matrix command exits 0")
    torch.cuda.synchronize()
    counts = read_counts()
    doc = json.loads((out / "z16_matrix.json").read_text())
    timed = doc["timing"]
    print(f"  (z16a) {len(timed)} timed rows; kernel launches {counts}; "
          f"{time.perf_counter() - t1:.1f}s (with the accuracy rows)")
    check(len(timed) == Z16_TIMED_ROWS and not any("skipped" in r for r in timed),
          f"(z16a) {Z16_TIMED_ROWS} timed rows, the twelve sharded ones among them")
    for r in timed:
        check(r["bound_ms_per_iter"] > 0 and ("pct_of_roofline" in r) != ("roofline_note" in r),
              f"(z16a) {r['solver']} {r['shape']}: bound {r['bound_ms_per_iter']:.5f} ms "
              f"({r['bound_by']}), {r['iters_per_sec']:.1f} iter/s")
    invalid = {(r["solver"], r["shape"]) for r in timed if r.get("valid") is False}
    print(f"  (z16a) rows that stopped early or are not finite: {sorted(invalid)}")
    check(invalid <= Z16_KNOWN_TIMING_FAULTS,
          "(z16a) every timed row runs its steps to a finite result, or is a recorded fault")
    for kernel, rows in (("K1b", 2), ("K2", 2), ("K4", 3)):
        check(counts[kernel] >= 4 * rows * Z16_STEPS,
              f"(z16a) {kernel} launched >= {4 * rows * Z16_STEPS} times on its {rows} rows")
    failed = {r["solver"] for r in doc["f32_oracle_accuracy"] if r["failed"]}
    print(f"  (z16b) {len(doc['f32_oracle_accuracy'])} accuracy rows, failing: {sorted(failed)}")
    check(len(doc["f32_oracle_accuracy"]) == Z16_ACCURACY_ROWS,
          f"(z16b) {Z16_ACCURACY_ROWS} accuracy rows")
    check(failed <= Z16_KNOWN_F32_FAULTS,
          "(z16b) every f32 row within admm_tpu's bar, or a recorded fault")

    # (z16c) python -m admm_tpu_torch sweep --smoke.
    t1 = time.perf_counter()
    rc = cli(["sweep", "--smoke", "--out", str(out / "z16_sweep.json")])
    sweep = json.loads((out / "z16_sweep.json").read_text())
    red = {f["solver"] for f in sweep["families"] if f["any_failed"]}
    print(f"  (z16c) sweep --smoke: exit {rc}, failing families {sorted(red)}, "
          f"{time.perf_counter() - t1:.1f}s")
    check(len(sweep["families"]) == 10 and rc == (0 if not red else 1),
          "(z16c) the sweep covers the ten families and exits 0 only when all pass")
    check(red <= Z16_KNOWN_SWEEP_FAULTS, "(z16c) every family passes, or is a recorded fault")

    # (z16d) mnistsvm at its defaults: 6000 x 400 images, ten digits, hinge
    # and 0-1 loss, each loss the ten lanes of one svm_batch solve.
    t1 = time.perf_counter()
    before = read_counts()
    rows = mnistsvm.mnistsvm(device=dev)
    torch.cuda.synchronize()
    print(f"  (z16d) mnistsvm: {time.perf_counter() - t1:.1f}s, kernel launches "
          f"{ {k: v - before[k] for k, v in read_counts().items()} }")
    check(len(rows) == 10 and np.isfinite(np.asarray(rows)).all()
          and all(r[1] < 35.0 for r in rows),
          "(z16d) ten digits, finite errors, every hinge train error below 35%")
    (tr_x, tr_y), _, _ = mnistsvm.load_mnist()
    D = tr_x.reshape(len(tr_x), -1)
    lane = mnistsvm.train_all_digits(D, tr_y, [0, 1], device=dev)[0]
    solo = mnistsvm.train_for_digit(D, tr_y, 0, device=dev)
    e = float(np.linalg.norm(lane - solo) / np.linalg.norm(solo))
    print(f"  (z16d) digit 0 hinge: lanes against the serial solve {e:.3e} (bar 1e-9)")
    check(e <= 1e-9, "(z16d) a lane of svm_batch equals the serial linearsvm in f64")

    # (z16e) each other example once, at its defaults but the acceleration
    # example's step caps.
    for name, run in (
            ("convergencechecking", lambda: convergencechecking.convergencechecking(device=dev)),
            ("fasteradmmcomparison", lambda: fasteradmmcomparison.fasteradmmcomparison(
                device=dev)),
            ("hnormdemo", lambda: hnormdemo.hnormdemo(device=dev)),
            ("relaxationexample", lambda: relaxationexample.relaxationexample(device=dev)),
            ("stepsizetesting", lambda: stepsizetesting.stepsizetesting(device=dev)),
            ("acceleration_ladder", lambda: acceleration.acceleration_ladder(
                device=dev, maxiters=Z16_LADDER_STEPS)),
            ("badly_scaled_lp", lambda: acceleration.badly_scaled_lp(
                device=dev, maxiters=Z16_LP_STEPS)),
            ("portfolio", lambda: portfolio.efficient_frontier(device=dev)),
            ("mpc_qp", lambda: mpc_qp.mpc_qp(device=dev)),
            ("maxcut", lambda: maxcut.maxcut_demo(device=dev))):
        t1 = time.perf_counter()
        print(f"  (z16e) {name}:")
        got = run()
        torch.cuda.synchronize()
        print(f"  (z16e) {name}: {time.perf_counter() - t1:.1f}s")
        EXAMPLE_CHECKS[name](got)
    print(f"  (z16) took {time.perf_counter() - t0:.1f}s")
    return {k: counts[k] for k in ("K1b", "K1b-D", "K2", "K4")}


def cuda_kernels(solve):
    """``(result, launches, ms)``: ``solve()``'s result, its CUDA kernel
    launches and their device time under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        r = solve()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    return (r, sum(e.count for e in events),
            sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
                for e in events) / 1e3)


def _stop_margin(tag, a, b):
    """Print the deciding step's pnorm/perr and dnorm/derr of two runs."""
    k = min(a.steps, b.steps) - 1
    for name, r in (("f32", a), ("f64", b)):
        print(f"  ({tag}) {name} step {k + 1}: pnorm {r.pnorm[k]:.9e} perr {r.perr[k]:.9e} "
              f"dnorm {r.dnorm[k]:.9e} derr {r.derr[k]:.9e}")


def z17_problem(dev):
    """(z17a)'s consensus LASSO, ``(D, s, lam)``: D on ``dev`` from a seeded
    generator, unit columns, s from a 10%-sparse x_true plus noise, lambda
    = 0.1 ||D^T s||_inf; the same bits on every call on the same card."""
    import torch

    m, n = Z17_W * Z17_ROWS, Z17_N
    gen = torch.Generator(device=dev).manual_seed(17)
    D = torch.randn(m, n, generator=gen, device=dev)
    D /= torch.linalg.vector_norm(D, dim=0, keepdim=True)
    x_true = torch.randn(n, generator=gen, device=dev) * (
        torch.rand(n, generator=gen, device=dev) < 0.1)
    s = D @ x_true + 0.03 * torch.randn(m, generator=gen, device=dev)
    return D, s, float(0.1 * torch.max(torch.abs(D.T @ s)))


def slice10a_phase(dev):
    """Slice 10a, (z17a)-(z17b): the distributed layer with its shards
    stacked on the card; returns every kernel's launches summed over the
    phase's main-path runs (all 0, each run is checked) and what (z18)
    holds against (z17a): its converging f32 run, the serial f64
    objective, and the timed run's iter/s, launches and device us a step."""
    import torch

    import admm_tpu_torch.parallel as TP
    from admm_tpu_torch.parallel import consensus as TC
    from admm_tpu_torch import (ADMMConfig, admm, covarianceselection, lasso, linearsvm, logreg,
                                sdp)
    from admm_tpu_torch.models.sdp import random_sdp_instance

    t0 = time.perf_counter()
    total = dict.fromkeys(kernel_counts(), 0)
    mp = functools.partial(main_path, tally=total)

    W, rows, n = Z17_W, Z17_ROWS, Z17_N
    m = W * rows
    print(f"slice 10a: consensus_lasso, {W} shards of {rows} rows, n = {n}, f32")

    D, s, lam = z17_problem(dev)
    print(f"  (z17a) D {m}x{n} f32 ({D.numel() * 4 / 2**30:.2f} GiB), Minv stack "
          f"{W * n * n * 4 / 2**20:.0f} MiB, lambda {lam:.6f}")
    cfg = ADMMConfig(maxiters=5000)
    r32 = mp("z17a", lambda: TP.consensus_lasso(D, s, lam, cfg, nshards=W))
    D64, s64 = D.double(), s.double()
    r64 = TP.consensus_lasso(D64, s64, lam, cfg, nshards=W)
    print(f"  (z17a) f32 steps {r32.steps}, f64 steps {r64.steps}")
    if r32.steps != r64.steps:
        _stop_margin("z17a", r32, r64)
    check(abs(r32.steps - r64.steps) <= 1 and r32.steps < cfg.maxiters,
          "(z17a) converges with the steps of f64 on the card, or one apart")
    ser = lasso(D64, s64, lam, cfg)

    def obj(z):
        z = z.double()
        return float(0.5 * torch.sum((D64 @ z - s64) ** 2) + lam * torch.sum(torch.abs(z)))

    f32, fser = obj(r32.zopt), obj(ser.xopt)
    print(f"  (z17a) objective f32 consensus {f32:.9g}, f64 consensus {obj(r64.zopt):.9g}, "
          f"serial f64 lasso {fser:.9g} ({ser.steps} steps); rel. gap "
          f"{abs(f32 - fser) / abs(fser):.3e} (bar 1e-2)")
    check(abs(f32 - fser) <= 1e-2 * abs(fser), "(z17a) objective within 1e-2 of serial f64")
    del D64, s64, r64, ser
    z17a = {"r32": r32, "fser": fser}

    tcfg = ADMMConfig(maxiters=Z17_TIMED_STEPS, domaxiters=True, unroll="auto")
    rt = mp("z17a timed", lambda: TP.consensus_lasso(D, s, lam, tcfg, nshards=W))
    check(rt.steps == Z17_TIMED_STEPS, f"(z17a) {Z17_TIMED_STEPS} steps under domaxiters")
    # The profiled run: the per-shard set-up (the 2 GiB Gram, the Cholesky
    # inverses) built once outside it, so its launches and device time are
    # the loop's and a few fills and reads around it; its wall clock is the
    # loop's (results.runtime).  The profiler's own cost lands on that wall
    # clock, so the busy share is a lower bound.
    local, data, _, _, _ = TC._sharded_ls_setup(D, s, tcfg, None, W, dev)
    data["lam"] = torch.as_tensor(lam, dtype=D.dtype, device=dev)
    rp, launches, dev_ms = cuda_kernels(lambda: TP.consensus_admm(
        local, TC._lasso_global_prox, data, n, tcfg, nshards=W, device=dev))
    check(rp.steps == Z17_TIMED_STEPS and 0.0 < dev_ms < rp.runtime * 1e3,
          "(z17a) profiled run: every step ran, device time positive and below its wall time")
    step_ms, pstep_ms = (r.runtime * 1e3 / r.steps for r in (rt, rp))
    nbytes = W * n * n * 4
    bnd = bound(nbytes, 2 * W * n * n)
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    share = ("l2-resident; % n/a" if bnd[1] == "bytes" and nbytes <= l2
             else f"{100 * bnd[0] / step_ms:.1f}% of it")
    print(f"  (z17a) timed: {rt.steps / rt.runtime:.1f} iter/s ({step_ms * 1e3:.2f} us/step); "
          f"profiled run: {pstep_ms * 1e3:.2f} us/step wall, {launches / rp.steps:.2f} CUDA "
          f"launches/step, device kernel time {dev_ms / rp.steps * 1e3:.2f} us/step, busy "
          f"share {dev_ms / (rp.runtime * 1e3):.3f}; bound {bnd[0] * 1e3:.2f} us/step "
          f"({bnd[1]}, {nbytes / 1e6:.1f} MB against the {l2 / 1e6:.1f} MB L2), {share}")
    z17a.update(ips=rt.steps / rt.runtime, launches=launches / rp.steps,
                dev_us=dev_ms / rp.steps * 1e3)
    del D, s, data

    # (z17b) the other runners at matrix.py's widths, f32, against oracles.
    oracle = ADMMConfig(**Z17_ORACLE)
    rng = np.random.default_rng(10)
    f32c = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    ms, ns = 4096, 512
    Dn = rng.standard_normal((ms, ns))
    ell = np.sign(Dn @ rng.standard_normal(ns) + 0.1 * rng.standard_normal(ms))
    Dd, elld = f32c(Dn), f32c(ell)
    D64, e64 = Dn.astype(np.float32).astype(np.float64), ell
    sh = mp("z17b linearsvm_sharded", lambda: TP.linearsvm_sharded(
        Dd, elld, 1.0, oracle, nshards=8))
    se = linearsvm(Dd, elld, 1.0, oracle)
    fs, fe = (family_objective("hinge", D64, e64, r.xopt) for r in (sh, se))
    print(f"  (z17b) linearsvm_sharded {ms}x{ns}: steps {sh.steps} (serial {se.steps}), "
          f"objective {fs:.9g} (serial {fe:.9g}), rel. {abs(fs - fe) / abs(fe):.3e} (bar 1e-3)")
    check(abs(fs - fe) <= 1e-3 * abs(fe), "(z17b) sharded SVM within 1e-3 of the serial one")

    Ax = rng.standard_normal((8, 512, 256)).astype(np.float32)
    bx = rng.standard_normal((8, 512)).astype(np.float32)
    Ginv = np.stack([np.linalg.inv(A.T @ A) for A in Ax.astype(np.float64)])
    Atb = np.einsum("wmi,wm->wi", Ax.astype(np.float64), bx.astype(np.float64))
    nu = np.linalg.solve(Ginv.sum(0), np.einsum("wij,wj->i", Ginv, Atb))
    xeq = np.einsum("wij,wj->wi", Ginv, Atb - nu[None, :])
    ex = mp("z17b exchange_quadratic", lambda: TP.exchange_quadratic(
        f32c(Ax), f32c(bx), oracle))
    err = np.linalg.norm(ex.xopt.double().cpu().numpy() - xeq) / np.linalg.norm(xeq)
    print(f"  (z17b) exchange W=8 512x256: steps {ex.steps}, against the f64 equilibrium "
          f"{err:.3e} (bar 1e-3)")
    check(err <= 1e-3, "(z17b) exchange within 1e-3 of the market equilibrium")

    C, A, b, *_ = random_sdp_instance(128, 512, 32, rng, dtype=np.float32)
    ssd = mp("z17b sdp_sharded", lambda: TP.sdp_sharded(
        f32c(C), f32c(A), f32c(b), oracle, nshards=8), eigh=True)
    sse = sdp(f32c(C), f32c(A), f32c(b), oracle)
    C64 = C.astype(np.float64)
    os_, oe = (float(np.sum(C64 * r.zopt.double().cpu().numpy())) for r in (ssd, sse))
    gap = abs(os_ - oe) / max(1.0, abs(oe))
    print(f"  (z17b) sdp_sharded n=128 m=512: steps {ssd.steps} (serial {sse.steps}), objective "
          f"{os_:.9g} (serial {oe:.9g}), gap {gap:.3e} (bar 1e-3)")
    check(gap <= 1e-3, "(z17b) sharded SDP within 1e-3 of the serial one")

    Dcv = rng.standard_normal((4096, 256)).astype(np.float32)
    Dc64 = Dcv.astype(np.float64)
    S64 = np.cov(Dc64, rowvar=False)
    ref = covarianceselection(f32c(Dcv), 0.1, oracle)
    fref = _covsel_objective(S64, 0.1, ref)
    for pm in ("eigh", "ns"):
        rc = mp(f"z17b consensus_covsel {pm}", lambda: TP.consensus_covsel(
            f32c(Dcv), 0.1, oracle, nshards=8, prox_method=pm), eigh=pm == "eigh")
        fc = _covsel_objective(S64, 0.1, rc)
        print(f"  (z17b) consensus_covsel {pm} p=256: steps {rc.steps} (serial eigh "
              f"{ref.steps}), objective {fc:.9g} (serial {fref:.9g}), rel. "
              f"{abs(fc - fref) / abs(fref):.3e} (bar 1e-3)")
        check(abs(fc - fref) <= 1e-3 * abs(fref),
              f"(z17b) consensus covsel {pm} within 1e-3 of the serial one")

    Dl = rng.standard_normal((4096, 256)).astype(np.float32)
    el = np.sign(Dl @ rng.standard_normal(256) + 0.1 * rng.standard_normal(4096))
    Dl64 = Dl.astype(np.float64)

    def fl(z):
        z = z.double().cpu().numpy()
        return float(np.sum(np.logaddexp(0.0, -el * (Dl64 @ z))) + 0.1 * np.sum(np.abs(z)))

    cl = mp("z17b consensus_logreg", lambda: TP.consensus_logreg(
        f32c(Dl), f32c(el), 0.1, oracle, nshards=8))
    sl = logreg(f32c(Dl), f32c(el), 0.1, oracle)
    print(f"  (z17b) consensus_logreg 4096x256: steps {cl.steps} (serial {sl.steps}), objective "
          f"{fl(cl.zopt):.9g} (serial {fl(sl.zopt):.9g})")
    check(abs(fl(cl.zopt) - fl(sl.zopt)) <= 5e-3 * abs(fl(sl.zopt)),
          "(z17b) consensus logreg within 5e-3 of the serial one")

    # The batch forms in f64: lanes equal to their single solves.
    f64c = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)  # noqa: E731
    s4 = rng.standard_normal(ms)
    S8 = np.stack([s4 + 0.01 * k for k in range(8)])
    cfg64 = ADMMConfig(maxiters=500)
    mesh11 = TP.make_mesh2d(1, 1, device=dev)
    lb = mp("z17b consensus_lasso_batch", lambda: TP.consensus_lasso_batch(
        f64c(Dn), f64c(S8), 0.1, cfg64, mesh=mesh11, nshards=8))
    X0 = rng.random((10, ns))
    Z0, U0 = rng.random((10, ms)), rng.random((10, ms))
    y10 = rng.integers(0, 10, size=ms)
    ells = np.stack([np.where(y10 == k, 1.0, -1.0) for k in range(10)])
    sb = mp("z17b svm_batch_sharded", lambda: TP.svm_batch_sharded(
        f64c(Dn), f64c(ells), 1.0, cfg64, mesh=mesh11, nshards=8, x0=X0, z0=Z0, u0=U0))
    Dcb = np.stack([Dcv[:1024, :64], Dcv[1024:2048, :64]]).astype(np.float64)
    cb = mp("z17b consensus_covsel_batch", lambda: TP.consensus_covsel_batch(
        f64c(Dcb), 0.1, cfg64, mesh=mesh11, nshards=8), eigh=True)
    for tag, out, solo, key in (
            ("consensus_lasso_batch", lb, lambda i: TP.consensus_lasso(
                f64c(Dn), f64c(S8[i]), 0.1, cfg64, nshards=8), "zopt"),
            ("svm_batch_sharded", sb, lambda i: TP.linearsvm_sharded(
                f64c(Dn), f64c(ells[i]), 1.0, cfg64, nshards=8, x0=X0[i], z0=Z0[i], u0=U0[i]),
             "xopt"),
            ("consensus_covsel_batch", cb, lambda i: TP.consensus_covsel(
                f64c(Dcb[i]), 0.1, cfg64, nshards=8), "zopt")):
        for i in (0, out.steps.numel() - 1):
            r = solo(i)
            e = rel(getattr(out, key)[i], getattr(r, key))
            print(f"  (z17b) {tag} lane {i}: steps {int(out.steps[i])} (single {r.steps}), "
                  f"{key} {e:.3e} (bar 1e-9)")
            check(int(out.steps[i]) == r.steps and e <= 1e-9,
                  f"(z17b) {tag} lane {i} equal to its single solve in f64")

    # A sliced admm(parallel='both') against the unsliced solve, f64.
    nm = 2048
    P, Q = rng.standard_normal((nm, nm)), rng.standard_normal((nm, nm))
    r_, q_ = rng.standard_normal(nm), rng.standard_normal(nm)
    PtPinv, QtQinv = (f64c(np.linalg.inv(M.T @ M + np.eye(nm))) for M in (P, Q))
    Ptr, Qts = f64c(P.T @ r_), f64c(Q.T @ q_)
    L = nm // 8
    pf = lambda x, z, u, rho: PtPinv @ (Ptr + rho * (z - u))  # noqa: E731
    pg = lambda x, z, u, rho: QtQinv @ (Qts + rho * (x + u))  # noqa: E731
    pfs = lambda x, z, u, rho, k: PtPinv[k * L:(k + 1) * L] @ (Ptr + rho * (z - u))  # noqa: E731
    pgs = lambda x, z, u, rho, k: QtQinv[k * L:(k + 1) * L] @ (Qts + rho * (x + u))  # noqa: E731
    kw = dict(A=1.0, B=-1.0, c=0.0, m=nm, dtype=torch.float64, device=dev)
    cfg_m = ADMMConfig(maxiters=1000)
    sliced = mp("z17b sliced both", lambda: admm(
        pfs, pgs, cfg_m, parallel="both", slices=(0, 0), mesh=TP.make_mesh(8, device=dev), **kw))
    whole = admm(pf, pg, cfg_m, **kw)
    e = rel(sliced.xopt, whole.xopt)
    print(f"  (z17b) sliced admm(parallel='both') n={nm}: steps {sliced.steps} (unsliced "
          f"{whole.steps}), xopt {e:.3e} (bar 1e-9)")
    check(sliced.steps == whole.steps and e <= 1e-9,
          "(z17b) the sliced solve equals the unsliced one in f64")

    print(f"  (z17) kernel launches over the phase's main-path runs {total}; "
          f"{time.perf_counter() - t0:.1f}s")
    check(not any(total.values()), "(z17) no K1-K4 launch on the phase's main paths")
    return total, z17a


def z18b_runs(dev, mesh8, mesh2d, dtype=None, reverse=False):
    """(z18b)'s runners at matrix.py's widths on ``mesh8`` (8 shards:
    stacked, or over a process group) and ``mesh2d`` (2 lanes x 4 shards),
    on data from fixed seeds, in ``dtype`` (default float64): {name:
    {"steps", "x", "obj", "hist", "ips", "calls"}}, "obj" the runner's
    objective (the SVM's hinge objective, the exchange agents' total cost,
    the SDP's <C, Z>, the sliced solve's |x|, the first and last lanes'
    |Z|, the implicit solver's gradient, in f64 only), "hist" its pnorm
    trace (or the lanes' steps), "calls" the collectives a step issued.
    ``reverse``: only the runners that sum over the shard axis (the SVM,
    the exchange, the SDP), on the same data with its 8 shard blocks in
    reverse order, the same problem with the shard sums in another order."""
    import torch

    import admm_tpu_torch.parallel as TP
    from admm_tpu_torch import ADMMConfig, admm, make_implicit_consensus_solver
    from admm_tpu_torch.models.sdp import random_sdp_instance
    from admm_tpu_torch.parallel import consensus as TC
    from admm_tpu_torch.parallel.mesh import pad_rows, shard_rows

    dtype = torch.float64 if dtype is None else dtype
    npdt = np.float64 if dtype == torch.float64 else np.float32
    oracle = ADMMConfig(**Z17_ORACLE)
    rng = np.random.default_rng(18)
    f64c = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)  # noqa: E731
    cast = lambda a: torch.as_tensor(np.asarray(a, npdt), device=dev)  # noqa: E731

    def blocks(a):
        a = np.asarray(a)
        return (np.ascontiguousarray(a.reshape(8, -1, *a.shape[1:])[::-1].reshape(a.shape))
                if reverse else a)

    out = {}

    def keep(name, r, x, obj, hist=None, mesh=mesh8):
        st = mesh.reset_stats()
        steps = r.steps.tolist() if torch.is_tensor(r.steps) else int(r.steps)
        nsteps = max(steps) if isinstance(steps, list) else steps
        out[name] = {"steps": steps, "x": x.double().cpu().numpy(), "obj": float(obj),
                     "hist": None if hist is None else hist.double().cpu().numpy(),
                     "ips": nsteps / r.runtime if r.runtime else 0.0,
                     "calls": {op: c / max(nsteps, 1) for op, c in st["calls"].items()}}

    ms, ns = 4096, 512
    Dn = rng.standard_normal((ms, ns))
    ell = np.sign(Dn @ rng.standard_normal(ns) + 0.1 * rng.standard_normal(ms))
    mesh8.reset_stats()
    r = TP.linearsvm_sharded(cast(blocks(Dn)), cast(blocks(ell)), 1.0, oracle, mesh=mesh8)
    keep("linearsvm_sharded", r, r.xopt, family_objective("hinge", Dn, ell, r.xopt),
         r.hist["pnorm"])

    Ax = rng.standard_normal((8, 512, 256))
    bx = rng.standard_normal((8, 512))
    xcfg = (oracle if dtype == torch.float64
            else ADMMConfig(**dict(Z17_ORACLE, maxiters=Z18B_F32_EXCHANGE_STEPS)))
    r = TP.exchange_quadratic(cast(blocks(Ax)), cast(blocks(bx)), xcfg, mesh=mesh8)
    keep("exchange_quadratic", r, r.xopt,
         exchange_cost(blocks(Ax), blocks(bx), r.xopt.double().cpu().numpy()), r.hist["pnorm"])

    C, A, b, *_ = random_sdp_instance(128, 512, 32, rng, dtype=np.float32)
    r = TP.sdp_sharded(cast(C), cast(blocks(A)), cast(blocks(b)), oracle, mesh=mesh8)
    keep("sdp_sharded", r, r.zopt, float(np.sum(C.astype(np.float64)
                                                 * r.zopt.double().cpu().numpy())),
         r.hist["pnorm"])

    nm = 2048
    P, Q = rng.standard_normal((nm, nm)), rng.standard_normal((nm, nm))
    r_, q_ = rng.standard_normal(nm), rng.standard_normal(nm)
    if not reverse:
        # The inverses and products on the card, in f64: NumPy's LAPACK
        # rounds an inverse differently with another thread count, so the
        # host's would hand the ranks (one thread each) other inputs than
        # this process (z19's witness).
        eye = torch.eye(nm, dtype=torch.float64, device=dev)
        PtPinv, QtQinv = (torch.linalg.inv(f64c(M).T @ f64c(M) + eye).to(dtype)
                          for M in (P, Q))
        Ptr, Qts = ((f64c(M).T @ f64c(v)).to(dtype) for M, v in ((P, r_), (Q, q_)))
        L = nm // 8

        def pfs(x, z, u, rho, k):
            return PtPinv[k * L:(k + 1) * L] @ (Ptr + rho * (z - u))

        def pgs(x, z, u, rho, k):
            return QtQinv[k * L:(k + 1) * L] @ (Qts + rho * (x + u))

        r = admm(pfs, pgs, ADMMConfig(maxiters=1000), A=1.0, B=-1.0, c=0.0, m=nm,
                 dtype=dtype, device=dev, parallel="both", slices=(0, 0), mesh=mesh8)
        keep("sliced_both", r, r.xopt, float(torch.linalg.norm(r.xopt.double())),
             r.hist["pnorm"])

    S8 = np.stack([rng.standard_normal(ms) + 0.01 * k for k in range(8)])
    if not reverse:
        r = TP.consensus_lasso_batch(cast(Dn), cast(S8), 0.1, ADMMConfig(maxiters=500),
                                     mesh=mesh2d, nshards=8)
        keep("consensus_lasso_batch", r, r.zopt,
             float(torch.linalg.norm(r.zopt[[0, 7]].double())), r.steps, mesh=mesh2d)
    if reverse or dtype != torch.float64:
        return out

    Dg = rng.standard_normal((8 * 512, 64))
    sg = Dg @ (rng.standard_normal(64) * (rng.random(64) < 0.5)) + 0.1 * rng.standard_normal(
        8 * 512)
    setup = TC.ls_setup(mesh8.take(shard_rows(pad_rows(f64c(Dg), 8)[0], 8)),
                        mesh8.take(shard_rows(pad_rows(f64c(sg), 8)[0], 8)), False,
                        IMPLICIT_RHO)
    solve = make_implicit_consensus_solver(
        TC._lasso_local_prox, TC._lasso_global_prox,
        ADMMConfig(rho=IMPLICIT_RHO, maxiters=4000, abstol=1e-10, reltol=1e-10), 64, 8,
        mesh=mesh8, vjp_maxiters=Z18B_ADJOINT_STEPS)
    lam = torch.tensor(0.3, dtype=torch.float64, device=dev)
    t0 = time.perf_counter()
    g = torch.func.grad(lambda lm: torch.sum(solve(dict(setup, lam=lm))[1] ** 2))(lam)
    torch.cuda.synchronize()
    st = mesh8.reset_stats()
    adj = solve.stats["steps"][0]
    out["implicit_consensus"] = {"steps": adj, "x": g.double().cpu().numpy().reshape(1),
                                 "obj": float(g), "hist": None,
                                 "ips": adj / (time.perf_counter() - t0),
                                 "calls": {op: c / adj for op, c in st["calls"].items()}}
    return out


# (z18b)'s work on each of two gloo ranks on the one card, run by
# ``multihost.run_ranks`` (``mesh`` the global mesh, ``rank``, ``save``).
Z18B_WORKER = """
import time
import torch.distributed as dist
import chip_smoke as C
import admm_tpu_torch.parallel as TP
from admm_tpu_torch import ADMMConfig
from admm_tpu_torch.benchmarks.scaling import collective_microbench
dev = mesh.device
say = lambda msg: print(f"  (z18b) [rank {rank}] {msg}", flush=True)
say(f"joined: gloo, {mesh.world} ranks, device {dev}")
x = torch.ones(4, device=dev)
dist.all_reduce(x)
try:
    parts = [torch.empty(4, device=dev) for _ in range(2)]
    dist.all_gather(parts, x)
    took = "takes"
except RuntimeError as e:
    took = "refuses (" + str(e).splitlines()[0][:120] + ")"
say(f"gloo all_reduce takes CUDA tensors; all_gather {took}")
C.reset_counts()
g8 = TP.make_mesh(8, group=mesh.group)
D, s, lam = C.z17_problem(dev)
r = TP.consensus_lasso(D, s, lam, ADMMConfig(maxiters=5000), mesh=g8)
torch.cuda.synchronize()
st = g8.reset_stats()
res = {"cons.steps": r.steps, "cons.zopt": r.zopt, "cons.pnorm": r.hist["pnorm"],
       "cons.dnorm": r.hist["dnorm"]}
say(f"consensus_lasso 8x65536x1024 f32, 4 shards a rank: steps {r.steps}, "
    f"{r.steps / r.runtime:.1f} iter/s, collectives a step "
    f"{ {k: v / r.steps for k, v in st['calls'].items()} }")
tcfg = ADMMConfig(maxiters=C.Z18_TIMED_STEPS, domaxiters=True, unroll="auto")
rt = TP.consensus_lasso(D, s, lam, tcfg, mesh=g8)
st = g8.reset_stats()
res["cons.ips"] = rt.steps / rt.runtime
say(f"timed {rt.steps} steps: {rt.steps / rt.runtime:.1f} iter/s, "
    f"{st['calls']['all_reduce'] / rt.steps:.2f} all_reduce a step")
del D, s
for row in collective_microbench(mesh=mesh, cols=C.Z17_N, quiet=True):
    say(f"gloo all_reduce of {row['payload_floats']} floats from the card: "
        f"{row['us_per_collective']:.1f} us")
    res[f"coll.{row['payload_floats']}"] = row["us_per_collective"]
m2d = TP.make_mesh2d(2, 4, group=mesh.group)
for tag, dtype in (("", torch.float64), ("f32:", torch.float32)):
    for name, v in C.z18b_runs(dev, g8, m2d, dtype=dtype).items():
        say(f"{tag}{name}: steps {v['steps']}, objective {v['obj']:.9g}, "
            f"{v['ips']:.1f} steps/s, collectives a step {v['calls']}")
        res[tag + name + ".steps"] = np.asarray(v["steps"])
        res[tag + name + ".x"] = v["x"]
        res[tag + name + ".obj"] = v["obj"]
        res[tag + name + ".ips"] = v["ips"]
        if v["hist"] is not None:
            res[tag + name + ".hist"] = v["hist"]
counts = C.read_counts()
say(f"kernel launches {counts}")
res["launches"] = np.array([counts[k] for k in sorted(counts)])
save(**res)
"""


def exchange_cost(Ax, bx, x):
    """The exchange agents' total cost sum_i 0.5 ||A_i x_i - b_i||^2 in f64."""
    r = np.einsum("wmi,wi->wm", Ax.astype(np.float64), x) - bx.astype(np.float64)
    return float(0.5 * np.sum(r * r))


def exchange_equilibrium(Ax, bx):
    """The quadratic agents' closed-form market equilibrium in f64."""
    A64, b64 = Ax.astype(np.float64), bx.astype(np.float64)
    Ginv = np.stack([np.linalg.inv(A.T @ A) for A in A64])
    Atb = np.einsum("wmi,wm->wi", A64, b64)
    nu = np.linalg.solve(Ginv.sum(0), np.einsum("wij,wj->i", Ginv, Atb))
    return np.einsum("wij,wj->wi", Ginv, Atb - nu[None, :])


# (z18c)'s work on each of two NCCL ranks, a card each.
Z18C_WORKER = """
import chip_smoke as C
import admm_tpu_torch.parallel as TP
from admm_tpu_torch import ADMMConfig
g8 = TP.make_mesh(8, group=mesh.group)
D, s, lam = C.z17_problem(torch.device("cuda", 0))
D, s = D.to(mesh.device), s.to(mesh.device)
r = TP.consensus_lasso(D, s, lam, ADMMConfig(maxiters=5000), mesh=g8)
st = g8.reset_stats()
print(f"  (z18c) [rank {rank}] NCCL on {mesh.device}: steps {r.steps}, "
      f"{r.steps / r.runtime:.1f} iter/s, collectives {st['calls']}", flush=True)
save(steps=r.steps, zopt=r.zopt, pnorm=r.hist["pnorm"])
"""


def _two_ranks(tag, code, backend):
    """Run ``code`` on two ranks of a ``backend`` group (``multihost.run_ranks``),
    print their output, and return each rank's saved arrays; fails unless
    both ran to their end within Z18B_TIMEOUT_S."""
    import tempfile

    from admm_tpu_torch.parallel import multihost

    with tempfile.TemporaryDirectory() as tmp:
        rc, outputs, arrays = multihost.run_ranks(
            code, 2, tmp, Z18B_TIMEOUT_S, join=dict(backend=backend, timeout=300))
    for text in outputs:
        print(text.replace(multihost.SENTINEL + "\n", "").rstrip())
    check(rc == 0, f"({tag}) both {backend} ranks ran to their end")
    return arrays


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def slice10b_phase(dev, z17a):
    """Slice 10b, (z18a)-(z18d): the shard axis over processes; returns
    every kernel's launches over the phase's main paths (all 0)."""
    import tempfile

    import torch

    import admm_tpu_torch.parallel as TP
    from admm_tpu_torch import ADMMConfig
    from admm_tpu_torch.benchmarks.scaling import collective_microbench
    from admm_tpu_torch.parallel import consensus as TC
    from admm_tpu_torch.parallel import multihost

    t0 = time.perf_counter()
    total = dict.fromkeys(kernel_counts(), 0)
    mp = functools.partial(main_path, tally=total)
    W, n = Z17_W, Z17_N
    r32 = z17a["r32"]
    print(f"slice 10b: the shard axis over processes ({W} shards of {Z17_ROWS} x {n} f32)")

    # (z18a) a world-1 NCCL group in this process, at (z17a)'s width.
    D, s, lam = z17_problem(dev)
    with tempfile.TemporaryDirectory() as tmp:
        count = multihost.initialize_cluster(f"file://{tmp}/pg", 1, 0, backend="nccl",
                                             timeout=300)
        try:
            mesh = TP.make_mesh(W, group=TP.global_mesh().group)
            check(count == 1 and mesh.device.type == "cuda" and mesh.world == 1,
                  "(z18a) a one-rank NCCL group on the card")
            r = mp("z18a", lambda: TP.consensus_lasso(D, s, lam, ADMMConfig(maxiters=5000),
                                                      mesh=mesh))
            st = mesh.reset_stats()
            same = (r.steps == r32.steps and all(torch.equal(getattr(r, f), getattr(r32, f))
                                                 for f in ("xopt", "zopt", "uopt"))
                    and torch.equal(r.extra["xi"], r32.extra["xi"])
                    and torch.equal(r.extra["ui"], r32.extra["ui"])
                    and set(r.hist) == set(r32.hist)
                    and all(_same_bits(r.hist[k].cpu().numpy(), v.cpu().numpy())
                            for k, v in r32.hist.items()))
            print(f"  (z18a) world-1 NCCL: steps {r.steps} ((z17a) {r32.steps}); steps, x, z, "
                  f"u, xi, ui and every history {'equal' if same else 'DIFFER from'} (z17a)'s "
                  f"bit for bit; NCCL collectives {st['calls']} ({st['calls'].get('all_reduce', 0) / r.steps:.0f} all_reduce a step, "
                  f"{st['bytes'].get('all_reduce', 0) / r.steps:.0f} bytes a step)")
            check(same, "(z18a) the world-1 NCCL run equals (z17a)'s stacked run bit for bit")
            check(st["calls"] == {"all_reduce": 2 * r.steps, "all_gather": 1}
                  and st["bytes"]["all_reduce"] == r.steps * (2 * n + 1) * 4,
                  "(z18a) 2 all_reduce a step, 2n + 1 floats, one all_gather at the end")
            tcfg = ADMMConfig(maxiters=Z18_TIMED_STEPS, domaxiters=True, unroll="auto")
            rt = mp("z18a timed", lambda: TP.consensus_lasso(D, s, lam, tcfg, mesh=mesh))
            mesh.reset_stats()
            local, data, _, _, _ = TC._sharded_ls_setup(D, s, tcfg, mesh, W, dev)
            data["lam"] = torch.as_tensor(lam, dtype=D.dtype, device=dev)
            rp, launches, dev_ms = cuda_kernels(lambda: TP.consensus_admm(
                local, TC._lasso_global_prox, data, n, tcfg, mesh=mesh, nshards=W))
            st = mesh.reset_stats()
            check(rp.steps == Z18_TIMED_STEPS and 0.0 < dev_ms < rp.runtime * 1e3,
                  "(z18a) profiled run: every step ran, device time positive, below the wall")
            print(f"  (z18a) timed {rt.steps} steps: {rt.steps / rt.runtime:.1f} iter/s "
                  f"((z17a) stacked {z17a['ips']:.1f}); profiled: {launches / rp.steps:.2f} "
                  f"CUDA launches a step ((z17a) {z17a['launches']:.2f}), device "
                  f"{dev_ms / rp.steps * 1e3:.2f} us a step ((z17a) {z17a['dev_us']:.2f}), "
                  f"busy share {dev_ms / (rp.runtime * 1e3):.3f}; "
                  f"{st['calls']['all_reduce'] / rp.steps:.2f} NCCL all_reduce a step "
                  f"(counted in the tests: 2)")
            del data, local
            for row in collective_microbench(mesh=mesh, cols=n, quiet=True):
                print(f"  (z18a) NCCL (1 rank) all_reduce of {row['payload_floats']} floats: "
                      f"{row['us_per_collective']:.2f} us (host clock, {row['ranks']} rank)")
        finally:
            multihost.shutdown()
    del D, s

    # (z18b) two gloo ranks sharing the card, against the stacked runs.
    stacked8, stacked2d = TP.make_mesh(W, device=dev), TP.make_mesh2d(2, 4, device=dev)
    ref = z18b_runs(dev, stacked8, stacked2d)
    ref32 = z18b_runs(dev, stacked8, stacked2d, dtype=torch.float32)
    rev32 = z18b_runs(dev, stacked8, stacked2d, dtype=torch.float32, reverse=True)
    serial = z18b_serial(dev)
    r0, r1 = _two_ranks("z18b", Z18B_WORKER, "gloo")
    for key in r0:
        if not key.endswith(".ips") and not key.startswith("coll."):
            check(_same_bits(r0[key], r1[key]), f"(z18b) rank 0 and rank 1 hold the same {key}")
    check(not r0["launches"].any() and not r1["launches"].any(),
          "(z18b) no K1-K4 launch on either rank")
    cons_steps = int(r0["cons.steps"])
    zs = r0["cons.zopt"].astype(np.float64)
    D64, s64 = (t.double() for t in z17_problem(dev)[:2])
    fz = float(0.5 * torch.sum((D64 @ torch.as_tensor(zs, device=dev) - s64) ** 2)
               + lam * np.sum(np.abs(zs)))
    f_stacked = float(0.5 * torch.sum((D64 @ r32.zopt.double() - s64) ** 2)
                      + lam * torch.sum(torch.abs(r32.zopt.double())))
    del D64, s64
    print(f"  (z18b) consensus_lasso: steps {cons_steps} on both ranks (stacked {r32.steps}), "
          f"objective {fz:.9g} (stacked {f_stacked:.9g}, rel. {abs(fz - f_stacked) / abs(f_stacked):.3e}, "
          f"bar 1e-5; serial f64 {z17a['fser']:.9g}, rel. "
          f"{abs(fz - z17a['fser']) / abs(z17a['fser']):.3e}, bar 1e-2); timed "
          f"{float(r0['cons.ips']):.1f} / {float(r1['cons.ips']):.1f} iter/s")
    _steps_apart("z18b consensus_lasso", cons_steps, r32.steps, r0["cons.pnorm"],
                 r32.hist["pnorm"].cpu().numpy())
    check(abs(fz - f_stacked) <= 1e-5 * abs(f_stacked)
          and abs(fz - z17a["fser"]) <= 1e-2 * abs(z17a["fser"]),
          "(z18b) consensus_lasso within 1e-5 of the stacked run and 1e-2 of serial f64")
    for name, bar in Z18B_BARS.items():
        got, want, ser = float(r0[name + ".obj"]), ref[name]["obj"], serial[name]
        steps = r0[name + ".steps"]
        print(f"  (z18b) {name}: steps {steps.tolist()} on both ranks (stacked "
              f"{ref[name]['steps']}), objective {got:.9g} (stacked {want:.9g}, rel. "
              f"{abs(got - want) / max(abs(want), 1e-30):.3e}, bar 1e-5; serial f64 "
              f"{ser:.9g}, bar {bar}); {float(r0[name + '.ips']):.1f} / "
              f"{float(r1[name + '.ips']):.1f} steps/s (stacked {ref[name]['ips']:.1f})")
        if name == "implicit_consensus":
            pass  # its adjoint steps are printed; the gradient is held
        elif name != "consensus_lasso_batch":
            _steps_apart(f"z18b {name}", int(steps), ref[name]["steps"], r0[name + ".hist"],
                         ref[name]["hist"])
        else:
            check(steps.tolist() == (ref[name]["steps"] if isinstance(ref[name]["steps"], list)
                                     else [ref[name]["steps"]] * steps.size
                                     if steps.ndim else ref[name]["steps"]),
                  f"(z18b) {name}: the stacked run's steps")
        check(abs(got - want) <= 1e-5 * max(abs(want), 1e-30),
              f"(z18b) {name} within 1e-5 of the stacked run")
        check(_within(name, got, ser, bar), f"(z18b) {name} within {bar} of serial f64")
    # In f32 the order of a shard sum alone moves a stop: the ranks' runs
    # are held to serial f64, and printed beside the stacked f32 run and
    # beside the stacked f32 run with its shard blocks reversed.
    for name in Z18B_F32_RUNNERS:
        got, want, ser = float(r0["f32:" + name + ".obj"]), ref32[name]["obj"], serial[name]
        rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)  # noqa: E731
        rev = rev32.get(name)
        witness = ("no shard sum to reorder" if rev is None else
                   f"reversed shard blocks: steps {rev['steps']}, objective {rev['obj']:.9g}, "
                   f"rel. {rel(rev['obj'], want):.3e}")
        print(f"  (z18b) f32 {name}: steps {r0['f32:' + name + '.steps'].tolist()} on both "
              f"ranks (stacked f32 {ref32[name]['steps']}), objective {got:.9g} (stacked f32 "
              f"{want:.9g}, rel. {rel(got, want):.3e}; {witness}); serial f64 {ser:.9g}, bar "
              f"{Z18B_F32_BAR}; {float(r0['f32:' + name + '.ips']):.1f} / "
              f"{float(r1['f32:' + name + '.ips']):.1f} steps/s (stacked {ref32[name]['ips']:.1f})")
        check(_within(name, got, ser, Z18B_F32_BAR),
              f"(z18b) f32 {name} within {Z18B_F32_BAR} of serial f64")
    # The sliced solve's inputs are made on the card, the same bits in
    # every process, and its prox gathers whole blocks: over the ranks it
    # is the stacked run bit for bit, in f64 and in f32 (with inverses
    # taken by the host's LAPACK the f32 run was 1.8e-6 away: (z19e)).
    for tag, refs in (("", ref), ("f32:", ref32)):
        same = _same_bits(r0[tag + "sliced_both.x"], refs["sliced_both"]["x"])
        print(f"  (z18b) {tag or 'f64:'} sliced_both over the ranks "
              f"{'equals' if same else 'DIFFERS from'} the stacked run bit for bit")
        check(same, f"(z18b) {tag or 'f64:'} sliced_both equals the stacked run bit for bit")

    # (z18c) two NCCL ranks, a card each.
    cards = torch.cuda.device_count()
    if cards >= 2:
        ranks = _two_ranks("z18c", Z18C_WORKER, "nccl")
        check(_same_bits(ranks[0]["zopt"], ranks[1]["zopt"])
              and int(ranks[0]["steps"]) == int(ranks[1]["steps"]),
              "(z18c) both NCCL ranks hold the same steps and solution")
        _steps_apart("z18c", int(ranks[0]["steps"]), r32.steps, ranks[0]["pnorm"],
                     r32.hist["pnorm"].cpu().numpy())
    else:
        print(f"  (z18c) did not run: two NCCL ranks need a card each and this machine has "
              f"{cards} CUDA device; NCCL refuses two ranks on one card")

    # (z18d) the CLI's scaling: the stacked sweep and the cost model.
    for argv in (["scaling", "--devices", "8", "--iters", "50"], ["scaling", "--predict"]):
        run = subprocess.run([sys.executable, "-m", "admm_tpu_torch", *argv], cwd=ROOT,
                             capture_output=True, text=True, timeout=600)
        for line in run.stdout.splitlines():
            print(f"  (z18d) {line}")
        check(run.returncode == 0, f"(z18d) python -m admm_tpu_torch {' '.join(argv)} exit 0 "
              f"({run.stderr[-2000:]})")

    print(f"  (z18) kernel launches over the phase's main paths {total} (the gloo ranks' "
          f"checked 0 each); {time.perf_counter() - t0:.1f}s")
    check(not any(total.values()), "(z18) no K1-K4 launch on the phase's main paths")
    return total


def _steps_apart(tag, steps, ref_steps, hist, ref_hist):
    """Hold a run's steps to the stacked run's, or one apart with the
    deciding step's pnorm printed."""
    if steps != ref_steps:
        k = min(steps, ref_steps) - 1
        print(f"  ({tag}) steps {steps} against the stacked {ref_steps}: pnorm at step "
              f"{k + 1} {float(hist[k]):.9e} (stacked {float(ref_hist[k]):.9e})")
    check(abs(steps - ref_steps) <= 1, f"({tag}) the stacked run's steps, or one apart")


def _within(name, got, ser, bar):
    if name == "implicit_consensus":       # no serial twin: the stacked gradient
        return True
    if name in ("sliced_both", "consensus_lasso_batch"):
        return abs(got - ser) <= bar * abs(ser)
    return abs(got - ser) <= bar * max(1.0, abs(ser))


def z18b_serial(dev):
    """The serial f64 references of (z18b)'s runners, on the same draws as
    ``z18b_runs``: the serial SVM's hinge objective, the agents' cost at
    the f64 equilibrium, the serial SDP's <C, Z>, the unsliced
    solve's |x|, the first and last lanes' single solves' |Z|, and 0 for
    the gradient (held against the stacked run only)."""
    import torch

    import admm_tpu_torch.parallel as TP
    from admm_tpu_torch import ADMMConfig, admm, linearsvm, sdp
    from admm_tpu_torch.models.sdp import random_sdp_instance

    oracle = ADMMConfig(**Z17_ORACLE)
    rng = np.random.default_rng(18)
    f64c = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)  # noqa: E731
    ms, ns = 4096, 512
    Dn = rng.standard_normal((ms, ns))
    ell = np.sign(Dn @ rng.standard_normal(ns) + 0.1 * rng.standard_normal(ms))
    se = linearsvm(f64c(Dn), f64c(ell), 1.0, oracle)
    out = {"linearsvm_sharded": family_objective("hinge", Dn, ell, se.xopt)}
    Ax = rng.standard_normal((8, 512, 256))
    bx = rng.standard_normal((8, 512))
    out["exchange_quadratic"] = exchange_cost(Ax, bx, exchange_equilibrium(Ax, bx))
    C, A, b, *_ = random_sdp_instance(128, 512, 32, rng, dtype=np.float32)
    r = sdp(*(f64c(v) for v in (C, A, b)), oracle)
    out["sdp_sharded"] = float(np.sum(C.astype(np.float64) * r.zopt.cpu().numpy()))
    nm = 2048
    P, Q = rng.standard_normal((nm, nm)), rng.standard_normal((nm, nm))
    r_, q_ = rng.standard_normal(nm), rng.standard_normal(nm)
    PtPinv, QtQinv = (f64c(np.linalg.inv(M.T @ M + np.eye(nm))) for M in (P, Q))
    Ptr, Qts = f64c(P.T @ r_), f64c(Q.T @ q_)
    w = admm(lambda x, z, u, rho: PtPinv @ (Ptr + rho * (z - u)),
             lambda x, z, u, rho: QtQinv @ (Qts + rho * (x + u)), ADMMConfig(maxiters=1000),
             A=1.0, B=-1.0, c=0.0, m=nm, dtype=torch.float64, device=dev)
    out["sliced_both"] = float(torch.linalg.norm(w.xopt))
    S8 = np.stack([rng.standard_normal(ms) + 0.01 * k for k in range(8)])
    lanes = [TP.consensus_lasso(f64c(Dn), f64c(S8[i]), 0.1, ADMMConfig(maxiters=500),
                                mesh=TP.make_mesh(8, device=dev)).zopt for i in (0, 7)]
    out["consensus_lasso_batch"] = float(torch.linalg.norm(torch.stack(lanes)))
    out["implicit_consensus"] = 0.0
    return out


def z19a_problem(dev):
    """(z19a)'s lanes: (z17a)'s D (8 x 65536 x 1024 f32, 2 GiB) shared, its
    signal in every lane, the lanes' lambdas Z19_LANES times (z17a)'s."""
    import torch

    D, s, lam = z17_problem(dev)
    S = s.expand(len(Z19_LANES), -1).contiguous()
    return D, S, torch.tensor([lam * f for f in Z19_LANES], device=dev)


def lane_objectives(D, S, lams, Z):
    """Each lane's 0.5 ||D z - s||^2 + lam ||z||_1, in f64 on the card."""
    import torch

    R = Z.double() @ D.double().T - S.double()
    return (0.5 * torch.sum(R * R, dim=1) + lams.double() * torch.sum(torch.abs(Z.double()),
                                                                      dim=1)).cpu().numpy()


def z19b_gradient(dev, mesh8, method):
    """(z19b): d sum(z*^2) / d lambda of (z18b)'s implicit consensus LASSO
    (8 shards of 512 x 64 in f64, rho IMPLICIT_RHO) over ``mesh8`` with
    ``vjp_method``;
    returns (gradient, the backward's cycles or steps, seconds, the
    collectives of the gradient's call)."""
    import torch

    from admm_tpu_torch import ADMMConfig, make_implicit_consensus_solver
    from admm_tpu_torch.parallel import consensus as TC
    from admm_tpu_torch.parallel.mesh import pad_rows, shard_rows

    rng = np.random.default_rng(18)
    Dg = rng.standard_normal((8 * 512, 64))
    sg = Dg @ (rng.standard_normal(64) * (rng.random(64) < 0.5)) + 0.1 * rng.standard_normal(
        8 * 512)
    f64c = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)  # noqa: E731
    setup = TC.ls_setup(mesh8.take(shard_rows(pad_rows(f64c(Dg), 8)[0], 8)),
                        mesh8.take(shard_rows(pad_rows(f64c(sg), 8)[0], 8)), False,
                        IMPLICIT_RHO)
    solve = make_implicit_consensus_solver(
        TC._lasso_local_prox, TC._lasso_global_prox,
        ADMMConfig(rho=IMPLICIT_RHO, maxiters=4000, abstol=1e-10, reltol=1e-10), 64, 8,
        mesh=mesh8, vjp_method=method, vjp_tol=Z19B_VJP_TOL, vjp_maxiters=Z19B_VJP_MAXITERS[method])
    lam = torch.tensor(0.3, dtype=torch.float64, device=dev)
    mesh8.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g = torch.func.grad(lambda lm: torch.sum(solve(dict(setup, lam=lm))[1] ** 2))(lam)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return float(g), solve.stats["steps"][0], secs, mesh8.reset_stats()["calls"]


def host_inverse():
    """(z19e)'s witness: NumPy's inverse of the sliced solve's P^T P + I
    ((z18b)'s order, its own seeded P), cast to f32 as (z18b) cast it."""
    rng = np.random.default_rng(18)
    P = rng.standard_normal((Z19E_N, Z19E_N))
    return np.linalg.inv(P.T @ P + np.eye(Z19E_N)).astype(np.float32)


# (z19a), (z19b) and (z19e)'s work on each of two gloo ranks on the card.
Z19_WORKER = """
import chip_smoke as C
import admm_tpu_torch.parallel as TP
from admm_tpu_torch import ADMMConfig
dev = mesh.device
say = lambda msg: print(f"  (z19) [rank {rank}] {msg}", flush=True)
C.reset_counts()
m18 = TP.make_mesh2d(1, 8, group=mesh.group)
D, S, lams = C.z19a_problem(dev)
r = TP.consensus_lasso_batch(D, S, lams, ADMMConfig(maxiters=5000), mesh=m18)
torch.cuda.synchronize()
st = m18.reset_stats()
res = {"a.steps": r.steps, "a.zopt": r.zopt, "a.calls": st["calls"]["all_reduce"],
       "a.gathers": st["calls"]["all_gather"]}
say(f"consensus_lasso_batch {S.shape[0]} lanes x 8 shards of 65536 x 1024 f32, a lane row "
    f"over {m18.span} ranks, 4 shards of every lane a rank: steps {r.steps.tolist()}, "
    f"collectives {st['calls']}")
tcfg = ADMMConfig(maxiters=C.Z19_TIMED_STEPS, domaxiters=True, unroll="auto")
rt = TP.consensus_lasso_batch(D, S, lams, tcfg, mesh=m18)
st = m18.reset_stats()
res["a.ips"] = C.Z19_TIMED_STEPS / rt.runtime
res["a.timed_calls"] = st["calls"]["all_reduce"]
say(f"timed {C.Z19_TIMED_STEPS} steps: {res['a.ips']:.1f} iter/s a rank "
    f"({res['a.ips'] * S.shape[0]:.1f} inst-iter/s), {st['calls']['all_reduce']} all_reduce")
del D, S, r, rt
g8 = TP.make_mesh(8, group=mesh.group)
cold = C.z19b_gradient(dev, g8, "gmres")[2]   # the rank's first linear-algebra calls
g, cycles, secs, calls = C.z19b_gradient(dev, g8, "gmres")
res.update({"b.g": g, "b.cycles": cycles, "b.secs": secs, "b.cold": cold,
            "b.calls": calls.get("all_reduce", 0)})
say(f"implicit consensus, GMRES over the ranks: d/dlam {g!r}, {cycles} restart cycles, "
    f"{secs:.3f}s (first call {cold:.3f}s), {calls}")
res["e.inv"] = C.host_inverse()
res["launches"] = np.array([v for _, v in sorted(C.read_counts().items())])
save(**res)
"""


def slice10c_phase(dev):
    """Slice 10c, (z19a)-(z19e): lanes x shards over ranks, GMRES over a
    group, vmap over the serial implicit solve, the packed cyclic
    reduction, and the witness of (z18b)'s sliced gap.  Returns every
    kernel's launches over the phase's main paths (K4's: (z19c)'s and
    (z19d)'s hybrid runs)."""
    import os

    import torch

    import admm_tpu_torch.parallel as TP
    from admm_tpu_torch import ADMMConfig, make_implicit_solver, totalvariation
    from admm_tpu_torch.benchmarks.timing import graph_ms
    from admm_tpu_torch.linop import DiffOp
    from admm_tpu_torch.models.totalvariation import make_prox_ops, tv_system
    from admm_tpu_torch.ops.tridiag import (CyclicReductionSolver, PackedCyclicReductionSolver,
                                            cr_solve)

    t0 = time.perf_counter()
    smi = nvidia_smi_line()
    total = dict.fromkeys(kernel_counts(), 0)
    mp = functools.partial(main_path, tally=total)
    print(f"slice 10c: lanes x shards over ranks, GMRES over a group, vmap over the implicit "
          f"solve, cr_packed ({smi})")

    # (z19a) the stacked 4 x 8 reference, then the two gloo ranks.
    D, S, lams = z19a_problem(dev)
    st_mesh = TP.make_mesh2d(1, 8, device=dev)
    ref = mp("z19a stacked", lambda: TP.consensus_lasso_batch(D, S, lams,
                                                               ADMMConfig(maxiters=5000),
                                                               mesh=st_mesh))
    tcfg = ADMMConfig(maxiters=Z19_TIMED_STEPS, domaxiters=True, unroll="auto")
    rt = TP.consensus_lasso_batch(D, S, lams, tcfg, mesh=st_mesh)
    ref_ips = Z19_TIMED_STEPS / rt.runtime
    f_ref = lane_objectives(D, S, lams, ref.zopt)
    # (z19b)'s stacked references: GMRES and Neumann.
    g8 = TP.make_mesh(8, device=dev)
    g_gm, c_gm, s_gm, _ = z19b_gradient(dev, g8, "gmres")
    g_ne, c_ne, s_ne, _ = z19b_gradient(dev, g8, "neumann")
    r0, r1 = _two_ranks("z19", Z19_WORKER, "gloo")
    for key in r0:
        if key not in ("a.ips", "b.secs", "b.cold"):
            check(_same_bits(r0[key], r1[key]), f"(z19) rank 0 and rank 1 hold the same {key}")
    check(not r0["launches"].any() and not r1["launches"].any(),
          "(z19) no K1-K4 launch on either rank")
    steps = r0["a.steps"].tolist()
    Z = torch.as_tensor(r0["a.zopt"], device=dev)
    f_got = lane_objectives(D, S, lams, Z)
    rel_f = np.abs(f_got - f_ref) / np.abs(f_ref)
    spread = float(torch.max(torch.abs(Z - ref.zopt)) / torch.max(torch.abs(ref.zopt)))
    nsub = max(steps)
    print(f"  (z19a) ranks: steps {steps} (stacked {ref.steps.tolist()}); objectives "
          f"rel. to the stacked run {', '.join(f'{v:.3e}' for v in rel_f)} (bar 1e-5); f32 "
          f"spread max|z - z_stacked| / max|z_stacked| {spread:.3e}; collectives "
          f"{int(r0['a.calls'])} all_reduce over {nsub} sub-steps "
          f"({int(r0['a.calls']) / nsub:.2f} a sub-step: 2 shard-axis reductions of all 4 "
          f"lanes, 1 chunk flag), {int(r0['a.gathers'])} all_gather; timed "
          f"{float(r0['a.ips']):.1f} / {float(r1['a.ips']):.1f} iter/s a rank, stacked "
          f"{ref_ips:.1f} iter/s ({smi})")
    check(steps == ref.steps.tolist(), "(z19a) each lane takes the stacked run's steps")
    check(bool(np.all(rel_f <= 1e-5)), "(z19a) each lane within 1e-5 of the stacked run")
    check(int(r0["a.gathers"]) == 1 and int(r0["a.calls"]) >= 2 * nsub,
          "(z19a) two shard-axis collectives a sub-step for all lanes, one all_gather")
    del D, S, ref, rt, Z

    g = float(r0["b.g"])
    e_gm, e_ne = abs(g - g_gm) / abs(g_gm), abs(g - g_ne) / abs(g_ne)
    print(f"  (z19b) implicit consensus f64, d/dlam over the ranks (GMRES, "
          f"{int(r0['b.cycles'])} cycles, {float(r0['b.secs']):.3f}s, the rank's first call "
          f"{float(r0['b.cold']):.3f}s, "
          f"{int(r0['b.calls'])} all_reduce) {g!r}; stacked GMRES {g_gm!r} ({c_gm} cycles, "
          f"{s_gm:.3f}s), rel. {e_gm:.3e} (bar 1e-10); stacked Neumann {g_ne!r} ({c_ne} "
          f"steps, {s_ne:.3f}s), rel. {e_ne:.3e} (bar 1e-5)")
    check(e_gm <= 1e-10, "(z19b) GMRES over the ranks within 1e-10 of the stacked GMRES")
    check(e_ne <= 1e-5, "(z19b) GMRES over the ranks within 1e-5 of Neumann")

    # (z19c) vmap(grad) over the serial TV implicit solve, n = 65536 f32.
    n = HG_N
    truth, sig = staircase_pair(n)
    cfg = ADMMConfig(maxiters=HG_MAXITERS, unroll="auto", **HG_STOP["float32"])
    pf, pg, _, data, _ = make_prox_ops(torch.from_numpy(sig).to(dev), TV_LAM, cfg, solver="cr")
    check(data["cr"].Tinv is not None, f"(z19c) n={n} 'cr' is the hybrid form")
    solve = make_implicit_solver(pf, pg, cfg, A=DiffOp(n), nA=n, nB=n,
                                 vjp_tol=HG_VJP_TOL["float32"], vjp_maxiters=HG_VJP_MAXITERS)
    t = torch.from_numpy(truth).to(dev)
    loss = lambda lam: torch.mean((solve(dict(data, lam=lam))[0] - t) ** 2)  # noqa: E731
    lam4 = torch.tensor(Z19C_LAMS, device=dev)
    torch.func.vmap(torch.func.grad(loss))(lam4)     # warm-up
    reset_counts()
    with torch.no_grad():
        torch.func.vmap(loss)(lam4)
    torch.cuda.synchronize()
    fwd = read_counts()
    reset_counts()
    t1 = time.perf_counter()
    g4 = torch.func.vmap(torch.func.grad(loss))(lam4)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    both = read_counts()
    st = dict(solve.stats)
    for k, v in both.items():
        total[k] += v
    t1 = time.perf_counter()
    serial = [float(torch.func.grad(loss)(lam4[i])) for i in range(len(Z19C_LAMS))]
    torch.cuda.synchronize()
    wall_serial = time.perf_counter() - t1
    errs = [abs(float(g4[i]) - serial[i]) / abs(serial[i]) for i in range(len(serial))]
    bwd_k4 = both["K4"] - fwd["K4"]
    print(f"  (z19c) vmap(grad) over the serial TV solve, n={n} f32, lambdas {Z19C_LAMS}: "
          f"{[float(v) for v in g4]}; against the serial gradients rel. "
          f"{', '.join(f'{e:.3e}' for e in errs)} (bar 1e-5); adjoint steps per lane "
          f"{st['steps']}, {st['applies']} J^T applications; K4 launches {both['K4']} "
          f"(forward {fwd['K4']}, backward {bwd_k4}, each a (4, N) launch); wall "
          f"{wall:.3f}s against {wall_serial:.3f}s for the 4 serial gradients ({smi})")
    check(max(errs) <= 1e-5, "(z19c) each lane within 1e-5 of the serial gradient")
    check(bwd_k4 == st["applies"] + 2 and sum(both.values()) == both["K4"],
          f"(z19c) backward: one K4 launch of all lanes per J^T application plus 2 "
          f"({bwd_k4} for {st['applies']}), no other kernel")

    # (z19d) solver='cr_packed' against the hybrid at n = 65536.
    cfg = ADMMConfig(maxiters=TV_MAXITERS, unroll="auto")
    sig = staircase(n)
    times = {}
    for dtype in (torch.float32, torch.float64):
        dn = str(dtype).split(".")[-1]
        x = sig.astype(np.float64) if dtype == torch.float64 else sig
        rp = mp(f"z19d cr_packed {dn}", lambda: totalvariation(x, TV_LAM, cfg,
                                                               solver="cr_packed", device=dev),
                once="K1b-D")
        reset_counts()
        rh = totalvariation(x, TV_LAM, cfg, solver="cr", device=dev)
        torch.cuda.synchronize()
        total["K4"] += read_counts()["K4"]
        err = rel(rp.xopt, rh.xopt)
        sol = CyclicReductionSolver.from_tridiag(*tv_system(n, 1.0), dense_cutoff=1023,
                                                 device=dev, dtype=dtype)
        pk = PackedCyclicReductionSolver.from_tridiag(*tv_system(n, 1.0), device=dev,
                                                      dtype=dtype)
        b = torch.from_numpy(np.random.default_rng(19).standard_normal(n)).to(dev, dtype)
        bb = torch.nn.functional.pad(b, (0, sol.alphas.shape[1] - n)).reshape(1, -1)
        xp, xh = pk.solve(b), sol.solve(b)
        solve_err = float(torch.max(torch.abs(xp - xh)) / torch.max(torch.abs(xh)))
        k4s, pks = [], []
        for packed in (False, True, True, False):
            fn = (lambda: pk.solve(b)) if packed else (lambda: cr_solve(bb, sol))
            (pks if packed else k4s).append(graph_ms(fn, 200) * 1e3)
        times[dn] = (min(pks), min(k4s))
        print(f"  (z19d) {dn}: cr_packed steps {rp.steps}, hybrid {rh.steps}; xopt rel. "
              f"{err:.3e} (bar {Z19D_BARS[dn]}); one solve (1, {n}) device time by graph "
              f"replay: packed {pks[0]:.2f} / {pks[1]:.2f} us, K4 hybrid {k4s[0]:.2f} / "
              f"{k4s[1]:.2f} us ({min(pks) / min(k4s):.1f}x), max rel. solve difference "
              f"{solve_err:.3e} ({smi})")
        if dtype == torch.float64:
            check(rp.steps == rh.steps, "(z19d) f64 cr_packed takes the hybrid's steps")
        check(err <= Z19D_BARS[dn], f"(z19d) {dn} cr_packed within {Z19D_BARS[dn]} of the "
              f"hybrid")

    # (z19e) the witness of (z18b)'s sliced gap: the host's inverse in this
    # process against a rank's (one thread each).
    mine = host_inverse()
    differ = int(np.sum(mine != r0["e.inv"]))
    print(f"  (z19e) NumPy inverse of a {Z19E_N}-square P^T P + I cast to f32: {differ} of "
          f"{mine.size} entries differ between this process ({os.cpu_count()} cores, "
          f"OMP_NUM_THREADS={os.environ.get('OMP_NUM_THREADS', 'unset')}) and a rank "
          f"(OMP_NUM_THREADS=1)")
    print(f"  (z19) kernel launches over the phase's main paths {total}; "
          f"{time.perf_counter() - t0:.1f}s")
    return total


def _check_acceleration(out):
    objs = [f for _, f in out.values()]
    check(max(objs) - min(objs) <= 1e-6 * (1.0 + abs(objs[0]))
          and out["anderson m=10"][0] < out["plain"][0],
          "(z16e) acceleration: every rung at one objective, AA in fewer steps")


def _check_lp(out):
    check(all(out[k][2] < 1e-6 and out[k][3] < 1e-3 for k in ("precondition",
                                                              "precondition + AA")),
          "(z16e) badly scaled LP: the preconditioned runs are feasible")


# What each example's own test holds (tests/test_examples.py), at its defaults.
EXAMPLE_CHECKS = {
    "convergencechecking": lambda out: check(
        not out["ok-f / ok-g"].diverged and out["BROKEN-f / BROKEN-g"].diverged,
        "(z16e) convergencechecking: the monitor catches the broken pair only"),
    "fasteradmmcomparison": lambda out: check(
        out["standard"][1] < 1e-2 and out["fast (strong)"][1] < 1e-2
        and out["fast (strong)"][0] <= out["standard"][0],
        "(z16e) fasteradmmcomparison: accurate, fast ADMM in no more steps"),
    "hnormdemo": lambda out: check(
        all(k > 0 and np.isfinite(h) for k, h in out.values()),
        "(z16e) hnormdemo: every stop condition runs to a finite H-norm"),
    "relaxationexample": lambda out: check(
        all(xerr < 1e-2 for _, xerr in out.values()),
        "(z16e) relaxationexample: every relaxation recovers x"),
    "stepsizetesting": lambda out: check(
        all(k > 0 for k, _ in out.values()), "(z16e) stepsizetesting: every rho runs"),
    "acceleration_ladder": _check_acceleration,
    "badly_scaled_lp": _check_lp,
    "portfolio": lambda rows: check(
        all(abs(r[3] - 1) < 1e-6 and r[4] >= -1e-8 for r in rows),
        "(z16e) portfolio: every frontier point on the simplex"),
    "mpc_qp": lambda out: check(
        all(w < c for w, c in zip(out[1][1:], out[0][1:])),
        "(z16e) mpc_qp: every warm re-solve beats its cold solve"),
    "maxcut": lambda rows: check(
        all(cut <= v + 1e-6 and ratio >= 0.878 for _, v, cut, ratio, _ in rows),
        "(z16e) maxcut: every cut within its SDP bound and above 0.878 of it"),
}


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is visible; this script runs only on a GPU")
    sys.path.insert(0, str(ROOT))
    import admm_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    from admm_tpu_torch.ops import _cuda

    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    print(f"device: {smi}")
    print(f"device: torch {torch.__version__}, CUDA {torch.version.cuda}, {name}, "
          f"count {torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    _cuda.library()
    print(f"nvcc build/load of {', '.join(_cuda.SOURCES)}: {time.perf_counter() - t0:.1f}s")
    k1_err, k1_ms, k1_plain_ms, k1_bound = kernel_phase(dev)
    k1b_err, ((k1b_ms, k1b_plain_ms, k1b_bound),) = k1b_phase(dev)
    k1bd_err, k1bd_rows = k1b_phase(dev, diff=True)
    k4_err, k4_ms, k4_plain_ms, k4_bound = k4_phase(dev)
    k2_err, k2_ms, k2_plain_ms, k2_library_ms, k2_bound, k2_backward = k2_phase(dev)
    k1b_launches, k1_launches, a, d_plain = slice_phase(dev)
    k3_launches, k3_err, k3_ms, k3_plain_ms, k3_bound = k3_phase(dev, a)
    k2_launches = bf16_phase(dev, a)
    k4_launches, k1bd_launches = tv_phase(dev)
    variants = variants_phase(dev, d_plain)
    families_phase(dev)
    programs_phase(dev)
    spectral_phase(dev)
    k4_batch_launches = batch_phase(dev)
    hg_launches = hypergradient_phase(dev)
    z16 = slice11b_phase(dev)
    z17, z17a = slice10a_phase(dev)
    z18 = slice10b_phase(dev, z17a)
    z19 = slice10c_phase(dev)
    print(f"total {time.perf_counter() - t0:.1f}s")

    def row(name, route, source, replaces, launches, err, ms, plain_ms, bnd, library_ms):
        by_path = launches if isinstance(launches, dict) else None
        out = {"name": name, "route": route, "source": source, "replaces": replaces,
               "launches": sum(by_path.values()) if by_path else launches,
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": library_ms}
        if by_path:
            out["launches_by_path"] = by_path
        return out

    # K1: softshrink gives z only; K1b, K3: no library call runs an ADMM
    # step's tail or whole steps; K4: torch has no tridiagonal solve.  K2's
    # row is the f32 K = 1 call, the function multi_dot computes.  K1's
    # launches are those of the paths that take the z/u mode: (d)'s user
    # hook, (n) residual balancing and (o) Anderson acceleration with
    # lasso's fused hook (the main path (a) takes K1b); K2's those of the
    # bf16 paths (k) and (p), (z15c)'s forward and backward (its transposed
    # pair, whose times at (1500, 5000) bf16 are the row's "backward"), and
    # (z16)'s; K1b's and K4's (z16)'s beside their own paths.  K1b-D
    # replaces the step's tail of the JAX engine for 1-D TV: its launches
    # are TV (f)'s and (z16)'s and (z19d)'s, and its row carries f64 times.
    print(json.dumps({"kernels": [
        row("fused_soft_threshold_dual", "cuda", "admm_tpu_torch/csrc/zu_tail.cu",
            "admm_tpu/ops/kernels.py:48", {"d": k1_launches, **variants["k1"], "z17": z17["K1"],
                                            "z18": z18["K1"], "z19": z19["K1"]},
            k1_err, k1_ms,
            k1_plain_ms, k1_bound, None),
        row("fused_zu_tail", "cuda", "admm_tpu_torch/csrc/zu_tail.cu",
            "admm_tpu/ops/kernels.py:48", {"a": k1b_launches, "z16": z16["K1b"],
                                            "z17": z17["K1b"], "z18": z18["K1b"],
                                            "z19": z19["K1b"]}, k1b_err,
            k1b_ms, k1b_plain_ms, k1b_bound, None),
        dict(row("fused_diff_tail", "cuda", "admm_tpu_torch/csrc/zu_tail.cu",
                 "admm_tpu/engine.py:575", {"f": k1bd_launches, "z16": z16["K1b-D"],
                                            "z17": z17["K1b-D"], "z18": z18["K1b-D"],
                                            "z19": z19["K1b-D"]}, k1bd_err,
                 *k1bd_rows[0], None),
             f64={"ms": k1bd_rows[1][0], "plain_ms": k1bd_rows[1][1],
                  "bound_ms": k1bd_rows[1][2][0], "bound_by": k1bd_rows[1][2][1]}),
        row("cr_solve", "cuda", "admm_tpu_torch/csrc/cr_solve.cu",
            "experiments/pallas_cr_kernel.py:103",
            {"f": k4_launches, "z14": k4_batch_launches, **hg_launches["K4"], "z16": z16["K4"],
             "z17": z17["K4"], "z18": z18["K4"], "z19": z19["K4"]},
            k4_err, k4_ms,
            k4_plain_ms, k4_bound, None),
        dict(row("gemv_pair", "cuda", "admm_tpu_torch/csrc/gemv_pair.cu",
                 "experiments/pallas_probe.py:52",
                 {"k": k2_launches, **variants["k2"], **hg_launches["K2"], "z16": z16["K2"],
                  "z17": z17["K2"], "z18": z18["K2"], "z19": z19["K2"]},
                 k2_err, k2_ms, k2_plain_ms, k2_bound, k2_library_ms),
             backward={"ms": k2_backward["kernel"], "plain_ms": k2_backward["plain"],
                       "bound_ms": k2_backward["bound"][0],
                       "bound_by": k2_backward["bound"][1]}),
        row("resident_lasso", "cuda", "admm_tpu_torch/csrc/gemv_pair.cu",
            "experiments/resident_iter_proto.py:77", {"k3": k3_launches, "z17": z17["K3"],
                                                      "z18": z18["K3"], "z19": z19["K3"]},
            k3_err,
            k3_ms,
            k3_plain_ms, k3_bound, None),
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
