#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases (any failure raises; the script then exits non-zero and prints no
result line):
  1. card, CUDA and nvcc versions; build of the CUDA kernels (timed)
  2. each kernel against its plain PyTorch version on the same CUDA tensors,
     at the shapes the dense and the H2 builds of the disc at noRef 4 give
     them (float64, tolerance 1e-12 relative to the largest entry; K5's
     keys, element pairs and histogram equal), with both times
  3. the dense slice at the default noRef 5 (4465 dofs) against the JAX
     package's outputs, pinned below
  4. the dense slice at noRef 6 (18145 dofs): assembly and solve times,
     peak device memory, and the launch count of every kernel, reset to
     zero just before this run of the dense main path
  5. the H2 slice at noRef 5 against the JAX package's H2 outputs, pinned
     below; the H2 operator at noRef 6 against phase 4's dense operator
     (1e-5 relative, the Chebyshev far field), and the default (block)
     near-field engine against the flat one at noRef 6: H2 apply 1e-10
     relative, near data 1e-10 of max|data|
  6. the H2 slice at noRef 7 (73153 dofs) on the flat near-field engine
     (params={'nearEngine': 'flat'}): assembly seconds with the build
     parts, solve seconds and iterations, peak device memory, and the launch
     count of every kernel, reset to zero just before this run of the H2
     main path; CG must converge and the L2 error must be below phase 4's.
     Then the H2 kernels against their plain versions as in phase 2, at
     this path's shapes: K8 on its operator; K1's CSR targets (all calls),
     K5 (the largest segment), K6 (the largest order) and K7 on their
     calls, recorded during the run.  The kernel table holds these
     comparisons for K5-K8 and K1's CSR targets.
  7. the H2 CG-MG slice at noRef 5 (6 levels, every one H2) against the
     JAX package's outputs for the same driver line, pinned below
  8. the flagship, H2 CG-MG at noRef 7 (8 levels, 73153 dofs on the
     finest): assembly seconds per level and in total, hierarchy set-up
     seconds, solve seconds (the driver's, and a warm solve), iterations,
     ms per V-cycle (CUDA events), peak device memory, and the launch
     count of every kernel, reset to zero just before this run of the
     multigrid main path; it must converge within 100 iterations, with
     an L2 error within rtol 3e-2 of phase 6's (the finest operator is
     the same up to the engines' 1e-12).  Its H2 levels build their near
     field with the default block engine (K11, K12; K5 and K6 on the pairs
     that also hold orders > 8).  Then K4's two forms (ten iterations
     each, the general one with this V-cycle), K9 (P and P^T of noRef
     6 -> 7), K10 (its three modes), and K11 and K12 (their calls of the
     finest level, recorded during the run) against their plain versions
     at these shapes.
  9. the host near-field engine: the H2 slice at noRef 5 with
     params={'nearEngine': 'host'} (launch counts reset to zero just
     before it) against the JAX package's pinned H2 outputs; then the
     three engines' operators at noRef 5 agree (H2 apply 1e-10 relative,
     near data 1e-10 of max|data|).
 10. the finite-horizon path (drivers/runNonlocal.py: constant kernel,
     ball2, horizon 0.2, poly-Dirichlet with its collar): the five interval
     patch lines of tests/test_nonlocal_driver.py at noRef 6 to their
     bounds, the sparse one a path of its own (launch counts reset) whose
     K14 calls are held against the plain version; the square at noRef 2
     (sparse, cg-mg, 3 levels, 1,521 dofs; launch counts reset just before
     it) against the JAX package's pinned outputs: per-level assembly
     seconds with the host classification and pattern and the device
     fill, iterations, L2 error, peak device memory; K15 and K1's cross
     target (the calls of A_BC) against their plain versions on all its
     calls; the sparse operator against the dense one (1e-12 relative on
     a seeded vector).  (PERF.md holds the square at noRef 3, 6,241 dofs,
     whose host classification is O(C^2).)
 11. the serial multigrid path (drivers/runSerialGMG.py: Poisson on the
     unit square, P1, MG and FMG V-cycles with two damped-Jacobi sweeps on
     each side, CG, GMRES and BiCGStab, plain and preconditioned by one
     V-cycle): the square at noRef 4 against the JAX package's pinned
     outputs (iterations equal); then the full-width line, noRef 9 (10
     levels, 1,046,529 dofs; launch counts reset just before it) against
     the pinned JAX outputs (iterations equal, rates and residuals rtol
     1e-5, errors rtol 1e-6 above their summation floor) and the
     reference cache (tests/test_gmg.py:36-49), with the host set-up
     parts, K16's device time per level, each solve's seconds, a V-cycle
     (CUDA events) and the peak device memory; then K16 (the finest
     stiffness), K17 (one restart cycle of 10 steps and the combine) and
     K18 (10 iterations) against their plain versions at these shapes.
 12. the interval in H2 and the smooth kernels: runFractional's interval
     (s = 0.75, P1, lu, H2, noRef 6, 127 dofs; a path of its own) against
     the reference cache and the pinned JAX outputs, and its cg-mg line
     against the JAX outputs; runNonlocal's gaussian and exponential lines
     (lu, H2, fullSpace, noRef 8; each a path of its own) against their
     caches and the JAX outputs, with K1's CSR targets, K5, K6, K7, K11 and
     K12 on all their calls, K13 (a host-engine build) and K1's dense
     target, K2 and K3 (a dense build) against their plain versions with
     these profiles (erfc included, in the gaussian's 1D boundary kernel);
     the gaussian at noRef 14 (cg-jacobi, a path); H2 against dense at
     noRef 12 (8,191 dofs, 1e-5 relative) and that line's CG-MG error; then
     the full-width line, H2 CG-MG at noRef 15 (16 levels, 65,535 dofs; a
     path): per-level build parts, iterations, the warm solve, ms per
     V-cycle, peak device memory, an L2 error below noRef 12's, and K1's
     CSR targets, K5, K6, K7, K11 and K12 (their largest calls) against
     their plain versions at its shapes.
 13. variable-order and nonsymmetric kernels on the interval
     (runFractional): the six lines of tests/test_drivers_fractional.py
     :121-167 at noRef 6 (varconst, constantNonSym and twoDomainNonSym;
     dense and H2; cg-jacobi, gmres-jacobi, lu and gmres-mg; each a path
     of its own) against their pins and the pinned JAX outputs; H2 and its
     transpose against dense at noRef 12 (8,191 dofs; the transposed apply
     a path of its own, eT < max(1e-5, 3 eFwd), tests/test_h2_transpose.py
     :33); the full-width line, twoDomainNonSym gmres-mg H2 at noRef 12
     (13 levels, 8,191 dofs; a path): iterations, errors, per-level build
     parts, cold and warm solve, ms per V-cycle, peak device memory; then
     K1 with the order codes (dense target; tree, dense and slots targets
     with the y shift),
     K7 with them, K19 (dense and slots targets) and K20 (noRef 12 and
     every level of the full-width line) against their plain versions.
 14. the s-derivative operators (nonlocalBuilder with getFractionalKernel(d,
     s, derivative=k)): d^2/ds^2 of s = 0.75 on the disc at noRef 5, dense
     (getDenseVector) and H2 (getH2Vector), and the three vector lines of
     leftRight on the interval at noRef 6 (getDenseVector, matvec,
     matvecTrans; each a path of its own) against the pinned JAX outputs;
     the vector kernel against central differences of the dense operators
     in (sll, srr) at noRef 8 (5e-4); dA/ds H2 against dense on the disc at
     noRef 6 (5e-4); the full-width lines, dA/ds of the flagship disc at
     noRef 6 (cut from 7 to make room for phase 28; getH2Vector under
     torch.profiler: build parts and seconds,
     its device time, apply and transposed apply, peak memory) and
     d^2A/ds^2 of leftRight(0.25, 0.75) dense at noRef 10 (2,047 dofs,
     [2047, 2047, 4]; noRef 9 if its host classification exceeds 300 s;
     each a path, K21's and K22's calls recorded during it); then K21, K22,
     K23 (against torch.einsum too) and the power-log profile in K1, K2,
     K3, K6 (where called), K7 and K12 against their plain versions.
 15. the Helmholtz path (drivers/runHelmholtz.py: S - omega^2 M + i omega
     M_B with impedance conditions, GMRES right-preconditioned by one
     V-cycle of the complex-shifted Laplacian, all complex128): the
     interval's wave and greens lines and the full-width square (noRef 8,
     4 levels, 66,049 dofs; each a path of its own) against the JAX
     driver's pinned outputs (numIter equal, the rest 1e-6 relative, the
     solution's L2 norm 1 within 1e-5), with the host set-up parts, the
     multigrid set-up, the solve, a V-cycle, a warm GMRES solve per step
     and the peak device memory; then K9's, K10's and K17's complex
     variants against their plain versions at the square's shapes (the
     finest A, P and P^T on complex vectors; n 66,049; one GMRES cycle of
     10 steps and the combine), with torch.sparse, torch.sub and
     torch.addmv beside them.
 16. the complex Greens kernels (nonlocalBuilder with greens2D, lambda
     -3j, on the square, P1, Dirichlet; complex128 throughout): at noRef 5
     (961 dofs), infinite horizon and horizon 0.45 (ball2), getDense,
     getDiagonal, GMRES and BiCGStab against the JAX package's pinned
     outputs (||A||_F, trace, ||A v|| and A v[:4] to 1e-11 relative; GMRES
     iterations equal and ||x|| to 1e-8; BiCGStab iterations +-1 and ||x||
     to 1e-6); then the full-width lines, noRef 6 (8,192 cells, 3,969
     dofs; each horizon a path): the host classification (seconds, peak
     host memory), getDense and getDiagonal, both solves to a relative
     residual below 1e-7, getDiagonal against diag(A) to 1e-10, the dense
     apply and the peak device memory; the device time per kernel of a
     second build under torch.profiler, during which the calls of K1's
     complex dense and diagonal targets and of K15's complex variant are
     recorded; then those and K18's complex variant (10 iterations on the
     horizon-0.45 operator) against their plain versions at these shapes.
 17. the finite-horizon cut pairs: runNonlocal's disc with its collar
     (constant kernel, horizon 0.2, poly-Dirichlet, sparse cg-mg) at noRef
     3 with ball2 and ballInf against the JAX outputs pinned by
     scripts/pin_finite_horizon_jax.py, then the full-width line at noRef
     4 (7,936 cells; a path): dofs, iterations, error, assembly and solve
     seconds, the finest classification's seconds and peak host memory;
     ball1 and the ellipse through the library call (the indicator kernel
     on squareWithInteractions(0, 0, 1, 1, 0.2, h), P1 on every vertex,
     zeroExterior=False) at h 0.05 against their pins (||A||_F, ||A u||,
     (A u)[:4] to 1e-11; each a path), ball1 at h 0.025 (6,272 cells; a
     path): sparse = dense, the patch ratio of
     tests/test_kernels_extra.py, the classification, getSparse and
     getDense seconds, the device time per kernel of a second getSparse,
     the apply; the variable horizon delta(x) on the interval
     (getFractionalKernel(1, s, horizon=horizonFunction(...))): noRef 6
     against its pins (a path), getDense = getSparse at noRef 12, and the
     full-width noRef 12 (4,095 dofs; a path): getSparse, the apply,
     unpreconditioned GMRES of A u = A 1 to 1e-10 relative, the device
     time of K19; then K15 and K1 with ball1 and the ellipse and K19 with
     the indicator and the variable horizon against their plain versions
     (kernel line rows ``cut2d_polar:ball1`` ... with their launches on
     these paths).
 18. the matrix formats of assembleNonlocal (the fractional kernel of order
     0.25 on nonlocalMesh's interval or square with its collar, the
     interior dofs): 'H2corrected' (S_inf in H2, the mass, the complement
     kernel's cross operator; setKernel to horizon 0.3 keeps S_inf) at the
     interval noRef 3 and 6 and the square noRef 1 against the JAX outputs
     pinned by scripts/pin_matrix_formats_jax.py (1e-12; CG-Jacobi at noRef
     6: 32 iterations); the full-width interval at noRef 10 (7,168 cells,
     5,119 dofs; a path): the build parts, getSparse at horizons 0.4 and
     0.3 (entries and apply below the JAX package's noRef 7 differences),
     setKernel's seconds and device time by kernel, CG-Jacobi with it and
     with getSparse, the applies and the peak device memory; the square at
     noRef 3 (6,272 cells; a path) the same without the solves; getDiagonal
     with the zero-exterior term (s 0.6, infinite horizon) on the interval
     at noRef 12 and the disc at noRef 4 against the diagonal of getDense
     without the grid; 'sparsified' on the interval at noRef 8 against
     getSparse (each a path); then K1 with the complement indicator and the
     block mask and K1's diagonal target on the zero-exterior pairs against
     their plain versions (kernel line rows ``panel_scatter:complement``
     and ``panel_scatter:diag_exterior``).
 19. operator interpolation over the fractional order and the matrix-free
     operator: the port's copy of examples/example_operator_interpolation.py
     (the interval refined 6 times, s in [0.05, 0.95], dense) on its
     default path (the grid) and on the per-pair path (each a path)
     against the JAX outputs pinned by
     scripts/pin_operator_interpolation_jax.py (intervals and nodes exact,
     weights 1e-15, CG-Jacobi iterations equal, |u|_max 1e-8, the node
     operators assembled after each set; on the per-pair path, the JAX
     package's on the CPU, A(s) x 1e-12), its H2 twin at s 0.5
     (1e-10; a path); the full-width line, the interval refined 13 times
     (8,191 dofs, 13 intervals of 6 nodes; 12 if its node assemblies would
     exceed 120 s; a path): per s = 0.75, 0.76, 0.3 the node assemblies'
     seconds, the stack, CG-Jacobi to 1e-8, the peak device memory, and
     A(0.75) x against a direct assembly (below 0.1 h^(1/2)); then K24
     (against torch.einsum too) against its plain version.  Its
     matrix-free part runs right after phase 11, on phase 11's square
     while it is alive, and reports under phase 19: the stiffness and mass
     (a path) against the CSR operators (1e-12), then K25 (apply and
     diagonal; against K9 and torch.sparse too) against its plain version.
 20. the multigrid extras, right after phase 11's matrix-free part on
     phase 11's square: Chebyshev multigrid (3+3 steps, K26) on the
     interval and the square (noRef 6, 3,969 dofs), the ILU smoother's
     multigrid and an SSS apply (K27) of a seeded matrix against the JAX
     outputs pinned by scripts/pin_multigrid_extras_jax.py (a path:
     iterations exact, max|x| and rho(D^-1 A) per level 1e-10, the apply
     1e-13); the full-width line (a path) on the square at noRef 9
     (1,046,529 dofs): the Chebyshev set-up (rho per level), V, FMG_V and
     CG preconditioned by its V-cycle at phase 11's tolerance, _mg_solve
     (its iterations equal V's), the SSS operator of tril(A, -1) against
     the CSR apply (1e-13), a V-cycle by CUDA events; the host smoothers
     on the square at noRef 7 (65,025 dofs, hierarchyManager; a path): the
     ILU smoother's multigrid and CG preconditioned by IChol, with their
     set-up and host seconds; then K26 (its three modes) and K27 (against
     torch.sparse and K9 on the symmetric CSR too) against their plain
     versions at the noRef 9 shapes (1e-13 of the largest entry).  Alone:
     `python -c 'import chip_smoke as c; from pynucleus_tpu_torch import
     kernels; kernels.library(); c.phase20()'` (it makes the square).
 21. the two-point weights, the tempered kernels and the remaining
     profiles: the per-pair dense operators of the interval at noRef 4
     with the tempered, leftRight and interface phis, a nonsymmetric order
     with the tempered phi (K19), the tempered kernel of a finite horizon
     (getSparse, K14), the log-inverse-distance, monomial and polynomial
     profiles and greens2D with the tempered phi (a path), against the
     JAX outputs pinned by scripts/pin_twopoint_jax.py (1e-11; the tier-1
     far-entry ratio too); runNonlocal's gaussian and exponential lines on
     the interval at noRef 6 and the gaussian on the square at noRef 2
     (sparse, lu; each a path) against the JAX driver's errors (1e-10
     absolute; the square rtol 1e-6); the full-width line, the flagship
     disc at noRef 6 (18,145 dofs) on the default grid with the tempered
     phi and the tempered kernel (a path): A_phi = (C/C_t) A_t to 1e-12 of
     the largest entry (K1 and K2 apply phi; the JAX grid drops it), then
     the tempered problem with its zero-exterior term (K3 with the
     tempered boundary kernel) by CG-Jacobi, iterations and seconds;
     runNonlocal's interval at noRef 8 with the gaussian and exponential
     kernels (sparse, CG-MG; each a path); the weighted finite horizon (a
     tempered fractional kernel times the tempered phi) on the interval
     at noRef 10 and the square at noRef 1 (sparse; the square against its
     dense operator), the nonsymmetric order with the tempered phi at
     noRef 10 and the comparison builds on the disc at noRef 5 (a path);
     then each new variant of K1, K2, K3, K14, K15 and K19 against its
     plain version (1e-12 of the largest entry).  Alone: `python -c
     'import chip_smoke as c; from pynucleus_tpu_torch import kernels;
     kernels.library(); c.phase21()'`.
 22. the manifold fractional kernel and the variable orders in 1D and
     2D: the pins of scripts/pin_orders2d_jax.py (a path: the manifold
     kernel at 64 and 256 dofs, each order of VO22_CASES on the interval
     refined 4 times and on the square or the disc at noRef 2, per pair,
     with the zero-exterior term, and the variableOrder driver at noRef 3;
     1e-10); the driver at its defaults (a path: the circle at noRef 5,
     3,969 dofs, innerOuter through K1, lu and cg; the square at noRef 5,
     961 dofs, leftRight through K19, lu and gmres with the transpose; the
     interval at noRef 8, its seven orders, lu), with each assembly's and
     solve's seconds; the manifold kernel on sphere1(8192) on the default
     grid (a path: symmetric, A 1 = 0 and a positive diagonal, to 1e-12
     of the largest entry) and sphere1(1024) on the grid against its
     per-pair path (1e-12); then each variant of K1 and K19 with the
     orders of position, and K1 and K2 on the manifold, against its plain
     version (1e-12 of the largest entry).  Alone: `python -c 'import
     chip_smoke as c; from pynucleus_tpu_torch import kernels;
     kernels.library(); c.phase22()'`.
 23. the float32 dense path (a builder's params={'dtype': np.float32}):
     tests/test_f32_path.py's interval lines (noRef 6, grid and per pair,
     e32 < max(2 e64, 5e-4); a path), then bench.py's benchAssembly disc,
     circle(n=8) refined 6 times (16,129 dofs), getDense on the grid in
     float32 (a path: K1's, K2's and K3's float32 instances) and CG-Jacobi
     to 1e-6 (500 iterations at most, K4 on float32 vectors, TF32 off), and
     the same in float64 (a path): each assembly's seconds and its
     kernels' device ms (CUDA events), iterations, residuals, peak device
     memory, max|A32 - A64| / max|A64| and the relative distance of the two
     solutions (below 1e-3); then each float32 instance against its
     float32 plain version at the disc's calls (every identical-cell,
     touching and zero-exterior bucket and the largest distant bucket of
     each route and shape; 1e-5 of the largest entry; K4 10 iterations,
     x, r and p to 1e-5 relative) with the same calls' float64 time, and
     the natural-order entry (the JAX package's one-chunk
     _bucket_natural_scatter) on its largest call in float32 and float64.
     Alone: `python -c 'import chip_smoke as c; from pynucleus_tpu_torch
     import kernels; kernels.library(); c.phase23()'`.
 24. the float32 H2 path (getH2 with params={'dtype': np.float32}):
     bench.py's h2_2d, the disc of phase 23 (16,129 dofs), getH2 on the
     block engine in float32 (a path: the float32 instances of K1's slot
     and tree targets, K6, K7, K8 and K12; no float64 instance of them)
     and in float64 (a path), CG-Jacobi (b = M 1, 1e-6, 500 at most) and
     the steady apply (bench.py:92, 64 normalised applications); bench.py's
     h2_1d, the interval refined 16 times (65,535 dofs), getH2 and the
     steady apply on sin(pi x) in float32 (a path) and its float64 twin (a
     path; at noRef 14 beside a float32 build there if the float32 build
     at 16 took over 25 s): build seconds with the builder's timers, the
     build kernels' device ms (CUDA events), near nnz, far blocks, peak
     device memory, iterations, residuals, warm solve seconds; max|H32 x -
     H64 x| / max|H64 x|, the diagonals' gap, the solutions' (below 1e-3)
     and the disc's H2 against phase 23's float64 dense operator; then each
     float32 instance against its float32 plain version at a third float32
     build's calls (the largest bucket of K1's slot and tree targets and of
     K6, every call of K12 and K7; K8 10 applies of the disc's operator,
     1e-5 of max|y|) with the same calls' float64 time.  Alone: `python -c
     'import chip_smoke as c; from pynucleus_tpu_torch import kernels;
     kernels.library(); c.phase24()'`.
 25. distribution on one card, a shard mesh of four shards stacked on it
     (pynucleus_tpu_torch/parallel): drivers/testDistOp.py's disc at noRef
     6 (18,145 dofs; cut from 7) in H2, wrapped as DistributedH2Matrix in halo and
     bcast mode, with the distributed CG (a path): the distributed applies
     within 1e-10 of the H2 one (relative), the CG converged; ms per apply
     of each against K8's (CUDA events), K28's and K29's launches and the
     bytes the shards receive per apply, the peak device memory; the
     dense bases (each a path): testDistOp's disc at noRef 5 on a dense
     base (DistributedRowBlockOperator, DistributedHaloOperator; 1e-10 of
     the dense apply, the CG converged), shardedDenseAssembly on the dry
     run's S1 problem (s 0.25, the interval at 4,095 dofs) against the
     per-pair getDense (1e-12 of the largest entry) with CG-Jacobi on its
     row shards (residual below 1e-5 |b|), and a banded operator (a
     horizon of 0.05 on the interval at noRef 12, dofs in coordinate
     order) through the halo strips, DistMatrix and Import (1e-12 of
     max|Bx|); runParallelGMG's interval P1 at its default noRef (32,767
     dofs) with --ranks 4 (a path: its levels of at least 2000 rows sharded as
     DistributedCSROperator) against --ranks 1 (residual histories rtol
     1e-10, atol 1e-12) and the reference cache of
     tests/test_parallel_gmg.py; dryrunDistributedH2 at noRef 14 (a path;
     its CG must converge); the overlap accumulate and the repartition of
     tests/test_overlaps.py's square (a path) against the host path
     (1e-14); then K28 (each phase) and K29 (the pack, also at the banded
     operator's halo strips; the receive-add and the 2D gather at the
     overlap calls) against their plain versions at the calls of one halo
     and one bcast apply of the disc (1e-12 of
     each call's largest output), K28's near phase against torch.sparse
     and K29's pack against index_select.  Alone: `python -c 'import
     chip_smoke as c; from pynucleus_tpu_torch import kernels;
     kernels.library(); c.phase25()'`.
26. the float32 remainder (params={'dtype': np.float32} beyond getDense
     and getH2): runNonlocal's square with its collar at noRef 2 (the
     constant kernel, ball2, horizon 0.2; a path): getSparse in float32
     and float64 on one dofmap and kernel (one O(C^2) classification),
     CG-Jacobi on each (1e-6, 500 at most: K9's and K4's float32
     instances), the float32 solution within 1e-3 of the float64 one,
     the float32 getDiagonal float64 and within one float32 ulp of the
     float32 operator's diagonal; the interval at noRef 9 the same way
     without the diagonal (K14, a path); the float32 getDiagonal of phase
     18's zero-exterior lines (the interval at noRef 12, the disc at noRef
     4; a path each) within 1e-3 of their float64 ones (the float32
     diagonal moves away with refinement in both packages:
     scripts/f32_diag_gap_jax.py); the host engine's
     float32 getH2 on the disc circle(n=8) at noRef 5 (3,969 dofs, one
     level below phase 24's: the host enumeration; a path) within 1e-5
     of max|y| of the float32 block-engine operator of the same mesh, and
     DistributedH2Matrix of it over four shards in halo and bcast mode (a
     path each): a float64 apply of a float32 x within 1e-12 (relative) of
     K8's float64 apply on the upcast coefficients (H.double()); then K1's
     float32 instances into float64 data (with the indicator) and into
     the float64 diagonal, K9's and K13's float32 instances against their
     float32 plain versions at these calls (1e-5 of the largest entry),
     with the same calls' float64 time and, for K9, torch.sparse's
     float32 product.  The cut pairs run K14 and K15 in float64, as the
     JAX float32 program runs them.  Alone: `python -c 'import chip_smoke
     as c; from pynucleus_tpu_torch import kernels; kernels.library();
     c.phase26()'` (it then builds phase 18's diagonals itself).
27. the variable-order H2 on the interval: getH2Vector of the derivative-1
     kernel of leftRight(0.25, 0.75, 0.4, 0.6) (four component kernels
     through K1 and K19 with the component order and the singular rules'
     log correction, K7 with the component order) against getDenseVector
     (K22, K21; applies by K23) at noRef 8 (a path: each component's gap
     of the apply and of the transposed apply against the JAX gap pinned
     from scripts/pin_varorder_h2_jax.py, |gap - pin| <= 1e-6 pin +
     1e-12) and at noRef 11 (4,095 dofs, cut from 12: PERF.md §4; a path:
     build parts, applies, gaps), the getDense of its component 0 there
     against the stack (1e-12; a path); the H2 of the orders of position
     innerOuter and islands (symmetric and with sio != soi), layers and
     fe against their dense operators at noRef 8 (fe at noRef 3, the
     largest interval the JAX getH2 of fe builds; a path: the gaps against
     the JAX pins) and at noRef 10 (2,047 dofs, cut from 12: PERF.md §4; a
     path; fe's H2 there raises NotImplementedError, as the JAX getH2
     fails), GMRES-Jacobi on innerOuter's H2 and dense operators at noRef
     10 (a path: iterations, residuals, the solutions' gap); then the
     component order's variants of
     K1 (dense and tree targets), K19 (dense and slot targets) and K7, and
     the orders of position in K1's tree target, K19's slot target and K7
     against their plain versions at these calls (1e-12 of the largest
     entry).  Alone: `python -c 'import chip_smoke as c; from
     pynucleus_tpu_torch import kernels; kernels.library(); c.phase27()'`.
 28. the float32 formats of the finite horizon and the smooth kernels
     (params={'dtype': np.float32}): the gaussian kernel's getDense on the
     disc of phase 23 (16,129 dofs, on the grid; K1, K2 and K3's float32
     instances with the profile switch; a path) and in float64 (a path),
     CG-Jacobi on each; runNonlocal's constant kernel (ball2, horizon 0.2)
     on phase 26's square (noRef 2) and interval (noRef 9): getDense (K1's
     float32 instance with the indicator into a float32 A, the cut pairs'
     float64 matrices of K14 and K15 added with one rounding), 'sparsified'
     (equal to the dense entries) and on the interval getDenseCross (K1's
     float32 entries into the float64 A_BC), CG-Jacobi on the sparsified
     operator against phase 26's float64 getSparse and solve (a path each);
     phase 18's H2corrected line (the interval at noRef 10) in float32 (the
     float32 getH2, K1 with the complement indicator and the block mask
     into the float64 cross operator, a float64 apply; a path) against
     phase 18's float64 operator, CG-Jacobi on each; the gaussian kernel of
     horizon 0.2 on the square in float32 getSparse (K1's float32 entries
     with the profile into float64 data) and float64, CG-Jacobi on each (a
     path); every float32 solution within 1e-3 of the float64 one; then each
     new float32 instance against its plain version at the largest call of
     each kind (1e-5 of the largest entry) with the same calls' float64
     time.  Alone: `python -c 'import chip_smoke as c; from
     pynucleus_tpu_torch import kernels; kernels.library(); c.phase28()'`
     (it then makes the float64 lines of phases 18 and 26 itself).
Phase 2 also holds K4's two forms, K9 (P and P^T of noRef 3 -> 4) and K10
at the noRef 4 shapes, K8 on the noRef 0, 1 and 2 operators, and K11, K12
(a default build) and K13 (a host-engine build) at the noRef 4 shapes
against their plain versions.
The last lines are the kernel table (JSON: per kernel, per complex
variant of K9, K10, K17, K1 (dense and diagonal targets), K15 and K18,
per finite-horizon variant of K1, K15 (ball1, ellipse) and K19
(indicator, variable horizon), per matrix-format variant of K1
(complement, the zero-exterior diagonal), per profile and two-point
variant of K1, K2, K3, K14, K15 and K19 (tempered, two_point,
log_inverse, polynomial, gaussian, exponential), per order-of-position
variant of K1 and K19, per manifold variant of K1 and K2, per float32
instance of K1 (all, natural-order, zero-exterior rows), K2, K3 and K4,
of the H2 path (K1's slot and tree targets, K6, K7, K8, K12) and of the
float32 remainder (K1 into float64 CSR data and diagonals, K9, K13) and
of the finite horizon's formats and the smooth kernels (K1 with the
indicator into a float32 A, into the float64 A_BC, with the complement
indicator into a float64 A; K1, K2 and K3 with the profiles)
(with the same calls' float64 time), per variant of the interval's
variable-order H2 (the component order in K1, K19, K7 with its log
launches; the orders of position in K1's tree target, K19's slot target
and K7), and K24-K29, its
launches on the main paths and the CUDA
launches those made, the largest error against
its plain version, its time, the plain version's, the least time the card
could take for the same work and what bounds it, and the time of one
PyTorch library call computing the same function where there is one),
the card's name and power limit, and {"ok": true, "device": {...}}.
"""
import functools
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()
# operators that one phase leaves to a later one (phase 23's float64 dense
# disc for phase 24)
KEPT = {}

# JAX package outputs of `drivers/runFractional.py --domain disc --s
# 'const(0.75)' --problem constant --element P1 --solverType cg-jacobi
# --matrixFormat dense` (default noRef 5, 4465 dofs), run on the CPU in
# float64.  The JAX run takes the per-pair path and the port the grid path
# (A differs by ~1e-7 relative), the L2 error cancels ~4 digits and CG
# stops at 1e-6, so they are held to the repo's regression tolerance
# rtol 3e-2 (nl/discretized.py reportErrors), no tighter.
JAX_NOREF5 = {
    'dofs': 4465,
    'iterations': 34,
    'errors': {
        'L2 error': 2.658977e-03,
        'relative L2 error': 5.666890e-03,
        'L2 error interpolated': 1.400320e-03,
        'relative interpolated L2 error': 2.985901e-03,
        'Linf error interpolated': 1.267110e-03,
        'relative interpolated Linf error': 3.027257e-03,
        'Hs error': 6.048856e-02,
        'relative Hs error': 6.978063e-02,
    },
}
# JAX package outputs of the same driver line with --matrixFormat H2
# (default noRef 5, host near-field engine), run on the CPU in float64.
JAX_H2_NOREF5 = {
    'dofs': 4465,
    'iterations': 34,
    'errors': {
        'L2 error': 2.6814678e-03,
        'relative L2 error': 5.7148228e-03,
        'L2 error interpolated': 1.4369129e-03,
        'relative interpolated L2 error': 3.0639282e-03,
        'Linf error interpolated': 1.2658493e-03,
        'relative interpolated Linf error': 3.0242459e-03,
        'Hs error': 6.1014731e-02,
        'relative Hs error': 7.0387631e-02,
    },
}
# JAX package outputs of the same driver line with --solverType cg-mg
# --matrixFormat H2 --noRef 5 (6 levels, every one H2; host near-field
# engine), run on the CPU in float64.  Iterations are held to +-1: the
# port's near data come from the flat device engine and differ from the
# host engine's by ~1e-12 relative, which can move a last residual that
# sits at the tolerance across it.
JAX_H2_MG_NOREF5 = {
    'dofs': 4465,
    'iterations': 7,
    'errors': {
        'L2 error': 2.681466e-03,
        'relative L2 error': 5.714818e-03,
        'L2 error interpolated': 1.436908e-03,
        'relative interpolated L2 error': 3.063918e-03,
        'Linf error interpolated': 1.265806e-03,
        'relative interpolated Linf error': 3.024142e-03,
        'Hs error': 6.101473e-02,
        'relative Hs error': 7.038763e-02,
    },
}
# JAX package outputs of `drivers/runNonlocal.py --domain square
# --kernelType constant --problem poly-Dirichlet --element P1 --solverType
# cg-mg --matrixFormat sparse` (default noRef 2, horizon 0.2, 1521 dofs),
# run on the CPU in float64; iterations +-1 and the error within the
# repo's regression tolerance rtol 3e-2.
JAX_SQUARE_NOREF2 = {'dofs': 1521, 'iterations': 7,
                     'L2 error interpolated': 3.6939776e-04}
# the square's line (a path), held to JAX_SQUARE_NOREF2
FH_NOREF = 2
# tests/test_nonlocal_driver.py INTERVAL_CONFIGS: (kernel, format, bound)
INTERVAL_PATCH = (('constant', 'dense', 1e-12), ('constant', 'H2', 1e-12),
                  ('constant', 'sparse', 1e-12),
                  ('inverseDistance', 'dense', 1e-12),
                  ('fractional', 'dense', 1e-8))
RTOL_ERRORS = 3e-2
TOL_KERNEL = 1e-12
TOL_H2_DENSE = 1e-5
H2_NOREF = 7
H2_MAXITER = 400
MG_MAXITER = 100

# Peak rates of one H100 SXM for the bound of each kernel: HBM3 3.35 TB/s
# and float32 67 TFLOP/s outside the tensor cores; float64 34 TFLOP/s
# outside the tensor cores (NVIDIA's H100 data sheet).  A pow, log or division counts as one operation, so
# the operations bound is a lower bound.
HBM_RATE = 3.35e12
F64_PEAK = 34e12
F32_PEAK = 67e12

KERNEL_INFO = {
    'panel_scatter': ('cuda', 'pynucleus_tpu_torch/kernels/csrc/panel_scatter.cuh',
                      'pynucleus_tpu/nl/assembly.py:91'),
    'grid_distant': ('cuda', 'pynucleus_tpu_torch/kernels/csrc/grid_distant.cu',
                     'pynucleus_tpu/nl/assembly.py:131'),
    'grid_boundary': ('cuda', 'pynucleus_tpu_torch/kernels/csrc/grid_boundary.cu',
                      'pynucleus_tpu/nl/assembly.py:240'),
    'pcg_update': ('triton', 'pynucleus_tpu_torch/kernels/pcg_update.py',
                   'pynucleus_tpu/base/solvers.py:297'),
    'near_enum': ('cuda', 'pynucleus_tpu_torch/kernels/csrc/near_enum.cu',
                  'pynucleus_tpu/nl/assembly.py:1280'),
    'near_enum_quad': ('cuda', 'pynucleus_tpu_torch/kernels/csrc/near_enum.cu',
                       'pynucleus_tpu/nl/assembly.py:1506'),
    'far_field': ('cuda', 'pynucleus_tpu_torch/kernels/csrc/far_field.cu',
                  'pynucleus_tpu/nl/assembly.py:744'),
    'h2_matvec': ('cuda', 'pynucleus_tpu_torch/kernels/csrc/h2_matvec.cu',
                  'pynucleus_tpu/nl/h2.py:963'),
    'csr_spmv': ('cuda', 'pynucleus_tpu_torch/kernels/csrc/csr_spmv.cu',
                 'pynucleus_tpu/base/linear_operators.py:310'),
    'jacobi_smooth': ('triton', 'pynucleus_tpu_torch/kernels/jacobi_smooth.py',
                      'pynucleus_tpu/multilevel/gmg.py:216'),
    'block_near_count': ('cuda',
                         'pynucleus_tpu_torch/kernels/csrc/near_block.cu',
                         'pynucleus_tpu/nl/assembly.py:1402'),
    'block_near_quad': ('cuda',
                        'pynucleus_tpu_torch/kernels/csrc/near_block.cu',
                        'pynucleus_tpu/nl/assembly.py:1427'),
    'tree_csr_quad': ('cuda', 'pynucleus_tpu_torch/kernels/csrc/near_enum.cu',
                      'pynucleus_tpu/nl/assembly.py:1118'),
    'cut1d': ('cuda', 'pynucleus_tpu_torch/kernels/csrc/cut_cells.cu',
              'pynucleus_tpu/nl/assembly.py:644'),
    'cut2d_polar': ('cuda', 'pynucleus_tpu_torch/kernels/csrc/cut_cells.cu',
                    'pynucleus_tpu/nl/assembly.py:511'),
    'csr_scatter': ('cuda', 'pynucleus_tpu_torch/kernels/csrc/csr_scatter.cu',
                    'pynucleus_tpu/fem/assembly.py:87'),
    'gmres_arnoldi': ('triton', 'pynucleus_tpu_torch/kernels/gmres_arnoldi.py',
                      'pynucleus_tpu/base/solvers.py:365'),
    'bicgstab_update': ('triton',
                        'pynucleus_tpu_torch/kernels/bicgstab_update.py',
                        'pynucleus_tpu/base/solvers.py:503'),
    'panel_scatter_nonsym': (
        'cuda', 'pynucleus_tpu_torch/kernels/csrc/panel_scatter_nonsym.cuh',
        'pynucleus_tpu/nl/assembly.py:424'),
    'h2_matvec_T': ('cuda', 'pynucleus_tpu_torch/kernels/csrc/h2_matvec.cu',
                    'pynucleus_tpu/nl/h2.py:910'),
    'panel_scatter_vec': (
        'cuda', 'pynucleus_tpu_torch/kernels/csrc/panel_scatter_vec.cu',
        'pynucleus_tpu/nl/assembly.py:457'),
    'panel_scatter_nonsym_vec': (
        'cuda', 'pynucleus_tpu_torch/kernels/csrc/panel_scatter_vec.cu',
        'pynucleus_tpu/nl/assembly.py:484'),
    'vector_matvec': ('cuda',
                      'pynucleus_tpu_torch/kernels/csrc/vector_matvec.cu',
                      'pynucleus_tpu/base/linear_operators.py:156'),
    'interp_matvec': ('cuda',
                      'pynucleus_tpu_torch/kernels/csrc/interp_matvec.cu',
                      'pynucleus_tpu/nl/operator_interpolation.py:262'),
    'matfree_apply': ('cuda',
                      'pynucleus_tpu_torch/kernels/csrc/matfree_apply.cu',
                      'pynucleus_tpu/fem/assembly.py:321'),
}
# the kernels (and K1 targets) each main path must launch
DENSE_PATH = ('panel_scatter', 'grid_distant', 'grid_boundary', 'pcg_update',
              'panel_scatter:dense', 'pcg_update:jacobi')
H2_PATH = ('panel_scatter', 'pcg_update', 'near_enum', 'near_enum_quad',
           'far_field', 'h2_matvec', 'panel_scatter:slots',
           'panel_scatter:tree', 'pcg_update:jacobi')
MG_PATH = ('panel_scatter', 'pcg_update', 'near_enum', 'near_enum_quad',
           'far_field', 'h2_matvec', 'csr_spmv', 'jacobi_smooth',
           'block_near_count', 'block_near_quad', 'panel_scatter:slots',
           'panel_scatter:tree', 'pcg_update:general')
HOST_PATH = ('panel_scatter', 'pcg_update', 'tree_csr_quad', 'far_field',
             'h2_matvec', 'panel_scatter:slots', 'panel_scatter:tree',
             'pcg_update:jacobi')
INTERVAL_PATH = ('panel_scatter', 'cut1d', 'csr_spmv', 'panel_scatter:slots',
                 'panel_scatter:cross')
NONLOCAL_PATH = ('panel_scatter', 'pcg_update', 'csr_spmv', 'jacobi_smooth',
                 'cut2d_polar', 'panel_scatter:slots', 'panel_scatter:cross',
                 'pcg_update:general')
FLAT = {'nearEngine': 'flat'}
HOST = {'nearEngine': 'host'}
TOL_ENGINES = 1e-10
# where the kernel table's comparison with the plain version was made
COMPARED_AT = {
    'panel_scatter': 'disc noRef 4 (dense target), '
                     f'noRef {H2_NOREF} (CSR targets, all calls), square '
                     f'noRef {FH_NOREF} horizon 0.2 (cross target, A_BC)',
    'grid_distant': 'disc noRef 4, all calls, and an order-6 window',
    'grid_boundary': 'disc noRef 4',
    'pcg_update': f'disc noRef {H2_NOREF}, 10 iterations of each form (the '
                  'general one with the flagship V-cycle, timed with a '
                  'diagonal M)',
    'near_enum': f'disc noRef {H2_NOREF}, its largest segment',
    'near_enum_quad': f'disc noRef {H2_NOREF}, its largest order',
    'far_field': f'disc noRef {H2_NOREF}',
    'h2_matvec': f'disc noRef {H2_NOREF}, per apply of 10',
    'csr_spmv': f'disc noRef {H2_NOREF}: P x and P^T r of noRef '
                f'{H2_NOREF - 1} -> {H2_NOREF}, per pair of products',
    'jacobi_smooth': f'disc noRef {H2_NOREF}: its three modes, per set',
    'block_near_count': f'disc noRef {H2_NOREF}, the finest level of the '
                        'flagship (its one call)',
    'block_near_quad': f'disc noRef {H2_NOREF}, the finest level of the '
                       'flagship (its one call)',
    'tree_csr_quad': 'disc noRef 4, a host-engine build, all calls',
    'cut1d': 'interval noRef 6 (horizon 0.2, sparse), all calls',
    'cut2d_polar': f'square noRef {FH_NOREF} (horizon 0.2, sparse), all its '
                   'calls',
    'csr_scatter': 'the Poisson square at noRef 9: the finest stiffness (its '
                   'one call), per call',
    'gmres_arnoldi': 'the Poisson square at noRef 9: one restart cycle of 10 '
                     'steps and the combine, per cycle',
    'bicgstab_update': 'the Poisson square at noRef 9: 10 iterations',
    'panel_scatter_nonsym': 'interval twoDomainNonSym(0.25,0.75) and '
                            'constantNonSym(0.25): the dense target on all '
                            'calls of the noRef 6 dense builds and the '
                            'largest of noRef 12, the slots target on the '
                            'largest call of the noRef 13 gmres-mg H2 line',
    'h2_matvec_T': 'interval twoDomainNonSym(0.25,0.75): noRef 12, and '
                   'every level of the noRef 13 gmres-mg H2 line, timed on '
                   'the finest, per apply',
}


def log(*a):
    """Print a line; a phase's first line ('phase N: ...') gains the
    seconds since the script started."""
    if a and isinstance(a[0], str) and a[0].startswith('phase ') \
            and a[0].split(':')[0][6:].isdigit():
        a = a + (f'(at {time.perf_counter() - T_START:.1f} s)',)
    print(*a, flush=True)


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, timeout=60)


def slice_argv(noRef, fmt='dense', maxiter=100, solver='cg-jacobi'):
    return ['--domain', 'disc', '--s', 'const(0.75)', '--problem', 'constant',
            '--element', 'P1', '--solverType', solver, '--matrixFormat',
            fmt, '--noRef', str(noRef), '--maxiter', str(maxiter), '--device',
            'cuda']


# ------------------------------------------------------- bound of a kernel

def nbytes(*ts):
    """Bytes of the tensors among ts (tuples are walked)."""
    import torch
    n = 0
    for t in ts:
        if isinstance(t, torch.Tensor):
            n += t.numel() * t.element_size()
        elif isinstance(t, (tuple, list)):
            n += nbytes(*t)
        elif isinstance(t, dict):
            n += nbytes(*t.values())
    return n


def result(err, ms, plain_ms, work, library_ms=None):
    """A kernel's comparison: max abs error, kernel and plain ms, the work
    of the timed calls as [(bytes, operations, peak rate)], one PyTorch
    library call's ms."""
    return {'err': err, 'ms': ms, 'plain_ms': plain_ms, 'work': work,
            'library_ms': library_ms}


def merge(*rs):
    out = result(max(r['err'] for r in rs), sum(r['ms'] for r in rs),
                 sum(r['plain_ms'] for r in rs),
                 [w for r in rs for w in r['work']])
    if all('unweighted_ms' in r for r in rs):
        out['unweighted_ms'] = sum(r['unweighted_ms'] for r in rs)
    return out


def bound(work):
    """(ms, 'bytes' or 'operations'): the least time the card could take
    for the work, per call the larger of its bytes over HBM_RATE (each
    input read once, each output written once) and its operations over
    the peak rate of their type, summed over the calls."""
    tot = byBytes = byOps = 0.0
    for b, ops, peak in work:
        tb, to = b / HBM_RATE * 1e3, ops / peak * 1e3
        tot += max(tb, to)
        if tb >= to:
            byBytes += tb
        else:
            byOps += to
    return tot, ('bytes' if byBytes >= byOps else 'operations')


def target_entries(shape, index):
    """The entries of a K1 or K19 target that the recorded call's local
    entries reach in this run's data, each counted once at most: a dense
    [N, N] target's entries of two dofs >= 0, A_BC's [N, NB] of an interior
    row and a boundary column, CSR data's [nnz+1] of a slot in [0, nnz)
    (explicit int32 slots) or of two dofs >= 0 (tree slots); at most the
    whole target (nnz for CSR data), however many pairs share them."""
    import torch
    from pynucleus_tpu_torch.nl.assembly import DROP
    if index.dtype == torch.int32:
        nnz = shape[0] - 1
        return min(int(((index >= 0) & (index < nnz)).sum()), nnz)
    rows = (index >= 0).sum(1)
    if len(shape) == 1:
        return min(int((rows * rows).sum()), shape[0] - 1)
    cols = rows if shape[0] == shape[1] else \
        ((index < 0) & (index > DROP // 2)).sum(1)
    return min(int((rows * cols).sum()), math.prod(shape))


def panel_work(args, entryBytes=16, peak=F64_PEAK):
    """K1 (any target) on recorded args (the target's shape, vertices, vi1,
    vi2, dofRows or slots, ..., w, PSIP, profile): per pair and node the
    positions, r^2, gamma (one pow, exp or erfc), the normal factor and
    nPSI^2 multiply-adds; inputs read once, the target's entries that the
    call reaches read and written once (target_entries; ``entryBytes`` for
    the read and the write, ``peak`` the rate of the operations' type)."""
    vertices, vi1, vi2, normals = args[1], args[2], args[3], args[6]
    w, PSIP = args[-3], args[-2]
    P, Q, nn, dim = vi1.shape[0], w.shape[0], PSIP.shape[1], \
        vertices.shape[1]
    ops = P * Q * (2 * dim * (vi1.shape[1] + vi2.shape[1]) + 3 * dim + 3
                   + 2 * nn + (3 * dim + 2 if normals is not None else 0))
    return (nbytes(args[1:]) + entryBytes * target_entries(args[0], args[4]),
            ops, peak)


# ----------------------------------------------------------------- phase 2

def timed(fn):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def _clone(a):
    import torch
    if isinstance(a, torch.Tensor):
        return a.clone()
    if isinstance(a, tuple):
        items = tuple(_clone(b) for b in a)
        # a named tuple (the kernels' Profile) keeps its type
        return type(a)(*items) if hasattr(a, '_fields') else items
    if isinstance(a, dict):
        return {k: _clone(v) for k, v in a.items()}
    return a


class ArgRecorder:
    """Replaces a kernel wrapper of a module by one that records cloned
    arguments of every call of the main path (and then makes the call).
    For a kernel that adds into its first argument (``dataFirst``: dense A
    [N, N], A_BC [N, NB] or CSR data [nnz+1]) that one is recorded by its
    shape.  With ``size``, only the call of the largest ``size(*args)`` is
    kept."""

    def __init__(self, module, name, dataFirst=False, size=None):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.dataFirst, self.size = dataFirst, size
        self.calls = []
        self.largest = -1

    def _record(self, args, kw):
        if self.dataFirst:
            args = (tuple(args[0].shape),) + _clone(args[1:])
        else:
            args = _clone(args)
        return args, _clone(kw)

    def __enter__(self):
        def rec(*args, **kw):
            if self.size is None:
                self.calls.append(self._record(args, kw))
            else:
                size = self.size(*args)
                if size > self.largest:
                    self.largest = size
                    self.calls = [self._record(args, kw)]
            return self.orig(*args, **kw)
        setattr(self.module, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


# the H2 build's kernel wrappers (nl.assembly): K1's CSR targets, K6, K5
# and K7 (the flat engine's build), K11-K13 (the block and host engines);
# those of CSR_DATA add into the near data [nnz+1]
H2_CSR = ('panel_scatter_slots', 'panel_scatter_tree', 'near_enum_quad')
H2_BUILD = H2_CSR + ('near_enum', 'far_field')
ENGINE_KERNELS = ('block_near_count', 'block_near_quad', 'tree_csr_quad')
CSR_DATA = H2_CSR + ENGINE_KERNELS[1:]


def record_h2_build(build, names=H2_BUILD, largestOnly=False):
    """Runs ``build()``, an H2 build or a path that makes one, with the
    calls of the wrappers ``names`` recorded; with ``largestOnly`` K5 keeps
    only its largest segment and K6 only its largest order.  Returns (what
    build returned, the recorders)."""
    import contextlib
    import torch
    import pynucleus_tpu_torch.nl.assembly as asm
    sizes = {'near_enum': lambda cum, *a: int(cum[-1]),
             'near_enum_quad': lambda data, ids, *a: ids.shape[0]} \
        if largestOnly else {}
    with contextlib.ExitStack() as stack:
        recs = {n: stack.enter_context(ArgRecorder(
            asm, n, dataFirst=n in CSR_DATA, size=sizes.get(n)))
            for n in names}
        H = build()
    torch.cuda.synchronize()
    return H, recs


def compare_target_kernel(name, calls, kernel, plain, work, dtype=None,
                          csr=True, tol=TOL_KERNEL, perCall=False):
    """Recorded calls of a kernel that adds into its first argument
    (recorded by its shape: dense A, A_BC or CSR data [nnz+1]; with
    ``csr=False`` a vector target is the diagonal [N]) through the kernel
    and through the plain version, the calls of one shape all into one zero
    tensor of ``dtype`` (float64 by default) each way (with ``perCall``
    each call into one of its own: a float32 target's sums round at the
    magnitude the other calls left in it, so calls of different operators
    are not summed there), after an untimed warm-up call of each per
    shape; CSR data compared on its nnz real slots.  Each target is held
    to ``tol`` of its largest entry.  Returns the result() with
    ``work(args)`` of each call's recorded args."""
    import torch
    byShape = {}
    for i, c in enumerate(calls):
        byShape.setdefault((c[0][0], i if perCall else -1), []).append(c)
    dev = next(a.device for a in calls[0][0] if isinstance(a, torch.Tensor))
    worst_abs = worst_rel = ms = plain_ms = 0.0
    warm = set()
    for (shape, _), group in byShape.items():
        Dk = torch.zeros(shape, dtype=dtype or torch.float64, device=dev)
        Dp = torch.zeros_like(Dk)
        (_, *args0), kw0 = group[0]
        if shape not in warm:
            warm.add(shape)
            kernel(torch.zeros_like(Dk), *args0, **kw0)
            plain(torch.zeros_like(Dk), *args0, **kw0)
        for (_, *args), kw in group:
            ms += timed(lambda: kernel(Dk, *args, **kw))
            plain_ms += timed(lambda: plain(Dp, *args, **kw))
        if len(shape) == 1 and csr:
            Dk, Dp = Dk[:-1], Dp[:-1]
        err = float((Dk - Dp).abs().max())
        scale = float(Dp.abs().max())
        if not (scale > 0 and err <= tol * scale):
            raise AssertionError(f'{name}: kernel vs plain max err {err} '
                                 f'(max {scale}) on {shape}')
        worst_abs = max(worst_abs, err)
        worst_rel = max(worst_rel, err / scale)
    log(f'  {name}: {len(calls)} calls on {len(byShape)} targets, max abs '
        f'err {worst_abs:.3e} (rel {worst_rel:.3e}), kernel {ms:.3f} ms, '
        f'plain {plain_ms:.3f} ms')
    return result(worst_abs, ms, plain_ms, [work(c[0]) for c in calls])


def enum_quad_work(args, entryBytes=16, peak=F64_PEAK):
    """K6 on recorded args (nnz+1, ids, pT, ..., vertices, cells, ...,
    w, PSIP, profile): K1's quadrature body per element (two cells), the
    touched entries read and written once (``entryBytes`` for the read and
    the write, ``peak`` the rate of the operations' type)."""
    ids, vertices, cells, w, PSIP = args[1], args[12], args[13], args[-3], \
        args[-2]
    n, Q, nn, dim, nv = ids.shape[0], w.shape[0], PSIP.shape[1], \
        vertices.shape[1], cells.shape[1]
    ops = n * Q * (4 * dim * nv + 3 * dim + 3 + 2 * nn)
    return (nbytes(args[1:]) + entryBytes * n * nn, ops, peak)


def compare_h2_build(recs):
    """K1's CSR targets, K5, K6 and K7 on their recorded calls against
    their plain versions, each after an untimed warm-up call; returns
    {name: result()}."""
    import torch
    import pynucleus_tpu_torch.nl.assembly as asm
    for n in H2_BUILD:
        if not recs[n].calls:
            raise AssertionError(f'{n}: the build made no call of it')
    out = {}
    for n in H2_CSR:
        out[n] = compare_target_kernel(
            n, recs[n].calls, getattr(asm, n), getattr(asm, '_' + n + '_plain'),
            enum_quad_work if n == 'near_enum_quad' else panel_work)

    ms = plain_ms = 0.0
    work = []
    for args, kw in recs['near_enum'].calls:
        T = int(args[0][-1])
        # per element: keys and pT written (5 B), about 45 float32
        # operations of the order model (distance, log, two ceil'd ratios)
        work.append((nbytes(args) + 5 * T + 512, 45 * T, F32_PEAK))
        asm.near_enum(*args), asm._near_enum_plain(*args, T)
        got, ref = [], []
        ms += timed(lambda: got.append(asm.near_enum(*args)))
        plain_ms += timed(lambda: ref.append(asm._near_enum_plain(*args, T)))
        for what, a, b in zip(('keys', 'pT', 'hist'), got[0], ref[0]):
            if not torch.equal(a, b):
                raise AssertionError(f'near_enum: {what} differ from the '
                                     'plain version')
    log(f"  near_enum: {len(recs['near_enum'].calls)} calls, "
        f"{recs['near_enum'].largest if recs['near_enum'].size else 'all'} "
        f'elements, keys, pT and histogram equal, kernel {ms:.3f} ms, plain '
        f'{plain_ms:.3f} ms')
    out['near_enum'] = result(0.0, ms, plain_ms, work)

    out['far_field'] = compare_far_field(recs['far_field'].calls)
    return out


def compare_far_field(calls, label='far_field', tol=TOL_KERNEL):
    """K7 on recorded calls (gi, gj, profile[, order]) against its plain
    version, each after an untimed warm-up call, to ``tol`` of the largest
    entry; per entry r^2 and one profile evaluation (a variable order's
    VO_EVAL_OPS), the blocks written once in the grids' type."""
    import pynucleus_tpu_torch.nl.assembly as asm
    worst = ms = plain_ms = 0.0
    work = []
    for args, kw in calls:
        P, M, dim = args[0].shape
        order = args[3] if len(args) > 3 else kw.get('order')
        f32 = args[0].element_size() == 4
        work.append((nbytes(args[:2]) + args[0].element_size() * P * M * M,
                     P * M * M * (3 * dim + (VO_EVAL_OPS if order is not None
                                             else 1)),
                     F32_PEAK if f32 else F64_PEAK))
        asm.far_field(*args, **kw), asm._far_field_plain(*args, **kw)
        got, ref = [], []
        ms += timed(lambda: got.append(asm.far_field(*args, **kw)))
        plain_ms += timed(lambda: ref.append(asm._far_field_plain(*args,
                                                                  **kw)))
        err = float((got[0] - ref[0]).abs().max())
        scale = float(ref[0].abs().max())
        if not (scale > 0 and err <= tol * scale):
            raise AssertionError(f'{label}: max err {err} (max {scale})')
        worst = max(worst, err)
    log(f"  {label}: {len(calls)} calls, max abs err "
        f'{worst:.3e}, kernel {ms:.3f} ms, plain {plain_ms:.3f} ms')
    return result(worst, ms, plain_ms, work)


# per element of the near field's order model: the cell-pair validity (9
# vertex and 2 dpe node comparisons) and the float32 order (about 45
# operations: distance, log, two ceil'd ratios, the snap)
ENUM_OPS = 60


def block_count_work(args):
    """K11 on recorded args (offI, offJ, n1, n2, I, J, ncArr, cells,
    cellNodes, centers, logh, consts): the tables read once, the counts
    written once; the validity and order model per element."""
    n1, n2 = args[2], args[3]
    T = int((n1.long() * n2.long()).sum())
    return (nbytes(args) + 20 * args[0].shape[0], ENUM_OPS * T, F32_PEAK)


def block_quad_work(args, entryBytes=16, peak=F64_PEAK):
    """K12 on recorded args (nnz+1, pairs, ncArr, cells, cellNodes,
    centers, logh, consts, vertices, vols, dofs, treePos, rules, profile):
    the order model per element; per element of a requested order K1's
    quadrature body (counted by K11's plain version on the same pairs);
    the tables read once, each pair's block(s) read and written once
    (``entryBytes`` for the read and the write; ``peak`` the quadrature's
    rate, the order model's float32)."""
    import pynucleus_tpu_torch.nl.assembly as asm
    pairs, tabs, rules = args[1], args[2:8], args[12]
    cells, vertices, dofs = args[3], args[8], args[10]
    counts = asm._block_near_count_plain(*pairs[:6], *tabs).sum(0)
    nv, dim, nn = cells.shape[1], vertices.shape[1], (2 * dofs.shape[1]) ** 2
    T = int((pairs[2].long() * pairs[3].long()).sum())
    ops = ENUM_OPS * T
    for o, (bx, by, w, PSIP) in rules.items():
        ops += int(counts[o // 2 - 1]) * w.shape[0] * (
            4 * dim * nv + 3 * dim + 3 + 2 * nn)
    nI, nJ, I, J = pairs[12].long(), pairs[13].long(), pairs[4], pairs[5]
    blockEntries = int((nI * nJ * (1 + (I != J).long())).sum())
    return (nbytes(args[1:]) + entryBytes * blockEntries, ops, peak)


def tree_quad_work(args, entryBytes=16, peak=F64_PEAK):
    """K13 on recorded args (nnz+1, c1, c2, I, J, offF, offB, sf,
    vertices, cells, vols, dofs, tables, bary_x, bary_y, w, PSIP,
    profile): K1's quadrature body per element, the touched entries read
    and written once (``entryBytes`` for the read and the write, ``peak``
    the rate of the operations' type)."""
    c1, vertices, cells, w, PSIP = args[1], args[8], args[9], args[-3], \
        args[-2]
    n, Q, nn, dim, nv = c1.shape[0], w.shape[0], PSIP.shape[1], \
        vertices.shape[1], cells.shape[1]
    ops = n * Q * (4 * dim * nv + 3 * dim + 3 + 2 * nn)
    return (nbytes(args[1:]) + entryBytes * n * nn, ops, peak)


def compare_block_count(calls):
    """K11 on its recorded calls against the plain version (counts equal),
    after an untimed call of each; returns (result(), the counts summed
    over the calls by class)."""
    import torch
    import pynucleus_tpu_torch.nl.assembly as asm
    ms = plain_ms = 0.0
    total = 0
    for args, kw in calls:
        asm.block_near_count(*args), asm._block_near_count_plain(*args)
        got, ref = [], []
        ms += timed(lambda: got.append(asm.block_near_count(*args)))
        plain_ms += timed(lambda: ref.append(
            asm._block_near_count_plain(*args)))
        if not torch.equal(got[0], ref[0]):
            raise AssertionError('block_near_count: counts differ from the '
                                 'plain version')
        total = total + ref[0].sum(0).cpu()
    log(f'  block_near_count: {len(calls)} calls, '
        f'{sum(c[0][0].shape[0] for c in calls)} pairs, counts equal (by '
        f'class 2/4/6/8/>8: {total.tolist()}), kernel {ms:.3f} ms, plain '
        f'{plain_ms:.3f} ms')
    return result(0.0, ms, plain_ms,
                  [block_count_work(c[0]) for c in calls]), total.tolist()


def compare_engines(recs, names):
    """Kernels ``names`` among K11-K13 on their recorded calls against
    their plain versions; returns {name: result()}."""
    import pynucleus_tpu_torch.nl.assembly as asm
    out = {}
    for n in names:
        if not recs[n].calls:
            raise AssertionError(f'{n}: the build made no call of it')
    if 'block_near_count' in names:
        out['block_near_count'] = compare_block_count(
            recs['block_near_count'].calls)[0]
    for n, work in (('block_near_quad', block_quad_work),
                    ('tree_csr_quad', tree_quad_work)):
        if n in names:
            out[n] = compare_target_kernel(n, recs[n].calls, getattr(asm, n),
                                        getattr(asm, '_' + n + '_plain'),
                                        work)
    return out


def compare_operators(label, Ha, Hb, seed):
    """Two H2 operators of one mesh from two near-field engines: the
    apply to TOL_ENGINES relative, the near data to TOL_ENGINES of
    max|data|."""
    import torch
    x = torch.randn(Ha.num_rows, dtype=torch.float64, device='cuda',
                    generator=torch.Generator('cuda').manual_seed(seed))
    ya = Ha.matvec(x)
    rel = float(torch.linalg.norm(Hb.matvec(x) - ya) / torch.linalg.norm(ya))
    da, db = Ha.Anear.dataT, Hb.Anear.dataT
    dErr = float((da - db).abs().max() / da.abs().max())
    if not (rel <= TOL_ENGINES and dErr <= TOL_ENGINES):
        raise AssertionError(f'{label}: apply {rel}, near data {dErr} '
                             f'(> {TOL_ENGINES})')
    log(f'  {label}: apply relative error {rel:.3e}, near data {dErr:.3e} '
        f'of max|data| (<= {TOL_ENGINES})')


def h2_matvec_work(H):
    """K8 per apply: x read and y written, the operator's arrays read
    once; the near products, the leaf moments and leaf outputs, the up
    and down transfers and the far blocks (in the operator's type)."""
    A = H.Anear
    b = 2 * A.dataZ.element_size() * H.num_rows + nbytes(
        A.perm, A.rowNode, A.indptrT, A.tStartRow, A.tLen, A.rowLen,
        A.tmplStart, A.tmplAll, A.dataZ, H.leafPhi, H.leafNode, H.Ttr,
        H.parent, H.Kall, H.src, H.dst)
    M = H.M
    ops = 2 * A.nnz + 4 * H.L * H.nbar * M + 4 * M * M * H.nNodes \
        + 2 * M * M * H.Kall.shape[0]
    return (b, ops, F32_PEAK if A.dataZ.element_size() == 4 else F64_PEAK)


def compare_h2_matvec(H, reps=10, label=''):
    """K8: ``reps`` applies of the operator H each way, after one untimed
    apply of each; returns the result() per apply."""
    import torch
    from pynucleus_tpu_torch.nl import h2
    x = torch.randn(H.num_rows, dtype=torch.float64, device='cuda',
                    generator=torch.Generator('cuda').manual_seed(0))
    yk = torch.empty_like(x)
    h2.h2_matvec(H, x, out=yk), h2._h2_matvec_plain(H, x)
    ms = timed(lambda: [h2.h2_matvec(H, x, out=yk) for _ in range(reps)])
    yp = []
    plain_ms = timed(lambda: [yp.append(h2._h2_matvec_plain(H, x))
                              for _ in range(reps)])
    err = float((yk - yp[-1]).abs().max())
    scale = float(yp[-1].abs().max())
    if not (scale > 0 and err <= TOL_KERNEL * scale):
        raise AssertionError(f'h2_matvec: max err {err} (max {scale})')
    log(f'  h2_matvec{label}: {reps} applies, max abs err {err:.3e} (rel '
        f'{err / scale:.3e}), kernel {ms / reps:.3f} ms, plain '
        f'{plain_ms / reps:.3f} ms per apply')
    return result(err, ms / reps, plain_ms / reps, [h2_matvec_work(H)])


def compare_csr_spmv(P, reps=10, dtype=None, extra=()):
    """K9 on a prolongation P and its transpose (and on the operators
    ``extra``): y = A x and y += A x against the plain version; then
    ``reps`` products y = A x each way and through one torch.sparse CSR
    product (the library's yardstick, never used by the port), after an
    untimed call of each.  x is float64, or ``dtype`` (complex128: K9's
    complex variant, the library product on the data cast to it).
    Returns the result() per set of products."""
    import torch
    from pynucleus_tpu_torch.base.linear_operators import (csr_spmv,
                                                           _csr_spmv_plain)
    dtype = dtype or torch.float64
    g = torch.Generator('cuda').manual_seed(2)
    worst = ms = plain_ms = lib_ms = 0.0
    work = []
    for A in (P, P.transposed()) + tuple(extra):
        def vec(n):
            return torch.randn(n, dtype=dtype, device='cuda', generator=g)
        x, y0 = vec(A.num_columns), vec(A.num_rows)
        args = (A.indptr, A.indices, A.data, x)
        for acc in (False, True):
            yk, yp = y0.clone(), y0.clone()
            csr_spmv(*args, out=yk, accumulate=acc)
            _csr_spmv_plain(*args, yp, acc)
            err = float((yk - yp).abs().max())
            scale = float(yp.abs().max())
            if not (scale > 0 and err <= TOL_KERNEL * scale):
                raise AssertionError(f'csr_spmv: max err {err} (max {scale})')
            worst = max(worst, err)
        S = torch.sparse_csr_tensor(A.indptr, A.indices, A.data.to(dtype),
                                    size=A.shape)
        yl = torch.mv(S, x)
        csr_spmv(*args, out=yk)
        if not float((yl - yk).abs().max()) <= \
                TOL_KERNEL * float(yl.abs().max()):
            raise AssertionError('csr_spmv: the library product differs')
        _csr_spmv_plain(*args, yp)
        ms += timed(lambda: [csr_spmv(*args, out=yk)
                             for _ in range(reps)]) / reps
        plain_ms += timed(lambda: [_csr_spmv_plain(*args, yp)
                                   for _ in range(reps)]) / reps
        lib_ms += timed(lambda: [torch.mv(S, x) for _ in range(reps)]) / reps
        # a real product 2 operations an entry, a real entry times a complex
        # value 4, a complex product 8
        opsPerEntry = 2 * (1 + x.is_complex()) * (1 + A.data.is_complex())
        work.append((nbytes(A.indptr, A.indices, A.data, x)
                     + x.element_size() * A.num_rows, opsPerEntry * A.nnz,
                     F64_PEAK))
    log(f'  csr_spmv ({dtype}): P {tuple(P.shape)} and P^T, nnz {P.nnz}'
        + ''.join(f', A {tuple(A.shape)} nnz {A.nnz} ({A.data.dtype})'
                  for A in extra)
        + f', max abs err {worst:.3e}, kernel {ms:.4f} ms, plain '
        f'{plain_ms:.4f} ms, torch.sparse {lib_ms:.4f} ms per set of '
        'products')
    return result(worst, ms, plain_ms, work, lib_ms)


def compare_jacobi_smooth(n, reps=10, dtype=None):
    """K10: its three modes on random vectors [n] (float64, or ``dtype``:
    complex128, the complex variant) against the plain version, ``reps``
    passes of each mode each way after an untimed one; returns the result()
    per set of three passes, with the time of the library call of the
    residual mode, one torch.sub (never used by the port), beside that
    mode's own."""
    import torch
    from pynucleus_tpu_torch.multilevel.gmg import (jacobi_smooth,
                                                    _jacobi_smooth_plain)
    dtype = dtype or torch.float64
    cplx = dtype.is_complex
    g = torch.Generator('cuda').manual_seed(3)
    b, Ax, x0 = (torch.randn(n, dtype=dtype, device='cuda', generator=g)
                 for _ in range(3))
    Dinv = torch.rand(n, dtype=torch.float64, device='cuda', generator=g) \
        + 0.5
    if cplx:
        Dinv = torch.complex(Dinv, torch.rand(n, dtype=torch.float64,
                                              device='cuda', generator=g))
    om = torch.tensor([2.0 / 3.0], dtype=torch.float64, device='cuda')
    worst = ms = plain_ms = 0.0
    work = []
    # vectors read or written, and operations (a complex product 6, a
    # complex sum 2, a real times a complex 2)
    modes = (('zero', 3, 8 if cplx else 2), ('residual', 3, 2 if cplx else 1),
             ('update', 5, 12 if cplx else 4))
    for mode, nvec, ops in modes:
        xk, xp = x0.clone(), x0.clone()
        jacobi_smooth(mode, xk, b, Ax=Ax, Dinv=Dinv, omega=om)
        _jacobi_smooth_plain(mode, xp, b, Ax=Ax, Dinv=Dinv, omega=om)
        err = float((xk - xp).abs().max())
        scale = float(xp.abs().max())
        if not (scale > 0 and err <= TOL_KERNEL * scale):
            raise AssertionError(f'jacobi_smooth ({mode}): max err {err}')
        worst = max(worst, err)
        ms += timed(lambda: [jacobi_smooth(mode, xk, b, Ax=Ax, Dinv=Dinv,
                                           omega=om)
                             for _ in range(reps)]) / reps
        plain_ms += timed(lambda: [_jacobi_smooth_plain(
            mode, xp, b, Ax=Ax, Dinv=Dinv, omega=om)
            for _ in range(reps)]) / reps
        work.append((b.element_size() * nvec * n, ops * n, F64_PEAK))
    torch.sub(b, Ax, out=xp)
    lib_ms = timed(lambda: [torch.sub(b, Ax, out=xp)
                            for _ in range(reps)]) / reps
    res_ms = timed(lambda: [jacobi_smooth('residual', xk, b, Ax=Ax)
                            for _ in range(reps)]) / reps
    log(f'  jacobi_smooth ({dtype}): n {n}, three modes, max abs err '
        f'{worst:.3e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per set; '
        f'residual mode {res_ms:.4f} ms, torch.sub {lib_ms:.4f} ms')
    r = result(worst, ms, plain_ms, work, lib_ms)
    r['residual_ms'] = res_ms
    return r


def grid_distant_work(args, entryBytes=16, peak=F64_PEAK):
    """K2 on recorded args (N, X, ccf, vols, dofs, PhiXw, PhiX, PsiYw, w,
    t_lo, t_hi, profile): per cell pair of the window Q^2 kernel values
    (one pow or exp each) and the two contractions with the dpe shape functions, per
    cell its dpe^2 block; the touched entries read and written once, at
    most the whole target however many pairs share them."""
    import torch
    import pynucleus_tpu_torch.nl.assembly as asm
    X, ccf, dofs, t_lo, t_hi = args[1], args[2], args[4], args[9], args[10]
    nC, Q, dim = X.shape
    dpe = dofs.shape[1]
    d2 = asm._d2f32(ccf, torch.arange(nC, device=ccf.device))
    pairs = int(((d2 >= t_lo) & (d2 < t_hi)).sum())
    ops = pairs * (Q * Q * (3 * dim + 5) + 2 * Q * Q * dpe
                   + 2 * Q * dpe * dpe) + 3 * nC * Q * dpe * dpe
    entries = min((pairs + nC) * dpe * dpe, math.prod(args[0]))
    return (nbytes(args[1:]) + entryBytes * entries, ops, peak)


def grid_boundary_work(args, entryBytes=16, peak=F64_PEAK):
    """K3 on recorded args (N, X, vols, dofs, Ysurf, svolw2, normals,
    exclPtr, exclIdx, PhiXw, PhiX, profile, useNormals): a kernel value (and
    the normal factor) per cell node and surface node not excluded, per
    cell its dpe^2 block."""
    X, dofs, Ysurf, exclIdx, useNormals = args[1], args[3], args[4], \
        args[8], args[12]
    nC, Q1, dim = X.shape
    S, Q2, _ = Ysurf.shape
    dpe = dofs.shape[1]
    evals = (nC * S - exclIdx.numel()) * Q1 * Q2
    ops = evals * (3 * dim + 3 + (3 * dim + 2 if useNormals else 0)) \
        + 3 * nC * Q1 * dpe * dpe
    return (nbytes(args[1:]) + entryBytes * nC * dpe * dpe, ops, peak)


def compare_pcg(name, fns, states, M=None, iters=10, tol=TOL_KERNEL):
    """``iters`` PCG iterations through fns[0] (the kernel) on states[0],
    with A p by the operator ``M[0]`` and, for the general form, the
    preconditioner ``M[1]``; each iteration the plain version fns[1] takes
    the same step from a copy of the kernel's state into states[1] (the
    same inputs: two separate trajectories would drift apart by rounding,
    most where the residual has shrunk), and x, r, p and the history must
    agree after it.  Returns (max abs err, kernel ms, plain ms), the times
    summed over the iterations (the operator's apply is not timed, the
    preconditioner's is)."""
    A, prec = M
    ms = plain_ms = worst = 0.0
    pre = [prec] if prec is not None else []
    for it in range(iters):
        A.matvec(states[0][3], out=states[0][4])
        for vk, vp in zip(*states):
            vp.copy_(vk)
        args = [st[:5] + pre + st[5:] for st in states]
        ms += timed(lambda: fns[0](*args[0], it))
        plain_ms += timed(lambda: fns[1](*args[1], it))
        for what, i in (('x', 0), ('r', 1), ('p', 3), ('hist', -1)):
            vk = states[0][i][:it + 2] if what == 'hist' else states[0][i]
            vp = states[1][i][:it + 2] if what == 'hist' else states[1][i]
            err = float((vk - vp).abs().max())
            scale = float(vp.abs().max())
            if not err <= tol * scale:
                raise AssertionError(f'{name}: {what} max err {err} '
                                     f'(max {scale}) at iteration {it}')
            worst = max(worst, err)
    return worst, ms, plain_ms


def pcg_state(b, z0, extra):
    """PCG start from x = 0: [x, r, z, p, Ap, *extra, scal, hist] with
    z0 = M b given."""
    import torch
    x = torch.zeros_like(b)
    r = b.clone()
    z = z0.clone()
    p = z.clone()
    rz = torch.dot(r, z)
    scal = torch.stack([rz, torch.zeros_like(rz), torch.sqrt(rz)])
    hist = torch.full((12,), float('nan'), dtype=b.dtype, device=b.device)
    hist[0] = scal[2]
    return [x, r, z, p, torch.empty_like(b)] + extra + [scal, hist]


def compare_pcg_forms(A, b, M, label, iters=10):
    """K4's two forms against their plain versions, ``iters`` iterations
    each (fewer than the solve needs: a converged residual is rounding
    noise) with A p of the operator A: the Jacobi form with invD the inverse
    diagonal of M's finest level, the general form with M (a multigrid
    preconditioner, whose K8, K9 and K10 launches are no main path's);
    the general form's time is taken with M = that diagonal (one
    torch.mul), so that it is K4's own.  Returns the merged result()."""
    from pynucleus_tpu_torch.base import solvers
    from pynucleus_tpu_torch.base.linear_operators import \
        Diagonal_LinearOperator
    n = b.shape[0]
    invD = M.levels.Dinvs[-1]
    Mdiag = Diagonal_LinearOperator(invD)
    jac = (solvers.pcg_update, solvers._pcg_update_plain)
    gen = (solvers.pcg_update_prec, solvers._pcg_update_prec_plain)
    # warm-up (Triton compiles the kernels at their first launch)
    for fn in jac:
        w = pcg_state(b, invD * b, [invD])
        A.matvec(w[3], out=w[4])
        fn(*w, 0)
    for fn in gen:
        w = pcg_state(b, M.matvec(b), [])
        A.matvec(w[3], out=w[4])
        fn(*w[:5], M, *w[5:], 0)
    errJ, msJ, plainJ = compare_pcg('pcg_update (Jacobi form)', jac, [
        pcg_state(b, invD * b, [invD]) for _ in range(2)], (A, None), iters)
    errG, _, _ = compare_pcg('pcg_update (general form, CG-MG)', gen, [
        pcg_state(b, M.matvec(b), []) for _ in range(2)], (A, M), iters)
    errD, msG, plainG = compare_pcg('pcg_update (general form)', gen, [
        pcg_state(b, Mdiag.matvec(b), []) for _ in range(2)], (A, Mdiag),
        iters)
    log(f'  pcg_update ({label}): {iters} iterations of each form; Jacobi: '
        f'max abs err {errJ:.3e}, kernel {msJ:.3f} ms, plain {plainJ:.3f} ms; '
        f'general (CG-MG): max abs err {errG:.3e}, timed with M = diag: '
        f'kernel {msG:.3f} ms, plain {plainG:.3f} ms')
    # per iteration, Jacobi: x, r, p, Ap, invD read, x, r, z, p written;
    # general: x, r, p, Ap, z read, x, r, p written
    return merge(result(errJ, msJ, plainJ,
                        [(72 * n, 13 * n, F64_PEAK)] * iters),
                 result(max(errG, errD), msG, plainG,
                        [(64 * n, 12 * n, F64_PEAK)] * iters))


def phase2():
    import numpy as np
    import torch
    import pynucleus_tpu_torch.nl.assembly as asm
    from pynucleus_tpu_torch.nl.problems import fractionalLaplacianProblem
    from pynucleus_tpu_torch.fem.dofmaps import P1_DoFMap
    from pynucleus_tpu_torch.fem.assembly import assembleRHS
    from pynucleus_tpu_torch.nl.discretized import (buildMeshHierarchy,
                                                    buildHierarchy)
    from pynucleus_tpu_torch.multilevel.gmg import multigrid

    log('phase 2: kernels against their plain versions (disc, noRef 4, '
        'dense and H2 builds, the H2 CG-MG hierarchy of noRef 0-4)')
    prob = fractionalLaplacianProblem('disc', 'const(0.75)')
    mesh = prob['mesh']
    for _ in range(4):
        mesh = mesh.refine()
    dm = P1_DoFMap(mesh, prob['tag'], device='cuda')
    with ArgRecorder(asm, 'panel_scatter', dataFirst=True) as k1, \
            ArgRecorder(asm, 'grid_distant', dataFirst=True) as k2, \
            ArgRecorder(asm, 'grid_boundary', dataFirst=True) as k3:
        A = asm.nonlocalBuilder(dm, prob['kernel']).getDense()
    torch.cuda.synchronize()
    # noRef 6 adds an order-6 window (12-node rule), which takes K2's
    # warp-cooperative branch: cover it with the order-6 rule on the
    # order-4 window of noRef 4
    from pynucleus_tpu_torch.fem.quadrature import simplexCompact
    b6, w6 = simplexCompact(6, 2)
    Phi6 = dm.evalPhi(b6)
    (N4, _, ccf, vols, dofs, *_, t_lo, t_hi, prof), _ = k2.calls[-1]

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64,
                               device='cuda')
    k2.calls.append(((
        N4, dev(np.einsum('qk,ckd->cqd', b6, mesh.vertices[mesh.cells])),
        ccf, vols, dofs, dev(Phi6 * w6), dev(Phi6), dev(-Phi6 * w6),
        dev(w6), t_lo, t_hi, prof), {}))
    out = {}
    out['panel_scatter'] = compare_target_kernel(
        'panel_scatter', k1.calls, asm.panel_scatter, asm._panel_scatter_plain,
        panel_work)
    out['grid_distant'] = compare_target_kernel(
        'grid_distant', k2.calls, asm.grid_distant, asm._grid_distant_plain,
        grid_distant_work)
    out['grid_boundary'] = compare_target_kernel(
        'grid_boundary', k3.calls, asm.grid_boundary, asm._grid_boundary_plain,
        grid_boundary_work)

    # K4's two forms (the general one with the V-cycle of the H2 hierarchy
    # of noRef 0-4), K9 on P and P^T of noRef 3 -> 4, K10 at n = 1081, K8
    # on the hierarchy's noRef 0, 1 and 2 operators (1, 10 and 55 dofs)
    b = assembleRHS(dm, prob['rhs'], qOrder=3).data
    n = b.shape[0]
    _, dms, Ps = buildMeshHierarchy(prob['mesh'], 'cg-mg', prob['tag'], 4,
                                    'P1', torch.device('cuda'))
    hier = buildHierarchy(dms, Ps, prob['kernel'], 'cg-mg', 'H2', True)
    mg = multigrid(hier)
    mg.setup()
    compare_pcg_forms(hier[-1]['A'], b, mg.asPreconditioner(), 'noRef 4')
    compare_csr_spmv(hier[-1]['P'])
    compare_jacobi_smooth(n)
    for k in (0, 1, 2):
        compare_h2_matvec(hier[k]['A'], label=f' (noRef {k}, '
                          f'{hier[k]["A"].num_rows} dofs, '
                          f'{hier[k]["A"].nLvl} tree levels)')

    # the H2 kernels at these shapes too (the kernel table holds them at
    # the shapes of phase 6's main path, K11 and K12 at phase 8's), the
    # flat engine's from a flat build, K11 and K12 from a default (block)
    # build, K13 from a host-engine build
    H, recs = record_h2_build(
        lambda: asm.nonlocalBuilder(dm, prob['kernel'], FLAT).getH2())
    compare_h2_build(recs)
    compare_h2_matvec(H)
    _, recs = record_h2_build(
        lambda: asm.nonlocalBuilder(dm, prob['kernel']).getH2(),
        ENGINE_KERNELS[:2])
    compare_engines(recs, ENGINE_KERNELS[:2])
    _, recs = record_h2_build(
        lambda: asm.nonlocalBuilder(dm, prob['kernel'], HOST).getH2(),
        ENGINE_KERNELS[2:])
    out.update(compare_engines(recs, ENGINE_KERNELS[2:]))
    return out


# ------------------------------------------------------------- phases 3-6

def check_against_jax(out, ref):
    """dofs equal, iterations +-1 (the pinned runs' comments say why),
    errors within RTOL_ERRORS of the pinned JAX outputs."""
    res = out['results'].toDict()
    errs = out['errors'].toDict()
    if res['dofs'] != ref['dofs']:
        raise AssertionError(f"dofs {res['dofs']} != {ref['dofs']}")
    if abs(res['iterations'] - ref['iterations']) > 1:
        raise AssertionError(f"iterations {res['iterations']} vs "
                             f"{ref['iterations']} +- 1")
    for label, val in ref['errors'].items():
        got = errs[label]
        if not abs(got - val) <= RTOL_ERRORS * abs(val):
            raise AssertionError(f'{label}: {got} vs JAX {val}')
    log(f"  dofs {res['dofs']}, iterations {res['iterations']}, L2 error "
        f"{errs['L2 error']:.6e}: matches the JAX outputs (dofs, iterations "
        f'+-1, errors within rtol {RTOL_ERRORS})')
    return errs


def phase3():
    from pynucleus_tpu_torch.drivers.runFractional import main
    log('phase 3: dense slice at noRef 5 against the JAX package')
    return check_against_jax(main(slice_argv(5), quiet=True), JAX_NOREF5)


def run_main_path(argv, path, params=None):
    """One run of a main path through the driver (builder ``params`` to
    every level), with every launch count set to 0 just before and read
    just after; each kernel of the path must have launched, an iterative
    solver must have converged."""
    import torch
    from pynucleus_tpu_torch import kernels
    from pynucleus_tpu_torch.drivers.runFractional import main
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.resetLaunches()
    out = main(argv, quiet=True, params=params)
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    counts['device'] = dict(kernels.deviceLaunches)
    peak = torch.cuda.max_memory_allocated()
    res = out['results'].toDict()
    tim = out['timers'].toDict()
    errs = out['errors'].toDict()
    log(f"  dofs {res['dofs']}, iterations {res['iterations']}, assembly "
        f"{tim['assembly seconds']:.3f} s, solve {tim['solve seconds']:.3f} "
        f's, peak device memory {peak / 2**30:.3f} GiB')
    parts = {k[len('assembly '):-len(' seconds')]: round(v, 3)
             for k, v in tim.items()
             if k.startswith('assembly ') and k != 'assembly seconds'}
    if parts:
        log(f'  assembly parts (s): {parts}')
    log(f'  errors: {errs}')
    log(f'  launches: {counts}')
    for k in path:
        if counts[k] <= 0:
            raise AssertionError(f'kernel {k} was not launched by the main '
                                 'path')
    solver = out['solver']
    if hasattr(solver, 'residuals') and (
            not solver.residuals[-1] <= solver.tolerance
            or res['iterations'] >= solver.maxIter):
        raise AssertionError(f'{res["solver"]} did not converge: '
                             f'{solver.residuals[-3:]}')
    for k, v in errs.items():
        if not v == v or v < 0:
            raise AssertionError(f'{k} = {v}')
    return out, counts


def phase4(errs5):
    log('phase 4: dense slice at noRef 6')
    out, counts = run_main_path(slice_argv(6), DENSE_PATH)
    errs = out['errors'].toDict()
    if not errs['L2 error'] < errs5['L2 error']:
        raise AssertionError(f"L2 error {errs['L2 error']} not below noRef 5 "
                             f"{errs5['L2 error']}")
    return counts, errs, out['A'], out['dm']


def phase5(A6, dm6):
    import torch
    from pynucleus_tpu_torch.drivers.runFractional import main
    from pynucleus_tpu_torch.nl.assembly import assembleNonlocal
    from pynucleus_tpu_torch.nl.problems import fractionalLaplacianProblem
    log('phase 5: H2 slice at noRef 5 against the JAX package; H2 against '
        'dense at noRef 6')
    check_against_jax(main(slice_argv(5, 'H2'), quiet=True), JAX_H2_NOREF5)
    kernel = fractionalLaplacianProblem('disc', 'const(0.75)')['kernel']
    H = assembleNonlocal(dm6, kernel, matrixFormat='H2', device='cuda')
    x = torch.randn(dm6.num_dofs, dtype=torch.float64, device='cuda',
                    generator=torch.Generator('cuda').manual_seed(1))
    ref = A6.matvec(x)
    rel = float(torch.linalg.norm(H.matvec(x) - ref) / torch.linalg.norm(ref))
    if not rel <= TOL_H2_DENSE:
        raise AssertionError(f'H2 vs dense at noRef 6: relative error {rel}')
    log(f'  H2 vs dense matvec at noRef 6: relative error {rel:.3e} '
        f'(<= {TOL_H2_DENSE})')
    compare_operators('block vs flat engine at noRef 6', H, assembleNonlocal(
        dm6, kernel, matrixFormat='H2', device='cuda', params=FLAT), 6)


def phase6(errs6):
    """The H2 main path at noRef H2_NOREF, then each of its kernels against
    its plain version at the shapes of that path: K8 on its operator, K1's
    CSR targets, K5 (largest segment), K6 (largest order) and K7 on their
    calls, recorded during the run.  Returns the launch counts, the
    comparisons and the errors."""
    import torch
    log(f'phase 6: H2 slice at noRef {H2_NOREF} (flat near-field engine)')
    (out, counts), recs = record_h2_build(
        lambda: run_main_path(slice_argv(H2_NOREF, 'H2', H2_MAXITER),
                              H2_PATH, FLAT), largestOnly=True)
    errs = out['errors'].toDict()
    if not errs['L2 error'] < errs6['L2 error']:
        raise AssertionError(f"L2 error {errs['L2 error']} not below dense "
                             f"noRef 6 {errs6['L2 error']}")
    H = out['A']
    del out
    log(f'  kernels against their plain versions at the noRef {H2_NOREF} '
        'shapes')
    cmp = {'h2_matvec': compare_h2_matvec(H)}
    del H
    torch.cuda.empty_cache()
    cmp.update(compare_h2_build(recs))
    return counts, cmp, errs


def phase7():
    from pynucleus_tpu_torch.drivers.runFractional import main
    log('phase 7: H2 CG-MG slice at noRef 5 (6 levels) against the JAX '
        'package')
    check_against_jax(main(slice_argv(5, 'H2', MG_MAXITER, 'cg-mg'),
                           quiet=True), JAX_H2_MG_NOREF5)


def phase8(errs6):
    """The flagship: the multigrid main path at noRef H2_NOREF and a warm
    solve, then K4's two forms, K9, K10, and K11 and K12 (their finest
    level's calls, recorded during the run) against their plain versions
    at its finest shapes.  Returns the launch counts and the
    comparisons."""
    import torch
    from pynucleus_tpu_torch.fem.assembly import assembleRHS
    from pynucleus_tpu_torch.nl.problems import fractionalLaplacianProblem
    import pynucleus_tpu_torch.nl.assembly as asm
    log(f'phase 8: the flagship, H2 CG-MG at noRef {H2_NOREF}')
    # K11's and K12's calls of the finest level (the largest) are recorded
    # during the run; a recorded call is cloned, not launched again
    with ArgRecorder(asm, 'block_near_count',
                     size=lambda offI, *a: offI.shape[0]) as k11, \
            ArgRecorder(asm, 'block_near_quad', dataFirst=True,
                        size=lambda data, pairs, *a: pairs[0].shape[0]) \
            as k12:
        out, counts = run_main_path(slice_argv(H2_NOREF, 'H2', MG_MAXITER,
                                               'cg-mg'), MG_PATH)
    errs = out['errors'].toDict()
    tim = out['timers'].toDict()
    ref = errs6['L2 error']
    if not abs(errs['L2 error'] - ref) <= RTOL_ERRORS * ref:
        raise AssertionError(f"L2 error {errs['L2 error']} not within rtol "
                             f'{RTOL_ERRORS} of the CG-Jacobi {ref}')
    hierarchy = out['hierarchy']
    levelS = [tim[f'assembly level {k} seconds']
              for k in range(len(hierarchy))]
    M = out['solver'].prec
    b = torch.randn(M.num_rows, dtype=torch.float64, device='cuda',
                    generator=torch.Generator('cuda').manual_seed(5))
    z = torch.empty_like(b)
    M.matvec(b, out=z)
    perCycle = timed(lambda: [M.matvec(b, out=z) for _ in range(10)]) / 10
    its = out['results'].toDict()['iterations']
    solver, A = out['solver'], hierarchy[-1]['A']
    rhs = assembleRHS(out['dm'], fractionalLaplacianProblem(
        'disc', 'const(0.75)')['rhs'], qOrder=3).data
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.solve(rhs)
    torch.cuda.synchronize()
    tWarm = time.perf_counter() - t0
    log(f"  L2 error {errs['L2 error']:.6e} (CG-Jacobi {ref:.6e}), "
        f'{its} iterations')
    log(f"  assembly {tim['assembly seconds']:.3f} s, per level (s) "
        f"{[round(t, 3) for t in levelS]}; hierarchy set-up "
        f"{tim['hierarchy set-up seconds']:.3f} s; solve "
        f"{tim['solve seconds']:.4f} s (the driver's, cold), "
        f'{tWarm:.4f} s warm ({solver.iterations} iterations)')
    log(f'  V-cycle {perCycle:.3f} ms (CUDA events over 10 cycles)')
    log(f'  kernels against their plain versions at the noRef {H2_NOREF} '
        'shapes')
    P = hierarchy[-1]['P']
    cmp = {'pcg_update': compare_pcg_forms(A, rhs, M, f'noRef {H2_NOREF}'),
           'csr_spmv': compare_csr_spmv(P),
           'jacobi_smooth': compare_jacobi_smooth(P.num_rows)}
    del out, hierarchy, M, solver, A
    torch.cuda.empty_cache()
    cmp['block_near_count'], byClass = compare_block_count(k11.calls)
    log(f'  near-field elements of the finest level: block engine '
        f'{sum(byClass[:4])} (orders 2/4/6/8: {byClass[:4]}), flat engine '
        f'{byClass[4]} (orders > 8)')
    cmp['block_near_quad'] = compare_target_kernel(
        'block_near_quad', k12.calls, asm.block_near_quad,
        asm._block_near_quad_plain, block_quad_work)
    return counts, cmp


def phase9():
    """The host near-field engine through the driver at noRef 5 (a path
    of its own, launch counts reset), held to the pinned JAX outputs; then
    the three engines' operators at noRef 5 agree.  Returns the launch
    counts."""
    from pynucleus_tpu_torch.nl.assembly import assembleNonlocal
    from pynucleus_tpu_torch.nl.problems import fractionalLaplacianProblem
    log('phase 9: H2 slice at noRef 5 on the host near-field engine; the '
        'three engines at noRef 5')
    out, counts = run_main_path(slice_argv(5, 'H2'), HOST_PATH, HOST)
    check_against_jax(out, JAX_H2_NOREF5)
    kernel = fractionalLaplacianProblem('disc', 'const(0.75)')['kernel']
    for engine in ('block', 'flat'):
        H = assembleNonlocal(out['dm'], kernel, matrixFormat='H2',
                             device='cuda', params={'nearEngine': engine})
        compare_operators(f'{engine} vs host engine at noRef 5', H,
                          out['A'], 5)
    return counts


# ---------------------------------------------------------------- phase 10

# operations per unit of the cut-pair kernels (a pow, atan2, sin, cos or
# division counts as one): K14 per node (the clipped interval, y, the
# kernel value, the weight and the 10 upper-triangle multiply-adds); K15
# per x node (its window: 4 atan2, 3 floor-mods, the clips and the sort),
# per ray (angle, cos, sin, 3 ray-edge solves, the ball clip) and per
# radial node of a ray that hits the cell (y, the kernel value, the
# barycentrics and the 21 upper-triangle multiply-adds)
CUT1D_NODE_OPS = 47
CUT2D_XNODE_OPS = 70
CUT2D_RAY_OPS = 77
CUT2D_NODE_OPS = 74


def nonlocal_argv(domain, noRef, fmt, solver, kernelType='constant'):
    return ['--domain', domain, '--kernelType', kernelType, '--horizon',
            '0.2', '--problem', 'poly-Dirichlet', '--element', 'P1',
            '--solverType', solver, '--matrixFormat', fmt, '--noRef',
            str(noRef), '--device', 'cuda']


def run_nonlocal_path(argv, path):
    """One run of the finite-horizon path through runNonlocal, with every
    launch count set to 0 just before and read just after; each kernel of
    the path must have launched, an iterative solver must have
    converged."""
    import torch
    from pynucleus_tpu_torch import kernels
    from pynucleus_tpu_torch.drivers.runNonlocal import main
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.resetLaunches()
    out = main(argv, quiet=True)
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    counts['device'] = dict(kernels.deviceLaunches)
    peak = torch.cuda.max_memory_allocated()
    res = out['results'].toDict()
    tim = out['timers'].toDict()
    errs = out['errors'].toDict()
    log(f"  {' '.join(argv[:2] + argv[10:14])}: dofs {res['dofs']}, "
        f"iterations {res['iterations']}, assembly "
        f"{tim['assembly seconds']:.3f} s, A_BC {tim['A_BC seconds']:.3f} s, "
        f"solve {tim['solve seconds']:.3f} s, peak device memory "
        f'{peak / 2**30:.3f} GiB, L2 error interpolated '
        f"{errs['L2 error interpolated']:.6e}")
    log(f'  launches: {counts}')
    for k in path:
        if counts[k] <= 0:
            raise AssertionError(f'kernel {k} was not launched by the path')
    solver = out['solver']
    if hasattr(solver, 'residuals') and (
            not solver.residuals[-1] <= solver.tolerance
            or res['iterations'] >= solver.maxIter):
        raise AssertionError(f'{res["solver"]} did not converge: '
                             f'{solver.residuals[-3:]}')
    for k, v in errs.items():
        if not v == v or v < 0:
            raise AssertionError(f'{k} = {v}')
    out['peak'] = peak
    return out, counts


def cut1d_work(args, entryBytes=16):
    """K14 on recorded args (shape, target, index, vertices, vi1, vi2,
    vols1, tq, wq, ur, wr, horizon, profile): every (x, y) node product of
    every pair; inputs read once, the 16 entries of a pair (4 for the
    diagonal target, whose nodes need 4 of the 10 multiply-adds) read and
    written once (``entryBytes`` each), at most the whole target."""
    P = args[4].shape[0]
    Q = args[7].shape[0] * args[9].shape[0]
    diag = args[1] == 'diag'
    ops = (CUT1D_NODE_OPS - (12 if diag else 0)) * P * Q
    touched = min((4 if diag else 16) * P, math.prod(args[0]))
    return (nbytes(args[2:]) + entryBytes * touched, ops, F64_PEAK)


def cut2d_work(args, cplx=False, entryBytes=16):
    """K15 on recorded args (shape, target, index, vertices, vi1, vi2,
    vols1, bary_x, wx, thetas, wtheta, rq, wr, horizon, inter, profile): the
    window of every x node, every ray, and the radial nodes of the rays
    that hit the cell in this run's data (counted by the plain version's
    ray part, chunked), with the 21 sums of the triangle at each (the 6 of
    the diagonal for the diagonal target); inputs read once, the 36
    entries of a pair (6 for the diagonal target) read and written once,
    at most the whole target, however many pairs share them
    (``entryBytes`` each).  ``cplx``: the complex variant, with the Bessel
    pair and complex sums at each radial node, and complex entries (16 B
    each way)."""
    import pynucleus_tpu_torch.nl.assembly as asm
    (vertices, vi1, vi2, bary_x, thetas, wtheta, horizon,
     inter) = args[3], args[4], args[5], args[7], args[9], args[10], \
        args[13], args[14]
    P, Qx, Qr = vi1.shape[0], bary_x.shape[1], args[11].shape[0]
    rays = hitRays = 0
    for sl in asm._plainChunks(P, Qx * thetas.shape[0] * 8):
        hits = asm._cut2dRays(vertices, vi1[sl], vi2[sl], bary_x, thetas,
                              wtheta, horizon, inter)[-1]
        rays += hits.numel()
        hitRays += int(hits.sum())
    diag = args[1] == 'diag'
    # the node's 21 multiply-adds (42 operations), twice as many complex
    sums = 6 if diag else 21
    node = CUT2D_NODE_OPS - 42 + (4 if cplx else 2) * sums \
        + (BESSEL_OPS if cplx else 0)
    ops = CUT2D_XNODE_OPS * P * Qx + CUT2D_RAY_OPS * rays \
        + node * hitRays * Qr
    touched = min((6 if diag else 36) * P, math.prod(args[0]))
    return (nbytes(args[2:]) + (32 if cplx else entryBytes) * touched, ops,
            F64_PEAK)


def phase10():
    """The finite-horizon path.  Returns the launch counts of its two paths
    (the interval's sparse patch line, the square at noRef FH_NOREF) and
    the comparisons of K14, K15 and K1's cross target."""
    import torch
    import pynucleus_tpu_torch.nl.assembly as asm
    from pynucleus_tpu_torch.drivers.runNonlocal import main
    log('phase 10: the finite-horizon path (runNonlocal, horizon 0.2)')
    cmp = {}
    countsI = None
    for kernelType, fmt, bnd in INTERVAL_PATCH:
        argv = nonlocal_argv('interval', 6, fmt, 'lu', kernelType)
        if (kernelType, fmt) == ('constant', 'sparse'):
            with ArgRecorder(asm, 'cut1d', dataFirst=True) as k14:
                out, countsI = run_nonlocal_path(argv, INTERVAL_PATH)
        else:
            out = main(argv, quiet=True)
        err = out['errors'].toDict()['L2 error interpolated']
        if not err < bnd:
            raise AssertionError(f'interval {kernelType} {fmt}: L2 error '
                                 f'interpolated {err} >= {bnd}')
        log(f'  interval noRef 6 {kernelType} {fmt} lu: L2 error '
            f'interpolated {err:.3e} (< {bnd})')
    cmp['cut1d'] = compare_target_kernel('cut1d', k14.calls, asm.cut1d,
                                         asm._cut1d_plain, cut1d_work)

    log(f'  the full-width line: square noRef {FH_NOREF}, sparse, cg-mg')
    with ArgRecorder(asm, 'cut2d_polar', dataFirst=True) as k15, \
            ArgRecorder(asm, 'panel_scatter_cross', dataFirst=True) as kx:
        out, countsS = run_nonlocal_path(
            nonlocal_argv('square', FH_NOREF, 'sparse', 'cg-mg'),
            NONLOCAL_PATH)
    res, errs = out['results'].toDict(), out['errors'].toDict()
    tim = out['timers'].toDict()
    ref = JAX_SQUARE_NOREF2
    got = errs['L2 error interpolated']
    if res['dofs'] != ref['dofs'] or \
            abs(res['iterations'] - ref['iterations']) > 1 or \
            not abs(got - ref['L2 error interpolated']) \
            <= RTOL_ERRORS * ref['L2 error interpolated']:
        raise AssertionError(f'square noRef {FH_NOREF}: {res}, {errs} vs '
                             f'JAX {ref}')
    log(f"  square noRef {FH_NOREF} sparse cg-mg: dofs {res['dofs']}, "
        f"iterations {res['iterations']}, L2 error interpolated {got:.7e}: "
        'matches the JAX outputs (dofs, iterations +-1, error within rtol '
        f'{RTOL_ERRORS})')
    for k in range(FH_NOREF + 1):
        parts = {p: round(tim[f'assembly level {k} {p} seconds'], 3)
                 for p in ('classification', 'pattern', 'quadrature')}
        log(f"  level {k}: {out['hierarchy'][k]['A'].num_rows} dofs, nnz "
            f"{out['hierarchy'][k]['A'].nnz}, assembly "
            f"{tim[f'assembly level {k} seconds']:.3f} s (host "
            f"classification {parts['classification']}, host pattern "
            f"{parts['pattern']}, device fill {parts['quadrature']})")
    log(f"  A_BC {tuple(out['A_BC'].shape)} {tim['A_BC seconds']:.3f} s, "
        f"solver set-up {tim['solver set-up seconds']:.3f} s, solve "
        f"{tim['solve seconds']:.4f} s, explicit residual "
        f"{tim['explicit residual']:.3e}, peak device memory "
        f"{out['peak'] / 2**30:.3f} GiB")
    A, dm, kernel = out['A'], out['dm'], out['kernel']
    del out
    torch.cuda.empty_cache()
    D = asm.assembleNonlocal(dm, kernel, matrixFormat='dense',
                             device='cuda')
    x = torch.randn(dm.num_dofs, dtype=torch.float64, device='cuda',
                    generator=torch.Generator('cuda').manual_seed(10))
    ref = D.matvec(x)
    rel = float(torch.linalg.norm(A.matvec(x) - ref) / torch.linalg.norm(ref))
    if not rel <= TOL_KERNEL:
        raise AssertionError(f'sparse vs dense at noRef {FH_NOREF}: {rel}')
    log(f'  sparse vs dense apply at noRef {FH_NOREF}: relative error '
        f'{rel:.3e} (<= {TOL_KERNEL})')
    del A, D
    torch.cuda.empty_cache()
    log(f'  kernels against their plain versions at the noRef {FH_NOREF} '
        'shapes')
    cmp['cut2d_polar'] = compare_target_kernel(
        'cut2d_polar', k15.calls, asm.cut2d_polar, asm._cut2d_polar_plain,
        cut2d_work)
    cmp['panel_scatter_cross'] = compare_target_kernel(
        'panel_scatter_cross (A_BC)', kx.calls, asm.panel_scatter_cross,
        asm._panel_scatter_cross_plain, panel_work)
    return countsI, countsS, cmp


# ---------------------------------------------------------------- phase 11

# JAX package outputs of `drivers/runSerialGMG.py --domain square --noRef
# N`, run on the CPU in float64 (printed to 7 digits): label -> (iterations,
# rate, residual norm); errors L2 and H1_0
SERIAL_LABELS = ('MG', 'FMG', 'CG', 'PCG', 'GMRES', 'PGMRES', 'BICGSTAB',
                 'PBICGSTAB')
JAX_SERIAL = {
    4: {'DoFs': 961, 'Tol': 9.765625e-04,
        'iterations': (5, 4, 8, 3, 5, 3, 3, 1),
        'residuals': (7.453214e-04, 5.298254e-04, 8.871800e-04, 1.794617e-04,
                      8.725642e-04, 1.165668e-04, 7.755684e-04,
                      1.959891e-04),
        'errors': (1.340462e-03, 1.095661e-01)},
    9: {'DoFs': 1046529, 'Tol': 9.536743e-07,
        'iterations': (9, 5, 50, 5, 22, 5, 14, 2),
        'rates': (3.199636e-01, 1.282801e-01, 8.348316e-01, 1.543608e-01,
                  6.565008e-01, 1.042137e-01, 5.158734e-01, 5.563332e-03),
        'residuals': (3.387693e-07, 3.348073e-07, 1.158627e-06, 8.446646e-07,
                      9.187029e-07, 1.184738e-07, 9.111774e-07,
                      2.983109e-07),
        'errors': (1.517652e-06, 3.497728e-03)},
}
SERIAL_NOREF = 9
# the reference's cache (tests/test_gmg.py:36-49, BASELINE.md:19):
# (group, label, value, atol, rtol); iterations exact
SERIAL_CACHE = (('iterations', 'MG', 9, 0, 0),
                ('rates', 'MG', 0.31996358412183235, 1e-2, 0),
                ('residuals', 'MG', 3.387693291422185e-07, 0, 3e-1),
                ('iterations', 'CG', 50, 0, 0),
                ('rates', 'CG', 0.8348286600972041, 1e-2, 0),
                ('residuals', 'PCG', 8.44664592068035e-07, 0, 3e-1),
                ('iterations', 'FMG', 5, 0, 0),
                ('iterations', 'PCG', 5, 0, 0),
                ('errors', 'L^2 error', 1.6442082655606228e-06, 0, 2.0),
                ('errors', 'H^1_0 error', 0.003537410542403111, 0, 2.0))
# rates and residuals of the JAX noRef 9 table within this (the pinned
# values carry 7 digits); errors within TOL_SERIAL_ERRORS above the
# summation floor of their formulas (see check_serial)
TOL_SERIAL = 1e-5
TOL_SERIAL_ERRORS = 1e-6
# except unpreconditioned BiCGStab, whose 14 erratic steps amplify
# rounding: its residual differs from the JAX package's CPU run by 4.1e-5
# relative on an H100 (NVIDIA H100 80GB HBM3, 700 W), while its rate, its
# iterations and every other solver's numbers agree to 3e-6 or better;
# phase 11 measures in every run how far that residual moves when only
# the summation orders change (the dot products, A x's row sums, or all
# of them on the host's CPU)
TOL_SERIAL_LABEL = {'BICGSTAB': 1e-4}
# K18's scalars (rho, alpha, omega, ||r||) against the plain version's,
# each relative to itself
TOL_SCALARS = 1e-8
SERIAL_PATH = ('csr_scatter', 'csr_spmv', 'jacobi_smooth', 'pcg_update',
               'pcg_update:jacobi', 'pcg_update:general', 'gmres_arnoldi',
               'bicgstab_update')


def serial_argv(noRef):
    return ['--domain', 'square', '--noRef', str(noRef), '--device', 'cuda']


def check_serial(out, noRef):
    """The driver's groups against the JAX outputs of JAX_SERIAL[noRef]:
    dofs and iterations equal; at noRef 9 also rates and residuals within
    TOL_SERIAL, the errors within TOL_SERIAL_ERRORS plus the floor
    sqrt(n) eps ex / err^2 of their formulas (sums of n terms of the size
    of the exact norm ex cancel to err^2; the JAX package's CPU dot sums in
    another order), and the reference cache.  Logs every comparison, then
    raises if one failed."""
    import numpy as np
    ref = JAX_SERIAL[noRef]
    g = {k: out[k].toDict() for k in ('info', 'rates', 'iterations',
                                      'residuals', 'errors')}
    bad = []
    if g['info']['DoFs'] != ref['DoFs']:
        bad.append(f"DoFs {g['info']['DoFs']} != {ref['DoFs']}")
    its = [g['iterations']['Number of iterations ' + k]
           for k in SERIAL_LABELS]
    if its != list(ref['iterations']):
        bad.append(f"iterations {its} != JAX {list(ref['iterations'])}")
    log(f"  square noRef {noRef}: {g['info']['DoFs']} dofs, Tol "
        f"{g['info']['Tol']:.6e}; iterations {dict(zip(SERIAL_LABELS, its))}"
        f" (JAX {list(ref['iterations'])})")
    worst = {}
    for group, key in (('rates', 'Rate of convergence '),
                       ('residuals', 'Residual norm ')):
        if group not in ref:
            continue
        rel = [abs(g[group][key + k] - v) / v
               for k, v in zip(SERIAL_LABELS, ref[group])]
        worst[group] = max(rel)
        for k, r in zip(SERIAL_LABELS, rel):
            if r > TOL_SERIAL_LABEL.get(k, TOL_SERIAL):
                bad.append(f'{group} {k}: relative difference {r:.2e} > '
                           f'{TOL_SERIAL_LABEL.get(k, TOL_SERIAL)}')
        log(f'  {group}: ' + ', '.join(
            f'{k} {g[group][key + k]:.6e}' for k in SERIAL_LABELS)
            + f' (largest relative difference from JAX {worst[group]:.2e})')
    n = ref['DoFs']
    eps = float(np.finfo(float).eps)
    for (label, ex), val in zip((('L^2 error', 0.25),
                                 ('H^1_0 error', 2 * np.pi ** 2 / 4)),
                                ref['errors']):
        got = g['errors'][label]
        tol = TOL_SERIAL_ERRORS + np.sqrt(n) * eps * ex / val ** 2
        rel = abs(got - val) / val
        log(f'  {label} {got:.7e} (JAX {val:.6e}, relative difference '
            f'{rel:.2e}, allowed {tol:.2e})')
        if rel > tol:
            bad.append(f'{label}: {got} vs JAX {val} (rtol {tol:.2e})')
    if noRef == SERIAL_NOREF:
        for group, label, val, atol, rtol in SERIAL_CACHE:
            key = label if group == 'errors' else {
                'iterations': 'Number of iterations ',
                'rates': 'Rate of convergence ',
                'residuals': 'Residual norm '}[group] + label
            got = g[group][key]
            if not abs(got - val) <= atol + rtol * abs(val):
                bad.append(f'cache {key}: {got} vs {val}')
        log(f'  the reference cache (tests/test_gmg.py:36-49, BASELINE.md:19):'
            f' {"met" if not any(b.startswith("cache") for b in bad) else "MISSED"}')
    if bad:
        raise AssertionError('runSerialGMG: ' + '; '.join(bad))
    return worst


def scatter_work(args):
    """K16 on recorded args (vals, order, offsets): its inputs read once,
    the data [nnz] written once; one addition per kept contribution."""
    vals, order, offsets = args[:3]
    return (nbytes(vals, order, offsets) + 8 * (offsets.shape[0] - 1),
            order.shape[0], F64_PEAK)


def compare_csr_scatter(dm, reps=10):
    """K16 on the finest level's stiffness (the dofmap dm's local matrices
    and gather order) against its plain version (equal to 1e-12 of the
    largest entry; the same sums in the same order), ``reps`` calls each
    way after an untimed one, and the library yardstick: one index_add_ of
    all contributions into [nnz+1], the dropped ones into the last slot
    (never used by the port).  Returns the result() per call."""
    import torch
    from pynucleus_tpu_torch.fem.assembly import (
        csr_scatter, _csr_scatter_plain, localStiffness, scatterPlan)
    _, _, order, offsets = scatterPlan(dm)
    vals = torch.as_tensor(localStiffness(dm).reshape(-1), device='cuda')
    nnz = offsets.shape[0] - 1
    dk = torch.empty(nnz, dtype=torch.float64, device='cuda')
    dp = torch.empty_like(dk)
    csr_scatter(vals, order, offsets, out=dk)
    _csr_scatter_plain(vals, order, offsets, dp)
    err = float((dk - dp).abs().max())
    scale = float(dp.abs().max())
    if not (scale > 0 and err <= TOL_KERNEL * scale):
        raise AssertionError(f'csr_scatter: max err {err} (max {scale})')
    ms = timed(lambda: [csr_scatter(vals, order, offsets, out=dk)
                        for _ in range(reps)]) / reps
    plain_ms = timed(lambda: [_csr_scatter_plain(vals, order, offsets, dp)
                              for _ in range(reps)]) / reps
    # the flat slot of every contribution (nnz for a dropped one)
    slot = torch.full_like(vals, nnz, dtype=torch.int64)
    slot[order.long()] = torch.repeat_interleave(
        torch.arange(nnz, device='cuda'), (offsets[1:] - offsets[:-1]).long())
    lib = torch.zeros(nnz + 1, dtype=torch.float64, device='cuda')
    lib.index_add_(0, slot, vals)
    libErr = float((lib[:nnz] - dp).abs().max())
    if not libErr <= 1e-10 * scale:
        raise AssertionError(f'csr_scatter: index_add_ differs by {libErr}')
    lib_ms = timed(lambda: [lib.zero_().index_add_(0, slot, vals)
                            for _ in range(reps)]) / reps
    log(f'  csr_scatter: {vals.shape[0]} local entries, {order.shape[0]} '
        f'kept, nnz {nnz}, max abs err {err:.3e}, kernel {ms:.4f} ms, plain '
        f'{plain_ms:.4f} ms, index_add_ {lib_ms:.4f} ms (max difference '
        f'{libErr:.2e}, atomics)')
    return result(err, ms, plain_ms, [scatter_work((vals, order, offsets))],
                  lib_ms)


def _max_err(pairs):
    """Largest absolute difference and largest entry over (kernel, plain)
    tensor pairs."""
    err = max(float((a - b).abs().max()) for a, b in pairs)
    scale = max(float(b.abs().max()) for _, b in pairs)
    return err, scale


def compare_gmres_arnoldi(A, b, restart=10):
    """K17 on one full restart cycle of GMRES on the operator A from x0 =
    0: the start and each of the ``restart`` Arnoldi steps, then the
    combine x0 + V y, each call made by the kernel and by the plain
    version on copies of the same state (the cycle goes on from the
    kernel's), compared to 1e-12 of the largest entry and timed with CUDA
    events; and the combine's library yardstick, one torch.addmv.  In b's
    type: float64, or complex128 (K17's complex variant, complex y).
    Returns the result() per cycle."""
    import numpy as np
    import torch
    from pynucleus_tpu_torch.base import solvers as S
    n = b.shape[0]
    cplx = b.is_complex()
    V = torch.empty((restart + 1, n), dtype=b.dtype, device='cuda')
    h = torch.zeros(restart + 1, dtype=b.dtype, device='cuda')
    guards = torch.tensor([0.0, 1e-300], dtype=torch.float64, device='cuda')
    w = b.clone()
    worst = ms = plain_ms = 0.0
    work = []
    for j in range(-1, restart):
        if j >= 0:
            A.matvec(V[j], out=w)
        guard = guards[:1] if j < 0 else guards[1:]
        Vp, wp, hp = V.clone(), w.clone(), h.clone()
        ms += timed(lambda: S.gmres_arnoldi(V, w, h, j, guard))
        plain_ms += timed(lambda: S._gmres_arnoldi_plain(Vp, wp, hp, j,
                                                         guard))
        err, scale = _max_err(((V[:j + 2], Vp[:j + 2]), (w, wp)))
        herr = float((h[:j + 2] - hp[:j + 2]).abs().max())
        if not (err <= TOL_KERNEL * scale and
                herr <= TOL_KERNEL * float(hp[:j + 2].abs().max())):
            raise AssertionError(f'gmres_arnoldi step {j}: max err {err}, '
                                 f'h {herr}')
        worst = max(worst, err)
        # V[0..j] and w read, w and V[j+1] written (the start: w read,
        # V[0] written); 4 n operations a Gram-Schmidt term, 3 n for the
        # norm and the division (complex: 16 n and 6 n)
        work.append((b.element_size() * n * (j + 4 if j >= 0 else 2),
                     (16 if cplx else 4) * n * (j + 1)
                     + (6 if cplx else 3) * n, F64_PEAK))
    rng = np.random.default_rng(11)
    y = rng.normal(size=restart)
    if cplx:
        y = y + 1j * rng.normal(size=restart)
    y = torch.as_tensor(y, device='cuda')
    x0 = torch.randn(n, dtype=b.dtype, device='cuda',
                     generator=torch.Generator('cuda').manual_seed(12))
    xk, xp = x0.clone(), x0.clone()
    cms = timed(lambda: S.gmres_combine(xk, V, y))
    cplain = timed(lambda: S._gmres_combine_plain(xp, V, y))
    err, scale = _max_err(((xk, xp),))
    if not err <= TOL_KERNEL * scale:
        raise AssertionError(f'gmres_combine: max err {err}')
    worst = max(worst, err)
    Vt = V[:restart].T
    torch.addmv(x0, Vt, y)
    lib_ms = timed(lambda: torch.addmv(x0, Vt, y))
    ms += cms
    plain_ms += cplain
    work.append((b.element_size() * n * (restart + 2),
                 (8 if cplx else 2) * n * restart + (2 if cplx else 1) * n,
                 F64_PEAK))
    log(f'  gmres_arnoldi ({b.dtype}): one cycle of {restart} steps on n {n} '
        '(start, '
        f'steps, combine), max abs err {worst:.3e}, kernel {ms:.4f} ms, plain '
        f'{plain_ms:.4f} ms; combine {cms:.4f} ms, torch.addmv {lib_ms:.4f} '
        'ms')
    r = result(worst, ms, plain_ms, work)
    r.update(combine_ms=cms, combine_library_ms=lib_ms)
    return r


def compare_bicgstab_update(A, b, iters=10):
    """K18 on ``iters`` BiCGStab iterations on the operator A from x0 = 0
    (no preconditioner): each of its calls made by the kernel and by the
    plain version on copies of the same state (the iteration goes on from
    the kernel's), vectors and scalars compared to 1e-12 of their largest
    entry and timed with CUDA events.  In b's type: float64, or complex128
    (K18's complex variant).  Returns the result() per ``iters``
    iterations."""
    import torch
    from pynucleus_tpu_torch.base import solvers as S
    x = torch.zeros_like(b)
    r, r0 = b.clone(), b.clone()
    p, v, s, t = (torch.zeros_like(b) for _ in range(4))
    scal = torch.tensor([1.0, 1.0, 1.0, 1.0, 0.0], dtype=b.dtype,
                        device='cuda')
    n = b.shape[0]
    # inputs read and outputs written once: direction r0, r, p, v -> p;
    # step r0, v, r -> s; update t, s, x, p -> x, r (ph = p, sh = s); a
    # complex multiply-add is four real ones
    nvec = {'direction': 5, 'step': 4, 'update': 6}
    nops = {'direction': 9, 'step': 4, 'update': 10}
    cops = 4 if b.is_complex() else 1
    worst = ms = plain_ms = worstScal = 0.0
    work = []
    for it in range(iters):
        for mode in ('direction', 'step', 'update'):
            if mode == 'step':
                A.matvec(p, out=v)
            elif mode == 'update':
                A.matvec(s, out=t)
            k = [x, r, r0, p, v, s, t, p, s, scal]
            q = [a.clone() for a in k[:7]]
            q = q + [q[3], q[5], scal.clone()]
            ms += timed(lambda: S.bicgstab_update(mode, *k, it))
            plain_ms += timed(lambda: S._bicgstab_update_plain(mode, *q, it))
            err, scale = _max_err(list(zip(k[:7], q[:7])))
            # each scalar is a quotient of dot products that cancel, which
            # the kernel's block sums and torch.dot round differently; the
            # vectors they scale are held to TOL_KERNEL
            serr = float(((k[-1] - q[-1]).abs() / q[-1].abs()).max())
            if not (err <= TOL_KERNEL * scale and serr <= TOL_SCALARS):
                raise AssertionError(f'bicgstab_update ({mode}, {it}): max '
                                     f'err {err}, scalars {serr}')
            worst = max(worst, err)
            worstScal = max(worstScal, serr)
            work.append((b.element_size() * n * nvec[mode],
                         cops * nops[mode] * n, F64_PEAK))
    log(f'  bicgstab_update ({b.dtype}): {iters} iterations on n {n}, max '
        f'abs err {worst:.3e} (scalars: relative {worstScal:.2e}), kernel '
        f'{ms:.4f} ms, plain {plain_ms:.4f} ms (||r|| '
        f'{float(scal[4].real):.3e})')
    return result(worst, ms, plain_ms, work)


def warm_solves(out):
    """Each solve of the driver again, warm (the kernels compiled), timed
    by the host clock to a synchronize: returns {label: seconds}."""
    import torch
    from pynucleus_tpu_torch.base.solvers import solverFactory
    from pynucleus_tpu_torch.drivers.runSerialGMG import SOLVERS
    ml, b = out['ml'], out['b']
    A = out['hierarchy'][-1]['A']
    secs = {}

    def run(label, solve):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        secs[label] = time.perf_counter() - t0
    for cycle, label in (('V', 'MG'), ('FMG_V', 'FMG')):
        ml.cycle = cycle
        run(label, lambda: ml.solve(b))
    for name, label, restarts in SOLVERS:
        for prefix in ('', 'P'):
            s = solverFactory.build(name, A=A, setup=True)
            s.tolerance = ml.tolerance
            s.maxIter = ml.maxIter // 5 if name == 'gmres' else ml.maxIter
            if name == 'gmres':
                s.restarts = restarts
            if prefix:
                s.setPreconditioner(ml.asPreconditioner())
            run(prefix + label, lambda: s.solve(b))
    return secs


class LibraryCSR:
    """The CSR operator A applied by one torch.sparse CSR product (another
    order of each row's sum than K9's); a yardstick, never used by the
    port."""

    def __init__(self, A):
        import torch
        self.S = torch.sparse_csr_tensor(A.indptr, A.indices, A.data,
                                         size=A.shape)
        self.num_rows, self.num_columns = A.shape

    def matvec(self, x, out=None):
        import torch
        y = torch.mv(self.S, x)
        return y if out is None else out.copy_(y)


def bicgstab_spread(out):
    """Unpreconditioned BiCGStab as in the driver four ways: through K18
    and K9 (the port), through K18's plain version (other orders of the
    dot products), with A x by a torch.sparse product (another order of
    each row's sum), and on the host's CPU (the plain versions: the CPU's
    blocked dot products and sequential row sums, less accurate sums of a
    million terms, as the JAX package's CPU run takes).  Returns the final
    residuals ||b - A x|| of the four and the relative spread of the last
    three from the first."""
    import torch
    from pynucleus_tpu_torch.base import solvers as S
    from pynucleus_tpu_torch.base.linear_operators import CSR_LinearOperator
    ml, b = out['ml'], out['b']
    A = out['hierarchy'][-1]['A']
    Ah = CSR_LinearOperator(A.indptrH, A.indicesH, A.dataH,
                            num_columns=A.num_columns, device='cpu')
    res = []
    for fn, op, rhs in ((S.bicgstab_update, A, b),
                        (S._bicgstab_update_plain, A, b),
                        (S.bicgstab_update, LibraryCSR(A), b),
                        (S.bicgstab_update, Ah, b.cpu())):
        orig, S.bicgstab_update = S.bicgstab_update, fn
        try:
            s = S.bicgstab_solver(op)
            s.tolerance, s.maxIter = ml.tolerance, ml.maxIter
            x = s.solve(rhs)
        finally:
            S.bicgstab_update = orig
        res.append(float(torch.linalg.norm(b - A.matvec(x.to(b.device)))))
    return res, [abs(r - res[0]) / res[0] for r in res[1:]]


def phase11():
    """The serial multigrid path (drivers/runSerialGMG.py): the square at
    noRef 4 against the JAX outputs; the full-width line at noRef
    SERIAL_NOREF (launch counts reset just before it) against the JAX
    outputs and the reference cache, with its set-up parts, K16 per level,
    the solves, a V-cycle and the peak memory; then K16, K17 and K18
    against their plain versions at its shapes.  Returns the launch counts
    and the comparisons."""
    import torch
    from pynucleus_tpu_torch import kernels
    from pynucleus_tpu_torch.drivers.runSerialGMG import main
    log('phase 11: the serial multigrid path (runSerialGMG, the Poisson '
        'square)')
    check_serial(main(serial_argv(4), quiet=True), 4)
    log(f'  the full-width line: square noRef {SERIAL_NOREF}')
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.resetLaunches()
    t0 = time.perf_counter()
    out = main(serial_argv(SERIAL_NOREF), quiet=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.launches)
    counts['device'] = dict(kernels.deviceLaunches)
    peak = torch.cuda.max_memory_allocated()
    log(f'  launches: {counts}')
    for k in SERIAL_PATH:
        if counts[k] <= 0:
            raise AssertionError(f'kernel {k} was not launched by the path')
    tim = out['timers'].toDict()
    nLvl = len(out['hierarchy'])
    log(f'  {nLvl} levels, the driver {wall:.3f} s, peak device memory '
        f'{peak / 2**30:.3f} GiB')
    log('  host set-up (s): ' + ', '.join(
        f'{k[:-len(" seconds")]} {v:.3f}' for k, v in tim.items()
        if k.endswith(' seconds') and not k.startswith(('level ', 'solve '))))
    for part in ('local', 'pattern', 'scatter order'):
        log(f'  {part} (host s) per level: '
            f"{[round(tim[f'level {k} {part} seconds'], 3) for k in range(nLvl)]}")
    log('  K16 csr_scatter (device ms, CUDA events) per level: '
        f"{[round(tim[f'level {k} scatter seconds'] * 1e3, 4) for k in range(nLvl)]}")
    log('  solves (s): ' + ', '.join(
        f"{k} {tim[f'solve {k} seconds']:.4f}" for k in SERIAL_LABELS))
    secs = warm_solves(out)
    log('  warm solves (s): ' + ', '.join(f'{k} {v:.4f}'
                                          for k, v in secs.items()))
    res, spread = bicgstab_spread(out)
    log(f'  BICGSTAB residual through K18 and K9 {res[0]:.7e}; through '
        f"K18's plain version {res[1]:.7e} (relative {spread[0]:.2e}); "
        f'with A x by torch.sparse {res[2]:.7e} (relative {spread[1]:.2e}); '
        f'on the host CPU {res[3]:.7e} (relative {spread[2]:.2e})')
    worst = check_serial(out, SERIAL_NOREF)
    ml, b, dm = out['ml'], out['b'], out['dm']
    hierarchy, tol = out['hierarchy'], ml.tolerance
    A = hierarchy[-1]['A']
    M = ml.asPreconditioner()
    z = torch.empty_like(b)
    M.matvec(b, out=z)
    perCycle = timed(lambda: [M.matvec(b, out=z) for _ in range(10)]) / 10
    log(f'  V-cycle (2+2 sweeps, {nLvl} levels) {perCycle:.3f} ms (CUDA '
        'events over 10 cycles)')
    del out, ml, M, z
    torch.cuda.empty_cache()
    log(f'  kernels against their plain versions at the noRef '
        f'{SERIAL_NOREF} shapes')
    cmp = {'csr_scatter': compare_csr_scatter(dm),
           'gmres_arnoldi': compare_gmres_arnoldi(A, b),
           'bicgstab_update': compare_bicgstab_update(A, b)}
    summary = {'dofs': A.num_rows, 'levels': nLvl, 'wall_s': wall,
               'peak_GiB': peak / 2**30, 'vcycle_ms': perCycle,
               'largest_rel_diff': worst, 'bicgstab_spread': spread,
               'warm_solve_s': secs}
    log(f'  summary: {json.dumps(summary)}')
    return counts, cmp, {'dm': dm, 'A': A, 'hierarchy': hierarchy, 'b': b,
                         'tol': tol}


# ---------------------------------------------------------------- phase 12

# JAX package outputs of `drivers/runFractional.py --domain interval --s
# 'const(0.75)' --problem constant --element P1 --solverType lu
# --matrixFormat H2` (default noRef 6, 127 dofs) and of the same line with
# --solverType cg-mg (7 levels, every one H2), run on the CPU in float64.
# The port's near data equal the JAX package's to 1e-15 of max|data| there
# (tests/test_torch_interval_h2.py), so the errors are held to
# TOL_INTERVAL_JAX relative.
JAX_INTERVAL_LU = {
    'dofs': 127, 'iterations': 1,
    'errors': {'L2 error': 0.0014601356600079179,
               'relative L2 error': 0.00178829366113067,
               'L2 error interpolated': 0.0010913476899855,
               'relative interpolated L2 error': 0.0013367044777926175,
               'Linf error interpolated': 0.000987510692509408,
               'relative interpolated Linf error': 0.0013127378473115044,
               'Hs error': 0.04187962925463276,
               'relative Hs error': 0.040269522411370114}}
JAX_INTERVAL_MG = {
    'dofs': 127, 'iterations': 3,
    'errors': {'L2 error': 0.0014601358642015285,
               'L2 error interpolated': 0.0010913478773632536,
               'Hs error': 0.04187962925529021}}
TOL_INTERVAL_JAX = 1e-6
# the reference cache of the lu line (tests/test_drivers_fractional.py:95-98)
INTERVAL_H2_CACHE = {'Hs error': 0.041849732677658555,
                     'L2 error': 0.001458788789368659,
                     'L2 error interpolated': 0.001089628333551184,
                     'Linf error interpolated': 0.0009871148528776685}
# runNonlocal's smooth lines (lu, H2, fullSpace, default noRef 8, 511
# dofs): flags, the reference cache (tests/test_nonlocal_driver.py:83-104)
# and the JAX package's output (CPU, float64) of 'L2 error interpolated'
SMOOTH_LINES = {
    'gaussian': (['--kernelType', 'gaussian', '--problem', 'gaussian',
                  '--gaussianVariance', '0.1'], 2.9565447289171816e-03,
                 2.9352268303818796e-03),
    'exponential': (['--kernelType', 'exponential', '--problem',
                     'exponential', '--exponentialRate', '8.0'],
                    2.5530396949181036e-04, 2.545126451525732e-04)}
# the square with the gaussian kernel (runNonlocal, lu, H2, fullSpace,
# variance 0.1) at noRef 3, 225 dofs, for the 2D profiles: the gaussian
# and its boundary form C exp(-a r2) / (2 a r); the JAX package's output
# (CPU, float64) of 'L2 error interpolated' (no reference cache holds the
# square).  The 2D exponential kernel (rate 8, scaling 0.7: it has no
# normalization in 2D) and its boundary form on the same mesh, built
# through the library.
SQUARE_NOREF = 3
JAX_SQUARE_GAUSSIAN = 41.68066922312951
SQUARE_EXPONENTIAL = {'exponentialRate': 8.0, 'scaling': 0.7}
# the interval's full-width CG-MG line (16 until phase 25 came, PERF.md
# section 4)
INTERVAL_NOREF = 15
INTERVAL_CHECK_NOREF = 12
SMOOTH_NOREF = 14
INTERVAL_LU_PATH = ('panel_scatter', 'near_enum', 'near_enum_quad',
                    'far_field', 'h2_matvec', 'block_near_count',
                    'block_near_quad', 'panel_scatter:slots',
                    'panel_scatter:tree')
SMOOTH_CG_PATH = INTERVAL_LU_PATH + ('pcg_update', 'pcg_update:jacobi')
# the kernels of this slice, held with the smooth profiles (and K1, K5-K7,
# K11, K12 at the full-width line's shapes), and the solve's kernels K4,
# K8, K9, K10 at the full-width line's shapes, in the kernel table's
# 'at_interval'
INTERVAL_KERNELS = ('panel_scatter', 'grid_distant', 'grid_boundary',
                    'near_enum', 'near_enum_quad', 'far_field',
                    'block_near_count', 'block_near_quad', 'tree_csr_quad',
                    'pcg_update', 'h2_matvec', 'csr_spmv', 'jacobi_smooth')
INTERVAL_COMPARED_AT = (
    'interval: the gaussian (variance 0.1) and exponential (rate 8) lines '
    'at noRef 8 (all calls of their H2 builds; K13 a host-engine build, K1 '
    'dense, K2 and K3 a dense build), the 2D boundary profiles on the '
    'square (K1 tree and dense targets, K3, K7), and K1, K5-K7, K11, K12 '
    f'the largest call of the fractional CG-MG line at noRef {INTERVAL_NOREF}; '
    f'on that line K8 on each of its levels (timed on the finest, per '
    'apply), K9 on the finest prolongation, K10 at the finest size, K4 '
    'one iteration fewer than the solve took, each form, with its V-cycle')


def interval_argv(noRef, solver):
    return ['--domain', 'interval', '--s', 'const(0.75)', '--problem',
            'constant', '--element', 'P1', '--solverType', solver,
            '--matrixFormat', 'H2', '--noRef', str(noRef), '--maxiter',
            str(MG_MAXITER), '--device', 'cuda']


def smooth_argv(kind, noRef, solver='lu', domain='interval'):
    return ['--domain', domain] + SMOOTH_LINES[kind][0] + [
        '--interaction', 'fullSpace', '--horizon', 'inf', '--solverType',
        solver, '--matrixFormat', 'H2', '--noRef', str(noRef), '--device',
        'cuda']


def check_interval_jax(out, ref, label):
    """dofs and iterations equal, errors within TOL_INTERVAL_JAX of the
    pinned JAX outputs."""
    res, errs = out['results'].toDict(), out['errors'].toDict()
    bad = [f"{k}: {errs[k]} vs JAX {v}" for k, v in ref['errors'].items()
           if not abs(errs[k] - v) <= TOL_INTERVAL_JAX * abs(v)]
    if res['dofs'] != ref['dofs'] or res['iterations'] != ref['iterations']:
        bad.append(f"dofs {res['dofs']}, iterations {res['iterations']} vs "
                   f"JAX {ref['dofs']}, {ref['iterations']}")
    if bad:
        raise AssertionError(f'{label}: ' + '; '.join(bad))
    log(f"  {label}: dofs {res['dofs']}, iterations {res['iterations']}, "
        f"L2 error {errs['L2 error']:.9e}: the JAX outputs (errors within "
        f'rtol {TOL_INTERVAL_JAX})')
    return errs


def compare_smooth_builds(kind, domain='interval'):
    """The kernels of this slice with the ``kind`` profile on the card
    against their plain versions, at the shapes of its smooth line (the
    interval at noRef 8, or the square at SQUARE_NOREF, held to its pinned
    JAX output): K1's CSR targets, K5, K6, K7, K11 and K12 on the recorded
    calls of the line's run (launch counts reset just before it: a path
    of its own), then compare_profile_builds on its mesh.  Returns (the
    launch counts, {name: result()}, (dofmap, kernel))."""
    noRef = 8 if domain == 'interval' else SQUARE_NOREF
    (out, counts), recs = record_h2_build(
        lambda: run_nonlocal_path(smooth_argv(kind, noRef, domain=domain),
                                  INTERVAL_LU_PATH),
        H2_BUILD + ENGINE_KERNELS[:2])
    errs = out['errors'].toDict()
    got = errs['L2 error interpolated']
    if domain == 'interval':
        _, cache, jaxErr = SMOOTH_LINES[kind]
        ok = abs(got - cache) <= RTOL_ERRORS * cache
        what = f'the reference cache {cache:.7e} (rtol {RTOL_ERRORS}) and '
    else:
        jaxErr, ok, what = JAX_SQUARE_GAUSSIAN, True, ''
    if not (ok and abs(got - jaxErr) <= TOL_INTERVAL_JAX * jaxErr):
        raise AssertionError(f'{kind} {domain} line: L2 error interpolated '
                             f'{got} vs {what}JAX {jaxErr} (rtol '
                             f'{TOL_INTERVAL_JAX})')
    log(f'  {kind} {domain} noRef {noRef} lu H2: L2 error interpolated '
        f'{got:.9e}: {what}the JAX output (rtol {TOL_INTERVAL_JAX})')
    dm, kernel = out['dm'], out['kernel']
    del out
    log(f'  kernels against their plain versions, {kind} profile')
    cmp = compare_h2_build(recs)
    cmp.update(compare_engines(recs, ENGINE_KERNELS[:2]))
    return counts, compare_profile_builds(dm, kernel, cmp), (dm, kernel)


def compare_profile_builds(dm, kernel, cmp=None):
    """The kernels that evaluate ``kernel``'s profiles (its own and its
    boundary kernel's) against their plain versions on the dofmap dm: K13
    on a host-engine build, K1's dense target, K2 and K3 on a dense build
    (in 2D K3 without its exclusions);
    without ``cmp`` (the comparisons of a recorded driver run) also K1's
    CSR targets, K5-K7, K11 and K12 on a default H2 build.  Returns
    {name: result()}, K1's targets merged."""
    import torch
    import pynucleus_tpu_torch.nl.assembly as asm
    if cmp is None:
        _, recs = record_h2_build(
            lambda: asm.assembleNonlocal(dm, kernel, matrixFormat='H2',
                                         device='cuda'),
            H2_BUILD + ENGINE_KERNELS[:2])
        cmp = compare_h2_build(recs)
        cmp.update(compare_engines(recs, ENGINE_KERNELS[:2]))
    _, recs = record_h2_build(
        lambda: asm.assembleNonlocal(dm, kernel, matrixFormat='H2',
                                     device='cuda', params=HOST),
        ENGINE_KERNELS[2:])
    cmp.update(compare_engines(recs, ENGINE_KERNELS[2:]))
    with ArgRecorder(asm, 'panel_scatter', dataFirst=True) as k1, \
            ArgRecorder(asm, 'grid_distant', dataFirst=True) as k2, \
            ArgRecorder(asm, 'grid_boundary', dataFirst=True) as k3:
        asm.assembleNonlocal(dm, kernel, matrixFormat='dense',
                             device='cuda')
    torch.cuda.synchronize()
    k3calls = k3.calls
    if kernel.dim == 2:
        # the smooth 2D kernels send every cell-surface pair to K1 (orders
        # above 4), so K3 adds nothing there: it is held on those calls
        # with their exclusion lists (exclPtr, exclIdx) emptied
        k3calls = [(a[:7] + (torch.zeros_like(a[7]), a[8][:0]) + a[9:], kw)
                   for a, kw in k3calls]
    for name, calls, work in (('panel_scatter', k1.calls, panel_work),
                              ('grid_distant', k2.calls, grid_distant_work),
                              ('grid_boundary', k3calls, grid_boundary_work)):
        cmp[name] = compare_target_kernel(
            f'{name} ({kernel}, dense)', calls, getattr(asm, name),
            getattr(asm, '_' + name + '_plain'), work)
    cmp['panel_scatter'] = merge(cmp['panel_scatter'],
                                 cmp.pop('panel_scatter_slots'),
                                 cmp.pop('panel_scatter_tree'))
    return cmp


def phase12():
    """The interval in H2 and the smooth kernels: the reference line
    against the cache and the JAX outputs, the kernels of this slice with
    the gaussian and exponential profiles against their plain versions,
    the gaussian at noRef SMOOTH_NOREF, H2 against dense at noRef
    INTERVAL_CHECK_NOREF and the full-width line, CG-MG at noRef
    INTERVAL_NOREF, with its kernels against their plain versions at its
    shapes.  Returns the launch counts of its paths and the comparisons."""
    import contextlib
    import numpy as np
    import torch
    import pynucleus_tpu_torch.nl.assembly as asm
    from pynucleus_tpu_torch.drivers.runFractional import main
    from pynucleus_tpu_torch.fem.assembly import assembleRHS
    from pynucleus_tpu_torch.nl.kernels import getIntegrableKernel
    from pynucleus_tpu_torch.nl.problems import fractionalLaplacianProblem
    prob = fractionalLaplacianProblem('interval', 'const(0.75)')
    log('phase 12: the interval in H2 (runFractional) and the gaussian and '
        'exponential kernels (runNonlocal)')
    counts = {}
    out, counts['lu'] = run_main_path(interval_argv(6, 'lu'),
                                      INTERVAL_LU_PATH)
    errs = check_interval_jax(out, JAX_INTERVAL_LU, 'interval noRef 6 lu H2')
    bad = [k for k, v in INTERVAL_H2_CACHE.items()
           if not abs(errs[k] - v) <= RTOL_ERRORS * v]
    if bad:
        raise AssertionError(f'interval lu H2: {bad} miss the reference '
                             'cache')
    log(f'  the reference cache (tests/test_drivers_fractional.py:95-98): '
        f'met (rtol {RTOL_ERRORS})')
    check_interval_jax(main(interval_argv(6, 'cg-mg'), quiet=True),
                       JAX_INTERVAL_MG, 'interval noRef 6 cg-mg H2')

    byProfile = {}
    for kind in SMOOTH_LINES:
        counts[kind], byProfile[kind], _ = compare_smooth_builds(kind)
    # the 2D profile codes: the gaussian square line, then the exponential
    # kernel on its mesh
    counts['square'], byProfile['square'], (dm, _) = compare_smooth_builds(
        'gaussian', 'square')
    kExp = getIntegrableKernel(2, 'exponential', np.inf,
                               **SQUARE_EXPONENTIAL)
    log(f'  {kExp} and its boundary kernel on the square at noRef '
        f'{SQUARE_NOREF}: the kernels against their plain versions')
    byProfile['square exponential'] = compare_profile_builds(dm, kExp)
    del dm
    out, counts['gaussian14'] = run_nonlocal_path(
        smooth_argv('gaussian', SMOOTH_NOREF, 'cg-jacobi'), SMOOTH_CG_PATH)
    g14 = out['errors'].toDict()['L2 error interpolated']
    log(f"  gaussian noRef {SMOOTH_NOREF} cg-jacobi H2: dofs "
        f"{out['results'].toDict()['dofs']}, L2 error interpolated "
        f'{g14:.6e} (noRef 8: {SMOOTH_LINES["gaussian"][2]:.6e}; the '
        'solution is exact only up to the zero Dirichlet data)')
    del out
    torch.cuda.empty_cache()

    log(f'  H2 against dense at noRef {INTERVAL_CHECK_NOREF}, and its CG-MG '
        'error')
    outC = main(interval_argv(INTERVAL_CHECK_NOREF, 'cg-mg'), quiet=True)
    errC = outC['errors'].toDict()['L2 error']
    H, dm = outC['A'], outC['dm']
    del outC
    D = asm.assembleNonlocal(dm, prob['kernel'], matrixFormat='dense',
                             device='cuda')
    x = torch.randn(dm.num_dofs, dtype=torch.float64, device='cuda',
                    generator=torch.Generator('cuda').manual_seed(12))
    ref = D.matvec(x)
    rel = float(torch.linalg.norm(H.matvec(x) - ref) / torch.linalg.norm(ref))
    if not rel <= TOL_H2_DENSE:
        raise AssertionError(f'interval H2 vs dense at noRef '
                             f'{INTERVAL_CHECK_NOREF}: {rel}')
    log(f'  {dm.num_dofs} dofs: H2 vs dense apply relative error {rel:.3e} '
        f'(<= {TOL_H2_DENSE}); CG-MG L2 error {errC:.6e}')
    del H, D, dm
    torch.cuda.empty_cache()

    log(f'  the full-width line: interval noRef {INTERVAL_NOREF}, H2 CG-MG')
    recNames = {'block_near_count': (lambda offI, *a: offI.shape[0], False),
                'block_near_quad': (lambda data, pairs, *a: pairs[0].shape[0],
                                    True),
                'near_enum': (lambda cum, *a: int(cum[-1]), False),
                'near_enum_quad': (lambda data, ids, *a: ids.shape[0], True),
                'far_field': (lambda gi, *a: gi.shape[0], False),
                'panel_scatter_slots': (lambda d, v, vi1, *a: vi1.shape[0],
                                        True),
                'panel_scatter_tree': (lambda d, v, vi1, *a: vi1.shape[0],
                                       True)}
    with contextlib.ExitStack() as stack:
        recs = {n: stack.enter_context(ArgRecorder(asm, n, dataFirst=df,
                                                   size=size))
                for n, (size, df) in recNames.items()}
        out, counts['mg16'] = run_main_path(
            interval_argv(INTERVAL_NOREF, 'cg-mg'), MG_PATH)
    errs = out['errors'].toDict()
    if not errs['L2 error'] < errC:
        raise AssertionError(f"noRef {INTERVAL_NOREF} L2 error "
                             f"{errs['L2 error']} not below noRef "
                             f'{INTERVAL_CHECK_NOREF} {errC}')
    hierarchy, tim = out['hierarchy'], out['timers'].toDict()
    for k in range(len(hierarchy)):
        parts = out['levelParts'][k]
        log(f"  level {k}: {hierarchy[k]['A'].num_rows} dofs, assembly "
            f"{tim[f'assembly level {k} seconds']:.3f} s: " + ', '.join(
                f'{p} {v:.3f}' for p, v in parts.items()))
    M = out['solver'].prec
    b = torch.randn(M.num_rows, dtype=torch.float64, device='cuda',
                    generator=torch.Generator('cuda').manual_seed(13))
    z = torch.empty_like(b)
    M.matvec(b, out=z)
    perCycle = timed(lambda: [M.matvec(b, out=z) for _ in range(10)]) / 10
    solver, dm = out['solver'], out['dm']
    rhs = assembleRHS(dm, prob['rhs'], qOrder=3).data
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.solve(rhs)
    torch.cuda.synchronize()
    tWarm = time.perf_counter() - t0
    summary = {'dofs': dm.num_dofs, 'levels': len(hierarchy),
               'iterations': out['results'].toDict()['iterations'],
               'L2_error': errs['L2 error'],
               'L2_error_noRef12': errC,
               'assembly_s': tim['assembly seconds'],
               'solve_s': tim['solve seconds'], 'warm_solve_s': tWarm,
               'vcycle_ms': perCycle,
               'peak_GiB': torch.cuda.max_memory_allocated() / 2 ** 30}
    log(f'  summary: {json.dumps(summary)}')
    log(f'  kernels against their plain versions at the noRef '
        f'{INTERVAL_NOREF} shapes (the largest call of each; K8 on every '
        'level of the hierarchy, timed on the finest)')
    A, P = hierarchy[-1]['A'], hierarchy[-1]['P']
    k8 = [compare_h2_matvec(lv['A'], reps=10 if k == len(hierarchy) - 1
                            else 1, label=f' level {k}')
          for k, lv in enumerate(hierarchy)]
    mg = {'h2_matvec': dict(k8[-1], err=max(r['err'] for r in k8)),
          'csr_spmv': compare_csr_spmv(P),
          'jacobi_smooth': compare_jacobi_smooth(P.num_rows),
          'pcg_update': compare_pcg_forms(
              A, rhs, M, f'interval noRef {INTERVAL_NOREF}',
              iters=out['results'].toDict()['iterations'] - 1)}
    del out, hierarchy, M, solver, z, A, P
    torch.cuda.empty_cache()
    mg.update(compare_h2_build(recs))
    mg['block_near_count'] = compare_block_count(
        recs['block_near_count'].calls)[0]
    mg['block_near_quad'] = compare_target_kernel(
        'block_near_quad', recs['block_near_quad'].calls,
        asm.block_near_quad, asm._block_near_quad_plain, block_quad_work)
    mg['panel_scatter'] = merge(mg.pop('panel_scatter_slots'),
                                mg.pop('panel_scatter_tree'))
    # per kernel: the smooth profiles' comparisons and the full-width line's
    cmp = {}
    for name in INTERVAL_KERNELS:
        rs = [byProfile[k][name] for k in byProfile if name in byProfile[k]]
        if name in mg:
            rs.append(mg[name])
        cmp[name] = rs[0] if len(rs) == 1 else merge(*rs)
    return counts, cmp, summary


# ---------------------------------------------------------------- phase 13

def _vo_argv(s, problem, solver, fmt):
    return ['--domain', 'interval', '--s', s, '--problem', problem,
            '--element', 'P1', '--solverType', solver, '--matrixFormat', fmt]


LR = 'twoDomainNonSym(0.25,0.75)'
# tests/test_drivers_fractional.py:121-167 (VARIABLE_CONFIGS): argv, the
# pinned reference values (rtol 3e-2), and the JAX package's outputs of
# the same driver line (default noRef 6, 127 dofs; CPU, float64) with its
# iterations, held to TOL_INTERVAL_JAX relative and +-1 iteration.
VARIABLE_LINES = (
    ('varconst', _vo_argv('varconst(0.75)', 'constant', 'cg-jacobi', 'dense'),
     {'Hs error': 0.041842962898268554, 'L2 error': 0.0014584869817160686,
      'Linf error interpolated': 0.0009870492444583046},
     {'L2 error': 0.0014584876514333886,
      'L2 error interpolated': 0.0010892434381019561,
      'Linf error interpolated': 0.0009870496485860358,
      'Hs error': 0.04184297753455954}, 41),
    ('constantNonSym', _vo_argv('constantNonSym(0.25)', 'constant',
                                'gmres-jacobi', 'dense'),
     {'Hs error': 0.09611243700814974, 'L2 error': 0.0266553185536795,
      'Linf error interpolated': 0.04664216828925677},
     {'L2 error': 0.026655322723040574,
      'L2 error interpolated': 0.008022626666842203,
      'Linf error interpolated': 0.04664203600833766,
      'Hs error': 0.09611246910485544}, 9),
    ('twoDomainNonSym', _vo_argv(LR, 'knownSolution', 'lu', 'dense'),
     {'L2 error': 0.0020560901451394443,
      'Linf error interpolated': 0.003599161364716205},
     {'L2 error': 0.0020165419394079244,
      'L2 error interpolated': 0.0012040812422250483,
      'Linf error interpolated': 0.0036074442982775012}, 1),
    ('constantNonSym-H2', _vo_argv('constantNonSym(0.25)', 'constant',
                                   'gmres-jacobi', 'H2'),
     {'L2 error': 0.02665532198267176},
     {'L2 error': 0.026655317676124377,
      'L2 error interpolated': 0.008022571820942168,
      'Linf error interpolated': 0.046641894707784626,
      'Hs error': 0.09611199629077337}, 9),
    ('twoDomainNonSym-H2-lu', _vo_argv(LR, 'knownSolution', 'lu', 'H2'),
     {'L2 error': 0.001968154983051443},
     {'L2 error': 0.0020155700017095396,
      'L2 error interpolated': 0.001202654921585978,
      'Linf error interpolated': 0.0036095994277783594}, 1),
    ('twoDomainNonSym-H2-mg', _vo_argv(LR, 'knownSolution', 'gmres-mg', 'H2'),
     {'L2 error': 0.001968148149500615},
     {'L2 error': 0.002015603941010537,
      'L2 error interpolated': 0.0012026945043101618,
      'Linf error interpolated': 0.0036093081028042984}, 5))
# the kernels each of those paths must launch
VO_DENSE_NONSYM = ('panel_scatter', 'panel_scatter_nonsym',
                   'panel_scatter:dense', 'panel_scatter_nonsym:dense')
VO_H2 = ('panel_scatter', 'panel_scatter_nonsym', 'far_field', 'h2_matvec',
         'panel_scatter:tree', 'panel_scatter_nonsym:slots')
VO_PATHS = {
    'varconst': DENSE_PATH,
    'constantNonSym': VO_DENSE_NONSYM + ('gmres_arnoldi',),
    'twoDomainNonSym': VO_DENSE_NONSYM,
    'constantNonSym-H2': VO_H2 + ('gmres_arnoldi',),
    'twoDomainNonSym-H2-lu': VO_H2,
    'twoDomainNonSym-H2-mg': VO_H2 + ('gmres_arnoldi', 'csr_spmv',
                                      'jacobi_smooth')}
VO_TRANSPOSE_PATH = VO_H2 + ('h2_matvec_T',)
# the full-width line at VO_NOREF (noRef 14 until phase 23 came: its
# assembly took 36.6 s there; 13 until phase 25 came, PERF.md section 4)
VO_NOREF = 12
VO_CHECK_NOREF = 12
# the L2 error of twoDomainNonSym(0.25,0.75) knownSolution lu H2 at noRef
# VO_CHECK_NOREF: the JAX driver's (drivers/runFractional.py on the CPU,
# float64).  Far above the dense line's: the JAX package's H2 fault of a
# variable order (ROADMAP.md section C), which the port mirrors; held to
# TOL_INTERVAL_JAX relative
JAX_VO_CHECK_H2_L2 = 0.09597993396216485
# the full-width line's host set-up limit: above it noRef 12 is run instead
VO_HOST_LIMIT = 300.0
# operations of one variable-order kernel evaluation (two pow, two lgamma,
# an exp, a division and about ten products and sums)
VO_EVAL_OPS = 16
# operations of one radial power-profile evaluation (a pow and a product)
RADIAL_EVAL_OPS = 2
_VO_FULL = (f'the noRef {VO_NOREF} twoDomainNonSym(0.25,0.75) gmres-mg H2 '
            f'line ({VO_NOREF + 1} levels, {2 ** (VO_NOREF + 1) - 1:,} dofs)')
VO_COMPARED_AT = {
    'panel_scatter': (
        'interval, twoDomainNonSym(0.25,0.75) (order code 2) and '
        'constantNonSym(0.25) (code 1): the dense target on the '
        f'zero-exterior calls of the noRef 6 and {VO_CHECK_NOREF} dense '
        'builds; the tree target (y shift) on all calls of the noRef '
        f'{VO_CHECK_NOREF} H2 build, its pairs also through the dense and '
        f'the slots targets, and on all calls of {_VO_FULL}'),
    'far_field': ('all calls of the noRef 6 H2 builds of twoDomainNonSym '
                  f'and constantNonSym, and the largest of {_VO_FULL}'),
    'h2_matvec': f'every level of {_VO_FULL}, timed on the finest, per apply',
    'csr_spmv': (f'{_VO_FULL}: P x and P^T r of its finest level, per pair '
                 'of products'),
    'jacobi_smooth': f'{_VO_FULL}: its three modes at the finest size, per set',
    'gmres_arnoldi': (f'{_VO_FULL}: one cycle of the solve\'s iterations on '
                      'the finest operator and right-hand side, per cycle'),
}


def vo_main_path(argv, path):
    """run_main_path of a variable-order line on the card at noRef
    ``argv``'s; its errors must be finite."""
    return run_main_path(argv + ['--device', 'cuda', '--maxiter',
                                 str(MG_MAXITER)], path)


def check_variable_line(label, out, pins, jaxOut, its):
    """The pinned reference values (rtol 3e-2) and the JAX outputs
    (TOL_INTERVAL_JAX relative), iterations within +-1."""
    res, errs = out['results'].toDict(), out['errors'].toDict()
    bad = [f'{k}: {errs[k]} vs pin {v}' for k, v in pins.items()
           if not abs(errs[k] - v) <= RTOL_ERRORS * abs(v)]
    bad += [f'{k}: {errs[k]} vs JAX {v}' for k, v in jaxOut.items()
            if not abs(errs[k] - v) <= TOL_INTERVAL_JAX * abs(v)]
    if ('Hs error' in errs) != ('Hs error' in jaxOut):
        bad.append('the Hs error is reported where the JAX driver does not '
                   'report it, or the other way round')
    if res['dofs'] != 127 or abs(res['iterations'] - its) > 1:
        bad.append(f"dofs {res['dofs']}, iterations {res['iterations']} vs "
                   f'127, {its}')
    if bad:
        raise AssertionError(f'{label}: ' + '; '.join(bad))
    log(f"  {label}: iterations {res['iterations']}, L2 error "
        f"{errs['L2 error']:.9e}: the pins (rtol {RTOL_ERRORS}) and the JAX "
        f'outputs (rtol {TOL_INTERVAL_JAX})')


def nonsym_work(args):
    """K19 on recorded args (the target's shape, vertices, vi1, vi2, index,
    volsym, bary_x, bary_y, w, PHIxPSI, PHIyPSI, profile[, order[,
    indicator[, horizon]]]): per pair and node the positions, r^2, two
    kernel evaluations (a variable order's or horizon's counted as
    VO_EVAL_OPS, the radial profile's as RADIAL_EVAL_OPS), the interaction
    indicator and 2 nPSI^2 multiply-adds each way; inputs read once, the
    target's entries that the call reaches read and written once
    (target_entries)."""
    vertices, vi1, vi2 = args[1], args[2], args[3]
    w, PX = args[8], args[9]
    P, Q, nn, dim = vi1.shape[0], w.shape[0], PX.shape[1], vertices.shape[1]
    order, indicator, horizon = (tuple(args[12:15]) + (None,) * 3)[:3]
    ind = indicator is not None and int(indicator[0]) != 0
    evalOps = RADIAL_EVAL_OPS if order is None and horizon is None \
        else VO_EVAL_OPS
    ops = P * Q * (2 * dim * (vi1.shape[1] + vi2.shape[1]) + 3 * dim + 4
                   + 2 * evalOps + 4 * nn
                   + (INDICATOR_OPS if ind else 0))
    return (nbytes(args[1:11]) + 16 * target_entries(args[0], args[4]), ops,
            F64_PEAK)


def panel_order_work(args):
    """panel_work with a variable order's evaluation per node."""
    b, ops, peak = panel_work(args)
    return (b, ops + args[2].shape[0] * args[-3].shape[0] * VO_EVAL_OPS,
            peak)


def compare_h2_matvec_T(H, reps=10, label=''):
    """K20: ``reps`` transposed applies each way after an untimed one;
    returns the result() per apply."""
    import torch
    from pynucleus_tpu_torch.nl import h2
    x = torch.randn(H.num_rows, dtype=torch.float64, device='cuda',
                    generator=torch.Generator('cuda').manual_seed(1))
    yk = torch.empty_like(x)
    h2.h2_matvec_T(H, x, out=yk), h2._h2_matvec_T_plain(H, x)
    ms = timed(lambda: [h2.h2_matvec_T(H, x, out=yk) for _ in range(reps)])
    yp = []
    plain_ms = timed(lambda: [yp.append(h2._h2_matvec_T_plain(H, x))
                              for _ in range(reps)])
    err = float((yk - yp[-1]).abs().max())
    scale = float(yp[-1].abs().max())
    if not (scale > 0 and err <= TOL_KERNEL * scale):
        raise AssertionError(f'h2_matvec_T: max err {err} (max {scale})')
    log(f'  h2_matvec_T{label}: {reps} applies, max abs err {err:.3e} (rel '
        f'{err / scale:.3e}), kernel {ms / reps:.3f} ms, plain '
        f'{plain_ms / reps:.3f} ms per apply')
    # the work of K8's apply, plus the atomics of the column scatter
    b, ops, peak = h2_matvec_work(H)
    return result(err, ms / reps, plain_ms / reps,
                  [(b, ops + H.Anear.nnz, peak)])


def _k19_plain(target):
    import pynucleus_tpu_torch.nl.assembly as asm

    def plain(out, vertices, vi1, vi2, index, *rest):
        return asm._panel_scatter_nonsym_plain(out, target, index, vertices,
                                               vi1, vi2, *rest)
    return plain


def _k1_synthetic(calls, N):
    """K1's dense and slots targets with an order and a y shift on the
    pairs of recorded tree-target calls: their dof rows into one dense
    [N, N] A, and every local entry of every call into a slot of its own of
    one CSR data vector."""
    import torch
    dense, slots = [], []
    total = sum(c[0][4].shape[0] * c[0][4].shape[1] ** 2 for c in calls)
    off = 0
    for (shape, *a), kw in calls:
        (vertices, vi1, vi2, dofRows, volsym, normals, I, J, offF, offB,
         tables, bary_x, bary_y, w, PSIP, prof) = a
        P, n = dofRows.shape
        dense.append((((N, N), vertices, vi1, vi2, dofRows, volsym, normals,
                       bary_x, bary_y, w, PSIP, prof), kw))
        sl = torch.arange(off, off + P * n * n, dtype=torch.int32,
                          device=dofRows.device).reshape(P, n * n)
        off += P * n * n
        slots.append((((total + 1,), vertices, vi1, vi2, sl, volsym,
                       normals, bary_x, bary_y, w, PSIP, prof), kw))
    return dense, slots


def phase13():
    """Variable-order and nonsymmetric kernels on the interval: the six
    VARIABLE_CONFIGS lines at noRef 6 (each a path), H2 and its transpose
    against dense at noRef VO_CHECK_NOREF (a path: the transposed apply),
    the full-width line (twoDomainNonSym gmres-mg H2 at noRef VO_NOREF, a
    path) with its build parts, solves, V-cycle and peak memory, and K1
    (order codes, dense, slots and tree targets with the y shift), K7,
    K19 and K20 against their plain versions.  Returns the launch counts
    of its paths, the comparisons and the summary."""
    import contextlib
    import torch
    import pynucleus_tpu_torch.nl.assembly as asm
    from pynucleus_tpu_torch import kernels
    from pynucleus_tpu_torch.drivers.runFractional import main
    from pynucleus_tpu_torch.fem.assembly import assembleRHS
    from pynucleus_tpu_torch.nl.problems import fractionalLaplacianProblem
    log('phase 13: variable-order and nonsymmetric kernels on the interval '
        '(varconst, constantNonSym, twoDomainNonSym)')
    counts = {}
    k1dense, k7, k19dense = [], [], []
    for label, argv, pins, jaxOut, its in VARIABLE_LINES:
        with ArgRecorder(asm, 'panel_scatter', dataFirst=True) as r1, \
                ArgRecorder(asm, 'far_field') as r7, \
                ArgRecorder(asm, 'panel_scatter_nonsym', dataFirst=True) \
                as r19:
            out, counts[label] = vo_main_path(argv, VO_PATHS[label])
        check_variable_line(label, out, pins, jaxOut, its)
        if label != 'varconst':
            k1dense += r1.calls
            k7 += r7.calls
            k19dense += r19.calls
        del out

    prob = fractionalLaplacianProblem('interval', LR, 'knownSolution')
    log(f'  H2 and its transpose against dense at noRef {VO_CHECK_NOREF} '
        '(the transposed apply a path of its own)')
    from pynucleus_tpu_torch.nl.discretized import buildMeshHierarchy
    meshes, dms, _ = buildMeshHierarchy(prob['mesh'], 'lu', prob['tag'],
                                        VO_CHECK_NOREF, 'P1', 'cuda')
    dmC = dms[-1]
    del meshes
    with ArgRecorder(asm, 'panel_scatter', dataFirst=True) as r1, \
            ArgRecorder(asm, 'panel_scatter_nonsym', dataFirst=True,
                        size=lambda A, v, vi1, *a: vi1.shape[0]) as r19:
        D = asm.assembleNonlocal(dmC, prob['kernel'], matrixFormat='dense',
                                 device='cuda').data
    torch.cuda.synchronize()
    k1dense += r1.calls
    k19dense += r19.calls
    torch.cuda.empty_cache()
    kernels.resetLaunches()
    # K1's tree target with the y shift: all calls of this build (the two
    # runs over a jump facet nearly cancel in a slot, so one call alone can
    # leave sums far below its items' size)
    with ArgRecorder(asm, 'panel_scatter_tree', dataFirst=True) as rTree:
        H = asm.assembleNonlocal(dmC, prob['kernel'], matrixFormat='H2',
                                 device='cuda')
    x = torch.sin(torch.linspace(-1.0, 1.0, dmC.num_dofs,
                                 dtype=torch.float64, device='cuda'))
    yF, yT = H.matvec(x), H.T.matvec(x)
    torch.cuda.synchronize()
    counts['transpose'] = dict(kernels.launches)
    counts['transpose']['device'] = dict(kernels.deviceLaunches)
    for k in VO_TRANSPOSE_PATH:
        if counts['transpose'][k] <= 0:
            raise AssertionError(f'kernel {k} was not launched by the '
                                 'transposed-apply path')
    eFwd = float(torch.linalg.norm(yF - D @ x))
    eT = float(torch.linalg.norm(yT - D.T @ x))
    if not (eT < max(1e-5, 3.0 * eFwd)
            and eFwd <= TOL_H2_DENSE * float(torch.linalg.norm(D @ x))):
        raise AssertionError(f'H2 vs dense at noRef {VO_CHECK_NOREF}: eFwd '
                             f'{eFwd}, eT {eT}')
    log(f'  {dmC.num_dofs} dofs, dense {D.numel() * 8 / 1e6:.0f} MB: '
        f'|H x - A x| {eFwd:.3e}, |H^T x - A^T x| {eT:.3e} (< max(1e-5, '
        f'3 eFwd), tests/test_h2_transpose.py:33); relative '
        f'{eFwd / float(torch.linalg.norm(D @ x)):.3e} and '
        f'{eT / float(torch.linalg.norm(D.T @ x)):.3e}')
    # the solutions of both operators by LU: their errors (the JAX package
    # gives the H2 line a larger error than the dense one from noRef 8 on,
    # ROADMAP.md section C; the port follows it)
    from pynucleus_tpu_torch.nl.discretized import modelErrors
    bC = assembleRHS(dmC, prob['rhs'], qOrder=3)
    checkErrs = {}
    for what, Ad in (('dense', D), ('H2', torch.as_tensor(
            H.toarray(), dtype=torch.float64, device='cuda'))):
        lu, piv = torch.linalg.lu_factor(Ad)
        u = torch.linalg.lu_solve(lu, piv, bC.data[:, None])[:, 0]
        checkErrs[what] = modelErrors(dmC, u, bC.data,
                                      prob['analyticSolution'],
                                      prob['exactL2Squared'], None)
        del Ad, lu, piv
    log(f'  noRef {VO_CHECK_NOREF} lu: L2 error dense '
        f"{checkErrs['dense']['L2 error']:.6e}, H2 "
        f"{checkErrs['H2']['L2 error']:.9e}; L2 error interpolated dense "
        f"{checkErrs['dense']['L2 error interpolated']:.6e}, H2 "
        f"{checkErrs['H2']['L2 error interpolated']:.6e}")
    eH2 = checkErrs['H2']['L2 error']
    if not abs(eH2 - JAX_VO_CHECK_H2_L2) <= \
            TOL_INTERVAL_JAX * JAX_VO_CHECK_H2_L2:
        raise AssertionError(f'noRef {VO_CHECK_NOREF} H2 lu: L2 error {eH2} '
                             f'vs the JAX driver {JAX_VO_CHECK_H2_L2}')
    log(f'  the H2 lu L2 error is the JAX driver\'s {JAX_VO_CHECK_H2_L2:.9e} '
        f'(rtol {TOL_INTERVAL_JAX})')
    k20 = [compare_h2_matvec_T(H, label=f' noRef {VO_CHECK_NOREF}')]
    tree = rTree.calls
    k1d, k1s = _k1_synthetic(tree, dmC.num_dofs)
    del D, H, yF, yT, dmC, dms
    torch.cuda.empty_cache()

    # the full-width line
    noRef = VO_NOREF
    # K1's tree target: all calls (the two runs over a jump facet nearly
    # cancel in a slot, so the calls of a level are compared together)
    recNames = {'far_field': (lambda gi, *a: gi.shape[0], False),
                'panel_scatter_nonsym_slots': (
                    lambda d, v, vi1, *a: vi1.shape[0], True),
                'panel_scatter_tree': (None, True)}
    while True:
        log(f'  the full-width line: {LR} knownSolution gmres-mg H2 at '
            f'noRef {noRef}')
        with contextlib.ExitStack() as stack:
            recs = {n: stack.enter_context(ArgRecorder(asm, n, dataFirst=df,
                                                       size=size))
                    for n, (size, df) in recNames.items()}
            out, counts['full'] = vo_main_path(
                _vo_argv(LR, 'knownSolution', 'gmres-mg', 'H2')
                + ['--noRef', str(noRef)], VO_PATHS['twoDomainNonSym-H2-mg'])
        # the build parts but the far field (K7), the operator's set-up and
        # the split (a part of the plan), on every level
        host = sum(v for p in out['levelParts'].values() for k, v in p.items()
                   if k not in ('far field', 'near operator set-up',
                                'plan (split leaves)'))
        if host <= VO_HOST_LIMIT or noRef == VO_CHECK_NOREF:
            break
        log(f'  host set-up {host:.1f} s > {VO_HOST_LIMIT} s: noRef '
            f'{VO_CHECK_NOREF} instead')
        noRef = VO_CHECK_NOREF
        del out
    errs = out['errors'].toDict()
    hierarchy, tim = out['hierarchy'], out['timers'].toDict()
    for k in range(len(hierarchy)):
        parts = out['levelParts'][k]
        log(f"  level {k}: {hierarchy[k]['A'].num_rows} dofs, assembly "
            f"{tim[f'assembly level {k} seconds']:.3f} s: " + ', '.join(
                f'{p} {v:.3f}' for p, v in parts.items()))
    M = out['solver'].prec
    b = torch.randn(M.num_rows, dtype=torch.float64, device='cuda',
                    generator=torch.Generator('cuda').manual_seed(14))
    z = torch.empty_like(b)
    M.matvec(b, out=z)
    perCycle = timed(lambda: [M.matvec(b, out=z) for _ in range(10)]) / 10
    solver, dm = out['solver'], out['dm']
    rhs = assembleRHS(dm, prob['rhs'], qOrder=3).data
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.solve(rhs)
    torch.cuda.synchronize()
    tWarm = time.perf_counter() - t0
    summary = {'noRef': noRef, 'dofs': dm.num_dofs,
               'levels': len(hierarchy),
               'iterations': out['results'].toDict()['iterations'],
               'L2_error': errs['L2 error'],
               'Linf_error_interpolated': errs['Linf error interpolated'],
               'assembly_s': tim['assembly seconds'],
               'finest_level_parts_s': out['levelParts'][len(hierarchy) - 1],
               'host_setup_s': host,
               'solve_s': tim['solve seconds'], 'warm_solve_s': tWarm,
               'vcycle_ms': perCycle,
               'explicit_residual': tim['explicit residual'],
               'peak_GiB': torch.cuda.max_memory_allocated() / 2 ** 30,
               'noRef12_lu_errors': checkErrs}
    log(f'  summary: {json.dumps(summary)}')
    # finite errors of a converged solve (run_main_path) with the expected
    # dofs; the line is held to the JAX outputs at noRef 6 above
    if dm.num_dofs != 2 ** (noRef + 1) - 1 or not all(
            v == v and v >= 0 and v != float('inf') for v in errs.values()):
        raise AssertionError(f'noRef {noRef}: dofs {dm.num_dofs}, {errs}')
    log(f'  kernels against their plain versions at the noRef {noRef} shapes '
        '(the largest call of each, K1 all its tree-target calls; K8 and K20 '
        'on every level, timed on the finest; K9 on the finest P, K10 at '
        'the finest size, K17 on the finest operator and right-hand side, '
        'one cycle of the solve\'s iterations)')
    last = len(hierarchy) - 1
    k8 = [compare_h2_matvec(lv['A'], reps=10 if k == last else 1,
                            label=f' level {k}')
          for k, lv in enumerate(hierarchy)]
    k20 += [compare_h2_matvec_T(lv['A'], reps=10 if k == last else 1,
                                label=f' level {k}')
            for k, lv in enumerate(hierarchy)]
    A, P = hierarchy[-1]['A'], hierarchy[-1]['P']
    cmp = {'h2_matvec': dict(k8[-1], err=max(r['err'] for r in k8)),
           'csr_spmv': compare_csr_spmv(P),
           'jacobi_smooth': compare_jacobi_smooth(P.num_rows),
           'gmres_arnoldi': compare_gmres_arnoldi(
               A, rhs, restart=max(summary['iterations'], 1))}
    del out, hierarchy, M, solver, z, A, P
    torch.cuda.empty_cache()
    k7 += recs['far_field'].calls
    cmp.update({'h2_matvec_T': dict(k20[-1], err=max(r['err'] for r in k20)),
                'far_field': compare_far_field(k7, 'far_field (orders)')})
    k1 = [compare_target_kernel('panel_scatter (order, dense)', k1dense,
                                asm.panel_scatter, asm._panel_scatter_plain,
                                panel_order_work),
          compare_target_kernel('panel_scatter (order, tree, y shift)', tree,
                                asm.panel_scatter_tree,
                                asm._panel_scatter_tree_plain,
                                panel_order_work),
          compare_target_kernel(f'panel_scatter (order, tree, y shift, noRef '
                                f'{noRef})', recs['panel_scatter_tree'].calls,
                                asm.panel_scatter_tree,
                                asm._panel_scatter_tree_plain,
                                panel_order_work),
          compare_target_kernel('panel_scatter (order, dense, y shift)', k1d,
                                asm.panel_scatter, asm._panel_scatter_plain,
                                panel_order_work),
          compare_target_kernel('panel_scatter (order, slots, y shift)', k1s,
                                asm.panel_scatter_slots,
                                asm._panel_scatter_slots_plain,
                                panel_order_work)]
    cmp['panel_scatter'] = merge(*k1)
    cmp['panel_scatter_nonsym'] = merge(
        compare_target_kernel('panel_scatter_nonsym (dense)', k19dense,
                              asm.panel_scatter_nonsym, _k19_plain('dense'),
                              nonsym_work),
        compare_target_kernel('panel_scatter_nonsym (slots)',
                              recs['panel_scatter_nonsym_slots'].calls,
                              asm.panel_scatter_nonsym_slots,
                              _k19_plain('slots'), nonsym_work))
    return counts, cmp, summary


# ---------------------------------------------------------------- phase 14

# JAX package outputs, run on the CPU in float64 (getDenseVector and getH2
# of nl/assembly.py nonlocalBuilder on the drivers' meshes, x = numpy
# RandomState(14) standard_normal(N)): the interval at noRef 6 (127 dofs),
# per vector line the Frobenius norm of each component and the norms of
# matvec(x) and matvecTrans(x); the disc at noRef 5 (4465 dofs), d^2/ds^2
# of s = 0.75, the norms of A x for the dense operator (params={'denseGrid':
# True}, the grid path, as the port's default) and the H2 operator.  Held
# to TOL_DERIV_JAX relative.
JAX_VECTOR_NOREF6 = {
    'LR2-d1': {'components': [6.517508709957474, 924.1232194495659],
               'matvec': 841.291904101015,
               'matvecTrans': 840.3457653651976},
    'LR2-d2': {'components': [61.4617095320536, 0.0, 0.0,
                              9635.573930541792],
               'matvec': 8835.391851993249,
               'matvecTrans': 8822.673328452054},
    'LR4-d1': {'components': [6.387706986956925, 922.987548784992,
                              1.5734508825023479, 8.90777776800417],
               'matvec': 840.1892407230822,
               'matvecTrans': 840.0775999682043}}
JAX_DISC5_D2 = {'dense': 2142.6239279254646, 'H2': 2142.6968773060808}
TOL_DERIV_JAX = 1e-6
DERIV_PIN_NOREF = 5
DERIV_VECTOR_PIN_NOREF = 6
# the three vector lines: leftRight parameters and derivative
DERIV_VECTOR_LINES = (('LR2-d1', (0.25, 0.75), 1), ('LR2-d2', (0.25, 0.75), 2),
                      ('LR4-d1', (0.25, 0.75, 0.4, 0.6), 1))
# the finite-difference check (tests/test_vector_assembly.py:59-80): order
# leftRight(0.3, 0.6), step 1e-5, at noRef DERIV_FD_NOREF
DERIV_FD_NOREF = 8
TOL_DERIV_FD = 5e-4
# dA/ds of s = 0.75 on the disc: H2 against dense at noRef
# DERIV_CHECK_NOREF, the full-width line at DERIV_NOREF
DERIV_CHECK_NOREF = 6
TOL_DERIV_H2 = 5e-4
DERIV_NOREF = 7
# d^2A/ds^2 of leftRight(0.25, 0.75), dense vector on the interval at
# DERIV_VECTOR_NOREF (cut so that the script keeps within its time limit,
# PERF.md section 4); DERIV_VECTOR_FALLBACK if its host set-up exceeds
# DERIV_HOST_LIMIT seconds
DERIV_VECTOR_NOREF = 10
DERIV_VECTOR_FALLBACK = 9
DERIV_HOST_LIMIT = 300.0
# the kernels each path of phase 14 must launch
DERIV_DENSE_PATH = ('panel_scatter', 'grid_distant', 'grid_boundary',
                    'vector_matvec', 'panel_scatter:dense',
                    'vector_matvec:apply')
DERIV_H2_PATH = ('panel_scatter', 'far_field', 'h2_matvec', 'near_enum',
                 'near_enum_quad', 'block_near_count', 'block_near_quad',
                 'panel_scatter:slots', 'panel_scatter:tree')
DERIV_VEC_PATH = ('panel_scatter_vec', 'panel_scatter_nonsym_vec',
                  'vector_matvec', 'vector_matvec:apply',
                  'vector_matvec:transposed')
# operations of one vector-kernel node term (side, pow, log, the power-log
# polynomial and the log correction)
VEC_TERM_OPS = 14
DERIV_COMPARED_AT = {
    'panel_scatter': 'disc noRef 5, d^2/ds^2 of s = 0.75 (power-log '
                     'profile): the dense target (a dense build) and the CSR '
                     'targets (an H2 build), all calls',
    'grid_distant': 'disc noRef 5, d^2/ds^2 of s = 0.75, all calls',
    'grid_boundary': 'disc noRef 5, d^2/ds^2 of s = 0.75',
    'near_enum_quad': 'disc noRef 5, d^2/ds^2 of s = 0.75, all calls',
    'far_field': 'disc noRef 5, d^2/ds^2 of s = 0.75, all calls',
    'block_near_quad': 'disc noRef 5, d^2/ds^2 of s = 0.75, all calls',
}
COMPARED_AT.update({
    'panel_scatter_vec': 'interval, the three vector lines at noRef 6 and '
                         'leftRight(0.25, 0.75) d^2/ds^2 at noRef '
                         f'{DERIV_VECTOR_NOREF}: all calls',
    'panel_scatter_nonsym_vec': 'interval, the three vector lines at noRef 6 '
                                '(all calls) and leftRight(0.25, 0.75) '
                                f'd^2/ds^2 at noRef {DERIV_VECTOR_NOREF} (its '
                                'largest call)',
    'vector_matvec': 'interval, leftRight(0.25, 0.75) d^2/ds^2 at noRef '
                     f'{DERIV_VECTOR_NOREF} (N x N x 4): one apply and one '
                     'transposed apply, per pair, library torch.einsum'})


def count_path(label, path, fn):
    """Runs fn() as a main path: every launch count set to 0 just before
    and read just after; each kernel of ``path`` must have launched.
    Returns (fn's result, the counts)."""
    import torch
    from pynucleus_tpu_torch import kernels
    torch.cuda.synchronize()
    kernels.resetLaunches()
    out = fn()
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    counts['device'] = dict(kernels.deviceLaunches)
    for k in path:
        if counts[k] <= 0:
            raise AssertionError(f'kernel {k} was not launched by the '
                                 f'{label} path')
    return out, counts


def vec_work(args):
    """K21 or K22 on recorded args (N, vertices, vi1, vi2, dofRows, volsym,
    bary_x, bary_y, w, P1[, P2], vp, logTables): per pair and node the
    positions, r^2, the node term (twice for K22) and V nPSI^2
    multiply-adds each way; the touched entries of A [N, N, V] read and
    written once (at most all of A, however many pairs share them)."""
    (shape, vertices, vi1, vi2, dofRows, volsym, bx, by, w, P1, *rest) = args
    ways = 2 if len(rest) == 3 else 1
    V = rest[-2].grads.shape[1]
    P, Q, nn, dim = vi1.shape[0], w.shape[0], P1.shape[1], vertices.shape[1]
    ops = P * Q * (2 * dim * (vi1.shape[1] + vi2.shape[1]) + 3 * dim
                   + ways * (VEC_TERM_OPS + 2 * V * nn))
    touched = min(P * nn, shape[0] * shape[1]) * V
    return (nbytes(args[1:]) + 16 * touched, ops, F64_PEAK)


def _vec_plain(nonsym):
    import pynucleus_tpu_torch.nl.assembly as asm
    return asm._panel_scatter_nonsym_vec_plain if nonsym else \
        asm._panel_scatter_vec_plain


def compare_vector_matvec(A, reps=10):
    """K23: ``reps`` applies and transposed applies of the dense vector
    operator's data A [N, M, V] each way, after an untimed one, and one
    torch.einsum call each way; returns the result() per pair of applies."""
    import torch
    from pynucleus_tpu_torch.base.linear_operators import (
        vector_matvec, _vector_matvec_plain)
    N, M, V = A.shape
    x = torch.randn(N, dtype=torch.float64, device='cuda',
                    generator=torch.Generator('cuda').manual_seed(23))
    worst = ms = plain_ms = lib_ms = 0.0
    for trans, eq in ((False, 'nmk,m->nk'), (True, 'nmk,n->mk')):
        vector_matvec(A, x, trans), _vector_matvec_plain(A, x, trans)
        torch.einsum(eq, A, x)
        got, ref = [], []
        ms += timed(lambda: [got.append(vector_matvec(A, x, trans))
                             for _ in range(reps)]) / reps
        plain_ms += timed(lambda: [ref.append(_vector_matvec_plain(A, x,
                                                                   trans))
                                   for _ in range(reps)]) / reps
        lib_ms += timed(lambda: [torch.einsum(eq, A, x)
                                 for _ in range(reps)]) / reps
        err = float((got[-1] - ref[-1]).abs().max())
        scale = float(ref[-1].abs().max())
        if not (scale > 0 and err <= TOL_KERNEL * scale):
            raise AssertionError(f'vector_matvec (trans={trans}): max err '
                                 f'{err} (max {scale})')
        worst = max(worst, err)
    log(f'  vector_matvec: [{N}, {M}, {V}], apply and transposed apply, max '
        f'abs err {worst:.3e}, kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, '
        f'torch.einsum {lib_ms:.3f} ms per pair')
    b = 2 * (nbytes(A) + 8 * N + 8 * max(N, M) * V)
    return result(worst, ms, plain_ms, [(b, 4 * N * M * V, F64_PEAK)],
                  library_ms=lib_ms)


def _seeded(n):
    import numpy as np
    import torch
    return torch.as_tensor(np.random.RandomState(14).standard_normal(n),
                           device='cuda')


def _relclose(got, ref, tol):
    return abs(got - ref) <= tol * abs(ref)


def phase14():
    """The s-derivative operators: the constant order's d^2/ds^2 on the
    disc at noRef 5, dense and H2, and the three vector lines on the
    interval at noRef 6 against the pinned JAX outputs (each a path); the
    finite-difference check of the vector kernel at noRef DERIV_FD_NOREF
    and dA/ds H2 against dense on the disc at noRef DERIV_CHECK_NOREF; the
    full-width lines (dA/ds of the flagship disc at noRef DERIV_NOREF with
    getH2Vector, d^2A/ds^2 of leftRight(0.25, 0.75) dense at noRef
    DERIV_VECTOR_NOREF; each a path), and K21, K22, K23 and the power-log
    profile in K1, K2, K3, K6 (where called), K7 and K12 against their plain
    versions.  Returns the launch counts of its paths, the comparisons of
    K21-K23, those of the power-log profile and the summary."""
    import contextlib
    import numpy as np
    import torch
    import pynucleus_tpu_torch.nl.assembly as asm
    from pynucleus_tpu_torch.nl.discretized import buildMeshHierarchy
    from pynucleus_tpu_torch.nl.kernels import (getFractionalKernel,
                                                leftRightFractionalOrder)
    from pynucleus_tpu_torch.nl.problems import fractionalLaplacianProblem
    log('phase 14: the s-derivative operators (dA/ds, d^2A/ds^2)')
    counts, summary = {}, {}

    def level(domain, noRef):
        """The dofmap of the driver's mesh of ``domain`` at noRef."""
        prob = fractionalLaplacianProblem(domain, 'const(0.75)')
        _, dms, _ = buildMeshHierarchy(prob['mesh'], 'lu', prob['tag'],
                                       noRef, 'P1', 'cuda')
        return dms[-1]

    def disc(noRef):
        return level('disc', noRef)

    def interval(noRef):
        return level('interval', noRef)

    # --- the constant order's d^2/ds^2 on the disc at noRef 5
    dm5 = disc(DERIV_PIN_NOREF)
    k2 = getFractionalKernel(2, 0.75, derivative=2)
    x5 = _seeded(dm5.num_dofs)
    with ArgRecorder(asm, 'panel_scatter', dataFirst=True) as r1, \
            ArgRecorder(asm, 'grid_distant', dataFirst=True) as r2, \
            ArgRecorder(asm, 'grid_boundary', dataFirst=True) as r3:
        y, counts['disc5_dense'] = count_path(
            'disc noRef 5 d2 dense', DERIV_DENSE_PATH,
            lambda: asm.nonlocalBuilder(dm5, k2).getDenseVector().matvec(x5))
    got = float(torch.linalg.norm(y))
    if not _relclose(got, JAX_DISC5_D2['dense'], TOL_DERIV_JAX):
        raise AssertionError(f'disc noRef 5 d2 dense: |A x| {got} vs JAX '
                             f"{JAX_DISC5_D2['dense']}")
    log(f'  disc noRef 5, d^2/ds^2 of s = 0.75, dense: |A x| {got:.12e}, '
        f'the JAX output (rtol {TOL_DERIV_JAX})')
    names = asm.__dict__
    (got, counts['disc5_h2']), recs = record_h2_build(lambda: count_path(
        'disc noRef 5 d2 H2', DERIV_H2_PATH,
        lambda: float(torch.linalg.norm(asm.nonlocalBuilder(dm5, k2)
                                        .getH2Vector().matvec(x5)))),
        H2_BUILD + ENGINE_KERNELS[:2])
    if not _relclose(got, JAX_DISC5_D2['H2'], TOL_DERIV_JAX):
        raise AssertionError(f'disc noRef 5 d2 H2: |H x| {got} vs JAX '
                             f"{JAX_DISC5_D2['H2']}")
    log(f'  disc noRef 5, d^2/ds^2 of s = 0.75, H2 (getH2Vector): |H x| '
        f'{got:.12e}, the JAX output (rtol {TOL_DERIV_JAX})')
    log('  the power-log profile in the kernels against their plain versions '
        '(these two builds)')
    prof = {}
    for n in H2_CSR:
        if recs[n].calls:
            prof[n] = compare_target_kernel(
                n + ' (power-log)', recs[n].calls, names[n],
                names['_' + n + '_plain'],
                enum_quad_work if n == 'near_enum_quad' else panel_work)
    if not (recs['panel_scatter_slots'].calls
            and recs['panel_scatter_tree'].calls and recs['far_field'].calls
            and (recs['block_near_quad'].calls
                 or recs['near_enum_quad'].calls)):
        raise AssertionError('the H2 build made no call of K1 (slots, tree), '
                             'K7, or K6 or K12')
    prof['far_field'] = compare_far_field(recs['far_field'].calls,
                                          'far_field (power-log)')
    if recs['block_near_quad'].calls:
        prof['block_near_quad'] = compare_target_kernel(
            'block_near_quad (power-log)', recs['block_near_quad'].calls,
            asm.block_near_quad, asm._block_near_quad_plain, block_quad_work)
    for name, calls, work in (('panel_scatter', r1.calls, panel_work),
                              ('grid_distant', r2.calls, grid_distant_work),
                              ('grid_boundary', r3.calls,
                               grid_boundary_work)):
        c = compare_target_kernel(f'{name} (power-log, dense)', calls,
                                  names[name], names['_' + name + '_plain'],
                                  work)
        prof[name] = merge(c, *(prof.pop(n) for n in ('panel_scatter_slots',
                                                      'panel_scatter_tree')
                                if name == 'panel_scatter'))
    del recs, r1, r2, r3, dm5, y
    torch.cuda.empty_cache()

    # --- the vector lines on the interval at noRef 6
    dm6 = interval(DERIV_VECTOR_PIN_NOREF)
    x6 = _seeded(dm6.num_dofs)
    k21, k22 = [], []
    for label, sv, d in DERIV_VECTOR_LINES:
        kv = getFractionalKernel(1, leftRightFractionalOrder(*sv),
                                 derivative=d)

        def line():
            A = asm.nonlocalBuilder(dm6, kv).getDenseVector()
            return A, A.matvec(x6), A.matvecTrans(x6)
        with ArgRecorder(asm, 'panel_scatter_vec', dataFirst=True) as rv, \
                ArgRecorder(asm, 'panel_scatter_nonsym_vec',
                            dataFirst=True) as rn:
            (A, y, yT), counts[label] = count_path(
                f'interval noRef 6 {label}', DERIV_VEC_PATH, line)
        k21 += rv.calls
        k22 += rn.calls
        ref = JAX_VECTOR_NOREF6[label]
        got = {'components': [float(torch.linalg.norm(A.data[:, :, v]))
                              for v in range(A.vectorSize)],
               'matvec': float(torch.linalg.norm(y)),
               'matvecTrans': float(torch.linalg.norm(yT))}
        bad = [f'{k}: {got[k]} vs {ref[k]}' for k in ('matvec', 'matvecTrans')
               if not _relclose(got[k], ref[k], TOL_DERIV_JAX)]
        bad += [f'component {v}: {a} vs {b}' for v, (a, b) in enumerate(
            zip(got['components'], ref['components']))
            if not (len(got['components']) == len(ref['components'])
                    and _relclose(a, b, TOL_DERIV_JAX))]
        if bad:
            raise AssertionError(f'{label}: ' + '; '.join(bad))
        log(f"  interval noRef 6 {label}: V {A.vectorSize}, |matvec| "
            f"{got['matvec']:.12e}, |matvecTrans| {got['matvecTrans']:.12e}: "
            f'the JAX outputs (rtol {TOL_DERIV_JAX})')
        if d == 2:
            P = int(round(A.vectorSize ** 0.5))
            H = A.data.reshape(A.num_rows, A.num_rows, P, P)
            sym = float((H[:, :, 0, 1] - H[:, :, 1, 0]).abs().max()
                        / H.abs().max())
            if not sym <= 1e-10:
                raise AssertionError(f'{label}: components (0,1) and (1,0) '
                                     f'differ by {sym}')
            log(f'  {label}: components (0,1) and (1,0) within {sym:.2e}')
        del A, y, yT

    # --- the finite-difference check
    log(f'  d/dp of leftRight(0.3, 0.6) at noRef {DERIV_FD_NOREF} against '
        'central differences of the dense operators (step 1e-5)')
    dmF = interval(DERIV_FD_NOREF)
    kv = getFractionalKernel(1, leftRightFractionalOrder(0.3, 0.6),
                             derivative=1)
    arr = asm.nonlocalBuilder(dmF, kv).getDenseVector().data
    eps = 1e-5

    def plain(a, b):
        return asm.nonlocalBuilder(dmF, getFractionalKernel(
            1, leftRightFractionalOrder(a, b))).getDense().data
    fdErr = []
    for q, (da, db) in enumerate(((eps, 0.0), (0.0, eps))):
        fd = (plain(0.3 + da, 0.6 + db) - plain(0.3 - da, 0.6 - db)) \
            / (2 * eps)
        fdErr.append(float((arr[:, :, q] - fd).abs().max() / fd.abs().max()))
    if not max(fdErr) < TOL_DERIV_FD:
        raise AssertionError(f'finite differences: {fdErr}')
    log(f'  components 0, 1 against the differences: {fdErr[0]:.3e}, '
        f'{fdErr[1]:.3e} of the largest entry (< {TOL_DERIV_FD})')
    summary['fd_rel_err'] = fdErr
    del arr, dmF, dm6
    torch.cuda.empty_cache()

    # --- dA/ds of s = 0.75 on the disc: H2 against dense
    k1 = getFractionalKernel(2, 0.75, derivative=1)
    dmC = disc(DERIV_CHECK_NOREF)
    xC = _seeded(dmC.num_dofs)
    yD = asm.nonlocalBuilder(dmC, k1).getDenseVector().matvec(xC)
    yH = asm.nonlocalBuilder(dmC, k1).getH2Vector().matvec(xC)
    rel = float(torch.linalg.norm(yH - yD) / torch.linalg.norm(yD))
    if not rel < TOL_DERIV_H2:
        raise AssertionError(f'disc noRef {DERIV_CHECK_NOREF} dA/ds: H2 vs '
                             f'dense {rel}')
    log(f'  disc noRef {DERIV_CHECK_NOREF} ({dmC.num_dofs} dofs), dA/ds: H2 '
        f'against dense {rel:.4e} relative on one apply (< {TOL_DERIV_H2})')
    summary['disc_check'] = {'noRef': DERIV_CHECK_NOREF,
                             'dofs': dmC.num_dofs, 'h2_vs_dense': rel}
    del yD, yH, dmC
    torch.cuda.empty_cache()

    # --- the full-width line: dA/ds of the flagship disc in H2
    log(f'  the full-width line: dA/ds of s = 0.75 on the disc at noRef '
        f'{DERIV_NOREF}, getH2Vector')
    dm7 = disc(DERIV_NOREF)
    torch.cuda.reset_peak_memory_stats()

    # the build runs under torch.profiler for its device part
    from torch.profiler import profile, ProfilerActivity

    def flagship():
        b = asm.nonlocalBuilder(dm7, k1)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as profiled:
            t0 = time.perf_counter()
            H = b.getH2Vector()
            torch.cuda.synchronize()
            tB = time.perf_counter() - t0
        return (H, tB, b.timers, profiled, timed(lambda: H.matvec(x7)),
                timed(lambda: H.matvecTrans(x7)))
    x7 = _seeded(dm7.num_dofs)
    (H, tBuild, parts, profiled, first, firstT), counts['disc7_h2'] = \
        count_path(f'disc noRef {DERIV_NOREF} dA/ds H2', DERIV_H2_PATH,
                   flagship)
    ms = timed(lambda: [H.matvec(x7) for _ in range(10)]) / 10
    msT = timed(lambda: [H.matvecTrans(x7) for _ in range(10)]) / 10
    y7 = H.matvec(x7)
    if not (y7.shape == (dm7.num_dofs, 1) and bool(torch.isfinite(y7).all())):
        raise AssertionError(f'noRef {DERIV_NOREF}: H x {y7.shape}')
    peak = torch.cuda.max_memory_allocated()
    del H
    torch.cuda.empty_cache()
    dev = {}
    for ev in profiled.key_averages():
        t = getattr(ev, 'device_time_total', None)
        if t is None:
            t = getattr(ev, 'cuda_time_total', 0)
        if t and ev.device_type.name == 'CUDA':
            dev[ev.key[:48]] = dev.get(ev.key[:48], 0.0) + t / 1e3
    devMs = sum(dev.values())
    summary['disc_full'] = {
        'noRef': DERIV_NOREF, 'dofs': dm7.num_dofs,
        'build_s_under_profiler': tBuild,
        'parts_s': {k: round(v, 4) for k, v in parts.items()},
        'device_ms': devMs, 'device_busy_share': devMs / 1e3 / tBuild,
        'device_ms_by_kernel': dict(sorted(dev.items(),
                                           key=lambda kv: -kv[1])[:8]),
        'matvec_ms_first': first, 'matvec_ms': ms,
        'matvecTrans_ms_first': firstT, 'matvecTrans_ms': msT,
        'peak_GiB': peak / 2 ** 30, 'norm_Hx': float(torch.linalg.norm(y7))}
    log(f"  summary: {json.dumps(summary['disc_full'])}")
    del y7, dm7
    torch.cuda.empty_cache()

    # --- the full-width line: d^2A/ds^2 of leftRight(0.25, 0.75), dense
    kv = getFractionalKernel(1, leftRightFractionalOrder(0.25, 0.75),
                             derivative=2)
    noRef = DERIV_VECTOR_NOREF
    while True:
        log(f'  the full-width line: d^2A/ds^2 of leftRight(0.25, 0.75) on '
            f'the interval at noRef {noRef}, getDenseVector')
        dmV = interval(noRef)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

        def vectorLine():
            b = asm.nonlocalBuilder(dmV, kv)
            t0 = time.perf_counter()
            b._classifyAll()
            tCls = time.perf_counter() - t0
            A = b.getDenseVector()
            torch.cuda.synchronize()
            return A, tCls, time.perf_counter() - t0

        def apply():
            A, tCls, tAll = vectorLine()
            return A, tCls, tAll, A.matvec(xV), A.matvecTrans(xV)
        xV = _seeded(dmV.num_dofs)
        # K21's and K22's calls (K22's largest) recorded during the run
        with ArgRecorder(asm, 'panel_scatter_vec', dataFirst=True) as rv, \
                ArgRecorder(asm, 'panel_scatter_nonsym_vec', dataFirst=True,
                            size=lambda A, v, vi1, *a: vi1.shape[0]) as rn:
            (A, tCls, tAll, y, yT), counts['vector_full'] = count_path(
                f'interval noRef {noRef} d2 vector', DERIV_VEC_PATH, apply)
        peak = torch.cuda.max_memory_allocated()
        if tCls <= DERIV_HOST_LIMIT or noRef == DERIV_VECTOR_FALLBACK:
            break
        log(f'  host classification {tCls:.1f} s > {DERIV_HOST_LIMIT} s: '
            f'noRef {DERIV_VECTOR_FALLBACK} instead')
        noRef = DERIV_VECTOR_FALLBACK
        del A, y, yT
    if not (bool(torch.isfinite(y).all()) and bool(torch.isfinite(yT).all())):
        raise AssertionError(f'noRef {noRef} vector line: non-finite apply')
    summary['vector_full'] = {
        'noRef': noRef, 'dofs': dmV.num_dofs, 'V': A.vectorSize,
        'GB': A.data.numel() * 8 / 1e9, 'build_s': tAll,
        'host_classification_s': tCls, 'peak_GiB': peak / 2 ** 30,
        'norm_matvec': float(torch.linalg.norm(y)),
        'norm_matvecTrans': float(torch.linalg.norm(yT))}
    log(f"  summary: {json.dumps(summary['vector_full'])}")
    del y, yT
    log(f'  K21, K22 and K23 against their plain versions (the noRef 6 lines '
        f'and noRef {noRef}, its calls recorded during the run)')
    cmp = {'vector_matvec': compare_vector_matvec(A.data)}
    del A
    torch.cuda.empty_cache()
    k21 += rv.calls
    k22 += rn.calls
    del dmV
    torch.cuda.empty_cache()
    cmp['panel_scatter_vec'] = compare_target_kernel(
        'panel_scatter_vec', k21, asm.panel_scatter_vec, _vec_plain(False),
        vec_work)
    cmp['panel_scatter_nonsym_vec'] = compare_target_kernel(
        'panel_scatter_nonsym_vec', k22, asm.panel_scatter_nonsym_vec,
        _vec_plain(True), vec_work)
    torch.cuda.empty_cache()
    return counts, cmp, prof, summary


# ---------------------------------------------------------------- phase 15

# JAX package outputs of `drivers/runHelmholtz.py --domain D [--problem
# P]`, run on the CPU in float64 (the results group, to full precision)
JAX_HELMHOLTZ = {
    ('interval', 'wave'): {'DoFs': 129, 'numIter': 23,
                           'res': 4.38928474391897e-06,
                           'solution L2 norm': 0.9999999758530215,
                           'L2 error': 1.5359002813128508e-06},
    ('interval', 'greens'): {'DoFs': 129, 'numIter': 11,
                             'res': 7.5679531697032636e-06,
                             'solution L2 norm': 0.00027988735977089665},
    ('square', 'wave'): {'DoFs': 66049, 'numIter': 26,
                         'res': 9.518279657696444e-06,
                         'solution L2 norm': 1.0000000471161223,
                         'L2 error': 1.0066312136028506e-05},
}
# the pinned outputs are held to 1e-6 relative (numIter equal), and the
# square's solution L2 norm to 1 within 1e-5 (tests/test_helmholtz.py)
TOL_HELMHOLTZ = 1e-6
HELMHOLTZ_PATH = ('csr_scatter', 'csr_spmv:complex', 'jacobi_smooth:complex',
                  'gmres_arnoldi:complex')
COMPLEX_COMPARED_AT = {
    'csr_spmv:complex': 'the Helmholtz square (66,049 dofs): the finest '
                        'complex operator A and the real P and P^T of '
                        'levels 16,641 -> 66,049 on complex vectors, per '
                        'set of three products',
    'jacobi_smooth:complex': 'the Helmholtz square: n 66,049, its three '
                             'modes, per set',
    'gmres_arnoldi:complex': 'the Helmholtz square: one restart cycle of 10 '
                             'steps on the complex A and the combine, per '
                             'cycle',
}


def helmholtz_argv(domain, problem='wave'):
    return ['--domain', domain, '--problem', problem, '--device', 'cuda']


def check_helmholtz(out, domain, problem):
    """The driver's results against the pinned JAX outputs: DoFs and
    numIter equal, the rest within TOL_HELMHOLTZ relative; the square's
    solution L2 norm within 1e-5 of 1, the interval's wave line the
    reference cache (tests/test_helmholtz.py:11-17)."""
    ref = JAX_HELMHOLTZ[(domain, problem)]
    r = out['results'].toDict()
    bad = []
    if out['info'].toDict()['DoFs'] != ref['DoFs']:
        bad.append(f"DoFs {out['info'].toDict()['DoFs']}")
    if r['numIter'] != ref['numIter']:
        bad.append(f"numIter {r['numIter']} != JAX {ref['numIter']}")
    rel = {}
    for label in ('res', 'solution L2 norm', 'L2 error'):
        if label in ref:
            rel[label] = abs(r[label] - ref[label]) / abs(ref[label])
            if rel[label] > TOL_HELMHOLTZ:
                bad.append(f'{label} {r[label]} vs JAX {ref[label]}')
    if problem == 'wave' and not abs(r['solution L2 norm'] - 1.0) <= 1e-5:
        bad.append(f"solution L2 norm {r['solution L2 norm']} not 1")
    if (domain, problem) == ('interval', 'wave') and not (
            abs(r['numIter'] - 24) <= 1 and r['L2 error'] < 5e-6):
        bad.append('the reference cache')
    log(f'  {domain} {problem}: {json.dumps(r)} (relative to JAX: '
        f'{json.dumps(rel)})')
    if bad:
        raise AssertionError(f'runHelmholtz {domain} {problem}: '
                             + '; '.join(bad))
    return rel


def phase15():
    """The Helmholtz path (runHelmholtz, complex128): K9, K10 and K17's
    complex variants against their plain versions at the square's shapes;
    the interval's wave and greens lines and the square (66,049 dofs; each
    a path) against the pinned JAX outputs, with the square's host set-up
    parts, multigrid set-up, solve, a V-cycle, a GMRES step and the peak
    memory.  Returns the launch counts, the comparisons and a summary."""
    import torch
    from pynucleus_tpu_torch.drivers.runHelmholtz import main
    log('phase 15: the Helmholtz path (runHelmholtz, complex128 GMRES with '
        'a complex-shifted V-cycle)')
    counts = {}
    for problem in ('wave', 'greens'):
        out, counts[f'interval_{problem}'] = count_path(
            f'interval {problem}', HELMHOLTZ_PATH,
            lambda: main(helmholtz_argv('interval', problem), quiet=True))
        check_helmholtz(out, 'interval', problem)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, counts['square'] = count_path(
        'square wave', HELMHOLTZ_PATH,
        lambda: main(helmholtz_argv('square'), quiet=True))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    for label, c in counts.items():
        for k in ('csr_spmv', 'jacobi_smooth', 'gmres_arnoldi'):
            # every launch of the paths is a complex one: the device counts
            # are the complex variants'
            if c[k] != c[k + ':complex']:
                raise AssertionError(f'{k}: real launches on the Helmholtz '
                                     f'path {label}')
    log('  launches: ' + json.dumps({k: counts['square'][k]
                                     for k in HELMHOLTZ_PATH}))
    rel = check_helmholtz(out, 'square', 'wave')
    tim = out['timers'].toDict()
    log('  the square (s): ' + ', '.join(
        f'{k[:-len(" seconds")]} {v:.4f}' for k, v in tim.items()
        if k.endswith(' seconds')) + f'; the driver {wall:.3f} s, peak '
        f'device memory {peak / 2**30:.3f} GiB')
    ml, b, gm, A = out['ml'], out['b'], out['gmres'], out['A']
    M = ml.asPreconditioner()
    z = torch.empty_like(b)
    M.matvec(b, out=z)
    vcycle = timed(lambda: [M.matvec(b, out=z) for _ in range(10)]) / 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gm.solve(b)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    steps = len(gm.residuals) - 1
    log(f'  V-cycle ({len(ml.levels.As)} levels, 2+2 sweeps) {vcycle:.4f} ms '
        f'(CUDA events over 10); warm GMRES solve {warm:.4f} s, {steps} '
        f'steps, {warm / steps * 1e3:.3f} ms a step')
    summary = {'dofs': A.num_rows, 'levels': len(ml.levels.As),
               'numIter': out['results'].toDict()['numIter'],
               'wall_s': wall, 'timers_s': {k: v for k, v in tim.items()
                                            if k.endswith(' seconds')},
               'peak_GiB': peak / 2**30, 'vcycle_ms': vcycle,
               'warm_solve_s': warm, 'ms_per_step': warm / steps * 1e3,
               'relative_to_jax': rel}
    P = out['hierarchy'][-1]['P']
    del out, M, z, gm
    torch.cuda.empty_cache()
    log('  complex kernels against their plain versions at the square\'s '
        'shapes')
    cmp = {'csr_spmv:complex': compare_csr_spmv(P, dtype=torch.complex128,
                                                extra=(A,)),
           'jacobi_smooth:complex': compare_jacobi_smooth(
               A.num_rows, dtype=torch.complex128),
           'gmres_arnoldi:complex': compare_gmres_arnoldi(A, b)}
    k17 = cmp['gmres_arnoldi:complex']
    summary['k17_ms_per_step'] = (k17['ms'] - k17['combine_ms']) / 10
    log(f'  summary: {json.dumps(summary)}')
    return counts, cmp, summary


# ---------------------------------------------------------------- phase 16

# JAX package outputs for the complex Greens systems on the square
# (meshFactory('square', N=2) refined 5 times, 961 dofs; greens2D, lambda
# -3j, scaling 1), printed by scripts/pin_greens_jax.py on the CPU in
# float64: ||A||_F, trace A, ||A v|| and A v[:4] (v = N(0,1) + i N(0,1),
# numpy default_rng(7)), and GMRES and BiCGStab (tolerance 1e-9, maxIter
# 300) on the load of tests/test_complex_kernels.py:141-142
JAX_GREENS = {
    'inf': {'dofs': 961, 'fro': 0.017148733378131668,
            'trace': (-0.1996025187744821, 0.4318465882786291),
            'Av_norm': 0.02391375953153697,
            'Av4': ((-0.0001876123313067591, -0.0004192064420527932),
                    (0.00013280403542498774, 0.0008050107885264486),
                    (0.0005752650481650249, 0.0001495315473655878),
                    (-0.00010084342913958057, -0.0006196227313100392)),
            'gmres': (42, 789154.0701518062),
            'bicgstab': (25, 789154.0701518168)},
    'h045': {'dofs': 961, 'fro': 0.011623362445326814,
             'trace': (0.0468629091511512, 0.3199937792067557),
             'Av_norm': 0.016258680351081498,
             'Av4': ((-0.00017623989913001054, 1.6861195206688755e-05),
                     (0.0003326299218922338, 5.112392581751349e-05),
                     (0.00032325576086731956, -0.00011435915510595168),
                     (-0.00028936039917827334, -0.00020228157284510228)),
             'gmres': (38, 1508777.0006265915),
             'bicgstab': (22, 1508777.0006265831)},
}
GREENS_LAMBDA = -3.0j
GREENS_HORIZONS = (('inf', float('inf')), ('h045', 0.45))
GREENS_PIN_NOREF = 5
GREENS_NOREF = 6
# the pinned operator numbers to 1e-11 relative; GMRES iterations equal and
# ||x|| to 1e-8, BiCGStab iterations +-1 and ||x|| to 1e-6 (its residual
# jumps); on the full-width line relative residuals below 1e-7
# (tests/test_complex_kernels.py:147) and getDiagonal = diag(A) to 1e-10
# (:94)
TOL_GREENS_PIN = 1e-11
TOL_GREENS_X = {'gmres': 1e-8, 'bicgstab': 1e-6}
TOL_GREENS_RES = 1e-7
TOL_GREENS_DIAG = 1e-10
GREENS_SOLVERS = ('gmres', 'bicgstab')
GREENS_PATH = ('panel_scatter:complex', 'panel_scatter:complex_diag',
               'gmres_arnoldi:complex', 'bicgstab_update:complex')
GREENS_PATHS = {'inf': GREENS_PATH,
                'h045': GREENS_PATH + ('cut2d_polar:complex',)}
# operations of the A&S Bessel pair at one node (a branch's two rational
# polynomials and its log, or cos, sin and sqrt, each counted as one) and
# of greens2D around it
BESSEL_OPS = 40
GREENS_COMPARED_AT = {
    'panel_scatter:complex': f'the Greens square at noRef {GREENS_NOREF} '
                             '(3,969 dofs, infinite horizon): the largest '
                             'call of getDense (dense target)',
    'panel_scatter:complex_diag': f'the Greens square at noRef '
                                  f'{GREENS_NOREF}, infinite horizon: the '
                                  'largest call of getDiagonal (diagonal '
                                  'target)',
    'cut2d_polar:complex': f'the Greens square at noRef {GREENS_NOREF}, '
                           'horizon 0.45: every call of getDense (dense '
                           'target) and getDiagonal (diagonal target)',
    'bicgstab_update:complex': f'the Greens square at noRef {GREENS_NOREF}, '
                               'horizon 0.45: 10 iterations on the dense '
                               'operator',
}


def greens_square(noRef, horizon):
    """(dm, kernel) of the Greens square on the card: uniformSquare(N=2)
    refined noRef times, P1 with Dirichlet dofs, greens2D of
    GREENS_LAMBDA."""
    from pynucleus_tpu_torch.fem.meshes import uniformSquare
    from pynucleus_tpu_torch.fem.dofmaps import P1_DoFMap
    from pynucleus_tpu_torch.nl.kernels import getComplexKernel
    mesh = uniformSquare(N=2)
    for _ in range(noRef):
        mesh = mesh.refine()
    return P1_DoFMap(mesh, device='cuda'), getComplexKernel(
        2, greensLambda=GREENS_LAMBDA, horizon=horizon, scaling=1.0)


def greens_load(n):
    """The load of tests/test_complex_kernels.py:141-142 on the card."""
    import numpy as np
    import torch
    return torch.as_tensor(np.random.RandomState(0).rand(n)
                           + 1j * np.random.RandomState(1).rand(n),
                           device='cuda')


def greens_solves(A, b):
    """GMRES and BiCGStab (no preconditioner, tolerance 1e-9, maxIter 300)
    on A x = b: {name: (iterations, x, seconds, relative residual)}."""
    import torch
    from pynucleus_tpu_torch.base.solvers import solverFactory
    out = {}
    for name in GREENS_SOLVERS:
        s = solverFactory.build(name, A=A, setup=True)
        s.tolerance, s.maxIter = 1e-9, 300
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = s.solve(b)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        res = float(torch.linalg.norm(A.matvec(x) - b)
                    / torch.linalg.norm(b))
        out[name] = (s.iterations, x, secs, res)
    return out


def check_greens_pins(label, A, d, solves):
    """The noRef 5 operator and solves against the pinned JAX outputs."""
    import numpy as np
    import torch
    ref = JAX_GREENS[label]
    n = A.num_rows
    rng = np.random.default_rng(7)
    v = torch.as_tensor(rng.standard_normal(n)
                        + 1j * rng.standard_normal(n), device='cuda')
    Av = A.matvec(v).cpu().numpy()
    tr = complex(torch.trace(A.data))
    got = {'fro': float(torch.linalg.norm(A.data)),
           'Av_norm': float(np.linalg.norm(Av))}
    bad = []
    if n != ref['dofs']:
        bad.append(f'dofs {n}')
    rel = {k: abs(got[k] - ref[k]) / abs(ref[k]) for k in got}
    rel['trace'] = abs(tr - complex(*ref['trace'])) / abs(complex(
        *ref['trace']))
    av4 = np.array([complex(*z) for z in ref['Av4']])
    rel['Av4'] = float(np.abs(Av[:4] - av4).max() / np.abs(av4).max())
    bad += [f'{k} {v:.2e}' for k, v in rel.items() if not v <= TOL_GREENS_PIN]
    derr = float((d.diagonal - torch.diagonal(A.data)).abs().max()
                 / torch.diagonal(A.data).abs().max())
    if not derr <= TOL_GREENS_DIAG:
        bad.append(f'getDiagonal vs diag(A) {derr:.2e}')
    its = {}
    for name, (it, x, _, res) in solves.items():
        refIt, refNorm = ref[name]
        xn = float(torch.linalg.norm(x))
        rel[f'{name}_x_norm'] = abs(xn - refNorm) / refNorm
        its[name] = it
        if (it != refIt if name == 'gmres' else abs(it - refIt) > 1) \
                or not rel[f'{name}_x_norm'] <= TOL_GREENS_X[name] \
                or not res <= TOL_GREENS_RES:
            bad.append(f'{name}: {it} iterations (JAX {refIt}), ||x|| {xn} '
                       f'(JAX {refNorm}), residual {res:.2e}')
    log(f'  {label} noRef {GREENS_PIN_NOREF}: iterations {its}, relative to '
        f'JAX {json.dumps(rel)}; diag(A) {derr:.2e}')
    if bad:
        raise AssertionError(f'Greens square {label}: ' + '; '.join(bad))
    return rel


def greens_line(label, horizon, noRef):
    """The full-width line of one horizon: the host classification (timed,
    its peak host memory by tracemalloc), getDense and getDiagonal (timed
    to a synchronize), GMRES and BiCGStab, the dense apply (CUDA events
    over 10).  Returns (summary, A, b)."""
    import tracemalloc
    import torch
    from pynucleus_tpu_torch.nl.assembly import nonlocalBuilder
    dm, kernel = greens_square(noRef, horizon)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    b = nonlocalBuilder(dm, kernel)
    tracemalloc.start()
    t0 = time.perf_counter()
    info = b._classifyAll()
    tClass = time.perf_counter() - t0
    hostPeak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    t0 = time.perf_counter()
    A = b.getDense()
    torch.cuda.synchronize()
    tDense = time.perf_counter() - t0
    t0 = time.perf_counter()
    d = b.getDiagonal()
    torch.cuda.synchronize()
    tDiag = time.perf_counter() - t0
    n = A.num_rows
    rhs = greens_load(n)
    solves = greens_solves(A, rhs)
    x = torch.empty_like(rhs)
    apply_ms = timed(lambda: [A.matvec(rhs, out=x) for _ in range(10)]) / 10
    peak = torch.cuda.max_memory_allocated()
    derr = float((d.diagonal - torch.diagonal(A.data)).abs().max()
                 / torch.diagonal(A.data).abs().max())
    ci, cj, _ = info['cut']
    summary = {
        'noRef': noRef, 'cells': dm.mesh.num_cells, 'dofs': n,
        'pairs': {'identical': len(info['id']),
                  'touching': len(info['touching'][0]),
                  'distant': len(info['distant'][0]), 'cut': len(ci)},
        'classification_s': tClass,
        'classification_peak_host_GiB': hostPeak / 2 ** 30,
        'getDense_s': tDense, 'getDiagonal_s': tDiag,
        'solves': {k: {'iterations': it, 'seconds': secs,
                       'relative_residual': res,
                       'x_norm': float(torch.linalg.norm(xs))}
                   for k, (it, xs, secs, res) in solves.items()},
        'apply_ms': apply_ms, 'peak_device_GiB': peak / 2 ** 30,
        'diag_vs_A': derr}
    bad = [f'{k} residual {v[3]:.2e}' for k, v in solves.items()
           if not v[3] <= TOL_GREENS_RES]
    if not derr <= TOL_GREENS_DIAG:
        bad.append(f'getDiagonal vs diag(A) {derr:.2e}')
    if not bool(torch.isfinite(torch.view_as_real(A.data)).all()):
        bad.append('non-finite entries')
    if bad:
        raise AssertionError(f'Greens square {label} noRef {noRef}: '
                             + '; '.join(bad))
    log(f'  {label} noRef {noRef}: {json.dumps(summary)}')
    return summary, (b, A, rhs)


def device_ms_by_kernel(run):
    """Device milliseconds per kernel (the six largest) of run(), under
    torch.profiler."""
    import torch
    from torch.profiler import profile, ProfilerActivity
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    dev = {}
    for ev in prof.key_averages():
        t = getattr(ev, 'device_time_total', None)
        if t is None:
            t = getattr(ev, 'cuda_time_total', 0)
        if t and ev.device_type.name == 'CUDA':
            dev[ev.key[:48]] = dev.get(ev.key[:48], 0.0) + t / 1e3
    return dict(sorted(dev.items(), key=lambda kv: -kv[1])[:6])


def panel_work_dof(args, cplx=False, mask=None, indicatorOps=0,
                   peak=F64_PEAK):
    """K1's dense or diagonal target on recorded args (shape, vertices,
    vi1, vi2, dofRows, volsym, normals (None), bary_x, bary_y, w, PSIP,
    profile), counting in this run's data the entries the target takes
    (dense: both dofs >= 0 and, with ``mask`` [nPSI, nPSI], the local entry
    kept; diagonal: row dof = column dof >= 0): per pair with such an entry
    and node the positions, r^2, the profile (one pow, exp or erfc;
    ``cplx``: the Bessel pair and greens2D) and ``indicatorOps``, per entry
    and node a multiply-add (complex: 4 operations); inputs read once, the
    entries (complex: 16 B) read and written once, at most the whole
    target, however many pairs share them; ``peak`` the rate of the
    operations' type."""
    shape, vertices, vi1, vi2, dofRows = args[:5]
    Q, dim = args[-3].shape[0], vertices.shape[1]
    r, c = dofRows[:, :, None], dofRows[:, None, :]
    takes = (r >= 0) & (c >= 0) if len(shape) == 2 else (r >= 0) & (r == c)
    if mask is not None:
        takes &= mask[None]
    perPair = takes.sum((1, 2))
    entries, pairs = int(perPair.sum()), int((perPair > 0).sum())
    ops = Q * (pairs * (2 * dim * (vi1.shape[1] + vi2.shape[1]) + 3 * dim
                        + (BESSEL_OPS if cplx else 3) + indicatorOps)
               + (4 if cplx else 2) * entries)
    return (nbytes(args[1:]) + (32 if cplx else 16)
            * min(entries, math.prod(shape)), ops, peak)


# getDiagonal of a real kernel of a finite horizon (the constant kernel of
# order 0.75 with the ball2 indicator), whose per-pair path runs K1's,
# K14's and K15's real diagonal targets: (dimension, noRef, horizon)
REAL_DIAG_LINES = ((1, 5, 0.2), (2, 3, 0.45))
REAL_DIAG_COMPARED_AT = {
    'panel_scatter': 'the real diagonal target: getDiagonal of the constant '
                     'kernel (s 0.75, ball2) on the interval at noRef 5 '
                     '(horizon 0.2) and the square at noRef 3 (horizon '
                     '0.45), all calls',
    'cut1d': 'the real diagonal target: getDiagonal of the constant kernel '
             'on the interval at noRef 5 (horizon 0.2), all calls',
    'cut2d_polar': 'the real diagonal target: getDiagonal of the constant '
                   'kernel on the square at noRef 3 (horizon 0.45), all '
                   'calls',
}


def check_real_diagonals():
    """The real diagonal targets of K1, K14 and K15 on the lines of
    REAL_DIAG_LINES: each getDiagonal against diag(getDense) (to
    TOL_GREENS_DIAG), each kernel's recorded calls against its plain
    version.  Returns {kernel: result()}."""
    import contextlib
    import numpy as np
    import torch
    import pynucleus_tpu_torch.nl.assembly as asm
    from pynucleus_tpu_torch.fem.meshes import simpleInterval, uniformSquare
    from pynucleus_tpu_torch.interop import fromArrays
    names = {'panel_scatter': 'panel_scatter_diag', 'cut1d': 'cut1d',
             'cut2d_polar': 'cut2d_polar'}
    calls = {k: [] for k in names}
    for dim, noRef, horizon in REAL_DIAG_LINES:
        mesh = simpleInterval(-1.0, 1.0) if dim == 1 else uniformSquare(N=2)
        for _ in range(noRef):
            mesh = mesh.refine()
        _, dm, kernel = fromArrays(
            np.asarray(mesh.vertices), np.asarray(mesh.cells), 0.75, dim,
            device='cuda', kernelType='constant', horizon=horizon)
        b = asm.nonlocalBuilder(dm, kernel)
        with contextlib.ExitStack() as stack:
            recs = {k: stack.enter_context(ArgRecorder(asm, n, dataFirst=True))
                    for k, n in names.items()}
            d = b.getDiagonal().diagonal
        for k, rec in recs.items():
            calls[k] += [c for c in rec.calls if k == 'panel_scatter'
                         or c[0][1] == 'diag']
        dA = torch.diagonal(b.getDense().data)
        err = float((d - dA).abs().max() / dA.abs().max())
        log(f'  real getDiagonal, dim {dim} noRef {noRef} horizon '
            f'{horizon}: {d.numel()} dofs, vs diag(getDense) {err:.2e}')
        if not err <= TOL_GREENS_DIAG:
            raise AssertionError(f'real getDiagonal dim {dim}: {err:.2e} '
                                 'from diag(getDense)')
    work = {'panel_scatter': panel_work_dof, 'cut1d': cut1d_work,
            'cut2d_polar': cut2d_work}
    out = {}
    for k, n in names.items():
        if not calls[k]:
            raise AssertionError(f'{n}: getDiagonal made no call of its '
                                 'diagonal target')
        out[k] = compare_target_kernel(
            f'{n} (real, diagonal target)', calls[k], getattr(asm, n),
            getattr(asm, f'_{n}_plain'), work[k], csr=False)
    return out


# the size of a recorded K1 call: pairs x nodes
def _k1_size(A, V, vi1, vi2, *a, **k):
    return vi1.shape[0] * a[-3].shape[0]


def phase16():
    """The complex Greens kernels: noRef 5 against the pinned JAX outputs
    (both horizons), the full-width lines at noRef 6 (each a path), then K1's
    complex dense and diagonal targets, K15's and K18's complex variants
    against their plain versions at those shapes; the real diagonal targets
    of K1, K14 and K15 (check_real_diagonals).  Returns the launch counts,
    the comparisons of the complex variants and of the real diagonal
    targets, and a summary."""
    import contextlib
    import torch
    import pynucleus_tpu_torch.nl.assembly as asm
    from pynucleus_tpu_torch import kernels
    from pynucleus_tpu_torch.nl.assembly import nonlocalBuilder
    log('phase 16: the complex Greens kernels (greens2D, lambda -3j, '
        'complex128)')
    summary = {'pins': {}}
    for label, hor in GREENS_HORIZONS:
        dm, kernel = greens_square(GREENS_PIN_NOREF, hor)
        b = nonlocalBuilder(dm, kernel)
        A, d = b.getDense(), b.getDiagonal()
        summary['pins'][label] = check_greens_pins(
            label, A, d, greens_solves(A, greens_load(A.num_rows)))
        del A, d, b
    counts, lines = {}, {}
    for label, hor in GREENS_HORIZONS:
        (summary[label], lines[label]), counts[label] = count_path(
            f'Greens {label} noRef {GREENS_NOREF}', GREENS_PATHS[label],
            lambda: greens_line(label, hor, GREENS_NOREF))
        for k in ('panel_scatter', 'bicgstab_update', 'gmres_arnoldi',
                  'cut2d_polar'):
            # every launch of these paths is a complex one
            real = counts[label][k] - sum(counts[label][c]
                                          for c in kernels.COMPLEX
                                          if c.split(':')[0] == k)
            if real:
                raise AssertionError(f'{k}: {real} real launches on the '
                                     f'Greens path {label}')
        summary[label]['launches'] = {k: counts[label][k]
                                      for k in GREENS_PATHS[label]}
    # a second getDense and getDiagonal of each line (its classification
    # kept) under torch.profiler, with the calls of its complex kernels
    # recorded for the comparisons below
    recorded = {}
    for label, names in (('inf', ('panel_scatter', 'panel_scatter_diag')),
                         ('h045', ('cut2d_polar',))):
        with contextlib.ExitStack() as stack:
            recs = {n: stack.enter_context(ArgRecorder(
                asm, n, dataFirst=True,
                size=None if n == 'cut2d_polar' else _k1_size))
                for n in names}
            b = lines[label][0]
            summary[label]['device_ms_by_kernel'] = device_ms_by_kernel(
                lambda: (b.getDense(), b.getDiagonal()))
        recorded.update(recs)
        log(f"  {label}: launches {summary[label]['launches']}; device ms "
            f"{json.dumps(summary[label]['device_ms_by_kernel'])} (a second "
            'getDense and getDiagonal under torch.profiler)')
    log('  complex kernels against their plain versions at the noRef '
        f'{GREENS_NOREF} shapes')
    cmp = {'panel_scatter:complex': compare_target_kernel(
        'panel_scatter (complex, dense)', recorded['panel_scatter'].calls,
        asm.panel_scatter, asm._panel_scatter_plain,
        functools.partial(panel_work_dof, cplx=True),
        dtype=torch.complex128)}
    cmp['panel_scatter:complex_diag'] = compare_target_kernel(
        'panel_scatter_diag (complex)', recorded['panel_scatter_diag'].calls,
        asm.panel_scatter_diag, asm._panel_scatter_diag_plain,
        functools.partial(panel_work_dof, cplx=True),
        dtype=torch.complex128, csr=False)
    cutCalls = recorded['cut2d_polar'].calls
    cmp['cut2d_polar:complex'] = merge(*(compare_target_kernel(
        f'cut2d_polar (complex, {t})',
        [c for c in cutCalls if c[0][1] == t], asm.cut2d_polar,
        asm._cut2d_polar_plain, functools.partial(cut2d_work, cplx=True),
        dtype=torch.complex128,
        csr=False) for t in ('dense', 'diag')))
    _, A, rhs = lines['h045']
    cmp['bicgstab_update:complex'] = compare_bicgstab_update(A, rhs)
    del lines, recorded, cutCalls, A, rhs
    torch.cuda.empty_cache()
    log('  the real diagonal targets of K1, K14 and K15')
    diag = check_real_diagonals()
    log(f'phase 16 summary: {json.dumps(summary)}')
    return counts, cmp, diag, summary


# ---------------------------------------------------------------- phase 17

# JAX package outputs printed by scripts/pin_finite_horizon_jax.py (the JAX
# package on the CPU, float64): runNonlocal's disc with its collar at noRef
# 3 (sparse cg-mg, horizon 0.2; ball2, and ballInf whose reference
# normalization is not the Laplacian's, hence its error), held as phase 10
# holds the square: dofs, iterations +-1, the error within rtol 3e-2
JAX_DISC = {'ball2': {'dofs': 652, 'iterations': 8,
                      'L2 error interpolated': 6.700082e-03},
            'ballInf': {'dofs': 652, 'iterations': 7,
                        'L2 error interpolated': 1.319149}}
# ball1 (normalized) and the ellipse (1, 0.5; not normalized): the
# indicator kernel of horizon 0.2 on squareWithInteractions(0, 0, 1, 1,
# horizon 0.2, h 0.05), P1 on every vertex, getDense (zeroExterior=False);
# u = x^2 + y^2 at the dofs
JAX_BALLS = {
    'ball1': {'dofs': 841, 'fro': 4.9688959339166905,
              'Au_norm': 0.24162593702890933,
              'Au4': (0.001281741793866256, 0.0012135224393379708,
                      0.00382576603848371, 0.0012139050051944908)},
    'ellipse': {'dofs': 841, 'fro': 0.0020412554646502155,
                'Au_norm': 0.00010772447195555381,
                'Au4': (5.097751282889938e-07, 4.242764882901095e-07,
                        1.4672392160325357e-06, 5.380474531157207e-07)}}
# the variable horizon delta(x) = 0.1 + 0.05 (x + 1) in [0.1, 0.2], s 0.25,
# on the interval refined 6 times (interior dofs): getSparse, A v for
# v = N(0, 1) of numpy default_rng(7), GMRES (tolerance 1e-10, maxIter 500)
# on A u = A 1
JAX_VAR_HORIZON = {'dofs': 63, 'fro': 95.59811706975316,
                   'Av_norm': 80.42724417876033,
                   'Av4': (4.836684283815838, 5.947150013627837,
                           -2.720730805426254, -9.86936136257175),
                   'gmres_iterations': 40, 'x_norm': 7.937253933193434}
TOL_FH_PIN = 1e-11
TOL_FH_X = 1e-8
DISC_PIN_NOREF = 3
DISC_NOREF = 4
# name -> (interaction arguments, normalized)
BALLS = {'ball1': ((), True), 'ellipse': ((1.0, 0.5), False)}
BALLS_PIN_H = 0.05
BALLS_H = 0.025
# the patch ratio of tests/test_kernels_extra.py _patchTest (ball1, the
# reference's ballInf convention): mean -2 within 5 %, each within 15 %
BALL1_RATIO = -2.0
# (c0, c, min, max) of delta(x) = clip(c0 + c x, min, max), and s
VH_PIN = ((0.15, 0.05, 0.1, 0.2), 0.25)
VH_CHECK = ((0.25, 0.1, 0.15, 0.35), 0.4)
VH_PIN_NOREF = 6
VH_CHECK_NOREF = 12
# the full-width variable horizon (cut so that the script keeps within its
# time limit, PERF.md section 4)
VH_NOREF = 12
TOL_VH_RES = 1e-10
BALL_PATH = ('panel_scatter', 'cut2d_polar', 'panel_scatter:dense',
             'panel_scatter:slots')
VH_PATH = ('panel_scatter_nonsym', 'panel_scatter_nonsym:slots',
           'panel_scatter_nonsym:var_horizon', 'csr_spmv', 'gmres_arnoldi')
# operations of an interaction indicator at one node (|x-y| in the ball's
# norm and the comparison)
INDICATOR_OPS = 6
HORIZON_COMPARED_AT = {
    'cut2d_polar:ball1': f'the ball1 square at h {BALLS_H} (6,272 cells): '
                         'the largest call of getSparse (CSR slots)',
    'cut2d_polar:ellipse': f'the ellipse square at h {BALLS_PIN_H}: every '
                           'call of getDense and getSparse',
    'panel_scatter:ball1': f'the ball1 square at h {BALLS_H}: the largest '
                           'calls of the dense and the CSR slots targets',
    'panel_scatter:ellipse': f'the ellipse square at h {BALLS_PIN_H}: every '
                             'call of the dense and the CSR slots targets',
    'panel_scatter_nonsym:var_horizon': f'the variable horizon at noRef '
                                        f'{VH_NOREF}: its largest getSparse '
                                        'call (slots) and the largest noRef '
                                        f'{VH_CHECK_NOREF} getDense call '
                                        '(dense)',
}


# the JAX programs each variant replaces
HORIZON_REPLACES = {
    'cut2d_polar:ball1': 'pynucleus_tpu/nl/assembly.py:511 (ball1: '
                         ':554-556, nl/kernels.py:815)',
    'cut2d_polar:ellipse': 'pynucleus_tpu/nl/assembly.py:511 (ellipse: '
                           'nl/kernels.py:856)',
    'panel_scatter:ball1': 'pynucleus_tpu/nl/assembly.py:91 (ball1 '
                           'jaxIndicator, nl/kernels.py:808)',
    'panel_scatter:ellipse': 'pynucleus_tpu/nl/assembly.py:91 (ellipse '
                             'jaxIndicator, nl/kernels.py:845)',
    'panel_scatter_nonsym:var_horizon': 'pynucleus_tpu/nl/assembly.py:424 '
                                        'on the fallback :2509-2537 '
                                        '(nl/kernels.py:1384-1398)',
}


def FH17_PATHS(counts17):
    """The main paths of phase 17: (kernels, label, launch counts)."""
    return ((NONLOCAL_PATH, f'fh_disc_sparse_cg_mg_noRef{DISC_NOREF}',
             counts17['disc']),
            (BALL_PATH, f'ball1_square_h{BALLS_PIN_H}', counts17['ball1_pin']),
            (BALL_PATH, f'ellipse_square_h{BALLS_PIN_H}',
             counts17['ellipse_pin']),
            (BALL_PATH, f'ball1_square_h{BALLS_H}', counts17['ball1']),
            (VH_PATH, f'var_horizon_interval_noRef{VH_PIN_NOREF}',
             counts17['vh_pin']),
            (VH_PATH, f'var_horizon_interval_noRef{VH_NOREF}',
             counts17['vh']))


def check_disc_pin(interaction):
    """runNonlocal's disc at DISC_PIN_NOREF against the pinned JAX
    outputs."""
    from pynucleus_tpu_torch.drivers.runNonlocal import main
    out = main(nonlocal_argv('disc', DISC_PIN_NOREF, 'sparse', 'cg-mg')
               + ['--interaction', interaction], quiet=True)
    res, errs = out['results'].toDict(), out['errors'].toDict()
    ref = JAX_DISC[interaction]
    got = errs['L2 error interpolated']
    if res['dofs'] != ref['dofs'] or \
            abs(res['iterations'] - ref['iterations']) > 1 or \
            not abs(got - ref['L2 error interpolated']) \
            <= RTOL_ERRORS * ref['L2 error interpolated']:
        raise AssertionError(f'disc noRef {DISC_PIN_NOREF} {interaction}: '
                             f'{res}, {errs} vs JAX {ref}')
    log(f"  disc noRef {DISC_PIN_NOREF} {interaction} sparse cg-mg: dofs "
        f"{res['dofs']}, iterations {res['iterations']}, L2 error "
        f'interpolated {got:.7e}: the JAX outputs (dofs, iterations +-1, '
        f'error rtol {RTOL_ERRORS})')
    return got


def disc_line():
    """The full-width disc (DISC_NOREF, a path): the driver's parts, then
    the finest classification again under tracemalloc (its peak host
    memory)."""
    import tracemalloc
    from pynucleus_tpu_torch.nl.panels import classifyPairsDense
    out, counts = run_nonlocal_path(
        nonlocal_argv('disc', DISC_NOREF, 'sparse', 'cg-mg'), NONLOCAL_PATH)
    tim, res = out['timers'].toDict(), out['results'].toDict()
    dm = out['dm']
    tracemalloc.start()
    t0 = time.perf_counter()
    classifyPairsDense(dm, out['kernel'])
    tClass = time.perf_counter() - t0
    hostPeak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    summary = {
        'noRef': DISC_NOREF, 'dofs': res['dofs'],
        'cells': dm.mesh.num_cells, 'iterations': res['iterations'],
        'L2 error interpolated':
            out['errors'].toDict()['L2 error interpolated'],
        'assembly_s': tim['assembly seconds'],
        'finest_classification_s': tim[f'assembly level {DISC_NOREF} '
                                       'classification seconds'],
        'classification_again_s': tClass,
        'classification_peak_host_GiB': hostPeak / 2 ** 30,
        'A_BC_s': tim['A_BC seconds'], 'solve_s': tim['solve seconds'],
        'peak_device_GiB': out['peak'] / 2 ** 30}
    return summary, counts


def ball_square(name, h, device='cuda'):
    """(dm, kernel) of the ball ``name`` on squareWithInteractions(0, 0, 1,
    1, horizon 0.2, h), P1 on every vertex, the indicator kernel of horizon
    0.2 (BALLS)."""
    import numpy as np
    from pynucleus_tpu_torch.fem.meshes import squareWithInteractions
    from pynucleus_tpu_torch.fem.dofmaps import P1_DoFMap
    from pynucleus_tpu_torch.nl.kernels import (getIntegrableKernel,
                                                interactionFactory,
                                                INDICATOR)
    args, normalized = BALLS[name]
    mesh = squareWithInteractions(ax=0, ay=0, bx=1, by=1, horizon=0.2, h=h)
    dm = P1_DoFMap(mesh, np.ones(mesh.num_vertices, dtype=bool),
                   device=device)
    return dm, getIntegrableKernel(2, INDICATOR, 0.2,
                                   interaction=interactionFactory[name](*args),
                                   normalized=normalized)


def _patch_u(dm):
    import torch
    xy = dm.getDoFCoordinates()
    return xy, torch.as_tensor(xy[:, 0] ** 2 + xy[:, 1] ** 2, device='cuda')


def ball_pin_line(name):
    """getDense and getSparse of the ball at BALLS_PIN_H against the pinned
    JAX outputs (1e-11 relative) and each other (1e-12)."""
    import numpy as np
    import torch
    from pynucleus_tpu_torch.nl.assembly import nonlocalBuilder
    dm, kernel = ball_square(name, BALLS_PIN_H)
    b = nonlocalBuilder(dm, kernel, zeroExterior=False)
    A, S = b.getDense(), b.getSparse()
    _, u = _patch_u(dm)
    Au = A.matvec(u).cpu().numpy()
    ref = JAX_BALLS[name]
    got = {'fro': float(torch.linalg.norm(A.data)),
           'Au_norm': float(np.linalg.norm(Au))}
    rel = {k: abs(got[k] - ref[k]) / abs(ref[k]) for k in got}
    rel['Au4'] = float(np.abs(Au[:4] - np.array(ref['Au4'])).max()
                       / np.abs(ref['Au4']).max())
    x = torch.randn(A.num_rows, dtype=torch.float64, device='cuda',
                    generator=torch.Generator('cuda').manual_seed(11))
    rel['sparse_vs_dense'] = float(torch.linalg.norm(S.matvec(x)
                                                     - A.matvec(x))
                                   / torch.linalg.norm(A.matvec(x)))
    bad = [f'{k} {v:.2e}' for k, v in rel.items()
           if not v <= (TOL_KERNEL if k == 'sparse_vs_dense' else TOL_FH_PIN)]
    if A.num_rows != ref['dofs']:
        bad.append(f'dofs {A.num_rows}')
    log(f'  {name} h {BALLS_PIN_H}: {A.num_rows} dofs, relative to JAX '
        f'{json.dumps(rel)}')
    if bad:
        raise AssertionError(f'{name} h {BALLS_PIN_H}: ' + '; '.join(bad))
    return rel


def ball_line(name, h):
    """The full-width ball square at h (a path): the host classification
    (seconds, peak host memory), getSparse and getDense (seconds to a
    synchronize), sparse = dense, the patch ratio of tests/
    test_kernels_extra.py on interior dofs, the sparse apply (CUDA events
    over 10).  Returns (summary, builder)."""
    import tracemalloc
    import numpy as np
    import torch
    from pynucleus_tpu_torch.fem.assembly import assembleMass
    from pynucleus_tpu_torch.nl.assembly import nonlocalBuilder
    dm, kernel = ball_square(name, h)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    b = nonlocalBuilder(dm, kernel, zeroExterior=False)
    tracemalloc.start()
    t0 = time.perf_counter()
    info = b._classifyAll()
    tClass = time.perf_counter() - t0
    hostPeak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    t0 = time.perf_counter()
    S = b.getSparse()
    torch.cuda.synchronize()
    tSparse = time.perf_counter() - t0
    t0 = time.perf_counter()
    A = b.getDense()
    torch.cuda.synchronize()
    tDense = time.perf_counter() - t0
    x = torch.randn(A.num_rows, dtype=torch.float64, device='cuda',
                    generator=torch.Generator('cuda').manual_seed(12))
    y = torch.empty_like(x)
    apply_ms = timed(lambda: [S.matvec(x, out=y) for _ in range(10)]) / 10
    sparseErr = float((csr_to_dense(S, A.data) - A.data).abs().max()
                      / A.data.abs().max())
    xy, u = _patch_u(dm)
    r = A.matvec(u).cpu().numpy()
    lumped = np.asarray(assembleMass(dm).toarray()).sum(axis=1)
    inner = ((xy[:, 0] > 0.2 + 2 * h) & (xy[:, 0] < 1 - 0.2 - 2 * h)
             & (xy[:, 1] > 0.2 + 2 * h) & (xy[:, 1] < 1 - 0.2 - 2 * h))
    ratio = r[inner] / lumped[inner]
    ci, cj, _ = info['cut']
    summary = {
        'h': h, 'cells': dm.mesh.num_cells, 'dofs': A.num_rows,
        'nnz': S.nnz,
        'pairs': {'identical': len(info['id']),
                  'touching': len(info['touching'][0]),
                  'distant': len(info['distant'][0]), 'cut': len(ci)},
        'classification_s': tClass,
        'classification_peak_host_GiB': hostPeak / 2 ** 30,
        'getSparse_s': tSparse, 'getDense_s': tDense,
        'sparse_vs_dense': sparseErr, 'apply_ms': apply_ms,
        'patch_ratio_mean': float(ratio.mean()),
        'patch_ratio_range': (float(ratio.min()), float(ratio.max())),
        'interior_dofs': int(inner.sum()),
        'peak_device_GiB': torch.cuda.max_memory_allocated() / 2 ** 30}
    bad = []
    if not sparseErr <= TOL_KERNEL:
        bad.append(f'sparse vs dense {sparseErr:.2e}')
    if not abs(ratio.mean() - BALL1_RATIO) < 5e-2 * abs(BALL1_RATIO) or \
            not np.all(np.abs(ratio - BALL1_RATIO)
                       <= 15e-2 * abs(BALL1_RATIO)):
        bad.append(f'patch ratio mean {ratio.mean()}, range '
                   f'[{ratio.min()}, {ratio.max()}]')
    if bad:
        raise AssertionError(f'{name} h {h}: ' + '; '.join(bad))
    log(f'  {name} h {h}: {json.dumps(summary)}')
    return summary, b


def vh_interval(noRef, horizon, s):
    """(dm, kernel) of the variable horizon on the interval refined noRef
    times, interior dofs."""
    from pynucleus_tpu_torch.fem.meshes import simpleInterval
    from pynucleus_tpu_torch.fem.dofmaps import P1_DoFMap
    from pynucleus_tpu_torch.nl.kernels import (getFractionalKernel,
                                                horizonFunction)
    mesh = simpleInterval(-1.0, 1.0)
    for _ in range(noRef):
        mesh = mesh.refine()
    return P1_DoFMap(mesh, device='cuda'), getFractionalKernel(
        1, s, horizon=horizonFunction(*horizon))


def vh_gmres(A, b, tol):
    """Unpreconditioned GMRES on A x = b (one cycle of at most 5,000 Arnoldi
    steps, tolerance tol on the residual): (iterations, x, seconds,
    relative residual)."""
    import torch
    from pynucleus_tpu_torch.base.solvers import solverFactory
    s = solverFactory.build('gmres', A=A, setup=True)
    s.tolerance, s.maxIter = tol, 5000
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = s.solve(b)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return s.iterations, x, secs, float(torch.linalg.norm(A.matvec(x) - b)
                                        / torch.linalg.norm(b))


def vh_pin_line():
    """getSparse of the variable horizon at VH_PIN_NOREF and GMRES against
    the pinned JAX outputs."""
    import numpy as np
    import torch
    from pynucleus_tpu_torch.nl.assembly import nonlocalBuilder
    dm, kernel = vh_interval(VH_PIN_NOREF, *VH_PIN)
    A = nonlocalBuilder(dm, kernel).getSparse()
    n = A.num_rows
    v = torch.as_tensor(np.random.default_rng(7).standard_normal(n),
                        device='cuda')
    Av = A.matvec(v).cpu().numpy()
    ref = JAX_VAR_HORIZON
    its, x, _, res = vh_gmres(A, A.matvec(torch.ones_like(v)), 1e-10)
    got = {'fro': float(torch.linalg.norm(A.data)),
           'Av_norm': float(np.linalg.norm(Av)),
           'x_norm': float(torch.linalg.norm(x))}
    rel = {k: abs(got[k] - ref[k]) / abs(ref[k]) for k in got}
    rel['Av4'] = float(np.abs(Av[:4] - np.array(ref['Av4'])).max()
                       / np.abs(ref['Av4']).max())
    bad = [f'{k} {v:.2e}' for k, v in rel.items()
           if not v <= (TOL_FH_X if k == 'x_norm' else TOL_FH_PIN)]
    if n != ref['dofs'] or abs(its - ref['gmres_iterations']) > 1:
        bad.append(f'dofs {n}, GMRES iterations {its} (JAX '
                   f"{ref['gmres_iterations']})")
    log(f'  variable horizon noRef {VH_PIN_NOREF}: {n} dofs, GMRES {its} '
        f'iterations, relative to JAX {json.dumps(rel)}')
    if bad:
        raise AssertionError('variable horizon pins: ' + '; '.join(bad))
    return rel


def vh_check():
    """getDense against getSparse of the second variable horizon at
    VH_CHECK_NOREF (entries, 1e-12 of the largest)."""
    from pynucleus_tpu_torch.nl.assembly import nonlocalBuilder
    dm, kernel = vh_interval(VH_CHECK_NOREF, *VH_CHECK)
    b = nonlocalBuilder(dm, kernel)
    D, S = b.getDense(), b.getSparse()
    err = float((csr_to_dense(S, D.data) - D.data).abs().max()
                / D.data.abs().max())
    log(f'  variable horizon noRef {VH_CHECK_NOREF} (s {VH_CHECK[1]}): '
        f'{D.num_rows} dofs, getDense vs getSparse {err:.2e}')
    if not err <= TOL_KERNEL:
        raise AssertionError(f'variable horizon noRef {VH_CHECK_NOREF}: '
                             f'dense vs sparse {err:.2e}')
    return err


def vh_line():
    """The full-width variable horizon (VH_NOREF, a path): getSparse (host
    classification and pattern, device fill), the apply (CUDA events over
    10), unpreconditioned GMRES of A u = A 1 to TOL_VH_RES relative, the
    peak device memory.  Returns (summary, builder)."""
    import torch
    from pynucleus_tpu_torch.nl.assembly import nonlocalBuilder
    dm, kernel = vh_interval(VH_NOREF, *VH_PIN)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    b = nonlocalBuilder(dm, kernel)
    t0 = time.perf_counter()
    A = b.getSparse()
    torch.cuda.synchronize()
    tSparse = time.perf_counter() - t0
    ones = torch.ones(A.num_rows, dtype=torch.float64, device='cuda')
    rhs = A.matvec(ones)
    y = torch.empty_like(rhs)
    apply_ms = timed(lambda: [A.matvec(ones, out=y) for _ in range(10)]) / 10
    its, x, secs, res = vh_gmres(A, rhs, TOL_VH_RES
                                 * float(torch.linalg.norm(rhs)))
    summary = {'noRef': VH_NOREF, 'cells': dm.mesh.num_cells,
               'dofs': A.num_rows, 'nnz': A.nnz,
               'getSparse_s': tSparse, 'parts_s': dict(b.timers),
               'apply_ms': apply_ms, 'gmres_iterations': its,
               'gmres_s': secs, 'relative_residual': res,
               'error_vs_1': float(torch.linalg.norm(x - ones)
                                   / torch.linalg.norm(ones)),
               'peak_device_GiB': torch.cuda.max_memory_allocated() / 2 ** 30}
    if not res <= TOL_VH_RES * 1.01 or not bool(torch.isfinite(A.data).all()):
        raise AssertionError(f'variable horizon noRef {VH_NOREF}: '
                             f'{json.dumps(summary)}')
    log(f'  variable horizon noRef {VH_NOREF}: {json.dumps(summary)}')
    return summary, b


def csr_to_dense(S, like):
    """The CSR operator S as a dense tensor of like's shape and device."""
    import torch
    D = torch.zeros_like(like)
    D[torch.repeat_interleave(torch.arange(S.num_rows, device=like.device),
                              torch.diff(S.indptr.long())),
      S.indices.long()] = S.data.to(like.dtype)
    return D


def _k19_size(A, V, vi1, vi2, index, volsym, bary_x, bary_y, w, *a):
    """The size of a recorded K19 call: pairs x nodes."""
    return vi1.shape[0] * w.shape[0]


# K19 with the ball2 indicator alone (no order, no variable horizon): an
# instance that no path of the port runs, checked on the variable horizon's
# calls
RADIAL_INDICATOR_COMPARED_AT = (
    f'off the main path (no caller gives K19 an indicator without an order '
    f'or a variable horizon; the launches are var_horizon\'s): the '
    f'var_horizon calls (the noRef {VH_NOREF} getSparse call and the noRef '
    f'{VH_CHECK_NOREF} getDense call) with the horizon dropped, the radial '
    f'power profile and the ball2 indicator')


def _radial_k19(calls):
    """K19 calls with the variable horizon dropped (the radial power
    profile and the interaction indicator alone)."""
    return [((*args[:12], None, args[13], None), kw) for args, kw in calls]


def phase17():
    """The finite-horizon cut pairs: the disc with its collar (runNonlocal,
    pins at noRef 3, the full-width noRef 4 line), ball1 and the ellipse
    through the library call (pins at h 0.05, ball1 at h 0.025 with its
    patch ratio), the variable horizon on the interval (pins at noRef 6,
    dense = sparse at noRef 12, the full-width noRef 13 line with GMRES);
    each full-width line and pin line a path.  Then K15 and K1 with ball1
    and the ellipse and K19 with the variable horizon (and with its
    indicator alone) against their plain versions.  Returns the launch
    counts of the paths, the comparisons of the variants and a summary."""
    import contextlib
    import pynucleus_tpu_torch.nl.assembly as asm
    log('phase 17: the finite-horizon cut pairs (the disc with its collar, '
        'ball1, the ellipse, the variable horizon)')
    summary = {'disc_pins': {i: check_disc_pin(i) for i in JAX_DISC}}
    counts = {}
    summary['disc'], counts['disc'] = disc_line()

    def recorders(stack, names, largest):
        sizes = {'panel_scatter': _k1_size, 'panel_scatter_slots': _k1_size,
                 'cut2d_polar': lambda o, t, i, v, vi1, *a, **k: vi1.shape[0],
                 'panel_scatter_nonsym': _k19_size,
                 'panel_scatter_nonsym_slots': _k19_size}
        return {n: stack.enter_context(ArgRecorder(
            asm, n, dataFirst=True, size=sizes[n] if largest else None))
            for n in names}
    k1k15 = ('panel_scatter', 'panel_scatter_slots', 'cut2d_polar')
    recs = {}
    summary['ball_pins'] = {}
    for name in BALLS:
        with contextlib.ExitStack() as stack:
            rec = recorders(stack, k1k15, largest=False)
            summary['ball_pins'][name], counts[name + '_pin'] = count_path(
                f'{name} h {BALLS_PIN_H}', BALL_PATH
                + ('panel_scatter:' + name, 'cut2d_polar:' + name),
                lambda: ball_pin_line(name))
        recs[name] = rec
    with contextlib.ExitStack() as stack:
        recs['ball1'] = recorders(stack, k1k15, largest=True)
        (summary['ball1'], b), counts['ball1'] = count_path(
            f'ball1 h {BALLS_H}', BALL_PATH + ('panel_scatter:ball1',
                                               'cut2d_polar:ball1'),
            lambda: ball_line('ball1', BALLS_H))
    summary['ball1']['device_ms_by_kernel'] = device_ms_by_kernel(
        b.getSparse)
    log(f"  ball1 h {BALLS_H}: device ms of a second getSparse "
        f"{json.dumps(summary['ball1']['device_ms_by_kernel'])}")
    del b

    (summary['vh_pins'], counts['vh_pin']) = count_path(
        f'variable horizon noRef {VH_PIN_NOREF}', VH_PATH, vh_pin_line)
    with contextlib.ExitStack() as stack:
        k19d = recorders(stack, ('panel_scatter_nonsym',), largest=True)
        summary['vh_check'] = vh_check()
    with contextlib.ExitStack() as stack:
        k19s = recorders(stack, ('panel_scatter_nonsym_slots',), largest=True)
        (summary['vh'], b), counts['vh'] = count_path(
            f'variable horizon noRef {VH_NOREF}', VH_PATH, vh_line)
    summary['vh']['device_ms_by_kernel'] = device_ms_by_kernel(b.getSparse)
    log(f"  variable horizon noRef {VH_NOREF}: device ms of a second "
        f"getSparse {json.dumps(summary['vh']['device_ms_by_kernel'])}")
    del b

    log('  the finite-horizon variants against their plain versions')
    cmp = {}
    for name, at in (('ball1', 'ball1'), ('ellipse', 'ellipse')):
        r = recs[at]
        cmp['cut2d_polar:' + name] = compare_target_kernel(
            f'cut2d_polar ({name})', r['cut2d_polar'].calls, asm.cut2d_polar,
            asm._cut2d_polar_plain, cut2d_work)
        cmp['panel_scatter:' + name] = merge(
            compare_target_kernel(f'panel_scatter ({name}, dense)',
                                  r['panel_scatter'].calls, asm.panel_scatter,
                                  asm._panel_scatter_plain, panel_work),
            compare_target_kernel(f'panel_scatter ({name}, slots)',
                                  r['panel_scatter_slots'].calls,
                                  asm.panel_scatter_slots,
                                  asm._panel_scatter_slots_plain, panel_work))
    dense, slots = k19d['panel_scatter_nonsym'].calls, \
        k19s['panel_scatter_nonsym_slots'].calls
    for key, conv in (('var_horizon', list), ('radial_indicator',
                                              _radial_k19)):
        cmp['panel_scatter_nonsym:' + key] = merge(
            compare_target_kernel(f'panel_scatter_nonsym ({key}, dense)',
                                  conv(dense), asm.panel_scatter_nonsym,
                                  _k19_plain('dense'), nonsym_work),
            compare_target_kernel(f'panel_scatter_nonsym ({key}, slots)',
                                  conv(slots), asm.panel_scatter_nonsym_slots,
                                  _k19_plain('slots'), nonsym_work))
    log(f'phase 17 summary: {json.dumps(summary)}')
    return counts, cmp, summary


# ----------------------------------------------------------------- phase 18

# JAX package outputs printed by scripts/pin_matrix_formats_jax.py (the JAX
# package on the CPU, float64): assembleNonlocal(..., 'H2corrected') of the
# fractional kernel of order 0.25, horizon 0.4 then (setKernel) 0.3, on
# nonlocalMeshFactory's interval [-1, 1] and square [-1, 1]^2 with their
# collars refined noRef times, P1 on the interior dofs: the largest entry,
# ||A||_F and the trace of toarray, ||A x|| and (A x)[:4] for x_k =
# cos(0.3 k), diag(A)[:4]; at noRef 6 CG-Jacobi (tolerance 1e-10) on A x =
# M 1.  Held to 1e-12 (relative; the four values of (A x)[:4] and of
# diag(A)[:4] to 1e-12 of their largest), the CG to its iterations and
# ||x|| to 1e-10
JAX_H2CORRECTED = {
    'interval3': {
        'dofs': 39,
        'delta0.4': {'max_entry': 3.43629131455915, 'fro': 22.483109524235743,
                     'trace': 134.01534417216843,
                     'Ax_norm': 15.393511041137403,
                     'Ax4': (3.0702574256645, 3.4936274390749276,
                             2.9885848925181144, 2.742768130489105),
                     'diag4': (3.436290132062319, 3.4362901320623234,
                               3.436291314559141, 3.4362901320623207)},
        'delta0.3': {'max_entry': 4.992795249675726, 'fro': 32.918636171391995,
                     'trace': 194.71898841689614, 'Ax_norm': 22.54704654320238,
                     'Ax4': (4.437427548353948, 5.121335744762,
                             4.408153696725973, 4.148154303662659),
                     'diag4': (4.992793429102758, 4.992793429102763,
                               4.992795249675712, 4.992793429102759)}},
    'interval6': {
        'dofs': 319,
        'delta0.4': {'max_entry': 1.5006042493905074, 'fro': 27.55500775233263,
                     'trace': 478.69275552829123,
                     'Ax_norm': 20.507355299398967,
                     'Ax4': (1.7264555731578641, 1.232474009564784,
                             0.9624768543979779, 0.4983947940433392),
                     'diag4': (1.5006042493904879, 1.5006042493040108,
                               1.500604249304022, 1.5006042493904974)},
        'cg_jacobi': {'iterations': 32, 'x_norm': 7.855299249784022},
        'delta0.3': {'max_entry': 2.273116213938449, 'fro': 41.7905859385917,
                     'trace': 725.1240722043638, 'Ax_norm': 31.08242042398427,
                     'Ax4': (2.6403599105640603, 1.849223172481293,
                             1.4474220882821704, 0.731060503790059),
                     'diag4': (2.273116213938419, 2.2731162138052787,
                               2.2731162138052956, 2.2731162139384335)}},
    'square1': {
        'dofs': 81,
        'delta0.4': {'max_entry': 1.6360945791999062,
                     'fro': 13.342829891418393, 'trace': 116.30113138463994,
                     'Ax_norm': 8.129482285378522,
                     'Ax4': (1.214334389681373, 1.1260343489384765,
                             0.6457998590971235, 0.4483387840988997),
                     'diag4': (1.4566440834146952, 1.6360945791999044,
                               1.4375005073709635, 1.4567149908136683)},
        'delta0.3': {'max_entry': 2.0554760722948706,
                     'fro': 17.425852255083484, 'trace': 150.46320056522558,
                     'Ax_norm': 9.97088665226877,
                     'Ax4': (1.4855642768064476, 1.2912963280789285,
                             0.6966044008286523, 0.5539447201861578),
                     'diag4': (1.8906011055449197, 2.0554760722948675,
                               1.8586688843238446, 1.8907102746272781)}}}
MF_S, MF_DELTA, MF_DELTA2 = 0.25, 0.4, 0.3
MF_PINS = (('interval', 3), ('interval', 6), ('square', 1))
MF_NOREF = 10
MF_SQUARE_NOREF = 3
# H2corrected against the exact sparse operator (max entry difference over
# the largest entry; relative apply difference) in the JAX package
# (`scripts/pin_matrix_formats_jax.py --table`), below the full-width
# lines: the interval at noRef 7 at horizon 0.4 (the smaller of its two
# horizons' differences), which the interval at noRef MF_NOREF must fall below at
# either horizon; the square at noRef 2 at each horizon, which the square
# at noRef 3 must fall below at that horizon
_INTERVAL_BAR = {'entries': 1.4647666951596097e-05,
                 'matvec': 2.0723297528951998e-05}
MF_BARS = {'interval': {0.4: _INTERVAL_BAR, 0.3: _INTERVAL_BAR},
           'square': {0.4: {'entries': 0.00016034905597522565,
                            'matvec': 0.00022231383225516983},
                      0.3: {'entries': 0.0001778699733906907,
                            'matvec': 0.0002566527656905752}}}
TOL_MF_PIN = 1e-12
TOL_MF_X = 1e-10
MF_CG_TOL = 1e-10
# getDiagonal with the zero-exterior term: s, and (domain, noRef)
MF_DIAG_S = 0.6
MF_DIAG_LINES = (('interval', 12), ('disc', 4))
MF_SPARSIFIED_NOREF = 8
H2C_KERNELS = ('panel_scatter', 'panel_scatter:dense',
               'panel_scatter:complement', 'h2_matvec', 'csr_spmv',
               'csr_scatter')
MF_CG_PATH = H2C_KERNELS + ('pcg_update', 'pcg_update:jacobi')
MF_LINE_PATH = INTERVAL_LU_PATH + H2C_KERNELS[1:] + ('panel_scatter:slots',)
MF_LINES = {'interval': (MF_NOREF, MF_LINE_PATH + ('cut1d', 'pcg_update',
                                                   'pcg_update:jacobi')),
            'square': (MF_SQUARE_NOREF, MF_LINE_PATH + ('cut2d_polar',))}
MF_DIAG_PATH = ('panel_scatter', 'panel_scatter:diag',
                'panel_scatter:diag_exterior', 'panel_scatter:dense')
MF_SPARSIFIED_PATH = ('panel_scatter', 'panel_scatter:dense',
                      'panel_scatter:slots', 'cut1d')
FORMATS_COMPARED_AT = {
    'panel_scatter:complement': f'the largest calls of the cross operators '
                                f'of the interval at noRef {MF_NOREF} '
                                f'(delta {MF_DELTA} and {MF_DELTA2}) and of '
                                f'the square at noRef {MF_SQUARE_NOREF} '
                                '(dense target, the block mask)',
    'panel_scatter:diag_exterior': 'every call of the zero-exterior term of '
                                   'getDiagonal on the interval at noRef '
                                   f'{MF_DIAG_LINES[0][1]} and the disc at '
                                   f'noRef {MF_DIAG_LINES[1][1]} (normals)',
}
# the JAX programs each variant replaces
FORMATS_REPLACES = {
    'panel_scatter:complement': 'pynucleus_tpu/nl/assembly.py:91 with '
                                'ball2Complement.jaxIndicator (nl/kernels.py'
                                ':868-870), from _getComplementCross '
                                '(:4076-4134)',
    'panel_scatter:diag_exterior': 'pynucleus_tpu/nl/assembly.py:91 with the '
                                   'boundary kernel into _DiagAccumulator '
                                   '(:926) via _addZeroExterior (:4405)',
}


def FORMATS18_PATHS(counts18):
    """The main paths of phase 18: (kernels, label, launch counts)."""
    return tuple(
        (MF_CG_PATH if noRef == 6 else H2C_KERNELS,
         f'h2corrected_{domain}_noRef{noRef}', counts18[f'{domain}{noRef}'])
        for domain, noRef in MF_PINS) + tuple(
        (path, f'h2corrected_{domain}_noRef{noRef}', counts18[domain])
        for domain, (noRef, path) in MF_LINES.items()) + tuple(
        (MF_DIAG_PATH, f'diagonal_{domain}_noRef{noRef}',
                 counts18['diag_' + domain])
                for domain, noRef in MF_DIAG_LINES) + (
        (MF_SPARSIFIED_PATH, f'sparsified_interval_noRef{MF_SPARSIFIED_NOREF}',
         counts18['sparsified']),)


def mf_setup(domain, noRef, horizon=MF_DELTA):
    """(dm, kernel): the fractional kernel of order MF_S and the horizon on
    nonlocalMesh's domain with its collar (HOMOGENEOUS_DIRICHLET) refined
    noRef times, P1 on the interior dofs, on the card."""
    from pynucleus_tpu_torch.fem.dofmaps import P1_DoFMap
    from pynucleus_tpu_torch.nl.kernels import getFractionalKernel
    from pynucleus_tpu_torch.nl.problems import (nonlocalMesh,
                                                 HOMOGENEOUS_DIRICHLET)
    kernel = getFractionalKernel(1 if domain == 'interval' else 2, MF_S,
                                 horizon=horizon)
    mesh, info = nonlocalMesh(domain, kernel, HOMOGENEOUS_DIRICHLET)
    for _ in range(noRef):
        mesh = mesh.refine()
    return P1_DoFMap(mesh, tag=info['domain'], device='cuda'), kernel


def h2_dense(H):
    """The H2 operator H as a dense tensor on the card: H e_j for every j
    (row j of the result, returned transposed)."""
    import torch
    n = H.num_rows
    D = torch.empty((n, n), dtype=torch.float64, device='cuda')
    e = torch.zeros(n, dtype=torch.float64, device='cuda')
    for j in range(n):
        e[j] = 1.0
        H.matvec(e, out=D[j])
        e[j] = 0.0
    return D.t()


def h2c_dense(A, S):
    """The horizonCorrected A as a dense tensor: facS S - Cross - c_tot M,
    S the dense S_inf."""
    return A.facS * S - A.Cross.data - A.c_tot * csr_to_dense(A.mass, S)


def _cos(n):
    import torch
    return torch.cos(0.3 * torch.arange(n, dtype=torch.float64,
                                        device='cuda'))


def h2c_cg(A, b, maxIter=1000):
    """CG-Jacobi (tolerance MF_CG_TOL) on A x = b: (iterations, ||x||,
    seconds)."""
    import torch
    from pynucleus_tpu_torch.base.solvers import solverFactory
    s = solverFactory.build('cg-jacobi', A=A, setup=True)
    s.tolerance, s.maxIter = MF_CG_TOL, maxIter
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = s.solve(b)
    torch.cuda.synchronize()
    return s.iterations, float(torch.linalg.norm(x)), \
        time.perf_counter() - t0


def h2c_pin_line(domain, noRef):
    """H2corrected at delta 0.4 and, after setKernel, 0.3 (S_inf kept)
    against the pinned JAX outputs; at noRef 6 the CG-Jacobi line."""
    import numpy as np
    import torch
    from pynucleus_tpu_torch.nl.assembly import assembleNonlocal
    from pynucleus_tpu_torch.nl.kernels import getFractionalKernel
    dm, kernel = mf_setup(domain, noRef)
    ref = JAX_H2CORRECTED[f'{domain}{noRef}']
    A = assembleNonlocal(dm, kernel, matrixFormat='H2corrected')
    Sinf = A.Sinf
    S = h2_dense(Sinf)
    x = _cos(A.num_rows)
    rel, bad = {}, []
    if A.num_rows != ref['dofs']:
        bad.append(f'dofs {A.num_rows}')
    for delta in (MF_DELTA, MF_DELTA2):
        if delta != MF_DELTA:
            A.setKernel(getFractionalKernel(dm.mesh.dim, MF_S,
                                            horizon=delta))
            if A.Sinf is not Sinf:
                bad.append('setKernel rebuilt S_inf')
        D, Ax = h2c_dense(A, S), A.matvec(x)
        got = {'max_entry': D.abs().max(), 'fro': torch.linalg.norm(D),
               'trace': torch.trace(D), 'Ax_norm': torch.linalg.norm(Ax)}
        r = ref[f'delta{delta}']
        rd = {k: abs(float(v) - r[k]) / abs(r[k]) for k, v in got.items()}
        for k, v in (('Ax4', Ax[:4]), ('diag4', A.diagonal[:4])):
            rd[k] = float(np.abs(v.cpu().numpy() - np.array(r[k])).max()
                          / np.abs(r[k]).max())
        rel[f'delta{delta}'] = rd
        bad += [f'delta {delta} {k} {v:.2e}' for k, v in rd.items()
                if not v <= TOL_MF_PIN]
        if delta == MF_DELTA and 'cg_jacobi' in ref:
            its, xn, _ = h2c_cg(A, A.mass.matvec(torch.ones_like(x)))
            rel['cg_jacobi'] = {'iterations': its, 'x_norm': xn}
            cg = ref['cg_jacobi']
            if its != cg['iterations'] or \
                    not abs(xn - cg['x_norm']) <= TOL_MF_X * cg['x_norm']:
                bad.append(f'CG-Jacobi {its} iterations, ||x|| {xn!r} (JAX '
                           f"{cg['iterations']}, {cg['x_norm']!r})")
    log(f'  H2corrected {domain} noRef {noRef}: {A.num_rows} dofs, relative '
        f'to JAX {json.dumps(rel)}')
    if bad:
        raise AssertionError(f'H2corrected {domain} noRef {noRef}: '
                             + '; '.join(bad))
    return rel


def h2c_vs_sparse(A, S, dm, kernel, x):
    """The port's getSparse of the kernel (seconds to a synchronize) and
    H2corrected A against it: the largest entry difference over the
    largest entry, and the relative apply difference on x.  Returns
    (summary, the sparse operator)."""
    import torch
    from pynucleus_tpu_torch.nl.assembly import nonlocalBuilder
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Asp = nonlocalBuilder(dm, kernel).getSparse()
    torch.cuda.synchronize()
    tSparse = time.perf_counter() - t0
    Dsp = csr_to_dense(Asp, S)
    entries = float((h2c_dense(A, S) - Dsp).abs().max() / Dsp.abs().max())
    del Dsp
    Sx = Asp.matvec(x)
    return {'getSparse_s': tSparse, 'nnz': Asp.nnz, 'entries': entries,
            'matvec': float(torch.linalg.norm(A.matvec(x) - Sx)
                            / torch.linalg.norm(Sx))}, Asp


def h2c_line(domain, noRef, solve):
    """A full-width line (a path): H2corrected built (parts: S_inf, the
    mass, the cross operator's host classification and the rest), held to
    the port's getSparse at delta 0.4 and, after setKernel (S_inf kept;
    under torch.profiler: the device time by kernel), at 0.3, each below
    MF_BARS; back to 0.4 from the cache; with ``solve`` CG-Jacobi on A x =
    M 1 with A and with getSparse, the applies (CUDA events over 10) and
    the peak device memory."""
    import torch
    from pynucleus_tpu_torch.nl.assembly import nonlocalBuilder
    from pynucleus_tpu_torch.nl.kernels import getFractionalKernel
    dm, kernel = mf_setup(domain, noRef)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    b = nonlocalBuilder(dm, kernel)
    A = b.getH2FiniteHorizon()
    torch.cuda.synchronize()
    out = {'noRef': noRef, 'cells': dm.mesh.num_cells, 'dofs': A.num_rows,
           'build_s': time.perf_counter() - t0, 'parts_s': dict(b.timers)}
    Sinf = A.Sinf
    t0 = time.perf_counter()
    S = h2_dense(Sinf)
    torch.cuda.synchronize()
    out['S_inf_dense_s'] = time.perf_counter() - t0
    x = _cos(A.num_rows)
    out[f'delta{MF_DELTA}'], Asp = h2c_vs_sparse(A, S, dm, kernel, x)
    kernel2 = getFractionalKernel(dm.mesh.dim, MF_S, horizon=MF_DELTA2)
    t0 = time.perf_counter()
    dev = device_ms_by_kernel(lambda: A.setKernel(kernel2))
    out['setKernel_s'] = time.perf_counter() - t0
    out['setKernel_parts_s'] = dict(A.timers)
    out['setKernel_device_ms_by_kernel'] = dev
    bad = [] if A.Sinf is Sinf else ['setKernel rebuilt S_inf']
    out[f'delta{MF_DELTA2}'], _ = h2c_vs_sparse(A, S, dm, kernel2, x)
    del S
    A.setKernel(kernel)
    if A.timers:
        bad.append('setKernel back to the first horizon missed the cache')
    if solve:
        # the float64 operator stays for phase 28 (its float32 twin)
        KEPT[f'h2c64_{domain}'] = (dm, kernel, A)
    if solve:
        rhs = A.mass.matvec(torch.ones_like(x))
        for label, op in (('h2corrected', A), ('sparse', Asp)):
            its, xn, secs = h2c_cg(op, rhs, maxIter=5000)
            y = torch.empty_like(x)
            out[label] = {'cg_jacobi_iterations': its, 'x_norm': xn,
                          'cg_s': secs,
                          'apply_ms': timed(lambda: [op.matvec(x, out=y)
                                                     for _ in range(10)])
                          / 10}
    out['peak_device_GiB'] = torch.cuda.max_memory_allocated() / 2 ** 30
    for delta in (MF_DELTA, MF_DELTA2):
        got = out[f'delta{delta}']
        bad += [f'delta {delta} {k} {got[k]:.3e} (bar {v:.3e})'
                for k, v in MF_BARS[domain][delta].items() if not got[k] < v]
    log(f'  H2corrected {domain} noRef {noRef}: {json.dumps(out)}')
    if bad:
        raise AssertionError(f'H2corrected {domain} noRef {noRef}: '
                             + '; '.join(bad))
    return out


def mf_diag_setup(domain, noRef):
    """(dm, kernel) of a zero-exterior diagonal line: the fractional
    kernel of order MF_DIAG_S (infinite horizon) on the interval [-1, 1]
    or the disc circle(h=0.78) refined noRef times, P1, on the card."""
    from pynucleus_tpu_torch.fem.dofmaps import P1_DoFMap
    from pynucleus_tpu_torch.fem.meshes import simpleInterval, circle
    from pynucleus_tpu_torch.nl.kernels import getFractionalKernel
    mesh = simpleInterval(-1.0, 1.0) if domain == 'interval' else \
        circle(h=0.78, radius=1.0)
    for _ in range(noRef):
        mesh = mesh.refine()
    return P1_DoFMap(mesh, device='cuda'), getFractionalKernel(mesh.dim,
                                                               MF_DIAG_S)


def mf_diag_line(domain, noRef):
    """getDiagonal with the zero-exterior term (s MF_DIAG_S, infinite
    horizon; 2D: normals) against the diagonal of getDense without the
    grid (the same classification), 1e-12 of the largest.  The dofmap, the
    kernel and the diagonal are kept for phase 26's float32 getDiagonal."""
    import torch
    from pynucleus_tpu_torch.nl.assembly import (assembleNonlocal,
                                                 nonlocalBuilder)
    dm, kernel = mf_diag_setup(domain, noRef)
    mesh = dm.mesh
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d = assembleNonlocal(dm, kernel, matrixFormat='diagonal').diagonal
    torch.cuda.synchronize()
    tDiag = time.perf_counter() - t0
    dD = torch.diagonal(nonlocalBuilder(dm, kernel,
                                        params={'denseGrid': False})
                        .getDense().data)
    err = float((d - dD).abs().max() / dD.abs().max())
    KEPT[f'diag64_{domain}'] = (dm, kernel, d)
    out = {'noRef': noRef, 'cells': mesh.num_cells, 'dofs': dm.num_dofs,
           'getDiagonal_s': tDiag, 'vs_dense': err}
    log(f'  diagonal {domain} noRef {noRef}: {json.dumps(out)}')
    if not err <= TOL_KERNEL:
        raise AssertionError(f'diagonal {domain} noRef {noRef}: {err:.2e} '
                             'from getDense')
    return out


def mf_sparsified_line():
    """'sparsified' of the finite horizon on the interval: a CSR operator
    whose entries equal getSparse's on the union of the two patterns (1e-12
    of the largest: atomics add in no fixed order)."""
    import torch
    from pynucleus_tpu_torch.base.linear_operators import CSR_LinearOperator
    from pynucleus_tpu_torch.nl.assembly import (assembleNonlocal,
                                                 nonlocalBuilder)
    dm, kernel = mf_setup('interval', MF_SPARSIFIED_NOREF)
    A = assembleNonlocal(dm, kernel, matrixFormat='sparsified')
    Asp = nonlocalBuilder(dm, kernel).getSparse()
    like = torch.zeros((dm.num_dofs, dm.num_dofs), dtype=torch.float64,
                       device='cuda')
    DA, DS = csr_to_dense(A, like), csr_to_dense(Asp, like)
    union = (DA != 0) | (DS != 0)
    err = float((DA - DS)[union].abs().max() / DS.abs().max())
    out = {'noRef': MF_SPARSIFIED_NOREF, 'dofs': dm.num_dofs,
           'csr': isinstance(A, CSR_LinearOperator), 'nnz': A.nnz,
           'sparse_nnz': Asp.nnz, 'union': int(union.sum()),
           'vs_getSparse': err}
    log(f'  sparsified interval noRef {MF_SPARSIFIED_NOREF}: '
        f'{json.dumps(out)}')
    if not out['csr'] or not err <= TOL_KERNEL:
        raise AssertionError(f'sparsified: {json.dumps(out)}')
    return out


def complement_work(args):
    """K1 with the complement indicator (dense target, the off-diagonal
    block mask) on recorded args: panel_work_dof on the entries the mask
    keeps, with the indicator's operations per node."""
    import torch
    n = args[4].shape[1]
    mask = torch.zeros((n, n), dtype=torch.bool, device=args[4].device)
    mask[:n // 2, n // 2:] = mask[n // 2:, :n // 2] = True
    return panel_work_dof(args, mask=mask, indicatorOps=INDICATOR_OPS)


def _is_exterior(call):
    """A recorded K1 diagonal-target call of the zero-exterior term: pairs
    of a cell and a surface simplex (nv2 < nv1)."""
    (_, _, vi1, vi2, *_), _ = call
    return vi2.shape[1] < vi1.shape[1]


def phase18():
    """The matrix formats of assembleNonlocal: H2corrected against the
    pinned JAX outputs (interval noRef 3, 6 with CG-Jacobi, square noRef 1;
    each a path), the full-width interval (noRef MF_NOREF, CG-Jacobi) and square
    (noRef 3) against getSparse at two horizons (each a path), getDiagonal
    with the zero-exterior term (the interval at noRef 12, the disc at
    noRef 4; each a path), 'sparsified' (a path); then K1 with the
    complement indicator and the block mask, and K1's diagonal target on
    the zero-exterior pairs, against their plain versions.  Returns the
    launch counts of the paths, the comparisons and a summary."""
    import pynucleus_tpu_torch.nl.assembly as asm
    log('phase 18: the matrix formats (H2corrected with a horizon sweep, '
        'diagonal with the zero-exterior term, sparsified)')
    counts, summary = {}, {'pins': {}}
    for domain, noRef in MF_PINS:
        key = f'{domain}{noRef}'
        summary['pins'][key], counts[key] = count_path(
            f'H2corrected {domain} noRef {noRef}',
            MF_CG_PATH if noRef == 6 else H2C_KERNELS,
            lambda: h2c_pin_line(domain, noRef))
    recs = {}
    for domain, (noRef, path) in MF_LINES.items():
        with ArgRecorder(asm, 'panel_scatter', dataFirst=True,
                         size=_k1_size) as recs[domain]:
            summary[domain], counts[domain] = count_path(
                f'H2corrected {domain} noRef {noRef}', path,
                lambda: h2c_line(domain, noRef, domain == 'interval'))
    with ArgRecorder(asm, 'panel_scatter_diag', dataFirst=True) as diagRec:
        for domain, noRef in MF_DIAG_LINES:
            summary['diag_' + domain], counts['diag_' + domain] = count_path(
                f'diagonal {domain} noRef {noRef}', MF_DIAG_PATH,
                lambda: mf_diag_line(domain, noRef))
    summary['sparsified'], counts['sparsified'] = count_path(
        f'sparsified interval noRef {MF_SPARSIFIED_NOREF}', MF_SPARSIFIED_PATH,
        mf_sparsified_line)

    log('  the matrix formats\' variants of K1 against their plain versions')
    cmp = {'panel_scatter:complement': merge(*(compare_target_kernel(
        f'panel_scatter (complement, {domain})', recs[domain].calls,
        asm.panel_scatter, asm._panel_scatter_plain, complement_work)
        for domain in ('interval', 'square')))}
    exterior = [c for c in diagRec.calls if _is_exterior(c)]
    if not exterior:
        raise AssertionError('getDiagonal made no call of the zero-exterior '
                             'term')
    cmp['panel_scatter:diag_exterior'] = compare_target_kernel(
        'panel_scatter_diag (zero-exterior term)', exterior,
        asm.panel_scatter_diag, asm._panel_scatter_diag_plain,
        panel_work_dof, csr=False)
    log(f'phase 18 summary: {json.dumps(summary)}')
    return counts, cmp, summary


# ---------------------------------------------------------------- phase 19

# JAX package outputs of scripts/pin_operator_interpolation_jax.py (the
# line of examples/example_operator_interpolation.py: the interval [-1, 1]
# refined 6 times, P1, s in [0.05, 0.95], dense; x =
# RandomState(19).standard_normal(N)), run on the CPU in float64
JAX_INTERP = {
    'dofs': 63,
    'intervals': [
        [0.05, 0.15836120401337794], [0.15836120401337794, 0.26672240802675584],
        [0.26672240802675584, 0.37508361204013374],
        [0.37508361204013374, 0.48344481605351164],
        [0.48344481605351164, 0.5918060200668895],
        [0.5918060200668895, 0.6802708023400185],
        [0.6802708023400185, 0.7495632839733523],
        [0.7495632839733523, 0.8038385321289602],
        [0.8038385321289602, 0.8463511178080351],
        [0.8463511178080351, 0.8796502735472971],
        [0.8796502735472971, 0.9057327560694882],
        [0.9057327560694882, 0.9261625801721544],
        [0.9261625801721544, 0.9421648035997277],
        [0.9421648035997277, 0.95]],
    'nodes': [
        [0.05412425275356907, 0.08344658326316236, 0.12491462075021557,
         0.15423695125980885],
        [0.16248545676694703, 0.1918077872765403, 0.2332758247635935,
         0.26259815527318675],
        [0.27084666078032493, 0.3001689912899182, 0.3416370287769714,
         0.37095935928656465],
        [0.37920786479370283, 0.4085301953032961, 0.4499982327903493,
         0.47932056329994255],
        [0.48756906880708073, 0.5168913993166739, 0.5583594368037272,
         0.5876817673133204],
        [0.5951730103583485, 0.6191114079415984, 0.6529654144653098,
         0.6769038120485596],
        [0.6829080903877097, 0.7016585008024158, 0.728175585510955,
         0.746925995925661],
        [0.7516290126046876, 0.7663157889228287, 0.7870860271794837,
         0.8017728034976248],
        [0.8054565710769828, 0.816960393865306, 0.8332292560716893,
         0.8447330788600125],
        [0.8476184914589612, 0.8566291780710859, 0.8693722132842464,
         0.8783828998963711],
        [0.8806429789287248, 0.8877008478402955, 0.89768218177649,
         0.9047400506880606],
        [0.9065103199501918, 0.9120385905157097, 0.9198567457259329,
         0.9253850162914508],
        [0.9267716285362373, 0.9311017989925726, 0.9372255847793095,
         0.9415557552356448],
        [0.942463013006155, 0.9445832018740083, 0.9475816017257193,
         0.9497017905935726]],
    'orders': {
        0.75: {'weights': [1.1997044312904728, -0.28917870919667016,
                           0.12722254549926731, -0.037748267593069984],
               'Ax_norm': 52.14580980511108,
               'Ax4': [-2.9342382919534185, -0.7537119875560429,
                       -1.488817079347578, -1.6672161439378692],
               'iterations': 26, 'u_max': 0.7508971971875337,
               'assembled': 4},
        0.76: {'weights': [0.2736659279060494, 0.8756801317350374,
                           -0.20418686134017006, 0.05484080169908314],
               'Ax_norm': 56.86210388709582,
               'Ax4': [-3.30082588549797, -0.773698084387719,
                       -1.6009220323744784, -1.7347370898949501],
               'iterations': 26, 'u_max': 0.7404090974097841,
               'assembled': 4},
        0.3: {'weights': [0.0024026577673837684, 1.0006716247474974,
                          -0.004061403842153041, 0.0009871213272720236],
              'Ax_norm': 1.3094022207620848,
              'Ax4': [0.039345774860839434, -0.06456720666808975,
                      -0.08133573657964001, -0.12748866362901173],
              'iterations': 11, 'u_max': 1.1154156989416253,
              'assembled': 8}},
    'h2': {'s': 0.5, 'Ax_norm': 6.396086225502587,
           'Ax4': [-0.05901081696336194, -0.2211665080185936,
                   -0.2740546803882046, -0.4512429087996733]},
}
INTERP_SEED = 19
TOL_INTERP_W = 1e-15
TOL_INTERP_AX = 1e-12
TOL_INTERP_U = 1e-8
TOL_INTERP_H2 = 1e-10
INTERP_NOREF = 13
INTERP_FALLBACK = 12
# the full-width line's twelve node assemblies must take at most this
# (seconds); the first interval's six are its measure
INTERP_NODE_LIMIT = 120.0
INTERP_ORDERS = (0.75, 0.76, 0.3)
INTERP_MAXITER = 20000
INTERP_EXAMPLE_PATH = ('interp_matvec', 'pcg_update', 'pcg_update:jacobi',
                       'panel_scatter', 'panel_scatter:dense')
INTERP_PATH = INTERP_EXAMPLE_PATH + ('grid_distant', 'grid_boundary')
INTERP_H2_PATH = ('h2_matvec', 'panel_scatter', 'far_field')
MATFREE_PATH = ('matfree_apply', 'matfree_apply:apply',
                'matfree_apply:diagonal')
COMPARED_AT['interp_matvec'] = (
    f'interval noRef {INTERP_NOREF} (noRef {INTERP_FALLBACK} if its node '
    f'assemblies would exceed {INTERP_NODE_LIMIT:.0f} s): the stack '
    f'[6, N, N] of s = {INTERP_ORDERS[0]}, per apply')
COMPARED_AT['matfree_apply'] = (
    f'the Poisson square at noRef {SERIAL_NOREF}: the stiffness and the '
    'mass, apply and diagonal, timed per pair of applies')


# the example's node operators on the per-pair path, the JAX package's on
# the CPU, whose outputs JAX_INTERP pins
PER_PAIR = {'denseGrid': False}


def INTERP19_PATHS(counts19):
    """The main paths of phase 19: (kernels, label, launch counts)."""
    return ((INTERP_PATH, 'interpolation_example_interval_noRef6',
             counts19['example']),
            (INTERP_EXAMPLE_PATH,
             'interpolation_example_per_pair_interval_noRef6',
             counts19['example_per_pair']),
            (INTERP_H2_PATH, 'interpolation_h2_interval_noRef6',
             counts19['h2']),
            (INTERP_PATH,
             f"interpolation_interval_noRef{counts19['noRef']}",
             counts19['full']),
            (MATFREE_PATH, f'matrix_free_square_noRef{SERIAL_NOREF}',
             counts19['matfree']))


def _interp_close(label, got, ref, tol):
    import numpy as np
    got, ref = np.asarray(got, dtype=float), np.asarray(ref, dtype=float)
    err = float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))
    if not err <= tol:
        raise AssertionError(f'{label}: {got} against the JAX {ref} '
                             f'(relative {err:.3e} > {tol})')
    return err


def interp_example_line(params=None):
    """The port's example at its own size (a path), its node operators
    assembled with ``params``, against the JAX pins: intervals and nodes
    exact; per order the weights, the CG-Jacobi iterations, max(u) and the
    node operators assembled; on the per-pair path (PER_PAIR) A(s) x too
    (the grid's entries differ from the per-pair ones by up to 3.5e-5)."""
    import numpy as np
    import torch
    from pynucleus_tpu_torch.examples import example_operator_interpolation
    A, results = example_operator_interpolation.main(['--device', 'cuda'],
                                                     params=params)
    ref = JAX_INTERP
    if [[float(a), float(b)] for a, b in A.intervals] != ref['intervals'] \
            or [[float(v) for v in n] for n in A.nodes] != ref['nodes']:
        raise AssertionError('the intervals or nodes differ from the JAX '
                             'package\'s')
    x = torch.as_tensor(np.random.RandomState(INTERP_SEED).standard_normal(
        A.num_rows), device='cuda')
    worst = 0.0
    for r in results:
        pin = ref['orders'][r['s']]
        if r['iterations'] != pin['iterations'] \
                or r['assembled'] != pin['assembled'] \
                or not abs(r['u_max'] - pin['u_max']) <= TOL_INTERP_U:
            raise AssertionError(f"s = {r['s']}: {r} against the JAX {pin}")
        A.set(r['s'])
        if not np.abs(A._weights - pin['weights']).max() <= TOL_INTERP_W:
            raise AssertionError(f"s = {r['s']}: weights {A._weights}")
        if params != PER_PAIR:
            continue
        y = A.matvec(x).cpu().numpy()
        worst = max(worst, _interp_close(
            f"A({r['s']}) x", [np.linalg.norm(y), *y[:4]],
            [pin['Ax_norm'], *pin['Ax4']], TOL_INTERP_AX))
    path = 'per-pair' if params == PER_PAIR else 'default (grid)'
    log(f"  the example, {path} path: {A.getNumInterpolationNodes()} nodes "
        f"in {len(A.intervals)} intervals as the JAX package; per s "
        f"(iterations, |u|_max, assembled): "
        f"{[(r['s'], r['iterations'], round(r['u_max'], 10), r['assembled']) for r in results]}"
        + (f', A(s) x within {worst:.2e} of the JAX outputs'
           if params == PER_PAIR else ''))
    out = {'results': results}
    if params == PER_PAIR:
        out['Ax_rel'] = worst
    return A, x, out


def interp_h2_line(dm, x):
    """The same kernel in H2 at s = 0.5 (a path) against the JAX output."""
    from pynucleus_tpu_torch.nl.assembly import assembleNonlocal
    from pynucleus_tpu_torch.nl.kernels import kernelFactory
    from pynucleus_tpu_torch.nl.operator_interpolation import admissibleSet
    ref = JAX_INTERP['h2']
    H = assembleNonlocal(dm, kernelFactory(
        'fractional', s=admissibleSet([0.05, 0.95]), dim=1),
        matrixFormat='H2', device='cuda')
    H.set(ref['s'])
    y = H.matvec(x).cpu().numpy()
    import numpy as np
    err = _interp_close('the H2 twin', [np.linalg.norm(y), *y[:4]],
                        [ref['Ax_norm'], *ref['Ax4']], TOL_INTERP_H2)
    log(f"  the H2 twin at s = {ref['s']}: ||A x|| {np.linalg.norm(y):.15e}, "
        f'within {err:.2e} of the JAX output')
    return err


def interp_line(noRef):
    """The full-width line on the interval refined noRef times (a path):
    per order the set, the node assemblies, the stack and CG-Jacobi to
    1e-8; the peak device memory.  Returns None if the first interval's
    node assemblies project the twelve beyond INTERP_NODE_LIMIT, else
    (A, dm, summary)."""
    import torch
    from pynucleus_tpu_torch.base.solvers import solverFactory
    from pynucleus_tpu_torch.fem.assembly import assembleRHS
    from pynucleus_tpu_torch.fem.dofmaps import P1_DoFMap
    from pynucleus_tpu_torch.fem.functions import constant
    from pynucleus_tpu_torch.fem.meshes import simpleInterval
    from pynucleus_tpu_torch.nl.assembly import assembleNonlocal
    from pynucleus_tpu_torch.nl.kernels import kernelFactory
    from pynucleus_tpu_torch.nl.operator_interpolation import admissibleSet
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh = simpleInterval(-1.0, 1.0)
    for _ in range(noRef):
        mesh = mesh.refine()
    dm = P1_DoFMap(mesh, device='cuda')
    b = assembleRHS(dm, constant(1.)).data
    A = assembleNonlocal(dm, kernelFactory(
        'fractional', s=admissibleSet([0.05, 0.95]), dim=1),
        matrixFormat='dense', device='cuda')
    nodes = [len(n) for n in A.nodes]
    log(f'  interval noRef {noRef}: {dm.num_dofs} dofs, '
        f'{A.getNumInterpolationNodes()} nodes in {len(nodes)} intervals '
        f'of {sorted(set(nodes))}')
    lines = []
    for s in INTERP_ORDERS:
        A.set(s)
        before = sum(d.assembled for ops in A.ops for d in ops)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        A._intervalOps()
        torch.cuda.synchronize()
        tNodes = time.perf_counter() - t0
        new = sum(d.assembled for ops in A.ops for d in ops) - before
        if s == INTERP_ORDERS[0] and tNodes * 2 > INTERP_NODE_LIMIT:
            log(f'  the first {new} node assemblies took {tNodes:.3f} s: '
                f'twelve would exceed {INTERP_NODE_LIMIT} s')
            return None
        t0 = time.perf_counter()
        stack = A._denseStack()
        torch.cuda.synchronize()
        tStack = time.perf_counter() - t0
        solver = solverFactory.build('cg-jacobi', A=A, setup=True)
        solver.maxIter, solver.tolerance = INTERP_MAXITER, 1e-8
        t0 = time.perf_counter()
        u = solver.solve(b)
        torch.cuda.synchronize()
        tSolve = time.perf_counter() - t0
        its = solver.iterations
        if not (solver.residuals[-1] <= solver.tolerance
                and its < INTERP_MAXITER and torch.isfinite(u).all()):
            raise AssertionError(f'CG-Jacobi at s = {s} did not converge: '
                                 f'{solver.residuals[-3:]}')
        lines.append({'s': s, 'new_nodes': new, 'node_seconds': tNodes,
                      'stack_seconds': tStack,
                      'stack_GB': stack.numel() * 8 / 1e9,
                      'iterations': its, 'solve_seconds': tSolve,
                      'u_max': float(u.max())})
        log(f'  s = {s}: {new} node assemblies {tNodes:.3f} s, stack '
            f'{tuple(stack.shape)} ({stack.numel() * 8 / 1e9:.3f} GB) '
            f'{tStack:.3f} s, CG-Jacobi {its} iterations in {tSolve:.3f} s, '
            f'|u|_max {float(u.max()):.8f}')
    peak = torch.cuda.max_memory_allocated()
    log(f'  peak device memory {peak / 2**30:.3f} GiB')
    return A, dm, {'noRef': noRef, 'dofs': dm.num_dofs, 'orders': lines,
                   'node_seconds': sum(r['node_seconds'] for r in lines),
                   'peak_GiB': peak / 2**30}


def interp_direct_check(A, dm, summary):
    """A(0.75) x against the operator assembled directly at 0.75: below
    0.1 h^(1/2) (tests/test_operator_interpolation.py:68-78)."""
    import numpy as np
    import torch
    from pynucleus_tpu_torch.nl.assembly import assembleNonlocal
    from pynucleus_tpu_torch.nl.kernels import getFractionalKernel
    s = INTERP_ORDERS[0]
    D = assembleNonlocal(dm, getFractionalKernel(1, s), matrixFormat='dense',
                         device='cuda')
    A.set(s)
    x = torch.cos(torch.arange(dm.num_dofs, dtype=torch.float64,
                               device='cuda'))
    yD = D.matvec(x)
    rel = float(torch.linalg.norm(A.matvec(x) - yD) / torch.linalg.norm(yD))
    bar = 0.1 * float(dm.mesh.h) ** 0.5
    if not rel < bar:
        raise AssertionError(f'interpolation error {rel} not below {bar}')
    log(f'  A({s}) x against the direct operator: relative {rel:.3e} '
        f'(bar 0.1 h^(1/2) = {bar:.3e})')
    summary['direct_rel'], summary['direct_bar'] = rel, bar
    del D


def compare_interp_matvec(A, reps=20):
    """K24 on the full-width line's stack of s = 0.75 against its plain
    version and torch.einsum (the library's yardstick, never used by the
    port), each after an untimed call."""
    import torch
    from pynucleus_tpu_torch.nl.operator_interpolation import (
        interp_matvec, _interp_matvec_plain)
    A.set(INTERP_ORDERS[0])
    stack = A._denseStack()
    M1, N, _ = stack.shape
    w = torch.as_tensor(A._weights, dtype=torch.float64, device='cuda')
    x = torch.as_tensor(_seeded(N))
    yk, yp = torch.empty_like(x), torch.empty_like(x)
    interp_matvec(w, stack, x, out=yk)
    _interp_matvec_plain(w, stack, x, yp)
    yl = torch.einsum('m,mnk,k->n', w, stack, x)
    err = float((yk - yp).abs().max())
    scale = float(yp.abs().max())
    if not (scale > 0 and err <= TOL_KERNEL * scale
            and float((yl - yp).abs().max()) <= TOL_KERNEL * scale):
        raise AssertionError(f'interp_matvec: max err {err} (max {scale})')
    ms = timed(lambda: [interp_matvec(w, stack, x, out=yk)
                        for _ in range(reps)]) / reps
    plain_ms = timed(lambda: [_interp_matvec_plain(w, stack, x, yp)
                              for _ in range(reps)]) / reps
    lib_ms = timed(lambda: [torch.einsum('m,mnk,k->n', w, stack, x)
                            for _ in range(reps)]) / reps
    work = [(nbytes(w, stack, x) + 8 * N, 2 * M1 * N * N + 2 * M1 * N,
             F64_PEAK)]
    log(f'  interp_matvec: stack {tuple(stack.shape)}, max abs err '
        f'{err:.3e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, '
        f'torch.einsum {lib_ms:.4f} ms, bound {bound(work)[0]:.4f} ms per '
        'apply')
    return result(err, ms, plain_ms, work, lib_ms)


def matfree_line(dm, A):
    """matrixFreeOperator(dm, 'stiffness') and 'mass' on phase 11's square
    (a path: construction, an apply and the diagonal of each) against the
    CSR operators (A, the stiffness; the mass through K16) applied by K9:
    1e-12 of the largest entry."""
    import torch
    from pynucleus_tpu_torch.fem.assembly import (matrixFreeOperator,
                                                  assembleMass)
    x = _seeded(A.num_rows)
    out, csr = {}, {'stiffness': A, 'mass': assembleMass(dm)}
    t0 = time.perf_counter()
    ops = {kind: matrixFreeOperator(dm, kind) for kind in csr}
    tBuild = time.perf_counter() - t0
    for kind, op in ops.items():
        y, d = op.matvec(x), op.diagonal
        yr, dr = csr[kind].matvec(x), csr[kind].diagonal
        errs = [float((a - b).abs().max() / b.abs().max())
                for a, b in ((y, yr), (d, dr))]
        if not max(errs) <= TOL_KERNEL:
            raise AssertionError(f'matrix-free {kind}: apply / diagonal '
                                 f'{errs} from the CSR operator')
        out[kind] = {'apply_rel': errs[0], 'diagonal_rel': errs[1]}
    torch.cuda.synchronize()
    log(f'  matrix-free square noRef {SERIAL_NOREF} ({A.num_rows} dofs): '
        f'construction {tBuild:.3f} s (both), against the CSR operators '
        f'{out}')
    out['construction_seconds'] = tBuild
    return ops, csr, out


def compare_matfree_apply(ops, csr, reps=20):
    """K25 (apply and diagonal) on the square's matrix-free operators
    against its plain version, its time against K9's on the assembled CSR
    operator and torch.sparse's (the library's yardstick, never used by
    the port), each after an untimed call."""
    import torch
    from pynucleus_tpu_torch.fem.assembly import (matfree_apply,
                                                  _matfree_apply_plain)
    from pynucleus_tpu_torch.base.linear_operators import csr_spmv
    worst = ms = plain_ms = lib_ms = k9_ms = 0.0
    work = []
    for kind, op in ops.items():
        args = (op._Aloc, op._dofs, op._order, op._offsets)
        x = _seeded(op.num_rows)
        for diag in (False, True):
            yk, yp = torch.empty_like(x), torch.empty_like(x)
            xx = None if diag else x
            matfree_apply(*args, xx, out=yk, diagonal=diag)
            _matfree_apply_plain(*args, x, yp, diag)
            err = float((yk - yp).abs().max())
            scale = float(yp.abs().max())
            if not (scale > 0 and err <= TOL_KERNEL * scale):
                raise AssertionError(f'matfree_apply ({kind}, diagonal '
                                     f'{diag}): max err {err} (max {scale})')
            worst = max(worst, err)
        ms += timed(lambda: [matfree_apply(*args, x, out=yk)
                             for _ in range(reps)]) / reps
        plain_ms += timed(lambda: [_matfree_apply_plain(*args, x, yp, False)
                                   for _ in range(reps)]) / reps
        C = csr[kind]
        S = LibraryCSR(C)
        S.matvec(x)
        cargs = (C.indptr, C.indices, C.data, x)
        k9_ms += timed(lambda: [csr_spmv(*cargs, out=yp)
                                for _ in range(reps)]) / reps
        lib_ms += timed(lambda: [S.matvec(x) for _ in range(reps)]) / reps
        C_, dpe = op._Aloc.shape[:2]
        # the local matrices, dofs, order and offsets read once, x gathered
        # once, y written once; per local row dpe multiply-adds
        work.append((nbytes(*args, x) + 8 * op.num_rows,
                     2 * C_ * dpe * dpe, F64_PEAK))
    log(f'  matfree_apply: stiffness and mass, {ops["mass"].num_rows} dofs, '
        f'max abs err {worst:.3e} (apply and diagonal), kernel {ms:.4f} ms, '
        f'plain {plain_ms:.4f} ms, K9 on the CSR operators {k9_ms:.4f} ms, '
        f'torch.sparse {lib_ms:.4f} ms, bound {bound(work)[0]:.4f} ms per '
        'pair of applies')
    r = result(worst, ms, plain_ms, work, lib_ms)
    r['csr_spmv_ms'] = k9_ms
    return r


def serial_square(noRef):
    """{'dm', 'A', 'hierarchy', 'b', 'tol'}: runSerialGMG's square at
    noRef, its dofmap, finest stiffness, level list, load and tolerance
    (phases 19 and 20 alone)."""
    from pynucleus_tpu_torch.drivers.runSerialGMG import main
    out = main(serial_argv(noRef), quiet=True)
    return {'dm': out['dm'], 'A': out['hierarchy'][-1]['A'],
            'hierarchy': out['hierarchy'], 'b': out['b'],
            'tol': out['ml'].tolerance}


def phase19_matfree(serial):
    """Phase 19's matrix-free part on phase 11's square while it is alive
    (main runs it right after phase 11, so that no later phase holds the
    square): the mass and stiffness (a path) against the CSR operators,
    then K25 against its plain version.  ``serial`` holds the square's dm
    and finest stiffness.  Returns (launch counts, comparison, summary)."""
    log('phase 19, the matrix-free part: matrixFreeOperator on phase 11\'s '
        f'square at noRef {SERIAL_NOREF}')
    (ops, csr, summary), counts = count_path(
        'matrix-free', MATFREE_PATH,
        lambda: matfree_line(serial['dm'], serial['A']))
    return counts, compare_matfree_apply(ops, csr), summary


def phase19(matfree=None):
    """Operator interpolation over the fractional order and the
    matrix-free FEM operator: the port's example at its own size on its
    default path and on the per-pair path against the JAX pins (each a
    path), its H2 twin (a path), the full-width interval at noRef
    INTERP_NOREF (a path; noRef INTERP_FALLBACK if its node assemblies
    would exceed INTERP_NODE_LIMIT) with the interpolation error against a
    direct assembly; then K24 against its plain version.  ``matfree`` is
    what phase19_matfree returned on phase 11's square (alone: the square
    is made here and phase19_matfree runs last).  Returns the launch
    counts, the comparisons and a summary."""
    import torch
    log('phase 19: operator interpolation over the fractional order and '
        'the matrix-free operator')
    counts, summary = {}, {}
    (A, x, summary['example']), counts['example'] = count_path(
        'interpolation example', INTERP_PATH, interp_example_line)
    del A
    (A, x, summary['example_per_pair']), counts['example_per_pair'] = \
        count_path('interpolation example, per pair', INTERP_EXAMPLE_PATH,
                   lambda: interp_example_line(PER_PAIR))
    dm6 = A.ops[0][0].dm
    summary['h2_rel'], counts['h2'] = count_path(
        'interpolation H2 twin', INTERP_H2_PATH,
        lambda: interp_h2_line(dm6, x))
    del A
    t0 = time.perf_counter()
    full, counts['full'] = count_path(
        f'interpolation noRef {INTERP_NOREF}', (),
        lambda: interp_line(INTERP_NOREF))
    if full is None:
        log(f'  the full-width line at noRef {INTERP_FALLBACK} instead')
        full, counts['full'] = count_path(
            f'interpolation noRef {INTERP_FALLBACK}', (),
            lambda: interp_line(INTERP_FALLBACK))
    for k in INTERP_PATH:
        if counts['full'][k] <= 0:
            raise AssertionError(f'kernel {k} was not launched by the '
                                 'full-width interpolation path')
    A, dm, summary['full'] = full
    counts['noRef'] = summary['full']['noRef']
    interp_direct_check(A, dm, summary['full'])
    cmp = {'interp_matvec': compare_interp_matvec(A)}
    summary['full']['line_seconds'] = time.perf_counter() - t0
    del A, full
    torch.cuda.empty_cache()
    if matfree is None:
        matfree = phase19_matfree(serial_square(SERIAL_NOREF))
    counts['matfree'], cmp['matfree_apply'], summary['matfree'] = matfree
    log(f'phase 19 summary: {json.dumps(summary)}')
    return counts, cmp, summary


# ---------------------------------------------------------------- phase 20

# JAX package outputs of scripts/pin_multigrid_extras_jax.py (CPU, float64):
# Chebyshev multigrid (3+3 steps, tolerance 1e-10) on the interval [0, 1]
# refined 2-6 times and on uniformSquare(N=2) refined 1-6 times (the load
# of the constant 1), rho(D^-1 A) per level; the ILU smoother's multigrid
# on the interval refined 3-7 times (b = 1); the SSS apply of
# mgx_seeded_spd() to RandomState(MGX_SSS_SEED + 1)'s normal vector.
JAX_MG_EXTRAS = {
    'interval': {'dofs': 63,
                 'V': {'iterations': 7, 'xmax': 0.12499999999727483},
                 'FMG_V': {'iterations': 6, 'xmax': 0.1249999999996799},
                 'rhos': [1.707028426225744, 1.9233798080352242,
                          1.9529122374550032, 1.9879433970594649,
                          1.9768338573509454]},
    'square': {'dofs': 3969,
               'V': {'iterations': 10, 'xmax': 0.0736571854287482},
               'FMG_V': {'iterations': 9, 'xmax': 0.07365718547508142},
               'rhos': [1.0, 1.7068776655260347, 1.8145320215344918,
                        1.9771156449631122, 1.9852077443987393,
                        1.9772288856499614]},
    'ilu': {'dofs': 127, 'V': {'iterations': 1, 'xmax': 15.999999999999684}},
    'sss': {'n': 2000, 'nnz_L': 7989, 'y_norm': 240.40105984282022,
            'y4': [-0.3489388009172849, -0.8789471748383955,
                   2.5526587144986506, -4.28883760064649]},
}
# (domain, refinements, first kept level) of each pinned hierarchy
MGX_HIERARCHIES = {'interval': ('interval', 6, 2),
                   'square': ('square', 6, 1), 'ilu': ('interval', 7, 3)}
MGX_TOL = 1e-10
# runSerialGMG's default --maxiter, for every multigrid and CG-MG solve here
MGX_MAXITER = 50
TOL_MGX_PIN = 1e-10
TOL_MGX_SSS = 1e-13
MGX_SSS_SEED = 20
# the host smoothers' square: runSerialGMG's square at noRef 7 (65,025
# dofs), through hierarchyManager
MGX_HOST_NOREF = 7
MGX_ICHOL_MAXITER = 1000
# phase 11's Jacobi (2+2) counts at noRef 9 beside the Chebyshev ones
JACOBI_COUNTS = {'V': JAX_SERIAL[SERIAL_NOREF]['iterations'][0],
                 'FMG_V': JAX_SERIAL[SERIAL_NOREF]['iterations'][1],
                 'CG': JAX_SERIAL[SERIAL_NOREF]['iterations'][3]}
MGX_PIN_PATH = ('csr_scatter', 'csr_spmv', 'jacobi_smooth', 'cheb_smooth',
                'sss_spmv')
MGX_PATH = ('csr_spmv', 'jacobi_smooth', 'cheb_smooth', 'sss_spmv',
            'pcg_update', 'pcg_update:general')
MGX_HOST_PATH = ('csr_scatter', 'csr_spmv', 'jacobi_smooth', 'pcg_update',
                 'pcg_update:general')
KERNEL_INFO['cheb_smooth'] = (
    'cuda', 'pynucleus_tpu_torch/kernels/csrc/cheb_smooth.cu',
    'pynucleus_tpu/multilevel/gmg.py:170')
KERNEL_INFO['sss_spmv'] = (
    'cuda', 'pynucleus_tpu_torch/kernels/csrc/sss_spmv.cu',
    'pynucleus_tpu/base/linear_operators.py:434')
COMPARED_AT['cheb_smooth'] = (
    f'the Poisson square at noRef {SERIAL_NOREF} (n 1,046,529): the step '
    'mode per call (its 7 vectors), the zero and first modes beside it')
COMPARED_AT['sss_spmv'] = (
    f'the Poisson square at noRef {SERIAL_NOREF}: tril(A, -1) of the finest '
    'stiffness with its diagonal, per apply')


def mgx_seeded_spd(n=JAX_MG_EXTRAS['sss']['n'], seed=MGX_SSS_SEED):
    """The seeded SPD matrix of scripts/pin_multigrid_extras_jax.py
    seededSPD (numpy and scipy only)."""
    import numpy as np
    import scipy.sparse as sp
    rng = np.random.RandomState(seed)
    M = sp.random(n, n, density=4.0 / n, random_state=rng, format='csr')
    M = M + M.T
    return (M + sp.diags(np.asarray(abs(M).sum(axis=1)).ravel() + 1.0)) \
        .tocsr()


def mgx_levels(domain, noRef, first, device='cuda'):
    """The port's stiffness levels of the interval [0, 1] or of
    uniformSquare(N=2) refined ``first`` ... noRef times (K16 on the
    card), with their prolongations."""
    from pynucleus_tpu_torch.fem.meshes import simpleInterval, uniformSquare
    from pynucleus_tpu_torch.fem.dofmaps import P1_DoFMap
    from pynucleus_tpu_torch.fem.assembly import assembleStiffness
    from pynucleus_tpu_torch.multilevel.gmg import buildProlongation
    mesh = simpleInterval(0.0, 1.0) if domain == 'interval' else \
        uniformSquare(N=2, ax=0., ay=0., bx=1., by=1.)
    meshes = [mesh]
    for _ in range(noRef):
        meshes.append(meshes[-1].refine())
    levels, dmPrev = [], None
    for m in meshes[first:]:
        dm = P1_DoFMap(m, device=device)
        entry = {'A': assembleStiffness(dm), 'dm': dm}
        if dmPrev is not None:
            entry['P'] = buildProlongation(dmPrev, dm)
        levels.append(entry)
        dmPrev = dm
    return levels


def mgx_pin_lines(device='cuda'):
    """The pinned lines (a path): Chebyshev V and FMG_V on the interval
    and the square, the ILU smoother on its interval, the seeded SSS
    apply, against JAX_MG_EXTRAS (iterations exact, max|x| and rho per
    level 1e-10 relative, the apply 1e-13 of its largest entry).  Returns
    a summary."""
    import numpy as np
    import torch
    from pynucleus_tpu_torch.fem.assembly import assembleRHS
    from pynucleus_tpu_torch.fem.functions import constant
    from pynucleus_tpu_torch.multilevel.gmg import multigrid
    from pynucleus_tpu_torch.base.linear_operators import SSS_LinearOperator
    import scipy.sparse as sp
    out, bad = {}, []
    for line, spec in MGX_HIERARCHIES.items():
        ref = JAX_MG_EXTRAS[line]
        lv = mgx_levels(*spec, device=device)
        A = lv[-1]['A']
        if line == 'ilu':
            b = torch.ones(A.num_rows, dtype=torch.float64, device=device)
        else:
            b = assembleRHS(lv[-1]['dm'], constant(1.0)).data
        got = {'dofs': A.num_rows}
        if A.num_rows != ref['dofs']:
            bad.append(f"{line}: {A.num_rows} dofs, JAX {ref['dofs']}")
        for cycle in ('V',) if line == 'ilu' else ('V', 'FMG_V'):
            ml = multigrid(lv, smoother=('ilu', {}) if line == 'ilu'
                           else ('chebyshev', {}))
            ml.tolerance, ml.maxIter = MGX_TOL, MGX_MAXITER
            ml.setup()
            ml.cycle = cycle
            x = ml.solve(b)
            xmax = float(x.abs().max())
            got[cycle] = {'iterations': ml.iterations, 'xmax': xmax}
            r = ref[cycle]
            if ml.iterations != r['iterations'] or \
                    not _relclose(xmax, r['xmax'], TOL_MGX_PIN):
                bad.append(f'{line} {cycle}: {got[cycle]}, JAX {r}')
            if line != 'ilu':
                got['rhos'] = ml.levels.rhos
                rel = max(abs(a - c) / c for a, c in
                          zip(ml.levels.rhos, ref['rhos']))
                got['rhos_rel'] = rel
                if len(ml.levels.rhos) != len(ref['rhos']) or \
                        not rel <= TOL_MGX_PIN:
                    bad.append(f'{line}: rhos {ml.levels.rhos}, JAX '
                               f"{ref['rhos']}")
        out[line] = got
    ref = JAX_MG_EXTRAS['sss']
    Am = mgx_seeded_spd()
    L = sp.tril(Am, k=-1).tocsr()
    S = SSS_LinearOperator(L.indices, L.indptr, L.data, Am.diagonal(),
                           device=device)
    x = torch.as_tensor(np.random.RandomState(MGX_SSS_SEED + 1)
                        .standard_normal(ref['n']), device=device)
    y = S.matvec(x)
    yn = float(torch.linalg.norm(y))
    err4 = max(abs(a - c) for a, c in zip(y[:4].tolist(), ref['y4']))
    out['sss'] = {'nnz_L': int(L.nnz), 'y_norm': yn, 'y4_abs_err': err4}
    if L.nnz != ref['nnz_L'] or not _relclose(yn, ref['y_norm'],
                                               TOL_MGX_SSS) \
            or not err4 <= TOL_MGX_SSS * float(y.abs().max()):
        bad.append(f"sss: {out['sss']}, JAX {ref}")
    log(f'  the pinned lines (JAX_MG_EXTRAS): {json.dumps(out)}')
    if bad:
        raise AssertionError('multigrid extras against the JAX pins: '
                             + '; '.join(bad))
    return out


def _sync_seconds(fn):
    """(fn's result, its seconds by the host clock to a synchronize)."""
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return r, time.perf_counter() - t0


def mgx_full_line(serial):
    """The full-width line on phase 11's square (a path): Chebyshev
    multigrid's set-up (rho of each level by power iteration), V, FMG_V
    and CG preconditioned by its V-cycle at phase 11's tolerance,
    _mg_solve from 0 (its iterations must be V's), the SSS operator of
    tril(A, -1) against the CSR apply (1e-13 of the largest entry).
    Returns (the multigrid, the SSS operator, a summary)."""
    import torch
    import scipy.sparse as sp
    from pynucleus_tpu_torch.base.linear_operators import SSS_LinearOperator
    from pynucleus_tpu_torch.base.solvers import solverFactory
    from pynucleus_tpu_torch.multilevel.gmg import multigrid, _mg_solve
    hierarchy, b, tol = serial['hierarchy'], serial['b'], serial['tol']
    A = hierarchy[-1]['A']
    ml = multigrid(hierarchy, smoother=('chebyshev', {}))
    ml.tolerance, ml.maxIter = tol, MGX_MAXITER
    _, tSetup = _sync_seconds(ml.setup)
    summary = {'dofs': A.num_rows, 'levels': len(hierarchy), 'tol': tol,
               'setup_s': tSetup, 'rhos': ml.levels.rhos}
    bad = []

    def record(label, x, iterations, secs):
        # converged: multigrid tests ||b - A x||, CG its preconditioned
        # norm sqrt(r.M r) (the JAX package's criteria)
        res = float(torch.linalg.norm(b - A.matvec(x)))
        summary[label] = {'iterations': iterations, 'residual': res,
                          'seconds': secs,
                          'jacobi_iterations': JACOBI_COUNTS[label]}
        if not (iterations < MGX_MAXITER and (label == 'CG' or res <= tol)):
            bad.append(f'{label}: {iterations} iterations, residual {res} '
                       f'(tolerance {tol})')
    for cycle in ('V', 'FMG_V'):
        ml.cycle = cycle
        x, secs = _sync_seconds(lambda: ml.solve(b))
        record(cycle, x, ml.iterations, secs)
    cg = solverFactory.build('cg', A=A, setup=True)
    cg.tolerance, cg.maxIter = tol, MGX_MAXITER
    cg.setPreconditioner(ml.asPreconditioner())
    x, secs = _sync_seconds(lambda: cg.solve(b))
    record('CG', x, max(cg.iterations, 1), secs)
    (x, k, rn), secs = _sync_seconds(lambda: _mg_solve(
        ml.levels, b, torch.zeros_like(b), tol, MGX_MAXITER))
    summary['_mg_solve'] = {'iterations': k, 'rn': rn, 'seconds': secs}
    if k != summary['V']['iterations']:
        bad.append(f"_mg_solve: {k} iterations, multigrid.solve "
                   f"{summary['V']['iterations']}")
    Ah = A.to_scipy()
    L = sp.tril(Ah, k=-1).tocsr()
    S, tS = _sync_seconds(lambda: SSS_LinearOperator(
        L.indices, L.indptr, L.data, Ah.diagonal(), device=A.device))
    xs = _seeded(A.num_rows)
    ys, yr = S.matvec(xs), A.matvec(xs)
    err = float((ys - yr).abs().max() / yr.abs().max())
    summary['sss'] = {'nnz_L': int(L.nnz), 'construction_s': tS,
                      'rel_err_vs_csr': err}
    if not err <= TOL_MGX_SSS:
        bad.append(f'SSS apply {err} from the CSR apply')
    log(f'  Chebyshev (3+3) multigrid, square noRef {SERIAL_NOREF}: '
        f'{json.dumps(summary)}')
    if bad:
        raise AssertionError('Chebyshev multigrid at full width: '
                             + '; '.join(bad))
    return ml, S, summary


def mgx_host_line(device='cuda', noRef=MGX_HOST_NOREF):
    """The host smoothers on runSerialGMG's square at noRef (a path):
    hierarchyManager's levels, the ILU smoother's multigrid (set-up, the
    solve, its host round trips) and CG preconditioned by IChol, at
    tolerance 0.5 h^2.  Returns a summary."""
    import torch
    from pynucleus_tpu_torch.fem.meshes import uniformSquare
    from pynucleus_tpu_torch.fem.assembly import assembleRHS
    from pynucleus_tpu_torch.fem.functions import constant
    from pynucleus_tpu_torch.base.solvers import solverFactory
    from pynucleus_tpu_torch.multilevel import (hierarchyManager,
                                                paramsForMG, multigrid)
    hM, tH = _sync_seconds(lambda: hierarchyManager(
        uniformSquare(N=2, ax=0., ay=0., bx=1., by=1.),
        paramsForMG(noRef), device=device).setup())
    levels = hM.getLevelList()
    A = levels[-1]['A']
    tol = 0.5 * levels[-1]['mesh'].h ** 2
    b = assembleRHS(levels[-1]['dm'], constant(1.0)).data
    summary = {'dofs': A.num_rows, 'levels': len(levels), 'tol': tol,
               'hierarchy_s': tH}
    ml = multigrid(levels, smoother=('ilu', {}))
    ml.tolerance, ml.maxIter = tol, MGX_MAXITER
    _, tSetup = _sync_seconds(ml.setup)
    # the host part of each ILU step: its calls and seconds
    host = {'calls': 0, 'seconds': 0.0}
    for M in ml.levels.precOps[1:]:
        def timedFn(v, fn=M._fn):
            t0 = time.perf_counter()
            r = fn(v)
            host['calls'] += 1
            host['seconds'] += time.perf_counter() - t0
            return r
        M._fn = timedFn
    x, secs = _sync_seconds(lambda: ml.solve(b))
    res = float(torch.linalg.norm(b - A.matvec(x)))
    its = ml.iterations
    summary['ilu_mg'] = {
        'setup_s': tSetup, 'iterations': its, 'residual': res,
        'seconds': secs, 'seconds_per_cycle': secs / max(its, 1),
        'host_round_trips': host['calls'],
        'host_solve_seconds': host['seconds']}
    cg = solverFactory.build('cg', A=A, setup=True)
    cg.tolerance, cg.maxIter = tol, MGX_ICHOL_MAXITER
    ich, tIch = _sync_seconds(lambda: solverFactory.build('ichol', A=A,
                                                          setup=True))
    cg.setPreconditioner(ich.asPreconditioner())
    x, secs = _sync_seconds(lambda: cg.solve(b))
    res2 = float(torch.linalg.norm(b - A.matvec(x)))
    summary['ichol_cg'] = {'setup_s': tIch, 'iterations': cg.iterations,
                           'residual': res2, 'seconds': secs,
                           'seconds_per_iteration':
                           secs / max(cg.iterations, 1)}
    log(f'  host smoothers, square noRef {noRef}: {json.dumps(summary)}')
    # converged: multigrid on ||b - A x||, CG on sqrt(r.M r)
    if not (res <= tol and its < ml.maxIter
            and cg.iterations < MGX_ICHOL_MAXITER):
        raise AssertionError(f'host smoothers: ILU multigrid {its} '
                             f'iterations, residual {res} (tolerance {tol});'
                             f' IChol CG {cg.iterations} iterations')
    return summary


def compare_cheb_smooth(n, reps=20):
    """K26: its three modes on seeded vectors [n] against the plain
    version after an untimed call each; the row is the step mode (7
    vectors), the others beside it.  No single library call computes a
    step."""
    import torch
    from pynucleus_tpu_torch.multilevel.gmg import (cheb_smooth,
                                                    _cheb_smooth_plain)
    g = torch.Generator('cuda').manual_seed(26)
    b, Ax, x0, d0 = (torch.randn(n, dtype=torch.float64, device='cuda',
                                 generator=g) for _ in range(4))
    Dinv = torch.rand(n, dtype=torch.float64, device='cuda', generator=g) \
        + 0.5
    kw = {'zero': {'theta': 1.25}, 'first': {'theta': 1.25},
          'step': {'c1': 0.35, 'c2': 1.7}}
    # vectors read or written, and operations per dof
    modes = {'zero': (4, 2), 'first': (6, 4), 'step': (7, 6)}
    worst, byMode = 0.0, {}
    for mode, (nvec, ops) in modes.items():
        xk, dk, xp, dp = x0.clone(), d0.clone(), x0.clone(), d0.clone()
        cheb_smooth(mode, xk, b, dk, Dinv, Ax=Ax, **kw[mode])
        _cheb_smooth_plain(mode, xp, b, dp, Dinv, Ax, **kw[mode])
        err = max(float((xk - xp).abs().max()), float((dk - dp).abs().max()))
        scale = max(float(xp.abs().max()), float(dp.abs().max()))
        if not (scale > 0 and err <= TOL_MGX_SSS * scale):
            raise AssertionError(f'cheb_smooth ({mode}): max err {err}')
        worst = max(worst, err)
        ms = timed(lambda: [cheb_smooth(mode, xk, b, dk, Dinv, Ax=Ax,
                                        **kw[mode])
                            for _ in range(reps)]) / reps
        pms = timed(lambda: [_cheb_smooth_plain(mode, xp, b, dp, Dinv, Ax,
                                                **kw[mode])
                             for _ in range(reps)]) / reps
        work = [(8 * nvec * n, ops * n, F64_PEAK)]
        byMode[mode] = {'ms': ms, 'plain_ms': pms,
                        'bound_ms': bound(work)[0], 'work': work}
    log('  cheb_smooth: n {}, max abs err {:.3e}; '.format(n, worst)
        + ', '.join(f"{m} {v['ms']:.4f} ms (plain {v['plain_ms']:.4f}, "
                    f"bound {v['bound_ms']:.4f})" for m, v in byMode.items()))
    st = byMode['step']
    r = result(worst, st['ms'], st['plain_ms'], st['work'])
    r['modes'] = {m: {k: v for k, v in d.items() if k != 'work'}
                  for m, d in byMode.items()}
    return r


def compare_sss_spmv(S, A, reps=20):
    """K27 on the SSS operator S of phase 11's finest stiffness A against
    its plain version (1e-13 of the largest entry) after an untimed call,
    with torch.sparse on the symmetric CSR (the library yardstick, never
    used by the port) and K9 on it beside."""
    import torch
    from pynucleus_tpu_torch.base.linear_operators import (
        sss_spmv, _sss_spmv_plain, csr_spmv)
    args = (S.diag, S.data, S.indices, S.rowids, S.order1, S.offsets1,
            S.order2, S.offsets2)
    x = _seeded(S.num_rows)
    yk = sss_spmv(*args, x)
    yp = _sss_spmv_plain(S.diag, S.data, S.indices, S.rowids, x)
    err = float((yk - yp).abs().max())
    scale = float(yp.abs().max())
    if not (scale > 0 and err <= TOL_MGX_SSS * scale):
        raise AssertionError(f'sss_spmv: max err {err} (max {scale})')
    ms = timed(lambda: [sss_spmv(*args, x, out=yk)
                        for _ in range(reps)]) / reps
    plain_ms = timed(lambda: [_sss_spmv_plain(S.diag, S.data, S.indices,
                                              S.rowids, x)
                              for _ in range(reps)]) / reps
    lib = LibraryCSR(A)
    lib.matvec(x)
    lib_ms = timed(lambda: [lib.matvec(x) for _ in range(reps)]) / reps
    cargs = (A.indptr, A.indices, A.data, x)
    k9_ms = timed(lambda: [csr_spmv(*cargs, out=yp)
                           for _ in range(reps)]) / reps
    # what the function needs: L's data and its row and column ids, diag
    # and x read once, y written once (the kernel's host-sorted orders and
    # offsets are its own design, not the function's); per entry of L two
    # products and two sums
    work = [(nbytes(S.data, S.rowids, S.indices, S.diag, x) + 8 * S.num_rows,
             4 * S.data.shape[0] + 3 * S.num_rows, F64_PEAK)]
    log(f'  sss_spmv: n {S.num_rows}, nnz(L) {S.data.shape[0]}, max abs err '
        f'{err:.3e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, '
        f'torch.sparse (symmetric CSR) {lib_ms:.4f} ms, K9 on it {k9_ms:.4f} '
        f'ms, bound {bound(work)[0]:.4f} ms per apply')
    r = result(err, ms, plain_ms, work, lib_ms)
    r['csr_spmv_ms'] = k9_ms
    return r


def phase20(serial=None):
    """The multigrid extras: the pinned lines against the JAX outputs
    (a path), Chebyshev multigrid at full width on phase 11's square (a
    path), the host smoothers on the square at noRef MGX_HOST_NOREF (a
    path), then K26 and K27 against their plain versions at the noRef 9
    shapes.  ``serial`` is phase 11's square (alone: made here).  Returns
    (launch counts per path, comparisons, summary)."""
    import torch
    log('phase 20: the multigrid extras (Chebyshev and ILU smoothers, '
        '_mg_solve, the SSS apply, IChol)')
    t0 = time.perf_counter()
    if serial is None:
        serial = serial_square(SERIAL_NOREF)
    counts, summary = {}, {}
    summary['pins'], counts['pins'] = count_path(
        'multigrid extras pins', MGX_PIN_PATH, mgx_pin_lines)
    (ml, S, summary['full']), counts['full'] = count_path(
        f'Chebyshev multigrid noRef {SERIAL_NOREF}', MGX_PATH,
        lambda: mgx_full_line(serial))
    nLvl = len(ml.levels.As)
    M = ml.asPreconditioner()
    b = serial['b']
    z = torch.empty_like(b)
    M.matvec(b, out=z)
    summary['full']['vcycle_ms'] = timed(
        lambda: [M.matvec(b, out=z) for _ in range(10)]) / 10
    log(f"  V-cycle (Chebyshev 3+3, {nLvl} levels) "
        f"{summary['full']['vcycle_ms']:.3f} ms (CUDA events over 10 "
        'cycles)')
    del ml, M, z
    torch.cuda.empty_cache()
    summary['host'], counts['host'] = count_path(
        f'host smoothers noRef {MGX_HOST_NOREF}', MGX_HOST_PATH,
        mgx_host_line)
    cmp = {'cheb_smooth': compare_cheb_smooth(serial['A'].num_rows),
           'sss_spmv': compare_sss_spmv(S, serial['A'])}
    del S
    torch.cuda.empty_cache()
    summary['seconds'] = time.perf_counter() - t0
    log(f'phase 20 summary: {json.dumps(summary)}')
    return counts, cmp, summary


def MGX20_PATHS(counts20):
    """The main paths of phase 20: (kernels, label, launch counts)."""
    return ((MGX_PIN_PATH, 'mg_extras_pins', counts20['pins']),
            (MGX_PATH, f'chebyshev_mg_square_noRef{SERIAL_NOREF}',
             counts20['full']),
            (MGX_HOST_PATH, f'ilu_ichol_square_noRef{MGX_HOST_NOREF}',
             counts20['host']))


# ---------------------------------------------------------------- phase 21

# JAX package outputs printed by scripts/pin_twopoint_jax.py (the JAX
# package on the CPU, float64, its per-pair dense path): the largest entry,
# ||A||_F and the trace, ||A x|| and (A x)[:4] for x_k = cos(0.3 k),
# diag(A)[:4] of the interval [-1, 1] refined 4 times with the tempered
# phi (lambda 2, zeroExterior=False; its far entry's ratio to the
# unweighted kernel's), the leftRight and interface phis (with the
# zero-exterior term), the nonsymmetric order constantNonSym(0.25) with
# the tempered phi, the tempered kernel of a finite horizon (K14, getSparse
# on the interval with its collar), the log-inverse-distance, monomial and
# polynomial profiles (zeroExterior=False); greens2D with the tempered phi
# on the square refined 2 times (its real and imaginary parts); and
# runNonlocal's poly-Dirichlet lines (sparse, lu, horizon 0.2).  Held to
# TOL_TP_PIN (relative; (A x)[:4] and diag(A)[:4] to it of their
# largest); the interval's runNonlocal errors (the patch test, at rounding
# level) to 1e-10 absolute, the square's to rtol 1e-6
JAX_TWOPOINT = {'tempered_phi': {'dofs': 15,
                                 'max_entry': 0.3336563740814601,
                                 'fro': 1.350443143025439,
                                 'trace': 4.745761686183031,
                                 'Ax_norm': 1.0913206392453707,
                                 'Ax4': [0.32807091060666693,
                                         0.42856579778295323,
                                         0.3791728339407006,
                                         0.30606144543001734],
                                 'diag4': [0.2482033095395635,
                                           0.3336563740814601,
                                           0.33345910600478706,
                                           0.32868829721716325],
                                 'far_ratio': 0.030844852201646174},
                'leftRight': {'dofs': 15,
                              'max_entry': 0.9504359031866001,
                              'fro': 2.949930512798188,
                              'trace': 10.56685069550095,
                              'Ax_norm': 2.070467101745148,
                              'Ax4': [0.6098562521330504,
                                      0.6838438394416552,
                                      0.7954847298409172,
                                      0.4552290948137437],
                              'diag4': [0.5243787157048646,
                                        0.5777387693535567,
                                        0.6961818763041907,
                                        0.5326477166177579]},
                'interface': {'dofs': 15,
                              'max_entry': 0.5238839236535221,
                              'fro': 1.5088049331705105,
                              'trace': 4.84959147085016,
                              'Ax_norm': 1.3453974672058013,
                              'Ax4': [0.6080017317127377,
                                      0.45848017645226313,
                                      0.18396952445832937,
                                      0.45119480557856784],
                              'diag4': [0.5238839236535221,
                                        0.3171062604735405,
                                        0.1638778147763551,
                                        0.5238652553086961]},
                'nonsym_tempered': {'dofs': 15,
                                    'max_entry': 0.20592357585227916,
                                    'fro': 0.7544434032217756,
                                    'trace': 2.8843309499008414,
                                    'Ax_norm': 0.6159168115943436,
                                    'Ax4': [0.21949231362724242,
                                            0.22212218657565408,
                                            0.19977008080855704,
                                            0.14744580920813108],
                                    'diag4': [0.2059235758522791,
                                              0.18567685806925033,
                                              0.18594559081091672,
                                              0.190442295918542]},
                'tempered_k14': {'dofs': 159,
                                 'max_entry': 8.439575981604442,
                                 'fro': 112.86710316093202,
                                 'trace': 1341.8925810750047,
                                 'Ax_norm': 54.33821314533362,
                                 'Ax4': [7.080595098814382,
                                         5.680627870328775,
                                         2.6776316340205963,
                                         0.94859696137146],
                                 'diag4': [8.439575981603376,
                                           8.439575981603635,
                                           8.439575981603914,
                                           8.439575981604408]},
                'logInverseDistance': {'dofs': 15,
                                       'max_entry': 0.2317863950166631,
                                       'fro': 0.7806413568294248,
                                       'trace': 2.654625003333725,
                                       'Ax_norm': 0.6964500403840558,
                                       'Ax4': [0.08069531433928934,
                                               0.33321991227174785,
                                               0.31598029985830145,
                                               0.15211524620554484],
                                       'diag4': [0.07777458531697362,
                                                 0.2317863950166631,
                                                 0.2291712520288341,
                                                 0.18809498385002468]},
                'monomial': {'dofs': 15,
                             'max_entry': 0.1463541666666667,
                             'fro': 0.4766145627014804,
                             'trace': 1.6028645833333341,
                             'Ax_norm': 0.3392675112230754,
                             'Ax4': [0.191360352567918,
                                     0.10004332498121979,
                                     0.0879587585501285,
                                     0.09520541386628226],
                             'diag4': [0.1463541666666667,
                                       0.08255208333333337,
                                       0.0838541666666667,
                                       0.1033854166666667]},
                'polynomial': {'dofs': 15,
                               'max_entry': 0.012705956623775931,
                               'fro': 0.05245773766120673,
                               'trace': 0.18120877363115023,
                               'Ax_norm': 0.047025050498425223,
                               'Ax4': [0.012228649052388477,
                                       0.017971153144913272,
                                       0.015953745845357754,
                                       0.013439983714457444],
                               'diag4': [0.008357779442044591,
                                         0.012705956623775931,
                                         0.012705956623775931,
                                         0.012705956623775928]},
                'greens_tempered_re': {'dofs': 9,
                                       'max_entry': 0.008250657184068692,
                                       'fro': 0.025906757331406082,
                                       'trace': -0.06895165289195995,
                                       'Ax_norm': 0.018031199090752875,
                                       'Ax4': [-0.007788849995508121,
                                               -0.00488141171892114,
                                               -0.00530067206761402,
                                               -0.007271676737350497],
                                       'diag4': [-0.008164419876842974,
                                                 -0.008164419876842978,
                                                 -0.00825065718406869,
                                                 -0.007428783261754667]},
                'greens_tempered_im': {'dofs': 9,
                                       'max_entry': 0.02322834234588816,
                                       'fro': 0.0571818139164532,
                                       'trace': 0.16386690946022628,
                                       'Ax_norm': 0.035053270794369366,
                                       'Ax4': [0.01579038214366782,
                                               0.013953835551692646,
                                               0.007740686547324499,
                                               0.010646002822672963],
                                       'diag4': [0.015898476246198414,
                                                 0.015898476246198414,
                                                 0.01575870477238807,
                                                 0.01933105415834802]},
                'run_nonlocal': {
                    'interval_gaussian_noRef6': {
                        'dofs': 639,
                        'L2 error interpolated': 6.4247010076930075e-12},
                    'interval_exponential_noRef6': {
                        'dofs': 639,
                        'L2 error interpolated': 8.358673601561266e-14},
                    'square_gaussian_noRef2': {
                        'dofs': 1521,
                        'L2 error interpolated': 0.009458331118282133}}}
TOL_TP_PIN = 1e-11
TOL_TP_ERR_ABS = 1e-10
TOL_TP_SQUARE = 1e-6
TP_LAMBDA = 2.0          # temperedTwoPoint's lambda
TP_TEMPER = 3.0          # the finite-horizon tempered kernel's lambda
TP_FULL_NOREF = 6        # the flagship disc, 18,145 dofs
TP_CHECK_NOREF = 5       # the grid variants' comparison shapes
# runNonlocal's interval, sparse CG-MG (cut so that the script keeps within
# its time limit, PERF.md section 4: 10 before phase 24, 9 before phase 25)
TP_NONLOCAL_NOREF = 8
TP_FH_NOREF = 8          # the weighted finite horizon on the interval
TP_CG_TOL = 1e-8
TP_CG_MAXITER = 2000
TOL_TP_RATIO = 1e-12
TP_PIN_PATH = ('panel_scatter', 'panel_scatter:dense', 'panel_scatter:slots',
               'panel_scatter_nonsym', 'cut1d', 'panel_scatter:two_point',
               'panel_scatter:tempered', 'panel_scatter:log_inverse',
               'panel_scatter:polynomial', 'cut1d:tempered',
               'cut1d:polynomial', 'panel_scatter_nonsym:two_point',
               'panel_scatter:complex')
TP_NONLOCAL_PATH = ('panel_scatter', 'panel_scatter:slots',
                    'panel_scatter:cross')
TP_FULL_PATH = ('panel_scatter', 'panel_scatter:dense', 'grid_distant',
                'grid_boundary', 'pcg_update', 'pcg_update:jacobi',
                'panel_scatter:two_point', 'panel_scatter:tempered',
                'grid_distant:two_point', 'grid_distant:tempered',
                'grid_boundary:tempered')
TP_FH_PATH = ('panel_scatter', 'panel_scatter:slots', 'cut1d', 'cut2d_polar',
              'panel_scatter:tempered', 'panel_scatter:two_point',
              'cut1d:tempered', 'cut1d:two_point', 'cut2d_polar:tempered',
              'cut2d_polar:two_point', 'panel_scatter_nonsym',
              'panel_scatter_nonsym:two_point', 'grid_distant',
              'grid_distant:log_inverse', 'panel_scatter:log_inverse')
# the JAX programs each variant replaces
TWOPOINT_REPLACES = {
    'panel_scatter': 'pynucleus_tpu/nl/assembly.py:91 with phiJax (:58-62), '
                     'the tempered profile (nl/kernels.py:1095-1096) or the '
                     'log-inverse-distance and polynomial profiles '
                     '(:1122-1128)',
    'grid_distant': 'pynucleus_tpu/nl/assembly.py:131 with the tempered '
                    'profile (nl/kernels.py:1095-1096) or the '
                    'log-inverse-distance profile; with phiJax, which the '
                    'JAX program drops (a reference fault)',
    'grid_boundary': 'pynucleus_tpu/nl/assembly.py:240 with the tempered '
                     'boundary kernel (nl/kernels.py:1316-1327)',
    'cut1d': 'pynucleus_tpu/nl/assembly.py:644 with the gaussian, '
             'exponential, tempered or polynomial profile and phiJax '
             '(:607)',
    'cut2d_polar': 'pynucleus_tpu/nl/assembly.py:511 with the gaussian or '
                   'tempered profile and phiJax (:674)',
    'panel_scatter_nonsym': 'pynucleus_tpu/nl/assembly.py:424 with phiJax '
                            '(:435-436)',
}
TWOPOINT_COMPARED_AT = {
    'panel_scatter:two_point': f'the disc at noRef {TP_CHECK_NOREF} (grid '
                               'build, its largest dense call) and the '
                               f'interval at noRef {TP_FH_NOREF} (sparse, '
                               'its largest slots call)',
    'panel_scatter:tempered': 'the same as two_point, the tempered kernel',
    'panel_scatter:log_inverse': f'the disc at noRef {TP_CHECK_NOREF} (grid '
                                 'build, its largest dense call)',
    'panel_scatter:polynomial': 'the pinned interval at noRef 4 (all dense '
                                'calls)',
    'grid_distant:two_point': f'the disc at noRef {TP_CHECK_NOREF}, all calls',
    'grid_distant:tempered': f'the disc at noRef {TP_CHECK_NOREF}, all calls',
    'grid_distant:log_inverse': f'the disc at noRef {TP_CHECK_NOREF}, all '
                                'calls',
    'grid_boundary:tempered': f'the disc at noRef {TP_CHECK_NOREF}',
    'cut1d:gaussian': f'runNonlocal interval noRef {TP_NONLOCAL_NOREF}, its '
                      'largest call',
    'cut1d:exponential': f'runNonlocal interval noRef {TP_NONLOCAL_NOREF}, '
                         'its largest call',
    'cut1d:tempered': f'the interval at noRef {TP_FH_NOREF} (sparse), all '
                      'calls',
    'cut1d:two_point': f'the interval at noRef {TP_FH_NOREF} (sparse), all '
                       'calls',
    'cut1d:polynomial': 'the pinned interval at noRef 4, all calls',
    'cut2d_polar:gaussian': 'runNonlocal square noRef 2, all calls',
    'cut2d_polar:tempered': 'the square at noRef 1 (sparse), all calls',
    'cut2d_polar:two_point': 'the square at noRef 1 (sparse), all calls',
    'panel_scatter_nonsym:two_point': f'the interval at noRef {TP_FH_NOREF} '
                                      '(constantNonSym(0.25), dense), its '
                                      'largest call',
}


def TWOPOINT21_PATHS(counts21):
    """The main paths of phase 21: (kernels, label, launch counts)."""
    return ((TP_PIN_PATH, 'twopoint_pins', counts21['pins']),) + tuple(
        (TP_NONLOCAL_PATH, f'run_nonlocal_{key}', counts21[key])
        for key in counts21 if key.startswith(('interval_', 'square_'))) + (
        (TP_FULL_PATH, f'tempered_disc_noRef{TP_FULL_NOREF}',
         counts21['full']),
        (TP_FH_PATH, 'weighted_finite_horizon_and_checks',
         counts21['checks']))


def tp_summary(D):
    """tp pins' summary of a dense [N, N] tensor (real)."""
    import torch
    x = torch.cos(0.3 * torch.arange(D.shape[0], dtype=torch.float64,
                                     device=D.device))
    Ax = D @ x
    return {'dofs': int(D.shape[0]), 'max_entry': float(D.abs().max()),
            'fro': float(torch.linalg.norm(D)),
            'trace': float(torch.trace(D)),
            'Ax_norm': float(torch.linalg.norm(Ax)),
            'Ax4': [float(v) for v in Ax[:4]],
            'diag4': [float(v) for v in torch.diagonal(D)[:4]]}


def check_tp_pin(label, got, ref, tol=None):
    """got against the pinned ref (tp_summary's keys), to ``tol``
    (TOL_TP_PIN by default)."""
    if got['dofs'] != ref['dofs']:
        raise AssertionError(f'{label}: dofs {got["dofs"]} != {ref["dofs"]}')
    worst = 0.0
    for k in ('max_entry', 'fro', 'trace', 'Ax_norm', 'far_ratio'):
        if k in ref:
            worst = max(worst, abs(got[k] - ref[k]) / abs(ref[k]))
    for k in ('Ax4', 'diag4'):
        scale = max(abs(v) for v in ref[k])
        worst = max(worst, max(abs(a - b) for a, b in zip(got[k], ref[k]))
                    / scale)
    if not worst <= (TOL_TP_PIN if tol is None else tol):
        raise AssertionError(f'{label}: {got} vs the JAX pin {ref} ({worst})')
    log(f'  {label}: {got["dofs"]} dofs, max {got["max_entry"]:.6e}, '
        f'within {worst:.2e} of the JAX pin')
    return worst


def tp_dm(mesh, tag=None):
    from pynucleus_tpu_torch.fem.dofmaps import P1_DoFMap
    from pynucleus_tpu_torch.fem.meshes import PHYSICAL
    return P1_DoFMap(mesh, PHYSICAL if tag is None else tag, device='cuda')


def tp_refined(mesh, noRef):
    for _ in range(noRef):
        mesh = mesh.refine()
    return mesh


def tp_dense(dm, kernel, zeroExterior=True, params=None):
    from pynucleus_tpu_torch.nl.assembly import nonlocalBuilder
    return nonlocalBuilder(dm, kernel, zeroExterior=zeroExterior,
                           params=params).getDense().data


def tp_pin_lines():
    """The port's operators of scripts/pin_twopoint_jax.py on the card,
    per pair, against JAX_TWOPOINT."""
    import torch
    from pynucleus_tpu_torch.fem.meshes import simpleInterval, uniformSquare
    from pynucleus_tpu_torch.nl import kernels as tk
    from pynucleus_tpu_torch.nl.assembly import nonlocalBuilder
    from pynucleus_tpu_torch.nl.problems import nonlocalMesh, DIRICHLET
    perPair = {'denseGrid': False}
    dm = tp_dm(tp_refined(simpleInterval(-1, 1), 4))
    out, worst = {}, 0.0
    A = tp_dense(dm, tk.getFractionalKernel(
        1, 0.4, phi=tk.temperedTwoPoint(TP_LAMBDA)), False, perPair)
    A0 = tp_dense(dm, tk.getFractionalKernel(1, 0.4), False, perPair)
    out['tempered_phi'] = tp_summary(A)
    out['tempered_phi']['far_ratio'] = float(A[0, -1] / A0[0, -1])
    for name, phi in (('leftRight', tk.leftRightTwoPoint(1.0, 2.0, 0.5, 3.0,
                                                         0.1)),
                      ('interface', tk.interfaceTwoPoint(0.3, 0.2, True,
                                                         0.05))):
        out[name] = tp_summary(tp_dense(dm, tk.getFractionalKernel(
            1, 0.4, phi=phi), params=perPair))
    out['nonsym_tempered'] = tp_summary(tp_dense(dm, tk.getFractionalKernel(
        1, tk.constantNonSymFractionalOrder(0.25),
        phi=tk.temperedTwoPoint(TP_LAMBDA)), params=perPair))
    kt = tk.FractionalKernel(1, 0.4, 0.2, tk.ball2(), temperedLambda=TP_TEMPER)
    mesh, info = nonlocalMesh('interval', kt, DIRICHLET)
    dmc = tp_dm(tp_refined(mesh, 4), info['domain'])
    S = nonlocalBuilder(dmc, kt).getSparse()
    out['tempered_k14'] = tp_summary(torch.as_tensor(S.toarray(),
                                                     device=dmc.device))
    for name, kern in (
            ('logInverseDistance',
             tk.getIntegrableKernel(1, 'logInverseDistance', float('inf'))),
            ('monomial', tk.Kernel(1, 'monomial', float('inf'), None, 0.5,
                                   1.0, monomialPower=1.0)),
            ('polynomial', tk.Kernel(1, 'polynomial', 0.3, tk.ball2(), 0.5,
                                     0.0, exponentParam=0.3))):
        out[name] = tp_summary(tp_dense(dm, kern, False, perPair))
    G = tp_dense(tp_dm(tp_refined(uniformSquare(2, 2, 0, 0, 1, 1), 2)),
                 tk.getComplexKernel(2, greensLambda=-3j,
                                     phi=tk.temperedTwoPoint(1.0)))
    for part, D in (('re', G.real.contiguous()), ('im', G.imag.contiguous())):
        out['greens_tempered_' + part] = tp_summary(D)
    for name, got in out.items():
        worst = max(worst, check_tp_pin(name, got, JAX_TWOPOINT[name]))
    return {'worst': worst,
            'far_ratio': out['tempered_phi']['far_ratio']}


def tp_nonlocal_line(domain, kind, noRef, solver, path):
    """runNonlocal's poly-Dirichlet line (sparse, horizon 0.2) of the kernel
    type on the card (a path): dofs, iterations, L2 error, seconds."""
    out, counts = run_nonlocal_path(
        nonlocal_argv(domain, noRef, 'sparse', solver, kind), path)
    res, tim = out['results'].toDict(), out['timers'].toDict()
    line = {'dofs': res['dofs'], 'iterations': res['iterations'],
            'L2 error interpolated':
            out['errors'].toDict()['L2 error interpolated'],
            'assembly_s': tim['assembly seconds'],
            'solve_s': tim['solve seconds'], 'peak_GiB': out['peak'] / 2**30}
    return line, counts


def tp_full_line():
    """The flagship disc at TP_FULL_NOREF on the port's default grid: the
    tempered phi and the tempered kernel (zeroExterior=False) with A_phi =
    (C / C_t) A_t to TOL_TP_RATIO of the largest entry (K1 and K2 apply phi
    and the tempering), then the tempered problem (with its zero-exterior
    term: K3 with the tempered boundary kernel) solved by CG-Jacobi."""
    import torch
    from pynucleus_tpu_torch.base.solvers import solverFactory
    from pynucleus_tpu_torch.fem import assembleRHS, constant
    from pynucleus_tpu_torch.fem.meshes import circle
    from pynucleus_tpu_torch.nl import kernels as tk
    dm = tp_dm(tp_refined(circle(h=0.78, radius=1.0), TP_FULL_NOREF))
    kphi = tk.getFractionalKernel(2, 0.75, phi=tk.temperedTwoPoint(TP_LAMBDA))
    kt = tk.FractionalKernel(2, 0.75, temperedLambda=TP_LAMBDA)
    line = {'dofs': dm.num_dofs}
    for key, k in (('phi', kphi), ('tempered', kt)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        line[key] = tp_dense(dm, k, zeroExterior=False)
        torch.cuda.synchronize()
        line[key + '_assembly_s'] = time.perf_counter() - t0
    ratio = kphi.scalingValue / kt.scalingValue
    scale = float(line['phi'].abs().max())
    err = float((line['phi'] - ratio * line['tempered']).abs().max()) / scale
    del line['phi'], line['tempered']
    if not err <= TOL_TP_RATIO:
        raise AssertionError(f'A_phi != (C/C_t) A_t: {err}')
    line['ratio_err'] = err
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    from pynucleus_tpu_torch.nl.assembly import nonlocalBuilder
    A = nonlocalBuilder(dm, kt).getDense()
    torch.cuda.synchronize()
    line['zero_exterior_assembly_s'] = time.perf_counter() - t0
    b = assembleRHS(dm, constant(1.0)).data
    s = solverFactory.build('cg-jacobi', A=A, setup=True)
    s.tolerance, s.maxIter = TP_CG_TOL, TP_CG_MAXITER
    for key in ('cg_s', 'cg_warm_s'):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = s.solve(b)
        torch.cuda.synchronize()
        line[key] = time.perf_counter() - t0
    line['iterations'] = s.iterations
    r = float(torch.linalg.norm(b - A.data @ x) / torch.linalg.norm(b))
    line['relative_residual'] = r
    line['x_max'] = float(x.abs().max())
    line['peak_GiB'] = torch.cuda.max_memory_allocated() / 2**30
    # the CG's own test: sqrt(r.M r) below its absolute tolerance
    if not (s.residuals[-1] <= s.tolerance and s.iterations < TP_CG_MAXITER
            and bool(x.isfinite().all())):
        raise AssertionError(f'CG-Jacobi on the tempered disc: {line}')
    log(f'  the tempered disc noRef {TP_FULL_NOREF}: {dm.num_dofs} dofs, '
        f'A_phi = (C/C_t) A_t to {err:.2e}, assemblies '
        f"{line['phi_assembly_s']:.3f} / {line['tempered_assembly_s']:.3f} / "
        f"{line['zero_exterior_assembly_s']:.3f} s, CG-Jacobi "
        f"{s.iterations} iterations in {line['cg_s']:.3f} s (warm "
        f"{line['cg_warm_s']:.3f} s), relative residual {r:.2e}")
    del A
    torch.cuda.empty_cache()
    return line


def tp_check_lines():
    """The variants' comparison builds (a path): the tempered phi and the
    tempered kernel on the disc at TP_CHECK_NOREF on the grid (the kernel
    with its zero-exterior term) and the log-inverse-distance kernel there;
    the weighted finite horizon, FractionalKernel(0.4, horizon 0.2,
    temperedLambda TP_TEMPER) times the tempered phi, on the interval at
    TP_FH_NOREF and the square at noRef 1 (sparse, held to the dense
    operator), and constantNonSym(0.25) with the tempered phi on the
    interval at TP_FH_NOREF (dense, per pair)."""
    import torch
    from pynucleus_tpu_torch.fem.meshes import circle, simpleInterval
    from pynucleus_tpu_torch.nl import kernels as tk
    from pynucleus_tpu_torch.nl.assembly import nonlocalBuilder
    from pynucleus_tpu_torch.nl.problems import nonlocalMesh, DIRICHLET
    dm = tp_dm(tp_refined(circle(h=0.78, radius=1.0), TP_CHECK_NOREF))
    for k, ze in ((tk.getFractionalKernel(2, 0.75,
                                          phi=tk.temperedTwoPoint(TP_LAMBDA)),
                   False),
                  (tk.FractionalKernel(2, 0.75, temperedLambda=TP_LAMBDA),
                   True),
                  (tk.getIntegrableKernel(2, 'logInverseDistance',
                                          float('inf')), False)):
        A = tp_dense(dm, k, zeroExterior=ze)
        if not A.isfinite().all():
            raise AssertionError('a check build is not finite')
    del A
    line = {}
    for dim, noRef in ((1, TP_FH_NOREF), (2, 1)):
        k = tk.FractionalKernel(dim, 0.4, 0.2, tk.ball2(),
                                temperedLambda=TP_TEMPER).setTwoPoint(
            tk.temperedTwoPoint(TP_LAMBDA))
        mesh, info = nonlocalMesh('interval' if dim == 1 else 'square', k,
                                  DIRICHLET)
        b = nonlocalBuilder(tp_dm(tp_refined(mesh, noRef), info['domain']), k)
        S = b.getSparse()
        x = _cos(S.num_rows)
        y = S.matvec(x)
        if dim == 2:
            D = b.getDense()
            err = float((D.matvec(x) - y).abs().max() / y.abs().max())
            if not err <= TOL_KERNEL:
                raise AssertionError(f'sparse vs dense, weighted: {err}')
            line['square_sparse_vs_dense'] = err
        line[f'dim{dim}'] = {'dofs': S.num_rows, 'Ax_norm':
                             float(torch.linalg.norm(y))}
    dmi = tp_dm(tp_refined(simpleInterval(-1, 1), TP_FH_NOREF))
    A = tp_dense(dmi, tk.getFractionalKernel(
        1, tk.constantNonSymFractionalOrder(0.25),
        phi=tk.temperedTwoPoint(TP_LAMBDA)))
    line['nonsym_dofs'] = int(A.shape[0])
    if not A.isfinite().all():
        raise AssertionError('the nonsymmetric build is not finite')
    log(f'  the weighted finite horizon and checks: {json.dumps(line)}')
    return line


def unweighted_ms(calls, kernel):
    """The kernel's ms on recorded calls with the tempering and the
    two-point weight taken out of their profile (the same shapes and
    profile code): the cost of the weight, within one run."""
    import torch
    from pynucleus_tpu_torch.nl.kernels import Profile
    ms = 0.0
    for (shape, *args), kw in calls:
        args = [a._replace(t=0.0, wcode=0, wlam=0.0)
                if isinstance(a, Profile) else a for a in args]
        dev = next(a.device for a in args if isinstance(a, torch.Tensor))
        D = torch.zeros(shape, dtype=torch.float64, device=dev)
        kernel(D, *args, **kw)
        ms += timed(lambda: kernel(D, *args, **kw))
    return ms


def _variant(args):
    """A recorded call's variant key (profile code, tempered, two-point
    code), from its first Profile argument."""
    from pynucleus_tpu_torch.nl.kernels import Profile
    prof = next(a for a in args if isinstance(a, Profile))
    return int(prof.code), float(prof.t) != 0.0, int(prof.wcode)


class VariantRecorder(ArgRecorder):
    """An ArgRecorder (the target recorded by its shape) that keeps the
    calls of each variant apart (``byKey``, keyed by _variant): every call,
    or with ``size`` only each variant's largest."""

    def __init__(self, module, name, size=None):
        super().__init__(module, name, dataFirst=True)
        self.vsize = size
        self.byKey, self.best = {}, {}

    def __enter__(self):
        def rec(*args, **kw):
            key = _variant(args)
            if self.vsize is None:
                self.byKey.setdefault(key, []).append(self._record(args, kw))
            else:
                size = self.vsize(*args)
                if size > self.best.get(key, -1):
                    self.best[key] = size
                    self.byKey[key] = [self._record(args, kw)]
            return self.orig(*args, **kw)
        setattr(self.module, self.name, rec)
        return self

    def select(self, pick):
        """The recorded calls of the variants that pick(code, tempered,
        wcode) selects."""
        return [c for key, cs in self.byKey.items() if pick(*key) for c in cs]


def phase21():
    """The two-point weights, the tempered kernels and the remaining
    profiles: the pins of scripts/pin_twopoint_jax.py (a path), runNonlocal's
    gaussian and exponential lines against the JAX driver's errors (each a
    path), the flagship disc at TP_FULL_NOREF with the tempered phi and the
    tempered kernel (a path), runNonlocal's interval at TP_NONLOCAL_NOREF
    with CG-MG (each a path), and the weighted finite horizon and the
    comparison builds (a path); then each new variant of K1, K2, K3, K14,
    K15 and K19 against its plain version.  Returns (launch counts per
    path, comparisons, summary)."""
    import contextlib
    import pynucleus_tpu_torch.nl.assembly as asm
    from pynucleus_tpu_torch.nl.kernels import (
        TWO_POINT_TEMPERED, LOG_INVERSE_DISTANCE_PROFILE, POLYNOMIAL_PROFILE,
        GAUSSIAN_PROFILE, EXPONENTIAL_PROFILE)
    log('phase 21: the two-point weights, the tempered kernels and the '
        'remaining profiles')
    t0 = time.perf_counter()
    counts, summary = {}, {}
    names = ('panel_scatter', 'panel_scatter_slots', 'cut1d', 'cut2d_polar',
             'grid_distant', 'grid_boundary', 'panel_scatter_nonsym')
    sizes = {'panel_scatter': _k1_size, 'panel_scatter_slots': _k1_size,
             'cut1d': lambda o, t, i, v, vi1, *a, **k: vi1.shape[0],
             'panel_scatter_nonsym': _k19_size}

    def recorders(stack, largest=()):
        return {n: stack.enter_context(VariantRecorder(
            asm, n, size=sizes[n] if n in largest else None)) for n in names}
    recs = {}
    with contextlib.ExitStack() as stack:
        recs['pins'] = recorders(stack)
        summary['pins'], counts['pins'] = count_path(
            'two-point pins', TP_PIN_PATH, tp_pin_lines)
    summary['run_nonlocal'] = {}
    for key, (domain, kind, noRef) in {
            'interval_gaussian_noRef6': ('interval', 'gaussian', 6),
            'interval_exponential_noRef6': ('interval', 'exponential', 6),
            'square_gaussian_noRef2': ('square', 'gaussian', 2)}.items():
        cut = 'cut1d' if domain == 'interval' else 'cut2d_polar'
        with contextlib.ExitStack() as stack:
            recs[key] = recorders(stack)
            line, counts[key] = tp_nonlocal_line(
                domain, kind, noRef, 'lu',
                TP_NONLOCAL_PATH + (cut, f'{cut}:{kind}'))
        ref = JAX_TWOPOINT['run_nonlocal'][key]
        got, want = line['L2 error interpolated'], \
            ref['L2 error interpolated']
        ok = line['dofs'] == ref['dofs'] and (
            abs(got - want) <= TOL_TP_ERR_ABS if domain == 'interval'
            else abs(got - want) <= TOL_TP_SQUARE * want)
        if not ok:
            raise AssertionError(f'{key}: {line} vs the JAX driver {ref}')
        summary['run_nonlocal'][key] = line
    summary['full'], counts['full'] = count_path(
        f'tempered disc noRef {TP_FULL_NOREF}', TP_FULL_PATH, tp_full_line)
    for kind in ('gaussian', 'exponential'):
        key = f'interval_{kind}_noRef{TP_NONLOCAL_NOREF}_cg_mg'
        with contextlib.ExitStack() as stack:
            recs[key] = recorders(stack, largest=('cut1d',))
            summary['run_nonlocal'][key], counts[key] = tp_nonlocal_line(
                'interval', kind, TP_NONLOCAL_NOREF, 'cg-mg',
                TP_NONLOCAL_PATH + ('cut1d', f'cut1d:{kind}', 'csr_spmv',
                                    'jacobi_smooth', 'pcg_update'))
    with contextlib.ExitStack() as stack:
        recs['checks'] = recorders(stack, largest=(
            'panel_scatter', 'panel_scatter_slots', 'panel_scatter_nonsym'))
        summary['checks'], counts['checks'] = count_path(
            'weighted finite horizon and checks', TP_FH_PATH, tp_check_lines)

    log('  the variants against their plain versions')
    chk, pins = recs['checks'], recs['pins']

    def weighted(code, tempered, wcode):
        return wcode == TWO_POINT_TEMPERED

    def tempered(code, tempered, wcode):
        return tempered

    def ofCode(c):
        return lambda code, tempered, wcode: code == c

    def compare(label, rec, pick, kernel, plain, work):
        """The calls against the plain version; for a tempered or weighted
        variant also the same calls without the weight (unweighted_ms)."""
        calls = rec.select(pick)
        r = compare_target_kernel(label, calls, kernel, plain, work)
        if pick in (weighted, tempered):
            r['unweighted_ms'] = unweighted_ms(calls, kernel)
            log(f"  {label}: the same calls without the weight "
                f"{r['unweighted_ms']:.3f} ms")
        return r
    cmp = {}
    for key, pick in (('two_point', weighted), ('tempered', tempered)):
        cmp['panel_scatter:' + key] = merge(
            compare(f'panel_scatter ({key}, dense)', chk['panel_scatter'],
                    pick, asm.panel_scatter, asm._panel_scatter_plain,
                    panel_work),
            compare(f'panel_scatter ({key}, slots)',
                    chk['panel_scatter_slots'], pick, asm.panel_scatter_slots,
                    asm._panel_scatter_slots_plain, panel_work))
    for key, code, rec in (
            ('log_inverse', LOG_INVERSE_DISTANCE_PROFILE, chk),
            ('polynomial', POLYNOMIAL_PROFILE, pins)):
        cmp['panel_scatter:' + key] = compare(
            f'panel_scatter ({key})', rec['panel_scatter'], ofCode(code),
            asm.panel_scatter, asm._panel_scatter_plain, panel_work)
    for key, pick in (('two_point', weighted), ('tempered', tempered),
                      ('log_inverse', ofCode(LOG_INVERSE_DISTANCE_PROFILE))):
        cmp['grid_distant:' + key] = compare(
            f'grid_distant ({key})', chk['grid_distant'], pick,
            asm.grid_distant, asm._grid_distant_plain, grid_distant_work)
    cmp['grid_boundary:tempered'] = compare(
        'grid_boundary (tempered)', chk['grid_boundary'], tempered,
        asm.grid_boundary, asm._grid_boundary_plain, grid_boundary_work)
    for key, rec, pick in (
            ('gaussian', recs[f'interval_gaussian_noRef{TP_NONLOCAL_NOREF}'
                              '_cg_mg'], ofCode(GAUSSIAN_PROFILE)),
            ('exponential', recs[f'interval_exponential_noRef'
                                 f'{TP_NONLOCAL_NOREF}_cg_mg'],
             ofCode(EXPONENTIAL_PROFILE)),
            ('tempered', chk, tempered), ('two_point', chk, weighted),
            ('polynomial', pins, ofCode(POLYNOMIAL_PROFILE))):
        cmp['cut1d:' + key] = compare(f'cut1d ({key})', rec['cut1d'], pick,
                                      asm.cut1d, asm._cut1d_plain,
                                      cut1d_work)
    for key, rec, pick in (
            ('gaussian', recs['square_gaussian_noRef2'],
             ofCode(GAUSSIAN_PROFILE)),
            ('tempered', chk, tempered), ('two_point', chk, weighted)):
        cmp['cut2d_polar:' + key] = compare(
            f'cut2d_polar ({key})', rec['cut2d_polar'], pick,
            asm.cut2d_polar, asm._cut2d_polar_plain, cut2d_work)
    cmp['panel_scatter_nonsym:two_point'] = compare(
        'panel_scatter_nonsym (two_point, dense)',
        chk['panel_scatter_nonsym'], weighted, asm.panel_scatter_nonsym,
        _k19_plain('dense'), nonsym_work)
    summary['seconds'] = time.perf_counter() - t0
    log(f'phase 21 summary: {json.dumps(summary)}')
    return counts, cmp, summary


# ---------------------------------------------------------------- phase 22

# JAX package outputs printed by scripts/pin_orders2d_jax.py (the JAX
# package on the CPU, float64, its per-pair dense path): tp_summary's
# numbers of the manifold kernel (s 0.5, zeroExterior=False) on the surface
# of circle(n=8) refined 3 and 5 times; of each order of VO22_CASES on the
# interval refined 4 times and on its 2D mesh at noRef 2 (with the
# zero-exterior term); and drivers/variableOrder.py's results at noRef 3
# (the square with --do_transpose, the circle, the interval; lu).  Held to
# TOL_VO_PIN (relative; (A x)[:4] and diag(A)[:4] to it of their largest;
# a resNorm to it of ||b||)
JAX_ORDERS2D = {'manifold_64': {'dofs': 64,
                 'max_entry': 0.8826697649586849,
                 'fro': 7.526243722523243,
                 'trace': 56.49086495735572,
                 'Ax_norm': 3.21205388149133,
                 'Ax4': [0.625815096052594,
                         0.5757927076353487,
                         0.5773720133187832,
                         0.7262391673086934],
                 'diag4': [0.8826697649586828,
                           0.8826697649586832,
                           0.882669764958683,
                           0.8826697649586849]},
 'manifold_256': {'dofs': 256,
                  'max_entry': 0.8825503587168261,
                  'fro': 15.046780658492407,
                  'trace': 225.93289183150597,
                  'Ax_norm': 8.47616825092752,
                  'Ax4': [0.5077987187662467,
                          0.5762011327844543,
                          0.38146802903413035,
                          0.3726362128281816],
                  'diag4': [0.8825503587168205,
                            0.8825503587168202,
                            0.88255035871682,
                            0.8825503587168201]},
 'orders_interval': {'leftRight': {'dofs': 15,
                                   'max_entry': 3.525245209287952,
                                   'fro': 10.767348435770643,
                                   'trace': 28.308645095297283,
                                   'Ax_norm': 6.55308425248601,
                                   'Ax4': [0.2722942475480842,
                                           2.5087099573098985,
                                           3.437972623017804,
                                           0.19793168465517214],
                                   'diag4': [0.24926999100648878,
                                             1.8872452880781707,
                                             3.525222318619587,
                                             0.24926119493744503]},
                     'innerOuter': {'dofs': 15,
                                    'max_entry': 3.5368476808813236,
                                    'fro': 10.91662489706755,
                                    'trace': 29.76401610613847,
                                    'Ax_norm': 8.510961197054103,
                                    'Ax4': [0.2922937817429196,
                                            4.046059971018047,
                                            3.4419504992249395,
                                            1.0085467000777901],
                                    'diag4': [0.2753453807425727,
                                              3.5368476808813236,
                                              3.5315313400971338,
                                              1.8340888709099645]},
                     'innerOuter_sio': {'dofs': 15,
                                        'max_entry': 3.5328152214519672,
                                        'fro': 10.936395655034126,
                                        'trace': 29.863757107747492,
                                        'Ax_norm': 8.485416556956814,
                                        'Ax4': [0.29720681435198204,
                                                4.0396810763144355,
                                                3.4339464111169593,
                                                0.7786915359001338],
                                        'diag4': [0.2835785218617372,
                                                  3.5328152214519672,
                                                  3.5251775964521976,
                                                  1.8493501995098187]},
                     'islands': {'dofs': 15,
                                 'max_entry': 2.6201654433785873,
                                 'fro': 6.8644629973145275,
                                 'trace': 19.953247949281344,
                                 'Ax_norm': 4.997779180957,
                                 'Ax4': [3.2502381600417354,
                                         2.1256840598699984,
                                         0.5252808813477867,
                                         0.47913053632262603],
                                 'diag4': [2.6201654433785873,
                                           1.7028139182075384,
                                           0.9226218672456228,
                                           0.5211831259399449]},
                     'islands_sio': {'dofs': 15,
                                     'max_entry': 2.6364986973812923,
                                     'fro': 7.226640109305576,
                                     'trace': 20.086529876621118,
                                     'Ax_norm': 5.226642073895198,
                                     'Ax4': [3.2615128034167404,
                                             2.5101569858402475,
                                             0.718015849878807,
                                             0.3118263838264857],
                                     'diag4': [2.6364986973812923,
                                               2.23730327301138,
                                               0.14072412016031755,
                                               0.3832235428807465]},
                     'layers': {'dofs': 15,
                                'max_entry': 0.5234343192946324,
                                'fro': 1.3809839375069861,
                                'trace': 4.716636060598183,
                                'Ax_norm': 0.8655066496223354,
                                'Ax4': [0.2078320819972459,
                                        0.2703103589623721,
                                        0.28174153520688894,
                                        0.1522278286321003],
                                'diag4': [0.1937873480212961,
                                          0.2106872975604675,
                                          0.23333180107218715,
                                          0.1961874071156271]},
                     'layers_nonsym': {'dofs': 15,
                                       'max_entry': 0.6969245027452653,
                                       'fro': 1.585664748447009,
                                       'trace': 5.129710433776559,
                                       'Ax_norm': 1.3190101372619356,
                                       'Ax4': [0.20783049098259956,
                                               0.2703103510267208,
                                               0.28174108901346206,
                                               0.15222669154715876],
                                       'diag4': [0.19378607849594404,
                                                 0.21068728601190656,
                                                 0.23333149380793655,
                                                 0.19618593445683474]},
                     'smoothedLeftRight': {'dofs': 15,
                                           'max_entry': 3.534271379143807,
                                           'fro': 9.94527952505328,
                                           'trace': 25.677357974419923,
                                           'Ax_norm': 5.385626724633567,
                                           'Ax4': [0.2722942475480842,
                                                   1.2442157750301783,
                                                   1.8429024976983928,
                                                   0.19793168465517214],
                                           'diag4': [0.24926999100648878,
                                                     0.8776908985178558,
                                                     1.9460331747560298,
                                                     0.24926119493744503]},
                     'linearLeftRightNonSym': {'dofs': 15,
                                               'max_entry': 3.5535163199518305,
                                               'fro': 9.62030898648073,
                                               'trace': 24.825626168931848,
                                               'Ax_norm': 5.063556394632448,
                                               'Ax4': [0.2722942475480842,
                                                       1.1988038457914296,
                                                       1.513756677400993,
                                                       0.19793168465517214],
                                               'diag4': [0.24926999100648878,
                                                         0.8794504081850417,
                                                         1.5403977228806334,
                                                         0.24926119493744503]},
                     'innerOuterNonSym': {'dofs': 15,
                                          'max_entry': 1.5175407363094469,
                                          'fro': 4.0315155033059416,
                                          'trace': 12.323997684856412,
                                          'Ax_norm': 2.767807902775087,
                                          'Ax4': [1.8435196070691848,
                                                  0.40092755742976666,
                                                  0.36321501147349133,
                                                  0.5287655489342228],
                                          'diag4': [1.5149213112921345,
                                                    0.31745426799691046,
                                                    0.3174531717282112,
                                                    0.6784614835136906]},
                     'fe': {'dofs': 15,
                            'max_entry': 1.513510827373752,
                            'fro': 3.6208251983788142,
                            'trace': 11.69851097659489,
                            'Ax_norm': 2.2596669542964674,
                            'Ax4': [0.31319682329021975,
                                    0.8767559459354018,
                                    0.8492833308248885,
                                    0.351687605470936],
                            'diag4': [0.2837473805064576,
                                      0.6780638151197189,
                                      0.7729154824008851,
                                      0.4066412372580074]}},
 'orders_2d': {'leftRight': {'dofs': 9,
                             'max_entry': 1.4445448920299806,
                             'fro': 3.052545258798117,
                             'trace': 7.66014687018636,
                             'Ax_norm': 2.311743867253763,
                             'Ax4': [0.26903113292522685,
                                     1.4849412226397534,
                                     1.1013052900607712,
                                     0.17630621515952713],
                             'diag4': [0.2575910921058829,
                                       1.4441195862859115,
                                       1.4442743955933965,
                                       0.8514836736641915]},
               'innerOuter': {'dofs': 49,
                              'max_entry': 0.8876790139925637,
                              'fro': 3.3354425276719533,
                              'trace': 16.82247466774525,
                              'Ax_norm': 1.5490347815844152,
                              'Ax4': [0.7668678319313625,
                                      0.5952899492970668,
                                      0.17137605724514168,
                                      0.07611206404955617],
                              'diag4': [0.8876790139925637,
                                        0.8773284047819686,
                                        0.8773284047819683,
                                        0.8773284047819683]},
               'innerOuter_sio': {'dofs': 49,
                                  'max_entry': 0.8810045849503282,
                                  'fro': 3.3639168796833285,
                                  'trace': 17.08525674469301,
                                  'Ax_norm': 1.5464073991542104,
                                  'Ax4': [0.759810245525305,
                                          0.5861766476017277,
                                          0.16186556113733538,
                                          0.06906828227385794],
                                  'diag4': [0.8810045849503282,
                                            0.8692284591602963,
                                            0.8692284591602961,
                                            0.869228459160296]},
               'islands': {'dofs': 9,
                           'max_entry': 0.9537951158745721,
                           'fro': 2.4967386276611987,
                           'trace': 7.25419527019659,
                           'Ax_norm': 1.8080763407433116,
                           'Ax4': [0.9144358867363824,
                                   0.935718909221126,
                                   0.7409332545649763,
                                   0.28998900692534646],
                           'diag4': [0.9381511993303427,
                                     0.9381511993303427,
                                     0.9537951158745721,
                                     0.7632593915204854]},
               'islands_sio': {'dofs': 9,
                               'max_entry': 0.9320786096730941,
                               'fro': 2.4417581152359737,
                               'trace': 7.101187329459733,
                               'Ax_norm': 1.7501097748012728,
                               'Ax4': [0.8698184041686601,
                                       0.890078817712726,
                                       0.7209987781073439,
                                       0.2726430487111305],
                               'diag4': [0.8958189902667388,
                                         0.8958189902667388,
                                         0.9320786096730941,
                                         0.7532649130965416]},
               'layers': {'dofs': 9,
                          'max_entry': 0.3825829792285259,
                          'fro': 0.8908829059815772,
                          'trace': 2.5787785551907803,
                          'Ax_norm': 0.6142896119966575,
                          'Ax4': [0.23674452493551656,
                                  0.37100994062127,
                                  0.1707584833010822,
                                  0.15291770551385067],
                          'diag4': [0.22283641777745622,
                                    0.3825829792285259,
                                    0.22278946572853175,
                                    0.22306517363943135]},
               'layers_nonsym': {'dofs': 9,
                                 'max_entry': 0.5075638476530754,
                                 'fro': 1.0574742629631582,
                                 'trace': 2.8238068631125355,
                                 'Ax_norm': 0.7565742989552768,
                                 'Ax4': [0.2366949209645227,
                                         0.5149261373102575,
                                         0.1707691617675089,
                                         0.15297373897306593],
                                 'diag4': [0.22279368972216684,
                                           0.5033102277040536,
                                           0.22280324805289864,
                                           0.22309164819704394]},
               'smoothedLeftRight': {'dofs': 9,
                                     'max_entry': 1.453672935049191,
                                     'fro': 2.94587054002781,
                                     'trace': 7.262401112686117,
                                     'Ax_norm': 2.2873389906719455,
                                     'Ax4': [0.27382544865805086,
                                             1.4720513460682259,
                                             1.087244066165974,
                                             0.1801881417556532],
                                     'diag4': [0.255172359934451,
                                               1.4532406777027518,
                                               1.4525184801925743,
                                               0.7135808288420052]},
               'linearLeftRightNonSym': {'dofs': 9,
                                         'max_entry': 1.4373560349764203,
                                         'fro': 2.876710290806856,
                                         'trace': 7.070713009244347,
                                         'Ax_norm': 2.2447311556086826,
                                         'Ax4': [0.27882342528044496,
                                                 1.4395129032629699,
                                                 1.0743960746186914,
                                                 0.18142179697996635],
                                         'diag4': [0.25571908177550623,
                                                   1.436875520118845,
                                                   1.4362165712434796,
                                                   0.6650255947312075]},
               'innerOuterNonSym': {'dofs': 49,
                                    'max_entry': 0.42171454147597437,
                                    'fro': 2.2813870311747735,
                                    'trace': 14.251886670168126,
                                    'Ax_norm': 1.6664722405629808,
                                    'Ax4': [0.10523801998774536,
                                            0.0962809389209313,
                                            0.08816137937598417,
                                            0.0632212612384892],
                                    'diag4': [0.10600528702592593,
                                              0.09407347221539955,
                                              0.09407347221539955,
                                              0.09407347221539954]},
               'fe': {'dofs': 9,
                      'max_entry': 0.5393270457514378,
                      'fro': 1.3392952980807418,
                      'trace': 3.9370444696297975,
                      'Ax_norm': 0.8860597806815661,
                      'Ax4': [0.3768514546911431,
                              0.48542480066561344,
                              0.32704982415333994,
                              0.1983873050627201],
                      'diag4': [0.36551393622049194,
                                0.4949593240201704,
                                0.4504210549954538,
                                0.44790046639377323]}},
 'driver': {'square': {'dense twoDomain(0.25,0.75) resNorm': 5.043482897809253e-16,
                       'dense twoDomain(0.25,0.75) norm': 4.384200351598995,
                       'dense twoDomain(0.25,0.75) transpose norm': 5.1081161514078985},
            'circle': {'dense innerOuter(0.75,0.25,r=0.5) resNorm': 1.458551743605117e-15,
                       'dense innerOuter(0.75,0.25,r=0.5) norm': 10.902629006072926},
            'interval': {'dense const(0.25) resNorm': 1.5700924586837752e-16,
                         'dense const(0.25) norm': 2.760245523340339,
                         'dense const(0.75) resNorm': 2.9373740229761033e-16,
                         'dense const(0.75) norm': 1.6165021072014385,
                         'dense varconst(0.25) resNorm': 1.5700924586837752e-16,
                         'dense varconst(0.25) norm': 2.760245523340339,
                         'dense varconst(0.75) resNorm': 2.9373740229761033e-16,
                         'dense varconst(0.75) norm': 1.6165021072014385,
                         'dense twoDomain(0.25,0.75,0.25,0.25) resNorm': 6.010860650248393e-16,
                         'dense twoDomain(0.25,0.75,0.25,0.25) norm': 2.0768966714902195,
                         'dense twoDomain(0.25,0.75,0.5,0.5) resNorm': 3.7238012298709097e-16,
                         'dense twoDomain(0.25,0.75,0.5,0.5) norm': 2.216004451754438,
                         'dense twoDomain(0.25,0.75,0.75,0.75) resNorm': 4.791355229691893e-16,
                         'dense twoDomain(0.25,0.75,0.75,0.75) norm': 2.42865222955214}}}
TOL_VO_PIN = 1e-10
VO22_PIN_NOREF = 3
VO22_SPHERE_CELLS = 8192   # the manifold kernel at full width (8,192 dofs)
VO22_GRID_CHECK_CELLS = 1024   # the manifold's grid against its per-pair path
# the driver's lines whose K1 and K19 calls are compared at full width
VO22_RECORDED = ('circle_lu', 'square_lu')
TOL_VO_GRID = 1e-12
# name -> (the port's factory entry, its arguments ('dim' for the
# dimension), keywords, the 2D mesh); fe is the P1 interpolant of
# vo_fe_order (scripts/pin_orders2d_jax.py ORDER_CASES)
VO22_CASES = {
    'leftRight': ('twoDomainNonSym', (0.25, 0.75), {}, 'square'),
    'innerOuter': ('innerOuter', ('dim', 0.75, 0.25, 0.5), {}, 'disc'),
    'innerOuter_sio': ('innerOuter', ('dim', 0.75, 0.25, 0.5),
                       {'sio': 0.4, 'soi': 0.6}, 'disc'),
    'islands': ('islands', (0.3, 0.7), {'r': 0.1, 'r2': 0.6}, 'square'),
    'islands_sio': ('islands', (0.3, 0.7), {'r': 0.1, 'r2': 0.6,
                                            'sio': 0.4, 'soi': 0.6},
                    'square'),
    'layers': ('layers', ('dim', [-1.0, 0.25, 1.0], [[0.2, 0.3],
                                                      [0.3, 0.4]]), {},
               'square'),
    'layers_nonsym': ('layers', ('dim', [-1.0, 0.25, 1.0], [[0.2, 0.3],
                                                             [0.6, 0.4]]),
                      {}, 'square'),
    'smoothedLeftRight': ('smoothedLeftRight', (0.25, 0.75), {'r': 0.3},
                          'square'),
    'linearLeftRightNonSym': ('linearLeftRightNonSym', (0.25, 0.75),
                              {'r': 0.3}, 'square'),
    'innerOuterNonSym': ('innerOuterNonSym', (0.3, 0.6),
                         {'r': 0.2, 'radius': 0.5}, 'disc'),
    'fe': ('fe', (), {}, 'square'),
}
# the driver at its defaults: (label, argv)
VO22_FULL_LINES = (
    ('circle_lu', ['--domain', 'circle', '--solver', 'lu']),
    ('circle_cg', ['--domain', 'circle', '--solver', 'cg']),
    ('square_lu', ['--domain', 'square', '--solver', 'lu',
                   '--do_transpose']),
    ('square_gmres', ['--domain', 'square', '--solver', 'gmres',
                      '--do_transpose']),
    ('interval_lu', ['--domain', 'interval', '--solver', 'lu']))
ORDER22_VARIANTS = ('inner_outer', 'islands', 'layers', 'smoothed_left_right',
                    'linear_left_right', 'smoothed_inner_outer', 'fe')
VO22_PIN_PATH = ('panel_scatter', 'panel_scatter:dense',
                 'panel_scatter_nonsym', 'panel_scatter_nonsym:dense',
                 'panel_scatter:manifold') + tuple(
    f'{k}:{v}' for k in ('panel_scatter', 'panel_scatter_nonsym')
    for v in ORDER22_VARIANTS)
VO22_FULL_PATH = ('panel_scatter', 'panel_scatter:dense',
                  'panel_scatter:inner_outer', 'panel_scatter_nonsym',
                  'panel_scatter_nonsym:dense', 'grid_distant',
                  'grid_boundary', 'pcg_update', 'gmres_arnoldi')
VO22_MANIFOLD_PATH = ('panel_scatter', 'panel_scatter:dense',
                      'panel_scatter:manifold', 'grid_distant',
                      'grid_distant:manifold')
ORDERS22_REPLACES = {
    'panel_scatter': 'pynucleus_tpu/nl/assembly.py:91 _bucket_contrib + '
                     ':956 dense scatter with FractionalKernel.evalXY '
                     '(nl/kernels.py:1290-1330) of the order (nl/kernels.py'
                     ':206-475 jaxEval)',
    'panel_scatter_nonsym': 'pynucleus_tpu/nl/assembly.py:424 '
                            '_bucket_contrib_nonsym with FractionalKernel'
                            '.evalXY of the order (nl/kernels.py:206-475 '
                            'jaxEval)',
}
# the sources of the orders of position's instances
ORDERS22_SOURCES = {
    'panel_scatter': 'pynucleus_tpu_torch/kernels/csrc/panel_scatter_order.cu',
    'panel_scatter_nonsym':
        'pynucleus_tpu_torch/kernels/csrc/panel_scatter_nonsym_order.cu'}
MANIFOLD22_REPLACES = {
    'panel_scatter:manifold': 'pynucleus_tpu/nl/assembly.py:91 '
                              '_bucket_contrib with the MANIFOLD_FRACTIONAL '
                              'kernel (nl/kernels.py:1252-1284): 1D rules '
                              'on 2D vertices',
    'grid_distant:manifold': 'pynucleus_tpu/nl/assembly.py:131 '
                             '_grid_distant_pass on a 1-manifold in R^2',
}


def vo_fe_order(x):
    return 0.45 + 0.2 * x[0]


def vo_mesh(domain, noRef):
    from pynucleus_tpu_torch.fem.meshes import (simpleInterval, circle,
                                                uniformSquare)
    m = {'interval': lambda: simpleInterval(-1.0, 1.0),
         'square': lambda: uniformSquare(N=2, ax=-1.0, ay=-1.0, bx=1.0,
                                         by=1.0),
         'disc': lambda: circle(n=8)}[domain]()
    return tp_refined(m, noRef)


def vo_order(name, dm):
    """The port's order of a VO22_CASES case on the dofmap dm."""
    from pynucleus_tpu_torch.fem.functions import Lambda
    from pynucleus_tpu_torch.nl import kernels as tk
    entry, args, kw, _ = VO22_CASES[name]
    if entry == 'fe':
        return tk.feFractionalOrder(dm.interpolate(Lambda(vo_fe_order)))
    args = [dm.mesh.dim if a == 'dim' else a for a in args]
    return tk.fractionalOrderFactory[entry](*args, **kw)


def vo_driver(argv, params=None):
    """drivers/variableOrder.py on the card: its results and timers."""
    from pynucleus_tpu_torch.drivers import variableOrder
    out = variableOrder.main(argv + ['--device', 'cuda'], quiet=True,
                             params=params)
    import torch
    b = torch.linalg.norm(variableOrder.assembleRHS(
        out['dm'], variableOrder.constant(1.0)).data)
    return out, float(b)


def vo_check_driver(label, results, ref, bnorm):
    """A driver's results against the JAX driver's pinned ones: the same
    labels, norms to TOL_VO_PIN relative, resNorms to TOL_VO_PIN ||b||."""
    if sorted(results) != sorted(ref):
        raise AssertionError(f'{label}: labels {sorted(results)} vs '
                             f'{sorted(ref)}')
    worst = 0.0
    for k, want in ref.items():
        scale = bnorm if k.endswith('resNorm') else abs(want)
        worst = max(worst, abs(results[k] - want) / scale)
    if not worst <= TOL_VO_PIN:
        raise AssertionError(f'{label}: {results} vs the JAX driver {ref}')
    log(f'  the driver, {label} at noRef {VO22_PIN_NOREF}: {len(ref)} '
        f'results within {worst:.2e} of the JAX driver')
    return worst


def vo_pin_lines():
    """The pins of scripts/pin_orders2d_jax.py on the card, per pair: the
    manifold kernel at 64 and 256 dofs, each order on the interval and on
    its 2D mesh, the driver at noRef 3."""
    from pynucleus_tpu_torch.fem.meshes import circle
    from pynucleus_tpu_torch.nl import kernels as tk
    perPair = {'denseGrid': False}
    worst = 0.0
    for noRef in (3, 5):
        surf = tp_refined(circle(n=8), noRef).get_surface_mesh()
        dm = tp_dm(surf)
        got = tp_summary(tp_dense(dm, tk.getFractionalKernel(
            2, 0.5, manifold=True), False, perPair))
        key = f'manifold_{dm.num_dofs}'
        worst = max(worst, check_tp_pin(key, got, JAX_ORDERS2D[key],
                                        TOL_VO_PIN))
    for key, domain, noRef in (('orders_interval', 'interval', 4),
                               ('orders_2d', None, 2)):
        for name, (*_, mesh2d) in VO22_CASES.items():
            dm = tp_dm(vo_mesh(domain or mesh2d, noRef))
            got = tp_summary(tp_dense(dm, tk.getFractionalKernel(
                dm.mesh.dim, vo_order(name, dm)), params=perPair))
            worst = max(worst, check_tp_pin(f'{key} {name}', got,
                                            JAX_ORDERS2D[key][name],
                                            TOL_VO_PIN))
    for domain, extra in (('square', ['--do_transpose']), ('circle', []),
                          ('interval', [])):
        out, bnorm = vo_driver(['--domain', domain, '--noRef',
                                str(VO22_PIN_NOREF), '--solver', 'lu']
                               + extra, perPair)
        worst = max(worst, vo_check_driver(
            domain, out['results'].toDict(), JAX_ORDERS2D['driver'][domain],
            bnorm))
    return {'worst': worst}


def vo_full_lines(recorders=()):
    """drivers/variableOrder.py at its defaults on the card (a path): the
    circle at noRef 5 (innerOuter through K1; lu and cg), the square at
    noRef 5 (leftRight through K19; lu and gmres, with the transpose), the
    interval at noRef 8 (its seven orders, lu).  Each solve's residual
    below the driver's tolerance times ||b|| (lu: rounding) and its norms
    finite.  The OrderRecorders ``recorders`` record the lines of
    VO22_RECORDED alone (the other line of a domain assembles the same
    operator)."""
    lines = {}
    for label, argv in VO22_FULL_LINES:
        for rec in recorders:
            rec.active = label in VO22_RECORDED
        out, bnorm = vo_driver(argv)
        res, tim = out['results'].toDict(), out['timers'].toDict()
        for k, v in res.items():
            if not math.isfinite(v) or (k.endswith('resNorm')
                                        and not v <= 1e-6 * bnorm):
                raise AssertionError(f'the driver, {label}: {k} = {v}')
        lines[label] = {'dofs': out['info'].toDict()['dofs'], **res,
                        **{k: v for k, v in tim.items()}}
        log(f"  the driver, {label}: {lines[label]['dofs']} dofs, "
            + ', '.join(f'{k} {v:.4g}' for k, v in tim.items()))
    for rec in recorders:
        rec.active = False
    return lines


def vo_manifold_lines():
    """The manifold kernel at full width on the card (a path):
    sphere1(VO22_SPHERE_CELLS) on the default grid, symmetric, the
    constants in its null space and its diagonal positive, each to
    TOL_KERNEL of the largest entry; the peak device memory from the
    build on."""
    import torch
    from pynucleus_tpu_torch.fem.meshes import sphere1
    from pynucleus_tpu_torch.nl import kernels as tk
    k = tk.getFractionalKernel(2, 0.5, manifold=True)
    dm = tp_dm(sphere1(VO22_SPHERE_CELLS))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    A = tp_dense(dm, k, zeroExterior=False)
    torch.cuda.synchronize()
    line = {'dofs': dm.num_dofs, 'assembly_s': time.perf_counter() - t0}
    scale = float(A.abs().max())
    line['symmetry'] = float((A - A.T).abs().max()) / scale
    one = torch.ones(dm.num_dofs, dtype=torch.float64, device=A.device)
    line['constant'] = float(torch.linalg.norm(A @ one)) / scale
    line['min_diagonal'] = float(torch.diagonal(A).min())
    line['peak_GiB'] = torch.cuda.max_memory_allocated() / 2**30
    del A
    torch.cuda.empty_cache()
    if not (line['symmetry'] <= TOL_KERNEL and line['constant'] <= TOL_KERNEL
            and line['min_diagonal'] > 0):
        raise AssertionError(f'the manifold kernel on sphere1: {line}')
    log(f"  the manifold kernel on sphere1({VO22_SPHERE_CELLS}): "
        f"{dm.num_dofs} dofs in {line['assembly_s']:.3f} s, symmetric to "
        f"{line['symmetry']:.2e}, A 1 {line['constant']:.2e} of max|A|, "
        f"min diag {line['min_diagonal']:.4g}")
    return line


def vo_manifold_grid_check():
    """The manifold kernel on sphere1(VO22_GRID_CHECK_CELLS): its default
    grid against its per-pair path, to TOL_VO_GRID of the largest entry
    (a check, not a main path).  Returns the relative difference."""
    from pynucleus_tpu_torch.fem.meshes import sphere1
    from pynucleus_tpu_torch.nl import kernels as tk
    k = tk.getFractionalKernel(2, 0.5, manifold=True)
    dm = tp_dm(sphere1(VO22_GRID_CHECK_CELLS))
    G = tp_dense(dm, k, zeroExterior=False)
    P = tp_dense(dm, k, zeroExterior=False, params={'denseGrid': False})
    rel = float((G - P).abs().max() / P.abs().max())
    if not rel <= TOL_VO_GRID:
        raise AssertionError(f'the manifold grid vs per pair: {rel}')
    log(f'  the manifold kernel, grid vs per pair at {dm.num_dofs} dofs: '
        f'{rel:.2e}')
    return rel


def _order_code(args, kw):
    """The order code of a K1 or K19 call (None for no order; 'manifold'
    for the calls of simplices of a lower dimension than their vertices'
    space)."""
    from pynucleus_tpu_torch.nl.kernels import OrderParams
    order = next((a for a in list(args) + list(kw.values())
                  if isinstance(a, OrderParams)), None)
    if order is not None:
        return int(order.code)
    vertices, vi1, vi2 = args[1], args[2], args[3]
    if vi1.shape[1] == vi2.shape[1] and vi1.shape[1] <= vertices.shape[1]:
        return 'manifold'
    return None


def _k1_route(args, kw):
    """K1's route of a call: 'natural' (pairs gathered from cell ids),
    'rows' (with normals: the 2D zero-exterior rows), else 'pairs'."""
    return 'natural' if kw.get('natural') else \
        'rows' if args[6] is not None else 'pairs'


class OrderRecorder(ArgRecorder):
    """An ArgRecorder (the target recorded by its shape) that keeps the
    calls of each ``key(args, kw)`` apart (by default the order code,
    _order_code).  With ``distantLargest``, of the buckets of distant pairs
    (the first pair shares no vertex) only the largest of each key and shape
    (simplex sizes, nPSI) is kept, every other bucket (identical cells,
    touching pairs) is.  Nothing is recorded while ``active`` is False."""

    def __init__(self, module, name, distantLargest=False, key=_order_code):
        super().__init__(module, name, dataFirst=True)
        self.distantLargest = distantLargest
        self.key = key
        self.active = True
        self.byCode = {}
        self.distant = {}

    def __enter__(self):
        def rec(*args, **kw):
            if self.active:
                self._keep(args, kw)
            return self.orig(*args, **kw)
        setattr(self.module, self.name, rec)
        return self

    def _keep(self, args, kw):
        code = self.key(args, kw)
        vi1, vi2, index = args[2], args[3], args[4]
        P = vi1.shape[0]
        if self.distantLargest and P and not bool(
                (vi1[0][:, None] == vi2[0][None, :]).any()):
            key = (code, vi1.shape[1], vi2.shape[1], index.shape[1])
            if P > self.distant.get(key, (0, None))[0]:
                self.distant[key] = (P, self._record(args, kw))
            return
        self.byCode.setdefault(code, []).append(self._record(args, kw))

    def codes(self):
        return set(self.byCode) | {k[0] for k in self.distant}

    def callsOf(self, *codes):
        """The kept calls of ``codes`` (of every key without one): the near
        buckets, then the largest distant ones."""
        codes = codes or self.codes()
        return [c for code in codes for c in self.byCode.get(code, [])] + [
            c for k, (_, c) in self.distant.items() if k[0] in codes]


def grid_manifold_calls(rec):
    """The recorded K2 calls of a 1-manifold in R^2 (a P1 rule of dpe <=
    dim)."""
    return [c for c in rec.calls if c[0][4].shape[1] <= c[0][1].shape[2]]


def phase22():
    """The manifold fractional kernel and the variable orders of position:
    the pins of scripts/pin_orders2d_jax.py (a path), the variableOrder
    driver at its defaults (a path), the manifold kernel at full width on
    sphere1 (a path), the manifold's grid against its per-pair path; then
    each new variant of K1 and K19 (the orders of position, K1 and K2 on
    the manifold) against its plain version, at the pins' calls and at the
    full-width paths' calls (the driver's circle and square, sphere1).
    Returns (launch counts per path, comparisons, the comparisons at full
    width of the variants and of the base kernels, summary)."""
    import contextlib
    import pynucleus_tpu_torch.nl.assembly as asm
    from pynucleus_tpu_torch.nl.kernels import ORDER_VARIANTS
    log('phase 22: the manifold kernel and the variable orders in 1D and '
        '2D')
    t0 = time.perf_counter()
    counts, summary = {}, {}
    with contextlib.ExitStack() as stack:
        k1 = stack.enter_context(OrderRecorder(asm, 'panel_scatter'))
        k19 = stack.enter_context(OrderRecorder(asm, 'panel_scatter_nonsym'))
        summary['pins'], counts['pins'] = count_path(
            'orders and manifold pins', VO22_PIN_PATH, vo_pin_lines)
    with contextlib.ExitStack() as stack:
        k1f = stack.enter_context(OrderRecorder(asm, 'panel_scatter',
                                                distantLargest=True))
        k19f = stack.enter_context(OrderRecorder(
            asm, 'panel_scatter_nonsym', distantLargest=True))
        summary['full'], counts['full'] = count_path(
            'the variableOrder driver at its defaults', VO22_FULL_PATH,
            lambda: vo_full_lines((k1f, k19f)))
    with contextlib.ExitStack() as stack:
        k1m = stack.enter_context(OrderRecorder(asm, 'panel_scatter'))
        k2m = stack.enter_context(ArgRecorder(asm, 'grid_distant',
                                              dataFirst=True))
        summary['manifold'], counts['manifold'] = count_path(
            'the manifold kernel on sphere1', VO22_MANIFOLD_PATH,
            vo_manifold_lines)
    summary['manifold']['grid_vs_per_pair'] = vo_manifold_grid_check()

    log('  the variants against their plain versions')
    cmp = {}
    for code, name in ORDER_VARIANTS.items():
        cmp['panel_scatter:' + name] = compare_target_kernel(
            f'panel_scatter ({name}, dense)', k1.callsOf(code),
            asm.panel_scatter, asm._panel_scatter_plain, panel_order_work)
        cmp['panel_scatter_nonsym:' + name] = compare_target_kernel(
            f'panel_scatter_nonsym ({name}, dense)', k19.callsOf(code),
            asm.panel_scatter_nonsym, _k19_plain('dense'), nonsym_work)
    cmp['panel_scatter:manifold'] = compare_target_kernel(
        f'panel_scatter (manifold, dense, sphere1({VO22_SPHERE_CELLS}))',
        k1m.callsOf('manifold'), asm.panel_scatter,
        asm._panel_scatter_plain, panel_work)
    cmp['grid_distant:manifold'] = compare_target_kernel(
        f'grid_distant (manifold, sphere1({VO22_SPHERE_CELLS}))',
        grid_manifold_calls(k2m), asm.grid_distant, asm._grid_distant_plain,
        grid_distant_work)
    # the driver's circle and square at noRef 5: each order code that K1
    # and K19 ran there, an order of position in its variant's row, the
    # others (leftRight on triangles) in the kernel's own
    full = {}
    for rec, name, kernel, plain, work in (
            (k1f, 'panel_scatter', asm.panel_scatter,
             asm._panel_scatter_plain, panel_order_work),
            (k19f, 'panel_scatter_nonsym', asm.panel_scatter_nonsym,
             _k19_plain('dense'), nonsym_work)):
        for code in sorted(c for c in rec.codes() if c is not None):
            key = f'{name}:{ORDER_VARIANTS[code]}' \
                if code in ORDER_VARIANTS else name
            if key in full:
                raise AssertionError(f'{key}: two order codes at full width')
            full[key] = compare_target_kernel(
                f'{name} (order code {code}, dense, the driver at noRef 5)',
                rec.callsOf(code), kernel, plain, work)
    if set(full) != set(VO22_FULL_COMPARED):
        raise AssertionError(f'the full-width comparisons {sorted(full)} '
                             f'vs {sorted(VO22_FULL_COMPARED)}')
    summary['seconds'] = time.perf_counter() - t0
    log(f'phase 22 summary: {json.dumps(summary)}')
    return counts, cmp, full, summary


def ORDERS22_PATHS(counts22):
    """The main paths of phase 22: (kernels, label, launch counts)."""
    return ((VO22_PIN_PATH, 'orders_and_manifold_pins', counts22['pins']),
            (VO22_FULL_PATH, 'variable_order_driver_defaults',
             counts22['full']),
            (VO22_MANIFOLD_PATH,
             f'manifold_sphere1_{VO22_SPHERE_CELLS}', counts22['manifold']))


def ORDERS22_COMPARED_AT():
    """Where each variant of phase 22 was compared."""
    out = {f'{k}:{v}': 'the pins of scripts/pin_orders2d_jax.py (the '
           'interval refined 4 times, the square and the disc at noRef 2, '
           f'the driver at noRef {VO22_PIN_NOREF}), all dense calls'
           for k in ('panel_scatter', 'panel_scatter_nonsym')
           for v in ORDER22_VARIANTS}
    out['panel_scatter:manifold'] = (
        f'sphere1({VO22_SPHERE_CELLS}) on the grid (the main path), all '
        'calls')
    out['grid_distant:manifold'] = (
        f'sphere1({VO22_SPHERE_CELLS}) on the grid (the main path), all '
        'calls')
    return out


# the rows compared at the calls of the driver's full-width lines (K1 with
# innerOuter on the circle, K19 with leftRight on the square's triangles
# and K1 with it in the square's zero-exterior term), and where
VO22_FULL_AT = ('the driver at its defaults, {}: every identical-cell, '
                'touching and zero-exterior bucket and the largest distant '
                'bucket of each shape')
VO22_FULL_COMPARED = {
    'panel_scatter:inner_outer': VO22_FULL_AT.format(
        'the circle at noRef 5 (3,969 dofs)'),
    'panel_scatter_nonsym': VO22_FULL_AT.format(
        'the square at noRef 5 (961 dofs), leftRight on triangles'),
    'panel_scatter': VO22_FULL_AT.format(
        'the square at noRef 5 (961 dofs), the zero-exterior term of '
        'leftRight on triangles (with normals)')}


# ---------------------------------------------------------------- phase 23

# bench.py's benchAssembly (bench.py:123-158) and the CG-Jacobi solve of
# bench.py:253-273: (-Delta)^0.75 u = 1 on circle(n=8) refined F32_NOREF
# times (32,768 cells, 16,129 dofs, 536,887,296 cell pairs), P1, infinite
# horizon, zero exterior, getDense on the grid in float32 (the JAX
# package's dtype off the CPU, bench.py:58-64) and, beside it, in float64
F32_NOREF = 6
F32_S = 0.75
F32_CG_TOL = 1e-6
F32_CG_MAXITER = 500
TOL_F32 = 1e-5            # each float32 instance against its plain version
TOL_F32_VS_F64 = 1e-3     # the float32 solution against the float64 one
F32_INTERVAL_NOREF = 6    # tests/test_f32_path.py's interval (63 dofs)
F32_BAR_FLOOR = 5e-4      # tests/test_f32_path.py:44: e32 < max(2 e64, 5e-4)
K123 = ('panel_scatter', 'grid_distant', 'grid_boundary')
F32_PATH = ('panel_scatter', 'panel_scatter:dense', 'panel_scatter:float32',
            'panel_scatter:float32_natural', 'panel_scatter:float32_rows',
            'grid_distant', 'grid_distant:float32', 'grid_boundary',
            'grid_boundary:float32', 'pcg_update', 'pcg_update:jacobi',
            'pcg_update:float32')
F32_INTERVAL_PATH = ('panel_scatter', 'panel_scatter:float32',
                     'panel_scatter:float32_natural', 'grid_distant:float32',
                     'grid_boundary:float32', 'pcg_update',
                     'pcg_update:float32')
FLOAT32_REPLACES = {
    'panel_scatter:float32': 'pynucleus_tpu/nl/assembly.py:91',
    'panel_scatter:float32_natural': 'pynucleus_tpu/nl/assembly.py:352',
    'panel_scatter:float32_rows': 'pynucleus_tpu/nl/assembly.py:315',
    'grid_distant:float32': 'pynucleus_tpu/nl/assembly.py:131',
    'grid_boundary:float32': 'pynucleus_tpu/nl/assembly.py:240',
    'pcg_update:float32': 'pynucleus_tpu/base/solvers.py:297'}
F32_SOURCES = {
    'panel_scatter': 'pynucleus_tpu_torch/kernels/csrc/panel_scatter_f32.cu'}
_F32_AT = (f'the float32 disc (circle(n=8) refined {F32_NOREF} times, 16,129 '
           'dofs, dense on the grid)')
F32_COMPARED_AT = {
    'panel_scatter:float32': _F32_AT + ': every identical-cell, touching '
    'and zero-exterior bucket and the largest distant bucket of each route '
    'and shape',
    'panel_scatter:float32_natural': _F32_AT + ': its natural-order calls '
    'among those (identical cells, distant corrections)',
    'panel_scatter:float32_rows': _F32_AT + ': its calls with normals '
    'among those (the zero-exterior rows)',
    'grid_distant:float32': _F32_AT + ': all calls',
    'grid_boundary:float32': _F32_AT + ': its one call',
    'pcg_update:float32': _F32_AT + ': 10 iterations of the Jacobi form on '
    'its operator, device time (CUDA events around calls queued behind a '
    'spin of the card; around the calls on an idle card: event_ms)'}


class EventTimer:
    """Wraps kernel wrappers of a module with CUDA events around each call:
    the device milliseconds of each wrapper, summed over its calls (a
    kernel's share of an assembly)."""

    def __init__(self, module, names):
        self.module, self.names = module, names
        self.events = {n: [] for n in names}

    def __enter__(self):
        import torch
        self.orig = {n: getattr(self.module, n) for n in self.names}

        def wrap(n):
            def timedCall(*a, **k):
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                out = self.orig[n](*a, **k)
                e.record()
                self.events[n].append((s, e))
                return out
            return timedCall
        for n in self.names:
            setattr(self.module, n, wrap(n))
        return self

    def __exit__(self, *exc):
        for n in self.names:
            setattr(self.module, n, self.orig[n])

    def ms(self):
        import torch
        torch.cuda.synchronize()
        return {n: sum(s.elapsed_time(e) for s, e in ev)
                for n, ev in self.events.items()}


class NaturalRecorder(ArgRecorder):
    """Records the largest natural-order bucket of a dense build
    (_BucketRunner.runNatural on a dense target, no entry mask or weights)
    as a call of the one-chunk entry panel_scatter_natural (the target
    recorded by its shape)."""

    def __init__(self):
        import pynucleus_tpu_torch.nl.assembly as asm
        super().__init__(asm._BucketRunner, 'runNatural', dataFirst=True)

    def __enter__(self):
        from pynucleus_tpu_torch.nl.assembly import TINDEX

        def rec(runner, acc, rule, PSI, di, dj, symfac, entryMask=None,
                weights=None):
            if entryMask is None and weights is None \
                    and len(di) > self.largest:
                self.largest = len(di)
                self.calls = [self._record(
                    (acc.A, runner.vertices, runner.cells, runner.dofs,
                     runner.vols, runner._t(di, TINDEX),
                     runner._t(dj, TINDEX), float(symfac),
                     *runner.ruleTables(rule, PSI),
                     runner.kernel.profileParams()), {})]
            return self.orig(runner, acc, rule, PSI, di, dj, symfac,
                             entryMask, weights)
        setattr(self.module, self.name, rec)
        return self


def natural_work(args, entryBytes=16, peak=F64_PEAK):
    """The natural-order entry on recorded args (the target's shape,
    vertices, cells, dofs, vols, di, dj, symfac, bary_x, bary_y, w, PSIP,
    profile): K1's work on the gathered pairs (panel_work), the gather's
    cell, dof and volume rows read once in place of the whole arrays."""
    import pynucleus_tpu_torch.nl.assembly as asm
    shape, vertices, cells, dofs, vols, di, dj, symfac = args[:8]
    vi1, vi2, dr, vs = asm._naturalPairs(cells, dofs, vols, di, dj, symfac,
                                         asm._nPSI(args[11]))
    return panel_work((shape, vertices, vi1, vi2, dr, vs, None, *args[8:]),
                      entryBytes, peak)


def as_float64(args, keep=()):
    """Recorded args of a float32 call in float64: each float32 tensor
    cast (in a dict of rules too), except at the positions ``keep`` (the
    float32 centres of K2, K5, K11 and K12)."""
    import torch

    def cast(a):
        if isinstance(a, torch.Tensor) and a.dtype == torch.float32:
            return a.double()
        if isinstance(a, dict):
            return {k: tuple(cast(t) for t in v) for k, v in a.items()}
        return a
    return tuple(a if i in keep else cast(a) for i, a in enumerate(args))


def float64_ms(calls, kernel, keep=()):
    """The kernel's milliseconds on the recorded float32 calls cast to
    float64 (the same calls in float64), after an untimed warm-up call."""
    import torch
    dev = next(a.device for a in calls[0][0] if isinstance(a, torch.Tensor))
    casts = [((shape,) + as_float64(args, keep), kw)
             for (shape, *args), kw in calls]
    (shape0, *args0), kw0 = casts[0]
    kernel(torch.zeros(shape0, dtype=torch.float64, device=dev), *args0,
           **kw0)
    ms = 0.0
    for (shape, *args), kw in casts:
        D = torch.zeros(shape, dtype=torch.float64, device=dev)
        ms += timed(lambda: kernel(D, *args, **kw))
    return ms


def f32_tf32_off():
    """float32 means float32: no TF32 in the card's matrix products."""
    import torch
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise AssertionError('TF32 allowed in a float32 solve')


def f32_interval_error(dtype, grid):
    """tests/test_f32_path.py's _solve on the card: the interval at noRef
    6, getDense in ``dtype`` (on the grid or per pair), CG to 1e-6 (500
    iterations at most); the max error against (-Delta)^0.75 u = 1's
    analytic solution, and the iterations."""
    import numpy as np
    import torch
    from scipy.special import gamma
    from pynucleus_tpu_torch.fem.meshes import simpleInterval
    from pynucleus_tpu_torch.fem.assembly import assembleRHS
    from pynucleus_tpu_torch.fem.functions import constant
    from pynucleus_tpu_torch.nl.kernels import getFractionalKernel
    from pynucleus_tpu_torch.nl.assembly import nonlocalBuilder
    from pynucleus_tpu_torch.base.solvers import solverFactory
    dm = tp_dm(tp_refined(simpleInterval(-1.0, 1.0), F32_INTERVAL_NOREF))
    A = nonlocalBuilder(dm, getFractionalKernel(1, F32_S), params={
        'dtype': dtype, 'denseGrid': grid}).getDense()
    b = assembleRHS(dm, constant(1.0)).data.to(A.data.dtype)
    cg = solverFactory.build('cg', A=A, setup=True)
    cg.tolerance = F32_CG_TOL
    cg.maxIter = F32_CG_MAXITER
    f32_tf32_off()
    u = cg.solve(b)
    if u.dtype != (torch.float32 if dtype == np.float32 else torch.float64):
        raise AssertionError(f'the solution is {u.dtype}')
    s = F32_S
    xs = dm.getDoFCoordinates()[:, 0]
    uex = (2.0 ** (-2 * s) * np.sqrt(np.pi)
           / (gamma(s + 0.5) * gamma(1.0 + s))) * (1 - xs ** 2) ** s
    return float(np.abs(u.double().cpu().numpy() - uex).max()), \
        cg.iterations


def f32_interval_lines():
    """tests/test_f32_path.py's two bars on the card: e32 < max(2 e64,
    5e-4), on the grid and per pair."""
    import numpy as np
    out = {}
    for grid in (True, False):
        e64, it64 = f32_interval_error(np.float64, grid)
        e32, it32 = f32_interval_error(np.float32, grid)
        if not e32 < max(2.0 * e64, F32_BAR_FLOOR):
            raise AssertionError(f'float32 interval (grid {grid}): e32 {e32} '
                                 f'vs e64 {e64}')
        out['grid' if grid else 'per_pair'] = {
            'e32': e32, 'e64': e64, 'iterations32': it32,
            'iterations64': it64}
    log(f'  tests/test_f32_path.py bars on the card: {json.dumps(out)}')
    return out


# cycles of the spin that holds the card while the host queues a short
# timed run (about 25 ms at the H100's 1.98 GHz)
QUEUE_SPIN_CYCLES = 50_000_000


def queued_ms(run):
    """The device milliseconds of run()'s launches: they are queued behind
    a spin of the card (torch.cuda._sleep), so that CUDA events around
    them read their device time and not the host's time to launch them
    (which CUDA events around short calls on an idle card read)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_SPIN_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def k4_device_ms(A, u, fn):
    """The device ms of 10 calls of K4's Jacobi form (or its plain
    version) ``fn`` on the operator A's PCG state from b = A u, after a
    warm-up call (A p once: the calls' work does not depend on it)."""
    b = A.matvec(u)
    invD = 1.0 / A.diagonal
    st = pcg_state(b, invD * b, [invD])
    A.matvec(st[3], out=st[4])
    fn(*st, 0)
    return queued_ms(lambda: [fn(*st, it) for it in range(10)])


def f32_disc_mesh():
    from pynucleus_tpu_torch.fem.meshes import circle
    return tp_dm(tp_refined(circle(n=8), F32_NOREF))


def f32_disc_dense(dm, dtype):
    from pynucleus_tpu_torch.nl.kernels import getFractionalKernel
    from pynucleus_tpu_torch.nl.assembly import nonlocalBuilder
    return nonlocalBuilder(dm, getFractionalKernel(2, F32_S),
                           params={'dtype': dtype}).getDense()


def f32_disc_line(dtype, timer):
    """The disc in ``dtype``: getDense on the grid (host seconds after a
    synchronise; each kernel's device ms by CUDA events), CG-Jacobi to
    F32_CG_TOL (500 iterations at most; cold, then warm), the peak device
    memory above the line's start.  Returns (summary, (A, u))."""
    import numpy as np
    import torch
    from pynucleus_tpu_torch.fem.assembly import assembleRHS
    from pynucleus_tpu_torch.fem.functions import constant
    from pynucleus_tpu_torch.base.solvers import solverFactory
    dm = f32_disc_mesh()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    A = f32_disc_dense(dm, dtype)
    torch.cuda.synchronize()
    assembly = time.perf_counter() - t0
    shares = timer.ms()
    real = torch.float32 if dtype == np.float32 else torch.float64
    if A.data.dtype != real or not bool(torch.isfinite(A.data).all()):
        raise AssertionError(f'the {real} operator: {A.data.dtype}, finite '
                             f'{bool(torch.isfinite(A.data).all())}')
    b = assembleRHS(dm, constant(1.0)).data.to(real)
    cg = solverFactory.build('cg-jacobi', A=A, setup=True)
    cg.tolerance = F32_CG_TOL
    cg.maxIter = F32_CG_MAXITER
    f32_tf32_off()
    solve = []
    for _ in range(2):
        t0 = time.perf_counter()
        u = cg.solve(b)
        torch.cuda.synchronize()
        solve.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() - base
    if u.dtype != real or not bool(torch.isfinite(u).all()):
        raise AssertionError(f'the {real} solution: {u.dtype}')
    rel = float(torch.linalg.norm(b - A.matvec(u)) / torch.linalg.norm(b))
    out = {'dofs': dm.num_dofs, 'cells': dm.mesh.num_cells,
           'cell_pairs': dm.mesh.num_cells * (dm.mesh.num_cells + 1) // 2,
           'dtype': str(real).split('.')[-1], 'assembly_s': assembly,
           'kernel_ms': shares, 'iterations': cg.iterations,
           'residual': float(cg.residuals[-1]),
           'converged': bool(cg.residuals[-1] <= F32_CG_TOL),
           'relative_residual': rel, 'solve_s': solve[0],
           'warm_solve_s': solve[1], 'peak_GiB': peak / 2**30,
           'operator_GB': A.data.numel() * A.data.element_size() / 1e9}
    log(f'  the disc in {out["dtype"]}: {json.dumps(out)}')
    return out, (A, u)


def phase23():
    """The float32 dense path: tests/test_f32_path.py's interval lines (a
    path), bench.py's disc in float32 (a path: getDense on the grid, K1's,
    K2's and K3's float32 instances, CG-Jacobi through K4's) and in float64
    (a path), the distance of the two operators and solutions, K4 in both
    on their operators; then, recorded during a third (float32) build of
    the disc, each float32 instance against its float32 plain version at
    the disc's calls (1e-5 of the largest entry; K4 10 iterations, x, r and
    p to 1e-5 relative) with the same calls' float64 time, and the
    natural-order entry (float32, and the same call in float64) on its
    largest call.  Returns (launch counts per path, comparisons,
    summary)."""
    import contextlib
    import numpy as np
    import torch
    import pynucleus_tpu_torch.nl.assembly as asm
    from pynucleus_tpu_torch.base import solvers
    log('phase 23: the float32 dense path (bench.py\'s disc in float32 and '
        'float64)')
    t0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    counts, summary = {}, {}
    summary['interval'], counts['interval'] = count_path(
        'the float32 interval lines', F32_INTERVAL_PATH, f32_interval_lines)
    lines = {}
    for label, dtype, path in (('float32', np.float32, F32_PATH),
                               ('float64', np.float64, DENSE_PATH)):
        with EventTimer(asm, K123) as timer:
            (summary[label], lines[label]), counts[label] = count_path(
                f'the {label} disc', path, lambda: f32_disc_line(dtype,
                                                                  timer))
    (A32, u32), (A64, u64) = lines.pop('float32'), lines.pop('float64')
    scale = float(A64.data.abs().max())
    dA = float((A32.data.double() - A64.data).abs().max()) / scale
    du = float(torch.linalg.norm(u32.double() - u64)
               / torch.linalg.norm(u64))
    summary['operator_distance'] = dA
    summary['solution_distance'] = du
    log(f'  max|A32 - A64| / max|A64| = {dA:.3e}; ||u32 - u64|| / ||u64|| = '
        f'{du:.3e}')
    if not du <= TOL_F32_VS_F64:
        raise AssertionError(f'the float32 solution {du} from the float64 '
                             'one')
    if not summary['float64']['converged']:
        raise AssertionError('the float64 CG-Jacobi did not converge')
    # K4 on the disc's operators: 10 iterations of the Jacobi form against
    # its plain version in float32; its device time (a call is three short
    # launches, so CUDA events around it read the host's launch time
    # whenever the card waits for it) queued behind a spin, in turns
    # float32, float64, float64, float32 (the second run of each kept)
    jac = (solvers.pcg_update, solvers._pcg_update_plain)
    b32 = A32.matvec(u32)
    invD32 = 1.0 / A32.diagonal
    errJ, eventMs, _ = compare_pcg(
        'pcg_update (Jacobi form, float32)', jac,
        [pcg_state(b32, invD32 * b32, [invD32]) for _ in range(2)],
        (A32, None), tol=TOL_F32)
    dev = {}
    for label in ('float32', 'float64', 'float64', 'float32'):
        A, u = (A32, u32) if label == 'float32' else (A64, u64)
        dev[label] = {fn.__name__: k4_device_ms(A, u, fn) for fn in jac}
    n = u32.shape[0]
    msJ, plainJ = dev['float32']['pcg_update'], \
        dev['float32']['_pcg_update_plain']
    ms64 = dev['float64']['pcg_update']
    log(f'  pcg_update (float32, n {n}): 10 iterations, max abs err '
        f'{errJ:.3e}; device ms (queued): kernel {msJ:.4f} (float64 '
        f'{ms64:.4f}), plain {plainJ:.4f}; CUDA events around the calls '
        f'{eventMs:.4f} ms')
    cmp = {'pcg_update:float32': result(errJ, msJ, plainJ,
                                        [(36 * n, 13 * n, F32_PEAK)] * 10)}
    cmp['pcg_update:float32'].update(float64_ms=ms64, event_ms=eventMs)
    # the float64 dense A of the disc stays for phase 24 (H2 against it)
    KEPT['disc_dense64'] = A64
    del A32, A64, u32, u64, lines
    torch.cuda.empty_cache()

    # the kernels' calls, recorded during a third build (float32; no path)
    with contextlib.ExitStack() as stack:
        nat = stack.enter_context(NaturalRecorder())
        k1 = stack.enter_context(OrderRecorder(
            asm, 'panel_scatter', distantLargest=True, key=_k1_route))
        k2 = stack.enter_context(ArgRecorder(asm, 'grid_distant',
                                             dataFirst=True))
        k3 = stack.enter_context(ArgRecorder(asm, 'grid_boundary',
                                             dataFirst=True))
        f32_disc_dense(f32_disc_mesh(), np.float32)
    torch.cuda.synchronize()
    log('  the float32 instances against their plain versions (1e-5 of the '
        'largest entry), and the same calls in float64')
    F32W = dict(entryBytes=8, peak=F32_PEAK)
    for name, calls, kernel, plain, work, keep in (
            ('panel_scatter:float32', k1.callsOf(), asm.panel_scatter,
             asm._panel_scatter_plain, panel_work, ()),
            ('panel_scatter:float32_natural', k1.callsOf('natural'),
             asm.panel_scatter, asm._panel_scatter_plain, panel_work, ()),
            ('panel_scatter:float32_rows', k1.callsOf('rows'),
             asm.panel_scatter, asm._panel_scatter_plain, panel_work, ()),
            ('grid_distant:float32', k2.calls, asm.grid_distant,
             asm._grid_distant_plain, grid_distant_work, (1,)),
            ('grid_boundary:float32', k3.calls, asm.grid_boundary,
             asm._grid_boundary_plain, grid_boundary_work, ())):
        cmp[name] = compare_target_kernel(
            name, calls, kernel, plain, functools.partial(work, **F32W),
            dtype=torch.float32, tol=TOL_F32)
        cmp[name]['float64_ms'] = float64_ms(calls, kernel, keep)
        log(f'    the same calls in float64: {cmp[name]["float64_ms"]:.3f} '
            'ms')
    # the natural-order entry (the one-chunk program, no JAX caller) on its
    # largest call, and the same call in float64
    natCalls = {'float32': nat.calls,
                'float64': [((c[0][0],) + as_float64(c[0][1:]), c[1])
                            for c in nat.calls]}
    cmp['panel_scatter:float32_natural']['one_chunk_entry'] = {
        label: compare_target_kernel(
            f'panel_scatter_natural ({label}, its largest call)', calls,
            asm.panel_scatter_natural, asm._panel_scatter_natural_plain,
            functools.partial(natural_work, **(
                F32W if label == 'float32' else {})),
            dtype=getattr(torch, label),
            tol=TOL_F32 if label == 'float32' else TOL_KERNEL)
        for label, calls in natCalls.items()}
    summary['seconds'] = time.perf_counter() - t0
    log(f'phase 23 summary: {json.dumps(summary)}')
    return counts, cmp, summary


def FLOAT32_23_PATHS(counts23):
    """The main paths of phase 23: (kernels, label, launch counts)."""
    return ((F32_INTERVAL_PATH,
             f'float32_interval_noRef{F32_INTERVAL_NOREF}_grid_and_per_pair',
             counts23['interval']),
            (F32_PATH, f'float32_disc_noRef{F32_NOREF}_grid_cg_jacobi',
             counts23['float32']),
            (DENSE_PATH, f'float64_disc_noRef{F32_NOREF}_grid_cg_jacobi',
             counts23['float64']))


# ---------------------------------------------------------------- phase 24

# bench.py's H2 lines on the port: h2_2d (benchH2Matvec2D with _cgSolve,
# bench.py:218-273) on phase 23's disc (circle(n=8) refined H2F_NOREF
# times, 16,129 dofs) and h2_1d (benchH2Matvec, bench.py:186-215) on
# simpleInterval(-1, 1) refined H2F_INTERVAL_NOREF times (65,535 dofs, one
# cell halved 16 times, bench.py's BENCH_H2_NOREF default): getH2 of
# (-Delta)^0.75, P1, infinite horizon, zero exterior, on the default
# (block) engine, in float32 (the JAX package's dtype off the CPU,
# bench.py:58-64) and, beside it, in float64
H2F_NOREF = 6
H2F_INTERVAL_NOREF = 16
# the float64 twin of h2_1d at H2F_INTERVAL_NOREF, or, where the float32
# build there took longer than H2F_TWIN_LIMIT seconds, at H2F_TWIN_NOREF
# with a float32 build at that depth beside it (phase 24 keeps to about
# 90 s)
H2F_TWIN_NOREF = 14
H2F_TWIN_LIMIT = 25.0
H2F_APPLIES = 64           # bench.py:92 _steadyMatvec's applications
H2F_SEED = 24
# the build's kernel wrappers timed by CUDA events (nl.assembly)
H2F_BUILD = ('panel_scatter_slots', 'panel_scatter_tree', 'block_near_count',
             'block_near_quad', 'near_enum', 'near_enum_quad', 'far_field')
# the float32 instances of the H2 path and the float64 kernels they replace
# on it (each float32 line launches none of the latter's float64 instances)
H2F_VARIANTS = {'panel_scatter': 'panel_scatter:float32',
                'near_enum_quad': 'near_enum_quad:float32',
                'block_near_quad': 'block_near_quad:float32',
                'far_field': 'far_field:float32',
                'h2_matvec': 'h2_matvec:float32',
                'pcg_update': 'pcg_update:float32'}
H2F64_PATH = ('panel_scatter', 'panel_scatter:slots', 'panel_scatter:tree',
              'near_enum', 'near_enum_quad', 'block_near_count',
              'block_near_quad', 'far_field', 'h2_matvec')
H2F32_PATH = H2F64_PATH + ('panel_scatter:float32',
                           'panel_scatter:float32_slots',
                           'panel_scatter:float32_tree',
                           'near_enum_quad:float32',
                           'block_near_quad:float32', 'far_field:float32',
                           'h2_matvec:float32')
H2F_CG = ('pcg_update', 'pcg_update:jacobi')
# on the interval every near cluster pair also holds orders above 8: K12
# has no element to run (K11 counts them, K6 runs them)
H2F_1D = ('block_near_quad', 'block_near_quad:float32')
FLOAT32_H2_REPLACES = {
    'panel_scatter:float32_slots': 'pynucleus_tpu/nl/assembly.py:1088',
    'panel_scatter:float32_tree': 'pynucleus_tpu/nl/assembly.py:1568',
    'near_enum_quad:float32': 'pynucleus_tpu/nl/assembly.py:1506',
    'block_near_quad:float32': 'pynucleus_tpu/nl/assembly.py:1427',
    'far_field:float32': 'pynucleus_tpu/nl/assembly.py:744',
    'h2_matvec:float32': 'pynucleus_tpu/nl/h2.py:963'}
_H2F_AT = (f'the float32 h2_2d disc (circle(n=8) refined {H2F_NOREF} times, '
           '16,129 dofs, block engine)')
FLOAT32_H2_COMPARED_AT = {
    'panel_scatter:float32_slots': _H2F_AT + ': its largest slot-target '
    'bucket',
    'panel_scatter:float32_tree': _H2F_AT + ': its largest tree-target '
    'bucket (the union surfaces)',
    'near_enum_quad:float32': _H2F_AT + ': its largest order (the pairs '
    'that also hold orders above 8)',
    'block_near_quad:float32': _H2F_AT + ': its one call',
    'far_field:float32': _H2F_AT + ': its one call',
    'h2_matvec:float32': _H2F_AT + ': 10 applies of its operator, device '
    'time (CUDA events around applies queued behind a spin of the card; '
    'around the applies on an idle card: event_ms), per apply'}


def h2f_dm(domain, noRef):
    from pynucleus_tpu_torch.fem.meshes import circle, simpleInterval
    mesh = circle(n=8) if domain == 'disc' else simpleInterval(-1.0, 1.0)
    return tp_dm(tp_refined(mesh, noRef))


def h2f_operator(dm, dtype):
    """getH2 of (-Delta)^F32_S on dm in dtype; returns (H, builder
    timers)."""
    from pynucleus_tpu_torch.nl.kernels import getFractionalKernel
    from pynucleus_tpu_torch.nl.assembly import nonlocalBuilder
    b = nonlocalBuilder(dm, getFractionalKernel(dm.mesh.dim, F32_S),
                        params={'dtype': dtype})
    return b.getH2(), dict(b.timers)


def steady_apply_ms(H, x):
    """bench.py:92 _steadyMatvec on the port: H2F_APPLIES normalised
    applications y = H y / (1e-30 + max|H y|), after an untimed run of
    them; ms per application (host clock around a synchronised run)."""
    import torch

    def run():
        y = x.clone()
        for _ in range(H2F_APPLIES):
            y = H.matvec(y)
            y = y / (1e-30 + y.abs().max())
        return y
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = run()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(y).all()):
        raise AssertionError('the steady apply is not finite')
    return (time.perf_counter() - t0) * 1e3 / H2F_APPLIES


def h2f_check_types(label, counts, dtype):
    """A float32 line launched no float64 instance of the H2 path's
    kernels (each launch of such a kernel is its float32 variant's); a
    float64 line no float32 instance."""
    import numpy as np
    for base, var in H2F_VARIANTS.items():
        if dtype == np.float32 and counts[base] != counts[var]:
            raise AssertionError(f'{label}: {counts[base]} launches of '
                                 f'{base}, {counts[var]} of {var}')
        if dtype == np.float64 and counts[var]:
            raise AssertionError(f'{label}: {counts[var]} launches of {var}')


def h2f_line(label, domain, noRef, dtype, x, solve=False):
    """One line in ``dtype``: getH2 (host seconds after a synchronise, the
    builder's timers, each build kernel's device ms by CUDA events), near
    nnz, far blocks, the steady apply on x, with ``solve`` CG-Jacobi
    (bench.py:253-273: b = M 1 in the working type, 1e-6, 500 at most, M =
    1 / H.diagonal; cold, then warm), the peak device memory above the
    line's start.  Returns (summary, H, u or None)."""
    import numpy as np
    import torch
    import pynucleus_tpu_torch.nl.assembly as asm
    from pynucleus_tpu_torch.fem.assembly import assembleRHS
    from pynucleus_tpu_torch.fem.functions import constant
    from pynucleus_tpu_torch.base.solvers import solverFactory
    dm = h2f_dm(domain, noRef)
    real = torch.float32 if dtype == np.float32 else torch.float64
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with EventTimer(asm, H2F_BUILD) as timer:
        t0 = time.perf_counter()
        H, timers = h2f_operator(dm, dtype)
        torch.cuda.synchronize()
        build = time.perf_counter() - t0
    if H.dtype != real or H.diagonal.dtype != real or not bool(
            torch.isfinite(H.Anear.dataT).all()):
        raise AssertionError(f'{label}: the {real} operator is '
                             f'{H.dtype}')
    near = sum(v for k, v in timers.items() if k in (
        'near pattern', 'singular', 'near blocks', 'enumeration',
        'surfaces'))
    out = {'dofs': dm.num_dofs, 'noRef': noRef,
           'dtype': str(real).split('.')[-1], 'build_s': build,
           'timers_s': timers, 'near_field_s': near,
           'kernel_ms': timer.ms(), 'near_nnz': H.Anear.nnz,
           'far_blocks': H.Kall.shape[0], 'M': H.M, 'levels': H.nLvl,
           'operator_GB': sum(t.numel() * t.element_size() for t in (
               H.Anear.dataZ, H.leafPhi, H.Ttr, H.Kall)) / 1e9}
    u = None
    if solve:
        b = assembleRHS(dm, constant(1.0)).data.to(real)
        cg = solverFactory.build('cg-jacobi', A=H, setup=True)
        cg.tolerance = F32_CG_TOL
        cg.maxIter = F32_CG_MAXITER
        f32_tf32_off()
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            u = cg.solve(b)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        if u.dtype != real or not bool(torch.isfinite(u).all()):
            raise AssertionError(f'{label}: the solution is {u.dtype}')
        out.update(
            iterations=cg.iterations, residual=float(cg.residuals[-1]),
            converged=bool(cg.residuals[-1] <= F32_CG_TOL),
            at_cap=cg.iterations >= F32_CG_MAXITER,
            relative_residual=float(torch.linalg.norm(b - H.matvec(u))
                                    / torch.linalg.norm(b)),
            solve_s=times[0], warm_solve_s=times[1])
    out['steady_apply_ms'] = steady_apply_ms(H, x.to(real))
    out['peak_GiB'] = (torch.cuda.max_memory_allocated() - base) / 2**30
    log(f'  {label}: {json.dumps(out)}')
    return out, H, u


def h2f_gaps(H32, H64, x):
    """max|H32 x - H64 x| / max|H64 x| and max|diag32 - diag64| /
    max|diag64|."""
    y64 = H64.matvec(x.double())
    y32 = H32.matvec(x.float()).double()
    d64, d32 = H64.diagonal, H32.diagonal.double()
    return (float((y32 - y64).abs().max() / y64.abs().max()),
            float((d32 - d64).abs().max() / d64.abs().max()))


def h2f_path(dt, domain):
    """The kernels that a line of ``domain`` in ``dt`` must launch."""
    path = H2F32_PATH if dt == 'float32' else H2F64_PATH
    return tuple(k for k in path if domain == 'disc' or k not in H2F_1D)


def h2f_pair(label, domain, noRef32, noRef64, x32, x64, solve, counts,
             summary):
    """The float32 line (a path) and the float64 one (a path) of a domain;
    their gaps where the depths agree.  Returns the operators and the
    solutions."""
    import numpy as np
    ops = {}
    for dt, noRef, x in (('float32', noRef32, x32), ('float64', noRef64,
                                                      x64)):
        dtype = getattr(np, dt)
        key = f'{label}_{dt}'
        path = h2f_path(dt, domain) + (H2F_CG if solve else ())
        (summary[key], H, u), counts[key] = count_path(
            f'{label} in {dt}', path,
            lambda: h2f_line(f'{label} in {dt}', domain, noRef, dtype, x,
                             solve))
        h2f_check_types(key, counts[key], dtype)
        ops[dt] = (H, u)
    return ops


def phase24():
    """The float32 H2 path: bench.py's h2_2d (the disc in float32 and
    float64, a path each: getH2 on the block engine, CG-Jacobi, the steady
    apply) and h2_1d (the interval at noRef 16 in float32 with its float64
    twin, a path each: getH2 and the steady apply); the float32 operators
    against the float64 ones (the apply, the diagonal, the solution) and,
    where phase 23 left it, the float64 dense disc; then, recorded during
    a third (float32) build of the disc and at its operator, each float32
    instance against its float32 plain version (1e-5 of the largest entry,
    K8 of max|y|) with the same calls' float64 time.  Returns (launch counts
    per path, comparisons, summary)."""
    import contextlib
    import functools
    import numpy as np
    import torch
    import pynucleus_tpu_torch.nl.assembly as asm
    from pynucleus_tpu_torch.nl import h2
    log('phase 24: the float32 H2 path (bench.py\'s h2_2d and h2_1d lines in '
        'float32 and float64)')
    t0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    counts, summary = {}, {}
    gen = torch.Generator('cuda').manual_seed(H2F_SEED)
    n2 = h2f_dm('disc', H2F_NOREF).num_dofs
    x2 = torch.randn(n2, dtype=torch.float64, device='cuda', generator=gen)
    disc = h2f_pair('h2_2d', 'disc', H2F_NOREF, H2F_NOREF, x2, x2, True,
                    counts, summary)
    (H32, u32), (H64, u64) = disc['float32'], disc['float64']
    gap, dgap = h2f_gaps(H32, H64, x2)
    du = float(torch.linalg.norm(u32.double() - u64) / torch.linalg.norm(u64))
    summary['h2_2d_gaps'] = {'apply': gap, 'diagonal': dgap,
                             'solution': du}
    A64 = KEPT.pop('disc_dense64', None)
    if A64 is not None:
        yA = A64.matvec(x2)
        summary['h2_2d_gaps']['h2_32_vs_dense_64'] = float(
            (H32.matvec(x2.float()).double() - yA).abs().max()
            / yA.abs().max())
        summary['h2_2d_gaps']['h2_64_vs_dense_64'] = float(
            (H64.matvec(x2) - yA).abs().max() / yA.abs().max())
        del A64, yA
    log(f"  h2_2d gaps: {json.dumps(summary['h2_2d_gaps'])}")
    if not du <= TOL_F32_VS_F64:
        raise AssertionError(f'h2_2d: the float32 solution {du} from the '
                             'float64 one')
    if not summary['h2_2d_float64']['converged']:
        raise AssertionError('h2_2d: the float64 CG-Jacobi did not converge')

    # h2_1d: x = sin(pi linspace(-1, 1, N)) (bench.py:212); the float64
    # twin at noRef 16, or at 14 beside a float32 build at 14
    def sinx(noRef):
        n = h2f_dm('interval', noRef).num_dofs
        return torch.sin(np.pi * torch.linspace(-1.0, 1.0, n,
                                                dtype=torch.float64,
                                                device='cuda'))
    x1 = sinx(H2F_INTERVAL_NOREF)
    (summary['h2_1d_float32'], H1, _), counts['h2_1d_float32'] = count_path(
        'h2_1d in float32', h2f_path('float32', 'interval'),
        lambda: h2f_line('h2_1d in float32', 'interval', H2F_INTERVAL_NOREF,
                         np.float32, x1))
    h2f_check_types('h2_1d_float32', counts['h2_1d_float32'], np.float32)
    twin = H2F_INTERVAL_NOREF \
        if summary['h2_1d_float32']['build_s'] <= H2F_TWIN_LIMIT \
        else H2F_TWIN_NOREF
    summary['h2_1d_twin_noRef'] = twin
    if twin == H2F_INTERVAL_NOREF:
        (summary['h2_1d_float64'], H1_64, _), counts['h2_1d_float64'] = \
            count_path('h2_1d in float64', h2f_path('float64', 'interval'),
                       lambda: h2f_line('h2_1d in float64', 'interval', twin,
                                        np.float64, x1))
        h2f_check_types('h2_1d_float64', counts['h2_1d_float64'], np.float64)
        pair = (H1, H1_64, x1)
    else:
        del H1
        xt = sinx(twin)
        ops = h2f_pair(f'h2_1d_noRef{twin}', 'interval', twin, twin, xt, xt,
                       False, counts, summary)
        pair = (ops['float32'][0], ops['float64'][0], xt)
    gap1, dgap1 = h2f_gaps(*pair)
    summary['h2_1d_gaps'] = {'noRef': twin, 'apply': gap1,
                             'diagonal': dgap1}
    log(f"  h2_1d gaps: {json.dumps(summary['h2_1d_gaps'])}")
    del pair
    torch.cuda.empty_cache()

    # the kernels' calls, recorded during a third build of the disc
    # (float32; no path): the largest bucket of K1's slot and tree
    # targets and of K6, every call of K12 and K7
    sizes = {'panel_scatter_slots': lambda data, v, vi1, *a: vi1.shape[0],
             'panel_scatter_tree': lambda data, v, vi1, *a: vi1.shape[0],
             'near_enum_quad': lambda data, ids, *a: ids.shape[0]}
    with contextlib.ExitStack() as stack:
        recs = {n: stack.enter_context(ArgRecorder(
            asm, n, dataFirst=n != 'far_field', size=sizes.get(n)))
            for n in ('panel_scatter_slots', 'panel_scatter_tree',
                      'near_enum_quad', 'block_near_quad', 'far_field')}
        h2f_operator(h2f_dm('disc', H2F_NOREF), np.float32)
    torch.cuda.synchronize()
    log('  the float32 instances against their plain versions (1e-5 of the '
        'largest entry), and the same calls in float64')
    F32W = dict(entryBytes=8, peak=F32_PEAK)
    cmp = {}
    for name, n, work, keep in (
            ('panel_scatter:float32_slots', 'panel_scatter_slots',
             panel_work, ()),
            ('panel_scatter:float32_tree', 'panel_scatter_tree', panel_work,
             ()),
            ('near_enum_quad:float32', 'near_enum_quad', enum_quad_work, ()),
            ('block_near_quad:float32', 'block_near_quad', block_quad_work,
             (4, 5))):
        calls = recs[n].calls
        if not calls:
            raise AssertionError(f'{n}: the disc build made no call of it')
        kernel, plain = getattr(asm, n), getattr(asm, '_' + n + '_plain')
        cmp[name] = compare_target_kernel(
            name, calls, kernel, plain, functools.partial(work, **F32W),
            dtype=torch.float32, tol=TOL_F32)
        cmp[name]['float64_ms'] = float64_ms(calls, kernel, keep)
        log(f'    the same calls in float64: {cmp[name]["float64_ms"]:.3f} '
            'ms')
    kcalls = recs['far_field'].calls
    if not kcalls:
        raise AssertionError('far_field: the disc build made no call of it')
    cmp['far_field:float32'] = compare_far_field(
        kcalls, 'far_field (float32)', tol=TOL_F32)
    k64 = [(as_float64(a), kw) for a, kw in kcalls]
    asm.far_field(*k64[0][0], **k64[0][1])
    cmp['far_field:float32']['float64_ms'] = sum(
        timed(lambda: asm.far_field(*a, **kw)) for a, kw in k64)
    log('    the same calls in float64: '
        f"{cmp['far_field:float32']['float64_ms']:.3f} ms")
    cmp['h2_matvec:float32'] = compare_h2_matvec_f32(H32, H64, x2)
    summary['seconds'] = time.perf_counter() - t0
    log(f'phase 24 summary: {json.dumps(summary)}')
    return counts, cmp, summary


def compare_h2_matvec_f32(H32, H64, x, reps=10):
    """K8's float32 instance: ``reps`` applies of the float32 operator
    against its plain version (1e-5 of max|y|), device time queued behind
    a spin of the card (an apply is some twenty short launches), in turns
    float32, float64 (the float64 instance on the float64 operator of the
    same disc), float64, float32, the second run of each kept; CUDA events
    around the applies on an idle card beside."""
    import torch
    from pynucleus_tpu_torch.nl import h2
    x32, x64 = x.float().contiguous(), x.double().contiguous()
    yk, y64 = torch.empty_like(x32), torch.empty_like(x64)
    h2.h2_matvec(H32, x32, out=yk)
    yp = h2._h2_matvec_plain(H32, x32)
    err = float((yk - yp).abs().max())
    scale = float(yp.abs().max())
    if not (scale > 0 and err <= TOL_F32 * scale):
        raise AssertionError(f'h2_matvec (float32): max err {err} (max '
                             f'{scale})')
    h2.h2_matvec(H64, x64, out=y64)
    runs = {'float32': lambda: [h2.h2_matvec(H32, x32, out=yk)
                                for _ in range(reps)],
            'float64': lambda: [h2.h2_matvec(H64, x64, out=y64)
                                for _ in range(reps)],
            'plain': lambda: [h2._h2_matvec_plain(H32, x32)
                              for _ in range(reps)]}
    dev = {}
    for label in ('float32', 'float64', 'plain', 'plain', 'float64',
                  'float32'):
        dev[label] = queued_ms(runs[label]) / reps
    eventMs = timed(runs['float32']) / reps
    log(f'  h2_matvec (float32, n {H32.num_rows}): max abs err {err:.3e} '
        f'(rel {err / scale:.3e}); device ms per apply (queued): kernel '
        f"{dev['float32']:.4f} (float64 {dev['float64']:.4f}), plain "
        f"{dev['plain']:.4f}; CUDA events around the applies "
        f'{eventMs:.4f} ms')
    out = result(err, dev['float32'], dev['plain'], [h2_matvec_work(H32)])
    out.update(float64_ms=dev['float64'], event_ms=eventMs)
    return out


def FLOAT32_H2_24_PATHS(counts24):
    """The main paths of phase 24: (kernels, label, launch counts)."""
    return tuple((h2f_path(key.split('_')[-1],
                           'disc' if key.startswith('h2_2d') else 'interval'),
                  key, c) for key, c in counts24.items())


# ----------------------------------------------------------------- phase 25

# drivers/testDistOp.py's flagship line: the disc in H2 over four shards on
# one card, bcast and halo modes, the distributed CG, at noRef 6 (18,145
# dofs; cut from 7, 73,153 dofs, whose H2 build and two set-ups took 42.9 and
# 27.9 s of 73.0 s when the script reached 1,100.5 s of its 1,200 s on an
# H100 80GB HBM3 at 700 W); runParallelGMG's interval P1 at its default
# noRef, 4 ranks against 1; the dry run of the distributed H2 at its default
# noRef 14
DIST_NOREF = 6
DIST_RANKS = 4
DIST_DRYRUN_NOREF = 14
DIST_SEED = 25
TOL_DIST = 1e-10
# the reference cache of tests/test_parallel_gmg.py's interval P1 line
GMG_INTERVAL_CACHE = {
    'iterations': {'MG': 6, 'FMG': 5, 'PCG': 3, 'PGMRES': 3,
                   'PBICGSTAB': 2, 'FMG-PCG': 2, 'FMG-PGMRES': 2},
    'rates': {'MG': 0.049099444405778306, 'FMG': 0.02700477186888465,
              'PCG': 0.002753242733377948, 'PGMRES': 0.002568348642045146,
              'FMG-PCG': 0.00012398350674816368,
              'FMG-PGMRES': 0.00011126556266466207},
    'errors': {'L^2 error': 3.161013638317052e-08,
               'H^1_0 error': 6.148245111522337e-05}}
DIST_OP_PATH = ('dist_h2_matvec', 'outbox', 'h2_matvec', 'pcg_update',
                'panel_scatter', 'far_field')
DIST_GMG_PATH = ('outbox', 'csr_spmv', 'jacobi_smooth', 'pcg_update',
                 'csr_scatter', 'gmres_arnoldi', 'bicgstab_update')
DIST_DRYRUN_PATH = ('dist_h2_matvec', 'outbox', 'h2_matvec', 'pcg_update',
                    'far_field')
DIST_OVERLAP_PATH = ('outbox', 'outbox:pack', 'outbox:recv_add',
                     'outbox:gather2d')
# the dense bases: testDistOp's disc on a dense base (bcast: row blocks with
# an all_gathered x; halo: the fractional operator's full bandwidth gathers
# x too); shardedDenseAssembly with CG-Jacobi on its row-sharded operator,
# the S1 problem of __graft_entry__.py:88-101 (s 0.25 on the interval
# refined 1 + 11 times, 4,095 dofs); and a banded operator (a finite
# horizon on the interval, its dofs in coordinate order) whose halo mode
# exchanges strips (K29 pack, ppermute), beside DistMatrix (K9 per part)
# and Import (K29's 2D gather)
DIST_DENSE_NOREF = 5
DIST_S1_NOREF = 11
DIST_S1_S = 0.25
DIST_BANDED_NOREF = 12
DIST_BANDED_HORIZON = 0.05
DIST_DENSE_PATH = ('panel_scatter', 'grid_distant', 'grid_boundary',
                   'pcg_update')
DIST_SHARDED_DENSE_PATH = ('panel_scatter', 'panel_scatter:dense',
                           'pcg_update', 'pcg_update:jacobi')
DIST_BANDED_PATH = ('outbox', 'outbox:pack', 'outbox:gather2d', 'csr_spmv')
KERNEL_INFO['dist_h2_matvec'] = (
    'cuda', 'pynucleus_tpu_torch/kernels/csrc/dist_h2.cu',
    'pynucleus_tpu/parallel/dist_h2.py:722')
KERNEL_INFO['outbox'] = (
    'cuda', 'pynucleus_tpu_torch/kernels/csrc/outbox.cu',
    'pynucleus_tpu/parallel/dist_h2.py:578')
COMPARED_AT['dist_h2_matvec'] = (
    f'testDistOp disc noRef {DIST_NOREF}, {DIST_RANKS} shards: every phase '
    'call of one halo apply (timed, per apply) and of one bcast apply')
COMPARED_AT['outbox'] = (
    f'testDistOp disc noRef {DIST_NOREF}, {DIST_RANKS} shards: every pack '
    'of one halo apply (timed, per apply) and of one bcast apply; the '
    'halo strips of the banded interval operator (noRef '
    f'{DIST_BANDED_NOREF}); the receive-add and the 2D gather on '
    'tests/test_overlaps.py\'s square')


def dist_argv(device='cuda'):
    return ['--domain', 'disc', '--s', 'const(0.75)', '--problem',
            'constant', '--noRef', str(DIST_NOREF), '--buildH2',
            '--buildDistributedH2Bcast', '--buildDistributedH2', '--doSolve',
            '--ranks', str(DIST_RANKS), '--device', device]


def DIST25_PATHS(counts25):
    """The main paths of phase 25: (kernels, label, launch counts)."""
    return ((DIST_OP_PATH, f'test_dist_op_disc_noRef{DIST_NOREF}',
             counts25['testDistOp']),
            (DIST_GMG_PATH, 'parallel_gmg_interval_ranks4',
             counts25['gmg']),
            (DIST_DRYRUN_PATH, f'dryrun_dist_h2_noRef{DIST_DRYRUN_NOREF}',
             counts25['dryrun']),
            (DIST_OVERLAP_PATH, 'overlap_accumulate_repartition',
             counts25['overlaps']),
            (DIST_DENSE_PATH, f'test_dist_op_dense_disc_noRef'
             f'{DIST_DENSE_NOREF}', counts25['dense']),
            (DIST_SHARDED_DENSE_PATH, f'sharded_dense_interval_noRef'
             f'{DIST_S1_NOREF}', counts25['sharded_dense']),
            (DIST_BANDED_PATH, f'banded_halo_interval_noRef'
             f'{DIST_BANDED_NOREF}', counts25['banded']))


def _tensorsOf(args):
    import torch
    return [a for a in args if isinstance(a, torch.Tensor)]


def compare_recorded(name, calls, kernel, plain, work, library=None):
    """Recorded calls of a function that writes into some of its tensor
    arguments and may return a tensor: each call through the kernel and
    the plain version on clones of its arguments; every float64 argument
    and the returned tensor compared, each call to TOL_KERNEL of its
    outputs' largest value.  Times the calls as one group each way (and
    ``library(args)``, a callable timed per call, where given)."""
    import torch
    worst = worst_rel = 0.0
    for args, kw in calls:
        a1, a2 = _clone(args), _clone(args)
        r1, r2 = kernel(*a1, **kw), plain(*a2, **kw)
        outs = [(t1, t2) for t1, t2, t0 in zip(a1, a2, args)
                if isinstance(t0, torch.Tensor) and t0.is_floating_point()]
        if isinstance(r1, torch.Tensor):
            outs.append((r1, r2))
        err = max([float((p - q).abs().max()) if p.numel() else 0.0
                   for p, q in outs] + [0.0])
        scale = max([float(q.abs().max()) if q.numel() else 0.0
                     for _, q in outs] + [0.0])
        if not err <= TOL_KERNEL * scale:
            raise AssertionError(f'{name}: kernel vs plain max err {err} '
                                 f'(max {scale})')
        worst = max(worst, err)
        worst_rel = max(worst_rel, err / scale if scale else 0.0)
    ka = [(_clone(a), kw) for a, kw in calls]
    pa = [(_clone(a), kw) for a, kw in calls]
    ms = timed(lambda: [kernel(*a, **kw) for a, kw in ka])
    plain_ms = timed(lambda: [plain(*a, **kw) for a, kw in pa])
    lib = None
    if library is not None:
        fns = [library(a) for a, _ in calls]
        for f in fns:
            f()
        lib = timed(lambda: [f() for f in fns])
    log(f'  {name}: {len(calls)} calls, max abs err {worst:.3e} (rel '
        f'{worst_rel:.3e}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms'
        + (f', library {lib:.4f} ms' if lib is not None else ''))
    return result(worst, ms, plain_ms, [work(a) for a, _ in calls], lib)


def dist_work(args):
    """A K28 phase or a K29 gather on recorded args: every tensor argument
    read once and the written ones (float64) written once; two operations
    per float64 value read (a multiply-add)."""
    import torch
    b = nbytes(args)
    floats = sum(t.numel() for t in _tensorsOf(args)
                 if t.dtype == torch.float64)
    return (b + 8 * floats, 2 * floats, F64_PEAK)


def pack_work(args):
    """K29 pack on recorded args (src, slot): the slots read, the gathered
    rows read and the outbox written once."""
    src, slot = args[0], args[1]
    rows = slot.numel() * src.shape[2] * 8
    return (nbytes(slot) + 2 * rows, 0, F64_PEAK)


def pack_library(args):
    """torch.index_select on the sources padded by one zero row: the
    same outbox as K29's pack."""
    import torch
    src, slot = args[0], args[1]
    nk, P = slot.shape
    ns, S, W = src.shape
    flat = torch.cat([src.reshape(ns * S, W), src.new_zeros(1, W)])
    base = (torch.arange(nk, device=slot.device)[:, None] * S
            if ns > 1 else 0)
    idx = torch.where(slot >= 0, slot.long() + base, ns * S).reshape(-1)
    return lambda: torch.index_select(flat, 0, idx)


def near_library(args):
    """torch.sparse CSR mv on the shards' rows: one block-diagonal CSR
    [nk R, nk (R + B + 1)] applied to the stacked [x, halo, 0]."""
    import torch
    y, xl, buf, ptr, col, dat = args
    nk, R = xl.shape
    B = buf.shape[1]
    w = R + B + 1
    xe = torch.cat([xl, buf.expand(nk, B), xl.new_zeros(nk, 1)], 1) \
        .reshape(-1)
    crow = [torch.zeros(1, dtype=torch.int64, device=ptr.device)]
    cols, vals, base = [], [], 0
    for k in range(nk):
        n = int(ptr[k, -1])
        crow.append(ptr[k, 1:] + base)
        cols.append(torch.clamp(col[k, :n], max=R + B) + k * w)
        vals.append(dat[k, :n])
        base += n
    A = torch.sparse_csr_tensor(torch.cat(crow), torch.cat(cols),
                                torch.cat(vals), size=(nk * R, nk * w))
    return lambda: torch.mv(A, xe)


class StorageRecorder(ArgRecorder):
    """An ArgRecorder that also keeps, per call, the storage (data
    pointer), bytes and type of each tensor argument as the call saw it."""

    def __init__(self, module, name):
        super().__init__(module, name)
        self.storages = []

    def _record(self, args, kw):
        import torch
        self.storages.append([
            (a.data_ptr(), a.numel() * a.element_size(),
             a.dtype == torch.float64)
            for a in args if isinstance(a, torch.Tensor)])
        return super()._record(args, kw)


def record_dist_apply(op, x):
    """Runs one apply of ``op`` with every call of K28's phases and of
    K29's pack recorded: {function name: StorageRecorder}."""
    import contextlib
    import torch
    import pynucleus_tpu_torch.kernels.dist_h2 as kd
    import pynucleus_tpu_torch.kernels.outbox as ko
    with contextlib.ExitStack() as stack:
        recs = {n: stack.enter_context(StorageRecorder(kd, n))
                for n in kd.PLAIN}
        recs['outbox_pack'] = stack.enter_context(
            StorageRecorder(ko, 'outbox_pack'))
        op.matvec(x)
    torch.cuda.synchronize()
    return recs


def apply_work(storageLists):
    """The work of one apply's K28 phases: each distinct storage among the
    calls' tensor arguments (the shard arrays, x and its halo, the level
    coefficients, y) read or written once, two operations per float64
    value (a multiply-add).  A storage that the allocator handed to two
    short-lived tensors counts once: a bound on the low side."""
    seen = {}
    for storages in storageLists:
        for ptr, b, f64 in storages:
            seen[ptr] = (max(b, seen.get(ptr, (0, f64))[0]), f64)
    b = sum(v for v, _ in seen.values())
    floats = sum(v // 8 for v, f64 in seen.values() if f64)
    return (b, 2 * floats, F64_PEAK)


def compare_dist_kernels(Ah, Ab, x):
    """K28 (each phase) and K29's pack against their plain versions on
    the calls of one halo apply (timed: ms per apply) and of one bcast
    apply (held to the same tolerance); the library calls beside: K28's
    near phase against torch.sparse, K29's pack against index_select."""
    import pynucleus_tpu_torch.kernels.dist_h2 as kd
    import pynucleus_tpu_torch.kernels.outbox as ko
    out = {}
    for label, op in (('halo', Ah), ('bcast', Ab)):
        recs = record_dist_apply(op, x)
        parts = []
        for n, plain in kd.PLAIN.items():
            if recs[n].calls:
                parts.append(compare_recorded(
                    f'{n} ({label})', recs[n].calls, getattr(kd, n), plain,
                    dist_work, near_library if n == 'dist_h2_near' else None))
        k28 = merge(*parts)
        k28['work'] = [apply_work([st for n in kd.PLAIN
                                   for st in recs[n].storages])]
        k28['library_ms'] = parts[0]['library_ms']       # the near phase
        k28['library_of'] = 'the near phase: torch.sparse CSR mv'
        k28['phase_ms'] = {n[8:]: p['ms'] for n, p in zip(
            [n for n in kd.PLAIN if recs[n].calls], parts)}
        k29 = compare_recorded(
            f'outbox_pack ({label})', recs['outbox_pack'].calls,
            ko.outbox_pack, lambda src, slot: ko._outbox_pack_plain(src, slot),
            pack_work, pack_library)
        k29['library_of'] = 'torch.index_select on x padded by one zero'
        out[label] = (k28, k29)
    return out


def dist_overlaps(device='cuda'):
    """tests/test_overlaps.py's square (uniformSquare(10) refined, 4 parts)
    on the card: the sharded accumulate (K29 pack and receive-add) and the
    repartition (K29's 2D gather) against the host path (1e-14), and the
    receive-add and the 2D gather against their plain versions on their
    calls.  Returns (cmp of the two, launch counts)."""
    import numpy as np
    import torch
    import pynucleus_tpu_torch.kernels.outbox as ko
    from pynucleus_tpu_torch.fem import uniformSquare, P1_DoFMap
    from pynucleus_tpu_torch.fem.partitioning import regularMeshPartitioner
    from pynucleus_tpu_torch.parallel import overlaps as ov
    from pynucleus_tpu_torch.parallel import makeDeviceMesh
    m = uniformSquare(N=10).refine()
    dm = P1_DoFMap(m, tag=None, device=device)
    cellPart = regularMeshPartitioner(m, 4)
    mesh = makeDeviceMesh(4, device=device)
    bc = m.vertices[m.cells].mean(axis=1)
    tgt = np.minimum((bc[:, 1] * 4).astype(np.int64), 3)
    src, _, rep = ov.repartitionConnector(dm, m, cellPart, tgt)
    mgr = ov.AlgebraicOverlapManager(src)
    rng = np.random.default_rng(DIST_SEED)
    X = rng.standard_normal((4, src.maxLocal))
    with ArgRecorder(ko, 'outbox_recv_add') as ra, \
            ArgRecorder(ko, 'outbox_gather2d') as g2:
        def run():
            acc = mgr.shardmapAccumulate(mesh)(torch.as_tensor(
                X, device=device))
            Xs = src.fromGlobal(rng.standard_normal(dm.num_dofs))
            moved = rep.deviceApply(mesh)(torch.as_tensor(Xs, device=device))
            return acc, Xs, moved
        (acc, Xs, moved), counts = count_path(
            'overlap accumulate and repartition', DIST_OVERLAP_PATH, run)
    e1 = float(np.abs(acc.cpu().numpy() - mgr.accumulate(X)).max())
    e2 = float(np.abs(moved.cpu().numpy() - rep.apply(Xs)).max())
    log(f'  overlaps: accumulate {e1:.3e}, repartition {e2:.3e} from the '
        'host path')
    if not (e1 <= 1e-14 and e2 <= 1e-14):
        raise AssertionError(f'overlaps on the card: {e1}, {e2}')
    cmp = {'recv_add': compare_recorded(
        'outbox_recv_add', ra.calls, ko.outbox_recv_add,
        lambda X_, *a: X_.copy_(ko._outbox_recv_add_plain(X_, *a)),
        dist_work),
        'gather2d': compare_recorded(
        'outbox_gather2d', g2.calls, ko.outbox_gather2d,
        ko._outbox_gather2d_plain, dist_work)}
    return cmp, counts


def dist_dense_bases(device='cuda'):
    """The dense bases on the card, four shards: testDistOp's disc at
    noRef DIST_DENSE_NOREF on a dense base (a path: DistributedRowBlock-
    Operator and DistributedHaloOperator within TOL_DIST of the dense apply,
    the distributed CG converged); shardedDenseAssembly on the dry run's S1
    problem (a path) against the per-pair getDense (1e-12 of the largest
    entry; on the disc the two differ by 1.2e-8 in both packages at noRef
    3) and
    CG-Jacobi on its row-sharded operator to the dry run's bar; the banded
    interval operator (a path): DistributedHaloOperator's halo strips, DistMatrix and Import
    against the dense apply and x, and K29's packs of the halo apply
    against their plain version.  Returns (launch counts per path, the
    packs' comparison, summary)."""
    import numpy as np
    import scipy.sparse as sp
    import torch
    import pynucleus_tpu_torch.kernels.outbox as ko
    from pynucleus_tpu_torch.base.linear_operators import \
        Dense_LinearOperator
    from pynucleus_tpu_torch.drivers import testDistOp
    from pynucleus_tpu_torch.fem import simpleInterval, P1_DoFMap
    from pynucleus_tpu_torch.fem.assembly import assembleRHS
    from pynucleus_tpu_torch.fem.functions import constant
    from pynucleus_tpu_torch.nl.assembly import nonlocalBuilder
    from pynucleus_tpu_torch.nl.kernels import getFractionalKernel
    from pynucleus_tpu_torch.parallel import makeDeviceMesh
    from pynucleus_tpu_torch.parallel.dist import (
        shardedDenseAssembly, rowShardedOperator, distributedSolveStep,
        DistributedHaloOperator)
    from pynucleus_tpu_torch.parallel.maps import (Map, DistVector, Import,
                                                   DistMatrix)
    counts, summary = {}, {}
    t = time.perf_counter()
    out, counts['dense'] = count_path(
        'testDistOp dense disc', DIST_DENSE_PATH,
        lambda: testDistOp.main(
            ['--domain', 'disc', '--s', 'const(0.75)', '--problem',
             'constant', '--noRef', str(DIST_DENSE_NOREF), '--buildDense',
             '--buildDistributedH2Bcast', '--buildDistributedH2',
             '--doSolve', '--ranks', str(DIST_RANKS), '--device', device],
            quiet=True))
    ops, x, dm = out['ops'], out['x'], out['dm']
    kinds = {k: type(ops[k]).__name__ for k in
             ('A_distributed_bcast', 'A_distributed_halo')}
    if kinds != {'A_distributed_bcast': 'DistributedRowBlockOperator',
                 'A_distributed_halo': 'DistributedHaloOperator'}:
        raise AssertionError(f'testDistOp dense: operators {kinds}')
    ref = float(torch.linalg.norm(ops['A_dense'].matvec(x)))
    rel = {k: v / ref for k, v in out['matvec errors'].toDict().items()}
    solve = out['solve'].toDict()
    if not (len(rel) == 2 and all(v <= TOL_DIST for v in rel.values())):
        raise AssertionError(f'testDistOp dense: distributed applies {rel}')
    if not (solve['residual norm'] <= 1e-5
            and solve['CG iterations'] < 1000):
        raise AssertionError(f'testDistOp dense: the distributed CG did not '
                             f'converge: {solve}')
    summary['dense'] = {'dofs': dm.num_dofs, 'rel_errors': rel,
                        'solve': solve, 'timers': out['timers'].toDict(),
                        'seconds': time.perf_counter() - t}
    log(f'  testDistOp dense disc noRef {DIST_DENSE_NOREF}: {dm.num_dofs} '
        f'dofs, relative errors {json.dumps(rel)}, CG '
        f"{solve['CG iterations']} iterations, residual "
        f"{solve['residual norm']:.3e}")
    del out, ops

    # S1: the distant pairs over the shards, then psum; CG-Jacobi (K4) on
    # the row-sharded operator, as the dry run
    t = time.perf_counter()
    m = simpleInterval(-1.0, 1.0).refine()
    for _ in range(DIST_S1_NOREF):
        m = m.refine()
    dmS = P1_DoFMap(m, device=device)
    kernel = getFractionalKernel(1, DIST_S1_S)
    mesh = makeDeviceMesh(DIST_RANKS, device=device)
    b = assembleRHS(dmS, constant(1.0)).data

    def sharded():
        A = shardedDenseAssembly(dmS, kernel, mesh)
        Ash, pad = rowShardedOperator(A, mesh)
        return A, distributedSolveStep(mesh, Ash, b, pad, tol=1e-6,
                                       maxiter=1000)
    (As, (u, its)), counts['sharded_dense'] = count_path(
        'shardedDenseAssembly', DIST_SHARDED_DENSE_PATH, sharded)
    Ad = nonlocalBuilder(dmS, kernel, params={'denseGrid': False}).getDense()
    errS = float((As.data - Ad.data).abs().max())
    scaleS = float(Ad.data.abs().max())
    res = float(torch.linalg.norm(b - As.matvec(u)))
    bn = float(torch.linalg.norm(b))
    if not errS <= 1e-12 * scaleS:
        raise AssertionError(f'shardedDenseAssembly: {errS} off the '
                             f'per-pair getDense (max entry {scaleS})')
    if not (its < 1000 and res < 1e-5 * bn):
        raise AssertionError(f'distributedSolveStep: {its} iterations, '
                             f'residual {res} (|b| {bn})')
    summary['sharded_dense'] = {'dofs': dmS.num_dofs, 'err': errS,
                                'max_entry': scaleS,
                                'cg_iterations': its, 'residual': res,
                                'seconds': time.perf_counter() - t}
    log(f'  shardedDenseAssembly, interval s {DIST_S1_S}: {dmS.num_dofs} '
        f'dofs, {errS:.3e} off the per-pair getDense (max entry '
        f'{scaleS:.3e}); CG-Jacobi on its row shards {its} iterations, '
        f'residual {res:.3e} (|b| {bn:.3e})')
    del As, Ad

    # a banded operator: the halo strips (K29 pack, ppermute), DistMatrix
    # (K9 per part), Import (K29's 2D gather)
    t = time.perf_counter()
    m = simpleInterval(-1.0, 1.0)
    for _ in range(DIST_BANDED_NOREF):
        m = m.refine()
    dmI = P1_DoFMap(m, device=device)
    A = nonlocalBuilder(dmI, getFractionalKernel(
        1, 0.75, horizon=DIST_BANDED_HORIZON)).getDense()
    coords = dmI.getDoFCoordinates()[:, 0]
    order = torch.as_tensor(np.argsort(coords, kind='stable'),
                            device=A.data.device)
    B = Dense_LinearOperator(A.data[order][:, order].contiguous())
    N = B.num_rows
    xB = torch.sin(np.pi * torch.as_tensor(np.sort(coords),
                                           device=A.data.device))
    yRef = B.matvec(xB)
    Bcsr = sp.csr_matrix(B.data.cpu().numpy())
    rowMap = Map.blockDistribution(N, DIST_RANKS)
    cyclic = Map([np.arange(k, N, DIST_RANKS) for k in range(DIST_RANKS)],
                 N)
    with ArgRecorder(ko, 'outbox_pack') as packs:
        def banded():
            halo = DistributedHaloOperator(B, mesh)
            return (halo, halo.matvec(xB),
                    DistMatrix(Bcsr, rowMap, device=device).matvec(xB),
                    Import(rowMap, cyclic)(DistVector.fromGlobal(rowMap, xB)))
        (halo, yH, yM, xC), counts['banded'] = count_path(
            'banded halo, DistMatrix, Import', DIST_BANDED_PATH, banded)
    scale = float(yRef.abs().max())
    eH = float((yH - yRef).abs().max())
    eM = float(np.abs(yM.toGlobal() - yRef.cpu().numpy()).max())
    eI = float(np.abs(xC.toGlobal() - xB.cpu().numpy()).max())
    if halo.fullGather or not 0 < halo.halo < halo.per:
        raise AssertionError(f'banded operator: halo {halo.halo}, block '
                             f'{halo.per}, full gather {halo.fullGather}')
    if not (eH <= TOL_KERNEL * scale and eM <= TOL_KERNEL * scale
            and eI == 0.0):
        raise AssertionError(f'banded operator: halo {eH}, DistMatrix {eM}, '
                             f'Import {eI} (max|Bx| {scale})')
    summary['banded'] = {'dofs': N, 'halo': halo.halo, 'block': halo.per,
                         'err_halo': eH, 'err_dist_matrix': eM,
                         'err_import': eI, 'max_abs_Bx': scale,
                         'seconds': time.perf_counter() - t}
    log(f'  banded interval operator: {N} dofs, halo {halo.halo} of '
        f'blocks of {halo.per}; halo apply {eH:.3e}, DistMatrix {eM:.3e}, '
        f'Import {eI:.3e} off (max|Bx| {scale:.3e})')
    cmp = compare_recorded(
        'outbox_pack (halo strips)', packs.calls, ko.outbox_pack,
        lambda src, slot: ko._outbox_pack_plain(src, slot), pack_work,
        pack_library)
    return counts, cmp, summary


def dist_apply_ms(op, x, reps=10):
    """ms per apply of an operator (CUDA events over ``reps`` applies after
    one untimed)."""
    y = op.matvec(x)
    return timed(lambda: [op.matvec(x, out=y) for _ in range(reps)]) / reps


def phase25():
    """Distribution on one card: testDistOp's disc in H2 over four shards
    (a path), the distributed applies against the H2 one, the distributed
    CG, ms per apply against K8, bytes exchanged, peak memory, K28's and
    K29's launches per apply; the dense bases (dist_dense_bases: three
    paths); runParallelGMG's interval P1 at --ranks 4 (a path) against
    --ranks 1 and the reference cache; dryrunDistributedH2
    at noRef 14 (a path, converged); the overlap accumulate and the
    repartition (a path); then K28 and K29 against their plain versions at
    these calls.  Returns (launch counts per path, comparisons, summary)."""
    import numpy as np
    import torch
    from pynucleus_tpu_torch import kernels
    from pynucleus_tpu_torch.drivers import testDistOp, runParallelGMG
    from pynucleus_tpu_torch.parallel import makeDeviceMesh
    from pynucleus_tpu_torch.parallel.dist_h2 import dryrunDistributedH2
    log(f'phase 25: distribution on one card (testDistOp disc noRef '
        f'{DIST_NOREF} over {DIST_RANKS} shards, the dense bases, '
        'runParallelGMG, the dry run, overlaps)')
    t0 = time.perf_counter()
    counts, summary = {}, {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out, counts['testDistOp'] = count_path(
        'testDistOp disc', DIST_OP_PATH,
        lambda: testDistOp.main(dist_argv(), quiet=True))
    seconds = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for g in ('info', 'matvec errors', 'solve', 'timers'):
        out[g].log()
    ops, x = out['ops'], out['x']
    H, Ah, Ab = ops['A_h2'], ops['A_distributed_halo'], \
        ops['A_distributed_bcast']
    ref = float(torch.linalg.norm(H.matvec(x)))
    errs = out['matvec errors'].toDict()
    rel = {k: v / ref for k, v in errs.items()}
    solve = out['solve'].toDict()
    s = {'dofs': out['dm'].num_dofs, 'seconds': seconds,
         'peak_GiB': peak, 'rel_errors': rel, 'solve': solve,
         'timers': out['timers'].toDict()}
    if not all(v <= TOL_DIST for v in rel.values()):
        raise AssertionError(f'testDistOp: distributed applies {rel}')
    if not (solve['residual norm'] <= 1e-5 and solve['CG iterations'] < 1000):
        raise AssertionError(f'testDistOp: the distributed CG did not '
                             f'converge: {solve}')
    # ms per apply, launches per apply, bytes exchanged per apply
    x = x.contiguous()
    s['ms_per_apply'] = {'K8 h2_matvec': dist_apply_ms(H, x),
                         'halo': dist_apply_ms(Ah, x),
                         'bcast': dist_apply_ms(Ab, x)}
    for label, op in (('halo', Ah), ('bcast', Ab)):
        torch.cuda.synchronize()
        kernels.resetLaunches()
        op.matvec(x)
        torch.cuda.synchronize()
        s[f'launches_per_apply_{label}'] = {
            k: kernels.launches[k] for k in kernels.launches
            if k.startswith(('dist_h2_matvec', 'outbox')) and
            kernels.launches[k]}
        s[f'exchange_bytes_{label}'] = op.exchangeBytes()
    s['operator'] = {'nLvl': Ah._meta['nLvl'], 'M': Ah._meta['M'],
                     'R': Ah.R, 'maxOwn': list(Ah._meta['maxOwn']),
                     'nShr': list(Ah._meta['nShr']),
                     'far_levels': sorted(int(k) for k in Ah._farMeta)}
    summary['testDistOp'] = s
    log(f"  testDistOp: {s['dofs']} dofs, {seconds:.1f} s, peak "
        f"{peak:.3f} GiB, relative errors {json.dumps(rel)}, CG "
        f"{solve['CG iterations']} iterations; ms per apply "
        f"{json.dumps(s['ms_per_apply'])}; launches per halo apply "
        f"{json.dumps(s['launches_per_apply_halo'])}; bytes exchanged per "
        f"halo apply {json.dumps(s['exchange_bytes_halo'])}")
    cmpDist = compare_dist_kernels(Ah, Ab, x)
    del out, ops, H, Ah, Ab
    torch.cuda.empty_cache()

    cD, cmpStrips, summary['dense_bases'] = dist_dense_bases()
    counts.update(cD)
    torch.cuda.empty_cache()

    # runParallelGMG: the interval P1 at its default noRef, 4 ranks (a
    # path) against 1 and the reference cache
    t = time.perf_counter()
    g4, counts['gmg'] = count_path(
        'runParallelGMG --ranks 4', DIST_GMG_PATH,
        lambda: runParallelGMG.main(['--domain', 'interval', '--element',
                                     'P1', '--ranks', str(DIST_RANKS)],
                                    quiet=True))
    g1 = runParallelGMG.main(['--domain', 'interval', '--element', 'P1',
                              '--ranks', '1'], quiet=True)
    h1, h4 = g1['resHist'].toDict(), g4['resHist'].toDict()
    if set(h1) != set(h4) or not all(
            len(h1[k]) == len(h4[k]) and np.allclose(
                h1[k], h4[k], rtol=1e-10, atol=1e-12) for k in h1):
        raise AssertionError(f'runParallelGMG: --ranks 4 {h4} against '
                             f'--ranks 1 {h1}')
    its = g4['iterations'].toDict()
    rates = g4['rates'].toDict()
    errsG = g4['errors'].toDict()
    for label, n in GMG_INTERVAL_CACHE['iterations'].items():
        if its['Number of iterations ' + label] != n:
            raise AssertionError(f'runParallelGMG {label}: {its}')
    for label, r in GMG_INTERVAL_CACHE['rates'].items():
        if not np.isclose(rates['Rate of convergence ' + label], r,
                          atol=1e-2):
            raise AssertionError(f'runParallelGMG {label}: {rates}')
    for label, e in GMG_INTERVAL_CACHE['errors'].items():
        if not np.isclose(errsG[label], e, rtol=4.0):
            raise AssertionError(f'runParallelGMG {label}: {errsG}')
    summary['gmg'] = {'dofs': g4['info'].toDict()['DoFs'],
                      'levels': len(g4['hierarchy']),
                      'sharded_levels': sum(
                          type(A).__name__ == 'DistributedCSROperator'
                          for A in g4['ml'].levels.As),
                      'iterations': its, 'seconds': time.perf_counter() - t,
                      'timers_ranks4': g4['timers'].toDict(),
                      'timers_ranks1': g1['timers'].toDict()}
    log(f"  runParallelGMG interval P1: {summary['gmg']['dofs']} dofs, "
        f"{summary['gmg']['sharded_levels']} of "
        f"{summary['gmg']['levels']} levels sharded, iterations "
        f"{json.dumps(its)}; --ranks 4 repeats --ranks 1's residual "
        'histories')
    del g1, g4

    # the dry run of the distributed H2 (its CG must converge)
    t = time.perf_counter()
    dr, counts['dryrun'] = count_path(
        'dryrunDistributedH2', DIST_DRYRUN_PATH,
        lambda: dryrunDistributedH2(makeDeviceMesh(DIST_RANKS),
                                    noRef=DIST_DRYRUN_NOREF))
    dr['seconds'] = time.perf_counter() - t
    summary['dryrun'] = dr

    cmpOv, counts['overlaps'] = dist_overlaps()
    k28, k29 = cmpDist['halo']
    summary['bcast_kernels'] = {
        'dist_h2_matvec': {'err': cmpDist['bcast'][0]['err'],
                           'ms': cmpDist['bcast'][0]['ms']},
        'outbox': {'err': cmpDist['bcast'][1]['err'],
                   'ms': cmpDist['bcast'][1]['ms']}}
    k28['err'] = max(k28['err'], cmpDist['bcast'][0]['err'])
    k29['err'] = max(k29['err'], cmpDist['bcast'][1]['err'],
                     cmpStrips['err'], cmpOv['recv_add']['err'],
                     cmpOv['gather2d']['err'])
    k29['halo_strips'] = {k: cmpStrips[k] for k in
                          ('err', 'ms', 'plain_ms', 'library_ms')}
    k29['recv_add'] = {k: cmpOv['recv_add'][k] for k in
                       ('err', 'ms', 'plain_ms')}
    k29['gather2d'] = {k: cmpOv['gather2d'][k] for k in
                       ('err', 'ms', 'plain_ms')}
    summary['seconds'] = time.perf_counter() - t0
    log(f'phase 25 summary: {json.dumps(summary)}')
    return counts, {'dist_h2_matvec': k28, 'outbox': k29}, summary


# ----------------------------------------------------------------- phase 26

# the float32 remainder: getSparse, getDiagonal and CG-Jacobi of a finite
# horizon in float32 (runNonlocal's constant kernel, ball2, horizon 0.2, on
# the square with its collar at FH_NOREF, as phase 10: the O(C^2)
# classification, shared by the float32 and float64 builds of one dofmap;
# the interval at FH32_INTERVAL_NOREF), the float32 getDiagonal of phase
# 18's zero-exterior lines, the host engine's float32 getH2 on phase 24's
# disc and DistributedH2Matrix of it over FH32_SHARDS shards
FH32_HORIZON = 0.2
FH32_INTERVAL_NOREF = 9
# the host engine's disc: circle(n=8) refined FH32_HOST_NOREF times (3,969
# dofs), one level below phase 24's, against a block-engine build of the
# same mesh (the host enumeration on phase 24's 16,129 dofs took 42.6 s)
FH32_HOST_NOREF = H2F_NOREF - 1
FH32_SHARDS = 4
TOL_DIST32 = 1e-12        # the float64 distributed apply of a float32 H2
FH32_SPARSE = ('panel_scatter', 'panel_scatter:slots',
               'panel_scatter:float32', 'panel_scatter:float32_indicator')
FH32_CG = ('csr_spmv', 'csr_spmv:float32', 'pcg_update', 'pcg_update:jacobi',
           'pcg_update:float32')
FH32_PATHS = {'square': FH32_SPARSE + ('cut2d_polar',) + FH32_CG,
              'interval': FH32_SPARSE + ('cut1d',) + FH32_CG}
FH32_DIAG_PATH = ('panel_scatter', 'panel_scatter:diag',
                  'panel_scatter:float32', 'panel_scatter:float32_diag')
FH32_HOST_PATH = ('panel_scatter', 'panel_scatter:float32', 'tree_csr_quad',
                  'tree_csr_quad:float32', 'far_field', 'far_field:float32')
FH32_DIST_PATH = ('dist_h2_matvec', 'outbox')
FLOAT32_REM_REPLACES = {
    'panel_scatter:float32_indicator': 'pynucleus_tpu/nl/assembly.py:91',
    'panel_scatter:float32_diag': 'pynucleus_tpu/nl/assembly.py:91',
    'csr_spmv:float32': 'pynucleus_tpu/base/linear_operators.py:310',
    'tree_csr_quad:float32': 'pynucleus_tpu/nl/assembly.py:1118'}
FLOAT32_REM_SOURCES = {
    'panel_scatter:float32_indicator':
        'pynucleus_tpu_torch/kernels/csrc/panel_scatter_f32.cu',
    'panel_scatter:float32_diag':
        'pynucleus_tpu_torch/kernels/csrc/panel_scatter_f32.cu'}
_FH32_SQ = (f'the float32 square (runNonlocal\'s square with its collar at '
            f'noRef {FH_NOREF}, the constant kernel, ball2, horizon '
            f'{FH32_HORIZON})')
FLOAT32_REM_COMPARED_AT = {
    'panel_scatter:float32_indicator': _FH32_SQ + ': the largest bucket of '
    'its getSparse (float32 entries into float64 data)',
    'panel_scatter:float32_diag': 'the float32 getDiagonal of the disc at '
    'noRef 4 (s 0.6, zero exterior): its largest bucket and its largest '
    'bucket with normals (the exterior rows), into the float64 diagonal',
    'csr_spmv:float32': _FH32_SQ + ' and the interval at noRef '
    f'{FH32_INTERVAL_NOREF}: 10 products y = S x with each float32 sparse '
    'operator',
    'tree_csr_quad:float32': f'the float32 host-engine getH2 of the disc '
    f'circle(n=8) refined {FH32_HOST_NOREF} times (3,969 dofs): its largest '
    'call'}


def fh32_setup(domain, noRef):
    """(dm, kernel): runNonlocal's constant kernel (horizon FH32_HORIZON,
    ball2) on nonlocalMesh's domain with its collar refined noRef times,
    P1 on the interior dofs, on the card."""
    from pynucleus_tpu_torch.fem.dofmaps import P1_DoFMap
    from pynucleus_tpu_torch.nl.problems import (nonlocalMesh, processKernel,
                                                 HOMOGENEOUS_DIRICHLET)
    kernel = processKernel(domain, 'constant', 'const(0.4)', FH32_HORIZON)
    mesh, info = nonlocalMesh(domain, kernel, HOMOGENEOUS_DIRICHLET)
    for _ in range(noRef):
        mesh = mesh.refine()
    return P1_DoFMap(mesh, tag=info['domain'], device='cuda'), kernel


def fh32_cg(S, b):
    """CG-Jacobi on S (F32_CG_TOL, F32_CG_MAXITER): (u, iterations,
    converged, the relative residual)."""
    import torch
    from pynucleus_tpu_torch.base.solvers import solverFactory
    cg = solverFactory.build('cg-jacobi', A=S, setup=True)
    cg.tolerance = F32_CG_TOL
    cg.maxIter = F32_CG_MAXITER
    f32_tf32_off()
    u = cg.solve(b)
    torch.cuda.synchronize()
    if u.dtype != b.dtype or not bool(torch.isfinite(u).all()):
        raise AssertionError(f'CG-Jacobi: the solution is {u.dtype}')
    res = float(torch.linalg.norm(b - S.matvec(u)) / torch.linalg.norm(b))
    return u, cg.iterations, bool(cg.residuals[-1] <= F32_CG_TOL), res


def fh32_line(domain, noRef, diagonal=False):
    """getSparse in float32 and float64 on one dofmap and kernel (one
    classification), CG-Jacobi on each (b = M 1 in the working type), the
    float32 data and solution against the float64 ones; with ``diagonal``
    the float32 getDiagonal (float64, as the JAX package's) against the
    float32 operator's diagonal (one float32 ulp).  Returns (summary, the
    float32 and float64 operators)."""
    import numpy as np
    import torch
    from pynucleus_tpu_torch.nl.assembly import nonlocalBuilder
    from pynucleus_tpu_torch.fem.assembly import assembleRHS
    from pynucleus_tpu_torch.fem.functions import constant
    dm, kernel = fh32_setup(domain, noRef)
    b64 = assembleRHS(dm, constant(1.0)).data
    out = {'dofs': dm.num_dofs, 'noRef': noRef}
    ops, us = {}, {}
    for dt in ('float32', 'float64'):
        builder = nonlocalBuilder(dm, kernel, params={'dtype': getattr(
            np, dt)})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        S = builder.getSparse()
        torch.cuda.synchronize()
        real = getattr(torch, dt)
        if S.data.dtype != real or not bool(torch.isfinite(S.data).all()):
            raise AssertionError(f'{domain} getSparse ({dt}): '
                                 f'{S.data.dtype} data')
        u, its, conv, res = fh32_cg(S, b64.to(real))
        if not conv:
            raise AssertionError(f'{domain} CG-Jacobi ({dt}) did not '
                                 f'converge in {its} iterations')
        out[dt] = {'getSparse_s': time.perf_counter() - t0,
                   'timers_s': dict(builder.timers), 'nnz': S.nnz,
                   'iterations': its, 'relative_residual': res}
        ops[dt], us[dt] = S, u
    d32, d64 = ops['float32'].data.double(), ops['float64'].data
    out['data_gap'] = float((d32 - d64).abs().max() / d64.abs().max())
    # the float64 line stays for phase 28 (its float32 formats on this mesh)
    KEPT[f'fh32_{domain}'] = (dm, kernel, ops['float64'], us['float64'])
    out['solution_gap'] = float(torch.linalg.norm(us['float32'].double()
                                                  - us['float64'])
                                / torch.linalg.norm(us['float64']))
    if not out['solution_gap'] <= TOL_F32_VS_F64:
        raise AssertionError(f"{domain}: the float32 solution "
                             f"{out['solution_gap']} from the float64 one")
    if diagonal:
        t0 = time.perf_counter()
        D = nonlocalBuilder(dm, kernel, params={
            'dtype': np.float32}).getDiagonal().data
        torch.cuda.synchronize()
        dS = ops['float32'].diagonal.to(D.device)
        d32 = D.float()
        ulp = torch.nextafter(d32.abs(), torch.tensor(
            float('inf'), device=D.device)) - d32.abs()
        out['diagonal'] = {'getDiagonal_s': time.perf_counter() - t0,
                           'dtype': str(D.dtype).split('.')[-1],
                           'ulps_from_sparse': float(
                               ((dS - d32).abs() / ulp).max())}
        if D.dtype != torch.float64 or \
                not bool(((dS - d32).abs() <= ulp).all()):
            raise AssertionError(f"{domain}: the float32 getDiagonal "
                                 f"{out['diagonal']} from the sparse one")
    log(f'  {domain} noRef {noRef} (horizon {FH32_HORIZON}): '
        f'{json.dumps(out)}')
    return out, ops


def fh32_diag_line(domain, noRef):
    """The float32 getDiagonal (float64) of phase 18's zero-exterior line
    against its float64 getDiagonal (kept by phase 18 with its dofmap and
    kernel, whose classification the float32 build reuses; made here when
    phase 18 did not run), TOL_F32_VS_F64 of the largest entry: the float32
    diagonal of s 0.6 moves away from the float64 one with refinement, in
    both packages alike (scripts/f32_diag_gap_jax.py)."""
    import numpy as np
    import torch
    from pynucleus_tpu_torch.nl.assembly import nonlocalBuilder
    kept = KEPT.pop(f'diag64_{domain}', None)
    if kept is None:
        dm, kernel = mf_diag_setup(domain, noRef)
        d64 = nonlocalBuilder(dm, kernel).getDiagonal().data
    else:
        dm, kernel, d64 = kept
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    D = nonlocalBuilder(dm, kernel, params={
        'dtype': np.float32}).getDiagonal().data
    torch.cuda.synchronize()
    out = {'noRef': noRef, 'dofs': dm.num_dofs,
           'getDiagonal_s': time.perf_counter() - t0,
           'dtype': str(D.dtype).split('.')[-1],
           'gap': float((D - d64).abs().max() / d64.abs().max())}
    log(f'  float32 diagonal {domain} noRef {noRef}: {json.dumps(out)}')
    if D.dtype != torch.float64 or not out['gap'] <= TOL_F32_VS_F64:
        raise AssertionError(f'float32 diagonal {domain}: {out}')
    return out


def fh32_host_line(x):
    """The float32 getH2 with nearEngine='host' on the disc at
    FH32_HOST_NOREF: build seconds, its apply on x against the float32
    block-engine operator of the same mesh, relative to max|y|.  Returns
    (summary, the host-engine operator)."""
    import numpy as np
    import torch
    from pynucleus_tpu_torch.nl.kernels import getFractionalKernel
    from pynucleus_tpu_torch.nl.assembly import nonlocalBuilder
    dm = h2f_dm('disc', FH32_HOST_NOREF)
    kernel = getFractionalKernel(2, F32_S)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b = nonlocalBuilder(dm, kernel, params={'dtype': np.float32,
                                            'nearEngine': 'host'})
    H = b.getH2()
    torch.cuda.synchronize()
    build = time.perf_counter() - t0
    block = nonlocalBuilder(dm, kernel, params={'dtype': np.float32}).getH2()
    if H.dtype != torch.float32:
        raise AssertionError(f'host engine float32: a {H.dtype} operator')
    yb = block.matvec(x)
    gap = float((H.matvec(x) - yb).abs().max() / yb.abs().max())
    out = {'dofs': dm.num_dofs, 'build_s': build, 'timers_s': b.timers,
           'near_nnz': H.Anear.nnz, 'vs_block_engine': gap}
    log(f'  host engine float32 getH2: {json.dumps(out)}')
    if not gap <= TOL_F32:
        raise AssertionError(f'host engine float32: {gap} from the block '
                             'engine')
    return out, H


def fh32_dist_line(H, x, bcast):
    """DistributedH2Matrix of the float32 H over FH32_SHARDS shards on the
    card: a float64 apply of the float32 x, against K8's float64 apply of
    H's coefficients upcast (H.double()), relative 2-norm."""
    import torch
    from pynucleus_tpu_torch.parallel import makeDeviceMesh
    from pynucleus_tpu_torch.parallel import DistributedH2Matrix
    t0 = time.perf_counter()
    A = DistributedH2Matrix(H, makeDeviceMesh(FH32_SHARDS, device='cuda'),
                            bcast=bcast)
    setup = time.perf_counter() - t0
    y = A.matvec(x)
    ref = H.double().matvec(x.double())
    rel = float(torch.linalg.norm(y - ref) / torch.linalg.norm(ref))
    out = {'setup_s': setup, 'dtype': str(y.dtype).split('.')[-1],
           'vs_upcast_h2': rel}
    log(f"  DistributedH2Matrix ({'bcast' if bcast else 'halo'}) of the "
        f'float32 H2: {json.dumps(out)}')
    if y.dtype != torch.float64 or not rel <= TOL_DIST32:
        raise AssertionError(f'distributed float32 H2: {out}')
    return out


def compare_csr_spmv_f32(pairs, reps=10):
    """K9's float32 instance on the float32 sparse operators (each with
    its float64 twin of the same pattern): y = S x against the plain
    version (TOL_F32 of max|y|), then ``reps`` products each way, through
    the float64 instance on the twin and through one float32 torch.sparse
    CSR product (the library's yardstick, never used by the port), after
    an untimed call of each.  Returns the result() with float64_ms."""
    import torch
    from pynucleus_tpu_torch.base.linear_operators import (csr_spmv,
                                                           _csr_spmv_plain)
    g = torch.Generator('cuda').manual_seed(26)
    worst = ms = ms64 = plain_ms = lib_ms = 0.0
    work = []
    for S, S64 in pairs:
        x = torch.randn(S.num_columns, dtype=torch.float32, device='cuda',
                        generator=g)
        x64 = x.double()
        args = (S.indptr, S.indices, S.data, x)
        args64 = (S64.indptr, S64.indices, S64.data, x64)
        yk = csr_spmv(*args)
        yp = _csr_spmv_plain(*args, torch.empty_like(yk))
        err = float((yk - yp).abs().max())
        scale = float(yp.abs().max())
        if not (scale > 0 and err <= TOL_F32 * scale):
            raise AssertionError(f'csr_spmv (float32): max err {err} (max '
                                 f'{scale})')
        worst = max(worst, err)
        L = torch.sparse_csr_tensor(S.indptr, S.indices, S.data,
                                    size=S.shape)
        yl = torch.mv(L, x)
        y64 = csr_spmv(*args64)
        ms += timed(lambda: [csr_spmv(*args, out=yk)
                             for _ in range(reps)]) / reps
        ms64 += timed(lambda: [csr_spmv(*args64, out=y64)
                               for _ in range(reps)]) / reps
        plain_ms += timed(lambda: [_csr_spmv_plain(*args, yp)
                                   for _ in range(reps)]) / reps
        lib_ms += timed(lambda: [torch.mv(L, x) for _ in range(reps)]) / reps
        if not float((yl - yk).abs().max()) <= TOL_F32 * scale:
            raise AssertionError('csr_spmv (float32): the library product '
                                 'differs')
        work.append((nbytes(*args) + x.element_size() * S.num_rows,
                     2 * S.nnz, F32_PEAK))
    log(f'  csr_spmv (float32): {len(pairs)} operators, max abs err '
        f'{worst:.3e}, kernel {ms:.4f} ms (float64 {ms64:.4f}), plain '
        f'{plain_ms:.4f} ms, torch.sparse {lib_ms:.4f} ms per set of '
        'products')
    out = result(worst, ms, plain_ms, work, lib_ms)
    out['float64_ms'] = ms64
    return out


def phase26():
    """The float32 remainder: the square's float32 getSparse (K1's float32
    instance into float64 data with the indicator, K15 in float64),
    CG-Jacobi (K9's and K4's float32 instances) and getDiagonal against
    the float64 ones (a path); the interval's at noRef FH32_INTERVAL_NOREF
    (K14, a path); the float32 getDiagonal of phase 18's lines (a path
    each); the host engine's float32 getH2 on phase 24's disc (K13's
    float32 instance, a path) and DistributedH2Matrix of it in halo and
    bcast mode (the float64 K28 and K29, a path each); then each new
    float32 instance against its float32 plain version at these calls
    (TOL_F32 of the largest entry) with the same calls' float64 time.
    Returns (launch counts per path, comparisons, summary)."""
    import contextlib
    import functools
    import torch
    import pynucleus_tpu_torch.nl.assembly as asm
    log('phase 26: the float32 remainder (getSparse, getDiagonal, CG on the '
        'sparse operator, the host engine, the distributed apply)')
    t0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    counts, summary, cmp = {}, {}, {}
    def f32Size(normals=False):
        """The size of a K1 call by its pairs: the float32 tables' calls
        alone (with ``normals``, those with normals alone), -1 for the
        others (never kept)."""
        def size(out, v, vi1, vi2, index, vs, nm, *a):
            ok = v.dtype == torch.float32 and (nm is not None or not normals)
            return vi1.shape[0] if ok else -1
        return size
    with ArgRecorder(asm, 'panel_scatter_slots', dataFirst=True,
                     size=f32Size()) as k1s:
        (summary['square'], sq), counts['square'] = count_path(
            'float32 square', FH32_PATHS['square'],
            lambda: fh32_line('square', FH_NOREF, diagonal=True))
    (summary['interval'], iv), counts['interval'] = count_path(
        'float32 interval', FH32_PATHS['interval'],
        lambda: fh32_line('interval', FH32_INTERVAL_NOREF))
    with contextlib.ExitStack() as stack:
        diagRecs = [stack.enter_context(ArgRecorder(
            asm, 'panel_scatter_diag', dataFirst=True, size=f32Size(nm)))
            for nm in (False, True)]
        for domain, noRef in MF_DIAG_LINES:
            key = f'diag_{domain}'
            summary[key], counts[key] = count_path(
                f'float32 diagonal {domain}', FH32_DIAG_PATH,
                lambda: fh32_diag_line(domain, noRef))
    x = torch.randn(h2f_dm('disc', FH32_HOST_NOREF).num_dofs,
                    dtype=torch.float32,
                    device='cuda',
                    generator=torch.Generator('cuda').manual_seed(H2F_SEED))
    with ArgRecorder(asm, 'tree_csr_quad', dataFirst=True,
                     size=lambda data, c1, *a: c1.shape[0]) as k13:
        (summary['host'], H), counts['host'] = count_path(
            'float32 host engine', FH32_HOST_PATH,
            lambda: fh32_host_line(x))
    for bcast in (False, True):
        key = 'dist_bcast' if bcast else 'dist_halo'
        summary[key], counts[key] = count_path(
            f'distributed float32 H2 ({key})', FH32_DIST_PATH,
            lambda: fh32_dist_line(H, x, bcast))
    del H
    torch.cuda.empty_cache()

    log('  the float32 instances against their plain versions (1e-5 of the '
        'largest entry), and the same calls in float64')
    F32W = dict(peak=F32_PEAK)
    for name, calls, n, work, dtype, csr in (
            ('panel_scatter:float32_indicator', k1s.calls,
             'panel_scatter_slots', panel_work, torch.float64, True),
            ('panel_scatter:float32_diag',
             diagRecs[0].calls + diagRecs[1].calls, 'panel_scatter_diag',
             panel_work_dof, torch.float64, False),
            ('tree_csr_quad:float32', k13.calls, 'tree_csr_quad',
             functools.partial(tree_quad_work, entryBytes=8), torch.float32,
             True)):
        if not calls:
            raise AssertionError(f'{n}: phase 26 made no call of it')
        kernel, plain = getattr(asm, n), getattr(asm, '_' + n + '_plain')
        cmp[name] = compare_target_kernel(
            name, calls, kernel, plain, functools.partial(work, **F32W),
            dtype=dtype, csr=csr, tol=TOL_F32)
        cmp[name]['float64_ms'] = float64_ms(calls, kernel)
        log(f'    the same calls in float64: {cmp[name]["float64_ms"]:.3f} '
            'ms')
    cmp['csr_spmv:float32'] = compare_csr_spmv_f32(
        [(sq['float32'], sq['float64']), (iv['float32'], iv['float64'])])
    summary['seconds'] = time.perf_counter() - t0
    log(f'phase 26 summary: {json.dumps(summary)}')
    return counts, cmp, summary


def FLOAT32_REM_26_PATHS(counts26):
    """The main paths of phase 26: (kernels, label, launch counts)."""
    paths = {'square': FH32_PATHS['square'],
             'interval': FH32_PATHS['interval'], 'host': FH32_HOST_PATH,
             'dist_halo': FH32_DIST_PATH, 'dist_bcast': FH32_DIST_PATH}
    return tuple((paths.get(key, FH32_DIAG_PATH), f'float32_{key}', c)
                 for key, c in counts26.items())



# ---------------------------------------------------------------- phase 27

# JAX package outputs (scripts/pin_varorder_h2_jax.py, run on the CPU in
# float64): on runFractional's interval at noRef VH2_PIN_NOREF (511 dofs;
# fe at VH2_FE_NOREF, 15 dofs), x = numpy default_rng(VH2_SEED)
# standard_normal(N), the gaps max|H x - D x| / max|D x| of the H2 apply
# and of the transposed apply against the dense operator of the same
# kernel: getH2Vector of leftRight(0.25, 0.75, 0.4, 0.6) derivative 1
# against getDenseVector, per component; getH2 of the orders of position
# against getDense.  Each port gap is held to |gap - pin| <= TOL_VH2_REL
# pin + TOL_VH2_ABS.
JAX_VARORDER_H2 = {
    'LR4-d1': {'apply': [5.60588738856365e-07, 1.5345432004069005e-07,
                         1.9129346083200515e-06, 2.515224496778948e-06],
               'transposed': [5.605887387929001e-07, 1.5345432162195289e-07,
                              4.5678843502527985e-07,
                              5.116918448683324e-07]},
    'innerOuter': {'apply': 2.270628209755678e-07,
                   'transposed': 2.270628211900415e-07},
    'innerOuter_sio': {'apply': 2.2695103086086474e-07,
                       'transposed': 2.2709112331712752e-07},
    'islands': {'apply': 0.024762394856380068,
                'transposed': 0.024762394856379617},
    'islands_sio': {'apply': 0.018873829100256256,
                    'transposed': 0.01887362659396562},
    'layers': {'apply': 0.00702783818578188,
               'transposed': 0.007027838185781868},
    'fe': {'apply': 7.573992384217347e-05,
           'transposed': 8.314771823762246e-05}}
TOL_VH2_REL = 1e-6
TOL_VH2_ABS = 1e-12
VH2_SEED = 27
VH2_PIN_NOREF = 8
# getH2Vector at full width (4 components), cut from phase 13's 12 (8,191
# dofs, where its build, the dense stack's and a component's dense build
# took 17.1, 19.1 and 19.5 s of a 90.7 s phase and the script 1,110.3 s of
# its 1,200 s on an H100 80GB HBM3 at 700 W): 4,095 dofs
VH2_NOREF = 11
# the orders of position at full width, cut from 12: at 8,191 dofs their
# five dense operators' O(C^2) classifications and builds took 7-17 s each
# (H100 80GB HBM3, 700 W), and GMRES-Jacobi did not converge in 500 steps
VH2_ORDERS_NOREF = 10
VH2_FE_NOREF = 3        # the largest interval of the JAX fe order's H2
VH2_LINE = (0.25, 0.75, 0.4, 0.6)
VH2_GMRES_TOL = 1e-8    # relative to ||b||
VH2_GMRES_MAXITER = 3000   # one cycle
# the orders of position (the port's order strings; fe the interpolant of
# 0.5 + 0.3 x clipped to [0.2, 0.8], scripts/pin_varorder_h2_jax.py)
VH2_ORDERS = {
    'innerOuter': 'innerOuter(1,0.75,0.25,0.5)',
    'innerOuter_sio': 'innerOuter(1,0.75,0.25,0.5,sio=0.4,soi=0.6)',
    'islands': 'islands(0.3,0.7)',
    'islands_sio': 'islands(0.3,0.7,sio=0.4,soi=0.6)',
    'layers': 'layers(1,3,-1,-0.3,0.4,1,0.2,0.3,0.4,0.3,0.5,0.6,0.4,0.6,0.7)',
    'fe': None}
VH2_FE = (0.5, 0.3, 0.2, 0.8)   # fe's values a + b x, smin, smax
VH2_VEC_PATH = ('panel_scatter', 'panel_scatter:tree', 'panel_scatter:log',
                'panel_scatter:component', 'panel_scatter_nonsym',
                'panel_scatter_nonsym:slots', 'panel_scatter_nonsym:log',
                'panel_scatter_nonsym:component', 'far_field',
                'far_field:component', 'h2_matvec', 'h2_matvec_T',
                'panel_scatter_vec', 'panel_scatter_nonsym_vec',
                'vector_matvec', 'vector_matvec:apply',
                'vector_matvec:transposed')
VH2_COMP_DENSE_PATH = ('panel_scatter', 'panel_scatter:dense',
                       'panel_scatter:log', 'panel_scatter:component',
                       'panel_scatter_nonsym', 'panel_scatter_nonsym:dense',
                       'panel_scatter_nonsym:log',
                       'panel_scatter_nonsym:component')
VH2_ORDERS_PATH = ('panel_scatter', 'panel_scatter:dense',
                   'panel_scatter:slots', 'panel_scatter:tree',
                   'panel_scatter:position',
                   'panel_scatter_nonsym', 'panel_scatter_nonsym:dense',
                   'panel_scatter_nonsym:slots',
                   'panel_scatter_nonsym:position', 'far_field',
                   'far_field:position', 'h2_matvec', 'h2_matvec_T')
VH2_GMRES_PATH = ('h2_matvec', 'gmres_arnoldi')
VARH2_REPLACES = {
    'panel_scatter:component': 'pynucleus_tpu/nl/assembly.py:91',
    'panel_scatter:position': 'pynucleus_tpu/nl/assembly.py:91',
    'panel_scatter_nonsym:component': 'pynucleus_tpu/nl/assembly.py:424',
    'panel_scatter_nonsym:position': 'pynucleus_tpu/nl/assembly.py:424',
    'far_field:component': 'pynucleus_tpu/nl/assembly.py:744',
    'far_field:position': 'pynucleus_tpu/nl/assembly.py:744'}
VARH2_SOURCES = {
    'panel_scatter:component':
        'pynucleus_tpu_torch/kernels/csrc/panel_scatter_order.cu',
    'panel_scatter:position':
        'pynucleus_tpu_torch/kernels/csrc/panel_scatter_order_h2.cu',
    'panel_scatter_nonsym:component':
        'pynucleus_tpu_torch/kernels/csrc/panel_scatter_nonsym_order.cu',
    'panel_scatter_nonsym:position':
        'pynucleus_tpu_torch/kernels/csrc/panel_scatter_nonsym_order_h2.cu',
    'far_field:component': 'pynucleus_tpu_torch/kernels/csrc/far_field.cu',
    'far_field:position': 'pynucleus_tpu_torch/kernels/csrc/far_field.cu'}


def VARH2_COMPARED_AT(summary):
    """Where phase 27 compared each variant with its plain version."""
    n, no = summary['vector_full']['noRef'], summary['orders_noRef']
    vec = (f'getH2Vector of leftRight{VH2_LINE} derivative 1 on the '
           f'interval at noRef {n}')
    return {
        'panel_scatter:component': f'the largest call of the getDense of '
        f'its component 0 at noRef {n} (the zero-exterior term, with the log '
        f'correction); every call of {vec} into the tree target (the union '
        'surfaces of the four components, with and without the log '
        'correction, with the y shift; the calls of one operator compared '
        'together: the two runs over a jump facet nearly cancel in a slot)',
        'panel_scatter_nonsym:component': f'the largest call of the getDense '
        f'of its component 0 at noRef {n} (dense target) and of {vec} (slot '
        'target), with the log correction',
        'far_field:component': f'the largest far-field call of {vec}',
        'panel_scatter:position': 'the orders of position (innerOuter, '
        f'islands, layers) on the interval at noRef {no}: the largest call '
        'of their getH2s into the slot target (the singular panels of a '
        'symmetric order) and every call into the tree target (the '
        'distant near pairs of a symmetric order, the union surfaces with '
        'and without the y shift; the calls of one operator compared '
        'together)',
        'panel_scatter_nonsym:position': 'the orders of position on the '
        f'interval at noRef {no}: the largest call of their getH2s into the '
        'slot target',
        'far_field:position': 'the orders of position on the interval at '
        f'noRef {no}: the largest far-field call of their getH2s'}


class VariantCallRecorder(ArgRecorder):
    """ArgRecorder of the calls of a K1, K19 or K7 wrapper whose order is
    of one kind: 'component' (ORDER_COMPONENT) or 'position' (an order of
    position); with ``largest`` only the call of the most pairs (blocks
    for K7) is kept."""

    def __init__(self, module, name, kind, largest=False, dataFirst=True):
        self.kind, self.keepLargest = kind, largest
        super().__init__(module, name, dataFirst=dataFirst)

    def __enter__(self):
        from pynucleus_tpu_torch.nl.kernels import (ORDER_COMPONENT,
                                                    ORDER_VARIANTS)
        orig = self.orig

        def rec(*args, **kw):
            order = kw.get('order')
            if order is None and self.name.startswith('panel_scatter_nonsym'):
                order = args[12] if len(args) > 12 else None
            code = None if order is None else int(order.code)
            match = code == ORDER_COMPONENT if self.kind == 'component' \
                else code in ORDER_VARIANTS
            if match:
                size = args[0].shape[0] if self.name == 'far_field' \
                    else args[2].shape[0]
                if not self.keepLargest:
                    self.calls.append(self._record(args, kw))
                elif size > self.largest:
                    self.largest = size
                    self.calls = [self._record(args, kw)]
            return orig(*args, **kw)
        setattr(self.module, self.name, rec)
        return self


def vh2_interval(noRef, spec, **kw):
    """(dofmap, kernel) of runFractional's interval at noRef (simpleInterval
    (-1, 1) refined noRef + 1 times, P1, zero exterior) on the card: the
    order ``spec`` (a string, the leftRight parameters with derivative=,
    or 'fe': VH2_FE's interpolant on the dofmap)."""
    import numpy as np
    from pynucleus_tpu_torch.fem.meshes import simpleInterval
    from pynucleus_tpu_torch.interop import fromArrays
    m = simpleInterval(-1.0, 1.0)
    for _ in range(noRef + 1):
        m = m.refine()
    if spec == 'fe':
        _, dm, _ = fromArrays(m.vertices, m.cells, 0.75, 1, device='cpu')
        dofs = np.asarray(dm.dofs)
        x = np.zeros(dm.num_dofs)
        x[dofs[dofs >= 0]] = np.asarray(m.vertices)[
            np.asarray(m.cells)[dofs >= 0], 0]
        a, b, smin, smax = VH2_FE
        spec = ('fe', a + b * x, smin, smax)
    _, dm, k = fromArrays(m.vertices, m.cells, spec, 1, device='cuda', **kw)
    return dm, k


def vh2_seeded(n):
    import numpy as np
    import torch
    return torch.as_tensor(np.random.default_rng(VH2_SEED).standard_normal(
        n), dtype=torch.float64, device='cuda')


def vh2_gaps(y, ref):
    """max|y - ref| / max|ref| per column of [N, V] (or of [N])."""
    if y.dim() == 1:
        y, ref = y[:, None], ref[:, None]
    scale = ref.abs().amax(0)
    err = (y - ref).abs().amax(0)
    return [float(e / s) if float(s) > 0 else float(e)
            for e, s in zip(err, scale)]


def vh2_check_pins(label, got, pin):
    """Each gap of ``got`` against the JAX gap ``pin`` (lists or
    numbers): |gap - pin| <= TOL_VH2_REL pin + TOL_VH2_ABS."""
    gs = got if isinstance(got, list) else [got]
    ps = pin if isinstance(pin, list) else [pin]
    for g, p in zip(gs, ps):
        if not abs(g - p) <= TOL_VH2_REL * p + TOL_VH2_ABS:
            raise AssertionError(f'{label}: gap {g} vs the JAX gap {p}')
    log(f'  {label}: gaps {gs} = the JAX gaps (|gap - pin| <= '
        f'{TOL_VH2_REL} pin + {TOL_VH2_ABS})')


def vh2_vector_line(noRef, pins=None):
    """getH2Vector and getDenseVector of leftRight VH2_LINE derivative 1 at
    noRef: build seconds (the H2 build's parts summed over the components),
    each component's apply and transposed apply gap (H2 against K23 on
    the dense stack), held to ``pins`` where given.  Returns (summary,
    dofmap, kernel, dense vector operator)."""
    import torch
    from pynucleus_tpu_torch.nl.assembly import nonlocalBuilder
    dm, k = vh2_interval(noRef, VH2_LINE, derivative=1)
    b = nonlocalBuilder(dm, k)
    H, tH = _sync_seconds(b.getH2Vector)
    D, tD = _sync_seconds(nonlocalBuilder(dm, k).getDenseVector)
    x = vh2_seeded(dm.num_dofs)
    (yH, yD), tA = _sync_seconds(lambda: (H.matvec(x), D.matvec(x)))
    (tH2, tD2), tT = _sync_seconds(lambda: (H.matvecTrans(x), D.matvecTrans(x)))
    out = {'noRef': noRef, 'dofs': dm.num_dofs, 'components': k.valueSize,
           'getH2Vector_s': tH, 'h2_parts_s': dict(b.timers),
           'getDenseVector_s': tD,
           'dense_GB': D.data.numel() * 8 / 1e9,
           'apply_gaps': vh2_gaps(yH, yD),
           'transposed_gaps': vh2_gaps(tH2, tD2),
           'applies_s': tA, 'transposed_applies_s': tT}
    for key in ('apply_gaps', 'transposed_gaps'):
        if not all(g == g and g < 1e-3 for g in out[key]):
            raise AssertionError(f'getH2Vector at noRef {noRef}: {out}')
    log(f'  getH2Vector noRef {noRef}: {json.dumps(out)}')
    if pins is not None:
        vh2_check_pins(f'getH2Vector noRef {noRef} apply',
                       out['apply_gaps'], pins['apply'])
        vh2_check_pins(f'getH2Vector noRef {noRef} transposed apply',
                       out['transposed_gaps'], pins['transposed'])
    return out, dm, k, D


def vh2_component_dense(dm, k, D, q=0):
    """getDense of component q of the vector kernel k (K1 and K19 with the
    component order and the log correction) against the component of the
    dense vector operator D (K22, K21): 1e-12 of its largest entry."""
    from pynucleus_tpu_torch.nl.assembly import nonlocalBuilder
    A, t = _sync_seconds(lambda: nonlocalBuilder(
        dm, k.componentKernels()[q]).getDense().data)
    ref = D.data[:, :, q]
    err = float((A - ref).abs().max() / ref.abs().max())
    out = {'component': q, 'getDense_s': t, 'vs_vector_dense': err}
    log(f'  component {q} getDense at {dm.num_dofs} dofs: {json.dumps(out)}')
    if not err <= TOL_KERNEL:
        raise AssertionError(f'component {q} getDense vs getDenseVector: '
                             f'{err}')
    return out


def vh2_order_line(name, noRef, pin=None):
    """getH2 and getDense of the order of position ``name`` at noRef: build
    seconds and parts, the apply and transposed apply gaps, held to the
    JAX gaps ``pin`` where given.  Returns (summary, H2, dense, dofmap)."""
    import torch
    from pynucleus_tpu_torch.nl.assembly import nonlocalBuilder
    dm, k = vh2_interval(noRef, VH2_ORDERS[name] or 'fe')
    b = nonlocalBuilder(dm, k)
    H, tH = _sync_seconds(b.getH2)
    D, tD = _sync_seconds(lambda: nonlocalBuilder(dm, k).getDense().data)
    x = vh2_seeded(dm.num_dofs)
    out = {'order': name, 'noRef': noRef, 'dofs': dm.num_dofs,
           'symmetric': bool(k.symmetric), 'getH2_s': tH,
           'h2_parts_s': dict(b.timers), 'getDense_s': tD,
           'apply_gap': vh2_gaps(H.matvec(x), D @ x)[0],
           'transposed_gap': vh2_gaps(H.T.matvec(x), D.T @ x)[0]}
    log(f'  {name} noRef {noRef}: {json.dumps(out)}')
    if not (out['apply_gap'] < 0.1 and out['transposed_gap'] < 0.1):
        raise AssertionError(f'{name} H2 vs dense: {out}')
    if pin is not None:
        vh2_check_pins(f'{name} noRef {noRef}',
                       [out['apply_gap'], out['transposed_gap']],
                       [pin['apply'], pin['transposed']])
    return out, H, D, dm


def vh2_gmres(H, D, dm):
    """GMRES-Jacobi (one cycle of at most VH2_GMRES_MAXITER steps, to
    VH2_GMRES_TOL ||b||) on the H2 operator and on the dense one, b the
    seeded vector: iterations, seconds, relative residuals and the
    solutions' gap."""
    import torch
    from pynucleus_tpu_torch.base.linear_operators import \
        Dense_LinearOperator
    from pynucleus_tpu_torch.base.solvers import solverFactory
    b = vh2_seeded(dm.num_dofs)
    out, xs = {}, {}
    for label, A in (('H2', H), ('dense', Dense_LinearOperator(D))):
        s = solverFactory.build('gmres-jacobi', A=A, setup=True)
        s.tolerance = VH2_GMRES_TOL * float(torch.linalg.norm(b))
        s.maxIter = VH2_GMRES_MAXITER
        x, t = _sync_seconds(lambda: s.solve(b))
        res = float(torch.linalg.norm(A.matvec(x) - b) / torch.linalg.norm(b))
        if not res <= 10 * VH2_GMRES_TOL:
            raise AssertionError(f'GMRES-Jacobi ({label}): residual {res} '
                                 f'after {s.iterations} iterations')
        out[label] = {'iterations': s.iterations, 'seconds': t,
                      'relative_residual': res}
        xs[label] = x
    out['solution_gap'] = float(torch.linalg.norm(xs['H2'] - xs['dense'])
                                / torch.linalg.norm(xs['dense']))
    log(f'  GMRES-Jacobi on the innerOuter H2 and dense operators: '
        f'{json.dumps(out)}')
    return out


def phase27():
    """The variable-order H2 on the interval: getH2Vector of leftRight
    VH2_LINE derivative 1 (its component kernels through K1 and K19 with
    the log correction and K7 with the component order) against
    getDenseVector at noRef VH2_PIN_NOREF (a path: each component's gap
    against the JAX one) and at noRef VH2_NOREF (a path), the getDense of
    its component 0 there against the stack (a path); the H2 of the orders
    of position (innerOuter and islands, symmetric and not, layers, fe)
    against their dense operators at noRef VH2_PIN_NOREF (fe at
    VH2_FE_NOREF; a path: the gaps against the JAX ones) and at noRef
    VH2_ORDERS_NOREF (a path; fe raises there as the JAX getH2 fails),
    GMRES-Jacobi on innerOuter's H2 and dense operators (a path); then the
    new variants of K1, K19 and K7 against their plain versions at the
    full-width calls.  Returns (launch counts per path, comparisons,
    summary)."""
    import contextlib
    import torch
    import pynucleus_tpu_torch.nl.assembly as asm
    log('phase 27: the variable-order H2 on the interval (getH2Vector of a '
        'multi-parameter order, the orders of position)')
    t0 = time.perf_counter()
    counts, summary, cmp = {}, {}, {}
    (summary['vector_pins'], *_), counts['vector_pins'] = count_path(
        f'getH2Vector noRef {VH2_PIN_NOREF}', VH2_VEC_PATH,
        lambda: vh2_vector_line(VH2_PIN_NOREF, JAX_VARORDER_H2['LR4-d1']))

    # the full width: the component variants' calls recorded
    with contextlib.ExitStack() as stack:
        rTree = stack.enter_context(VariantCallRecorder(
            asm, 'panel_scatter_tree', 'component'))
        r19s = stack.enter_context(VariantCallRecorder(
            asm, 'panel_scatter_nonsym_slots', 'component', largest=True))
        r7 = stack.enter_context(VariantCallRecorder(
            asm, 'far_field', 'component', largest=True, dataFirst=False))
        (summary['vector_full'], dm, k, D), counts['vector_full'] = \
            count_path(f'getH2Vector noRef {VH2_NOREF}', VH2_VEC_PATH,
                       lambda: vh2_vector_line(VH2_NOREF))
    with VariantCallRecorder(asm, 'panel_scatter', 'component',
                             largest=True) as r1d, \
            VariantCallRecorder(asm, 'panel_scatter_nonsym', 'component',
                                largest=True) as r19d:
        summary['component_dense'], counts['component_dense'] = count_path(
            f'component getDense noRef {VH2_NOREF}', VH2_COMP_DENSE_PATH,
            lambda: vh2_component_dense(dm, k, D))
    del D, dm, k
    torch.cuda.empty_cache()

    def orderPins():
        return {name: vh2_order_line(
            name, VH2_FE_NOREF if name == 'fe' else VH2_PIN_NOREF,
            JAX_VARORDER_H2[name])[0] for name in VH2_ORDERS}
    summary['orders_pins'], counts['orders_pins'] = count_path(
        f'the orders of position noRef {VH2_PIN_NOREF}', VH2_ORDERS_PATH,
        orderPins)

    full = {}

    def orderFull():
        out = {}
        for name in VH2_ORDERS:
            if name == 'fe':
                # the JAX getH2 of fe fails beyond 15 dofs; the port refuses
                dmF, kF = vh2_interval(VH2_ORDERS_NOREF, 'fe')
                try:
                    asm.nonlocalBuilder(dmF, kF).getH2()
                except NotImplementedError as e:
                    out['fe_refused'] = str(e)
                    log(f'  fe noRef {VH2_ORDERS_NOREF}: refused ({e})')
                    continue
                raise AssertionError('fe: the H2 beyond 15 dofs built')
            out[name], H, D, dmO = vh2_order_line(name, VH2_ORDERS_NOREF)
            if name == 'innerOuter':
                full['innerOuter'] = (H, D, dmO)
            del H, D
        return out
    with contextlib.ExitStack() as stack:
        rTreeP = stack.enter_context(VariantCallRecorder(
            asm, 'panel_scatter_tree', 'position'))
        rSlotsP = stack.enter_context(VariantCallRecorder(
            asm, 'panel_scatter_slots', 'position', largest=True))
        r19P = stack.enter_context(VariantCallRecorder(
            asm, 'panel_scatter_nonsym_slots', 'position', largest=True))
        r7P = stack.enter_context(VariantCallRecorder(
            asm, 'far_field', 'position', largest=True, dataFirst=False))
        summary['orders_full'], counts['orders_full'] = count_path(
            f'the orders of position noRef {VH2_ORDERS_NOREF}',
            VH2_ORDERS_PATH, orderFull)
    summary['orders_noRef'] = VH2_ORDERS_NOREF
    summary['gmres'], counts['gmres'] = count_path(
        'GMRES-Jacobi on innerOuter', VH2_GMRES_PATH,
        lambda: vh2_gmres(*full.pop('innerOuter')))
    torch.cuda.empty_cache()

    log('  the new variants against their plain versions (1e-12 of the '
        'largest entry)')
    cmp['panel_scatter:component'] = merge(
        compare_target_kernel('panel_scatter (component, log, dense)',
                              r1d.calls, asm.panel_scatter,
                              asm._panel_scatter_plain, panel_order_work),
        compare_target_kernel('panel_scatter (component, tree)',
                              rTree.calls, asm.panel_scatter_tree,
                              asm._panel_scatter_tree_plain,
                              panel_order_work))
    cmp['panel_scatter_nonsym:component'] = merge(
        compare_target_kernel('panel_scatter_nonsym (component, log, dense)',
                              r19d.calls, asm.panel_scatter_nonsym,
                              _k19_plain('dense'), nonsym_work),
        compare_target_kernel('panel_scatter_nonsym (component, log, slots)',
                              r19s.calls, asm.panel_scatter_nonsym_slots,
                              _k19_plain('slots'), nonsym_work))
    cmp['far_field:component'] = compare_far_field(
        r7.calls, 'far_field (component)')
    cmp['panel_scatter:position'] = merge(
        compare_target_kernel('panel_scatter (orders of position, slots)',
                              rSlotsP.calls, asm.panel_scatter_slots,
                              asm._panel_scatter_slots_plain,
                              panel_order_work),
        compare_target_kernel('panel_scatter (orders of position, tree)',
                              rTreeP.calls, asm.panel_scatter_tree,
                              asm._panel_scatter_tree_plain,
                              panel_order_work))
    cmp['panel_scatter_nonsym:position'] = compare_target_kernel(
        'panel_scatter_nonsym (orders of position, slots)', r19P.calls,
        asm.panel_scatter_nonsym_slots, _k19_plain('slots'), nonsym_work)
    cmp['far_field:position'] = compare_far_field(
        r7P.calls, 'far_field (orders of position)')
    summary['seconds'] = time.perf_counter() - t0
    log(f'phase 27 summary: {json.dumps(summary)}')
    return counts, cmp, summary


def VARH2_27_PATHS(counts27):
    """The main paths of phase 27: (kernels, label, launch counts)."""
    paths = {'vector_pins': VH2_VEC_PATH, 'vector_full': VH2_VEC_PATH,
             'component_dense': VH2_COMP_DENSE_PATH,
             'orders_pins': VH2_ORDERS_PATH, 'orders_full': VH2_ORDERS_PATH,
             'gmres': VH2_GMRES_PATH}
    return tuple((paths[key], f'varorder_h2_{key}', c)
                 for key, c in counts27.items())


# ---------------------------------------------------------------- phase 28

# the float32 formats of the finite horizon and the smooth kernels: the
# gaussian kernel of an infinite horizon and the tempered fractional one on
# phase 23's disc (circle(n=8) refined F32_NOREF times, 16,129 dofs:
# bench.py's float32 dense line, on the grid), runNonlocal's constant
# kernel (ball2, horizon FH32_HORIZON) on phase 26's square (noRef
# FH_NOREF) and interval (noRef
# FH32_INTERVAL_NOREF) in getDense, 'sparsified' and (the interval)
# getDenseCross, phase 18's H2corrected line (the interval at noRef
# MF_NOREF), and the gaussian kernel of horizon FH32_HORIZON on phase 26's
# square in getSparse; each in float32 (a path) against the same line in
# float64 (kept from phases 18 and 26 where they ran)
F28_GAUSS_VARIANCE = 0.1    # runNonlocal's --gaussianVariance of its lines
# the float32 operator against the float64 one, of its largest entry (the
# discs' dense operators, the finite horizon's getDense and getDenseCross):
# float32 local entries are each within half an ulp (6e-8), their sums a
# few ulps of the largest entry; 5x the largest gap read on the card (the
# tempered disc's 2.0e-5, PERF.md section 6), and far below what a wrong
# profile, indicator or cut-pair entry gives
F28_OPERATOR_BAR = 1e-4
# the JAX package's own float32 H2corrected gaps to float64 on phase 18's
# interval line (scripts/f32_h2corrected_gap_jax.py --noRef 10, on a CPU;
# the port's there: 1.0219944722086355e-04 and 0.1402988419523544): the
# float32 nodes at |x - y| = delta fall on either side of the complement
# indicator, so the cross operator's ring-cut entries move by 14 % of its
# largest entry in both packages.  Phase 28 holds the port's apply gaps
# within twice the JAX apply gap (tests/test_torch_f32_h2.py's rule for the
# float32 H2) and its cross gap within 1.1 times the JAX one.
F28_H2C_JAX_GAPS = {10: {'apply_gap': 1.0218599616650326e-04,
                         'cross_gap': 0.1402987941288597}}
F28_H2C_CROSS_FACTOR = 1.1
F28_EXTERIOR_NOREF = 4      # the gaussian's zero-exterior line (961 dofs)
F28_DENSE = ('panel_scatter', 'panel_scatter:dense', 'panel_scatter:float32',
             'panel_scatter:float32_horizon')
F28_PATHS = {
    'discs': ('panel_scatter', 'panel_scatter:float32',
              'panel_scatter:float32_profile', 'panel_scatter:float32_rows',
              'grid_distant', 'grid_distant:float32',
              'grid_distant:float32_profile', 'grid_boundary',
              'grid_boundary:float32', 'grid_boundary:float32_profile',
              'pcg_update', 'pcg_update:float32'),
    'square': F28_DENSE + ('cut2d_polar', 'cut2d_polar:float32', 'csr_spmv',
                           'csr_spmv:float32', 'pcg_update',
                           'pcg_update:float32'),
    'interval': F28_DENSE + ('cut1d', 'cut1d:float32', 'panel_scatter:cross',
                             'panel_scatter:float32_cross', 'csr_spmv',
                             'csr_spmv:float32', 'pcg_update',
                             'pcg_update:float32'),
    'h2corrected': ('panel_scatter', 'panel_scatter:float32',
                    'panel_scatter:float32_complement', 'h2_matvec',
                    'h2_matvec:float32', 'far_field:float32', 'csr_spmv',
                    'pcg_update', 'pcg_update:jacobi'),
    'gaussian_sparse': ('panel_scatter', 'panel_scatter:slots',
                        'panel_scatter:float32',
                        'panel_scatter:float32_indicator',
                        'panel_scatter:float32_profile', 'cut2d_polar',
                        'csr_spmv:float32', 'pcg_update:float32')}
F28_64_PATHS = {'discs64': ('panel_scatter', 'panel_scatter:dense',
                             'grid_distant', 'grid_boundary', 'pcg_update')}
F28_REPLACES = {
    'panel_scatter:float32_horizon': 'pynucleus_tpu/nl/assembly.py:91',
    'panel_scatter:float32_cross': 'pynucleus_tpu/nl/assembly.py:91',
    'panel_scatter:float32_complement': 'pynucleus_tpu/nl/assembly.py:91',
    'panel_scatter:float32_profile': 'pynucleus_tpu/nl/assembly.py:91',
    'grid_distant:float32_profile': 'pynucleus_tpu/nl/assembly.py:131',
    'grid_boundary:float32_profile': 'pynucleus_tpu/nl/assembly.py:240',
    'cut1d:float32': 'pynucleus_tpu/nl/assembly.py:644',
    'cut2d_polar:float32': 'pynucleus_tpu/nl/assembly.py:511'}
_CSRC = 'pynucleus_tpu_torch/kernels/csrc/'
F28_SOURCES = {
    'panel_scatter:float32_horizon': _CSRC + 'panel_scatter_f32.cu',
    'panel_scatter:float32_cross': _CSRC + 'panel_scatter_f32.cu',
    'panel_scatter:float32_complement': _CSRC + 'panel_scatter_f32.cu',
    'panel_scatter:float32_profile': _CSRC + 'panel_scatter_f32_profiles.cu',
    'grid_distant:float32_profile': _CSRC + 'grid_distant_f32.cu',
    'grid_boundary:float32_profile': _CSRC + 'grid_boundary.cu',
    'cut1d:float32': _CSRC + 'cut_cells.cu',
    'cut2d_polar:float32': _CSRC + 'cut_cells.cu'}
_F28_DISC = (f'the float32 disc (circle(n=8) refined {F32_NOREF} times, '
             '16,129 dofs, dense on the grid) with the gaussian kernel '
             f'(variance {F28_GAUSS_VARIANCE}, infinite horizon, no exterior '
             'term) and the tempered fractional kernel (s 0.75, lambda '
             f'{TP_LAMBDA}, zero exterior)')
_F28_SMALL = (f'the gaussian kernel with its zero-exterior term on the disc '
              f'at noRef {F28_EXTERIOR_NOREF} (961 dofs)')
F28_COMPARED_AT = {
    'panel_scatter:float32_horizon': _FH32_SQ + ': the largest bucket of '
    'each shape of its float32 getDense (float32 entries with the indicator '
    'into a float32 A)',
    'panel_scatter:float32_cross': 'the float32 getDenseCross of the '
    f'interval at noRef {FH32_INTERVAL_NOREF} (horizon {FH32_HORIZON}): the '
    'largest bucket of each shape, into the float64 A_BC',
    'panel_scatter:float32_complement': 'the float32 H2corrected of the '
    f'interval at noRef {MF_NOREF} (s {MF_S}, horizon {MF_DELTA}): the '
    'largest bucket of each shape of its complement cross operator, into a '
    'float64 dense A with the block mask',
    'panel_scatter:float32_profile': _F28_DISC + ' and ' + _F28_SMALL
    + ': the largest bucket of each shape and route (the boundary '
    'profiles\' rows with normals among them), and the float32 getSparse '
    f'of the gaussian kernel of horizon {FH32_HORIZON} on the square: its '
    'largest bucket of each shape, into float64 CSR data',
    'grid_distant:float32_profile': _F28_SMALL + ': all calls, and ' +
    _F28_DISC + ': the first distance window of the gaussian and of the '
    'tempered kernel',
    'grid_boundary:float32_profile': _F28_DISC + ': the tempered kernel\'s '
    'call (the gaussian\'s boundary kernel leaves K3 no pair: every one is '
    'a correction)',
    'cut1d:float32': 'the float32 getDense and sparsified of the interval at '
    f'noRef {FH32_INTERVAL_NOREF} (horizon {FH32_HORIZON}): all calls, '
    'float64 entries into a float32 A, each rounded as it is added',
    'cut2d_polar:float32': _FH32_SQ + ': all calls of its float32 getDense '
    'and sparsified, float64 entries into a float32 A, each rounded as it is '
    'added'}


class LargestRecorder(ArgRecorder):
    """An ArgRecorder (the target recorded by its shape) that keeps, of the
    calls that ``want(args, kw)`` admits, the largest (by its pairs) of each
    key (the target's dtype and shape class, the simplex sizes, nPSI,
    whether it has normals, and the profile's code, tempering and two-point
    weight): the heaviest bucket of each kind and profile, not all."""

    def __init__(self, module, name, want):
        super().__init__(module, name, dataFirst=True)
        self.want = want
        self.kept = {}

    def __enter__(self):
        def rec(*args, **kw):
            if self.want(args, kw):
                vi1, vi2, index = args[2], args[3], args[4]
                prof = _profileOf(args)
                key = (args[0].dtype, args[0].dim(), vi1.shape[1],
                       vi2.shape[1], index.shape[1], args[6] is None,
                       int(prof.code), float(prof.t) != 0.0,
                       int(prof.wcode))
                if vi1.shape[0] > self.kept.get(key, (0, None))[0]:
                    self.kept[key] = (vi1.shape[0], self._record(args, kw))
            return self.orig(*args, **kw)
        setattr(self.module, self.name, rec)
        return self

    def callsOf(self, dtype):
        return [c for k, (_, c) in sorted(self.kept.items(), key=str)
                if k[0] == dtype]


def _f32Args(args, kw):
    """A float32 call (its vertices float32) of a kernel of K1's targets."""
    import torch
    return args[1].dtype == torch.float32


def _profileOf(args):
    """The profile among a K1 call's recorded args."""
    return next(a for a in reversed(args) if hasattr(a, 'wcode'))


def _smoothProfile(args, kw):
    """A float32 call with a profile other than the plain power one."""
    prof = _profileOf(args)
    return _f32Args(args, kw) and (int(prof.code) != 0 or prof.t != 0.0
                                   or int(prof.wcode) != 0)


def f28_cg(A, b, tol=F32_CG_TOL, maxIter=F32_CG_MAXITER):
    """CG-Jacobi on A u = b: (u, iterations, seconds); raises unless it
    converged to a finite u of b's type (the float64 u of H2corrected's
    float64 apply)."""
    import torch
    from pynucleus_tpu_torch.base.solvers import solverFactory
    cg = solverFactory.build('cg-jacobi', A=A, setup=True)
    cg.tolerance, cg.maxIter = tol, maxIter
    f32_tf32_off()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u = cg.solve(b)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if not bool(torch.isfinite(u).all()) or not cg.residuals[-1] <= tol:
        raise AssertionError(f'CG-Jacobi: {cg.iterations} iterations, '
                             f'residual {cg.residuals[-1]}, {u.dtype}')
    return u, cg.iterations, secs


def f28_gap(u32, u64):
    import torch
    return float(torch.linalg.norm(u32.double() - u64)
                 / torch.linalg.norm(u64))


def f28_check(label, out, bars=()):
    """The float32 bars of a line: its solution within TOL_F32_VS_F64 of the
    float64 one, and each (key, bar) of ``bars`` (an operator's or an
    apply's gap to float64) at or under its bar."""
    log(f'  {label}: {json.dumps(out)}')
    for key, bar in (('solution_gap', TOL_F32_VS_F64),) + tuple(bars):
        if not out[key] <= bar:
            raise AssertionError(f'{label}: {key} {out[key]} over {bar}')
    return out


def f28_disc(dtype, dm, kernel, zeroExterior):
    """getDense of ``kernel`` on the disc dm in ``dtype`` (on the grid) and
    CG-Jacobi (b = M 1 in its type): (summary, (A, u))."""
    import numpy as np
    import torch
    from pynucleus_tpu_torch.nl.assembly import nonlocalBuilder
    from pynucleus_tpu_torch.fem.assembly import assembleRHS
    from pynucleus_tpu_torch.fem.functions import constant
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    A = nonlocalBuilder(dm, kernel, params={'dtype': dtype},
                        zeroExterior=zeroExterior).getDense()
    torch.cuda.synchronize()
    build = time.perf_counter() - t0
    real = torch.float32 if dtype == np.float32 else torch.float64
    if A.data.dtype != real or not bool(torch.isfinite(A.data).all()):
        raise AssertionError(f'disc: a {A.data.dtype} operator')
    b = assembleRHS(dm, constant(1.0)).data.to(real)
    u, its, secs = f28_cg(A, b)
    return {'dofs': dm.num_dofs, 'getDense_s': build, 'iterations': its,
            'cg_s': secs}, (A, u)


def f28_disc_lines(dtype):
    """The disc lines of phase 28 in ``dtype``: the gaussian kernel of an
    infinite horizon on phase 23's disc (16,129 dofs) without the
    zero-exterior term (its boundary kernel takes every surface pair as a
    correction through K1: 16.7 million pairs, 13 s a dtype on the card)
    and with it on the disc at F28_EXTERIOR_NOREF, and the tempered
    fractional kernel on phase 23's disc with the zero-exterior term (K3
    with its boundary profile): {line: (summary, (A, u))}."""
    import numpy as np
    from pynucleus_tpu_torch.nl.kernels import (getIntegrableKernel,
                                                FractionalKernel)
    gaussian = getIntegrableKernel(2, 'gaussian', np.inf,
                                   gaussian_variance=F28_GAUSS_VARIANCE)
    from pynucleus_tpu_torch.fem.meshes import circle
    full = f32_disc_mesh()
    small = tp_dm(tp_refined(circle(n=8), F28_EXTERIOR_NOREF))
    return {'gaussian': f28_disc(dtype, full, gaussian, False),
            'gaussian_exterior': f28_disc(dtype, small, gaussian, True),
            'tempered': f28_disc(dtype, full, FractionalKernel(
                2, F32_S, temperedLambda=TP_LAMBDA), True)}


def f28_finite(domain, noRef, cross=False):
    """runNonlocal's constant kernel on phase 26's mesh of ``domain``: the
    float32 getDense (K1's float32 instance with the indicator, the cut
    pairs in float64 added with one rounding) and 'sparsified' (its
    nonzero entries, float32 CSR: equal to the dense entries), CG-Jacobi
    on the sparsified operator (K9 and K4 in float32) against phase 26's
    float64 getSparse and its solve (made here when phase 26 did not run);
    with ``cross`` getDenseCross in float32 (float64, K1's float32 entries
    into A_BC) against the float64 one."""
    import numpy as np
    import torch
    from pynucleus_tpu_torch.nl.assembly import nonlocalBuilder
    from pynucleus_tpu_torch.fem.assembly import assembleRHS
    from pynucleus_tpu_torch.fem.functions import constant
    kept = KEPT.pop(f'fh32_{domain}', None)
    if kept is None:
        dm, kernel = fh32_setup(domain, noRef)
        S64 = nonlocalBuilder(dm, kernel).getSparse()
        b64 = assembleRHS(dm, constant(1.0)).data
        u64, _, _ = f28_cg(S64, b64)
    else:
        dm, kernel, S64, u64 = kept
    out = {'dofs': dm.num_dofs, 'noRef': noRef}
    f32 = {'dtype': np.float32}
    t0 = time.perf_counter()
    A = nonlocalBuilder(dm, kernel, params=f32).getDense()
    torch.cuda.synchronize()
    out['getDense_s'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    Ssp = nonlocalBuilder(dm, kernel, params=f32).getDense(
        trySparsification=True)
    torch.cuda.synchronize()
    out['sparsified_s'] = time.perf_counter() - t0
    if A.data.dtype != torch.float32 or Ssp.data.dtype != torch.float32 \
            or not hasattr(Ssp, 'indptr'):
        raise AssertionError(f'{domain}: float32 getDense {A.data.dtype}, '
                             f'sparsified {type(Ssp).__name__}')
    D64 = csr_to_dense(S64, A.data.double())
    out['dense_gap'] = float((A.data.double() - D64).abs().max()
                             / D64.abs().max())
    Dsp = csr_to_dense(Ssp, A.data.double())
    out['sparsified_vs_dense'] = float((Dsp - A.data.double()).abs().max()
                                       / A.data.abs().max())
    out['sparsified_nnz'] = Ssp.nnz
    if out['sparsified_vs_dense'] > TOL_F32:
        raise AssertionError(f'{domain}: sparsified {out} off the dense')
    b = assembleRHS(dm, constant(1.0)).data.float()
    u, its, secs = f28_cg(Ssp, b)
    out.update(iterations=its, cg_s=secs, solution_gap=f28_gap(u, u64))
    if cross:
        t0 = time.perf_counter()
        C32 = nonlocalBuilder(dm, kernel, params=f32).getDenseCross()
        torch.cuda.synchronize()
        out['getDenseCross_s'] = time.perf_counter() - t0
        C64 = nonlocalBuilder(dm, kernel).getDenseCross()
        if C32.data.dtype != torch.float64:
            raise AssertionError(f'float32 getDenseCross: {C32.data.dtype}')
        out['cross_gap'] = float((C32.data - C64.data).abs().max()
                                 / C64.data.abs().max())
    return f28_check(f'float32 {domain} (getDense, sparsified'
                     + (', getDenseCross' if cross else '') + ')', out,
                     (('dense_gap', F28_OPERATOR_BAR),)
                     + ((('cross_gap', F28_OPERATOR_BAR),) if cross else ()))


def f28_h2corrected():
    """Phase 18's H2corrected line in float32: S_inf the float32 getH2, the
    complement cross operator float64 from float32 entries (K1 code 5 with
    the block mask), the apply float64; CG-Jacobi (MF_CG_TOL) on A x = M 1
    against phase 18's float64 operator (made here when phase 18 did not
    run) and its solve; the applies' gap on a cosine."""
    import numpy as np
    import torch
    from pynucleus_tpu_torch.nl.assembly import nonlocalBuilder
    kept = KEPT.pop('h2c64_interval', None)
    if kept is None:
        dm, kernel = mf_setup('interval', MF_NOREF)
        A64 = nonlocalBuilder(dm, kernel).getH2FiniteHorizon()
    else:
        dm, kernel, A64 = kept
    t0 = time.perf_counter()
    b = nonlocalBuilder(dm, kernel, params={'dtype': np.float32})
    A = b.getH2FiniteHorizon()
    torch.cuda.synchronize()
    out = {'noRef': MF_NOREF, 'dofs': A.num_rows,
           'build_s': time.perf_counter() - t0, 'parts_s': dict(b.timers)}
    if A.Sinf.dtype != torch.float32 or A.Cross.data.dtype != torch.float64:
        raise AssertionError(f'float32 H2corrected: S_inf {A.Sinf.dtype}, '
                             f'Cross {A.Cross.data.dtype}')
    x = _cos(A.num_rows)
    y, y64 = A.matvec(x), A64.matvec(x)
    y32 = A.matvec(x.float())
    if y.dtype != torch.float64 or y32.dtype != torch.float64:
        raise AssertionError(f'float32 H2corrected: apply {y.dtype}, '
                             f'{y32.dtype}')
    out['apply_gap'] = float((y - y64).abs().max() / y64.abs().max())
    out['apply_gap_float32_x'] = float((y32 - y64).abs().max()
                                       / y64.abs().max())
    out['cross_gap'] = float((A.Cross.data - A64.Cross.data).abs().max()
                             / A64.Cross.data.abs().max())
    rhs = A64.mass.matvec(torch.ones_like(x))
    u, its, secs = f28_cg(A, rhs, MF_CG_TOL, 5000)
    u64, its64, secs64 = f28_cg(A64, rhs, MF_CG_TOL, 5000)
    out.update(iterations=its, iterations64=its64, cg_s=secs, cg64_s=secs64,
               solution_gap=f28_gap(u, u64))
    jax = F28_H2C_JAX_GAPS[MF_NOREF]
    return f28_check(f'float32 H2corrected interval noRef {MF_NOREF}', out,
                     (('apply_gap', 2.0 * jax['apply_gap']),
                      ('apply_gap_float32_x', 2.0 * jax['apply_gap']),
                      ('cross_gap',
                       F28_H2C_CROSS_FACTOR * jax['cross_gap'])))


def f28_gaussian_sparse():
    """getSparse of the gaussian kernel of horizon FH32_HORIZON on phase
    26's square in float32 and float64 (one classification: the same
    dofmap and kernel), CG-Jacobi on each (b = M 1)."""
    import numpy as np
    import torch
    from pynucleus_tpu_torch.nl.assembly import nonlocalBuilder
    from pynucleus_tpu_torch.nl.kernels import getIntegrableKernel
    from pynucleus_tpu_torch.fem.assembly import assembleRHS
    from pynucleus_tpu_torch.fem.functions import constant
    dm, _ = fh32_setup('square', FH_NOREF)
    kernel = getIntegrableKernel(2, 'gaussian', FH32_HORIZON,
                                 gaussian_variance=F28_GAUSS_VARIANCE)
    out, us = {'dofs': dm.num_dofs}, {}
    for dt in ('float32', 'float64'):
        t0 = time.perf_counter()
        S = nonlocalBuilder(dm, kernel, params={
            'dtype': getattr(np, dt)}).getSparse()
        torch.cuda.synchronize()
        real = getattr(torch, dt)
        if S.data.dtype != real:
            raise AssertionError(f'gaussian getSparse ({dt}): '
                                 f'{S.data.dtype}')
        b = assembleRHS(dm, constant(1.0)).data.to(real)
        us[dt], its, secs = f28_cg(S, b)
        out[dt] = {'getSparse_s': time.perf_counter() - t0, 'nnz': S.nnz,
                   'iterations': its, 'cg_s': secs}
    out['solution_gap'] = f28_gap(us['float32'], us['float64'])
    return f28_check('float32 gaussian getSparse square', out)


def phase28():
    """The float32 formats of the finite horizon and the smooth kernels:
    the gaussian kernel's getDense on the disc in float32 (a path: K1, K2
    and K3's float32 instances with the profile switch) and float64 (a
    path), CG-Jacobi on each; runNonlocal's constant kernel on phase 26's
    square and interval in float32 getDense and 'sparsified' (K1 with the
    indicator into a float32 A, the cut pairs' float64 matrices added with
    one rounding) and on the interval getDenseCross (K1 into the float64
    A_BC), CG-Jacobi on the sparsified operator, against phase 26's float64
    getSparse and solve (a path each); phase 18's H2corrected line in
    float32 (the float32 getH2, K1 code 5 into the float64 cross operator;
    a path) against its float64 operator, CG-Jacobi on each; the gaussian
    kernel of a finite horizon in float32 getSparse (K1's float32 entries
    with the profile into float64 data) and float64, CG-Jacobi on each (a
    path); each float32 solution within TOL_F32_VS_F64 of the float64 one.
    Then each new float32 instance against its plain version at the largest
    recorded call of each kind, each call into a target of its own (1e-5
    of its largest entry), with the same calls' float64 time.  Returns (launch counts per path, comparisons,
    summary)."""
    import contextlib
    import numpy as np
    import torch
    import pynucleus_tpu_torch.nl.assembly as asm
    log('phase 28: the float32 formats of the finite horizon and the smooth '
        'kernels (getDense of a finite horizon, sparsified, getDenseCross, '
        'H2corrected; the gaussian kernel)')
    t0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    counts, summary, cmp = {}, {}, {}
    secs = summary['path_s'] = {}

    def path(key, label, fn):
        """count_path of F28_PATHS[key] (or F28_64_PATHS), timed."""
        t1 = time.perf_counter()
        out, counts[key] = count_path(
            label, dict(F28_PATHS, **F28_64_PATHS)[key], fn)
        secs[key] = time.perf_counter() - t1
        return out
    with contextlib.ExitStack() as stack:
        k1p = stack.enter_context(LargestRecorder(asm, 'panel_scatter',
                                                  _smoothProfile))
        k2 = stack.enter_context(ArgRecorder(asm, 'grid_distant',
                                             dataFirst=True))
        k3 = stack.enter_context(ArgRecorder(asm, 'grid_boundary',
                                             dataFirst=True))
        d32 = path('discs', 'float32 discs',
                   lambda: f28_disc_lines(np.float32))
    # K2 at the small disc's calls and at the full disc's first distance
    # window of each profile (the plain version takes 10 s for all the full
    # disc's windows), K3 at the tempered kernel's (the gaussian's boundary
    # kernel leaves it no pair)
    nSmall = d32['gaussian_exterior'][1][0].num_rows
    k2calls, k2full = [], {}
    for c in k2.calls:
        if c[0][1].dtype != torch.float32:
            continue
        if c[0][0][0] == nSmall:
            k2calls.append(c)
        else:
            prof = c[0][-1]
            k2full.setdefault((int(prof.code), float(prof.t),
                               int(prof.wcode)), c)
    if len(k2full) != 2:
        raise AssertionError(f'K2 on the full disc: profiles {list(k2full)}')
    k2calls += list(k2full.values())
    k3calls = [c for c in k3.calls if c[0][1].dtype == torch.float32
               and c[0][0][0] != nSmall]
    del k2, k3
    d64 = path('discs64', 'float64 discs',
               lambda: f28_disc_lines(np.float64))
    for line in d32:
        (s32, (A32, u32)), (s64, (A64, u64)) = d32[line], d64[line]
        summary[f'disc_{line}'] = f28_check(f'float32 disc, {line}', {
            'float32': s32, 'float64': s64,
            'operator_gap': float((A32.data.double() - A64.data).abs().max()
                                  / A64.data.abs().max()),
            'solution_gap': f28_gap(u32, u64)},
            (('operator_gap', F28_OPERATOR_BAR),))
    del d32, d64, A32, A64, u32, u64
    torch.cuda.empty_cache()
    with LargestRecorder(asm, 'panel_scatter', _f32Args) as k1h, \
            ArgRecorder(asm, 'cut2d_polar', dataFirst=True) as k15:
        summary['square'] = path('square', 'float32 square',
                                 lambda: f28_finite('square', FH_NOREF))
    with LargestRecorder(asm, 'panel_scatter_cross', _f32Args) as k1c, \
            ArgRecorder(asm, 'cut1d', dataFirst=True) as k14:
        summary['interval'] = path(
            'interval', 'float32 interval',
            lambda: f28_finite('interval', FH32_INTERVAL_NOREF, cross=True))
    # K14 and K15 into the float32 A (the other calls: CSR data, A_BC)
    k14calls = [c for c in k14.calls if c[0][1] == 'dense']
    k15calls = [c for c in k15.calls if c[0][1] == 'dense']
    del k14, k15
    with LargestRecorder(asm, 'panel_scatter', _f32Args) as k1m:
        summary['h2corrected'] = path('h2corrected', 'float32 H2corrected',
                                      f28_h2corrected)
    with LargestRecorder(asm, 'panel_scatter_slots', _smoothProfile) as k1s:
        summary['gaussian_sparse'] = path('gaussian_sparse',
                                          'float32 gaussian sparse',
                                          f28_gaussian_sparse)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()

    log('  the float32 instances against their plain versions (1e-5 of the '
        'largest entry), and the same calls in float64')
    F32W = dict(entryBytes=8, peak=F32_PEAK)
    WIDE = dict(entryBytes=16, peak=F32_PEAK)
    f32, f64 = torch.float32, torch.float64
    k1 = (asm.panel_scatter, asm._panel_scatter_plain)
    for name, parts in (
            ('panel_scatter:float32_horizon',
             [(k1h.callsOf(f32), *k1, panel_work, F32W, f32, True)]),
            ('panel_scatter:float32_cross',
             [(k1c.callsOf(f64), asm.panel_scatter_cross,
               asm._panel_scatter_cross_plain, panel_work, WIDE, f64,
               True)]),
            ('panel_scatter:float32_complement',
             [(k1m.callsOf(f64), *k1, panel_work, WIDE, f64, True)]),
            ('panel_scatter:float32_profile',
             [(k1p.callsOf(f32), *k1, panel_work, F32W, f32, True),
              (k1s.callsOf(f64), asm.panel_scatter_slots,
               asm._panel_scatter_slots_plain, panel_work, WIDE, f64,
               True)]),
            ('grid_distant:float32_profile',
             [(k2calls, asm.grid_distant, asm._grid_distant_plain,
               grid_distant_work, F32W, f32, True)]),
            ('grid_boundary:float32_profile',
             [(k3calls, asm.grid_boundary, asm._grid_boundary_plain,
               grid_boundary_work, F32W, f32, True)]),
            ('cut1d:float32',
             [(k14calls, asm.cut1d, asm._cut1d_plain, cut1d_work,
               dict(entryBytes=8), f32, True)]),
            ('cut2d_polar:float32',
             [(k15calls, asm.cut2d_polar, asm._cut2d_polar_plain,
               cut2d_work, dict(entryBytes=8), f32, True)])):
        rs, ms64 = [], 0.0
        for calls, kernel_, plain, work, wkw, dtype, csr in parts:
            if not calls:
                raise AssertionError(f'{name}: phase 28 made no call of it')
            rs.append(compare_target_kernel(
                name, calls, kernel_, plain, functools.partial(work, **wkw),
                dtype=dtype, csr=csr, tol=TOL_F32, perCall=True))
            ms64 += float64_ms(calls, kernel_,
                               (1,) if kernel_ is asm.grid_distant else ())
        cmp[name] = merge(*rs)
        cmp[name]['float64_ms'] = ms64
        log(f'    the same calls in float64: {ms64:.3f} ms')
    summary['compare_s'] = time.perf_counter() - t1
    summary['seconds'] = time.perf_counter() - t0
    log(f'phase 28 summary: {json.dumps(summary)}')
    return counts, cmp, summary


def F28_28_PATHS(counts28):
    """The main paths of phase 28: (kernels, label, launch counts)."""
    paths = dict(F28_PATHS, **F28_64_PATHS)
    return tuple((paths[key], f'float32_formats_{key}', c)
                 for key, c in counts28.items())


def main():
    try:
        import torch
    except ImportError:
        sys.exit('chip_smoke: torch is not installed')
    if not torch.cuda.is_available():
        sys.exit('chip_smoke: torch.cuda.is_available() is False')
    if not os.path.isdir(os.path.join(HERE, 'pynucleus_tpu_torch')):
        sys.exit('chip_smoke: run it from a checkout of the repository')
    sys.path.insert(0, HERE)
    from pynucleus_tpu_torch import kernels

    smi = run(['nvidia-smi', '--query-gpu=name,power.limit',
               '--format=csv,noheader'])
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f'nvidia-smi failed: {smi.stderr.strip()}'
    log('phase 1: card', card)
    import triton
    log('  python', sys.version.split()[0], 'torch', torch.__version__,
        'CUDA', torch.version.cuda, 'triton', triton.__version__)
    nvcc = run([kernels._nvcc(), '--version'])
    log('  nvcc:', nvcc.stdout.strip().splitlines()[-1] if nvcc.returncode == 0
        else nvcc.stderr.strip())
    t0 = time.perf_counter()
    lib = kernels.buildLibrary()
    kernels.library()
    log(f'  built {os.path.relpath(lib, HERE)} in '
        f'{time.perf_counter() - t0:.1f} s')

    cmp = phase2()
    errs5 = phase3()
    counts6, errs6, A6, dm6 = phase4(errs5)
    phase5(A6, dm6)
    del A6
    counts7, cmp7, errs7 = phase6(errs6)
    phase7()
    counts8, cmp8 = phase8(errs7)
    counts9 = phase9()
    countsI, countsS, cmp10 = phase10()
    countsG, cmp11, serial = phase11()
    matfree19 = phase19_matfree(serial)
    counts20, cmp20, summary20 = phase20(serial)
    del serial
    counts12, cmp12, _ = phase12()
    counts13, cmp13, summary13 = phase13()
    counts14, cmp14, prof14, summary14 = phase14()
    counts15, cmp15, summary15 = phase15()
    counts16, cmp16, diag16, summary16 = phase16()
    counts17, cmp17, summary17 = phase17()
    counts18, cmp18, summary18 = phase18()
    counts19, cmp19, summary19 = phase19(matfree19)
    counts21, cmp21, summary21 = phase21()
    counts22, cmp22, full22, summary22 = phase22()
    counts23, cmp23, summary23 = phase23()
    counts24, cmp24, summary24 = phase24()
    counts25, cmp25, summary25 = phase25()
    counts26, cmp26, summary26 = phase26()
    counts27, cmp27, summary27 = phase27()
    counts28, cmp28, summary28 = phase28()

    # K1 is one kernel with four targets: the dense one compared at the
    # noRef 4 shapes, the CSR ones at the H2 main path's, the cross one at
    # the finite-horizon path's
    cmp['panel_scatter'] = merge(cmp['panel_scatter'],
                                 cmp7.pop('panel_scatter_slots'),
                                 cmp7.pop('panel_scatter_tree'),
                                 cmp10.pop('panel_scatter_cross'))
    cmp.update(cmp7)
    cmp.update(cmp8)
    cmp.update(cmp10)
    cmp.update(cmp11)
    paths = ((DENSE_PATH, 'dense_noRef6', counts6),
             (H2_PATH, f'h2_cg_jacobi_noRef{H2_NOREF}', counts7),
             (MG_PATH, f'h2_cg_mg_noRef{H2_NOREF}', counts8),
             (HOST_PATH, 'h2_host_engine_noRef5', counts9),
             (INTERVAL_PATH, 'fh_interval_sparse_noRef6', countsI),
             (NONLOCAL_PATH, f'fh_square_sparse_cg_mg_noRef{FH_NOREF}',
              countsS),
             (SERIAL_PATH, f'serial_gmg_square_noRef{SERIAL_NOREF}',
              countsG),
             (INTERVAL_LU_PATH, 'h2_lu_interval_noRef6', counts12['lu']),
             (INTERVAL_LU_PATH, 'h2_lu_gaussian_interval_noRef8',
              counts12['gaussian']),
             (INTERVAL_LU_PATH, 'h2_lu_exponential_interval_noRef8',
              counts12['exponential']),
             (INTERVAL_LU_PATH, f'h2_lu_gaussian_square_noRef{SQUARE_NOREF}',
              counts12['square']),
             (SMOOTH_CG_PATH,
              f'h2_cg_jacobi_gaussian_interval_noRef{SMOOTH_NOREF}',
              counts12['gaussian14']),
             (MG_PATH, f'h2_cg_mg_interval_noRef{INTERVAL_NOREF}',
              counts12['mg16'])) + tuple(
        (VO_PATHS[label], f'interval_{label}_noRef6', counts13[label])
        for label, *_ in VARIABLE_LINES) + (
        (VO_TRANSPOSE_PATH, f'h2_transpose_interval_noRef{VO_CHECK_NOREF}',
         counts13['transpose']),
        (VO_PATHS['twoDomainNonSym-H2-mg'],
         f"h2_gmres_mg_twoDomainNonSym_noRef{summary13['noRef']}",
         counts13['full']),
        (DERIV_DENSE_PATH, 'd2_dense_disc_noRef5', counts14['disc5_dense']),
        (DERIV_H2_PATH, 'd2_h2_disc_noRef5', counts14['disc5_h2'])) + tuple(
        (DERIV_VEC_PATH, f'vector_{label}_interval_noRef6', counts14[label])
        for label, *_ in DERIV_VECTOR_LINES) + (
        (DERIV_H2_PATH, f"d1_h2_disc_noRef{summary14['disc_full']['noRef']}",
         counts14['disc7_h2']),
        (DERIV_VEC_PATH,
         f"vector_LR2-d2_interval_noRef{summary14['vector_full']['noRef']}",
         counts14['vector_full'])) + FH17_PATHS(counts17) \
        + FORMATS18_PATHS(counts18) + INTERP19_PATHS(counts19) \
        + MGX20_PATHS(counts20) + TWOPOINT21_PATHS(counts21)
    table = []
    cmp['panel_scatter_nonsym'] = cmp13.pop('panel_scatter_nonsym')
    cmp['h2_matvec_T'] = cmp13.pop('h2_matvec_T')
    cmp.update(cmp14)
    cmp.update(cmp19)
    cmp.update(cmp20)
    cmp.update(cmp25)
    paths = paths + DIST25_PATHS(counts25)
    for name in kernels.KERNELS:
        route, src, replaces = KERNEL_INFO[name]
        c = cmp[name]
        bms, by = bound(c['work'])
        byPath = {label: counts[name] for path, label, counts in paths
                  if name in path}
        # the CUDA launches the wrapper calls made, counted as they launched
        device = sum(counts['device'][name] for path, _, counts in paths
                     if name in path)
        row = {'name': name, 'route': route, 'source': src,
               'replaces': replaces, 'launches': sum(byPath.values()),
               'max_abs_err': c['err'], 'ms': c['ms'],
               'plain_ms': c['plain_ms'], 'bound_ms': bms, 'bound_by': by,
               'library_ms': c['library_ms'],
               'launches_by_path': byPath,
               'device_launches': device,
               'compared_at': COMPARED_AT[name]}
        row.update({k: v for k, v in c.items()
                    if k not in ('err', 'ms', 'plain_ms', 'work',
                                 'library_ms')})
        # the same kernel at other shapes: with the gaussian and exponential
        # profiles at the smooth lines' shapes and, for K1, K4-K12, at the
        # interval's full-width line's; K1 and K7 with the variable orders' codes (and
        # K1's y shift), K8, K9, K10 and K17 at the shapes of the gmres-mg
        # H2 line; with the power-log profile of the s-derivatives of a
        # constant order; K1's, K14's and K15's real diagonal targets
        for key, cX, at in (
                ('at_interval', cmp12, INTERVAL_COMPARED_AT),
                ('at_varorder', cmp13, VO_COMPARED_AT),
                ('at_derivative', prof14, DERIV_COMPARED_AT),
                ('at_diagonal', diag16, REAL_DIAG_COMPARED_AT),
                ('at_orders2d', full22, VO22_FULL_COMPARED)):
            if name in cX:
                cx = cX[name]
                xms, xby = bound(cx['work'])
                row[key] = {
                    'max_abs_err': cx['err'], 'ms': cx['ms'],
                    'plain_ms': cx['plain_ms'], 'bound_ms': xms,
                    'bound_by': xby, 'library_ms': cx['library_ms'],
                    'compared_at': at if isinstance(at, str) else at[name]}
        split = {'panel_scatter': ('launches_by_target', kernels.K1_TARGETS),
                 'panel_scatter_nonsym': ('launches_by_target',
                                          kernels.K19_TARGETS),
                 'pcg_update': ('launches_by_form', kernels.K4_FORMS),
                 'vector_matvec': ('launches_by_form', kernels.K23_FORMS),
                 'matfree_apply': ('launches_by_form', kernels.K25_FORMS)}
        if name in split:
            key, names = split[name]
            row[key] = {t.split(':')[1]: sum(counts[t] for *_, counts in paths)
                        for t in names}
        table.append(row)
    # the complex variants: of K9, K10 and K17 on the Helmholtz paths, of
    # K1 (dense and diagonal targets), K15 and K18 on the Greens lines
    # (every launch of these kernels there is a complex one, phases 15 and
    # 16 check); the CUDA launches of a variant counted where it launched
    helmholtz = (('interval_wave', 'helmholtz_interval_wave_noRef7'),
                 ('interval_greens', 'helmholtz_interval_greens_noRef7'),
                 ('square', 'helmholtz_square_wave_noRef8'))
    greens = (('inf', f'greens_inf_noRef{GREENS_NOREF}'),
              ('h045', f'greens_h045_noRef{GREENS_NOREF}'))
    for cmpX, countsX, lines, comparedAt in (
            (cmp15, counts15, helmholtz, COMPLEX_COMPARED_AT),
            (cmp16, counts16, greens, GREENS_COMPARED_AT)):
        for name in comparedAt:
            base = name.split(':')[0]
            route, src, replaces = KERNEL_INFO[base]
            c = cmpX[name]
            bms, by = bound(c['work'])
            byPath = {label: countsX[key][name] for key, label in lines}
            device = sum(countsX[key]['device'][name] for key, _ in lines)
            row = {'name': name, 'route': route, 'source': src,
                   'replaces': replaces, 'launches': sum(byPath.values()),
                   'max_abs_err': c['err'], 'ms': c['ms'],
                   'plain_ms': c['plain_ms'], 'bound_ms': bms, 'bound_by': by,
                   'library_ms': c['library_ms'],
                   'launches_by_path': byPath, 'device_launches': device,
                   'compared_at': comparedAt[name]}
            row.update({k: v for k, v in c.items()
                        if k not in ('err', 'ms', 'plain_ms', 'work',
                                     'library_ms')})
            table.append(row)
    # the finite-horizon variants of phase 17: K1 and K15 with ball1 and
    # the ellipse, K19 with the variable horizon (and, off the path, with
    # its indicator alone); the CUDA launches of a variant counted where it
    # launched
    for name in HORIZON_COMPARED_AT:
        base = name.split(':')[0]
        route, src, _ = KERNEL_INFO[base]
        c = cmp17[name]
        bms, by = bound(c['work'])
        byPath = {label: counts[name] for path, label, counts
                  in FH17_PATHS(counts17) if counts[name]}
        device = sum(counts['device'][name]
                     for _, _, counts in FH17_PATHS(counts17))
        row = {
            'name': name, 'route': route, 'source': src,
            'replaces': HORIZON_REPLACES[name], 'launches':
            sum(byPath.values()), 'max_abs_err': c['err'], 'ms': c['ms'],
            'plain_ms': c['plain_ms'], 'bound_ms': bms, 'bound_by': by,
            'library_ms': c['library_ms'], 'launches_by_path': byPath,
            'device_launches': device,
            'compared_at': HORIZON_COMPARED_AT[name]}
        if name == 'panel_scatter_nonsym:var_horizon':
            cx = cmp17['panel_scatter_nonsym:radial_indicator']
            xms, xby = bound(cx['work'])
            row['at_radial_indicator'] = {
                'max_abs_err': cx['err'], 'ms': cx['ms'],
                'plain_ms': cx['plain_ms'], 'bound_ms': xms,
                'bound_by': xby, 'library_ms': cx['library_ms'],
                'compared_at': RADIAL_INDICATOR_COMPARED_AT}
        table.append(row)
    # the matrix formats' variants of phase 18: K1 with the complement
    # indicator and the block mask, K1's diagonal target on the
    # zero-exterior pairs; the CUDA launches counted where they launched
    for name in FORMATS_COMPARED_AT:
        route, src, _ = KERNEL_INFO[name.split(':')[0]]
        c = cmp18[name]
        bms, by = bound(c['work'])
        byPath = {label: counts[name] for _, label, counts
                  in FORMATS18_PATHS(counts18) if counts[name]}
        table.append({
            'name': name, 'route': route, 'source': src,
            'replaces': FORMATS_REPLACES[name],
            'launches': sum(byPath.values()), 'max_abs_err': c['err'],
            'ms': c['ms'], 'plain_ms': c['plain_ms'], 'bound_ms': bms,
            'bound_by': by, 'library_ms': c['library_ms'],
            'launches_by_path': byPath,
            'device_launches': sum(counts['device'][name] for _, _, counts
                                   in FORMATS18_PATHS(counts18)),
            'compared_at': FORMATS_COMPARED_AT[name]})
    # the variants of phase 21: the tempered profile, the smooth two-point
    # weight and the log-inverse-distance and polynomial profiles in K1, K2,
    # K3, K14, K15 and K19, the gaussian and exponential profiles of a
    # finite horizon in K14 and K15; the CUDA launches counted where they
    # launched
    for name in TWOPOINT_COMPARED_AT:
        base = name.split(':')[0]
        route, src, _ = KERNEL_INFO[base]
        c = cmp21[name]
        bms, by = bound(c['work'])
        byPath = {label: counts[name] for _, label, counts
                  in TWOPOINT21_PATHS(counts21) if counts[name]}
        table.append({
            'name': name, 'route': route, 'source': src,
            'replaces': TWOPOINT_REPLACES[base],
            'launches': sum(byPath.values()), 'max_abs_err': c['err'],
            'ms': c['ms'], 'plain_ms': c['plain_ms'], 'bound_ms': bms,
            'bound_by': by, 'library_ms': c['library_ms'],
            'launches_by_path': byPath,
            'device_launches': sum(counts['device'][name] for _, _, counts
                                   in TWOPOINT21_PATHS(counts21)),
            'compared_at': TWOPOINT_COMPARED_AT[name],
            **({'unweighted_ms': c['unweighted_ms']}
               if 'unweighted_ms' in c else {})})
    # the variants of phase 22: the orders of position in K1's and K19's
    # dense targets, K1 and K2 on the manifold; the CUDA launches counted
    # where they launched
    compared22 = ORDERS22_COMPARED_AT()
    for name in compared22:
        base = name.split(':')[0]
        route, src, _ = KERNEL_INFO[base]
        if name not in MANIFOLD22_REPLACES:
            src = ORDERS22_SOURCES[base]
        c = cmp22[name]
        bms, by = bound(c['work'])
        byPath = {label: counts[name] for _, label, counts
                  in ORDERS22_PATHS(counts22) if counts[name]}
        table.append({
            'name': name, 'route': route, 'source': src,
            'replaces': MANIFOLD22_REPLACES.get(name,
                                                ORDERS22_REPLACES.get(base)),
            'launches': sum(byPath.values()), 'max_abs_err': c['err'],
            'ms': c['ms'], 'plain_ms': c['plain_ms'], 'bound_ms': bms,
            'bound_by': by, 'library_ms': c['library_ms'],
            'launches_by_path': byPath,
            'device_launches': sum(counts['device'][name] for _, _, counts
                                   in ORDERS22_PATHS(counts22)),
            'compared_at': compared22[name]})
        if name in full22:
            cx = full22[name]
            xms, xby = bound(cx['work'])
            table[-1]['at_full_width'] = {
                'max_abs_err': cx['err'], 'ms': cx['ms'],
                'plain_ms': cx['plain_ms'], 'bound_ms': xms,
                'bound_by': xby, 'library_ms': cx['library_ms'],
                'compared_at': VO22_FULL_COMPARED[name]}
    # the float32 instances of phase 23: K1's dense target (all its float32
    # calls, and of those the natural-order and the zero-exterior rows), K2,
    # K3 and K4; the CUDA launches counted where they launched
    for name in F32_COMPARED_AT:
        base = name.split(':')[0]
        route, src, _ = KERNEL_INFO[base]
        c = cmp23[name]
        bms, by = bound(c['work'])
        byPath = {label: counts[name] for _, label, counts
                  in FLOAT32_23_PATHS(counts23) if counts[name]}
        table.append({
            'name': name, 'route': route,
            'source': F32_SOURCES.get(base, src),
            'replaces': FLOAT32_REPLACES[name],
            'launches': sum(byPath.values()), 'max_abs_err': c['err'],
            'ms': c['ms'], 'plain_ms': c['plain_ms'], 'bound_ms': bms,
            'bound_by': by, 'library_ms': c['library_ms'],
            'launches_by_path': byPath,
            'device_launches': sum(counts['device'][name] for _, _, counts
                                   in FLOAT32_23_PATHS(counts23)),
            'compared_at': F32_COMPARED_AT[name],
            'float64_ms': c['float64_ms'],
            **({'event_ms': c['event_ms']} if 'event_ms' in c else {}),
            **({'one_chunk_entry': {
                k: {'max_abs_err': v['err'], 'ms': v['ms'],
                    'plain_ms': v['plain_ms'],
                    'bound_ms': bound(v['work'])[0],
                    'bound_by': bound(v['work'])[1]}
                for k, v in c['one_chunk_entry'].items()}}
               if 'one_chunk_entry' in c else {})})
    # the float32 instances of phase 24: K1's slot and tree targets, K6,
    # K12, K7 and K8 on the float32 H2 path; the CUDA launches counted where
    # they launched
    for name in FLOAT32_H2_COMPARED_AT:
        base = name.split(':')[0]
        route, src, _ = KERNEL_INFO[base]
        c = cmp24[name]
        bms, by = bound(c['work'])
        byPath = {label: counts[name] for _, label, counts
                  in FLOAT32_H2_24_PATHS(counts24) if counts[name]}
        table.append({
            'name': name, 'route': route,
            'source': F32_SOURCES.get(base, src),
            'replaces': FLOAT32_H2_REPLACES[name],
            'launches': sum(byPath.values()), 'max_abs_err': c['err'],
            'ms': c['ms'], 'plain_ms': c['plain_ms'], 'bound_ms': bms,
            'bound_by': by, 'library_ms': c['library_ms'],
            'launches_by_path': byPath,
            'device_launches': sum(counts['device'][name] for _, _, counts
                                   in FLOAT32_H2_24_PATHS(counts24)),
            'compared_at': FLOAT32_H2_COMPARED_AT[name],
            'float64_ms': c['float64_ms'],
            **({'event_ms': c['event_ms']} if 'event_ms' in c else {})})
    # the float32 instances of phase 26: K1's slot target into float64 data
    # with the indicator and its diagonal target, K9 and K13; the CUDA
    # launches counted where they launched
    for name in FLOAT32_REM_COMPARED_AT:
        base = name.split(':')[0]
        route, src, _ = KERNEL_INFO[base]
        c = cmp26[name]
        bms, by = bound(c['work'])
        byPath = {label: counts[name] for _, label, counts
                  in FLOAT32_REM_26_PATHS(counts26) if counts[name]}
        table.append({
            'name': name, 'route': route,
            'source': FLOAT32_REM_SOURCES.get(name, src),
            'replaces': FLOAT32_REM_REPLACES[name],
            'launches': sum(byPath.values()), 'max_abs_err': c['err'],
            'ms': c['ms'], 'plain_ms': c['plain_ms'], 'bound_ms': bms,
            'bound_by': by, 'library_ms': c['library_ms'],
            'launches_by_path': byPath,
            'device_launches': sum(counts['device'][name] for _, _, counts
                                   in FLOAT32_REM_26_PATHS(counts26)),
            'compared_at': FLOAT32_REM_COMPARED_AT[name],
            'float64_ms': c['float64_ms']})
    # the variants of phase 27: the component order (with the singular
    # rules' log correction) in K1, K19 and K7, the orders of position in
    # K1's tree target, K19's slot target and K7; the CUDA launches counted
    # where they launched
    compared27 = VARH2_COMPARED_AT(summary27)
    for name in compared27:
        base = name.split(':')[0]
        route, _, _ = KERNEL_INFO[base]
        c = cmp27[name]
        bms, by = bound(c['work'])
        byPath = {label: counts[name] for _, label, counts
                  in VARH2_27_PATHS(counts27) if counts[name]}
        table.append({
            'name': name, 'route': route, 'source': VARH2_SOURCES[name],
            'replaces': VARH2_REPLACES[name],
            'launches': sum(byPath.values()), 'max_abs_err': c['err'],
            'ms': c['ms'], 'plain_ms': c['plain_ms'], 'bound_ms': bms,
            'bound_by': by, 'library_ms': c['library_ms'],
            'launches_by_path': byPath,
            **({'log_launches': {
                label: counts[f'{base}:log'] for _, label, counts
                in VARH2_27_PATHS(counts27) if counts.get(f'{base}:log')}}
               if name.endswith(':component') else {}),
            'device_launches': sum(counts['device'][name] for _, _, counts
                                   in VARH2_27_PATHS(counts27)),
            'compared_at': compared27[name]})
    # the float32 instances of phase 28: K1 with the indicator into a
    # float32 dense A, into the float64 A_BC, with the complement indicator
    # and the block mask into a float64 dense A, and K1, K2 and K3 with a
    # profile other than the plain power one; the CUDA launches counted
    # where they launched
    for name in F28_COMPARED_AT:
        base = name.split(':')[0]
        route, _, _ = KERNEL_INFO[base]
        c = cmp28[name]
        bms, by = bound(c['work'])
        byPath = {label: counts[name] for _, label, counts
                  in F28_28_PATHS(counts28) if counts[name]}
        table.append({
            'name': name, 'route': route, 'source': F28_SOURCES[name],
            'replaces': F28_REPLACES[name],
            'launches': sum(byPath.values()), 'max_abs_err': c['err'],
            'ms': c['ms'], 'plain_ms': c['plain_ms'], 'bound_ms': bms,
            'bound_by': by, 'library_ms': c['library_ms'],
            'launches_by_path': byPath,
            'device_launches': sum(counts['device'][name] for _, _, counts
                                   in F28_28_PATHS(counts28)),
            'compared_at': F28_COMPARED_AT[name],
            'float64_ms': c['float64_ms']})
    log(f'phases 1-28 took {time.perf_counter() - T_START:.1f} s')
    log(f'phase 14 summary: {json.dumps(summary14)}')
    log(f'phase 15 summary: {json.dumps(summary15)}')
    log(f'phase 16 summary: {json.dumps(summary16)}')
    log(f'phase 17 summary: {json.dumps(summary17)}')
    log(f'phase 18 summary: {json.dumps(summary18)}')
    log(f'phase 19 summary: {json.dumps(summary19)}')
    log(f'phase 20 summary: {json.dumps(summary20)}')
    log(f'phase 21 summary: {json.dumps(summary21)}')
    log(f'phase 22 summary: {json.dumps(summary22)}')
    log(f'phase 23 summary: {json.dumps(summary23)}')
    log(f'phase 24 summary: {json.dumps(summary24)}')
    log(f'phase 25 summary: {json.dumps(summary25)}')
    log(f'phase 26 summary: {json.dumps(summary26)}')
    log(f'phase 27 summary: {json.dumps(summary27)}')
    log(f'phase 28 summary: {json.dumps(summary28)}')
    print(json.dumps({'kernels': table}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
