#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``freedm_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card; builds the kernels from the sources in this
checkout and drives the served paths end to end: ``POST /v1/pf`` on the
dense Newton backend (K1-K3), the sparse one (S1-S4), which the default
server takes at 512 buses and more, and the serving cache's delta tier
(C1); ``POST /v1/n1`` on the SMW screen (N1) below 512 buses and the
status-traced sparse screen (S1 with status, S2-S4, K3) at and above;
the DC solver and ``dc_prefilter`` (D1); the radial ladder solve (L1)
and its adjoint (L2) under the VVC controller, and ``POST /v1/vvc`` (L1);
QSTS studies through ``run_study`` — the agent step (A1), the bus and
feeder streaming reductions (Q1, Q2), feeder chunks on L1 — and the jobs
API behind ``POST /v1/qsts``; topology sweeps through ``run_topo_sweep``
— the radiality check (T1) and the rank-r SMW screen (T2), the AC verify
on S1 with status, S2-S4 and K3 —, ``POST /v1/topo`` and ``POST
/v1/topo/sweep``; the rest of the solver family at the reference
bench's sizes — dense Newton with per-lane status on the Ybus stamp (Y1)
and K1/K2's per-lane form, the fast-decoupled solver (Y1's B′/B″ modes,
F1), the matrix-free Newton–Krylov solver (J1) and the three-phase CIM
(I1); the DGI round — FID-gated reachability (R1), group formation and
election (G1), the draft auction (B1), the state-collection matmul and
the VVC step (L1/L2) — through ``make_superstep``, ``lb.run_rounds``,
``gm.form_groups`` and ``topology.node_reachability``; and the reverse
modes of the fixed solves — ``torch.autograd`` through ``solve_fixed`` of
the Newton family (the residual VJP J2 and an adjoint solve at the last
iterate), FDLF (J2 over the saved half-steps) and the CIM (I2, every
iteration of a backward in one launch); the ladder's dense and doubling
sweep forms (L3, L4) with the source voltage's gradient through every
ladder reverse mode; and the LB round past 2¹⁵ nodes on B1's WIDE key
pairs, sorted on a thread-block cluster (form CLUSTER) up to its
capacity and by one CTA above.
Phases (any failure exits non-zero, and no result line is printed):

1. build: ten ``nvcc`` runs started together compile
   ``freedm_tpu_torch/kernels/csrc/newton.cu``, ``sparse.cu``,
   ``cache.cu``, ``screen.cu``, ``ladder.cu``, ``ladder_dense.cu``,
   ``qsts.cu``, ``topo.cu``, ``solvers.cu`` and ``dgi.cu`` for
   ``sm_90a``; prints the build seconds and the ``-Xptxas -v`` reports;
2. kernels: each kernel against its plain PyTorch version on the card at
   n ∈ {14, 30, 118, 2000} buses and B ∈ {1, 3, 64} lanes (float64,
   1e-10 absolute on J, f, P, Q — the sums run in another order; K3
   exactly, and bit-identical on repeat), K2 also at 67 lanes (a full
   and a ragged tile of its tiled product) and in float32
   (``KERNEL_ATOL_F32``), bit-identical on repeat; then each kernel's time
   (CUDA events) at the main path's shape (mesh2000, 64 lanes) beside its
   plain version's, its bound and, for K2, one ``torch.matmul`` of the
   complex pair, K2's device time (profiler and events a call), its
   dense tensor-core floor and float32 times, K3 also by device time;
   also the Newton step's library LU
   (``torch.linalg.solve_ex``) on K1's Jacobian, batched as the solver
   calls it and one lane at a time;
3. solve: ``make_newton_solver`` on mesh2000 over 64 lanes at load
   scales 0.5-1.2 — every lane converges, Σp (the losses) is small and
   non-negative, three lanes match the plain-version solve on the card
   within 1e-9 pu with identical iteration counts; then a float32 solve
   of mesh118 over 4 lanes, within 1e-4 pu of the float32 plain-version
   solve and of the float64 solve;
4. sparse kernels: S1-S4 against their plain versions at mesh118,
   mesh2000 and mesh5000, B ∈ {1, 3, 64} (B ≤ 8 at mesh5000), float64
   and float32 — S1 in each of its modes (``compare_assemble``: the
   float32 values of ``VALUES_F32`` are the full fill's cast, bit for
   bit, the ``RESIDUAL`` outputs the full fill's, P and Q the ordered
   sums of the c/a values it wrote, every mode bit-identical on repeat)
   —, with a breakdown lane and a forced Cholesky failure
   (``SPARSE_TOL`` gives each tolerance and its reason), S3 on the
   blocks of GMRES cycles with (m, s) ∈ {(16, 4), (16, 1), (16, 8),
   (32, 4)} (j0 up to 28, 33 basis rows; mesh118's N = 236 splits into
   ragged slices, mesh5000's 33 rows stream from L2; the float32 blocks
   of the 8-step chain at mesh5000 are held to the float64 result, see
   ``ORTH_F64_LIMIT``), S4 also on a rank-deficient H (dead rows of
   V·valid) and on a non-finite H and β (NaN lanes), S2, S3 and S4 run
   twice on identical inputs (identical bits), S3 also in both its
   shared- and its global-memory form (identical bits); the sweeps of
   S4's Jacobi SVD on the served mesh2000 cycles, from its PyTorch mirror
   (``gmres_lstsq_jacobi``, held to the kernel); then their times at
   mesh2000 × 64 (CUDA events over back-to-back calls, and device time
   from ``torch.profiler``) beside their plain versions, their bounds,
   the preconditioner apply and, for S2, one ``torch.sparse.mm`` over a
   block-diagonal CSR matrix of every lane's J, for S4 the SVD
   minimum-norm solve of its float64 H (``torch.linalg.pinv``; the card's
   ``torch.linalg.lstsq`` refuses a rank-deficient H) — S1 in each mode, all in
   float64 and float32;
5. sparse solves: mesh2000 × 64 in f64 and in mixed — every lane
   converges, losses ≥ 0, three lanes within 1e-9 pu of the plain-version
   sparse solve and 1e-6 pu of the dense solve — with launches per
   Newton step (S1's by mode), a ``torch.profiler`` breakdown and the
   device operations per Newton step; then mesh5000 × 8 on the LU-kind
   preconditioner;
6. serve (the dense kernels' main path): ``ServeServer`` with
   ``pf_backend="dense"`` and ``max_batch=64``; 64 concurrent ``POST /v1/pf`` per case to
   case14, case_ieee30, mesh118 and mesh2000 — every answer 200 and
   converged, at least one batch with more than one lane; prints p50/p99
   latency and solves/s per case.  Every dense kernel's launch count
   over this phase must be > 0;
7. default server (the main path of the sparse kernels): ``ServeServer``
   with the default ``pf_backend="auto"``/``pf_precision="auto"`` and
   ``max_batch=64``; 64 concurrent ``POST /v1/pf`` for mesh2000, all 200
   and converged, solved sparse and mixed; every S1-S4 launch count over
   the burst must be > 0.  Phases 6 and 7 run with ``cache_mb=0``;
8. serve cache: C1, the whole delta program in one launch, against its
   plain version (the host loop around ``torch.linalg.lu_solve``) at
   mesh118, mesh2000 and mesh5000, B ∈ {1, 8}, f64 and mixed, from a
   converged base over random 1-16-bus deltas (``PROGRAM_ATOL``; sweep
   counts equal or one apart on a lane, counted), bit-identical on
   repeat, and at mesh118 and mesh2000 also against the plain program on
   the mirror's solves (``lu_solve_mirror``, printed); its times at
   mesh2000 × {1, 8} lanes in mixed and f64 (events, and device time per
   program and per sweep), with no ``lu_solve`` kernel in its profile;
   then the default server with the cache on at mesh2000
   (:func:`serve_cache`): exact, delta, warm and fall-through answers,
   deltas while a 64-request burst is in flight, every answer within
   ``CACHE_ATOL`` of a ``cache_mb=0`` service; C1's launch count over it
   must be > 0, one a delta program, and a profiled answer's device time,
   operations and CUDA runtime calls are printed;
9. screen kernels: S1 with a per-lane status in each mode against its
   plain version at mesh118 and mesh2000, B ∈ {1, 3, 64, 256}, float64
   and float32, random 0/1 status and single outages
   (``compare_assemble``: ``SPARSE_TOL``, bit-identical on repeat, the
   modes' bit relations; an all-in-service status gives the no-status
   bits); N1 in every mode on identical inputs at case_ieee30, mesh118
   and mesh511 × L ∈ {1, 64, 256} (``SMW_ATOL``); D1 in both modes at
   mesh118 and mesh2000 × L ∈ {1, 1024} (``DC_ATOL``), and the bridges
   of case14 and case_ieee30 flagged islanded by kernel and plain
   version; then their times (events and device time) beside the plain
   versions and the bounds: S1 with status at mesh2000 × 64 and × 256,
   device time in turns with S1 without status on the same inputs
   (with, without, without, with), N1 at mesh511 × 256 and
   case_ieee30 × 64 in each mode, D1 SCREEN at mesh2000 × 1024 and SOLVE
   at × 4096;
10. n1 screens: ``make_n1_screen`` on mesh2000 × 256 chord outages
   (sparse; mixed on the served bf16 pair, f64 on the float64 LU pair)
   against the plain-version screen (every lane converged; f64: three
   lanes within 1e-9 pu with equal iterations, every lane's fallbacks
   equal and iterations ±1; mixed: equal flags and fallbacks, iterations
   ±1), its
   launches (every S1
   call with the lanes' status) and a profile; the SMW screen over every
   secure outage of case_ieee30 and mesh511 × 256 against its plain
   version (1e-9 pu), 2 + 2 × 24 N1 launches a screen; ``make_dc_solver``
   at mesh2000 (4096 injection lanes, 1024 outage lanes) and
   ``dc_prefilter=8`` over 64 chord outages against their plain versions;
11. serve n1: the default config but ``max_batch=256`` (a request of
   more lanes than ``max_batch`` is refused, as the reference's is),
   engines prewarmed (build and prewarm times printed apart): mesh2000
   — one request of 64 outages, 16 concurrent requests of 1-16, one of
   256 — and case_ieee30 over all its secure outages, each answer
   all_converged with ``v_min_pu``/``v_max_pu`` within 1e-9 pu of the
   direct screen of the same outages; an islanding outage refused (400);
   p50/p99 latency and lanes a batch; S1 (with status on every call),
   S2-S4 and N1 launched;
12. ladder kernels: L1 against its plain version through
   ``make_ladder_solver`` and its ``plain=True`` twin on vvc_9bus, the Dl
   table (``tests/data/Dl_new.mat``, 0.5 × load, 60 iterations),
   ``synthetic_radial(512, seed=0)`` and ``synthetic_radial(10000,
   seed=0, load_kw=1.0)`` × B ∈ {1, 8, 64} (load scales uniform in
   0.7-1.3, ``default_rng(0)``) × {solve, solve_fixed} × {float64,
   float32} (``LADDER_ATOL``: 1e-10 pu with equal iterations and flags,
   1e-4 pu with equal flags, on the lanes that converge; a lane in
   voltage collapse is held to equal flags and iterations and every
   lane's single iteration to the same limits; a float32 flag whose
   residual lies within rounding of eps, ``F32_FLAG_ULPS``, is printed;
   bit-identical on repeat); L1's routes (``compare_ladder_routes``): its
   plan and the clusters the card holds at once, at the 10k feeder a
   lane's outputs the same bits in launches of 1, 8 and 64 lanes (fixed
   and solve, float64 and float32), the global route above the cluster
   route's float64 capacity (``synthetic_radial(20904)``, its float32 run
   on the cluster route) and a feeder whose group outgrows a CTA's staged
   members (``broom_feeder``) against the plain version (fixed, saved
   iterates, solve); L2 through
   ``LadderFixed`` against ``torch.autograd.grad`` of the plain fixed
   solve for the total loss in Q on vvc_9bus and the 10k feeder × {1,
   64} (rtol 1e-8, atol 1e-10) and a central difference on three live
   coordinates at 10k × 1 (1e-4); then their times (events back to back,
   and device time by events queued behind a sleep kernel,
   ``queued_events_ms``) at the 10k feeder × 64 and × 1 and vvc_9bus × 64
   beside the plain versions and the bounds; both routes of L1, L2 and
   L4 (``time_crossover``: each launched through its plan and held to
   the plain versions) at 8-2048 branches × 64 and 1536 lanes, f64 and
   f32, and the crossover they imply;
13. vvc: one controller step on vvc_9bus from zero q at loads P·(1 +
   0.6j) — it improves and is within 1e-9 of the plain step, one L2
   launch —, 120 rounds (non-increasing, below 0.92 of the base, L2
   once a round), one step on the 10k feeder × 64 lanes (per-lane alphas
   equal to the plain step's, losses within 1e-9 relative);
14. serve vvc: the default server, 64 concurrent ``POST /v1/vvc`` to
   vvc_9bus with random q in ±50 kvar on live phases (seed 9): every
   answer 200 and converged, loss and voltage extremes within 1e-9 of a
   direct ``solve_fixed``; p50/p99; L1 launched over the burst;
15. qsts kernels: A1 against its plain version on the 6-bus world × 2 and
   the million-agent population (400k EV, 300k thermostats, 150k
   inverters, 150k DR) on case_ieee30 × {1, 4}, observations flat and
   solved, hours 0, 7.5, 15, 19 and 23.75, DR signal 0 and 1
   (``A1_STATE_RTOL``, ``QSTS_SUM_RTOL``, relays equal, bit-identical on
   repeat); Q1 at mesh2000 × 64 (a solved mixed step) and case_ieee30 × 1,
   Q2 at vvc_9bus × 24·64 lanes (counts, worst count and envelope equal,
   losses and peak within ``QSTS_SUM_RTOL``, bit-identical on repeat);
   then their times (events and device time) beside the plain versions
   and the bounds;
16. qsts: studies through ``run_study`` — (a) case14 × 16, 96 steps of
   15 min, chunks of 24, seed 5: warm against cold iterations, kill after
   2 chunks and resume exactly, the kernel path within ``QSTS_ATOL`` of
   ``plain=True`` with equal iteration sums; (b) mesh2000 × 64 (sparse,
   mixed), 96 steps, chunks of 24, residential, seed 5: every lane-step
   of the ``MIDDAY_STEP`` steps before midday converged, the whole day
   completed (its non-converged count printed), Q1 once a step, a second
   run, kill and resume and chunks of 32 equal, scenario-steps/s, Newton
   steps a lane-step and the chunk wall split; mesh2000 × 8 × 4 steps
   within ``QSTS_MIXED_ATOL`` of ``plain=True``, flags equal; (c) the
   million-agent day on case_ieee30 × {1, 4}, 24 one-hour steps, chunks
   of 8: agent-steps/s on the engine's second run, A1 and Q1 once a step,
   closed-loop against replayed, kill and resume; (d) vvc_9bus × 64, 96
   steps: L1 and Q2 once a chunk, within ``QSTS_ATOL`` of ``plain=True``,
   kill and resume;
17. serve qsts: a ``ServeServer`` with a ``JobManager`` over a temporary
   checkpoint directory: a mesh2000 × 16 job while the 64-request
   ``/v1/pf`` burst on case14 runs (p50/p99 beside the burst alone; every
   answer 200 and converged), its summary equal to a direct
   ``run_study``; a keyed job cancelled mid-run and resubmitted (resumed,
   equal); an agents job (A1 launched); an unknown id 404; ``/healthz``
   ``qsts``;
18. topo kernels: T1 and T2 (both modes) against their plain versions at
   case14, case_ieee30, mesh118 and mesh2000 × V ∈ {1, 64, 4096} (capped
   at a rank's distinct open-sets) × r ∈ {1, 2, 6}, random distinct
   open-sets (seeded), and every rank-<=2 variant of case14, case_ieee30
   and mesh118 (``TOPO_ATOL``; T1's booleans, T2's islanding flags and
   violation counts equal; both bit-identical on repeat, SCREEN equal to
   DETAIL); the bridges of case14 and case_ieee30 flagged by both; the
   least |det C| of a connected lane and the largest of an islanded one;
   T1 on graphs with parallel branches, self-loops and a disconnected
   base; a lane's bits at launch widths 1, 64 and 4096 and in a permuted
   chunk (mesh118 r = 2, mesh2000 r = 3); the card's refusal of T1's
   sweep count; then their times (events back to back, and device time by
   queued events) beside the plain versions and the bounds: T1 and T2
   SCREEN and DETAIL at mesh118 × 4096, r = 2 (a chunk of the gate
   sweep), × 64 (a chunk of the served sweep job) and mesh2000 × 16384,
   r ≤ 3 (SCREEN), T1 at 4-32 warps a CTA and T2's other launch plans
   (``screen_plan``'s choice recorded); the library row:
   ``torch.linalg.solve_ex`` of the chunk's re-formed B′, and per variant
   on the reference bench's 32 mixed-rank lanes;
19. topo sweeps through ``run_topo_sweep``: (a) every rank-<=2 variant of
   mesh118 in chunks of 4096, top 8 by loss — variants/s beside the
   reference bench's floor (10⁴), the AC verify of the top 8 apart, every
   entry converged under ``AC_TRUE_MISMATCH`` and no bridge, a second
   run, a kill after 3 chunks and its resume, chunks of 1024 and the
   plain versions' sweep equal; T1 and T2 once a chunk; (b) full width:
   mesh2000, ``TOPO_FULL_SAMPLES`` neighborhood samples of rank <= 3 (seed
   7) in chunks of ``TOPO_FULL_CHUNK`` — variants/s, the host draw, the
   chunk walls and T1 + T2's share, the plain T1's sweeps, the excluded
   counts;
20. serve topo: the default server (cache on) with a ``JobManager``:
   ``POST /v1/topo`` case14 at rank 2 (210 variants, counts partition,
   verified, the shortlist of ``run_topo_sweep``), mesh118 after a
   ``/v1/pf`` request (the cache entry's B′ LU adopted: no
   ``lu_factor``), 16 concurrent mesh118 rank-1 requests (p50/p99), an
   invalid spec 400; a keyed mesh118 rank-2 ``POST /v1/topo/sweep`` job
   cancelled mid-run and resubmitted (resumed, equal to a direct sweep,
   ``kind: "topo"``), an invalid job 400; T1 and T2 launched on both;
21. solver kernels: Y1 in its three modes, F1 in its three modes on a
   shared and a per-lane Ybus, J1 with and without status and K1/K2 on a
   per-lane Ybus against their plain versions at case14, case_ieee30,
   mesh118 and mesh2000 × B ∈ {1, 3} (mesh118 also × 118, the reference
   bench's N-1 batch), float64 (``KERNEL_ATOL``) and float32
   (``KERNEL_ATOL_F32``; J1 relative to max |J u| above 1); J1 at the
   krylov lane batch's case under every plan of ``residual_plans`` (its
   staged route's lanes a CTA and CTAs a lane, and the wide route) in
   float64 and float32, with and without status: lane 0 the same bits at
   widths 1, 64 and 256, every plan the default's bits, and mesh5000 × 2
   (past the float64 staging capacity) on the wide route by default
   (``compare_residual_routes``); then I1
   through ``make_cim_solver`` and its ``plain=True`` twin on vvc_9bus and
   the CIM feeder (``cim_feeder``) × B ∈ ``CIM_CHECK_LANES``; F1's tile
   mode (one Ybus, K2's tiled product) at ``F1_TILE_SHAPES`` in its three
   modes, float64 and float32, and its product K2's bits
   (``compare_fdlf_tiles``); each kernel bit-identical on repeat; then
   their times (events and device time) beside the plain versions, the
   bounds and the library rows: Y1 at mesh118 × 118 (library: a sparse
   COO tensor to dense, duplicates summed), K1/K2 on that per-lane Ybus,
   F1 at mesh2000 × 1 (its warp form, one kernel a call; device time and
   the library row — the complex ``torch.matmul`` of Ybus with V — both by
   queued events), mesh118 × 1024 (the tile mode; library the same
   product, float32 too) and mesh2000 × 16 per lane (queued events), J1
   at mesh2000 × 256 and × 64 (queued events; float32 and with status
   too, the plan of each, and the wide route beside; library:
   ``torch.sparse.mm`` of the S1-assembled Jacobian), I1 at the CIM feeder
   × 64 (device time by events a call; library: the complex
   ``torch.matmul`` of A with the injections; float32 too);
22. solvers at the reference bench's sizes (not cut): (a) ``bench_n1_118``
   (dense ``solve_fixed``, 118 outage lanes, against the plain path within
   ``SOLVE_ATOL``), (b) FDLF ``bench_nr_2000`` (solves/s), (c) FDLF
   ``bench_mc_1024`` (lane solves/s), (d) FDLF N-1 at mesh2000 × 16 chord
   outages, (e) ``bench_nr_2k_krylov_lanes`` mixed and f64 (mesh2000 ×
   256: lane solves/s, all converged, equal flags, within
   ``MIXED_DV_BOUND``, fallbacks, a profile with J1's device time and
   share of the busy time, every J1 launch on the staged route), (f)
   ``bench_n1_2000bus_krylov`` (256 warm-started chord outages) and (g)
   ``bench_nr_10k_mesh`` (ms a solve and an iteration beside the north
   star's ``NORTH_STAR_MS``, the host f64 true mismatch, a profile); each
   prints its Y1/F1/J1 launches and its device busy share;
23. cim: vvc_9bus radial against L1's ladder fixed point (1e-8 pu); the
   CIM feeder × 64 load scales — all converged, the KCL residual under
   ``CIM_KCL_KVA``, the kernel path within ``SOLVE_ATOL`` of the plain
   path with equal iterations, ms a solve.
24. dgi kernels: G1 against its plain version at N ∈ {3, 16, 256, 1024,
   4096} (lanes of alive masks, ~10% dead; sparse random groups and, from
   256, a chain of diameter N; one [B, N, N] case; one cooperative launch
   at every N), R1 on the synthetic topology
   (``dgi_topology_text``) at V = 48, 1024 × 64 FID scenarios and 2048
   (R1's device-memory form), B1 at N ∈ {3, 256, 4096} in float32,
   float64 and float64/float32 (imbalance/gateway), at 1024 fleets × 256
   and at N = 20000 (B1's GLOBAL form) — one round with malicious nodes and
   the gate, one without, and a run of rounds; each bit for bit and
   bit-identical on repeat (G1's and R1's label sweeps printed); then
   their times (events and device time) beside the plain versions, the
   bounds and, for G1 and R1, the plain version's float32 ``torch.bmm``
   squarings alone (a composite of library calls, not one call): G1 at
   1024 × 1 (the superstep's), 256 × 64 and 4096 × 1, R1 at 1024 × 64, B1
   at ``bench_lb_256`` (256 × 64 rounds), 1024 × 1 round, 4096 × 64 and
   1024 fleets × 256 × 64;
25. dgi: (a) ``bench_lb_256`` (N = 256, normal(0, 10), seed 0, 64 rounds,
   float32): converged, the kernel and plain trajectories equal,
   rounds/s; (b) N ∈ {1024, 4096}, one group: the round of convergence
   and rounds/s (the BASELINE's LB convergence wall-clock against node
   count); (c) 1024 fleets × 256 nodes, 64 rounds in one launch:
   fleet-rounds/s; (d) the synthetic topology (1024 vertices, 64 FIDs)
   over 64 FID scenarios: R1, ``node_reachability`` to 256 SST nodes,
   batched G1 — groups equal to the plain path's, one R1 and one G1
   launch;
26. superstep: ``make_superstep`` against its ``plain=True`` twin, each
   round from the same state — groups and the LB round equal, the
   snapshot within ``SUPERSTEP_SC_RTOL``, the VVC loss within
   ``SUPERSTEP_LOSS_RTOL`` or ``SUPERSTEP_LOSS_ULPS`` of the load power, q
   within ``SUPERSTEP_Q_ATOL``: (a) the reference dry run's shapes (16
   nodes, ``synthetic_radial(96, seed=3, load_kw=5.0)``, 8 lanes, two
   rounds); (b) 1024 nodes (readings through ``devices.tensor.net_value``
   from SST, DRER and LOAD rows, reachability from (d)'s topology, 2%
   dead), ``synthetic_radial(10000, seed=0, load_kw=1.0)`` × 64 lanes, 10
   rounds: ms a round by CUDA events split into GM, LB, SC and VVC, G1,
   B1, L1 and L2 launches a round (R1 once, the reachability; these are
   the kernel table's launches of G1, R1 and B1) and the device busy
   share;
27. reverse modes (``reverse_phase``): (a) J2 ``residual_vjp`` in both
   modes, with and without status, at case14, case_ieee30, mesh118 and
   mesh2000 × B ∈ {1, 3, 64}, and I2 ``cim_vjp`` (a call) on vvc_9bus
   with the reference's ``TIE_5_8`` × 64 and the CIM feeder × {1, 3, 64,
   65}, against their plain versions (``KERNEL_ATOL`` of the largest
   entry above 1), each bit-identical on repeat, and I2's walk
   (``cim_vjp_walk``) over 60 saved iterates at the CIM feeder × 64 and
   vvc_9bus × 65 against the 60 chained plain calls, on repeat and bit
   for bit against the 60 chained single calls; J2 against J1 by ⟨w, J u⟩
   = ⟨Jᵀ w, u⟩; J2 in both modes under every plan as J1 in phase 21; their
   times beside the plain versions, the bounds and the library rows (J2
   at mesh2000 × 256 and × 64, queued events, the wide route beside:
   ``torch.sparse.mm`` of the
   transposed S1-assembled Jacobian; I2 at the CIM feeder × 64: the
   complex ``torch.matmul`` of Aᴴ with the cotangents, and the walk's
   time an iteration beside the 60 single calls in a row); (b) the
   reference's gradient gates on the card
   against central differences (rtol 1e-4, atol 1e-8): dense Newton,
   krylov, the CIM, and FDLF at case_ieee30; (c) each ``solve_fixed``
   gradient at full width — dense ``bench_n1_118``, sparse mesh2000 × 64
   f64 and mixed, krylov ``bench_nr_2k_krylov_lanes`` (f64), FDLF mesh2000
   × 16, the CIM feeder × 64: the kernel route within 1e-9 of the plain
   route, route B within 1e-6 of the unrolled plain gradient on converged
   lanes (``UNROLLED_LANES`` of the sparse and krylov batches), route A
   within 1e-9, every entry finite; forward and backward ms, their ratio,
   the adjoint GMRES cycles, J2/I2 launches a backward and the saving
   forward's peak memory (the CIM backward launches I2 once), J2's device
   time and share in one profiled backward of the sparse f64 and krylov
   batches (every krylov J2 launch on the staged route), and I2 a
   call, an iteration in the walk and the library row on one line;
28. ladder forms and B1 from 2¹⁵ nodes (``forms_phase``): (a) L3
   ``ladder_dense`` and L4 ``ladder_doubling`` through
   ``make_ladder_solver(sweep_method="dense" | "doubling")`` against
   their ``plain=True`` twins at vvc_9bus (L3's CTA route) and
   ``synthetic_radial(2048, seed=0, load_kw=1.0)`` (L3's tiled route) and
   also
   ``synthetic_radial(10000, seed=0, load_kw=1.0)`` (L4) × 64 lanes ×
   {solve, solve_fixed} × {float64, float32} (``LADDER_ATOL``, flags and
   float64 iterations equal, L4 float64 bit for bit), bit-identical on
   repeat and in launches of 1 and 64 lanes, and the 2048 feeder at its
   default load (every lane in voltage collapse: flags and iterations
   equal); (b) the reverse modes of L3, L4 and L2 with the source
   phasors' cotangent against autograd of the plain fixed solves (rtol
   1e-8) × {1, 64} on vvc_9bus, × {1, 8} on the larger feeders, central
   differences in ``v_source_pu`` and three live
   loads on the 10k feeder × 1 (L4, L2) and the 2048 feeder × 1 (L3);
   (c) their times beside L1 on the same lanes, the plain versions, the
   bounds (the function's own work, as L1's: the forms' redundant products
   and rounds are not counted), L3's library rows (``torch.matmul`` of the
   subtree matrix and ``torch.sparse.mm`` of its CSR, 2 × 20 products
   each, with L3's ratio to each and to L1), and each reverse mode's
   cotangents
   at the timed shapes (× 64 too) against its plain version's (within
   1e-8 of the largest); (d) B1 over 64 rounds of ``bench_lb_256``'s draw
   at 2¹⁵ × 4 fleets, 40,961 × 1 and 2¹⁶ × 1 (form CLUSTER) and over 2
   rounds on one fleet of 2¹⁸ nodes (the first power of two above the
   cluster capacity: the one-CTA WIDE form) bit for bit, each shape's form
   and times beside its plain version's, the sort alone (64 stable
   ``torch.sort`` of a round's high key words at 2¹⁶), ``lb.run_rounds``
   and ``lb.lb_round(..., gid=...)`` at 2¹⁵ from a block-diagonal mask of
   512-node groups, and B1's packed form at 2¹⁵ − 1; (e) L3's and L4's main
   paths (a solve, ``solve_fixed`` and its backward: the kernel table's
   launches, every kernel launch counted — L3's tiled route 2 + 2 · 20 a
   solve and a reverse mode — and split by mode).

The line before the last is the kernel table as one JSON object (K3,
S1-S4 also carry ``device_ms``, S1-S4 float32 ``*_f32`` times, S1 its
other modes' ``*_values_f32``/``*_residual`` times and bounds, its
status-mode times ``*_status_x64``/``*_status_x256`` with device times
in turns with and without status on the same inputs
(``device_ms_turns_*``), its served launches by mode,
``launches_by_mode``, and those of the n1 path, all with status; N1 and
D1 their other modes' times; L1 and L2 their per-iteration device times
and other shapes; A1 its S = 4 times; A1, Q1 and Q2 the path of their
launches; T1 and T2 their mesh2000 × 16384 times, T2 DETAIL, the
refactorization head-to-head and the |det C| margin, both their launches
on the served paths; Y1-I1 their other shapes and modes, the float32
gaps and the path of their launches, F1 the numbers of phase 22; G1, R1
and B1 their other shapes, device times, G1's and R1's float32 squarings
as a library composite, their launches in phase 25 (d) and the
superstep's split, B1 its rows from 2¹⁵ nodes of phase 28 (d) and the
sort alone; J1 and J2 their plans, × 64 times, the wide route's time and
their launches by route, J1 its device time on the krylov lane batch; J2
and I2 their backward rows of phase 27 (c), I2 its walk's times; L3 and
L4 their other shapes beside L1);
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import http.client
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and fp64 FLOP/s
#: outside the tensor cores (the kernels' arithmetic is elementwise).
PEAK_BYTES = 3.35e12
PEAK_FP64 = 34e12
PEAK_FP32 = 67e12
#: fp64 through the tensor cores (DMMA; NVIDIA's data sheet): the least
#: time of a dense fp64 matrix product such as I1's.
PEAK_FP64_TENSOR = 67e12

MAIN_LANES = 64
KERNEL_ATOL = 1e-10
KERNEL_ATOL_F32 = 1e-3
SOLVE_ATOL = 1e-9
SOLVE_ATOL_F32 = 1e-4
TIGHT_TOL = 1e-11  # solver tolerance of the sparse kernel-vs-plain solves


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# Phase 1: build
# ---------------------------------------------------------------------------


def build_kernels(torch, nk, sk, ck, sck, lk, qk, tk, sol, dk, build):
    t0 = time.monotonic()
    box = {}

    def run_nvcc(name):
        try:
            box[name] = (build.build(name), time.monotonic() - t0)
        except Exception as e:  # noqa: BLE001 — re-raised on the main thread
            box["error"] = e

    names = ("newton", "sparse", "cache", "screen", "ladder", "ladder_dense",
             "qsts", "topo", "solvers", "dgi")
    threads = [threading.Thread(target=run_nvcc, args=(name,))
               for name in names]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if "error" in box:
        raise box["error"]
    nk._newton_lib()
    sk._sparse_lib()
    ck._cache_lib()
    sck._screen_lib()
    lk._ladder_lib()
    qk._qsts_lib()
    tk._topo_lib()
    sol._solvers_lib()
    dk._dgi_lib()
    t_all = time.monotonic() - t0
    log(f"build: nvcc x{len(names)} {t_all:.1f} s ("
        + ", ".join(f"{k}.cu {box[k][1]:.1f} s" for k in names) + "), "
        + ", ".join(box[k][0].name for k in names))
    for name in names:
        log(build.build_log(name).strip())


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions, then timings
# ---------------------------------------------------------------------------


def case_system(name):
    from freedm_tpu_torch.grid.cases import synthetic_mesh
    from freedm_tpu_torch.grid.matpower import load_builtin

    if name.startswith("mesh"):
        return synthetic_mesh(int(name[4:]), seed=1, load_mw=10.0,
                              chord_frac=1.0)
    return load_builtin(name)


def newton_inputs(torch, sys_, lanes, seed):
    """Random (θ, V) states and scaled injections for one case on the
    card, plus the case's Ybus and masks — the K1/K2 argument tuple."""
    from freedm_tpu_torch.grid.bus import PQ, SLACK, ybus_dense

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    n = sys_.n_bus
    f64 = torch.float64

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=f64, device=dev)

    scale = rng.uniform(0.5, 1.2, (lanes, 1))
    x = np.concatenate([rng.uniform(-0.3, 0.3, (lanes, n)),
                        rng.uniform(0.9, 1.1, (lanes, n))], axis=1)
    y_re, y_im = ybus_dense(sys_, dtype=f64, device=dev)
    bt = np.asarray(sys_.bus_type)
    return (t(x), y_re, y_im, t(scale * sys_.p_inj), t(scale * sys_.q_inj),
            t(bt != SLACK), t(bt == PQ), t(sys_.v_set))


def max_err(a, b):
    return float((a - b).abs().max())


#: K2's lane counts: 67 is one full 64-lane tile of the tiled product and a
#: ragged one (K1 and K3 run at the others).
K2_LANES = (1, 3, MAIN_LANES, 67)


def compare_injections(torch, nk, args):
    """K2 against its plain version on ``args`` (f64 and their float32
    cast), each bit-identical on repeat; returns the largest |Δ| a dtype
    and the float64 plain outputs."""
    gaps, plain64 = [], None
    for dtype in (torch.float64, torch.float32):
        a = args if dtype == torch.float64 else [t.float() for t in args]
        got, again = nk.power_injections(*a), nk.power_injections(*a)
        want = nk.power_injections_plain(*a)
        check(all(same_bits(torch, x, y) for x, y in zip(got, again)),
              f"K2 not bit-identical on repeat ({dtype})")
        gaps.append(max(max_err(x, y) for x, y in zip(got, want)))
        plain64 = want if plain64 is None else plain64
    return gaps, plain64


def compare_kernels(torch, nk, errs):
    """Each kernel against its plain version at every (case, lanes); K2
    also in float32 and at 67 lanes."""
    cases = ("case14", "case_ieee30", "mesh118", "mesh2000")
    worst32 = 0.0
    for ci, name in enumerate(cases):
        sys_ = case_system(name)
        for lanes in K2_LANES:
            args = newton_inputs(torch, sys_, lanes, seed=100 * ci + lanes)
            (e2, e2_32), (p_p, q_p, g_p) = compare_injections(torch, nk, args)
            check(e2 <= KERNEL_ATOL, f"K2 disagrees on {name} B={lanes}: {e2}")
            check(e2_32 <= KERNEL_ATOL_F32,
                  f"float32 K2 disagrees on {name} B={lanes}: {e2_32}")
            errs["power_injections"] = max(errs["power_injections"], e2)
            worst32 = max(worst32, e2_32)
            line = (f"kernels: {name:>11} n={sys_.n_bus:<5} B={lanes:<3} "
                    f"K2 {e2:.2e} (f32 {e2_32:.2e}, "
                    f"{nk.product_splits(sys_.n_bus, lanes)} K slices)")
            if lanes != 67:
                jac_k, f_k = nk.newton_assemble(*args)
                jac_p, f_p = nk.newton_assemble_plain(*args)
                e_jac = float(jac_k.sub_(jac_p).abs_().max())
                del jac_k, jac_p
                e1 = max(e_jac, max_err(f_k, f_p))
                e3 = compare_update(torch, nk, args[0], f_p, lanes, ci)
                torch.cuda.synchronize()
                line += f"  K1 {e1:.2e}  K3 {e3:.2e}"
                check(e1 <= KERNEL_ATOL,
                      f"K1 disagrees on {name} B={lanes}: {e1}")
                check(e3 == 0.0, f"K3 disagrees on {name} B={lanes}: {e3}")
                errs["newton_assemble"] = max(errs["newton_assemble"], e1)
                errs["newton_update"] = max(errs["newton_update"], e3)
                del f_k, f_p
            log(line)
            del args, p_p, q_p, g_p
            torch.cuda.empty_cache()
    # float32, the kernels' other instantiation: sums of ~1e2-sized terms
    # in another order differ by a few float32 ulps of the largest term;
    # K3's max and add are exact in any dtype.
    args = [a.float() for a in newton_inputs(torch, case_system("mesh118"),
                                             3, seed=1)]
    f32 = nk.newton_assemble_plain(*args)
    e32 = max(max_err(k, p) for k, p in zip(
        nk.newton_assemble(*args) + nk.power_injections(*args),
        f32 + nk.power_injections_plain(*args)))
    e32_k3 = compare_update(torch, nk, args[0], f32[1], 3, seed=5)
    log(f"kernels: float32 mesh118 B=3 K1/K2 {e32:.2e}  K3 {e32_k3:.2e}; "
        f"K2 float32 at every shape above within {worst32:.2e}")
    check(e32 <= KERNEL_ATOL_F32, f"float32 K1/K2 disagree: {e32}")
    check(e32_k3 == 0.0, f"float32 K3 disagrees: {e32_k3}")
    return worst32


def compare_update(torch, nk, x, f, lanes, seed):
    """K3 against its plain version, with a NaN lane and a lane at
    max_iter when there are lanes enough; returns the max |Δ| (NaNs
    must sit in the same places)."""
    dev, dtype = x.device, x.dtype
    rng = np.random.default_rng(seed)
    m = x.shape[1]
    max_iter = 5
    f = f.clone()
    if lanes >= 3:
        f[1, m // 3] = float("nan")
    it = torch.as_tensor(rng.integers(0, max_iter, lanes), dtype=torch.int32,
                         device=dev)
    if lanes >= 3:
        it[2] = max_iter
    err = torch.as_tensor(rng.uniform(0.0, 1e-6, lanes), dtype=dtype,
                          device=dev)
    active = torch.as_tensor(rng.uniform(size=lanes) < 0.8, device=dev)
    if lanes >= 3:
        active[1] = True
    free = torch.as_tensor(rng.uniform(size=m) < 0.9, dtype=dtype, device=dev)
    dx = torch.as_tensor(rng.normal(0, 1e-3, (lanes, m)), dtype=dtype,
                         device=dev)
    tol = torch.full((1,), 1e-8 if dtype == torch.float64 else 3e-5,
                     dtype=dtype, device=dev)
    states = []
    for fn in (nk.newton_update, nk.newton_update, nk.newton_update_plain):
        st = (x.clone(), it.clone(), err.clone(), active.clone())
        fn(st[0], dx, f, free, st[1], st[2], st[3], max_iter, tol)
        states.append(st)
    (xk, ik, ek, ak), again, (xp, ip, ep, ap) = states
    check(all(same_bits(torch, a, b) for a, b in zip((xk, ek), again[::2]))
          and torch.equal(ik, again[1]) and torch.equal(ak, again[3]),
          f"K3 not bit-identical on repeat: B={lanes} {dtype}")
    same_nan = bool(torch.equal(torch.isnan(ek), torch.isnan(ep)))
    if not (same_nan and torch.equal(ik, ip) and torch.equal(ak, ap)):
        return float("inf")
    fin = ~torch.isnan(ep)
    return max(max_err(xk, xp), max_err(ek[fin], ep[fin]))


def time_ms(torch, fn, reps, warmup=1):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms_by_kernel(torch, fn, reps):
    """Mean device time of one call of ``fn`` by kernel name: the kernel
    rows of a ``torch.profiler`` trace over ``reps`` calls (after one warm
    call), without the host's launch cost that CUDA events over
    back-to-back calls also count when a call launches faster than Python
    issues it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    rows = {}
    # A trace now and then comes back without its device events (seen once
    # in a hundred-odd windows on the H100; on one machine three windows
    # in a row): take another window then, and after three the call's
    # device time by CUDA events queued behind a sleep, under one row.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = {e.key: e.self_device_time_total / 1e3 / reps
                for e in prof.key_averages()
                if str(getattr(e, "device_type", "")).endswith("CUDA")
                and getattr(e, "self_device_time_total", 0) > 0}
        if rows:
            return rows
    # A time only: no caller checks kernel names in these rows.
    log("timing: three profiler windows held no device time; the call's "
        "device time by queued CUDA events instead (no per-kernel split)")
    return {"(queued CUDA events, all kernels)": queued_events_ms(torch, fn,
                                                                   reps)}


def device_ms(torch, fn, reps):
    """Mean device time of one call of ``fn`` (all its kernels)."""
    return sum(device_ms_by_kernel(torch, fn, reps).values())


#: A sleep of about 2 ms on the card (cycles at ~2 GHz): longer than the
#: host takes to issue one call of any wrapper timed behind it.
QUEUE_SLEEP_CYCLES = 4_000_000


def queued_events_ms(torch, fn, reps):
    """Median device time of one call of ``fn``: CUDA events around it,
    queued behind a sleep kernel so that the host has issued the whole
    call before the card reaches it.  The host's issue time is not
    counted (back-to-back events count it when the host is the slower);
    the gaps between the call's kernels on the card are (the profiler's
    kernel sums leave them out, and came back short for I1 in the whole
    script)."""
    fn()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def bound(bytes_, ops, fp64=True, tensor=False):
    """The larger of the bytes' and the operations' least times, in ms;
    ``tensor``: a dense fp64 product the kernel runs on the tensor cores."""
    t_bytes = bytes_ / PEAK_BYTES * 1e3
    peak = PEAK_FP64_TENSOR if tensor else PEAK_FP64 if fp64 else PEAK_FP32
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_kernels(torch, nk):
    """Times at the main path's shape: mesh2000, 64 lanes, float64."""
    sys_ = case_system("mesh2000")
    args = newton_inputs(torch, sys_, MAIN_LANES, seed=7)
    x, y_re, y_im = args[0], args[1], args[2]
    lanes, n = MAIN_LANES, sys_.n_bus
    m = 2 * n
    w = 8  # float64 bytes
    nnz = int(((y_re != 0) | (y_im != 0)).sum())
    rows = {}

    # K1: reads x, the schedules, Ybus and the masks; writes J and f.
    # Arithmetic: ~20 fp64 operations per nonzero of Ybus per lane (trig
    # products, C and A, the sums, two divisions, a negation) and ~10 per
    # row (diagonal and mismatch); zeros of Ybus need only their writes.
    b1 = w * (lanes * m + 2 * lanes * n + 2 * n * n + 3 * n
              + lanes * m * m + lanes * m)
    o1 = lanes * (20 * nnz + 10 * n)
    k = time_ms(torch, lambda: nk.newton_assemble(*args), reps=5)
    p = time_ms(torch, lambda: nk.newton_assemble_plain(*args), reps=2)
    rows["newton_assemble"] = (k, p, None, *bound(b1, o1))
    time_lu(torch, nk, args)
    torch.cuda.empty_cache()

    # K2: same reads; writes P, Q and f.  4 FMAs (8 operations) per
    # nonzero of Ybus per lane for I = Y V; ~12 per row for V's parts, S
    # and the mismatch.  The dense product the kernel runs has a floor of
    # its own: 8 n^2 B operations at the tensor cores' fp64 rate.
    b2 = w * (lanes * m + 2 * lanes * n + 2 * n * n + 3 * n
              + 2 * lanes * n + lanes * m)
    o2 = lanes * (8 * nnz + 12 * n)
    k = time_ms(torch, lambda: nk.power_injections(*args), reps=20)
    k2_prof = device_ms(torch, lambda: nk.power_injections(*args), reps=20)
    k2_dev = queued_events_ms(torch, lambda: nk.power_injections(*args),
                              reps=20)
    p = time_ms(torch, lambda: nk.power_injections_plain(*args), reps=3)
    # Library yardstick: one complex matmul I = Y V, then S = V conj(I).
    yc = torch.complex(y_re, y_im)
    theta, v = x[:, :n].T.contiguous(), x[:, n:].T.contiguous()
    vc = torch.polar(v, theta)

    def library():
        return vc * torch.matmul(yc, vc).conj()

    lib = time_ms(torch, library, reps=20)
    rows["power_injections"] = (k, p, lib, *bound(b2, o2))
    del yc, vc
    a32 = [t.float() for t in args]
    k32 = time_ms(torch, lambda: nk.power_injections(*a32), reps=20)
    k32_dev = queued_events_ms(torch, lambda: nk.power_injections(*a32),
                               reps=20)
    p32 = time_ms(torch, lambda: nk.power_injections_plain(*a32), reps=3)
    del a32
    dense_floor = 8 * n * n * lanes / PEAK_FP64_TENSOR * 1e3

    # K3: reads x, dx, f, the mask and the lane carries; writes x and the
    # carries.  ~4 operations per element.
    f = torch.randn(lanes, m, dtype=torch.float64, device=x.device)
    dx = 1e-12 * torch.randn_like(f)
    free = torch.ones(m, dtype=torch.float64, device=x.device)
    it = torch.zeros(lanes, dtype=torch.int32, device=x.device)
    err = torch.zeros(lanes, dtype=torch.float64, device=x.device)
    active = torch.ones(lanes, dtype=torch.bool, device=x.device)
    tol = torch.zeros(1, dtype=torch.float64, device=x.device)
    big = 1 << 30  # every lane stays active: each rep does the full update
    xk, xp = x.clone(), x.clone()
    carries = [(it.clone(), err.clone(), active.clone()) for _ in range(2)]
    # reads x, dx, f, free, it, err, active, tol; writes x, it, err, active
    b3 = (w * (3 * lanes * m + m) + (4 + w + 1) * lanes + w
          + w * lanes * m + (4 + w + 1) * lanes)
    o3 = lanes * m * 4
    k = time_ms(torch, lambda: nk.newton_update(
        xk, dx, f, free, *carries[0], big, tol), reps=100)
    k_dev = device_ms(torch, lambda: nk.newton_update(
        xk, dx, f, free, *carries[0], big, tol), reps=50)
    p = time_ms(torch, lambda: nk.newton_update_plain(
        xp, dx, f, free, *carries[1], big, tol), reps=100)
    rows["newton_update"] = (k, p, None, *bound(b3, o3))
    extra = {"newton_update": {"device_ms": k_dev}}
    k2 = rows["power_injections"]
    extra["power_injections"] = {
        "device_ms": k2_dev, "device_ms_source": "queued events",
        "device_ms_profiler": k2_prof,
        "bound_ms_dense_tensor": dense_floor,
        "k_splits": nk.product_splits(n, lanes),
        "library": "vc * torch.matmul(yc, vc).conj(), complex128",
        "ms_f32": k32, "device_ms_f32": k32_dev, "plain_ms_f32": p32,
        "bound_ms_f32": bound(b2 / 2, o2, fp64=False)[0]}
    log(f"timing: power_injections mesh2000 x{lanes}: device {k2_dev:.4f} ms "
        f"(queued events; profiler {k2_prof:.4f}), {k2[2] / k2_dev:.2f}x "
        f"faster than its library row ({k2_dev / k2[2]:.2f}x its time), "
        f"{nk.product_splits(n, lanes)} K slices; bytes bound {k2[3]:.4f} "
        f"ms, dense tensor-core floor {dense_floor:.4f} ms; float32 event "
        f"{k32:.4f} ms, device {k32_dev:.4f} ms, plain {p32:.4f} ms")
    for name, (k, p, lib, b, by) in rows.items():
        log(f"timing: {name:<17} kernel {k:.4f} ms  plain {p:.4f} ms  "
            f"bound {b:.4f} ms ({by})"
            + (f"  library {lib:.4f} ms" if lib is not None else "")
            + (f"  device {extra[name]['device_ms']:.4f} ms"
               if name in extra else ""))
    return rows, extra


def time_lu(torch, nk, args):
    """The Newton step's library LU (``torch.linalg.solve_ex``, not a
    kernel of the port) on K1's Jacobian at the main path's shape, timed
    as the kernels are; and the same 64 systems solved one at a time,
    the route a later change might take."""
    jac, f = nk.newton_assemble(*args)
    rhs = -f.unsqueeze(-1)
    lanes, m = f.shape
    flop = lanes * (2.0 / 3.0 * m ** 3 + 2.0 * m ** 2)

    def batched():
        return torch.linalg.solve_ex(jac, rhs, check_errors=False)

    def per_lane():
        for b in range(lanes):
            torch.linalg.solve_ex(jac[b], rhs[b], check_errors=False)

    t_b = time_ms(torch, batched, reps=2)
    t_l = time_ms(torch, per_lane, reps=2)
    log(f"timing: LU solve_ex [{lanes}, {m}, {m}] batched {t_b:.1f} ms "
        f"({flop / t_b / 1e9:.2f} TFLOP/s)  one lane at a time "
        f"{t_l:.1f} ms ({flop / t_l / 1e9:.2f} TFLOP/s)")
    del jac, f, rhs


def solve_f32(torch, nk):
    """The float32 solve (the solver's other dtype) on a few lanes:
    kernels against plain versions on the card, and both against the
    float64 kernel solve."""
    from freedm_tpu_torch.pf.newton import make_newton_solver

    sys_ = case_system("mesh118")
    p = np.linspace(0.6, 1.2, 4)[:, None] * sys_.p_inj[None]
    q = np.linspace(0.6, 1.2, 4)[:, None] * sys_.q_inj[None]
    out = {}
    for label, dtype, plain in (("kernels", torch.float32, False),
                                ("plain", torch.float32, True),
                                ("f64", torch.float64, False)):
        solve, _ = make_newton_solver(sys_, dtype=dtype, device="cuda",
                                      plain=plain)
        out[label] = solve(p_inj=p, q_inj=q)
    k, pl, r = out["kernels"], out["plain"], out["f64"]
    dv = max(max_err(k.v, pl.v), max_err(k.theta, pl.theta))
    dref = max(max_err(k.v.double(), r.v), max_err(k.theta.double(), r.theta))
    log(f"solve: float32 mesh118 x4 vs plain |d| {dv:.2e}, vs float64 "
        f"|d| {dref:.2e}, iterations {k.iterations.cpu().tolist()} vs "
        f"{pl.iterations.cpu().tolist()}, max mismatch "
        f"{float(k.mismatch.max()):.2e}")
    check(bool(k.converged.all()) and bool(pl.converged.all()),
          "float32 lanes not converged")
    check(dv <= SOLVE_ATOL_F32 and dref <= SOLVE_ATOL_F32,
          f"float32 solve disagrees: {dv}, {dref}")


# ---------------------------------------------------------------------------
# Phase 3: the batched solver on mesh2000
# ---------------------------------------------------------------------------


def solve_mesh2000(torch, nk):
    from freedm_tpu_torch.pf.newton import make_newton_solver

    sys_ = case_system("mesh2000")
    scales = np.linspace(0.5, 1.2, MAIN_LANES)[:, None]
    p = scales * sys_.p_inj[None]
    q = scales * sys_.q_inj[None]
    solve, _ = make_newton_solver(sys_, backend="dense", device="cuda")
    solve(p_inj=p[:2], q_inj=q[:2])  # warm (cuSOLVER handles, allocator)
    torch.cuda.synchronize()
    nk.reset_launches()
    t0 = time.monotonic()
    r = solve(p_inj=p, q_inj=q)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = nk.launches()
    its = r.iterations.cpu().numpy()
    conv = r.converged.cpu().numpy()
    losses = r.p.sum(dim=1).cpu().numpy()
    load = float(-sys_.p_inj[sys_.p_inj < 0].sum())
    log(f"solve: mesh2000 x{MAIN_LANES} lanes in {wall * 1e3:.1f} ms "
        f"({MAIN_LANES / wall:.1f} lane-solves/s), iterations "
        f"{its.min()}-{its.max()}, max mismatch "
        f"{float(r.mismatch.max()):.2e}, losses {losses.min():.4f}-"
        f"{losses.max():.4f} pu, launches {counts}")
    check(bool(conv.all()), f"mesh2000 lanes not converged: {np.where(~conv)}")
    check(bool(np.all(losses >= -1e-9)), f"negative losses: {losses.min()}")
    check(bool(np.all(losses < 0.05 * load * scales.max())),
          f"losses not small: {losses.max()} pu of {load} pu load")
    check(all(c > 0 for c in counts.values()),
          f"a kernel was not launched by the solve: {counts}")
    idx = [0, MAIN_LANES // 2, MAIN_LANES - 1]
    plain, _ = make_newton_solver(sys_, backend="dense", device="cuda",
                                  plain=True)
    rp = plain(p_inj=p[idx], q_inj=q[idx])
    dv = max_err(r.v[idx], rp.v)
    dth = max_err(r.theta[idx], rp.theta)
    log(f"solve: vs plain on the card, lanes {idx}: |dv| {dv:.2e}, "
        f"|dtheta| {dth:.2e}, iterations {its[idx].tolist()} vs "
        f"{rp.iterations.cpu().tolist()}")
    check(dv <= SOLVE_ATOL and dth <= SOLVE_ATOL,
          f"kernel solve disagrees with the plain solve: {dv}, {dth}")
    check(its[idx].tolist() == rp.iterations.cpu().tolist(),
          "iteration counts differ from the plain solve")
    del r, rp
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phases 4 and 5: the sparse backend — S1-S4 against their plain versions,
# their times, and the sparse solves
# ---------------------------------------------------------------------------

#: Relative tolerances (max |kernel - plain| / max |plain|): S1/S2 differ
#: from their plain versions only in the order of their sums and FMA
#: contraction; S3/S4 also in the Cholesky/triangular-solve order and,
#: for S4, a Jacobi SVD against cuSOLVER's.
SPARSE_TOL = {"float64": (1e-12, 1e-9), "float32": (1e-5, 1e-3)}
#: The one shape S3 is not held to its plain version at SPARSE_TOL: the
#: float32 blocks of the 8-step chain at mesh5000.  The LU-kind
#: preconditioner makes M⁻¹J nearly the identity there, so the chain's
#: eight normalized vectors are nearly parallel: the block's condition
#: after Gram-Schmidt is ~2e5 and its Gram's ~6e10, past float32's 1/eps,
#: and rounding the Gram-Schmidt update once instead of twice moves the
#: plain version's own result by ~6e-3
#: (``tests/test_torch_krylov.py::test_s8_float32_chain_at_mesh5000_is_ill_posed``).
#: Those blocks are held to ``ORTH_F64_LIMIT`` of the float64 result of the
#: same inputs instead (sound float32 results read up to 6e-3 there; the
#: plain algorithm without its second CholQR pass, its ridge or its
#: Gram-Schmidt reads 0.3-1), and their distance from the plain version
#: is printed.
ORTH_F64_LIMIT = 2e-2
ILL_POSED_ORTH = ("mesh5000", "float32", (16, 8))
SPARSE_CASES = (("mesh118", (1, 3, MAIN_LANES)),
                ("mesh2000", (1, 3, MAIN_LANES)),
                ("mesh5000", (1, 3, 8)))
KRYLOV_M, KRYLOV_S = 16, 4
#: GMRES cycles (m, s) whose S3 blocks phase 4 compares at B = 3: the
#: solver's (16, 4) at every lane count, then s = 1 and 8, and 33 basis
#: rows (j0 up to 28).
ORTH_CYCLES = ((KRYLOV_M, KRYLOV_S), (16, 1), (16, 8), (32, 4))


def rel_abs_err(torch, k, p):
    """``(max |k - p| / max |p|, max |k - p|)`` over the finite entries;
    both inf if the NaNs of the two differ in place."""
    if not torch.equal(torch.isnan(k), torch.isnan(p)):
        return float("inf"), float("inf")
    fin = ~torch.isnan(p)
    if not bool(fin.any()):
        return 0.0, 0.0
    scale = float(p[fin].abs().max())
    d = float((k[fin] - p[fin]).abs().max())
    return (d / scale if scale > 0 else d), d


def worst(pairs):
    """Elementwise max of ``(rel, abs)`` pairs."""
    pairs = list(pairs)
    return max(r for r, _ in pairs), max(a for _, a in pairs)


def sparse_setup(torch, sys_, lanes, seed, dtype, pc=None, device="cuda"):
    """Operands, a random state and scaled schedules for one case on the
    card (or ``device``), the FDLF pair (built once per case) and the M⁻¹
    apply."""
    from freedm_tpu_torch.pf.krylov import build_fdlf_precond, fdlf_apply
    from freedm_tpu_torch.pf.sparse import sparse_operands

    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    n = sys_.n_bus
    op = sparse_operands(sys_, dtype=dtype, device=dev)
    scale = rng.uniform(0.5, 1.2, (lanes, 1))

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)

    x = t(np.concatenate([rng.uniform(-0.3, 0.3, (lanes, n)),
                          rng.uniform(0.9, 1.1, (lanes, n))], axis=1))
    ps, qs = t(scale * sys_.p_inj), t(scale * sys_.q_inj)
    if pc is None:
        pc = build_fdlf_precond(sys_, device=dev)

    def m_op(u, v):
        return fdlf_apply(pc, op.th_free, op.v_free, u, v, u.dtype)

    return op, x, ps, qs, pc, m_op


def gmres_captures(torch, sk, op, ev, bv, f, x, m_op, m=KRYLOV_M,
                   s=KRYLOV_S):
    """The inputs of every S3 and S4 call of one plain GMRES cycle of
    dimension m and block size s on the Newton system at x (lane 1, when
    there is one, has a zero right-hand side: its chain breaks down at
    once)."""
    from freedm_tpu_torch.pf.krylov import _pgmres_block

    n = op.n
    b = -f.clone()
    if b.shape[0] >= 3:
        b[1] = 0.0
    caps = []
    orth, lstsq = sk.gmres_block_orth_plain, sk.gmres_lstsq_plain

    def spy_orth(vb, valid, w, j0):
        caps.append(("orth", vb.clone(), valid.clone(), w.clone(), j0))
        orth(vb, valid, w, j0)

    def spy_lstsq(vb, valid, ws, zs, beta):
        caps.append(("lstsq", vb.clone(), valid.clone(), ws.clone(),
                     zs.clone(), beta.clone()))
        return lstsq(vb, valid, ws, zs, beta)

    sk.gmres_block_orth_plain, sk.gmres_lstsq_plain = spy_orth, spy_lstsq
    try:
        _pgmres_block(lambda u: sk.sparse_matvec_plain(ev, bv, u, op),
                      lambda u: m_op(u, x[:, n:]), b, m=m, s=s, plain=True)
    finally:
        sk.gmres_block_orth_plain, sk.gmres_lstsq_plain = orth, lstsq
    return caps


def run_orth(fn, cap):
    _, vb, valid, w, j0 = cap
    vb, valid = vb.clone(), valid.clone()
    fn(vb, valid, w, j0)
    return vb, valid


def same_bits(torch, a, b):
    """Bit-for-bit equality (NaNs included)."""
    ints = {torch.float64: torch.int64, torch.float32: torch.int32}
    return a.dtype == b.dtype and torch.equal(a.view(ints[a.dtype]),
                                              b.view(ints[b.dtype]))


def compare_orth(torch, sk, cap, label, tol, f64_limit=None):
    """S3 on one captured block against its plain version; ``(rel, abs)``.
    At the second block of a cycle (j0 = s) with 3 lanes or more, lane 2's
    candidate block holds an inf: its Cholesky fails and the block must
    come out zero.  The kernel runs twice and must give the same bits.
    With ``f64_limit`` (``ILL_POSED_ORTH``) the block is held to that
    distance from the float64 result instead, and the returned error is
    that of the ``valid`` flags alone."""
    _, vb, valid, w, j0 = cap
    s_ = w.shape[1]
    fail = w.shape[0] >= 3 and j0 == s_
    if fail:
        w = w.clone()
        w[2, 0, 0] = float("inf")
    cap = ("orth", vb, valid, w, j0)
    vk, ak = run_orth(sk.gmres_block_orth, cap)
    vk2, ak2 = run_orth(sk.gmres_block_orth, cap)
    check(same_bits(torch, vk, vk2) and same_bits(torch, ak, ak2),
          f"S3 not bit-identical on repeat: {label} s={s_} j0={j0}")
    vp, ap = run_orth(sk.gmres_block_orth_plain, cap)
    if fail:
        rows = slice(j0 + 1, j0 + 1 + s_)
        check(bool((vk[2, rows] == 0).all()) and bool((ak[2, rows] == 0).all()),
              f"S3 kept a failed block: {label} s={s_}")
    d_valid = float((ak - ap).abs().max())
    err = rel_abs_err(torch, vk, vp)
    if f64_limit is None:
        return worst([err, (d_valid, d_valid)])
    c64 = ("orth", vb.double(), valid.double(), w.double(), j0)
    ref, _ = run_orth(sk.gmres_block_orth_plain, c64)
    e_k = rel_abs_err(torch, vk.double(), ref)[0]
    e_p = rel_abs_err(torch, vp.double(), ref)[0]
    log(f"sparse kernels: {label} S3 s={s_} j0={j0}: kernel vs plain "
        f"{err[0]:.2e}; vs the float64 result kernel {e_k:.2e} (limit "
        f"{f64_limit:g}), plain {e_p:.2e}")
    check(e_k <= f64_limit, f"gmres_block_orth {label} s={s_} j0={j0}: "
                            f"{e_k} from the float64 result > {f64_limit}")
    return d_valid, d_valid


def compare_lstsq(torch, sk, cap, label, served=False):
    """S4 on one captured cycle against its plain version; ``(rel,
    abs)``.  Also on the same cycle with four dead rows of V·valid (a
    rank-deficient H) and, with 3 lanes or more, with an inf in lane 0's
    basis and a NaN β in lane 2 (NaN lanes, in the same places as the
    plain version's).  The kernel runs twice and must give the same bits.
    ``served``: also the sweeps of the Jacobi SVD on this cycle, from
    S4's PyTorch mirror, whose solution is held to the kernel's."""
    _, vb, valid, ws, zs, beta = cap
    xk = sk.gmres_lstsq(vb, valid, ws, zs, beta)
    check(same_bits(torch, xk, sk.gmres_lstsq(vb, valid, ws, zs, beta)),
          f"S4 not bit-identical on repeat: {label}")
    errs = [rel_abs_err(torch, xk, sk.gmres_lstsq_plain(vb, valid, ws, zs,
                                                        beta))]
    dead = valid.clone()
    dead[:, 5:9] = 0.0
    errs.append(rel_abs_err(torch, sk.gmres_lstsq(vb, dead, ws, zs, beta),
                            sk.gmres_lstsq_plain(vb, dead, ws, zs, beta)))
    if vb.shape[0] >= 3:
        vbad, bbad = vb.clone(), beta.clone()
        vbad[0, 3, 7] = float("inf")
        bbad[2] = float("nan")
        xbad = sk.gmres_lstsq(vbad, valid, ws, zs, bbad)
        check(bool(torch.isnan(xbad[[0, 2]]).all())
              and not bool(torch.isnan(xbad[1]).any()),
              f"S4's NaN lanes are not lanes 0 and 2: {label}")
        errs.append(rel_abs_err(torch, xbad, sk.gmres_lstsq_plain(
            vbad, valid, ws, zs, bbad)))
    if served:
        xm, sweeps = sk.gmres_lstsq_jacobi(vb, valid, ws, zs, beta)
        e_m = rel_abs_err(torch, xk, xm)[0]
        sw = sweeps.cpu().numpy()
        log(f"sparse kernels: {label} S4 Jacobi sweeps (mirror) "
            f"{sw.min()}-{sw.max()}, mean {sw.mean():.2f} over {len(sw)} "
            f"lanes; kernel vs mirror {e_m:.2e}")
        tol = SPARSE_TOL[str(vb.dtype)[6:]][1]
        check(e_m <= tol, f"S4 disagrees with its mirror on {label}: {e_m}")
    return worst(errs)


def check_forms(torch, sk, cap, label):
    """S3 reading its rows from global memory gives the bits of its
    shared-memory form (the same cluster, the same arithmetic)."""
    _, vb, valid, w, j0 = cap
    nrows, nvec = vb.shape[1:]
    outs = []
    for r in (None, False):
        plan = sk.block_orth_plan(nvec, nrows, w.shape[1], j0,
                                  vb.element_size(), resident=r)
        vk, ak = vb.clone(), valid.clone()
        sk._launch_block_orth(vk, ak, w, j0, plan)
        outs.append((vk, ak))
    (v1, a1), (v2, a2) = outs
    check(same_bits(torch, v1, v2) and same_bits(torch, a1, a2),
          f"S3's two forms differ: {label} j0={j0}")


def ordered_bus_sums(torch, op, ev, x):
    """P and Q [B, n] from the c/a values S1 wrote into ``ev`` (rows 1 and
    0 of ``[B, 4, 2m]``), summed per bus as S1 sums them: the from-side
    terms, then the to-side terms, each in incidence-list order, one
    rounded operation at a time; then ``(P_from + P_to) + V² g_d`` and
    ``(Q_from + Q_to) − V² b_d``."""
    ptr = op.inc_ptr.cpu().numpy().astype(np.int64)
    side = op.inc_code.cpu().numpy() & 1
    deg = np.diff(ptr)
    dev = ev.device
    sums = {(s_, k): torch.zeros_like(x[:, :op.n])
            for s_ in (0, 1) for k in (1, 0)}
    for slot in range(int(deg.max())):
        has = deg > slot
        r = np.where(has, ptr[:-1] + slot, 0)
        entry = torch.as_tensor(r, device=dev)
        for s_ in (0, 1):
            mask = torch.as_tensor(has & (side[r] == s_), device=dev)
            for k in (1, 0):
                acc = sums[s_, k]
                acc.copy_(torch.where(mask, acc + ev[:, k][:, entry], acc))
    v = x[:, op.n:]
    v2 = v * v
    p = (sums[0, 1] + sums[1, 1]) + v2 * op.g_d
    q = (sums[0, 0] + sums[1, 0]) - v2 * op.b_d
    return p, q


def compare_assemble(torch, sk, op, x, ps, qs, label, status=None):
    """S1 in each of its modes against its plain version (each output at
    ``SPARSE_TOL`` of its own dtype), twice on identical inputs (identical
    bits), and the modes against each other bit for bit: ``VALUES_F32``'s
    ``ev``/``bv`` are ``FULL``'s cast to float32 and its ``f`` is
    ``FULL``'s; ``RESIDUAL``'s ``p``, ``q``, ``f`` are ``FULL``'s ``bv[:,
    4]``, ``bv[:, 5]`` and ``f``; without a ``status``, the bus role's P
    and Q are the ordered sums of the c/a values the edge role wrote
    (:func:`ordered_bus_sums`, on the stored diagonal).  Returns the worst
    ``(rel, abs)`` over the outputs in ``x``'s dtype."""
    modes = [sk.FULL, sk.RESIDUAL]
    if x.dtype == torch.float64:
        modes.append(sk.VALUES_F32)
    out, errs = {}, []
    for mode in modes:
        k = sk.sparse_assemble(x, ps, qs, op, mode, status)
        check(all(same_bits(torch, a, b) for a, b in zip(
            k, sk.sparse_assemble(x, ps, qs, op, mode, status))),
            f"S1 mode {mode} not bit-identical on repeat: {label}")
        for a, b in zip(k, sk.sparse_assemble_plain(x, ps, qs, op, mode,
                                                    status)):
            rel, ab = rel_abs_err(torch, a, b)
            tol = SPARSE_TOL[str(a.dtype)[6:]][0]
            check(rel <= tol, f"sparse_assemble mode {mode} disagrees on "
                              f"{label}: {rel} > {tol}")
            if a.dtype == x.dtype:
                errs.append((rel, ab))
        out[mode] = k
    ev, bv, f = out[sk.FULL]
    p, q, f3 = out[sk.RESIDUAL]
    check(same_bits(torch, p, bv[:, 4].contiguous())
          and same_bits(torch, q, bv[:, 5].contiguous())
          and same_bits(torch, f3, f),
          f"S1's residual mode differs from its full mode: {label}")
    if sk.VALUES_F32 in out:
        ev2, bv2, f2 = out[sk.VALUES_F32]
        check(same_bits(torch, ev2, ev.float())
              and same_bits(torch, bv2, bv.float())
              and same_bits(torch, f2, f),
              f"S1's float32 values are not its float64 values cast: {label}")
    if status is None:
        ps_, qs_ = ordered_bus_sums(torch, op, ev, x)
        check(same_bits(torch, ps_, bv[:, 4].contiguous())
              and same_bits(torch, qs_, bv[:, 5].contiguous()),
              f"S1's P/Q are not the ordered sums of its edge values: "
              f"{label}")
    return worst(errs)


def compare_sparse_kernels(torch, sk, errs):
    """S1-S4 against their plain versions at mesh118/2000/5000, several
    lane counts, float64 and float32, with a breakdown lane and a forced
    Cholesky failure (an inf in a candidate block: its lane's factor is
    all NaN, so the block must come out zero); S3 also over
    ``ORTH_CYCLES``; S2 and S3 bit-identical on repeat, S3 also across
    its two forms."""
    for ci, (name, lane_counts) in enumerate(SPARSE_CASES):
        sys_ = case_system(name)
        pc = None
        for lanes in lane_counts:
            for dtype in (torch.float64, torch.float32):
                tol12, tol34 = SPARSE_TOL[str(dtype).split(".")[-1]]
                label = f"{name} B={lanes} {str(dtype)[6:]}"
                op, x, ps, qs, pc, m_op = sparse_setup(
                    torch, sys_, lanes, 10 * ci + lanes, dtype, pc)
                e1 = compare_assemble(torch, sk, op, x, ps, qs, label)
                ev, bv, f = sk.sparse_assemble_plain(x, ps, qs, op)
                u = torch.randn_like(x)
                y2 = sk.sparse_matvec(ev, bv, u, op)
                e2 = rel_abs_err(torch, y2,
                                 sk.sparse_matvec_plain(ev, bv, u, op))
                check(same_bits(torch, y2, sk.sparse_matvec(ev, bv, u, op)),
                      f"S2 not bit-identical on repeat: {label}")
                e3 = e4 = (0.0, 0.0)
                cycles = ORTH_CYCLES if lanes == 3 else ORTH_CYCLES[:1]
                for m_k, s_k in cycles:
                    caps = gmres_captures(torch, sk, op, ev, bv, f, x, m_op,
                                          m_k, s_k)
                    ill = (name, str(dtype)[6:], (m_k, s_k)) == ILL_POSED_ORTH
                    for cap in caps:
                        if cap[0] == "orth":
                            e3 = worst([e3, compare_orth(
                                torch, sk, cap, label, tol34,
                                ORTH_F64_LIMIT if ill else None)])
                        elif (m_k, s_k) == ORTH_CYCLES[0]:
                            e4 = worst([e4, compare_lstsq(
                                torch, sk, cap, label,
                                served=(name, lanes) == ("mesh2000",
                                                         MAIN_LANES))])
                    if lanes == 3 and (m_k, s_k) == ORTH_CYCLES[0]:
                        check_forms(torch, sk,
                                    [c for c in caps if c[0] == "orth"][-1],
                                    label)
                torch.cuda.synchronize()
                log(f"sparse kernels: {name:>8} B={lanes:<3} {str(dtype)[6:]:<7}"
                    f" relative S1 {e1[0]:.1e}  S2 {e2[0]:.1e}  S3 {e3[0]:.1e}"
                    f"  S4 {e4[0]:.1e}")
                for kname, (rel, ab), tol in (
                        ("sparse_matvec", e2, tol12),
                        ("gmres_block_orth", e3, tol34),
                        ("gmres_lstsq", e4, tol34)):
                    check(rel <= tol, f"{kname} disagrees on {label}: "
                                      f"{rel} > {tol}")
                    if dtype == torch.float64:
                        errs[kname] = max(errs[kname], ab)
                if dtype == torch.float64:
                    errs["sparse_assemble"] = max(errs["sparse_assemble"],
                                                  e1[1])
                del ev, bv, f, caps
        del pc
        torch.cuda.empty_cache()


def sparse_library_matvec(torch, op, ev, bv):
    """One ``torch.sparse.mm`` of a block-diagonal CSR matrix holding every
    lane's J (from S1's values; pinned rows identity) — S2's library
    yardstick, built here and never called by the port."""
    lanes, n = ev.shape[0], op.n
    dev = ev.device
    i, j = op.inc_rows(), op.inc_nbr.long()
    ar = torch.arange(n, device=dev)
    # (row, column, sign) of each of ev's four rows, then bv's diagonals.
    entries = ((i, j, 1), (n + i, j, -1), (i, n + j, 1), (n + i, n + j, 1))
    r_list, c_list, v_list = [], [], []
    for k, (r, c, sign) in enumerate(entries):
        r_list.append(r)
        c_list.append(c)
        v_list.append(sign * ev[:, k])
    for k, (r, c) in enumerate(((ar, ar), (ar, n + ar), (n + ar, ar),
                                (n + ar, n + ar))):
        r_list.append(r)
        c_list.append(c)
        v_list.append(bv[:, k])
    r = torch.cat(r_list)
    c = torch.cat(c_list)
    v = torch.cat(v_list, dim=1)  # [B, nnz]
    free = torch.cat([op.th_free, op.v_free])
    keep = free[r] > 0
    r, c, v = r[keep], c[keep], v[:, keep]
    pinned = torch.nonzero(free == 0).flatten()
    r = torch.cat([r, pinned])
    c = torch.cat([c, pinned])
    v = torch.cat([v, torch.ones(lanes, pinned.numel(), dtype=v.dtype,
                                 device=dev)], dim=1)
    off = (torch.arange(lanes, device=dev) * 2 * n)[:, None]
    idx = torch.stack([(r[None] + off).flatten(), (c[None] + off).flatten()])
    mat = torch.sparse_coo_tensor(idx, v.flatten(),
                                  (lanes * 2 * n, lanes * 2 * n))
    return mat.coalesce().to_sparse_csr()


#: S1's modes as the kernel table names them (suffixes of its fields).
ASSEMBLE_MODES = (("", "FULL"), ("_values_f32", "VALUES_F32"),
                  ("_residual", "RESIDUAL"))


def time_assemble(torch, sk, op, x, ps, qs, rows, extra):
    """S1 in each mode at the main path's shape by CUDA events and device
    time, beside its plain version and its bound; the float64 full mode is
    the table row, the other modes (and float32) fields of its entry."""
    lanes, n, m = x.shape[0], op.n, op.m
    f64 = x.dtype == torch.float64
    w, iw = x.element_size(), 4
    # Every mode reads x and the schedules once, the incidence list with
    # its entries' admittances and the per-bus operands; the full modes
    # write ev, bv (in float32 for VALUES_F32) and f, the residual P, Q
    # and f.  Operations: ~45 per
    # edge and lane (sincos ~20), ~25 per bus and lane plus 1 per
    # incidence; the residual needs the edges' c/a terms (~35) and the
    # sums (~15 per bus).
    reads = (w * (4 * lanes * n + 4 * m + 5 * n)
             + iw * (n + 1 + 4 * m))
    for sfx, name in ASSEMBLE_MODES:
        if name == "VALUES_F32" and not f64:
            continue
        mode = getattr(sk, name)
        vw = 4 if name == "VALUES_F32" else w
        if name == "RESIDUAL":
            b1 = reads + w * 4 * lanes * n
            o1 = lanes * (35 * m + 15 * n + 2 * m)
        else:
            b1 = reads + vw * lanes * (8 * m + 6 * n) + w * 2 * lanes * n
            o1 = lanes * (45 * m + 25 * n + 2 * m)
        k = time_ms(torch, lambda: sk.sparse_assemble(x, ps, qs, op, mode),
                    reps=50)
        k_dev = device_ms(torch, lambda: sk.sparse_assemble(x, ps, qs, op,
                                                            mode), reps=20)
        p = time_ms(torch, lambda: sk.sparse_assemble_plain(x, ps, qs, op,
                                                            mode), reps=10)
        b, by = bound(b1, o1, fp64=f64)
        key = sfx + ("" if f64 else "_f32")
        if not key:
            rows["sparse_assemble"] = (k, p, None, b, by)
        else:
            extra["sparse_assemble"].update({
                "ms" + key: k, "plain_ms" + key: p, "bound_ms" + key: b,
                "library_ms" + key: None})
        extra["sparse_assemble"]["device_ms" + key] = k_dev
        log(f"timing: sparse_assemble{key:<15} kernel {k:.4f} ms (device "
            f"{k_dev:.4f})  plain {p:.4f} ms  bound {b:.4f} ms ({by})")


def time_sparse_kernels(torch, sk):
    """Each of S1-S4 at the main path's shape (mesh2000, 64 lanes,
    float64) against its plain version, its bound and, for S2, the
    library sparse product (for S4 the SVD minimum-norm solve of its H,
    ``torch.linalg.pinv``), by
    CUDA events and by device time; S2-S4
    (and the library product) also in float32, the dtype of the default
    mixed path's inner solve.  Returns ``(rows, extra)``: the float64
    table rows and the further fields of their table entries."""
    sys_ = case_system("mesh2000")
    lanes, n, m = MAIN_LANES, sys_.n_bus, sys_.n_branch
    nvec, iw = 2 * n, 4
    rows = {}
    extra = {"sparse_assemble": {}, "sparse_matvec": {},
             "gmres_block_orth": {}, "gmres_lstsq": {}}
    for dtype in (torch.float64, torch.float32):
        f64 = dtype == torch.float64
        sfx = "" if f64 else "_f32"
        w = 8 if f64 else 4
        op, x, ps, qs, pc, m_op = sparse_setup(torch, sys_, lanes, 3, dtype)
        time_assemble(torch, sk, op, x, ps, qs, rows, extra)
        ev, bv, f = sk.sparse_assemble(x, ps, qs, op)
        # S2: reads u, ev, the four diagonals, masks, the incidence
        # pointers and far ends; writes y.  4 FMAs (8 operations) per
        # incidence and lane, 4 per row.
        u = torch.randn_like(x)
        b2 = (w * (lanes * nvec + 8 * lanes * m + 4 * lanes * n + 2 * n
                   + lanes * nvec) + iw * (n + 1 + 2 * m))
        o2 = lanes * (2 * m * 8 + 8 * n)
        k = time_ms(torch, lambda: sk.sparse_matvec(ev, bv, u, op), reps=200)
        k_dev = device_ms(torch, lambda: sk.sparse_matvec(ev, bv, u, op),
                          reps=50)
        p = time_ms(torch, lambda: sk.sparse_matvec_plain(ev, bv, u, op),
                    reps=20)
        csr = sparse_library_matvec(torch, op, ev, bv)
        ucol = u.reshape(-1, 1)
        e_lib = rel_abs_err(torch, (csr @ ucol).reshape(lanes, nvec),
                            sk.sparse_matvec(ev, bv, u, op))[0]
        lib_tol = SPARSE_TOL[str(dtype)[6:]][0]
        check(e_lib <= lib_tol,
              f"library CSR product disagrees with S2 ({dtype}): {e_lib}")
        lib = time_ms(torch, lambda: csr @ ucol, reps=200)
        lib_dev = device_ms(torch, lambda: csr @ ucol, reps=50)
        b, by = bound(b2, o2, fp64=f64)
        if f64:
            rows["sparse_matvec"] = (k, p, lib, b, by)
        else:
            extra["sparse_matvec"].update(
                ms_f32=k, plain_ms_f32=p, bound_ms_f32=b, library_ms_f32=lib)
        extra["sparse_matvec"].update(
            {"device_ms" + sfx: k_dev, "library_device_ms" + sfx: lib_dev})
        log(f"timing: sparse_matvec{sfx:<4} kernel {k:.4f} ms (device "
            f"{k_dev:.4f})  plain {p:.4f} ms  bound {b:.4f} ms ({by})  "
            f"library torch.sparse.mm {lib:.4f} ms (device {lib_dev:.4f})")
        del csr
        # S3 and S4 on the inputs of a real cycle at this state.
        caps = gmres_captures(torch, sk, op, ev, bv, f, x, m_op)
        orth = [c for c in caps if c[0] == "orth"][-1]  # j0 = 12
        _, vb, valid, wb, j0 = orth
        s_ = wb.shape[1]
        vk, vp = vb.clone(), vb.clone()
        ak, ap = valid.clone(), valid.clone()
        b3 = w * lanes * ((j0 + 1) * nvec + s_ * nvec + s_ * nvec
                          + (j0 + 1) + s_)
        o3 = lanes * nvec * (2 * 4 * s_ * (j0 + 1) + 2 * 3 * s_ * s_)
        k = time_ms(torch, lambda: sk.gmres_block_orth(vk, ak, wb, j0),
                    reps=50)
        k_dev = device_ms(torch, lambda: sk.gmres_block_orth(vk, ak, wb, j0),
                          reps=20)
        p = time_ms(torch, lambda: sk.gmres_block_orth_plain(vp, ap, wb, j0),
                    reps=10)
        b, by = bound(b3, o3, fp64=f64)
        plan = sk.block_orth_plan(nvec, vb.shape[1], s_, j0, w)
        if f64:
            rows["gmres_block_orth"] = (k, p, None, b, by)
        else:
            extra["gmres_block_orth"].update(
                ms_f32=k, plain_ms_f32=p, bound_ms_f32=b, library_ms_f32=None)
        extra["gmres_block_orth"]["device_ms" + sfx] = k_dev
        log(f"timing: gmres_block_orth{sfx:<4} kernel {k:.4f} ms (device "
            f"{k_dev:.4f})  plain {p:.4f} ms  bound {b:.4f} ms ({by})  "
            f"[j0={j0}, s={s_}, cluster {plan.cluster}, "
            f"{plan.smem} B shared, resident {plan.resident}]")
        _, vb, valid, ws, zs, beta = caps[-1]
        mm = ws.shape[1]
        # S4: reads V, valid, W, Z and beta, writes x.  2 (mm+1) mm
        # operations per column for H, 2 mm for x = Z^T y (the SVD's few
        # thousand are nothing beside them).
        b4 = w * lanes * ((mm + 1) * nvec + (mm + 1) + 2 * mm * nvec + 1
                          + nvec)
        o4 = lanes * nvec * (2 * (mm + 1) * mm + 2 * mm)
        k = time_ms(torch, lambda: sk.gmres_lstsq(vb, valid, ws, zs, beta),
                    reps=50)
        parts = device_ms_by_kernel(
            torch, lambda: sk.gmres_lstsq(vb, valid, ws, zs, beta), reps=20)
        k_dev = sum(parts.values())
        p = time_ms(torch, lambda: sk.gmres_lstsq_plain(vb, valid, ws, zs,
                                                        beta), reps=10)
        b, by = bound(b4, o4, fp64=f64)
        plan = sk.lstsq_plan(nvec, mm, w)
        # The library yardstick: the SVD minimum-norm solve of the same
        # float64 H [B, mm+1, mm] and β e₁ with S4's cutoff,
        # torch.linalg.pinv and its product — the least-squares solve
        # alone, without H = Vᵀ W and x = Zᵀ y.  torch.linalg.lstsq on the
        # card takes only full-rank H (LAPACK's gels) and refuses a cycle
        # whose lanes have dead rows.
        h = (vb * valid[:, :, None]).double() @ ws.double().mT
        e1 = torch.zeros(lanes, mm + 1, 1, dtype=torch.float64,
                         device=h.device)
        e1[:, 0, 0] = beta.double()
        rtol = torch.finfo(dtype).eps * (mm + 1)
        lib = time_ms(torch, lambda: torch.linalg.pinv(h, rtol=rtol) @ e1,
                      reps=20)
        if f64:
            rows["gmres_lstsq"] = (k, p, lib, b, by)
        else:
            extra["gmres_lstsq"].update(
                ms_f32=k, plain_ms_f32=p, bound_ms_f32=b, library_ms_f32=lib)
        extra["gmres_lstsq"]["device_ms" + sfx] = k_dev
        extra["gmres_lstsq"]["library"] = (
            "torch.linalg.pinv(H, rtol) @ beta e1 of the same float64 H (the "
            "least-squares solve alone; torch.linalg.lstsq on the card "
            "refuses rank-deficient H)")
        log(f"timing: gmres_lstsq{sfx:<4}      kernel {k:.4f} ms (device "
            f"{k_dev:.4f})  plain {p:.4f} ms  bound {b:.4f} ms ({by})  "
            f"library torch.linalg.pinv @ b {lib:.4f} ms  "
            f"[mm={mm}, {plan.ctas} CTAs a lane, {plan.smem} B shared]; "
            "device by kernel: " + ", ".join(
                f"{name.split('::')[-1].split('<')[0]} {ms:.4f} ms"
                for name, ms in parts.items()))
        if f64:
            # The preconditioner apply (two bf16 products, a library call
            # of the port): reads the two [n, n] bf16 inverses and [B, 2n],
            # writes [B, 2n].
            v = x[:, n:]
            t_apply = time_ms(torch, lambda: m_op(u, v), reps=100)
            b_apply = 2 * 2 * n * n + w * 2 * lanes * nvec
            log(f"timing: precond apply (2 x bf16 [{lanes}, {n}] x [{n}, "
                f"{n}], torch.matmul) {t_apply:.4f} ms  bound "
                f"{b_apply / PEAK_BYTES * 1e3:.4f} ms (bytes)")
        del caps, vb, vk, vp, op, x, ev, bv, f, u
        torch.cuda.empty_cache()
    return rows, extra


#: The last :func:`profile_solve` window: device ms by kernel name, and
#: the busy total.
LAST_PROFILE = {"rows": {}, "busy_ms": 0.0}
#: J1's and J2's kernels by name in a profile: the staged route (the KIND
#: template argument 0 or 1) and the wide route.
RESIDUAL_KERNEL_RE = {
    False: re.compile(r"residual_staged_kernel<\w+, 0,|(?<![a-z_])jvp_kernel<"),
    True: re.compile(r"residual_staged_kernel<\w+, 1,|(?<![a-z_])vjp_kernel<")}


def residual_share(vjp):
    """J1's (or J2's) device ms in the last profile, and its share of the
    device's busy time there."""
    ms = sum(v for k, v in LAST_PROFILE["rows"].items()
             if RESIDUAL_KERNEL_RE[vjp].search(k))
    return ms, ms / max(LAST_PROFILE["busy_ms"], 1e-12)


def profile_solve(torch, fn, label, top=8):
    """One more run of ``fn`` under ``torch.profiler``: device time by
    kernel and the device's busy share of the wall.  Only the kernel
    events count (an aten op's own row repeats its kernels' time); their
    times are summed, so overlap would count twice — this path runs on
    one stream.  Returns ``(operations, busy_ms, wall_ms)``: the device
    operations it recorded (kernel launches and copies), their summed
    device time and the run's wall time.  It records device activity
    alone: with the host's operators recorded too, ``key_averages`` over
    the ~26k device operations of an FDLF N-1 solve (the batched LU's
    kernels) took minutes on the host, and seconds without."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")
              and getattr(e, "self_device_time_total", 0) > 0]
    busy = sum(e.self_device_time_total for e in events)
    LAST_PROFILE["rows"] = {e.key: e.self_device_time_total / 1e3
                            for e in events}
    LAST_PROFILE["busy_ms"] = busy / 1e3
    if not events:
        log(f"profile: {label}: the profiler recorded no device time")
        return 0, 0.0, wall_us / 1e3
    log(f"profile: {label}: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f}%, idle "
        f"{100 - 100 * busy / wall_us:.1f}%)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"profile:   {e.self_device_time_total / 1e3:8.2f} ms "
            f"{e.count:6d}x  {e.key[:90]}")
    return sum(e.count for e in events), busy / 1e3, wall_us / 1e3


def solve_sparse(torch, nk, sk):
    """mesh2000 x 64 on the sparse backend in f64 and in mixed precision:
    every lane converges with losses >= 0; three lanes within 1e-9 pu of
    the plain-version sparse solve and 1e-6 pu of the dense kernel solve.
    Then mesh5000 x 8 with the LU-kind preconditioner."""
    from freedm_tpu_torch.pf.krylov import build_fdlf_precond
    from freedm_tpu_torch.pf.newton import make_newton_solver
    from freedm_tpu_torch.pf.sparse import make_sparse_newton_solver

    sys_ = case_system("mesh2000")
    scales = np.linspace(0.5, 1.2, MAIN_LANES)[:, None]
    p = scales * sys_.p_inj[None]
    q = scales * sys_.q_inj[None]
    idx = [0, MAIN_LANES // 2, MAIN_LANES - 1]
    dense, _ = make_newton_solver(sys_, backend="dense", device="cuda")
    rd = dense(p_inj=p[idx], q_inj=q[idx])
    torch.cuda.synchronize()
    t0 = time.monotonic()
    pc = build_fdlf_precond(sys_, device="cuda")
    torch.cuda.synchronize()
    t_ns = time.monotonic() - t0
    log(f"solve: sparse mesh2000 FDLF pair ({pc.kind}, bf16, Newton-Schulz "
        f"on the card) built in {t_ns * 1e3:.1f} ms")
    load = float(-sys_.p_inj[sys_.p_inj < 0].sum())
    for prec in ("f64", "mixed"):
        solve, _ = make_sparse_newton_solver(sys_, precision=prec,
                                             precond=pc, device="cuda")
        solve(p_inj=p[:2], q_inj=q[:2])  # warm (cuBLAS handles, allocator)
        torch.cuda.synchronize()
        nk.reset_launches()
        sk.reset_launches()
        t0 = time.monotonic()
        r = solve(p_inj=p, q_inj=q)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = {**sk.launches(), **nk.launches()}
        modes = sk.assemble_launches()
        its = r.iterations.cpu().numpy()
        conv = r.converged.cpu().numpy()
        losses = r.p.sum(dim=1).cpu().numpy()
        log(f"solve: sparse {prec:<5} mesh2000 x{MAIN_LANES} in "
            f"{wall * 1e3:.1f} ms ({MAIN_LANES / wall:.1f} lane-solves/s), "
            f"iterations {its.min()}-{its.max()}, fallbacks "
            f"{int(r.fallbacks.sum())}, max mismatch "
            f"{float(r.mismatch.max()):.2e}, losses {losses.min():.4f}-"
            f"{losses.max():.4f} pu, launches {counts}, S1 by mode {modes}")
        steps = counts["gmres_lstsq"]  # one GMRES cycle per batched step
        log(f"solve: sparse {prec:<5} {steps} batched Newton steps; launches "
            f"per step " + ", ".join(
                f"{k} {v / max(steps, 1):g}" for k, v in counts.items() if v))
        kernels = profile_solve(torch, lambda: solve(p_inj=p, q_inj=q),
                                f"sparse {prec} mesh2000 x{MAIN_LANES}")[0]
        log(f"profile: sparse {prec} mesh2000 x{MAIN_LANES}: {kernels} device "
            f"operations (kernels and copies), {kernels / max(steps, 1):.1f} "
            f"per Newton step")
        check(bool(conv.all()),
              f"sparse {prec} lanes not converged: {np.where(~conv)}")
        check(bool(np.all(losses >= -1e-9)), f"negative losses: {losses.min()}")
        check(bool(np.all(losses < 0.05 * load * scales.max())),
              f"losses not small: {losses.max()} pu of {load} pu load")
        # Kernels against plain versions at a tolerance below the
        # comparison's: two correct solves stopped at tol = 1e-8 may sit
        # ~1e-8 pu apart (one stops a step earlier), so both paths run
        # to 1e-11 here.
        pair = [make_sparse_newton_solver(sys_, precision=prec, precond=pc,
                                          tol=TIGHT_TOL, device="cuda",
                                          plain=plain)[0](p_inj=p[idx],
                                                          q_inj=q[idx])
                for plain in (False, True)]
        rk, rp = pair
        dp = max(max_err(rk.v, rp.v), max_err(rk.theta, rp.theta))
        dd = max(max_err(r.v[idx], rd.v), max_err(r.theta[idx], rd.theta))
        log(f"solve: sparse {prec} lanes {idx} at tol {TIGHT_TOL:g}: kernels "
            f"vs plain |d| {dp:.2e} (iterations "
            f"{rk.iterations.cpu().tolist()} vs "
            f"{rp.iterations.cpu().tolist()}); at the default tol vs dense "
            f"|d| {dd:.2e}")
        check(bool(rk.converged.all()) and bool(rp.converged.all()),
              f"sparse {prec} lanes {idx} not converged at {TIGHT_TOL}")
        check(dp <= SOLVE_ATOL, f"sparse {prec} disagrees with plain: {dp}")
        check(dd <= 1e-6, f"sparse {prec} disagrees with dense: {dd}")
        del r, rk, rp, solve, pair
    del pc, rd, dense
    torch.cuda.empty_cache()

    sys5 = case_system("mesh5000")
    p5 = np.linspace(0.6, 1.2, 8)[:, None] * sys5.p_inj[None]
    q5 = np.linspace(0.6, 1.2, 8)[:, None] * sys5.q_inj[None]
    t0 = time.monotonic()
    pc5 = build_fdlf_precond(sys5, device="cuda")
    torch.cuda.synchronize()
    t_build = time.monotonic() - t0
    check(pc5.kind == "lu", f"mesh5000 took the {pc5.kind} preconditioner")
    solve5, _ = make_sparse_newton_solver(sys5, precond=pc5, device="cuda")
    t0 = time.monotonic()
    r5 = solve5(p_inj=p5, q_inj=q5)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    its = r5.iterations.cpu().numpy()
    log(f"solve: sparse auto mesh5000 x8 (LU-kind FDLF pair, factored in "
        f"{t_build * 1e3:.1f} ms) in {wall * 1e3:.1f} ms, iterations "
        f"{its.min()}-{its.max()}, fallbacks {int(r5.fallbacks.sum())}, "
        f"max mismatch {float(r5.mismatch.max()):.2e}")
    check(bool(r5.converged.all()), "mesh5000 lanes not converged")
    check(bool((r5.p.sum(dim=1) >= -1e-9).all()), "mesh5000 negative losses")
    del r5, solve5, pc5
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phases 6 and 7: the served paths, POST /v1/pf
# ---------------------------------------------------------------------------


def post_round(port, case, scales):
    """``len(scales)`` concurrent POST /v1/pf; returns (wall_s,
    [(status, body, latency_s)])."""

    def one(scale):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        body = json.dumps({"case": case, "scale": float(scale),
                           "timeout_s": 240.0})
        t0 = time.monotonic()
        conn.request("POST", "/v1/pf", body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        lat = time.monotonic() - t0
        conn.close()
        return resp.status, json.loads(data), lat

    t0 = time.monotonic()
    with cf.ThreadPoolExecutor(len(scales)) as ex:
        out = list(ex.map(one, scales))
    return time.monotonic() - t0, out


def serve(torch, nk):
    from freedm_tpu_torch.serve.http import ServeServer
    from freedm_tpu_torch.serve.service import ServeConfig, Service

    # Cache off: this phase measures the cold dense path (serve_cache
    # measures the cache).
    svc = Service(ServeConfig(max_batch=MAIN_LANES, pf_backend="dense",
                              device="cuda", cache_mb=0.0))
    server = ServeServer(svc).start()
    try:
        cases = ("case14", "case_ieee30", "mesh118", "mesh2000")
        scales = np.linspace(0.6, 1.2, MAIN_LANES)
        for case in cases:  # engine builds + first dispatch per bucket
            post_round(server.port, case, scales[:4])
        nk.reset_launches()
        multi = False
        for case in cases:
            wall, out = post_round(server.port, case, scales)
            for status, body, _ in out:
                check(status == 200, f"{case}: HTTP {status}: {body}")
                check(body["converged"], f"{case}: not converged: {body}")
                check(body["p_balance_pu"] >= -1e-9,
                      f"{case}: negative losses {body['p_balance_pu']}")
            lanes = [b["batch"]["lanes"] for _, b, _ in out]
            multi = multi or max(lanes) > 1
            lat = np.array([x for _, _, x in out]) * 1e3
            its = [b["iterations"] for _, b, _ in out]
            log(f"serve: {case:>11} {len(out)} requests  "
                f"{len(out) / wall:.1f} solves/s  p50 "
                f"{np.percentile(lat, 50):.1f} ms  p99 "
                f"{np.percentile(lat, 99):.1f} ms  batch lanes max "
                f"{max(lanes)}  iterations {min(its)}-{max(its)}")
        counts = nk.launches()
        log(f"serve: launches {counts}")
        check(multi, "no batch coalesced more than one request")
        check(all(c > 0 for c in counts.values()),
              f"a kernel was not launched on the served path: {counts}")
        return counts
    finally:
        server.stop()
        svc.stop()


def serve_default(torch, sk):
    """The default-config server (``pf_backend="auto"``,
    ``pf_precision="auto"``: sparse and mixed at mesh2000 on the card):
    64 concurrent ``POST /v1/pf`` for mesh2000, every answer 200 and
    converged, one batch with more than one lane; S1-S4 launch counts
    over the burst must be > 0."""
    from freedm_tpu_torch.serve.http import ServeServer
    from freedm_tpu_torch.serve.service import ServeConfig, Service

    # Cache off: this phase measures the cold sparse path (serve_cache
    # measures the cache).
    svc = Service(ServeConfig(max_batch=MAIN_LANES, device="cuda",
                              cache_mb=0.0))
    server = ServeServer(svc).start()
    try:
        scales = np.linspace(0.6, 1.2, MAIN_LANES)
        t0 = time.monotonic()
        post_round(server.port, "mesh2000", scales[:4])  # engine build
        log(f"serve default: engine build + first round "
            f"{time.monotonic() - t0:.2f} s")
        sk.reset_launches()
        wall, out = post_round(server.port, "mesh2000", scales)
        counts = sk.launches()
        modes = sk.assemble_launches()
        for status, body, _ in out:
            check(status == 200, f"default mesh2000: HTTP {status}: {body}")
            check(body["converged"], f"default mesh2000: not converged: {body}")
            check(body["p_balance_pu"] >= -1e-9,
                  f"default mesh2000: negative losses {body['p_balance_pu']}")
        lanes = [b["batch"]["lanes"] for _, b, _ in out]
        lat = np.array([x for _, _, x in out]) * 1e3
        its = [b["iterations"] for _, b, _ in out]
        stats = svc.stats()
        log(f"serve default: mesh2000 {len(out)} requests  "
            f"{len(out) / wall:.1f} solves/s  p50 "
            f"{np.percentile(lat, 50):.1f} ms  p99 "
            f"{np.percentile(lat, 99):.1f} ms  batch lanes max {max(lanes)}  "
            f"iterations {min(its)}-{max(its)}  backend "
            f"{stats['pf_backend']}/{svc.engine('pf', 'mesh2000').pf_backend}"
            f" precision {svc.engine('pf', 'mesh2000').pf_precision}")
        log(f"serve default: launches {counts}, S1 by mode {modes}")
        check(svc.engine("pf", "mesh2000").pf_backend == "sparse",
              "the default server did not take the sparse backend")
        check(max(lanes) > 1, "no batch coalesced more than one request")
        check(all(c > 0 for c in counts.values()),
              f"a sparse kernel was not launched on the served path: {counts}")
        return counts, modes
    finally:
        server.stop()
        svc.stop()


# ---------------------------------------------------------------------------
# Phase 8: the serving cache (C1 and the exact, delta and warm tiers)
# ---------------------------------------------------------------------------

#: C1, the delta program, against its plain version (the host loop of
#: the mismatch modes around ``torch.linalg.lu_solve``, on the card):
#: theta and v within 1e-9 pu in f64 on every lane whose sweep count
#: agrees (the substitutions round in another order, ~1e-15 relative,
#: and each lane stops below tol = 1e-8); within ``CACHE_ATOL`` under
#: mixed, whose float32 solves in two orders propose directions ~1e-6
#: apart (relative), and on a lane one sweep apart.  Sweep counts equal,
#: or one apart on a lane (counted and printed).
PROGRAM_ATOL = {"f64": 1e-9, "mixed": 1e-6}
DELTA_CASES = (("mesh118", (1, 8)), ("mesh2000", (1, 8)),
               ("mesh5000", (1, 8)))
#: Cases whose programs also run with the mirror's solves.
MIRROR_CASES = ("mesh118", "mesh2000")
DELTA_TOL = 1e-8  # the delta program's exit bar (the engines' tolerance)
#: Requests of the serve cache phase: exact repeats and random deltas.
CACHE_REPEATS = 8
CACHE_DELTAS = 16
#: Each answer of the phase against the cache-off service's (pu).
CACHE_ATOL = 1e-6
#: Client threads that send the cache requests while a burst is in flight.
LOAD_CLIENTS = 4
#: Device cycles of the sleep queued on the cache's stream in the stream
#: check (~0.5 s at the H100's 1.98 GHz), and the checks' limits (s): the
#: engine's sync must not wait for it, the cache stream's sync must.
SLEEP_CYCLES = 1_000_000_000
ENGINE_SYNC_LIMIT_S = 0.1
CACHE_SYNC_MIN_S = 0.2
#: Kernels of ``torch.linalg.lu_solve`` that a delta program must not run.
LIBRARY_SOLVE_KERNELS = ("unpack_pivots", "trsv", "trsm", "getrs")


class DeltaCase:
    """One case's delta-program operands on ``dev``: the operands, the
    cached LU pair (``build_fdlf_precond(kind="lu")``, as the serving
    cache builds it) and a converged base state, the plain program from
    the flat start (fast-decoupled sweeps to 1e-11)."""

    def __init__(self, torch, ck, name, dev="cuda"):
        from freedm_tpu_torch.grid.bus import PQ
        from freedm_tpu_torch.pf.krylov import build_fdlf_precond
        from freedm_tpu_torch.pf.mfree import delta_operands

        self.name = name
        self.sys = sys_ = case_system(name)
        self.op = delta_operands(sys_, device=dev)
        self.pc = build_fdlf_precond(sys_, kind="lu", device=dev)
        n = sys_.n_bus
        v_flat = np.where(np.asarray(sys_.bus_type) == PQ, 1.0,
                          np.asarray(sys_.v_set, np.float64))
        flat = [torch.as_tensor(a, dtype=torch.float64, device=dev)[None]
                for a in (np.zeros(n), v_flat, sys_.p_inj, sys_.q_inj)]
        out = ck.delta_program_plain(self.op, self.pc.bp, self.pc.bq, *flat,
                                     100, 1e-11)
        check(float(out[4][0]) < 1e-11, f"{name}: no converged base state")
        self.theta0 = out[0][0].cpu().numpy()
        self.v0 = out[1][0].cpu().numpy()

    def inputs(self, lanes, seed):
        """``lanes`` random 1-16-bus deltas from the base state, as the
        program's ``[lanes, n]`` numpy arguments."""
        d = random_deltas(self.sys, np.random.default_rng(seed), lanes)
        return (np.repeat(self.theta0[None], lanes, 0),
                np.repeat(self.v0[None], lanes, 0),
                np.stack([p for p, _ in d]), np.stack([q for _, q in d]))

    def program(self, ck, precision):
        from freedm_tpu_torch.serve.cache import DELTA_MAX_SWEEPS

        return ck.DeltaProgram(self.op, self.pc.bp, self.pc.bq,
                               DELTA_MAX_SWEEPS, DELTA_TOL,
                               mixed=precision == "mixed")

    def plain(self, torch, ck, args, precision, solve=None):
        """The plain program on the card (``solve``: its triangular
        solve, ``lu_solve`` by default)."""
        from freedm_tpu_torch.serve.cache import DELTA_MAX_SWEEPS

        mixed = precision == "mixed"
        lu_p, lu_q = self.pc.bp, self.pc.bq
        if mixed:
            lu_p = (lu_p[0].float(), lu_p[1])
            lu_q = (lu_q[0].float(), lu_q[1])
        dev = self.op.g_sh.device
        t = [torch.as_tensor(a, dtype=torch.float64, device=dev)
             for a in args]
        return ck.delta_program_plain(self.op, lu_p, lu_q, *t,
                                      DELTA_MAX_SWEEPS, DELTA_TOL, mixed,
                                      solve)


def program_gap(torch, a, b):
    """Per lane: the largest |Δtheta|, |Δv| of two programs' results, and
    their sweep counts."""
    d = torch.maximum((a[0] - b[0]).abs().amax(dim=-1),
                      (a[1] - b[1]).abs().amax(dim=-1))
    return d.cpu().tolist(), a[5].cpu().tolist(), b[5].cpu().tolist()


def compare_program(torch, ck, case, lanes, precision, seed, mirror=False):
    """The kernel's program against the plain one at ``lanes`` random
    deltas (``PROGRAM_ATOL``), run twice (identical bits); with
    ``mirror``, also against the plain program on the mirror's solves
    (printed).  Returns ``(worst gap, lanes one sweep apart, sweeps)``."""
    args = case.inputs(lanes, seed)
    prog = case.program(ck, precision)
    first = [r.clone() for r in prog(*args)]
    again = prog(*args)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(first, again)),
          f"delta program {case.name} B={lanes} {precision}: not "
          f"bit-identical on repeat")
    plain = case.plain(torch, ck, args, precision)
    gaps, sk_, sp_ = program_gap(torch, first, plain)
    apart = 0
    for lane, (g, a, b) in enumerate(zip(gaps, sk_, sp_)):
        check(abs(a - b) <= 1, f"delta program {case.name} B={lanes} "
              f"{precision} lane {lane}: {a} sweeps, plain {b}")
        apart += a != b
        limit = PROGRAM_ATOL[precision] if a == b else CACHE_ATOL
        check(g <= limit, f"delta program {case.name} B={lanes} "
              f"{precision} lane {lane}: {g:.3e} pu off the plain program "
              f"(limit {limit})")
    for k in (2, 3):  # P and Q at the answer
        check(bool(torch.isfinite(first[k]).all()),
              f"delta program {case.name}: non-finite P or Q")
    line = (f"cache kernels: C1 {case.name:>8} B={lanes} {precision:<5} vs "
            f"plain {max(gaps):.2e} pu, sweeps {sk_} (plain {sp_}, {apart} "
            f"lane(s) one apart), bit-identical on repeat")
    if mirror:
        mir = case.plain(torch, ck, args, precision, ck.lu_solve_mirror)
        gm, _, sm = program_gap(torch, first, mir)
        gpm, _, _ = program_gap(torch, plain, mir)
        line += (f"; mirror's solves: kernel {max(gm):.2e} pu, plain "
                 f"{max(gpm):.2e} pu from it, sweeps {sm}")
    log(line)
    return max(gaps), apart, sk_


def compare_delta_programs(torch, ck, errs, extra):
    """C1 against its plain program at mesh118, mesh2000 and mesh5000,
    B ∈ {1, 8}, f64 and mixed.  Returns the cases (their base states are
    reused by the timings)."""
    cases = {}
    worst = {"f64": 0.0, "mixed": 0.0}
    apart = 0
    for ci, (name, lane_counts) in enumerate(DELTA_CASES):
        case = cases[name] = DeltaCase(torch, ck, name)
        for lanes in lane_counts:
            for precision in ("f64", "mixed"):
                g, a, _ = compare_program(
                    torch, ck, case, lanes, precision,
                    seed=300 + 10 * ci + lanes, mirror=name in MIRROR_CASES)
                worst[precision] = max(worst[precision], g)
                apart += a
    errs["delta_program"] = worst["f64"]
    extra["delta_program"] = {"max_abs_err_mixed": worst["mixed"],
                              "lanes_one_sweep_apart": apart}
    return cases


def runtime_calls(prof):
    """CUDA runtime calls in a profile (the host's calls into the card)."""
    return sum(e.count for e in prof.key_averages()
               if e.key.startswith("cuda") and not e.key.startswith("cudaGet"))


def runtime_call_names(prof):
    return ", ".join(f"{e.key} {e.count}" for e in prof.key_averages()
                     if e.key.startswith("cuda")
                     and not e.key.startswith("cudaGet"))


def device_kernels(prof):
    return [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and getattr(e, "self_device_time_total", 0) > 0]


def program_bound(case, sweeps, lanes, mixed):
    """The least time for a program: each input read once (the factor
    pair, the operands and the lanes' states and schedules), each output
    written once; the operations are the substitutions' multiply-adds
    (2 n² a solve, two solves a sweep) for the sweeps this run took."""
    n, m = case.sys.n_bus, case.sys.n_branch
    esz = 4 if mixed else 8
    bytes_ = (2 * n * n * esz + 2 * 4 * n  # factors, permutations
              + 4 * (n + 1) + 8 * 2 * m + 8 * 8 * m + 4 * 8 * n  # operands
              + lanes * (4 * 8 * n + (4 * 8 * n + 16)))  # in, out
    ops = sum(sweeps) * 2 * 2 * n * n + lanes * 50 * 2 * m
    return bound(bytes_, ops, fp64=not mixed)


def time_delta(torch, ck, cases):
    """C1 at the served path's shape (mesh2000, one lane, mixed; also 8
    lanes and f64): CUDA events over back-to-back calls (the wrapper's
    input copy and the launch) and device time per program and per sweep
    from ``torch.profiler``, beside the plain program on the card and the
    bound.  A program's profile must hold C1 alone: no ``lu_solve``
    kernel.  Mixed × 1 is the table row."""
    from torch.profiler import ProfilerActivity, profile

    case = cases["mesh2000"]
    extra = {}
    row = None
    for precision in ("mixed", "f64"):
        prog = case.program(ck, precision)
        for lanes in (1, 8):
            args = case.inputs(lanes, seed=41 + lanes)
            sweeps = prog(*args)[5].cpu().tolist()

            def call():
                return prog(*args)

            k = time_ms(torch, call, reps=20)
            # A window without device events checks nothing: take another,
            # and fail after five, the library-kernel check not made.
            for _ in range(5):
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    for _ in range(5):
                        ck.results_to_host(call())
                kern = device_kernels(prof)
                if kern:
                    break
                log(f"timing: delta program {precision} x{lanes}: a "
                    f"profiler window held no device events; again")
            check(bool(kern), f"delta program {precision} x{lanes}: five "
                  f"profiler windows held no device events, so whether it "
                  f"ran a library solve kernel was not checked")
            names = [e.key for e in kern]
            check(not any(lib in key for key in names
                          for lib in LIBRARY_SOLVE_KERNELS),
                  f"a delta program ran a library solve kernel: {names}")
            dev_ms = sum(e.self_device_time_total for e in kern
                         if "delta_program" in e.key) / 1e3 / 5
            check(dev_ms > 0, "the profiler recorded no C1 device time")
            p = time_ms(torch, lambda: case.plain(torch, ck, args, precision),
                        reps=3)
            b, by = program_bound(case, sweeps, lanes, precision == "mixed")
            per_sweep = dev_ms / max(max(sweeps), 1)
            tag = f"{precision}_B{lanes}"
            extra.update({f"ms_{tag}": k, f"device_ms_{tag}": dev_ms,
                          f"device_ms_per_sweep_{tag}": per_sweep,
                          f"sweeps_{tag}": sweeps, f"plain_ms_{tag}": p,
                          f"bound_ms_{tag}": b,
                          f"runtime_calls_per_program_{tag}":
                              runtime_calls(prof) / 5})
            log(f"timing: delta_program {precision:<5} B={lanes} kernel "
                f"{k:.4f} ms a program (device {dev_ms:.4f} ms, "
                f"{per_sweep:.4f} a sweep, sweeps {sweeps})  plain "
                f"{p:.4f} ms  bound {b:.5f} ms ({by}); profile: "
                f"{', '.join(sorted(set(names)))[:200]}; "
                f"{runtime_calls(prof) / 5:.1f} CUDA runtime calls a program "
                f"({runtime_call_names(prof)}, over 5 programs)")
            if precision == "mixed" and lanes == 1:
                row = (k, p, None, b, by)
                extra["device_ms"] = dev_ms
                extra["device_ms_per_sweep"] = per_sweep
    return {"delta_program": row}, {"delta_program": extra}


def post_pf(port, body):
    """One ``POST /v1/pf``: ``(status, body, latency_s, end)`` (``end`` on
    the monotonic clock)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    t0 = time.monotonic()
    conn.request("POST", "/v1/pf", body=json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = json.loads(resp.read())
    end = time.monotonic()
    conn.close()
    return resp.status, data, end - t0, end


def random_deltas(sys_, rng, count):
    """``count`` injection pairs, each the case's own with 1-16 random
    buses moved by up to ±0.05 pu P and ±0.02 pu Q."""
    p0 = np.asarray(sys_.p_inj, np.float64)
    q0 = np.asarray(sys_.q_inj, np.float64)
    out = []
    for _ in range(count):
        p, q = p0.copy(), q0.copy()
        k = min(int(rng.integers(1, 17)), sys_.n_bus)
        for j in rng.choice(sys_.n_bus, size=k, replace=False):
            p[j] += rng.uniform(-0.05, 0.05)
            q[j] += rng.uniform(-0.02, 0.02)
        out.append((p, q))
    return out


def check_delta(label, status, data):
    check(status == 200, f"{label}: HTTP {status}: {str(data)[:300]}")
    check(data["converged"], f"{label}: not converged")
    check(data["batch"]["tier"] == "delta",
          f"{label}: tier {data['batch']['tier']}, not delta")
    check(data["residual_pu"] <= 1e-8,
          f"{label}: residual {data['residual_pu']}")


def cache_under_load(svc, port, case, deltas):
    """Cache requests while a 64-request burst of the same case is in
    flight, in turns: the burst alone; with :data:`CACHE_DELTAS` new
    deltas of the base case (tier ``delta``, the base case requested just
    before); with the same requests again (now tier
    ``exact``: the same HTTP and JSON work, no device work); twice more
    with new deltas and their repeat; alone.  :data:`LOAD_CLIENTS` client
    threads send a turn's requests, each thread one after another (the
    cache combines deltas that meet into lanes of one program call).  The
    burst's requests carry ``theta0`` = the flat start, which bypasses the
    cache both ways, so every turn's burst is the same cold batched work.
    Checks every answer and that the requests ran while the burst did;
    prints their p50/p99 beside the burst's wall and its
    ``serve_solve_seconds`` (sum over its batches), and their means by
    turn kind.  Returns the delta answers ``[(kind, body, data,
    latency_s)]``."""
    from freedm_tpu_torch.core import metrics as obs

    hist = obs.SERVE_SOLVE_LATENCY.labels("pf")
    n = len(deltas[0][0])
    burst = [{"case": case, "scale": float(x), "theta0": [0.0] * n,
              "timeout_s": 240.0}
             for x in np.linspace(0.6, 1.2, MAIN_LANES)]
    todo = iter(deltas)
    solve = {"alone": [], "delta": [], "exact": []}
    answers = []

    def send(bodies):
        return [(body, *post_pf(port, body)) for body in bodies]

    bodies = []
    for kind in ("alone", "delta", "exact", "delta", "exact", "alone"):
        if kind == "delta":
            bodies = [{"case": case, "p_inj": p.tolist(), "q_inj": q.tolist(),
                       "return_state": True, "timeout_s": 240.0}
                      for p, q in (next(todo) for _ in range(CACHE_DELTAS))]
            # The base case again, so its solution is among the DELTA_SCAN
            # most recent ones the deltas are measured against.
            status, data, _, _ = post_pf(port, {"case": case})
            check(status == 200 and data["batch"]["tier"] == "exact",
                  f"base repeat: HTTP {status}: {str(data)[:300]}")
        mine = bodies if kind != "alone" else []
        s0, c0 = hist.sum, hist.count
        runs0 = svc.stats()["cache"]["delta_runs"]
        with cf.ThreadPoolExecutor(MAIN_LANES + LOAD_CLIENTS) as ex:
            t0 = time.monotonic()
            bfuts = [ex.submit(post_pf, port, body) for body in burst]
            time.sleep(0.05)  # the burst is admitted first
            dfuts = [ex.submit(send, mine[i::LOAD_CLIENTS])
                     for i in range(LOAD_CLIENTS)]
            bout = [f.result() for f in bfuts]
            dout = [x for f in dfuts for x in f.result()]
        burst_end = max(x[3] for x in bout)
        wall = burst_end - t0
        solve_s, batches = hist.sum - s0, hist.count - c0
        solve[kind].append(solve_s)
        for status, data, _, _ in bout:
            check(status == 200, f"load burst: HTTP {status}: "
                  f"{str(data)[:300]}")
            check(data["converged"] and data["batch"]["tier"] == "full",
                  f"load burst: {data['batch']}")
        blat = np.array([x[2] for x in bout]) * 1e3
        line = (f"serve cache: under load, {kind:<5} burst of {len(bout)} "
                f"(theta0 given: no cache) wall {wall * 1e3:.1f} ms, p50 "
                f"{np.percentile(blat, 50):.1f} ms, serve_solve_seconds "
                f"{solve_s * 1e3:.1f} ms over {batches} batches")
        if mine:
            for body, status, data, lat, end in dout:
                if kind == "delta":
                    check_delta("delta under load", status, data)
                    answers.append(("delta_load", body, data, lat))
                else:
                    check(status == 200 and data["batch"]["tier"] == "exact",
                          f"repeat under load: HTTP {status}: "
                          f"{str(data)[:300]}")
            dlat = np.array([x[3] for x in dout]) * 1e3
            inside = sum(x[4] < burst_end for x in dout)
            runs = svc.stats()["cache"]["delta_runs"] - runs0
            line += (f"; {len(dout)} {kind} requests from {LOAD_CLIENTS} "
                     f"clients ({runs} delta programs), p50 "
                     f"{np.percentile(dlat, 50):.2f} ms p99 "
                     f"{np.percentile(dlat, 99):.2f} ms, solve_ms "
                     f"{np.median([x[2]['batch']['solve_ms'] for x in dout]):.2f}"
                     f" (median), {inside} answered before the burst ended")
            check(2 * inside >= len(dout),
                  f"only {inside} of {len(dout)} requests ran during the "
                  f"burst")
        log(line)
    mean = {k: float(np.mean(v)) for k, v in solve.items()}
    log(f"serve cache: the burst's serve_solve_seconds, mean ms: alone "
        f"{mean['alone'] * 1e3:.1f}, with exact repeats "
        f"{mean['exact'] * 1e3:.1f} ({mean['exact'] / mean['alone']:.3f}x), "
        f"with deltas {mean['delta'] * 1e3:.1f} "
        f"({mean['delta'] / mean['alone']:.3f}x)")
    return answers


def serve_cache(torch, ck, sk, dev="cuda", case="mesh2000"):
    """The default-config server with the cache on (cache_mb=64; mesh2000,
    sparse and mixed): prime the base case, repeats (exact), random deltas
    of 1-16 buses (delta), one request with every bus scaled (warm: full,
    ``hits.warm`` + 1), one delta with the verify bar forced to 1e-300
    (falls through to a warm-seeded full solve), then deltas under a burst
    (:func:`cache_under_load`).  Every answer converged and within
    ``CACHE_ATOL`` of the same request on a ``cache_mb=0`` service; every
    delta answer's host-verified residual ≤ 1e-8; the engine's sync does
    not wait for the cache's stream (:func:`stream_isolation`); no
    request's cache tier raised (``/stats`` ``errors`` 0); C1 launched once
    a delta program.  Then the delta program's wall per answer in two
    turns (identical results) and profiled answers' device time, device
    operations and CUDA runtime calls (no ``lu_solve`` kernel among
    them).  Returns C1's launches over the served requests.  (``dev`` and ``case`` let a
    rehearsal run the phase on the CPU at a small case.)"""
    from freedm_tpu_torch.serve.cache import injection_digest
    from freedm_tpu_torch.serve.http import ServeServer
    from freedm_tpu_torch.serve.service import ServeConfig, Service

    card = dev == "cuda"
    svc = Service(ServeConfig(max_batch=MAIN_LANES, device=dev))
    check(svc.cache is not None
          and svc.cache.precision == ("mixed" if card else "f64"),
          "the default server has no cache tier of the default precision")
    server = ServeServer(svc).start()
    try:
        sys_ = case_system(case)
        p0 = np.asarray(sys_.p_inj, np.float64)
        q0 = np.asarray(sys_.q_inj, np.float64)
        rng = np.random.default_rng(2026)
        deltas = random_deltas(sys_, rng, CACHE_DELTAS + 1)
        base = {"case": case}
        plan = ([("full", base)] + [("exact", base)] * CACHE_REPEATS
                + [("delta", {"case": case, "p_inj": p.tolist(),
                              "q_inj": q.tolist()})
                   for p, q in deltas[:CACHE_DELTAS]]
                + [("warm", {"case": case, "scale": 1.1}),
                   ("fallthrough", {"case": case,
                                    "p_inj": deltas[-1][0].tolist(),
                                    "q_inj": deltas[-1][1].tolist()})])
        ck.reset_launches()
        sk.reset_launches()
        answers = []
        for kind, body in plan:
            hits = svc.stats()["cache"]["hits"]
            if kind == "fallthrough":
                svc.cache.verify_tol = 1e-300
            try:
                status, data, lat, _ = post_pf(
                    server.port,
                    {**body, "return_state": True, "timeout_s": 240.0})
            finally:
                svc.cache.verify_tol = None
            after = svc.stats()["cache"]["hits"]
            if kind == "delta":
                check_delta("cache delta", status, data)
            check(status == 200, f"cache {kind}: HTTP {status}: "
                  f"{str(data)[:300]}")
            check(data["converged"], f"cache {kind}: not converged")
            tier = data["batch"]["tier"]
            want = {"full": "full", "exact": "exact", "delta": "delta",
                    "warm": "full", "fallthrough": "full"}[kind]
            check(tier == want, f"cache {kind}: tier {tier}, not {want}")
            if kind in ("warm", "fallthrough"):
                check(after["warm"] == hits["warm"] + 1
                      and after["delta"] == hits["delta"],
                      f"cache {kind}: hits {hits} -> {after}")
            answers.append((kind, body, data, lat))
        c1_counts = ck.launches()
        s_counts = sk.launches()
        stats = svc.stats()["cache"]
        log(f"serve cache: launches C1 {c1_counts}, S1-S4 {s_counts}; "
            f"cache {json.dumps(stats)}")
        check(not card or c1_counts["delta_program"] > 0,
              "C1 was not launched on the served delta path")
        check(not card or c1_counts["delta_program"] == stats["delta_runs"],
              f"C1 launches {c1_counts} are not one a delta program "
              f"({stats['delta_runs']} programs)")
        check(not card or all(c > 0 for c in s_counts.values()),
              f"a sparse kernel was not launched by the full solves: "
              f"{s_counts}")
        eng = svc.engine("pf", case)
        entry = svc.cache.entry(case, eng._sys, eng.cache_backend,
                                topo=eng.cache_topo)
        for kind in ("full", "exact", "delta", "warm", "fallthrough"):
            lat = np.array([a[3] for a in answers if a[0] == kind]) * 1e3
            its = [a[2]["iterations"] for a in answers if a[0] == kind]
            solve = [a[2]["batch"]["solve_ms"] for a in answers
                     if a[0] == kind]
            log(f"serve cache: {kind:<11} {len(lat):2d} requests  p50 "
                f"{np.percentile(lat, 50):.2f} ms  p99 "
                f"{np.percentile(lat, 99):.2f} ms  iterations/sweeps "
                f"{its}  solve_ms {solve}")
        answers += cache_under_load(svc, server.port, case,
                                    random_deltas(sys_, rng,
                                                  2 * CACHE_DELTAS))
        if card:
            stream_isolation(torch, svc, case)
        stats = svc.stats()["cache"]
        log(f"serve cache: after the load turns {json.dumps(stats)}")
        check(stats["errors"] == 0,
              f"the cache tier raised {stats['errors']} time(s): see the log")
    finally:
        server.stop()
        svc.stop()

    cold = Service(ServeConfig(max_batch=MAIN_LANES, device=dev,
                               cache_mb=0.0))
    try:
        worst_d = 0.0
        cold.request("pf", {"case": case, "scale": 0.9})  # engine build
        cold_lat = {}
        for kind, body, data, _ in answers:
            t0 = time.monotonic()
            r = cold.request("pf", {**body, "return_state": True,
                                    "timeout_s": 240.0})
            cold_lat.setdefault(kind, []).append(time.monotonic() - t0)
            check(r.converged, f"cold {kind}: not converged")
            d = max(float(np.max(np.abs(np.array(r.v) - np.array(data["v"])))),
                    float(np.max(np.abs(np.array(r.theta)
                                        - np.array(data["theta"])))))
            worst_d = max(worst_d, d)
            check(d <= CACHE_ATOL, f"cache {kind}: {d:.3e} pu from the "
                  f"cache-off service")
        log(f"serve cache: every answer within {worst_d:.2e} pu of the "
            f"cache-off service (limit {CACHE_ATOL})")
        for kind, lat in cold_lat.items():
            lat = np.array(lat) * 1e3
            log(f"serve cache: the same {kind} requests on the cache-off "
                f"service (in process): p50 {np.percentile(lat, 50):.2f} ms "
                f"p99 {np.percentile(lat, 99):.2f} ms")
    finally:
        cold.stop()

    # The served delta program alone, on a stream of its own, from the
    # base solution to each of the first turn's deltas.
    near = entry.solutions.get(injection_digest(p0, q0))
    check(near is not None, "the base solution was evicted")
    deltas = deltas[:CACHE_DELTAS]
    stream = torch.cuda.Stream() if card else None
    program = entry.ensure_delta_fn()

    def on_stream():
        return (torch.cuda.stream(stream) if card
                else contextlib.nullcontext())

    def run_all():
        outs = []
        t0 = time.monotonic()
        with on_stream():
            for p, q in deltas:
                out = ck.results_to_host(program(near.theta, near.v, p, q))
                outs.append(tuple(np.array(o) for o in out))
        return (time.monotonic() - t0) / len(deltas) * 1e3, outs

    walls = []
    ref_outs = None
    for _ in range(2):
        w, outs = run_all()
        walls.append(w)
        if ref_outs is None:
            ref_outs = outs
        check(all(np.array_equal(a, b) for o1, o2 in zip(outs, ref_outs)
                  for a, b in zip(o1, o2)),
              "the delta program is not bit-identical on repeat")
    sweeps = [int(o[5]) for o in ref_outs]
    log(f"serve cache: delta program sweeps {sweeps} (mean "
        f"{np.mean(sweeps):.2f}); wall per answer {walls[0]:.3f} / "
        f"{walls[1]:.3f} ms (two turns, identical results)")
    from torch.profiler import ProfilerActivity, profile

    # Three answers a window; a window that comes back without device
    # events (now and then on the H100) is taken again.
    answers_in_window = 3
    for _ in range(3):
        with on_stream():
            ck.results_to_host(program(near.theta, near.v, *deltas[0]))
            if card:
                torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.monotonic()
                outs = [ck.results_to_host(program(near.theta, near.v, p, q))
                        for p, q in deltas[:answers_in_window]]
                wall = (time.monotonic() - t0) * 1e3 / answers_in_window
        events = device_kernels(prof)
        if events or not card:
            break
    nsw = float(np.mean([int(o[5]) for o in outs]))
    per = answers_in_window
    c1_us = sum(e.self_device_time_total for e in events
                if "delta_program" in e.key) / per
    other_us = sum(e.self_device_time_total for e in events
                   if "delta_program" not in e.key) / per
    ops = sum(e.count for e in events) / per
    calls = runtime_calls(prof) / per
    log(f"serve cache: profiled delta answers ({per} in the window), "
        f"{nsw:.2f} sweeps each: wall {wall:.3f} ms an answer "
        f"({wall / max(nsw, 1):.3f} ms a sweep); device C1 "
        f"{c1_us / 1e3:.4f} ms ({c1_us / 1e3 / max(nsw, 1):.4f} a sweep), "
        f"copies and the rest {other_us / 1e3:.4f} ms; {ops:.1f} device "
        f"operations and {calls:.1f} CUDA runtime calls an answer "
        f"({runtime_call_names(prof)})")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"profile:   {e.self_device_time_total / 1e3:8.4f} ms "
            f"{e.count:6d}x  {e.key[:240]}")
    if card:
        names = [e.key for e in events]
        check(c1_us > 0, "the profiled delta answer ran no C1")
        check(not any(lib in key for key in names
                      for lib in LIBRARY_SOLVE_KERNELS),
              f"the delta answer ran a library solve kernel: {names}")
    return c1_counts


def stream_isolation(torch, svc, case):
    """The batcher's one sync waits for the solve's stream alone: with a
    ~0.5 s device sleep queued on the cache's stream, the pf engine's
    ``synchronize`` (called from a thread on the default stream, as the
    batcher's lane is) returns at once, and a sync of the cache's stream
    waits for the sleep."""
    eng = svc.engine("pf", case)
    cache = svc.cache
    torch.cuda.synchronize()
    with cache._delta_run:
        with cache._on_stream():
            torch.cuda._sleep(SLEEP_CYCLES)
        t0 = time.monotonic()
        eng.synchronize()
        t_eng = time.monotonic() - t0
        cache._stream.synchronize()
        t_cache = time.monotonic() - t0
    log(f"serve cache: stream check, {SLEEP_CYCLES:.0e} cycles asleep on the "
        f"cache's stream: the engine's sync returned in {t_eng * 1e3:.3f} ms, "
        f"the cache stream's in {t_cache * 1e3:.1f} ms")
    check(t_eng < ENGINE_SYNC_LIMIT_S,
          f"the engine's sync waited {t_eng:.3f} s for the cache's stream")
    check(t_cache > CACHE_SYNC_MIN_S,
          f"the cache stream's sleep took only {t_cache:.3f} s")


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Phase 9: the screening kernels (S1 with status, N1, D1)
# ---------------------------------------------------------------------------

#: S1 with a per-lane status against its plain version: the cases and
#: lane counts (the served N-1 shape is mesh2000 × up to 256 lanes).
STATUS_CASES = (("mesh118", (1, 3, 64, 256)), ("mesh2000", (1, 3, 64, 256)))
#: N1 against its plain version: every mode on identical inputs, θ, V, the
#: right-hand sides, P, Q and err within 1e-12 absolute (the two differ in
#: sin/cos and the order of the lane's sums only; ≤ 3.1e-14 on an H100).
SMW_ATOL = 1e-12
SMW_CASES = ("case_ieee30", "mesh118", "mesh511")
SMW_LANES = (1, 64, 256)
#: D1 against its plain version: angles, flows and severity within 1e-12
#: absolute, ``islanded`` exactly.
DC_ATOL = 1e-12
DC_CASES = (("mesh118", (1, 1024)), ("mesh2000", (1, 1024)))
#: The served screens' sizes: mesh2000 × 256 chord outages (sparse), the
#: DC solver's 4096 injection lanes and 1024 outage lanes.
N1_LANES = 256
DC_INJECTION_LANES = 4096
DC_OUTAGE_LANES = 1024
N1_MAX_ITER = 24  # ServeConfig.n1_max_iter


def sync(torch, dev):
    """Wait for the card (no-op for a CPU rehearsal of a phase)."""
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def chords(sys_, count, start=0):
    """``count`` chord outages of a synthetic mesh (branches past the
    first n, which never island it)."""
    return np.asarray(sys_.n_bus + (start + np.arange(count))
                      % (sys_.n_branch - sys_.n_bus), np.int64)


def outage_status(torch, sys_, lanes, seed, single, dtype, dev):
    """``[lanes, m]`` 0/1 status: one chord out a lane (``single``) or
    about one branch in ten out at random."""
    m = sys_.n_branch
    if single:
        st = np.ones((lanes, m))
        st[np.arange(lanes), chords(sys_, lanes, seed)] = 0.0
    else:
        st = (np.random.default_rng(seed).uniform(size=(lanes, m))
              > 0.1).astype(np.float64)
    return torch.as_tensor(st, device=dev).to(dtype)


def compare_status_assemble(torch, sk, errs, dev="cuda"):
    """S1 with a per-lane status in each mode against its plain version
    (``compare_assemble``: ``SPARSE_TOL``, bit-identical on repeat, the
    modes' bit relations), random and single-outage status, float64 and
    float32; in float64 an all-in-service status gives the no-status
    bits."""
    for name, lane_counts in STATUS_CASES:
        sys_ = case_system(name)
        for lanes in lane_counts:
            for dtype in (torch.float64, torch.float32):
                op, x, ps, qs, _, _ = sparse_setup(torch, sys_, lanes,
                                                   lanes + 5, dtype,
                                                   pc=False, device=dev)
                e = (0.0, 0.0)
                for single in (False, True):
                    st = outage_status(torch, sys_, lanes, lanes, single,
                                       dtype, x.device)
                    label = (f"{name} B={lanes} {str(dtype)[6:]} status "
                             f"{'single' if single else 'random'}")
                    e = worst([e, compare_assemble(torch, sk, op, x, ps, qs,
                                                   label, status=st)])
                if dtype == torch.float64:
                    ones = torch.ones(lanes, sys_.n_branch, dtype=dtype,
                                      device=x.device)
                    for mode in (sk.FULL, sk.VALUES_F32, sk.RESIDUAL):
                        check(all(same_bits(torch, a, b) for a, b in zip(
                            sk.sparse_assemble(x, ps, qs, op, mode, ones),
                            sk.sparse_assemble(x, ps, qs, op, mode))),
                            f"S1 with an all-in-service status differs from "
                            f"S1 without one: {name} B={lanes} mode {mode}")
                    errs["sparse_assemble"] = max(errs["sparse_assemble"],
                                                  e[1])
                sync(torch, dev)
                log(f"screen kernels: S1 status {name:>8} B={lanes:<3} "
                    f"{str(dtype)[6:]:<7} relative {e[0]:.1e} abs "
                    f"{e[1]:.1e}")


def smw_steps(torch, sck, lu_p, lu_q, op, ks, sweep):
    """One INIT, THETA, V, FINISH chain of N1 (``sweep``: the wrapper or
    its plain version) from the flat start: every mode's outputs."""
    lanes, n = int(ks.shape[0]), op.n
    th, v, rhs = (torch.empty(lanes, n, dtype=torch.float64,
                              device=ks.device) for _ in range(3))
    outs = []
    sweep(sck.INIT, ks, th, v, rhs, op)
    outs += [th.clone(), v.clone(), rhs.clone()]
    for mode, lu in ((sck.THETA, lu_p), (sck.V, lu_q)):
        x0 = torch.linalg.lu_solve(lu[0], lu[1], rhs.mT)
        sweep(mode, ks, th, v, rhs, op, x0)
        outs += [th.clone(), v.clone(), rhs.clone()]
    outs += list(sweep(sck.FINISH, ks, th, v, rhs, op))
    return outs


def compare_smw(torch, sck, errs, dev="cuda"):
    """N1 in every mode against its plain version on identical inputs
    (``SMW_ATOL``) and bit-identical on repeat, at case_ieee30, mesh118
    and mesh511 over ``SMW_LANES`` of their secure outages (the pinned
    endpoints of case_ieee30 among them)."""
    from freedm_tpu_torch.pf.n1 import secure_outages, smw_operands

    for name in SMW_CASES:
        sys_ = case_system(name)
        sec = np.asarray(secure_outages(sys_), np.int64)
        lu_p, lu_q, op = smw_operands(sys_, device=dev)
        worst_e = 0.0
        for lanes in SMW_LANES:
            ks = torch.as_tensor(np.resize(sec, lanes), device=dev)
            got = smw_steps(torch, sck, lu_p, lu_q, op, ks, sck.smw_sweep)
            again = smw_steps(torch, sck, lu_p, lu_q, op, ks, sck.smw_sweep)
            check(all(same_bits(torch, a, b) for a, b in zip(got, again)),
                  f"N1 not bit-identical on repeat: {name} L={lanes}")
            # Each mode on the kernel's own inputs: the plain chain from
            # the same start would drift apart by its own roundings.
            th, v, rhs = (t.clone() for t in got[:3])
            for i, (mode, lu) in enumerate(((sck.THETA, lu_p),
                                            (sck.V, lu_q))):
                th0, v0, r0 = (t.clone() for t in got[3 * i:3 * i + 3])
                x0 = torch.linalg.lu_solve(lu[0], lu[1], r0.mT)
                sck.smw_sweep_plain(mode, ks, th0, v0, r0, op, x0)
                for a, b in zip((th0, v0, r0), got[3 * i + 3:3 * i + 6]):
                    worst_e = max(worst_e, float((a - b).abs().max()))
            p_th, p_v, p_r = (t.clone() for t in got[6:9])
            for a, b in zip(sck.smw_sweep_plain(sck.FINISH, ks, p_th, p_v,
                                                p_r, op), got[9:]):
                worst_e = max(worst_e, float((a - b).abs().max()))
            sck.smw_sweep_plain(sck.INIT, ks, th, v, rhs, op)
            for a, b in zip((th, v, rhs), got[:3]):
                worst_e = max(worst_e, float((a - b).abs().max()))
        sync(torch, dev)
        log(f"screen kernels: N1 {name:>11} L in {SMW_LANES} "
            f"({len(sec)} secure outages) max abs {worst_e:.1e}")
        check(worst_e <= SMW_ATOL, f"smw_sweep disagrees on {name}: "
                                   f"{worst_e} > {SMW_ATOL}")
        errs["smw_sweep"] = max(errs["smw_sweep"], worst_e)


def compare_dc(torch, sck, errs, dev="cuda"):
    """D1 in both modes against its plain version (``DC_ATOL``,
    ``islanded`` exactly), bit-identical on repeat, at mesh118 and
    mesh2000 (L ∈ {1, 1024}); the bridges of case14 and case_ieee30
    flagged islanded by both, exactly the branches whose removal islands
    the network."""
    from freedm_tpu_torch.pf.dc import make_dc_solver
    from freedm_tpu_torch.pf.n1 import secure_outages

    worst_e = 0.0

    def agree(a, b, label):
        nonlocal worst_e
        check(torch.equal(a.islanded, b.islanded),
              f"dc_screen islanded flags differ: {label}")
        for k in ("theta", "flows", "severity"):
            x, y = getattr(a, k), getattr(b, k)
            fin = torch.isfinite(y)
            check(torch.equal(fin, torch.isfinite(x)),
                  f"dc_screen {k}: finite entries differ: {label}")
            worst_e = max(worst_e, float((x[fin] - y[fin]).abs().max()))

    for name in ("case14", "case_ieee30"):
        sys_ = case_system(name)
        ks = np.arange(sys_.n_branch)
        dc = make_dc_solver(sys_, device=dev)
        got = dc.screen_outages(ks)
        agree(got, make_dc_solver(sys_, device=dev,
                                  plain=True).screen_outages(ks), name)
        bridges = sorted(set(range(sys_.n_branch)) - set(secure_outages(sys_)))
        flagged = torch.nonzero(got.islanded).flatten().cpu().tolist()
        check(bridges and flagged == bridges,
              f"{name}: islanded lanes {flagged} are not the bridges "
              f"{bridges}")
        log(f"screen kernels: D1 {name}: bridges {bridges} flagged islanded "
            f"(severity inf) by kernel and plain version")
    for name, lane_counts in DC_CASES:
        sys_ = case_system(name)
        dc = make_dc_solver(sys_, device=dev)
        plain = make_dc_solver(sys_, device=dev, plain=True)
        for lanes in lane_counts:
            ks = chords(sys_, lanes)
            got = dc.screen_outages(ks)
            again = dc.screen_outages(ks)
            check(all(same_bits(torch, getattr(got, k), getattr(again, k))
                      for k in ("theta", "flows", "severity"))
                  and torch.equal(got.islanded, again.islanded),
                  f"D1 SCREEN not bit-identical on repeat: {name} L={lanes}")
            agree(got, plain.screen_outages(ks), f"{name} L={lanes}")
            pj = torch.as_tensor(np.random.default_rng(lanes).uniform(
                0.5, 1.5, (lanes, 1)) * sys_.p_inj, device=dev)
            a, b = dc.solve(pj), plain.solve(pj)
            check(same_bits(torch, a.flows, dc.solve(pj).flows),
                  f"D1 SOLVE not bit-identical on repeat: {name} L={lanes}")
            worst_e = max(worst_e, float((a.flows - b.flows).abs().max()))
        sync(torch, dev)
        log(f"screen kernels: D1 {name:>8} L in {lane_counts} max abs "
            f"{worst_e:.1e}")
    check(worst_e <= DC_ATOL, f"dc_screen disagrees: {worst_e} > {DC_ATOL}")
    errs["dc_screen"] = max(errs["dc_screen"], worst_e)


def time_screen_kernels(torch, sk, sck, rows, extra, dev="cuda"):
    """Times at the served shapes, CUDA events and device time, beside
    the plain versions and the bounds: S1 with status at mesh2000 × 256
    (and × 64, beside S1 without status on the same inputs); N1 at
    mesh511 × 256 (each mode) and case_ieee30 × 64; D1 SCREEN at mesh2000
    × 1024 and SOLVE at × 4096."""
    from freedm_tpu_torch.pf.dc import (dc_operands, make_dc_solver,
                                        outage_columns)
    from freedm_tpu_torch.pf.fdlf import decoupled_parts
    from freedm_tpu_torch.pf.n1 import secure_outages, smw_operands

    sys_ = case_system("mesh2000")
    n, m = sys_.n_bus, sys_.n_branch
    w = 8
    for lanes in (MAIN_LANES, N1_LANES):
        op, x, ps, qs, _, _ = sparse_setup(torch, sys_, lanes, 9,
                                           torch.float64, pc=False, device=dev)
        st = outage_status(torch, sys_, lanes, 0, True, torch.float64,
                           x.device)
        reads = w * (4 * lanes * n + 6 * m + 7 * n) + 4 * (n + 1 + 4 * m)
        for sfx, name in ASSEMBLE_MODES:
            mode = getattr(sk, name)
            vw = 4 if name == "VALUES_F32" else w
            if name == "RESIDUAL":
                b1 = reads + w * 4 * lanes * n
                o1 = lanes * (35 * m + 15 * n + 2 * m)
            else:
                b1 = reads + vw * lanes * (8 * m + 6 * n) + w * 2 * lanes * n
                o1 = lanes * (45 * m + 25 * n + 2 * m)
            b1 += w * lanes * m  # the status
            o1 += lanes * 8 * m  # the scaled admittances and self terms
            b, by = bound(b1, o1)

            def fn(s_):
                return lambda: sk.sparse_assemble(x, ps, qs, op, mode, s_)
            k = time_ms(torch, fn(st), reps=50)
            # Device time in turns: with, without, without, with status.
            turns = [device_ms(torch, fn(s_), reps=20)
                     for s_ in (st, None, None, st)]
            with_st, without = (turns[0] + turns[3]) / 2, turns[1:3]
            p = time_ms(torch, lambda: sk.sparse_assemble_plain(
                x, ps, qs, op, mode, st), reps=5)
            key = f"{sfx}_status_x{lanes}"
            extra["sparse_assemble"].update({
                "ms" + key: k, "device_ms" + key: with_st,
                "plain_ms" + key: p, "bound_ms" + key: b,
                "device_ms_turns" + key: turns})
            log(f"timing: sparse_assemble{sfx} status x{lanes:<4} kernel "
                f"{k:.4f} ms (device {with_st:.4f}; in turns with / "
                f"without / without / with status "
                + " / ".join(f"{t_:.4f}" for t_ in turns)
                + f")  plain {p:.4f} ms  bound {b:.4f} ms ({by})")
        del op, x, ps, qs, st
    # N1: the served SMW shapes.
    for name, lanes, main in (("mesh511", N1_LANES, True),
                              ("case_ieee30", MAIN_LANES, False)):
        sys5 = case_system(name)
        n5, m5 = sys5.n_bus, sys5.n_branch
        sec = np.asarray(secure_outages(sys5), np.int64)
        lu_p, lu_q, op5 = smw_operands(sys5, device=dev)
        ks = torch.as_tensor(np.resize(sec, lanes), device=dev)
        th, v, rhs = (torch.empty(lanes, n5, dtype=torch.float64,
                                  device=dev) for _ in range(3))
        sck.smw_sweep(sck.INIT, ks, th, v, rhs, op5)
        x0 = torch.linalg.lu_solve(lu_p[0], lu_p[1], rhs.mT)
        # Bytes: x0, the lane's ZM rows, θ and V read, a half and the
        # right-hand side written; the operands once.  Operations: sincos
        # (~40) a bus, ~30 a list entry, ~8 a bus for the update.
        opnd = 8 * (8 * m5 + 9 * n5) + 4 * (n5 + 1 + 4 * m5) + 16 * m5
        b_mode = {
            "INIT": opnd + w * 3 * lanes * n5,
            "THETA": opnd + w * lanes * n5 * 7,
            "V": opnd + w * lanes * n5 * 7,
            "FINISH": opnd + w * lanes * (4 * n5 + 1)}
        o_mode = lanes * (48 * n5 + 60 * m5)
        times = {}
        for mname in ("INIT", "THETA", "V", "FINISH"):
            mode = getattr(sck, mname)

            def fn(mode=mode):
                # THETA and V rewrite θ (V) from the same x0 each call:
                # the timed work of one half-iteration.
                return sck.smw_sweep(mode, ks, th, v, rhs, op5,
                                     x0 if mode in (sck.THETA, sck.V)
                                     else None)
            k = time_ms(torch, fn, reps=50)
            kd = device_ms(torch, fn, reps=20)
            pl = time_ms(torch, lambda mode=mode: sck.smw_sweep_plain(
                mode, ks, th.clone(), v.clone(), rhs.clone(), op5,
                x0 if mode in (sck.THETA, sck.V) else None), reps=5)
            b, by = bound(b_mode[mname], o_mode)
            times[mname] = (k, kd, pl, b, by)
            log(f"timing: smw_sweep {name} x{lanes} {mname:<6} kernel "
                f"{k:.4f} ms (device {kd:.4f})  plain {pl:.4f} ms  bound "
                f"{b:.5f} ms ({by})")
        lu_ms = device_ms(torch, lambda: torch.linalg.lu_solve(
            lu_p[0], lu_p[1], rhs.mT), reps=20)
        log(f"timing: lu_solve {name} [{n5}, {lanes}] device {lu_ms:.4f} ms "
            f"(the SMW screen's base solve, 2 an iteration)")
        key = "" if main else f"_{name}_x{lanes}"
        if main:
            k, kd, pl, b, by = times["THETA"]
            rows["smw_sweep"] = (k, pl, None, b, by)
            extra["smw_sweep"] = {"device_ms": kd, "shape": f"{name} x{lanes}"
                                  " THETA (a half-iteration)",
                                  "lu_solve_device_ms": lu_ms}
        for mname, (k, kd, pl, b, by) in times.items():
            extra["smw_sweep"].update({
                f"ms_{mname}{key}": k, f"device_ms_{mname}{key}": kd,
                f"plain_ms_{mname}{key}": pl, f"bound_ms_{mname}{key}": b})
        del op5, lu_p, lu_q
    # D1 at mesh2000, on the operands screen_outages hands it.
    dcs = make_dc_solver(sys_, device=dev)
    ks = torch.as_tensor(chords(sys_, DC_OUTAGE_LANES), device=dev)
    theta0 = dcs.solve().theta
    lanes = DC_OUTAGE_LANES
    op_d = dc_operands(sys_, device=dev)
    lu = torch.linalg.lu_factor(decoupled_parts(sys_, device=dev)
                                .b_prime(None))
    z = torch.linalg.lu_solve(lu[0], lu[1], outage_columns(op_d, ks).mT)
    log(f"timing: dc_screen z [{n}, {lanes}] strides {tuple(z.stride())} "
        f"(lanes read contiguous: {z.stride(0) == 1})")
    fn = lambda: sck.dc_screen(theta0, z, ks, op_d)  # noqa: E731
    k, kd = time_ms(torch, fn, reps=50), device_ms(torch, fn, reps=20)
    pl = time_ms(torch, lambda: sck.dc_screen_plain(theta0, z, ks, op_d),
                 reps=10)
    b, by = bound(w * (2 * lanes * n + n + lanes * m + 3 * m + 2 * lanes)
                  + 8 * lanes, lanes * (2 * n + 3 * m + 12))
    rows["dc_screen"] = (k, pl, None, b, by)
    extra["dc_screen"] = {"device_ms": kd,
                          "shape": f"mesh2000 x{lanes} SCREEN"}
    log(f"timing: dc_screen  mesh2000 x{lanes} SCREEN kernel {k:.4f} ms "
        f"(device {kd:.4f})  plain {pl:.4f} ms  bound {b:.5f} ms ({by})")
    lanes = DC_INJECTION_LANES
    theta = dcs.solve(torch.as_tensor(np.random.default_rng(4).uniform(
        0.5, 1.5, (lanes, 1)) * sys_.p_inj, device=dev)).theta
    fn = lambda: sck.dc_flows(theta, op_d)  # noqa: E731
    k, kd = time_ms(torch, fn, reps=50), device_ms(torch, fn, reps=20)
    pl = time_ms(torch, lambda: sck.dc_flows_plain(theta, op_d), reps=10)
    b, by = bound(w * (lanes * n + lanes * m + 3 * m), 2 * lanes * m)
    extra["dc_screen"].update({"ms_SOLVE": k, "device_ms_SOLVE": kd,
                               "plain_ms_SOLVE": pl, "bound_ms_SOLVE": b,
                               "shape_SOLVE": f"mesh2000 x{lanes} SOLVE"})
    log(f"timing: dc_screen  mesh2000 x{lanes} SOLVE  kernel {k:.4f} ms "
        f"(device {kd:.4f})  plain {pl:.4f} ms  bound {b:.5f} ms ({by}); "
        f"theta strides {tuple(theta.stride())}")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 10: the N-1 and DC screens (solver level)
# ---------------------------------------------------------------------------


def screen_launches(torch, sk, sck, nk, fn, dev):
    """``fn()`` with every count at 0 before it; returns (result, wall
    ms, launches by kernel, S1's status launches, N1 and D1 by mode)."""
    for mod in (sk, sck, nk):
        mod.reset_launches()
    sync(torch, dev)
    t0 = time.monotonic()
    r = fn()
    sync(torch, dev)
    wall = (time.monotonic() - t0) * 1e3
    counts = {**sk.launches(), **nk.launches(), **sck.launches()}
    return r, wall, counts, sk.status_launches(), sck.mode_launches()


def n1_screens(torch, sk, sck, nk, dev="cuda"):
    """The screens through their entry points on the card: the sparse
    screen at mesh2000 × 256 chord outages (mixed and f64) against its
    plain-version screen, the SMW screen over case_ieee30's secure
    outages and mesh511 × 256 against its plain version, the DC solver at
    mesh2000 (4096 injection lanes, 1024 outage lanes) and dc_prefilter=8
    over 64 chord outages on the sparse screen; launches, walls and a
    profile of the mesh2000 screen.  Returns the launch counts of the DC
    runs (D1's main path at solver level)."""
    from freedm_tpu_torch.pf.dc import make_dc_solver
    from freedm_tpu_torch.pf.krylov import build_fdlf_precond
    from freedm_tpu_torch.pf.n1 import make_n1_screen, secure_outages

    on_card = torch.device(dev).type == "cuda"
    sys_ = case_system("mesh2000")
    ks = chords(sys_, N1_LANES)
    for prec in ("mixed", "f64"):
        # f64 on the float64 LU pair (kind="lu"): on the default bf16 pair
        # the inexact inner solve moves a warm-started lane's mismatch by
        # tens of percent between two roundings, and a lane whose step
        # starts near tol stops one step apart (2 of 256 lanes on an H100,
        # 8e-13 pu apart); mixed runs on the served default pair.
        pc = (build_fdlf_precond(sys_, kind="lu", device=dev)
              if prec == "f64" else None)
        t0 = time.monotonic()
        screen = make_n1_screen(sys_, max_iter=N1_MAX_ITER, backend="sparse",
                                precision=prec, device=dev, precond=pc)
        build = time.monotonic() - t0
        screen(ks)  # the first calls of these shapes
        r, wall, counts, st, _ = screen_launches(torch, sk, sck, nk,
                                                 lambda: screen(ks), dev)
        plain = make_n1_screen(sys_, max_iter=N1_MAX_ITER, backend="sparse",
                               precision=prec, device=dev, plain=True,
                               precond=pc)
        rp = plain(ks)
        its, itp = r.iterations.cpu().numpy(), rp.iterations.cpu().numpy()
        conv = r.converged.cpu().numpy()
        check(conv.all(), f"n1 sparse {prec}: lanes not converged: "
                          f"{np.flatnonzero(~conv)}")
        check(torch.equal(r.converged, rp.converged),
              f"n1 sparse {prec}: flags differ from the plain screen")
        dv = float((r.v - rp.v).abs().max())
        dth = float((r.theta - rp.theta).abs().max())
        apart = int(np.abs(its - itp).max())
        n_apart = int(np.sum(its != itp))
        fb, fbp = int(r.fallbacks.sum()), int(rp.fallbacks.sum())
        lanes3 = [0, N1_LANES // 2, N1_LANES - 1]
        d3 = max(float((r.v[lanes3] - rp.v[lanes3]).abs().max()),
                 float((r.theta[lanes3] - rp.theta[lanes3]).abs().max()))
        if prec == "f64":
            check(d3 <= SOLVE_ATOL and np.array_equal(its[lanes3],
                                                      itp[lanes3])
                  and apart <= 1 and torch.equal(r.fallbacks, rp.fallbacks),
                  f"n1 sparse f64 vs plain: {d3:.2e} pu on lanes {lanes3}, "
                  f"iterations {its[lanes3]} vs {itp[lanes3]} ({apart} "
                  f"apart at most), fallbacks {fb} vs {fbp}")
        else:
            check(apart <= 1 and torch.equal(r.fallbacks, rp.fallbacks),
                  f"n1 sparse mixed vs plain: iterations {apart} apart, "
                  f"fallbacks {fb} vs {fbp}")
        check(not on_card or (sum(st.values()) == counts["sparse_assemble"]
                              and counts["sparse_assemble"] > 0),
              f"n1 sparse {prec}: S1 ran without the lanes' status: {st}, "
              f"{counts}")
        log(f"n1 screens: sparse {prec:<5} "
            f"({'LU' if pc is not None else 'bf16'} pair) mesh2000 "
            f"x{N1_LANES} chord "
            f"outages: build {build:.2f} s, wall {wall:.1f} ms, iterations "
            f"{its.min()}-{its.max()} (plain {itp.min()}-{itp.max()}; "
            f"{n_apart} lanes one apart), fallbacks {fb} (plain {fbp}), vs "
            f"plain max "
            f"|dv| {dv:.2e} |dtheta| {dth:.2e} (3 lanes {d3:.2e}), v_min "
            f"{float(r.v.min()):.4f}; launches {counts}, S1 with status "
            f"{st}")
        if prec == "mixed":
            profile_solve(torch, lambda: screen(ks),
                          f"n1 sparse mixed mesh2000 x{N1_LANES}")
        del screen, plain, r, rp
        torch.cuda.empty_cache()
    for name, lanes in (("case_ieee30", None), ("mesh511", N1_LANES)):
        sys5 = case_system(name)
        sec = np.asarray(secure_outages(sys5), np.int64)
        ks5 = sec if lanes is None else np.resize(sec, lanes)
        t0 = time.monotonic()
        screen = make_n1_screen(sys5, max_iter=N1_MAX_ITER, device=dev)
        build = time.monotonic() - t0
        screen(ks5)  # the first calls of these shapes
        r, wall, counts, _, modes = screen_launches(torch, sk, sck, nk,
                                                    lambda: screen(ks5), dev)
        rp = make_n1_screen(sys5, max_iter=N1_MAX_ITER, device=dev,
                            plain=True)(ks5)
        d = max(float((getattr(r, k) - getattr(rp, k)).abs().max())
                for k in ("v", "theta", "p", "q"))
        check(d <= SOLVE_ATOL and torch.equal(r.converged, rp.converged)
              and bool(r.converged.all()),
              f"n1 SMW {name}: {d:.2e} pu from the plain screen, converged "
              f"{int(r.converged.sum())}/{len(ks5)}")
        check(not on_card or counts["smw_sweep"] == 2 + 2 * N1_MAX_ITER,
              f"n1 SMW {name}: {counts['smw_sweep']} N1 launches, want "
              f"{2 + 2 * N1_MAX_ITER}")
        ops, busy, pwall = profile_solve(
            torch, lambda: screen(ks5), f"n1 SMW {name} x{len(ks5)}", top=4)
        log(f"n1 screens: SMW {name} x{len(ks5)}: build {build:.2f} s, wall "
            f"{wall:.2f} ms, max mismatch {float(r.mismatch.max()):.2e}, vs "
            f"plain {d:.2e} pu; N1 launches {modes['smw_sweep']}, device "
            f"operations {ops} (2 + 4 x {N1_MAX_ITER} = "
            f"{2 + 4 * N1_MAX_ITER} calls: lu_solve's own kernels counted "
            f"apart)")
    dc = make_dc_solver(sys_, device=dev)
    dcp = make_dc_solver(sys_, device=dev, plain=True)
    pj = torch.as_tensor(np.random.default_rng(8).uniform(
        0.5, 1.5, (DC_INJECTION_LANES, 1)) * sys_.p_inj, device=dev)
    dc.solve(pj[:4])
    ko = chords(sys_, DC_OUTAGE_LANES)
    rs, w1, c1, _, _ = screen_launches(torch, sk, sck, nk,
                                       lambda: dc.solve(pj), dev)
    ro, w2, c2, _, _ = screen_launches(torch, sk, sck, nk,
                                       lambda: dc.screen_outages(ko), dev)
    es = float((rs.flows - dcp.solve(pj).flows).abs().max())
    po = dcp.screen_outages(ko)
    eo = max(float((ro.theta - po.theta).abs().max()),
             float((ro.flows - po.flows).abs().max()))
    check(es <= DC_ATOL and eo <= DC_ATOL
          and torch.equal(ro.islanded, po.islanded)
          and not bool(ro.islanded.any()),
          f"DC solver vs plain: injections {es:.2e}, outages {eo:.2e}")
    log(f"n1 screens: DC mesh2000 {DC_INJECTION_LANES} injection lanes "
        f"{w1:.2f} ms, {DC_OUTAGE_LANES} outage lanes {w2:.2f} ms (walls "
        f"with the lu_solves), vs plain {es:.1e} / {eo:.1e}, max severity "
        f"{float(ro.severity.max()):.3f} pu")
    ac = make_n1_screen(sys_, max_iter=N1_MAX_ITER, backend="sparse",
                        dc_prefilter=8, device=dev)
    acp = make_n1_screen(sys_, max_iter=N1_MAX_ITER, backend="sparse",
                         dc_prefilter=8, device=dev, plain=True)
    k64 = chords(sys_, 64, 500)
    out, w3, c3, _, _ = screen_launches(torch, sk, sck, nk,
                                        lambda: ac(k64), dev)
    outp = acp(k64)
    check(np.array_equal(out.outages, outp.outages)
          and bool(out.result.converged.all())
          and float(np.abs(out.dc_severity_all
                           - outp.dc_severity_all).max()) <= DC_ATOL,
          f"dc_prefilter: shortlist {out.outages} vs plain {outp.outages}")
    log(f"n1 screens: dc_prefilter=8 over 64 chord outages: {w3:.1f} ms, "
        f"shortlist {out.outages.tolist()} (the plain version's), AC lanes "
        f"converged, launches {c3}")
    return {k: c2.get(k, 0) + c3.get(k, 0) + c1.get(k, 0)
            for k in ("dc_screen",)}


# ---------------------------------------------------------------------------
# Phase 11: the served n1 workload
# ---------------------------------------------------------------------------

N1_BURST = 16


def post_n1(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.monotonic()
    conn.request("POST", "/v1/n1", body=json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = json.loads(resp.read())
    lat = time.monotonic() - t0
    conn.close()
    return resp.status, data, lat


def serve_n1(torch, sk, sck, nk, dev="cuda", case="mesh2000"):
    """``POST /v1/n1`` on a server with the default config but
    ``max_batch=256`` (``N1Engine.MAX_OUTAGES``: a request of more lanes
    than ``max_batch`` is refused, as the reference refuses it):
    mesh2000 (the sparse screen, mixed) — one request of 64 outages, a
    burst of 16 concurrent requests of 1-16 outages, one of 256 — and
    case_ieee30 (the SMW screen) over all its secure outages, and an
    islanding outage refused with 400.  Every answer all_converged, with
    ``v_min_pu``/``v_max_pu`` within 1e-9 pu of the same outages through
    the direct screen.  Returns the launch counts over the served
    requests."""
    from freedm_tpu_torch.pf.n1 import make_n1_screen
    from freedm_tpu_torch.serve.http import ServeServer
    from freedm_tpu_torch.serve.service import ServeConfig, Service

    t0 = time.monotonic()
    svc = Service(ServeConfig(max_batch=N1_LANES, device=dev))
    eng = svc.engine("n1", case)
    build = time.monotonic() - t0
    t0 = time.monotonic()
    svc.prewarm((f"n1/{case}", "n1/case_ieee30"))
    prewarm = time.monotonic() - t0
    eng30 = svc.engine("n1", "case_ieee30")
    mixed = "mixed" if torch.device(dev).type == "cuda" else "f64"
    check(eng.pf_backend == "sparse" and eng.pf_precision == mixed
          and eng30.pf_backend == "dense",
          f"n1 engines: {case} {eng.pf_backend}/{eng.pf_precision}, "
          f"case_ieee30 {eng30.pf_backend}")
    log(f"serve n1: {case} engine build {build:.2f} s (secure_outages, "
        f"the base solve), prewarm of {len(svc.config.bucket_table())} "
        f"buckets x 2 cases {prewarm:.2f} s")
    server = ServeServer(svc).start()
    rng = np.random.default_rng(81)
    sys_ = case_system(case)
    sec = np.asarray(eng._secure)
    try:
        for mod in (sk, sck, nk):
            mod.reset_launches()
        runs = []
        one = chords(sys_, 64, 1000).tolist()
        runs.append(("64 outages", [one],
                     [post_n1(server.port, {"case": case,
                                            "outages": one})]))
        burst = [rng.choice(sec, size=int(rng.integers(1, 17)),
                            replace=False).tolist()
                 for _ in range(N1_BURST)]
        with cf.ThreadPoolExecutor(N1_BURST) as ex:
            out = list(ex.map(lambda ks: post_n1(
                server.port, {"case": case, "outages": ks}), burst))
        runs.append((f"burst of {N1_BURST}", burst, out))
        big = chords(sys_, N1_LANES, 1200).tolist()
        runs.append((f"{N1_LANES} outages", [big],
                     [post_n1(server.port, {"case": case,
                                            "outages": big})]))
        s30 = list(eng30._secure)
        runs.append(("case_ieee30 all secure", [s30],
                     [post_n1(server.port, {"case": "case_ieee30",
                                            "outages": s30})]))
        counts = {**sk.launches(), **nk.launches(), **sck.launches()}
        st = sk.status_launches()
        bridge = sorted(set(range(eng30.n_branch)) - set(s30))[0]
        status, data, _ = post_n1(server.port, {"case": "case_ieee30",
                                                "outages": [bridge]})
        check(status == 400 and "island" in data["error"]["detail"],
              f"islanding outage {bridge}: HTTP {status} {data}")
        direct = {case: make_n1_screen(
            sys_, max_iter=N1_MAX_ITER, backend="auto", device=dev),
            "case_ieee30": make_n1_screen(
                case_system("case_ieee30"), max_iter=N1_MAX_ITER,
                backend="auto", device=dev)}
        worst_pu = 0.0
        for label, reqs, outs in runs:
            name = "case_ieee30" if label.startswith("case") else case
            lat = []
            for ks, (status, body, sec_) in zip(reqs, outs):
                check(status == 200 and body["all_converged"],
                      f"serve n1 {label}: HTTP {status}: "
                      f"{str(body)[:300]}")
                check(body["outages"] == list(ks),
                      f"serve n1 {label}: outages echoed {body['outages']}")
                r = direct[name](ks)
                for k, red in (("v_min_pu", r.v.min(dim=1).values),
                               ("v_max_pu", r.v.max(dim=1).values)):
                    worst_pu = max(worst_pu, float(np.abs(
                        np.asarray(body[k]) - red.cpu().numpy()).max()))
                lat.append(sec_ * 1e3)
            lanes = [o[1]["batch"]["lanes"] for o in outs]
            buckets = [o[1]["batch"]["bucket"] for o in outs]
            solve = [o[1]["batch"]["solve_ms"] for o in outs]
            log(f"serve n1: {name} {label}: {len(outs)} requests, latency "
                f"p50 {np.percentile(lat, 50):.1f} ms p99 "
                f"{np.percentile(lat, 99):.1f} ms, lanes a batch "
                f"{min(lanes)}-{max(lanes)} (buckets {sorted(set(buckets))})"
                f", solve_ms {min(solve):.1f}-{max(solve):.1f}, v_min "
                f"{min(min(o[1]['v_min_pu']) for o in outs):.4f}")
        check(worst_pu <= SOLVE_ATOL,
              f"serve n1: answers {worst_pu:.2e} pu from the direct screen")
        log(f"serve n1: every answer all_converged, max |v_min/v_max - "
            f"direct screen| {worst_pu:.2e} pu; islanding outage {bridge} "
            f"refused (400); launches {counts}, S1 with status {st}")
        on_card = torch.device(dev).type == "cuda"
        # K3 runs on the mixed path only in its full-precision phase.
        check(not on_card or all(counts[k] > 0 for k in (
            "sparse_assemble", "sparse_matvec", "gmres_block_orth",
            "gmres_lstsq", "smw_sweep")),
              f"a kernel of the n1 path was not launched: {counts}")
        check(sum(st.values()) == counts["sparse_assemble"],
              f"S1 ran without status on the n1 path: {st}")
        return counts, st
    finally:
        server.stop()
        svc.stop()


# ---------------------------------------------------------------------------
# Phases 12-14: the ladder kernels (L1, L2), the VVC controller, serve vvc
# ---------------------------------------------------------------------------

LADDER_LANES = (1, 8, MAIN_LANES)
#: f64: the sums run in another order than the plain version's (1e-14
#: seen); f32: a 10k-bus feeder's prefix sums lose relative precision.
LADDER_ATOL = {"float64": 1e-10, "float32": 1e-4}
#: The ladder's convergence threshold (``make_ladder_solver``'s eps).
LADDER_EPS = 1e-4
#: float32 flags: a lane whose residual lies within this many float32
#: ulps of its largest root current from eps converges or not by rounding
#: (the residual is the change of a root current that sums nb rounded
#: terms a sweep), so its flag is printed, not gated.
F32_FLAG_ULPS = 64
GRAD_RTOL = 1e-8
GRAD_ATOL = 1e-10
FD_REL = 1e-4
VVC_ATOL = 1e-9
VVC_ROUNDS = 120
VVC_BURST = 64
#: Operations a branch and iteration: L1 (the complex division of the
#: load currents ~30, the two prefixes ~24 with their y and group sums,
#: the branch currents and root error ~21, the 3 × 3 complex drop 72, the
#: voltage update 12) and L2 (the masked prefix ~18, the adjoint drop 72,
#: the path prefix ~18, the two complex divisions of the load-current
#: derivative ~96).
L1_OPS = 171
L2_OPS = 210


def ladder_feeders():
    """The phase's feeders: (name, feeder, load factor, max_iter)."""
    from pathlib import Path

    from freedm_tpu_torch.grid import cases, feeder

    dl = Path(__file__).resolve().parent / "tests" / "data" / "Dl_new.mat"
    return (("vvc_9bus", cases.vvc_9bus(), 1.0, 20),
            ("Dl_new", feeder.load_dl_mat(str(dl)), 0.5, 60),
            ("radial512", cases.synthetic_radial(512, seed=0), 1.0, 20),
            ("radial10k", cases.synthetic_radial(10000, seed=0, load_kw=1.0),
             1.0, 20))


def lane_loads(f, lanes, factor=1.0):
    """``lanes`` load lanes: the feeder's loads times scales uniform in
    0.7-1.3 from ``default_rng(0)`` (the reference's ``bench.py``)."""
    scale = np.random.default_rng(0).uniform(0.7, 1.3, (lanes, 1, 1))
    return factor * scale * f.s_load[None]


def ladder_same_bits(torch, a, b):
    return all(torch.equal(getattr(a, k).re, getattr(b, k).re)
               and torch.equal(getattr(a, k).im, getattr(b, k).im)
               for k in ("v_node", "i_branch", "i_load"))


def ladder_out_same_bits(torch, a, b):
    """Two kernel-level ``LadderOut``s: v, i_branch and i_load the same
    bits, the same iterations."""
    return (all(torch.equal(getattr(a, k).re, getattr(b, k).re)
                and torch.equal(getattr(a, k).im, getattr(b, k).im)
                for k in ("v", "i_branch", "i_load"))
            and torch.equal(a.iterations, b.iterations))


def lane_gaps(torch, a, b):
    """Per lane, the largest |a - b| over v_node, i_branch and i_load."""
    out = None
    for k in ("v_node", "i_branch", "i_load"):
        for part in ("re", "im"):
            d = (getattr(getattr(a, k), part) - getattr(getattr(b, k), part))
            d = d.abs().flatten(1).amax(dim=1)
            out = d if out is None else torch.maximum(out, d)
    return out


def compare_ladder(torch, errs):
    """L1 against its plain version on the card: every feeder of
    :func:`ladder_feeders` × B ∈ {1, 8, 64} × {solve, solve_fixed} ×
    {float64, float32} through ``make_ladder_solver`` and its
    ``plain=True`` twin, and bit-identical on repeat.  Lanes the plain
    version finds converged are held to ``LADDER_ATOL``; a lane in
    voltage collapse (radial512 at 1.1-1.3 × load: the ladder diverges
    there, as the reference's does) is held to equal flags and
    iterations, its gap printed — its iteration is no contraction, and
    two float64 summation orders part exponentially on it (on the CPU
    L1's plain sweeps and the doubling sweeps: 8e-15 after one
    iteration, 7.6e-11 after 20) — and every lane's iteration map is held
    to ``LADDER_ATOL`` by a one-iteration fixed solve.  In float32 a
    lane's flag is gated unless its residual lies within
    ``F32_FLAG_ULPS`` of eps."""
    from freedm_tpu_torch.pf.ladder import make_ladder_solver

    worst = {"float64": 0.0, "float32": 0.0}
    for name, f, factor, max_iter in ladder_feeders():
        for dtype in (torch.float64, torch.float32):
            dn = str(dtype).split(".")[-1]
            tol = LADDER_ATOL[dn]
            kern = make_ladder_solver(f, max_iter=max_iter, dtype=dtype,
                                      device="cuda")
            plain = make_ladder_solver(f, max_iter=max_iter, dtype=dtype,
                                       device="cuda", plain=True)
            its, diverged, div_gap, near, flipped = set(), 0, 0.0, 0, 0
            root = torch.as_tensor(f.parent < 0, device="cuda")
            for lanes in LADDER_LANES:
                loads = lane_loads(f, lanes, factor)
                for mode, label in ((0, "solve"), (1, "solve_fixed")):
                    a, a2 = kern[mode](loads), kern[mode](loads)
                    p = plain[mode](loads)
                    torch.cuda.synchronize()
                    gaps = lane_gaps(torch, a, p)
                    where = f"ladder {name} {dn} x{lanes} {label}"
                    clear = torch.ones_like(p.converged)
                    if dn == "float32":
                        i_root = p.i_branch.abs()[:, root].flatten(1).amax(1)
                        band = F32_FLAG_ULPS * torch.finfo(dtype).eps * i_root
                        clear = (p.residual - LADDER_EPS).abs() > band
                        near += int((~clear).sum())
                        flipped += int((a.converged != p.converged).sum())
                    check(torch.equal(a.converged[clear],
                                      p.converged[clear]),
                          f"{where}: converged flags differ")
                    conv = p.converged & a.converged
                    err = float(gaps[conv].max()) if bool(conv.any()) else 0.0
                    check(err <= tol, f"{where}: {err:.3e} from the plain "
                          f"version on a converged lane")
                    check(dn == "float32"
                          or torch.equal(a.iterations, p.iterations),
                          f"{where}: iterations {a.iterations.tolist()} vs "
                          f"{p.iterations.tolist()}")
                    check(ladder_same_bits(torch, a, a2),
                          f"{where}: not bit-identical on repeat")
                    worst[dn] = max(worst[dn], err)
                    its.update(a.iterations.tolist())
                    if not bool(conv.all()):
                        diverged += int((~conv).sum())
                        div_gap = max(div_gap, float(gaps[~conv].max()))
            loads = lane_loads(f, LADDER_LANES[-1], factor)
            one = [make_ladder_solver(f, max_iter=1, dtype=dtype,
                                      device="cuda", plain=pl)[1](loads)
                   for pl in (False, True)]
            torch.cuda.synchronize()
            err1 = float(lane_gaps(torch, *one).max())
            check(err1 <= tol, f"ladder {name} {dn}: one iteration "
                  f"{err1:.3e} from the plain version")
            worst[dn] = max(worst[dn], err1)
            log(f"ladder kernels: {name:<9} (nb {f.n_branches}) {dn} B "
                f"{LADDER_LANES} solve/fixed: iterations {min(its)}-"
                f"{max(its)}, flags equal, bit-identical on repeat; one "
                f"iteration x{LADDER_LANES[-1]} {err1:.2e}"
                + (f"; {diverged} lane solves not converged (voltage collapse), "
                   f"their gap {div_gap:.2e}, not gated" if diverged else "")
                + (f"; {near} lane solves within {F32_FLAG_ULPS} ulps of eps "
                   f"(flags not gated, {flipped} differ)" if near else ""))
    errs["ladder_solve"] = worst["float64"]
    log(f"ladder kernels: L1 max |kernel - plain| f64 {worst['float64']:.3e}"
        f" pu (limit 1e-10), f32 {worst['float32']:.3e} (limit 1e-4)")
    return worst


def compare_ladder_vjp(torch, errs):
    """L2 (through ``LadderFixed``) against ``torch.autograd.grad`` of
    the plain fixed solve, for the total loss in Q, on vvc_9bus and the
    10k feeder × {1, 64}; then a central difference on three live
    coordinates at 10k × 1."""
    from freedm_tpu_torch.pf.ladder import make_ladder_solver, total_loss_kw

    feeders = {n: f for n, f, _, _ in ladder_feeders()}
    worst = 0.0
    dev = torch.device("cuda")
    for name in ("vvc_9bus", "radial10k"):
        f = feeders[name]
        for lanes in (1, MAIN_LANES):
            loads = lane_loads(f, lanes)
            p = torch.tensor(loads.real, dtype=torch.float64, device=dev)
            grads = []
            for plain in (False, True):
                _, fixed = make_ladder_solver(f, device=dev, plain=plain)
                q = torch.tensor(loads.imag, dtype=torch.float64, device=dev,
                                 requires_grad=True)
                loss = total_loss_kw(f, fixed((p, q))).sum()
                grads.append(torch.autograd.grad(loss, q)[0])
            torch.cuda.synchronize()
            g, want = grads
            check(bool(torch.isfinite(g).all()), f"L2 {name}: non-finite")
            excess = float(((g - want).abs() - GRAD_RTOL * want.abs()).max())
            check(excess <= GRAD_ATOL,
                  f"L2 {name} x{lanes}: |g - autograd| beyond rtol 1e-8 by "
                  f"{excess:.3e} (atol 1e-10)")
            gap = max_err(g, want)
            worst = max(worst, gap)
            log(f"ladder vjp: {name} x{lanes}: max |L2 - autograd of the "
                f"plain fixed solve| {gap:.3e} (max |g| "
                f"{float(want.abs().max()):.3e})")
    f = feeders["radial10k"]
    _, fixed = make_ladder_solver(f, device=dev)
    p = torch.tensor(f.s_load.real, dtype=torch.float64, device=dev)
    q0 = torch.tensor(f.s_load.imag, dtype=torch.float64, device=dev)

    def loss(q):
        return float(total_loss_kw(f, fixed((p, q))))

    qg = q0.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(total_loss_kw(f, fixed((p, qg))), qg)
    h = 1e-3
    for idx in ((0, 0), (f.n_branches // 2, 1), (f.n_branches - 1, 2)):
        e = torch.zeros_like(q0)
        e[idx] = h
        fd = (loss(q0 + e) - loss(q0 - e)) / (2 * h)
        rel = abs(fd - float(g[idx])) / max(abs(fd), 1e-30)
        check(rel <= FD_REL, f"L2 radial10k x1 {idx}: gradient "
              f"{float(g[idx]):.6e} vs central difference {fd:.6e}")
        log(f"ladder vjp: radial10k x1 dloss/dq{idx} = {float(g[idx]):.9e}, "
            f"central difference {fd:.9e} (rel {rel:.2e})")
    errs["ladder_vjp"] = worst


#: L2 in float32 against its plain version on the same saved iterates:
#: twenty walked iterations summed in other orders, within this share of
#: the largest cotangent.
L2_F32_RTOL = 1e-4


def _cotangents(torch, rng, lanes, nb, dtype, dev="cuda"):
    from freedm_tpu_torch.cplx import C

    return [C(torch.tensor(rng.normal(size=(lanes, nb, 3)), dtype=dtype,
                           device=dev),
              torch.tensor(rng.normal(size=(lanes, nb, 3)), dtype=dtype,
                           device=dev)) for _ in range(3)]


def _flat_vjp(out):
    sbar, v0bar = out
    return [sbar.re, sbar.im, v0bar.re, v0bar.im]


def compare_vjp_routes(torch, lk, errs):
    """L2's two routes (``lk.ladder_plan``) against its plain version on the
    same saved iterates and seeded cotangents, within ``GRAD_RTOL``
    (float64) or ``L2_F32_RTOL`` (float32) of the largest cotangent, and
    bit-identical on repeat: the cluster route at
    ``synthetic_radial(10000)`` x {1, 8, 64, 65} lanes, a lane's
    cotangents the same bits in launches of 1, 8 and 64 lanes; the
    cluster route at its capacity in each dtype and the global route one
    branch above, x 2 lanes."""
    from freedm_tpu_torch.cplx import C
    from freedm_tpu_torch.grid import cases

    rng = np.random.default_rng(12)
    feeders = {n: f for n, f, _, _ in ladder_feeders()}
    worst = {"float64": 0.0, "float32": 0.0}

    def head(x, k0, k1):
        return C(x.re[k0:k1].contiguous(), x.im[k0:k1].contiguous())

    def run(f, lanes, dtype, where):
        dn = str(dtype).split(".")[-1]
        s, v0, op = preorder_inputs(torch, lk, f, lanes, dtype)
        saved = lk.ladder_solve(s, v0, op, LADDER_EPS, 20, True,
                                save=True).saved
        gs = _cotangents(torch, rng, lanes, op.nb, dtype)
        got = _flat_vjp(lk.ladder_vjp(saved, s, op, *gs))
        again = _flat_vjp(lk.ladder_vjp(saved, s, op, *gs))
        want = _flat_vjp(lk.ladder_vjp_plain(saved, s, op, *gs))
        torch.cuda.synchronize()
        top = max(float(w.abs().max()) for w in want)
        rel = max(max_err(g, w) for g, w in zip(got, want)) / top
        tol = GRAD_RTOL if dn == "float64" else L2_F32_RTOL
        plan = lk.ladder_plan(op.nb, dtype)
        check(all(bool(torch.isfinite(g).all()) for g in got)
              and rel <= tol, f"L2 {where} {dn} x{lanes} ({plan.route}): "
              f"{rel:.3e} of the largest cotangent from the plain version")
        check(all(torch.equal(g, a) for g, a in zip(got, again)),
              f"L2 {where} {dn} x{lanes}: not bit-identical on repeat")
        worst[dn] = max(worst[dn], rel)
        return s, saved, gs, op, got, plan

    for dtype in (torch.float64, torch.float32):
        dn = str(dtype).split(".")[-1]
        f = feeders["radial10k"]
        for lanes in (1, 8, 65):
            run(f, lanes, dtype, "radial10k")
        s, saved, gs, op, wide, plan = run(f, MAIN_LANES, dtype, "radial10k")
        check(plan.route == "cluster", f"L2 radial10k {dn}: {plan}")
        for k0, k1 in ((0, 1), (5, 6), (0, 8), (MAIN_LANES - 1, MAIN_LANES)):
            part = _flat_vjp(lk.ladder_vjp(
                saved[:, k0:k1].contiguous(), head(s, k0, k1), op,
                *[head(g, k0, k1) for g in gs]))
            torch.cuda.synchronize()
            check(all(torch.equal(p_, w[k0:k1]) for p_, w in zip(part, wide)),
                  f"L2 radial10k {dn}: lanes {k0}-{k1 - 1} differ in a "
                  f"launch of {k1 - k0} lane(s)")
        cap = lk.cluster_capacity(dtype)
        routes = []
        for nb in (cap, cap + 1):
            fc = cases.synthetic_radial(nb, seed=3, load_kw=1.0)
            routes.append(run(fc, 2, dtype, f"nb={nb}")[-1].route)
        check(routes == ["cluster", "global"],
              f"L2 {dn} at its capacity {cap} and one above: {routes}")
        log(f"ladder vjp routes: {dn} radial10k plan {plan._asdict()}, x"
            f"{{1, 8, 64, 65}} within {worst[dn]:.2e} of the plain version's "
            f"largest cotangent (limit "
            f"{GRAD_RTOL if dn == 'float64' else L2_F32_RTOL:g}), a lane the "
            f"same bits in launches of 1, 8 and {MAIN_LANES}; nb {cap} "
            f"{routes[0]}, {cap + 1} {routes[1]}, both within the limit")
    return worst


#: The route crossover's feeders: vvc_9bus (8 branches), then
#: ``synthetic_radial(nb, seed=0, load_kw=1.0)``; its widths: the served
#: bursts' widest (``MAIN_LANES``) and QSTS (d)'s L1 launch (a chunk of 24
#: steps x ``MAIN_LANES`` scenarios on vvc_9bus).
CROSSOVER_NBS = (8, 32, 128, 256, 512, 1024, 2048)
CROSSOVER_LANES = (MAIN_LANES, 24 * MAIN_LANES)
CROSSOVER_KERNELS = ("ladder_solve", "ladder_vjp", "ladder_doubling",
                     "ladder_doubling_vjp")


def _out_gap(torch, got, want):
    """The largest |got - want| over v, i_branch and i_load of the lanes
    both find converged, and how many lanes those are."""
    conv = got.converged & want.converged
    gap = 0.0
    for k in ("v", "i_branch", "i_load"):
        for part in ("re", "im"):
            d = (getattr(getattr(got, k), part)
                 - getattr(getattr(want, k), part)).abs().flatten(1)
            if bool(conv.any()):
                gap = max(gap, float(d[conv].max()))
    return gap, int(conv.sum())


def time_crossover(torch, lk, extra):
    """Both routes of L1 (a fixed solve), L2, L4 (a fixed solve) and L4's
    reverse mode, 20 iterations, on each feeder of ``CROSSOVER_NBS`` x
    ``CROSSOVER_LANES`` lanes in float64 and float32, by queued events —
    each route launched through its own plan (``lk.route_plan``), and
    each route's outputs held to the plain version on the same inputs
    (L1 within ``LADDER_ATOL`` on the lanes both find converged, L2 within
    ``GRAD_RTOL`` / ``L2_F32_RTOL`` of the largest cotangent, L4 and its
    reverse mode bit for bit) — and the crossover the times imply at each
    width: the least nb of the list from which the cluster route is the
    faster at every larger nb, beside the plans' ``CLUSTER_FROM``."""
    from freedm_tpu_torch.grid import cases

    rng = np.random.default_rng(9)
    dev = torch.device("cuda")
    table = {}
    for dt in (torch.float64, torch.float32):
        dn = str(dt).split(".")[-1]
        for lanes in CROSSOVER_LANES:
            for nb in CROSSOVER_NBS:
                f = (cases.vvc_9bus() if nb == 8
                     else cases.synthetic_radial(nb, seed=0, load_kw=1.0))
                nb = f.n_branches
                s, v0, op = preorder_inputs(torch, lk, f, lanes, dt)
                sd, v0d = form_inputs(torch, f, lanes, dt)
                opd = lk.doubling_operands(f, dt, dev)
                gs = _cotangents(torch, rng, lanes, nb, dt)
                want = lk.ladder_solve_plain(s, v0, op, LADDER_EPS, 20, True,
                                             save=True)
                want_g = _flat_vjp(lk.ladder_vjp_plain(want.saved, s, op,
                                                       *gs))
                want_d = lk.ladder_doubling_plain(sd, v0d, opd, LADDER_EPS,
                                                  20, True, save=True)
                want_dg = _flat_vjp(lk.ladder_doubling_vjp_plain(
                    want_d.saved, sd, opd, *gs))
                top = max(float(w.abs().max()) for w in want_g)
                where = f"crossover nb {nb} x{lanes} {dn}"
                row = {}
                for route in ("cluster", "one_cta"):
                    plan = lk.route_plan(nb, dt, "cluster" if route ==
                                         "cluster" else "global")
                    dplan = lk.route_plan(nb, dt, "cluster" if route ==
                                          "cluster" else "cta", doubling=True)
                    fns = {
                        "ladder_solve": lambda: lk.ladder_solve(
                            s, v0, op, LADDER_EPS, 20, True, plan=plan),
                        "ladder_vjp": lambda: lk.ladder_vjp(
                            want.saved, s, op, *gs, plan=plan),
                        "ladder_doubling": lambda: lk.ladder_doubling(
                            sd, v0d, opd, LADDER_EPS, 20, True, plan=dplan),
                        "ladder_doubling_vjp": lambda: lk.ladder_doubling_vjp(
                            want_d.saved, sd, opd, *gs, plan=dplan)}
                    gap, n_conv = _out_gap(torch, fns["ladder_solve"](), want)
                    check(n_conv > 0 and gap <= LADDER_ATOL[dn],
                          f"{where}: L1 {route} {gap:.3e} from the plain "
                          f"version on {n_conv} converged lanes")
                    rel = max(max_err(g, w) for g, w in zip(
                        _flat_vjp(fns["ladder_vjp"]()), want_g)) / top
                    check(rel <= (GRAD_RTOL if dn == "float64"
                                  else L2_F32_RTOL),
                          f"{where}: L2 {route} {rel:.3e} of the largest "
                          f"cotangent from the plain version")
                    check(ladder_out_same_bits(torch, fns["ladder_doubling"](),
                                               want_d),
                          f"{where}: L4 {route} is not the plain version's "
                          f"bits")
                    check(all(torch.equal(g, w) for g, w in zip(
                        _flat_vjp(fns["ladder_doubling_vjp"]()), want_dg)),
                          f"{where}: L4's reverse mode {route} is not the "
                          f"plain version's bits")
                    row[route] = {k: queued_events_ms(torch, fn, 5)
                                  for k, fn in fns.items()}
                table[(dn, lanes, nb)] = row
                del want, want_d, want_g, want_dg
            torch.cuda.empty_cache()
    implied = {}
    for dn in ("float64", "float32"):
        for lanes in CROSSOVER_LANES:
            nbs = sorted(nb for d, w, nb in table if (d, w) == (dn, lanes))
            for k in CROSSOVER_KERNELS:
                t = {nb: table[(dn, lanes, nb)] for nb in nbs}
                implied[f"{k}_{dn}_x{lanes}"] = next(
                    (nb for i, nb in enumerate(nbs) if all(
                        t[m]["cluster"][k] <= t[m]["one_cta"][k]
                        for m in nbs[i:])), None)
            for nb in nbs:
                r = table[(dn, lanes, nb)]
                log(f"crossover: nb {nb:>5} x{lanes} {dn} ms (cluster / one "
                    f"CTA a lane): " + ", ".join(
                        f"{k} {r['cluster'][k]:.4f} / {r['one_cta'][k]:.4f}"
                        for k in CROSSOVER_KERNELS))
    log(f"crossover: each route within its limit of the plain version; the "
        f"cluster route is the faster from nb = {implied} (the plans' "
        f"CLUSTER_FROM {lk.CLUSTER_FROM})")
    for k in ("ladder_solve", "ladder_vjp", "ladder_doubling"):
        extra.setdefault(k, {})["crossover"] = {
            "cluster_from": lk.CLUSTER_FROM,
            "implied": {key: v for key, v in implied.items()
                        if key.startswith(k + "_f")},
            "implied_reverse": {key: v for key, v in implied.items()
                                if key.startswith(k + "_vjp_")},
            "ms": {f"{dn}_x{w}_nb{nb}": {r: table[(dn, w, nb)][r][k]
                                         for r in table[(dn, w, nb)]}
                   for dn, w, nb in table}}
    return table, implied


def broom_feeder(nb=10000, chain=3000, load_kw=0.2):
    """A feeder whose first ``chain`` branches form one path and whose
    others hang off the substation: every path branch's subtree closes at
    branch ``chain``, so that branch's group holds ``chain`` members, more
    than L1's cluster route stages in a CTA."""
    from freedm_tpu_torch.grid import cases, feeder

    rng = np.random.default_rng(7)
    dl = np.zeros((nb, 13))
    for i in range(nb):
        p = load_kw * rng.uniform(0.5, 1.5)
        dl[i] = [i + 1, i if 0 < i < chain else 0, i + 1, 1,
                 rng.uniform(0.001, 0.01), 1, p, 0.3 * p, p, 0.3 * p, p,
                 0.3 * p, 0]
    return feeder.from_branch_table(dl, cases.default_z_codes(1),
                                    base_kva=10000.0, v_source_pu=1.02)


def compare_ladder_routes(torch, lk, errs):
    """L1's two routes and its plan.  At ``synthetic_radial(10000)`` (the
    cluster route) a lane's outputs are the same bits in launches of 1, 8
    and 64 lanes, float64 and float32, fixed and solve modes; above the
    cluster route's float64 capacity (``synthetic_radial(20904)``) the
    global route, and in float32 the same feeder on the cluster route, and
    a feeder one of whose groups holds more members than a CTA stages
    (:func:`broom_feeder`), are held to the plain version in fixed,
    fixed-with-saved-iterates and solve modes (``LADDER_ATOL``); prints
    each plan and how many clusters the card holds at once."""
    from freedm_tpu_torch.cplx import C
    from freedm_tpu_torch.grid import cases

    feeders = {n: f for n, f, _, _ in ladder_feeders()}
    dev = torch.device("cuda")

    def head(x, k):
        return C(x.re[:k].contiguous(), x.im[:k].contiguous())

    def one(x, k):
        return C(x.re[k:k + 1].contiguous(), x.im[k:k + 1].contiguous())

    fields = ("v", "i_branch", "i_load")
    for dtype in (torch.float64, torch.float32):
        s, v0, op = preorder_inputs(torch, lk, feeders["radial10k"],
                                    MAIN_LANES, dtype)
        plan = lk.ladder_plan(op.nb, dtype)
        resident = lk.resident_clusters(plan, dtype, dev)
        for fixed in (True, False):
            wide = lk.ladder_solve(s, v0, op, LADDER_EPS, 20, fixed)
            mid = lk.ladder_solve(head(s, 8), head(v0, 8), op, LADDER_EPS,
                                  20, fixed)
            for k in (0, 5, 7):
                o = lk.ladder_solve(one(s, k), one(v0, k), op, LADDER_EPS,
                                    20, fixed)
                torch.cuda.synchronize()
                same = all(torch.equal(getattr(getattr(o, f), part)[0],
                                       getattr(getattr(x, f), part)[k])
                           for f in fields for part in ("re", "im")
                           for x in (mid, wide))
                same = same and int(o.iterations[0]) == int(
                    wide.iterations[k]) and torch.equal(o.residual[0],
                                                        wide.residual[k])
                check(same, f"L1 radial10k {dtype} fixed={fixed}: lane {k} "
                      f"differs between launches of 1, 8 and 64 lanes")
        log(f"ladder kernels: radial10k {str(dtype)[6:]} plan {plan._asdict()}"
            f", {resident} clusters at once; lanes 0, 5, 7 the same bits in "
            f"launches of 1, 8 and {MAIN_LANES} lanes (fixed and solve)")
    big = cases.synthetic_radial(lk.cluster_capacity(torch.float64) + 424,
                                 seed=3, load_kw=1.0)
    for f, dtype in ((big, torch.float64), (big, torch.float32),
                     (broom_feeder(), torch.float64),
                     (broom_feeder(), torch.float32)):
        dn = str(dtype).split(".")[-1]
        worst = 0.0
        for lanes in (1, 3):
            s, v0, op = preorder_inputs(torch, lk, f, lanes, dtype)
            plan = lk.ladder_plan(op.nb, dtype)
            for fixed, save in ((True, False), (True, True), (False, False)):
                a = lk.ladder_solve(s, v0, op, LADDER_EPS, 20, fixed, save)
                a2 = lk.ladder_solve(s, v0, op, LADDER_EPS, 20, fixed, save)
                p = lk.ladder_solve_plain(s, v0, op, LADDER_EPS, 20, fixed,
                                          save)
                torch.cuda.synchronize()
                where = (f"ladder nb {op.nb} {dn} x{lanes} {plan.route} "
                         f"fixed={fixed} save={save}")
                gap = max(float((getattr(a, f).re - getattr(p, f).re).abs()
                                .max()) for f in fields)
                gap = max(gap, max(float((getattr(a, f).im - getattr(p, f).im)
                                         .abs().max()) for f in fields))
                if save:
                    gap = max(gap, float((a.saved - p.saved).abs().max()))
                check(gap <= LADDER_ATOL[dn], f"{where}: {gap:.3e} from the "
                      f"plain version")
                check(torch.equal(a.converged, p.converged)
                      and (dn == "float32"
                           or torch.equal(a.iterations, p.iterations)),
                      f"{where}: flags or iterations differ")
                check(all(torch.equal(getattr(a, f).re, getattr(a2, f).re)
                          for f in fields), f"{where}: not bit-identical on "
                      f"repeat")
                worst = max(worst, gap)
        if dn == "float64":
            errs["ladder_solve"] = max(errs["ladder_solve"], worst)
        name = "broom" if f is not big else "radial"
        log(f"ladder kernels: {name}{f.n_branches} {dn} on the "
            f"{plan.route} route ({plan.cluster} CTAs a lane) x{{1, 3}} "
            f"fixed/save/solve: {worst:.3e} from the plain version, flags "
            f"equal, bit-identical on repeat")


def ladder_device_ms(torch, fn, reps, log_key):
    """Device time of one call of ``fn``: the profiler's kernel rows
    (:func:`device_ms`), or, where a trace holds no device events for the
    ladder kernels, CUDA events around each call with the device idle
    before it (the launch gap counted in: a few µs).  Returns (ms,
    source)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and getattr(e, "self_device_time_total", 0) > 0]
    if rows:
        return sum(e.self_device_time_total for e in rows) / 1e3 / reps, \
            "profiler"
    top = sorted(prof.key_averages(), key=lambda e: -e.cpu_time_total)
    n_dev = sum(1 for e in prof.events()
                if str(getattr(e, "device_type", "")).endswith("CUDA"))
    log(f"timing: {log_key}: the trace holds no device time "
        f"({len(prof.events())} events, {n_dev} on the device; top CPU rows "
        + ", ".join(f"{e.key} {getattr(e, 'device_type', '')}"
                    for e in top[:4]) + "); CUDA events per call")
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts)), "events per call"



def preorder_inputs(torch, lk, f, lanes, dtype):
    """L1's raw operands for ``lanes`` load lanes of feeder ``f``."""
    from freedm_tpu_torch.cplx import C
    from freedm_tpu_torch.pf.ladder import SOURCE_UNIT

    dev = torch.device("cuda")
    work, perm = f.reorder_preorder()
    op = lk.ladder_operands(work, dtype, dev)
    s = lane_loads(f, lanes)[:, perm] / f.s_base_per_phase_kva
    u = SOURCE_UNIT * f.v_source_pu

    def t(a):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    return (C(t(s.real), t(s.imag)),
            C(t(np.tile(u.real, (lanes, 1))), t(np.tile(u.imag, (lanes, 1)))),
            op)


def ladder_bytes(op, lanes, w, iters, save):
    """L1's inputs read once and outputs written once (the saved iterates
    too, when asked)."""
    nb = op.nb
    tree = w * (3 * nb + 18 * nb + nb) + 4 * (2 * nb + 1
                                              + int(op.grp_idx.shape[0]))
    out = w * 18 * lanes * nb + (4 + w + 1) * lanes
    return (w * (6 * lanes * nb + 6 * lanes) + tree + out
            + (w * 6 * lanes * nb * iters if save else 0))


def time_ladder(torch, lk, rows, extra):
    """L1 and L2 at the VVC shapes, CUDA events and device time, beside
    the plain versions and the bounds, with the route each plan takes:
    the 10k feeder × 64 (the table's row) and × 1 lanes, float64 and
    float32 (the superstep's), 20 fixed iterations, and the served
    vvc_9bus × 64.  Device time by :func:`queued_events_ms` (the profiler
    records no device events for L1/L2 in the whole script)."""
    feeders = {n: f for n, f, _, _ in ladder_feeders()}
    eps, iters = LADDER_EPS, 20
    for name, lanes, dtype in (("radial10k", MAIN_LANES, torch.float64),
                               ("radial10k", 1, torch.float64),
                               ("radial10k", MAIN_LANES, torch.float32),
                               ("radial10k", 1, torch.float32),
                               ("vvc_9bus", MAIN_LANES, torch.float64)):
        f = feeders[name]
        s, v0, op = preorder_inputs(torch, lk, f, lanes, dtype)
        nb, w = op.nb, (8 if dtype == torch.float64 else 4)
        fp64 = dtype == torch.float64
        fixed = lambda: lk.ladder_solve(s, v0, op, eps, iters, True)  # noqa: E731
        saving = lambda: lk.ladder_solve(s, v0, op, eps, iters, True,  # noqa: E731
                                         save=True)
        solving = lambda: lk.ladder_solve(s, v0, op, eps, iters, False)  # noqa: E731
        tag = f"{name} x{lanes} {str(dtype).split('.')[-1]}"
        src = src_save = src_solve = "queued events"
        k = time_ms(torch, fixed, reps=10)
        kd = queued_events_ms(torch, fixed, 7)
        k_save = time_ms(torch, saving, reps=5)
        kd_save = queued_events_ms(torch, saving, 5)
        k_solve = time_ms(torch, solving, reps=10)
        kd_solve = queued_events_ms(torch, solving, 7)
        pl = time_ms(torch, lambda: lk.ladder_solve_plain(
            s, v0, op, eps, iters, True), reps=2)
        b, by = bound(ladder_bytes(op, lanes, w, iters, False),
                      L1_OPS * nb * lanes * iters, fp64)
        sv = saving()
        n_it = int(solving().iterations.sum())
        key = f"{name}_x{lanes}_{str(dtype).split('.')[-1]}"
        plan = lk.ladder_plan(nb, dtype)
        row = {"ms": k, "device_ms": kd, "plain_ms": pl, "bound_ms": b,
               "route": plan.route, "cluster": plan.cluster,
               "bound_by": by, "device_ms_per_iteration": kd / iters,
               "device_ms_source": src, "ms_save": k_save,
               "device_ms_save": kd_save, "device_ms_source_save": src_save,
               "ms_solve": k_solve, "device_ms_solve": kd_solve,
               "device_ms_source_solve": src_solve,
               "solve_iterations": n_it}
        log(f"timing: ladder_solve {tag} ({plan.route} route, {plan.cluster} "
            f"CTAs a lane) fixed x{iters}: kernel {k:.4f} ms "
            f"(device {kd:.4f} [{src}], {kd / iters:.5f} an iteration); "
            f"saving iterates {k_save:.4f} (device {kd_save:.4f} "
            f"[{src_save}]); solve mode {k_solve:.4f} (device "
            f"{kd_solve:.4f} [{src_solve}]) for {n_it} lane-iterations; "
            f"plain {pl:.4f} ms  bound {b:.5f} ms ({by})")
        if name == "radial10k" and lanes == MAIN_LANES and fp64:
            rows["ladder_solve"] = (k, pl, None, b, by)
            extra["ladder_solve"] = {"device_ms": kd, "shape": (
                f"synthetic_radial(10000) x{lanes} f64, solve_fixed, "
                f"{iters} iterations"), **{k_: v for k_, v in row.items()
                                           if k_ not in ("ms", "plain_ms",
                                                         "bound_ms",
                                                         "bound_by")}}
        else:
            extra["ladder_solve"].setdefault("shapes", {})[key] = row
        gs = _cotangents(torch, np.random.default_rng(5), lanes, nb, dtype)
        vjp = lambda: lk.ladder_vjp(sv.saved, s, op, *gs)  # noqa: E731
        k2 = time_ms(torch, vjp, reps=10)
        kd2, src2 = queued_events_ms(torch, vjp, 7), "queued events"
        pl2 = time_ms(torch, lambda: lk.ladder_vjp_plain(sv.saved, s, op,
                                                         *gs), reps=1)
        tree = w * (3 * nb + 18 * nb) + 4 * (2 * nb + 1
                                             + int(op.grp_idx.shape[0]))
        b2, by2 = bound(w * 6 * lanes * nb * iters + w * 6 * lanes * nb * 4
                        + tree, L2_OPS * nb * lanes * iters, fp64)
        plan2 = lk.ladder_plan(nb, dtype)
        log(f"timing: ladder_vjp   {tag} {iters} iterates ({plan2.route} "
            f"route, {plan2.cluster} CTAs a lane): kernel {k2:.4f} ms "
            f"(device {kd2:.4f} [{src2}], {kd2 / iters:.5f} an iteration)  "
            f"plain {pl2:.4f} ms  bound {b2:.5f} ms ({by2})")
        if name == "radial10k" and lanes == MAIN_LANES and fp64:
            rows["ladder_vjp"] = (k2, pl2, None, b2, by2)
            extra["ladder_vjp"] = {
                "device_ms": kd2, "device_ms_per_iteration": kd2 / iters,
                "device_ms_source": src2, "route": plan2.route,
                "cluster": plan2.cluster,
                "shape": f"synthetic_radial(10000) x{lanes} f64, {iters} "
                         f"saved iterates"}
        else:
            extra["ladder_vjp"].update({f"ms_{key}": k2,
                                        f"route_{key}": plan2.route,
                                        f"device_ms_{key}": kd2,
                                        f"device_ms_source_{key}": src2,
                                        f"plain_ms_{key}": pl2,
                                        f"bound_ms_{key}": b2})
        del sv, gs
    torch.cuda.empty_cache()


def vvc_phase(torch, lk):
    """The controller through its entry points on the card: one step on
    vvc_9bus from zero q at loads P·(1 + 0.6j) against the plain step,
    120 rounds, one step on the 10k feeder × 64 lanes against the plain
    step.  Counts reset before each and read after; L2 launches once a
    step.  Returns the counts of the 10k step."""
    from freedm_tpu_torch.grid import cases
    from freedm_tpu_torch.modules import vvc

    f = cases.vvc_9bus()
    s = f.s_load.real * (1 + 0.6j)
    q0 = np.zeros((f.n_branches, 3))
    step = vvc.make_vvc_controller(f, device="cuda")
    plain = vvc.make_vvc_controller(f, device="cuda", plain=True)
    step(s, q0)  # warm-up: the timed step below is a steady one
    lk.reset_launches()
    t0 = time.monotonic()
    out = step(s, q0)
    torch.cuda.synchronize()
    wall = (time.monotonic() - t0) * 1e3
    counts = lk.launches()
    want = plain(s, q0)
    gap = 0.0
    for k in vvc.VVCStep._fields:
        a, b = getattr(out, k), getattr(want, k)
        if a.dtype == torch.bool:
            check(torch.equal(a, b), f"vvc 9bus step: {k} differs")
        else:
            gap = max(gap, max_err(a, b))
    check(gap <= VVC_ATOL, f"vvc 9bus step: {gap:.3e} from the plain step")
    check(bool(out.improved) and float(out.loss_after_kw)
          < float(out.loss_before_kw), f"vvc 9bus step did not improve: {out}")
    check(counts["ladder_vjp"] == 1 and counts["ladder_solve"] >= 2,
          f"vvc 9bus step launches {counts}")
    log(f"vvc: 9bus step {float(out.loss_before_kw):.6f} -> "
        f"{float(out.loss_after_kw):.6f} kW, alpha {float(out.alpha):g}, "
        f"{wall:.2f} ms wall, launches {counts}, max |kernel - plain step| "
        f"{gap:.3e}")
    lk.reset_launches()
    t0 = time.monotonic()
    qf, losses, alphas, improved = vvc.run_rounds(step, s, q0, VVC_ROUNDS)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = lk.launches()
    ls = losses.cpu().numpy()
    check(bool(np.all(np.diff(ls) <= 1e-12)), "vvc rounds: loss increased")
    check(ls[-1] < 0.92 * float(out.loss_before_kw),
          f"vvc rounds: {ls[-1]:.6f} kW not below 0.92 x base "
          f"{float(out.loss_before_kw):.6f}")
    check(counts["ladder_vjp"] == VVC_ROUNDS,
          f"vvc rounds: L2 launched {counts['ladder_vjp']} times")
    log(f"vvc: {VVC_ROUNDS} rounds {ls[0]:.6f} -> {ls[-1]:.6f} kW "
        f"({ls[-1] / float(out.loss_before_kw):.4f} of the base), "
        f"{int(improved.sum())} improved, {wall:.2f} s "
        f"({wall / VVC_ROUNDS * 1e3:.2f} ms a round), launches {counts}")
    f10 = cases.synthetic_radial(10000, seed=0, load_kw=1.0)
    loads = lane_loads(f10, MAIN_LANES)
    q10 = np.zeros((f10.n_branches, 3))
    step10 = vvc.make_vvc_controller(f10, device="cuda")
    plain10 = vvc.make_vvc_controller(f10, device="cuda", plain=True)
    step10(loads, q10)
    lk.reset_launches()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    got = step10(loads, q10)
    torch.cuda.synchronize()
    wall = (time.monotonic() - t0) * 1e3
    counts = lk.launches()
    t0 = time.monotonic()
    want = plain10(loads, q10)
    torch.cuda.synchronize()
    plain_wall = (time.monotonic() - t0) * 1e3
    check(torch.equal(got.alpha, want.alpha)
          and torch.equal(got.improved, want.improved),
          f"vvc 10k x64: alphas {got.alpha.tolist()} vs "
          f"{want.alpha.tolist()}")
    rel = max(float(((getattr(got, k) - getattr(want, k)).abs()
                     / getattr(want, k).abs().clamp_min(1.0)).max())
              for k in ("loss_before_kw", "loss_after_kw"))
    check(rel <= VVC_ATOL, f"vvc 10k x64: losses {rel:.3e} from the plain "
          f"step's")
    check(counts["ladder_vjp"] == 1, f"vvc 10k x64 launches {counts}")
    log(f"vvc: 10k x{MAIN_LANES} step: {wall:.2f} ms wall (plain step "
        f"{plain_wall:.1f} ms), alphas {sorted(set(got.alpha.tolist()))}, "
        f"{int(got.improved.sum())} of {MAIN_LANES} improved, losses "
        f"{float(got.loss_before_kw.mean()):.4f} -> "
        f"{float(got.loss_after_kw.mean()):.4f} kW a lane, max relative "
        f"|kernel - plain| of the losses {rel:.3e}, launches {counts}")
    return counts


def post_vvc(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    t0 = time.monotonic()
    conn.request("POST", "/v1/vvc", body=json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = json.loads(resp.read())
    lat = time.monotonic() - t0
    conn.close()
    return resp.status, data, lat


def serve_vvc(torch, lk):
    """``POST /v1/vvc`` on the default config: 64 concurrent what-ifs to
    vvc_9bus, random q in ±50 kvar on live phases (seed 9), each answer
    200 and converged, its loss and voltage extremes within 1e-9 of a
    direct ``solve_fixed``.  Returns the launch counts over the burst."""
    from freedm_tpu_torch.pf.ladder import make_ladder_solver, total_loss_kw
    from freedm_tpu_torch.serve.http import ServeServer
    from freedm_tpu_torch.serve.service import ServeConfig, Service

    svc = Service(ServeConfig(device="cuda"))
    server = ServeServer(svc).start()
    try:
        eng = svc.engine("vvc", "vvc_9bus")
        f = eng._feeder
        mask = f.phase_mask
        rng = np.random.default_rng(9)
        qs = [rng.uniform(-50.0, 50.0, (f.n_branches, 3)) * mask
              for _ in range(VVC_BURST)]
        status, data, _ = post_vvc(server.port, {
            "case": "vvc_9bus", "q_ctrl_kvar": qs[0].tolist()})
        check(status == 200, f"serve vvc warm-up: HTTP {status} {data}")
        lk.reset_launches()
        t0 = time.monotonic()
        with cf.ThreadPoolExecutor(VVC_BURST) as ex:
            out = list(ex.map(lambda q: post_vvc(server.port, {
                "case": "vvc_9bus", "q_ctrl_kvar": q.tolist()}), qs))
        wall = time.monotonic() - t0
        counts = lk.launches()
        _, fixed = make_ladder_solver(f, max_iter=20, device="cuda")
        s = np.stack([f.s_load.real + 1j * (f.s_load.imag - q) for q in qs])
        res = fixed(s)
        loss = total_loss_kw(f, res).cpu().numpy()
        live = np.concatenate([np.ones((1, 3)), mask]) > 0
        vm = res.v_node.abs().cpu().numpy()[:, live]
        worst = 0.0
        for i, (status, body, _) in enumerate(out):
            check(status == 200 and body["converged"],
                  f"serve vvc: HTTP {status}: {str(body)[:300]}")
            worst = max(worst, abs(body["loss_kw"] - loss[i]),
                        abs(body["v_min_pu"] - vm[i].min()),
                        abs(body["v_max_pu"] - vm[i].max()))
        check(worst <= VVC_ATOL,
              f"serve vvc: answers {worst:.3e} from the direct solve")
        lat = np.array([x for _, _, x in out]) * 1e3
        lanes = [b["batch"]["lanes"] for _, b, _ in out]
        log(f"serve vvc: {VVC_BURST} concurrent requests {VVC_BURST / wall:.1f}"
            f" what-ifs/s  p50 {np.percentile(lat, 50):.1f} ms  p99 "
            f"{np.percentile(lat, 99):.1f} ms  lanes a batch "
            f"{min(lanes)}-{max(lanes)}, max |answer - direct solve_fixed| "
            f"{worst:.3e}, launches {counts}")
        check(counts["ladder_solve"] > 0,
              f"L1 was not launched on the vvc path: {counts}")
        return counts
    finally:
        server.stop()
        svc.stop()


# ---------------------------------------------------------------------------
# Phases 15-17: QSTS — A1 agent_step, Q1 qsts_bus_reduce, Q2
# qsts_feeder_reduce, the studies through run_study, the jobs API
# ---------------------------------------------------------------------------

#: The reference's bench_agents population (bench.py:1192).
BENCH_AGENTS = dict(ev=400_000, thermostat=300_000, inverter=150_000,
                    dr=150_000)
SMALL_AGENTS = dict(ev=12, thermostat=10, inverter=8, dr=6)
SMALL_P0 = np.array([-1.0, -0.5, 0.0, -2.0, -0.3, 0.2])
AGENT_HOURS = (0.0, 7.5, 15.0, 19.0, 23.75)
#: A1 against its plain version: the state within 1e-13 of the largest
#: value of its array (the kernel repeats the plain version's operations
#: without contraction; libm's exp and cos on the card are shared), the
#: per-bus and served sums within 1e-12 (the served load is a tree over
#: buses in the kernel, torch.sum in the plain version).
A1_STATE_RTOL = 1e-13
QSTS_SUM_RTOL = 1e-12
QSTS_ATOL = 1e-9  # kernel-path study vs plain=True (f64)
QSTS_MIXED_ATOL = 2e-4  # the same on the mixed sparse solver
#: The residential day of mesh2000 (seed 5) is solvable through the first
#: 40 steps (10:00); after that some lanes diverge at the midday PV peak,
#: in the JAX package as in the port (CPU runs of both, 4 lanes: 7
#: non-converged lane-steps by step 48).
MIDDAY_STEP = 40
#: Operations an agent and step (exp and cos counted as 20 each), a
#: branch end of Q1 (sin, cos, two complex products, |.|), a branch
#: phase of Q2 (three complex products, |.|): rough counts for the bounds.
A1_OPS = 40
Q1_OPS = 60
Q2_OPS = 40


def rel_err(a, b):
    """max |a - b| over max |b| (the plain version's scale)."""
    d = float((a - b).abs().max()) if a.numel() else 0.0
    s = float(b.abs().max()) if b.numel() else 0.0
    return d / s if s > 0 else d


def agent_world(torch, qk, kw, case, lanes, seed=11):
    """A1's operands and a varied sorted-order state for ``kw`` agents on
    ``case`` (None: the 6-bus world) × ``lanes``, with the solved |V| of
    one step (the 6-bus world: random |V|)."""
    from freedm_tpu_torch.pf.newton import make_newton_solver
    from freedm_tpu_torch.scenarios import agents
    from freedm_tpu_torch.scenarios.profiles import ProfileSet, ProfileSpec
    from freedm_tpu_torch.serve.service import _resolve_bus_case

    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    if case is None:
        n, p0 = 6, SMALL_P0
        obs = torch.tensor(rng.uniform(0.86, 1.1, (lanes, n)), device=dev)
    else:
        sys_ = _resolve_bus_case(case)
        n, p0 = sys_.n_bus, np.asarray(sys_.p_inj)
        solve, _ = make_newton_solver(sys_, device=dev)
        scale = rng.uniform(0.8, 1.2, (lanes, 1))
        r = solve(p_inj=scale * sys_.p_inj, q_inj=scale * sys_.q_inj)
        check(bool(r.converged.all()), f"agent world {case}: not converged")
        obs = r.v.contiguous()
    prof = ProfileSet(ProfileSpec(scenarios=lanes, steps=96, seed=seed), n)
    pop, st0, _ = agents.build_population(agents.AgentSpec(**kw), prof, p0)
    op = qk.agent_operands(pop, n, dev)
    st = st0._asdict()
    st["th_on"] = rng.integers(0, 2, st["th_on"].shape).astype(np.float64)
    st["th_temp"] = st["th_temp"] + rng.normal(0.0, 1.5, st["th_temp"].shape)
    st["inv_q"] = rng.uniform(-0.02, 0.02, st["inv_q"].shape)
    st["dr_eng"] = rng.uniform(0.0, 1.0, st["dr_eng"].shape)
    return op, st, n, obs


def a1_call(torch, qk, fn, op, st, lanes, n, obs, sig, h):
    dev = torch.device("cuda")
    state = op.to_sorted(st, lanes)
    zero = torch.zeros(lanes, n, dtype=torch.float64, device=dev)
    out = [torch.empty_like(zero), torch.empty_like(zero)]
    acc = [torch.full((lanes,), 0.5, dtype=torch.float64, device=dev),
           torch.zeros(lanes, dtype=torch.float64, device=dev),
           torch.empty(lanes, dtype=torch.float64, device=dev)]
    fn(op, state, obs, sig, h, 0.25, zero, zero, *out, *acc)
    return state, out, acc


def compare_a1(torch, qk, errs):
    """A1 against its plain version: the 6-bus world × 2 and the
    million-agent population on case_ieee30 × {1, 4}; observations flat
    and solved; hours 0, 7.5, 15, 19, 23.75; the DR signal 0 and 1."""
    worst = {"state": 0.0, "sums": 0.0}
    for kw, case, lanes in ((SMALL_AGENTS, None, 2),
                            (BENCH_AGENTS, "case_ieee30", 1),
                            (BENCH_AGENTS, "case_ieee30", 4)):
        op, st, n, solved = agent_world(torch, qk, kw, case, lanes)
        for obs in (None, solved):
            for h in AGENT_HOURS:
                for sv in (0.0, 1.0):
                    sig = torch.full((lanes,), sv, dtype=torch.float64,
                                     device="cuda")
                    k = a1_call(torch, qk, qk.agent_step, op, st, lanes, n,
                                obs, sig, h)
                    p = a1_call(torch, qk, qk.agent_step_plain, op, st,
                                lanes, n, obs, sig, h)
                    again = a1_call(torch, qk, qk.agent_step, op, st, lanes,
                                    n, obs, sig, h)
                    torch.cuda.synchronize()
                    tag = (f"A1 {case or '6-bus'} x{lanes} "
                           f"{'flat' if obs is None else 'solved'} h={h} "
                           f"sig={sv}")
                    for a, c in zip(sum(k, []), sum(again, [])):
                        check(torch.equal(a, c), f"{tag}: not bit-identical "
                              f"on repeat")
                    check(torch.equal(k[0][2], p[0][2]),
                          f"{tag}: thermostat relays differ")
                    e_state = max(rel_err(a, b) for a, b in zip(k[0], p[0]))
                    e_sums = max(rel_err(a, b) for a, b in
                                 zip(k[1] + k[2], p[1] + p[2]))
                    check(e_state <= A1_STATE_RTOL,
                          f"{tag}: state {e_state:.3e} from the plain version")
                    check(e_sums <= QSTS_SUM_RTOL,
                          f"{tag}: sums {e_sums:.3e} from the plain version")
                    worst["state"] = max(worst["state"], e_state)
                    worst["sums"] = max(worst["sums"], e_sums)
        log(f"qsts kernels: A1 {case or '6-bus'} ({sum(kw.values())} agents, "
            f"{op.n_tiles} tiles, {op.n_seg} segments) x{lanes}: state "
            f"rel {worst['state']:.3e}, sums rel {worst['sums']:.3e}, "
            f"relays equal, bit-identical on repeat")
        del op
    errs["agent_step"] = max(worst.values())
    torch.cuda.empty_cache()


def random_acc(torch, qk, lanes, seed):
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")

    def f(lo, hi):
        return torch.tensor(rng.uniform(lo, hi, lanes), device=dev)

    def i(hi):
        return torch.tensor(rng.integers(0, hi, lanes).astype(np.int32),
                            device=dev)

    return qk.StepAcc(f(0, 5), f(0, 1), i(50), i(5), i(3), f(0.9, 1.1),
                      f(0.9, 1.1), f(0, 1))


def compare_acc(torch, tag, k, p, again):
    """Q1/Q2 accumulators: the counts, worst count, violation minutes and
    envelope equal, the losses and peak within QSTS_SUM_RTOL; the kernel
    bit-identical on repeat.  Returns the largest relative gap."""
    for a, c in zip(k, again):
        check(torch.equal(a, c), f"{tag}: not bit-identical on repeat")
    for name in ("viol", "it_sum", "it_max", "nonconv", "v_lo", "v_hi"):
        check(torch.equal(getattr(k, name), getattr(p, name)),
              f"{tag}: {name} differs from the plain version")
    e = max(rel_err(k.loss, p.loss), rel_err(k.peak, p.peak))
    check(e <= QSTS_SUM_RTOL, f"{tag}: sums {e:.3e} from the plain version")
    return e


def reduce_calls(torch, qk, kernel, plain, acc0):
    outs = []
    for fn in (kernel, plain, kernel):
        acc = qk.StepAcc(*(t.clone() for t in acc0))
        fn(acc)
        outs.append(acc)
    torch.cuda.synchronize()
    return outs


def q1_inputs(torch, case, lanes, seed=4):
    """A solved step of ``case`` × ``lanes`` as the engine solves it
    (mesh2000: sparse, mixed; below 512 buses dense)."""
    from freedm_tpu_torch.pf.newton import make_newton_solver
    from freedm_tpu_torch.serve.service import _resolve_bus_case

    sys_ = _resolve_bus_case(case)
    solve, _ = make_newton_solver(sys_, backend="auto", precision="auto",
                                  device="cuda")
    scale = np.random.default_rng(seed).uniform(0.6, 1.2, (lanes, 1))
    r = solve(p_inj=scale * sys_.p_inj, q_inj=scale * sys_.q_inj)
    check(bool(r.converged.all()), f"Q1 inputs {case}: not converged")
    return sys_, r


def q2_inputs(torch, steps, lanes, seed=6):
    """vvc_9bus: ``steps · lanes`` ladder lanes solved by L1 at load scales
    0.5-1.3."""
    from freedm_tpu_torch.grid.cases import vvc_9bus
    from freedm_tpu_torch.pf.ladder import make_ladder_solver

    f = vvc_9bus()
    scale = np.random.default_rng(seed).uniform(0.5, 1.3,
                                                (steps * lanes, 1, 1))
    solve, _ = make_ladder_solver(f, device="cuda")
    return f, solve(scale * f.s_load)


def compare_q(torch, qk, errs):
    """Q1 at mesh2000 × 64 (a solved mixed step) and case_ieee30 × 1, Q2
    at vvc_9bus × 24·64 lanes, against their plain versions."""
    dev = torch.device("cuda")
    worst = 0.0
    for case, lanes in (("mesh2000", MAIN_LANES), ("case_ieee30", 1)):
        sys_, r = q1_inputs(torch, case, lanes)
        op = qk.bus_reduce_operands(sys_, dev)

        def run(fn):
            return lambda acc: fn(r.v, r.theta, r.p, r.iterations,
                                  r.converged, op, acc, 15.0, 0.25, 0.95,
                                  1.05)

        k, p, again = reduce_calls(torch, qk, run(qk.qsts_bus_reduce),
                                   run(qk.qsts_bus_reduce_plain),
                                   random_acc(torch, qk, lanes, 5))
        e = compare_acc(torch, f"Q1 {case} x{lanes}", k, p, again)
        worst = max(worst, e)
        log(f"qsts kernels: Q1 {case} x{lanes}: counts, envelope equal, "
            f"losses/peak rel {e:.3e}, bit-identical on repeat")
    errs["qsts_bus_reduce"] = worst
    steps, lanes = 24, MAIN_LANES
    f, r = q2_inputs(torch, steps, lanes)
    op = qk.feeder_reduce_operands(f, dev)

    def run2(fn):
        return lambda acc: fn(r, op, acc, steps, 15.0, 0.25, 0.95, 1.05)

    k, p, again = reduce_calls(torch, qk, run2(qk.qsts_feeder_reduce),
                               run2(qk.qsts_feeder_reduce_plain),
                               random_acc(torch, qk, lanes, 7))
    e = compare_acc(torch, f"Q2 vvc_9bus x{steps}*{lanes}", k, p, again)
    errs["qsts_feeder_reduce"] = e
    log(f"qsts kernels: Q2 vvc_9bus {steps} steps x{lanes} lanes: counts, "
        f"envelope equal, losses/peak rel {e:.3e}, bit-identical on repeat")


def tensor_bytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def time_qsts(torch, qk, rows, extra):
    """A1 at the bench_agents shape × {1, 4} (the row: × 1), Q1 at
    mesh2000 × 64, Q2 at vvc_9bus × 24·64: CUDA events over back-to-back
    calls and device time, beside the plain versions and the bounds.  No
    single PyTorch call computes any of them: library "none"."""
    dev = torch.device("cuda")
    for lanes in (1, 4):
        op, st, n, obs = agent_world(torch, qk, BENCH_AGENTS, "case_ieee30",
                                     lanes)
        state = op.to_sorted(st, lanes)
        zero = torch.zeros(lanes, n, dtype=torch.float64, device=dev)
        outs = [torch.empty_like(zero), torch.empty_like(zero)]
        acc = [torch.zeros(lanes, dtype=torch.float64, device=dev)
               for _ in range(3)]
        sig = torch.ones(lanes, dtype=torch.float64, device=dev)

        def call(fn=qk.agent_step):
            fn(op, state, obs, sig, 19.0, 0.25, zero, zero, *outs, *acc)

        k = time_ms(torch, call, reps=20)
        kd, src = ladder_device_ms(torch, call, 10, f"A1 x{lanes}")
        pl = time_ms(torch, lambda: call(qk.agent_step_plain), reps=2)
        tables = (op.seg_start, op.seg_end, op.tile_seg_ptr, op.bus_seg_ptr)
        nbytes = (tensor_bytes(*op.params, *op.bus, *tables, obs, sig, zero,
                               zero, *outs) + 2 * tensor_bytes(*state)
                  + 5 * 8 * lanes)
        b, by = bound(nbytes, A1_OPS * sum(op.counts) * lanes)
        log(f"timing: agent_step bench_agents x{lanes}: kernel {k:.4f} ms "
            f"(device {kd:.4f} [{src}])  plain {pl:.4f} ms  bound {b:.5f} ms "
            f"({by}, {nbytes / 1e6:.1f} MB)")
        if lanes == 1:
            rows["agent_step"] = (k, pl, None, b, by)
            extra["agent_step"] = {
                "device_ms": kd, "device_ms_source": src, "bytes": nbytes,
                "shape": "bench_agents: 400k EV, 300k thermostats, 150k "
                         "inverters, 150k DR on case_ieee30 x1"}
        else:
            extra["agent_step"].update({
                "ms_x4": k, "device_ms_x4": kd, "plain_ms_x4": pl,
                "bound_ms_x4": b, "bytes_x4": nbytes})
        del op, state
        torch.cuda.empty_cache()
    sys_, r = q1_inputs(torch, "mesh2000", MAIN_LANES)
    op = qk.bus_reduce_operands(sys_, dev)
    acc = random_acc(torch, qk, MAIN_LANES, 5)
    v, th, p = r.v.contiguous(), r.theta.contiguous(), r.p.contiguous()

    def q1(fn=qk.qsts_bus_reduce):
        fn(v, th, p, r.iterations, r.converged, op, acc, 15.0, 0.25, 0.95,
           1.05)

    k = time_ms(torch, q1, reps=50)
    kq = queued_events_ms(torch, q1, 50)
    kd, src = ladder_device_ms(torch, q1, 20, "Q1 mesh2000 x64")
    pl = time_ms(torch, lambda: q1(qk.qsts_bus_reduce_plain), reps=5)
    m = int(op.f_idx.shape[0])
    nbytes = (tensor_bytes(v, th, p, r.iterations, r.converged, *op)
              + 2 * tensor_bytes(*acc))
    b, by = bound(nbytes, Q1_OPS * 2 * m * MAIN_LANES)
    plan = qk.bus_reduce_plan(sys_.n_bus)
    log(f"timing: qsts_bus_reduce mesh2000 x{MAIN_LANES} (plan {plan}): "
        f"queued events {kq:.4f} ms, events back to back {k:.4f} ms (device "
        f"{kd:.4f} [{src}])  plain {pl:.4f} ms  bound {b:.5f} ms ({by})")
    rows["qsts_bus_reduce"] = (kq, pl, None, b, by)
    extra["qsts_bus_reduce"] = {"ms_source": "queued CUDA events",
                                "events_back_to_back_ms": k,
                                "device_ms": kd, "device_ms_source": src,
                                "plan": list(plan),
                                "shape": "mesh2000 x64, a solved mixed step"}
    for lanes in (1, 256):  # the other widths: the x64 step's lanes cut or
        reps = -(-lanes // MAIN_LANES)  # repeated, each lane's bits its own
        vw, tw, pw = (x.repeat(reps, 1)[:lanes].contiguous()
                      for x in (v, th, p))
        itw = r.iterations.repeat(reps)[:lanes].contiguous()
        cw = r.converged.repeat(reps)[:lanes].contiguous()
        accw = random_acc(torch, qk, lanes, 5)

        def qw(fn=qk.qsts_bus_reduce):
            fn(vw, tw, pw, itw, cw, op, accw, 15.0, 0.25, 0.95, 1.05)

        kw = queued_events_ms(torch, qw, 50)
        plw = time_ms(torch, lambda: qw(qk.qsts_bus_reduce_plain), reps=3)
        bw, byw = bound(tensor_bytes(vw, tw, pw, itw, cw, *op)
                        + 2 * tensor_bytes(*accw), Q1_OPS * 2 * m * lanes)
        extra["qsts_bus_reduce"][f"x{lanes}"] = {
            "ms": kw, "plain_ms": plw, "bound_ms": bw, "bound_by": byw}
        log(f"timing: qsts_bus_reduce mesh2000 x{lanes}: queued events "
            f"{kw:.4f} ms  plain {plw:.4f} ms  bound {bw:.5f} ms ({byw})")
    steps, lanes = 24, MAIN_LANES
    f, res = q2_inputs(torch, steps, lanes)
    op2 = qk.feeder_reduce_operands(f, dev)
    acc2 = random_acc(torch, qk, lanes, 7)

    def q2(fn=qk.qsts_feeder_reduce):
        fn(res, op2, acc2, steps, 15.0, 0.25, 0.95, 1.05)

    k = time_ms(torch, q2, reps=50)
    kd, src = ladder_device_ms(torch, q2, 20, "Q2 vvc_9bus")
    pl = time_ms(torch, lambda: q2(qk.qsts_feeder_reduce_plain), reps=3)
    nbytes = (tensor_bytes(*res.v_node, *res.i_branch, *res.i_load,
                           res.iterations, res.converged, op2.root,
                           op2.live) + 2 * tensor_bytes(*acc2))
    b, by = bound(nbytes, Q2_OPS * 3 * f.n_branches * steps * lanes)
    log(f"timing: qsts_feeder_reduce vvc_9bus {steps} steps x{lanes}: kernel "
        f"{k:.4f} ms (device {kd:.4f} [{src}])  plain {pl:.4f} ms  bound "
        f"{b:.5f} ms ({by})")
    rows["qsts_feeder_reduce"] = (k, pl, None, b, by)
    extra["qsts_feeder_reduce"] = {
        "device_ms": kd, "device_ms_source": src,
        "shape": f"vvc_9bus, {steps} steps x{lanes} lanes"}


def study_states(eng):
    """The engine's final carried state, chunk by chunk."""
    spec = eng.spec
    state = eng.initial_state()
    for t0 in range(0, spec.steps, spec.chunk_steps):
        state = eng.run_chunk(state, t0, min(spec.steps, t0 + spec.chunk_steps))
    return state


def compare_states(tag, a, b, atol, exact_ints=True):
    """Float fields within ``atol``; integer fields equal (with
    ``exact_ints``: else only ``nonconv``, the flags)."""
    worst = 0.0
    for name in a._fields:
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        if x.dtype.kind in "iu":
            if exact_ints or name == "nonconv":
                check(np.array_equal(x, y), f"{tag}: {name} {x} vs {y}")
            continue
        gap = float(np.max(np.abs(x - y))) if x.size else 0.0
        check(gap <= atol, f"{tag}: {name} {gap:.3e} from plain=True")
        worst = max(worst, gap)
    return worst


def same_summary(a, b, drop=()):
    """Two summaries equal but for their timing keys (and ``drop``), NaN
    equal to NaN (a diverged lane's envelope is NaN in both)."""
    from freedm_tpu_torch.scenarios.engine import strip_timing

    def view(x):
        return json.dumps({k: v for k, v in strip_timing(x).items()
                           if k not in drop}, sort_keys=True)

    return view(a) == view(b)


def kill_and_resume(tag, spec, want, tmp, **kw):
    """Stop after ``kw['stop']`` chunks, resume from the checkpoint; the
    resumed summary must equal ``want`` (strip_timing)."""
    from freedm_tpu_torch.scenarios.engine import run_study, strip_timing

    ck = os.path.join(tmp, f"{tag}.json")
    t0 = time.monotonic()
    part = run_study(spec, checkpoint_path=ck, stop_after_chunks=kw["stop"])
    check(part["completed"] is False, f"{tag}: the killed run completed")
    out = run_study(spec, checkpoint_path=ck)
    check(out["resumed_from_chunk"] == kw["stop"],
          f"{tag}: resumed from {out['resumed_from_chunk']}")
    check(same_summary(out, want),
          f"{tag}: the resumed summary differs: {strip_timing(out)} vs "
          f"{strip_timing(want)}")
    log(f"qsts: {tag}: killed after {kw['stop']} chunks and resumed: equal "
        f"to the uninterrupted run ({time.monotonic() - t0:.1f} s with "
        f"checkpoints, {os.path.getsize(ck) / 1e6:.1f} MB)")


def split_line(eng, before):
    parts = {k: eng.wall_split[k] - before.get(k, 0.0)
             for k in eng.wall_split}
    return ", ".join(f"{k} {v:.3f} s" for k, v in parts.items())


def qsts_phase(torch, qk, lk):
    """The studies through ``run_study`` on the card: (a) the bench_qsts
    shape, (b) mesh2000 × 64 at full width, (c) the million-agent day,
    (d) the vvc_9bus feeder.  Returns the kernels' launches on their
    paths: Q1 over (b), A1 over (c)'s second run, Q2 and L1 over (d)."""
    import dataclasses
    import tempfile

    from freedm_tpu_torch.scenarios.agents import AgentSpec
    from freedm_tpu_torch.scenarios.engine import (QstsEngine, StudySpec,
                                                   run_study, strip_timing)

    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) bench_qsts: case14 x16, 96 steps of 15 min, chunks of 24.
        spec = StudySpec(case="case14", scenarios=16, steps=96,
                         dt_minutes=15.0, chunk_steps=24, seed=5)
        warm = run_study(spec)
        cold = run_study(dataclasses.replace(spec, warm_start=False))
        log(f"qsts: (a) case14 x16 x96: warm iters_mean {warm['iters_mean']}"
            f" vs cold {cold['iters_mean']}; {warm['scenario_steps_per_sec']}"
            f" scenario-steps/s warm, {cold['scenario_steps_per_sec']} cold")
        check(warm["completed"] and warm["lane_steps_not_converged"] == 0,
              f"(a): {warm}")
        check(cold["iters_mean"] > warm["iters_mean"],
              "(a): warm starts saved no iterations")
        kill_and_resume("a-case14", spec, warm, tmp, stop=2)
        got = study_states(QstsEngine(spec))
        want = study_states(QstsEngine(spec, plain=True))
        gap = compare_states("(a) vs plain=True", got, want, QSTS_ATOL)
        log(f"qsts: (a) kernel path vs plain=True: states within {gap:.3e} "
            f"pu, iteration sums equal")

        # (b) full width, the served default path.  The residential day
        # of this case is not solvable at midday: the reference diverges
        # on it too (MIDDAY_STEP), and a lane that diverges seeds its next
        # step with its diverged point, as the reference's carry does.  So
        # every lane-step must converge before midday, and the whole day
        # must complete and be reproducible.
        spec = StudySpec(case="mesh2000", scenarios=MAIN_LANES, steps=96,
                         dt_minutes=15.0, chunk_steps=24, seed=5,
                         profile="residential")
        morning = run_study(dataclasses.replace(spec, steps=MIDDAY_STEP))
        check(morning["completed"]
              and morning["lane_steps_not_converged"] == 0
              and morning["energy_balance_ok"],
              f"(b) mesh2000 before midday: {morning}")
        log(f"qsts: (b) mesh2000 x{MAIN_LANES}, the {MIDDAY_STEP} steps "
            f"before midday: every lane-step converged, "
            f"{morning['iters_mean']} Newton steps a lane-step, "
            f"{morning['scenario_steps_per_sec']} scenario-steps/s")
        t0 = time.monotonic()
        eng = QstsEngine(spec)
        build_s = time.monotonic() - t0
        qk.reset_launches()
        before = dict(eng.wall_split)
        full = run_study(spec, engine=eng)
        counts["qsts_bus_reduce"] = qk.launches()["qsts_bus_reduce"]
        check(full["completed"] and full["compiles"] <= 2,
              f"(b) mesh2000: {full}")
        check(counts["qsts_bus_reduce"] == spec.steps,
              f"(b): Q1 launched {counts['qsts_bus_reduce']} times")
        log(f"qsts: (b) mesh2000 x{MAIN_LANES} x96 ({full['pf_backend']}, "
            f"{full['pf_precision']}): {full['scenario_steps_per_sec']} "
            f"scenario-steps/s, {full['iters_mean']} Newton steps a "
            f"lane-step (max {full['iters_max']}), "
            f"{full['lane_steps_not_converged']} of "
            f"{MAIN_LANES * spec.steps} lane-steps not converged, wall "
            f"{full['wall_s']} s (engine build {build_s:.1f} s); chunk wall "
            f"split: {split_line(eng, before)}; v {full['v_min_pu']}-"
            f"{full['v_max_pu']} pu, Q1 launches "
            f"{counts['qsts_bus_reduce']}")
        again = run_study(spec, engine=eng)
        log(f"qsts: (b) second run on the built engine: "
            f"{again['scenario_steps_per_sec']} scenario-steps/s")
        check(same_summary(again, full),
              "(b): a second run differs from the first")
        kill_and_resume("b-mesh2000", spec, full, tmp, stop=2)
        other = run_study(dataclasses.replace(spec, chunk_steps=32))
        check(same_summary(full, other, drop=("chunks_total", "compiles")),
              f"(b): chunks of 32 differ: {strip_timing(full)} vs "
              f"{strip_timing(other)}")
        log("qsts: (b) chunks of 32: the summary equals chunks of 24")
        small = StudySpec(case="mesh2000", scenarios=8, steps=4,
                          chunk_steps=4, seed=5)
        got = study_states(QstsEngine(small))
        want = study_states(QstsEngine(small, plain=True))
        gap = compare_states("(b) mesh2000 x8 x4 vs plain=True", got, want,
                             QSTS_MIXED_ATOL, exact_ints=False)
        log(f"qsts: (b) mesh2000 x8 x4 kernel path vs plain=True: within "
            f"{gap:.3e} pu, flags equal (iteration sums {got.it_sum.tolist()}"
            f" vs {want.it_sum.tolist()})")
        del eng
        torch.cuda.empty_cache()

        # (c) bench_agents: a million agents on case_ieee30, 24 h steps.
        for lanes in (1, 4):
            spec = StudySpec(case="case_ieee30", scenarios=lanes, steps=24,
                             dt_minutes=60.0, chunk_steps=8, seed=11,
                             agents=AgentSpec(**BENCH_AGENTS))
            t0 = time.monotonic()
            eng = QstsEngine(spec)
            build_s = time.monotonic() - t0
            first = run_study(spec, engine=eng)
            qk.reset_launches()
            lk.reset_launches()
            before = dict(eng.wall_split)
            closed = run_study(spec, engine=eng)
            launched = qk.launches()
            if lanes == 1:
                counts["agent_step"] = launched["agent_step"]
            check(launched["agent_step"] == spec.steps
                  and launched["qsts_bus_reduce"] == spec.steps,
                  f"(c): launches {launched}")
            check(same_summary(closed, first),
                  "(c): a second run differs from the first")
            check(closed["completed"]
                  and closed["lane_steps_not_converged"] == 0,
                  f"(c): {closed}")
            log(f"qsts: (c) case_ieee30 x{lanes}, 10^6 agents, 24 h: "
                f"{closed['agent_steps_per_sec']} agent-steps/s on the "
                f"engine's second run (first {first['agent_steps_per_sec']}; "
                f"engine build {build_s:.1f} s), {closed['iters_mean']} "
                f"Newton steps a lane-step; chunk wall split: "
                f"{split_line(eng, before)}; launches {launched}; served "
                f"{closed['agent_energy_puh_mean']} pu·h, |q| peak "
                f"{closed['agent_q_peak_pu']} pu")
            if lanes == 1:
                replayed = run_study(dataclasses.replace(
                    spec, agents=dataclasses.replace(spec.agents,
                                                     closed_loop=False)))
                check(replayed["agent_q_peak_pu"] == 0.0
                      and closed["agent_q_peak_pu"] > 0.0
                      and closed["energy_loss_mwh_mean"]
                      != replayed["energy_loss_mwh_mean"],
                      f"(c): closed {closed} vs replayed {replayed}")
                log(f"qsts: (c) closed-loop |q| peak "
                    f"{closed['agent_q_peak_pu']} vs replayed "
                    f"{replayed['agent_q_peak_pu']}; losses "
                    f"{closed['energy_loss_mwh_mean']:.6f} vs "
                    f"{replayed['energy_loss_mwh_mean']:.6f} MWh")
            kill_and_resume(f"c-agents-x{lanes}", spec, closed, tmp, stop=1)
            del eng
            torch.cuda.empty_cache()

        # (d) the feeder: vvc_9bus x64, 96 steps, one L1 launch a chunk.
        spec = StudySpec(case="vvc_9bus", scenarios=MAIN_LANES, steps=96,
                         dt_minutes=15.0, chunk_steps=24, seed=5)
        eng = QstsEngine(spec)
        qk.reset_launches()
        lk.reset_launches()
        feeder = run_study(spec, engine=eng)
        counts["qsts_feeder_reduce"] = qk.launches()["qsts_feeder_reduce"]
        l1 = lk.launches()["ladder_solve"]
        n_chunks = spec.steps // spec.chunk_steps
        check(l1 == n_chunks and counts["qsts_feeder_reduce"] == n_chunks,
              f"(d): L1 {l1}, Q2 {counts['qsts_feeder_reduce']} launches for "
              f"{n_chunks} chunks")
        check(feeder["completed"] and feeder["energy_balance_ok"]
              and feeder["lane_steps_not_converged"] == 0, f"(d): {feeder}")
        got = study_states(QstsEngine(spec))
        want = study_states(QstsEngine(spec, plain=True))
        gap = compare_states("(d) vs plain=True", got, want, QSTS_ATOL)
        kill_and_resume("d-feeder", spec, feeder, tmp, stop=2)
        log(f"qsts: (d) vvc_9bus x{MAIN_LANES} x96: "
            f"{feeder['scenario_steps_per_sec']} scenario-steps/s, L1 "
            f"{l1} and Q2 {counts['qsts_feeder_reduce']} launches for "
            f"{n_chunks} chunks, within {gap:.3e} of plain=True, losses "
            f"{feeder['energy_loss_kwh_mean']:.3f} kWh a scenario")
    return counts


def post_json(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request(method, path, body=None if body is None else json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = json.loads(resp.read())
    conn.close()
    return resp.status, data


def wait_job(port, job_id, until=("completed", "failed", "cancelled"),
             timeout_s=600.0, pred=None):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        status, j = post_json(port, "GET", f"/v1/jobs/{job_id}")
        check(status == 200, f"GET /v1/jobs/{job_id}: HTTP {status} {j}")
        if j["state"] in until or (pred is not None and pred(j)):
            return j
        time.sleep(0.02)
    raise SmokeFailure(f"job {job_id} did not finish: {j}")


def serve_qsts(torch, qk):
    """``ServeServer`` with a ``JobManager`` over a temporary checkpoint
    directory: a mesh2000 study while a 64-request ``/v1/pf`` burst runs
    on case14, its summary against a direct ``run_study``, a cancelled
    keyed job resumed, an agents job, and the typed 404s."""
    import tempfile

    from freedm_tpu_torch.scenarios.engine import run_study
    from freedm_tpu_torch.scenarios.jobs import JobManager, parse_job_request
    from freedm_tpu_torch.serve.http import ServeServer
    from freedm_tpu_torch.serve.service import ServeConfig, Service

    def burst(tag):
        wall, out = post_round(server.port, "case14", scales)
        for status, body, _ in out:
            check(status == 200 and body["converged"],
                  f"serve qsts {tag}: HTTP {status}: {str(body)[:300]}")
        lat = np.array([x for _, _, x in out]) * 1e3
        return float(np.percentile(lat, 50)), float(np.percentile(lat, 99))

    with tempfile.TemporaryDirectory() as tmp:
        svc = Service(ServeConfig(max_batch=MAIN_LANES, device="cuda",
                                  cache_mb=0.0))
        jm = JobManager(workers=1, checkpoint_dir=tmp, device="cuda").start()
        server = ServeServer(svc, jobs=jm).start()
        try:
            scales = np.linspace(0.6, 1.2, MAIN_LANES)
            post_round(server.port, "case14", scales[:4])  # engine build
            alone = burst("alone")
            payload = {"case": "mesh2000", "scenarios": 16, "steps": 48,
                       "chunk_steps": 12, "seed": 5, "job_key": "s1"}
            status, d = post_json(server.port, "POST", "/v1/qsts", payload)
            check(status == 202 and d["state"] == "queued",
                  f"POST /v1/qsts: HTTP {status} {d}")
            wait_job(server.port, d["job_id"],
                     pred=lambda j: j["state"] == "running")
            during = burst("during a job")
            _, jstate = post_json(server.port, "GET", f"/v1/jobs/{d['job_id']}")
            job = wait_job(server.port, d["job_id"])
            check(job["state"] == "completed", f"job s1: {job}")
            spec, _ = parse_job_request(payload)
            direct = run_study(spec)
            check(same_summary(job["summary"], direct),
                  f"job s1 differs from a direct run_study: "
                  f"{job['summary']} vs {direct}")
            log(f"serve qsts: 64-request /v1/pf burst on case14 p50/p99 "
                f"{alone[0]:.1f}/{alone[1]:.1f} ms alone, "
                f"{during[0]:.1f}/{during[1]:.1f} ms while a mesh2000 x16 "
                f"job ran (job {jstate['state']} after the burst, chunk "
                f"{jstate['chunks_done']}/{jstate['chunks_total']}); the "
                f"job's summary equals a direct run_study "
                f"({job['summary']['scenario_steps_per_sec']} scenario-"
                f"steps/s)")
            payload2 = dict(payload, steps=96, job_key="s2")
            _, d2 = post_json(server.port, "POST", "/v1/qsts", payload2)
            wait_job(server.port, d2["job_id"],
                     pred=lambda j: j["chunks_done"] >= 1)
            status, c = post_json(server.port, "POST",
                                  f"/v1/jobs/{d2['job_id']}/cancel", {})
            check(status == 200, f"cancel: HTTP {status} {c}")
            j2 = wait_job(server.port, d2["job_id"])
            ck = os.path.join(tmp, "qsts_s2.json")
            check(j2["state"] == "cancelled" and os.path.exists(ck),
                  f"job s2 after cancel: {j2}")
            _, d3 = post_json(server.port, "POST", "/v1/qsts", payload2)
            j3 = wait_job(server.port, d3["job_id"])
            spec2, _ = parse_job_request(payload2)
            check(j3["state"] == "completed"
                  and j3["resumed_from_chunk"] > 0
                  and same_summary(j3["summary"], run_study(spec2)),
                  f"job s2 resubmitted: {j3}")
            log(f"serve qsts: job s2 cancelled after chunk "
                f"{j2['chunks_done']}, resubmitted: resumed from chunk "
                f"{j3['resumed_from_chunk']}, equal to the uninterrupted run")
            qk.reset_launches()
            _, d4 = post_json(server.port, "POST", "/v1/qsts", {
                "case": "case_ieee30", "scenarios": 2, "steps": 8,
                "chunk_steps": 4, "agents": {"ev": 4000, "thermostat": 3000,
                                             "inverter": 1500, "dr": 1500}})
            j4 = wait_job(server.port, d4["job_id"])
            a1 = qk.launches()["agent_step"]
            check(j4["state"] == "completed" and a1 == 8,
                  f"agents job: {j4.get('error')} A1 launches {a1}")
            status, e = post_json(server.port, "GET", "/v1/jobs/deadbeef")
            check(status == 404 and e["error"]["type"] == "not_found",
                  f"unknown job id: HTTP {status} {e}")
            status, h = post_json(server.port, "GET", "/healthz")
            check(status == 200 and h["qsts"] is True, f"/healthz: {h}")
            log(f"serve qsts: agents job (10^4 agents on case_ieee30 x2) "
                f"completed, A1 launched {a1} times; unknown id 404 "
                f"not_found; /healthz qsts {h['qsts']}")
        finally:
            server.stop()
            jm.stop()
            svc.stop()


# ---------------------------------------------------------------------------
# Phase 18: the topology kernels (T1, T2)
# ---------------------------------------------------------------------------

#: T2 against its plain version: θ, flows, loss and worst flow within
#: 1e-10 pu absolute (the r × r solve and the sums round in another
#: order); T2's islanding flags and violation counts and T1's booleans
#: equal; both bit-identical on repeat.
TOPO_ATOL = 1e-10
TOPO_CASES = ("case14", "case_ieee30", "mesh118", "mesh2000")
TOPO_LANES = (1, 64, 4096)  # capped by a case's distinct open-sets of a rank
TOPO_RANKS = (1, 2, 6)
#: The flow bar of the compared and timed screens, pu.
TOPO_LIMIT = 0.5
#: H100 SXM int32 rate outside the tensor cores: 64 INT32 lanes an SM a
#: clock (Hopper architecture white paper) x 132 SMs x 1.98 GHz.
PEAK_INT32 = 16.7e12
#: The integer operations that labelling a lane's components needs at
#: least, one pass over its inputs (loads not counted): per closed edge a
#: compare and a min, per bus the compare of the connected test.
T1_EDGE_OPS, T1_BUS_OPS = 2, 1
#: T2's float64 operations a lane: per bus and active slot a multiply and
#: an add, per bus an add, per branch a subtract, three multiplies, an
#: add, an abs and a compare.
T2_SLOT_OPS, T2_BUS_OPS, T2_EDGE_OPS = 2, 1, 7
#: The sweep gate of the reference's bench (``bench.py`` ``bench_topo``):
#: variants/s over every rank-<=2 variant of mesh118 — its gate value, for
#: orientation only; no time of another device is quoted here.
TOPO_GATE_FLOOR = 10_000
#: The full-width sweep: mesh2000 neighborhood samples of rank <= 3, in
#: chunks of this many (the largest chunk a job takes).
TOPO_FULL_SAMPLES = 65536
TOPO_FULL_CHUNK = 16384
#: The served shortlist's AC lanes: converged, and the host float64
#: residual of each variant's own topology under this bar.
AC_TRUE_MISMATCH = 1e-6


def random_open_sets(m, lanes, rank, seed):
    """``lanes`` distinct random open-sets of rank 1..``rank`` of ``m``
    branches (int32, ``-1`` pads)."""
    rng = np.random.default_rng(seed)
    rows, seen = [], set()
    while len(rows) < lanes:
        r = int(rng.integers(1, rank + 1))
        combo = tuple(sorted(rng.choice(m, size=r, replace=False).tolist()))
        if combo in seen:
            continue
        seen.add(combo)
        row = np.full(rank, -1, np.int32)
        row[:r] = combo
        rows.append(row)
    return np.stack(rows)


def topo_inputs(torch, tp, name, dev="cuda"):
    """One case's T1/T2 operands on the card, its Zᵀ and base angles θ0."""
    from freedm_tpu_torch.pf.fdlf import decoupled_parts

    sys_ = case_system(name)
    dev = torch.device(dev)
    op = tp.topo_operands(sys_, device=dev)
    parts = decoupled_parts(sys_, device=dev)
    lu = torch.linalg.lu_factor(parts.b_prime(None))
    zt = tp.z_transpose(sys_, lu, op)
    p0 = torch.as_tensor(np.asarray(sys_.p_inj, np.float64), device=dev)
    rhs = torch.where(parts.th_free > 0, p0, torch.zeros_like(p0))
    theta0 = torch.linalg.lu_solve(*lu, rhs[:, None])[:, 0].contiguous()
    return sys_, op, zt, theta0


def compare_topo_block(torch, tk, op, zt, theta0, sl, tag):
    """T1 and T2 (both modes) against their plain versions on one slot
    block; returns (T2's worst gap, |det C| max over islanded lanes, min
    over the others)."""
    cap = op.n + 1
    k1 = tk.topo_radiality(sl, op, cap)
    again1 = tk.topo_radiality(sl, op, cap)
    p1 = tk.topo_radiality_plain(sl, op, cap)
    check(torch.equal(k1[0], p1[0]) and torch.equal(k1[1], p1[1]),
          f"topo_radiality {tag}: connected/radial differ from the plain "
          f"version")
    check(torch.equal(k1[0], again1[0]) and torch.equal(k1[1], again1[1]),
          f"topo_radiality {tag}: not bit-identical on repeat")
    k2 = tk.topo_screen(zt, theta0, sl, TOPO_LIMIT, op, tk.DETAIL)
    again2 = tk.topo_screen(zt, theta0, sl, TOPO_LIMIT, op, tk.DETAIL)
    s2 = tk.topo_screen(zt, theta0, sl, TOPO_LIMIT, op, tk.SCREEN)
    p2 = tk.topo_screen_plain(zt, theta0, sl, TOPO_LIMIT, op, tk.DETAIL)
    check(torch.equal(k2.islanded, p2.islanded),
          f"topo_screen {tag}: islanding flags differ "
          f"({int((k2.islanded != p2.islanded).sum())} lanes)")
    check(torch.equal(k2.violations, p2.violations),
          f"topo_screen {tag}: violation counts differ")
    gap = 0.0
    for field in ("theta", "flows", "loss", "worst_flow"):
        g = max_err(getattr(k2, field), getattr(p2, field))
        check(g <= TOPO_ATOL, f"topo_screen {tag}: {field} {g:.3e} from the "
              f"plain version")
        gap = max(gap, g)
    check(all(torch.equal(getattr(k2, f), getattr(again2, f))
              for f in k2._fields),
          f"topo_screen {tag}: not bit-identical on repeat")
    check(all(torch.equal(getattr(k2, f), getattr(s2, f))
              for f in ("loss", "worst_flow", "violations", "islanded")),
          f"topo_screen {tag}: SCREEN differs from DETAIL")
    det = tk.capacitance_det(zt, sl, op).abs()
    isl = k2.islanded
    hi = float(det[isl].max()) if bool(isl.any()) else 0.0
    lo = float(det[~isl].min()) if bool((~isl).any()) else float("inf")
    return gap, hi, lo, int(isl.sum()), int((~k1[0]).sum())


def compare_topo(torch, tk, tp, errs, dev="cuda", cases=TOPO_CASES):
    """T1 and T2 against their plain versions at case14, case_ieee30,
    mesh118 and mesh2000 × V ∈ {1, 64, 4096} × r ∈ {1, 2, 6} (random
    distinct open-sets, seeded), every rank-<=2 variant of case14,
    case_ieee30 and mesh118, and the bridges of case14 and case_ieee30;
    then T1 on bare graphs (:func:`topo_graphs`) and a lane's bits across
    launch widths (:func:`topo_widths`)."""
    from freedm_tpu_torch.pf.n1 import secure_outages

    t0 = time.monotonic()
    worst, det_hi, det_lo, blocks = 0.0, 0.0, float("inf"), 0
    for ci, name in enumerate(cases):
        sys_, op, zt, theta0 = topo_inputs(torch, tp, name, dev)
        m = sys_.n_branch
        cases = [(f"r{rank} x{lanes}", random_open_sets(
            m, min(lanes, tp.count_exhaustive(m, rank)), rank,
            seed=100 * ci + 10 * rank + (lanes > 1) + 5 * (lanes == 64)))
            for rank in TOPO_RANKS for lanes in TOPO_LANES]
        if name != "mesh2000":
            cases.append(("every rank<=2",
                          tp.enumerate_variants(np.arange(m), 2)))
        line = []
        for tag, slots in cases:
            sl = torch.as_tensor(slots, device=dev)
            gap, hi, lo, n_isl, n_disc = compare_topo_block(
                torch, tk, op, zt, theta0, sl, f"{name} {tag}")
            worst, det_hi, det_lo = max(worst, gap), max(det_hi, hi), \
                min(det_lo, lo)
            blocks += 1
            line.append(f"{tag} ({sl.shape[0]} lanes, {n_disc} disconnected, "
                        f"{n_isl} islanded) {gap:.1e}")
        log(f"topo kernels: {name}: " + "; ".join(line))
        if name in ("case14", "case_ieee30"):
            bridges = sorted(set(range(m)) - set(secure_outages(sys_)))
            slots = np.full((len(bridges), 2), -1, np.int32)
            slots[:, 0] = bridges
            sl = torch.as_tensor(slots, device=dev)
            conn = tk.topo_radiality(sl, op, sys_.n_bus + 1)[0]
            isl = tk.topo_screen(zt, theta0, sl, TOPO_LIMIT, op).islanded
            check(not bool(conn.any()) and bool(isl.all()),
                  f"topo kernels: {name}'s bridges {bridges} not all flagged "
                  f"(T1 connected {conn.tolist()}, T2 islanded "
                  f"{isl.tolist()})")
            log(f"topo kernels: {name}'s {len(bridges)} bridges flagged by T1 "
                f"and T2")
    topo_graphs(torch, tk, dev)
    topo_widths(torch, tk, tp, dev)
    sync(torch, torch.device(dev))
    errs["topo_radiality"] = 0.0  # booleans: equal
    errs["topo_screen"] = worst
    log(f"topo kernels: {blocks} blocks, T1 booleans equal, T2 flags and "
        f"violations equal, theta/flows/loss/worst within {worst:.2e} "
        f"(<= {TOPO_ATOL:g}), both bit-identical on repeat; |det C| <= "
        f"{det_hi:.3e} on islanded lanes, >= {det_lo:.3e} on the others "
        f"(threshold {tk.ISLAND_EPS:g}) "
        f"({time.monotonic() - t0:.1f} s)")
    return {"det_max_islanded": det_hi, "det_min_connected": det_lo}


def graph_operands(torch, tk, n, f, t, dev):
    """T1's operands of a bare graph (T2's floats zero)."""
    plan = tk.tree_plan(n, f, t)

    def idx(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    zero = torch.zeros(len(f), dtype=torch.float64, device=dev)
    return tk.TopoOperands(n, idx(f), idx(t), zero, zero, zero, zero, plan,
                           idx(plan.cut), idx(tk.tree_buffer(plan)))


def topo_graphs(torch, tk, dev="cuda"):
    """T1 against its plain version on graphs the cases lack: a ring with
    parallel branches, a chord and self-loops; case14 with its bridges
    removed (a disconnected base); a 2-bus graph of 300 parallel branches;
    each over seeded rows of up to 6 slots with repeats, pads and slots >=
    m."""
    from freedm_tpu_torch.pf.n1 import secure_outages

    ring_f = list(range(12)) + [3, 7, 2, 5, 9]
    ring_t = [(i + 1) % 12 for i in range(12)] + [4, 8, 9, 5, 9]
    c14 = case_system("case14")
    keep = np.asarray(secure_outages(c14))
    graphs = {"ring+parallel+self-loops": (12, ring_f, ring_t),
              "case14 without bridges": (
                  c14.n_bus, np.asarray(c14.from_bus)[keep],
                  np.asarray(c14.to_bus)[keep]),
              "2 buses x 300 branches": (2, [0] * 300, [1] * 300)}
    rng = np.random.default_rng(18)
    for name, (n, f, t) in graphs.items():
        op = graph_operands(torch, tk, n, f, t, dev)
        m = op.m
        sl = rng.integers(-1, m + 2, size=(512, 6)).astype(np.int32)
        sl[::3, 3:] = sl[::3, :3]  # repeats
        sl = torch.as_tensor(sl, device=dev)
        got = tk.topo_radiality(sl, op, n + 1)
        want = tk.topo_radiality_plain(sl, op, n + 1)
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"topo_radiality {name}: connected/radial differ from the "
              f"plain version")
        log(f"topo graphs: {name} (n {n}, m {m}, base connected "
            f"{op.tree.connected}): T1 equal to its plain version on 512 "
            f"rows ({int(got[0].sum())} connected)")


def topo_widths(torch, tk, tp, dev="cuda"):
    """A lane's T1 booleans and T2 DETAIL outputs are the same bits at
    launch widths 1, 64 and 4096 and in a permuted chunk (mesh118, 4096
    rank-2 variants; mesh2000, 4096 neighborhood samples of rank <= 3);
    on the card T1 refuses ``with_sweeps``."""
    for name, rank in (("mesh118", 2), ("mesh2000", 3)):
        sys_, op, zt, theta0 = topo_inputs(torch, tp, name, dev)
        m = sys_.n_branch
        slots = (tp.enumerate_variants(np.arange(m), 2)[4096:8192]
                 if rank == 2 else
                 tp.neighborhood_variants(np.arange(m), rank, 4096, 11))
        sl = torch.as_tensor(slots, device=dev)

        def lanes(s):
            c, r = tk.topo_radiality(s, op, op.n + 1)
            d = tk.topo_screen(zt, theta0, s, TOPO_LIMIT, op, tk.DETAIL)
            return [c, r, d.loss, d.worst_flow, d.violations, d.islanded,
                    d.theta, d.flows]

        full = lanes(sl)
        perm = torch.as_tensor(np.random.default_rng(21).permutation(
            sl.shape[0]), device=sl.device)
        picks = [("x1 lane 0", slice(0, 1)), ("x1 lane 4095",
                                               slice(4095, 4096)),
                 ("x64 rows 64-127", slice(64, 128))]
        for tag, rows in picks:
            got = lanes(sl[rows].contiguous())
            check(all(torch.equal(a, b[rows]) for a, b in zip(got, full)),
                  f"topo widths {name}: {tag} differs from the 4096-lane "
                  f"launch")
        got = lanes(sl[perm].contiguous())
        check(all(torch.equal(a, b[perm]) for a, b in zip(got, full)),
              f"topo widths {name}: a permuted chunk differs")
        log(f"topo widths: {name} r{rank}: T1 and T2 DETAIL the same bits at "
            f"widths 1, 64 and 4096 and in a permuted chunk")
    if torch.device(dev).type == "cuda":
        try:
            tk.topo_radiality(sl, op, op.n + 1, with_sweeps=True)
        except ValueError as err:
            check("topo_radiality_plain" in str(err),
                  f"topo widths: T1's refusal names no plain version: {err}")
        else:
            check(False, "topo widths: T1 counted sweeps on the card")


def t1_bound(op, sl):
    """T1's least time from its inputs alone: its bytes (slots, branch
    ends, the two boolean outputs) or one pass of integer operations over
    each lane's closed edges and buses — not the sweeps the kernel makes."""
    lanes, r = int(sl.shape[0]), int(sl.shape[1])
    nbytes = lanes * r * 4 + 2 * op.m * 4 + lanes * 2
    closed = op.m - ((sl >= 0) & (sl < op.m)).sum(dim=1)
    ops = float((T1_EDGE_OPS * closed.double() + T1_BUS_OPS * op.n).sum())
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_INT32 * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"),
            nbytes)


def t2_bound(op, sl, detail=False):
    """T2's least time: the active rows of Zᵀ, θ0, the branch arrays, the
    slots and the outputs (DETAIL: the [V, n] and [V, m] writes too), or
    its float64 operations."""
    lanes, r = int(sl.shape[0]), int(sl.shape[1])
    n, m = op.n, op.m
    active = int(((sl >= 0) & (sl < m)).sum())
    nbytes = (active * n * 8 + n * 8 + m * (4 + 4 + 4 * 8) + lanes * r * 4
              + lanes * (3 * 8 + 1))
    if detail:
        nbytes += lanes * (n + m) * 8
    ops = (T2_SLOT_OPS * n * active + lanes * (T2_BUS_OPS * n
                                               + T2_EDGE_OPS * m
                                               + 4 * r * r + r ** 3))
    return bound(nbytes, ops), nbytes


def time_t1_t2(torch, tk, op, zt, theta0, sl, tag, detail_too=False):
    """Events back to back, device time by queued events and the plain
    versions' times of T1 and T2 SCREEN (and DETAIL) on one block, with
    their bounds; T1's sweep count from its plain version (the kernel runs
    none)."""
    cap = op.n + 1
    out = {}
    t1 = lambda: tk.topo_radiality(sl, op, cap)  # noqa: E731
    sweeps = tk.topo_radiality_plain(sl, op, cap, with_sweeps=True)[2]
    (b1, by1), bytes1 = t1_bound(op, sl)
    k = time_ms(torch, t1, reps=20)
    kd = queued_events_ms(torch, t1, 20)
    pl = time_ms(torch, lambda: tk.topo_radiality_plain(sl, op, cap), reps=2)
    out["topo_radiality"] = dict(
        ms=k, device_ms=kd, device_ms_source="queued events", plain_ms=pl,
        bound_ms=b1, bound_by=by1, bytes=bytes1,
        plain_sweeps_max=int(sweeps.max()),
        plain_sweeps_mean=float(sweeps.double().mean()))
    log(f"timing: topo_radiality {tag}: kernel {k:.4f} ms (device {kd:.4f} "
        f"[queued events])  plain {pl:.3f} ms  bound {b1:.5f} ms ({by1}); "
        f"the plain version's sweeps {int(sweeps.min())}-"
        f"{int(sweeps.max())}, mean {float(sweeps.double().mean()):.2f}")
    modes = (("SCREEN", tk.SCREEN),) + ((("DETAIL", tk.DETAIL),)
                                        if detail_too else ())
    for label, mode in modes:
        def t2(fn=tk.topo_screen, mode=mode):
            fn(zt, theta0, sl, TOPO_LIMIT, op, mode)

        (b2, by2), bytes2 = t2_bound(op, sl, detail=mode == tk.DETAIL)
        k = time_ms(torch, t2, reps=20)
        kd = queued_events_ms(torch, t2, 20)
        pl = time_ms(torch, lambda: t2(tk.topo_screen_plain), reps=2)
        out[f"topo_screen_{label}"] = dict(
            ms=k, device_ms=kd, device_ms_source="queued events",
            plain_ms=pl, bound_ms=b2, bound_by=by2, bytes=bytes2,
            plan=tk.screen_plan(op.n, op.m, int(sl.shape[1]))._asdict())
        log(f"timing: topo_screen {label} {tag}: kernel {k:.4f} ms (device "
            f"{kd:.4f} [queued events])  plain {pl:.3f} ms  bound {b2:.5f} "
            f"ms ({by2}, {bytes2 / 1e6:.2f} MB)")
    return out


def time_radiality_ctas(torch, tk, op, sl, tag):
    """T1 at 4, 8, 16 and 32 warps a CTA on one block: device time by
    queued events, the booleans equal to the chosen CTA's."""
    base = tk.topo_radiality(sl, op, op.n + 1)
    out = {}
    for warps in (4, 8, 16, 32):
        got = tk.radiality_launch(sl, op, warps)
        check(all(torch.equal(a, b) for a, b in zip(got, base)),
              f"topo_radiality {tag}: {warps} warps a CTA disagree")
        out[warps] = queued_events_ms(
            torch, lambda warps=warps: tk.radiality_launch(sl, op, warps), 20)
    log(f"timing: topo_radiality CTAs {tag} (queued events): "
        + "; ".join(f"{w} warps {ms:.4f} ms" for w, ms in out.items())
        + f"; T1_WARPS = {tk.T1_WARPS}")
    return out


def time_screen_plans(torch, tk, op, zt, theta0, sl, tag):
    """T2 SCREEN at other launch plans than ``screen_plan``'s on one block:
    device time by queued events of each, its outputs within
    ``TOPO_ATOL`` of the chosen plan's (flags and violations equal)."""
    r = int(sl.shape[1])
    chosen = tk.screen_plan(op.n, op.m, r)
    base = tk.screen_launch(zt, theta0, sl, TOPO_LIMIT, op, tk.SCREEN,
                            chosen)
    plans = {"chosen": chosen}
    if chosen.warps <= 8:  # the other stream width at the same shape
        plans["narrow" if chosen.wide else "wide"] = chosen._replace(
            wide=not chosen.wide)
    for warps, group, masks in ((8, 1, False), (8, 1, True), (4, 1, True),
                                (8, 8, True), (8, 2, False), (16, 2, False),
                                (16, 1, False), (16, 4, True)):
        smem = tk.screen_smem(op.n, op.m, warps, group, True, masks)
        if smem <= tk.SMEM_LIMIT and (warps <= 8 or chosen.wide):
            plans[f"w{warps}g{group}{'m' if masks else ''}"] = tk.ScreenPlan(
                warps, group, True, masks, smem, chosen.wide)
    plans["unstaged w1"] = tk.ScreenPlan(
        1, 1, False, False, tk.screen_smem(op.n, op.m, 1, 1, False, False),
        chosen.wide)
    out = {}
    for key, plan in plans.items():
        got = tk.screen_launch(zt, theta0, sl, TOPO_LIMIT, op, tk.SCREEN,
                               plan)
        check(torch.equal(got.islanded, base.islanded)
              and torch.equal(got.violations, base.violations)
              and max(max_err(got.loss, base.loss),
                      max_err(got.worst_flow, base.worst_flow)) <= TOPO_ATOL,
              f"topo_screen {tag}: plan {plan} disagrees with {chosen}")
        ms = queued_events_ms(torch, lambda plan=plan: tk.screen_launch(
            zt, theta0, sl, TOPO_LIMIT, op, tk.SCREEN, plan), 10)
        out[key] = dict(plan._asdict(), device_ms=ms)
    log(f"timing: topo_screen plans {tag} (queued events): "
        + "; ".join(f"{k} {v['device_ms']:.4f} ms" for k, v in out.items())
        + f"; screen_plan picks {tuple(chosen)}")
    return out


def refactor_solve(torch, sys_, op, sl):
    """The per-variant refactorization the SMW lanes replace (the
    reference bench's head-to-head): B′ re-formed with each lane's
    branches open, ``B′ − Σ_S w_k a_k a_kᵀ`` ``[V, n, n]``, and the
    right-hand side; the timed library call is ``torch.linalg.solve_ex``
    of the stack."""
    from freedm_tpu_torch.pf.fdlf import decoupled_parts

    dev = sl.device
    parts = decoupled_parts(sys_, device=dev)
    lanes, r = int(sl.shape[0]), int(sl.shape[1])
    ok = (sl >= 0) & (sl < op.m)
    k = torch.where(ok, sl, 0).long()
    a = torch.zeros(lanes, op.n, r, dtype=torch.float64, device=dev)
    lane = torch.arange(lanes, device=dev)[:, None].expand(lanes, r)
    col = torch.arange(r, device=dev)[None, :].expand(lanes, r)
    act = ok.double()
    a.index_put_((lane, op.f.long()[k], col), op.mask_f[k] * act,
                 accumulate=True)
    a.index_put_((lane, op.t.long()[k], col), -op.mask_t[k] * act,
                 accumulate=True)
    w = op.w[k] * act
    b = parts.b_prime(None) - torch.bmm(a * w[:, None, :], a.mT)
    p0 = torch.as_tensor(np.asarray(sys_.p_inj, np.float64), device=dev)
    rhs = torch.where(parts.th_free > 0, p0, torch.zeros_like(p0))
    return b, rhs[None, :, None].expand(lanes, op.n, 1).contiguous()


def time_topo(torch, tk, tp, rows, extra):
    """T1 and T2 SCREEN at mesh118 × 4096, r = 2 (a chunk of the gate
    sweep), × 64 (a chunk of the served sweep job) and mesh2000 × 16384,
    r = 3 (the first chunk of the full-width neighborhood sweep), T2 DETAIL
    at mesh118 × 4096 and × 64, T2's other launch plans at mesh2000 ×
    16384 and mesh118 × 4096; the library row: the
    re-formed B′ stack of the mesh118 chunk through
    ``torch.linalg.solve_ex``, and per variant on the reference bench's 32
    mixed-rank lanes."""
    dev = torch.device("cuda")
    sys_, op, zt, theta0 = topo_inputs(torch, tp, "mesh118")
    chunk = tp.enumerate_variants(np.arange(sys_.n_branch), 2)[4096:8192]
    sl = torch.as_tensor(chunk, device=dev)
    small = time_t1_t2(torch, tk, op, zt, theta0, sl, "mesh118 x4096 r2",
                       detail_too=True)
    # A chunk of the served sweep job: 64 lanes.
    served = time_t1_t2(torch, tk, op, zt, theta0, sl[:64].contiguous(),
                        "mesh118 x64 r2", detail_too=True)
    b, rhs = refactor_solve(torch, sys_, op, sl)
    lib = time_ms(torch, lambda: torch.linalg.solve_ex(b, rhs), reps=5)
    # The reference bench's head-to-head: 32 mixed-rank lanes (8 rank 1,
    # 24 rank 2 of branches 0-8), per variant, each side one call.
    pool = tp.enumerate_variants(np.arange(9), 2)
    sample = np.concatenate([pool[pool[:, 1] < 0][:8],
                             pool[pool[:, 1] >= 0][:24]])
    s32 = torch.as_tensor(sample, device=dev)
    b32, rhs32 = refactor_solve(torch, sys_, op, s32)
    ref_theta = torch.linalg.solve_ex(b32, rhs32)[0][..., 0]
    det32 = tk.topo_screen(zt, theta0, s32, TOPO_LIMIT, op, tk.DETAIL)
    okl = ~det32.islanded
    dth = max_err(ref_theta[okl], det32.theta[okl])
    check(dth < 1e-8, f"topo: SMW lanes {dth:.3e} from refactorization")
    lib32 = time_ms(torch, lambda: torch.linalg.solve_ex(b32, rhs32),
                    reps=20) * 1e3 / 32
    smw32 = time_ms(torch, lambda: tk.topo_screen(zt, theta0, s32,
                                                  TOPO_LIMIT, op),
                    reps=20) * 1e3 / 32
    log(f"timing: refactorization head-to-head, mesh118: torch.linalg."
        f"solve_ex of 4096 re-formed B' {lib:.3f} ms; 32 mixed-rank lanes "
        f"{lib32:.2f} us a variant against T2 SCREEN {smw32:.2f} us a "
        f"variant (x{lib32 / smw32:.1f}); theta within {dth:.1e}")
    del b, b32
    sys2, op2, zt2, th2 = topo_inputs(torch, tp, "mesh2000")
    big = tp.neighborhood_variants(np.arange(sys2.n_branch), 3, 16384, 7)
    sl2 = torch.as_tensor(big, device=dev)
    large = time_t1_t2(torch, tk, op2, zt2, th2, sl2, "mesh2000 x16384 r<=3")
    plans = time_screen_plans(torch, tk, op2, zt2, th2, sl2,
                              "mesh2000 x16384 r<=3")
    plans118 = time_screen_plans(torch, tk, op, zt, theta0, sl,
                                 "mesh118 x4096 r2")
    ctas = {"mesh118_x4096": time_radiality_ctas(torch, tk, op, sl,
                                                 "mesh118 x4096 r2"),
            "mesh118_x64": time_radiality_ctas(
                torch, tk, op, sl[:64].contiguous(), "mesh118 x64 r2"),
            "mesh2000_x16384": time_radiality_ctas(
                torch, tk, op2, sl2, "mesh2000 x16384 r<=3")}
    del zt2
    torch.cuda.empty_cache()
    r1, r2 = small["topo_radiality"], small["topo_screen_SCREEN"]
    rows["topo_radiality"] = (r1["ms"], r1["plain_ms"], None, r1["bound_ms"],
                              r1["bound_by"])
    rows["topo_screen"] = (r2["ms"], r2["plain_ms"], lib, r2["bound_ms"],
                           r2["bound_by"])
    shape = "mesh118 x4096 lanes, rank 2 (rows 4096-8191 of the gate sweep)"
    extra["topo_radiality"] = {
        "shape": shape, **{k: v for k, v in r1.items()
                           if k not in ("ms", "plain_ms", "bound_ms",
                                        "bound_by")},
        "mesh118_x64": served["topo_radiality"],
        "mesh2000_x16384": large["topo_radiality"], "ctas": ctas}
    extra["topo_screen"] = {
        "shape": shape, **{k: v for k, v in r2.items()
                           if k not in ("ms", "plain_ms", "bound_ms",
                                        "bound_by")},
        "library": "torch.linalg.solve_ex of the 4096 re-formed B' "
                   "[4096, 118, 118] (forming excluded)",
        "detail_mesh118_x4096": small["topo_screen_DETAIL"],
        "mesh118_x64": served["topo_screen_SCREEN"],
        "detail_mesh118_x64": served["topo_screen_DETAIL"],
        "mesh2000_x16384": large["topo_screen_SCREEN"],
        "plans_mesh2000_x16384": plans, "plans_mesh118_x4096": plans118,
        "refactor_us_per_variant_32": lib32,
        "smw_us_per_variant_32": smw32}
    return {"mesh2000": large, "mesh118": small}


# ---------------------------------------------------------------------------
# Phase 19: topology sweeps through run_topo_sweep
# ---------------------------------------------------------------------------


def same_topo(a, b, drop=()):
    """Two sweep summaries equal but for the timing keys (and ``drop``)."""
    from freedm_tpu_torch.pf.topo import strip_topo_timing

    def view(x):
        return json.dumps({k: v for k, v in strip_topo_timing(x).items()
                           if k not in drop}, sort_keys=True)

    return view(a) == view(b)


def check_shortlist(tag, summary, bridges=frozenset()):
    sl = summary["shortlist"]
    check(sl, f"{tag}: empty shortlist")
    for e in sl:
        check(e["ac_converged"], f"{tag}: AC lane not converged: {e}")
        check(e["ac_true_mismatch_pu"] < AC_TRUE_MISMATCH,
              f"{tag}: AC true mismatch {e['ac_true_mismatch_pu']:.3e}")
        check(not set(e["open_branches"]) & set(bridges),
              f"{tag}: a bridge in the shortlist: {e}")
    return max(e["ac_true_mismatch_pu"] for e in sl)


def topo_sweeps(torch, tk, tp, timed, dev="cuda"):
    """(a) the reference bench's gate shape: every rank-<=2 variant of
    mesh118 in chunks of 4096, top 8 by loss — variants/s beside the
    reference's floor, the AC verify of the top 8 apart, kill after 3 chunks
    and resume, chunks of 1024, the plain versions' shortlist, T1 and T2
    once a chunk; (b) full width: mesh2000, 65,536 neighborhood samples of
    rank <= 3 (seed 7) in four chunks of 16,384.  Returns T1's and T2's
    launches over (a)'s timed run."""
    import dataclasses
    import tempfile

    from freedm_tpu_torch.pf.n1 import secure_outages

    dev = torch.device(dev)

    def run(spec, **kw):
        return tp.run_topo_sweep(spec, device=dev, **kw)

    t_phase = time.monotonic()
    spec = tp.TopoSweepSpec(case="mesh118", max_rank=2, chunk_variants=4096,
                            top_k=8, objective="loss")
    first = run(spec)  # builds the verifier of the case
    tk.reset_launches()
    summary = run(spec)
    counts = tk.launches()
    modes = tk.mode_launches()["topo_screen"]
    n_chunks = summary["chunks_total"]
    check(summary["variants_total"] == 27966 and summary["completed"],
          f"topo sweep (a): {summary}")
    want = n_chunks if dev.type == "cuda" else 0
    check(counts == {"topo_radiality": want, "topo_screen": want}
          and modes["SCREEN"] == want,
          f"topo sweep (a): launches {counts} {modes} over {n_chunks} chunks")
    check(same_topo(first, summary), "topo sweep (a): a second run differs")
    sys_ = case_system("mesh118")
    bridges = set(range(sys_.n_branch)) - set(secure_outages(sys_))
    worst_ac = check_shortlist("topo sweep (a)", summary, bridges)
    check(len(summary["shortlist"]) == 8, "topo sweep (a): short shortlist")
    verifier = tp._cached_ac_verifier("mesh118", sys_, 8, device=dev)
    status = tp.status_from_slots(torch.as_tensor(np.array(
        [e["open_branches"] + [-1] * (2 - len(e["open_branches"]))
         for e in summary["shortlist"]], np.int32), device=dev),
        sys_.n_branch)
    verifier(status)
    sync(torch, dev)
    ts = []
    for _ in range(3):
        t0 = time.monotonic()
        verifier(status).v.cpu()
        ts.append((time.monotonic() - t0) * 1e3)
    ac_ms = float(np.median(ts))
    log(f"topo sweep (a): mesh118, {summary['variants_total']} rank<=2 "
        f"variants in {n_chunks} chunks of 4096: {summary['variants_per_sec']}"
        f" variants/s (wall {summary['wall_s']} s; the reference bench's "
        f"floor {TOPO_GATE_FLOOR}), disconnected {summary['disconnected']}, "
        f"islanded {summary['islanded']}; AC verify of the top 8: {ac_ms:.1f} "
        f"ms (median of 3), every lane converged, true mismatch <= "
        f"{worst_ac:.2e}, no bridge; T1 and T2 launched {counts} times")
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "topo.json")
        part = run(spec, checkpoint_path=ck, stop_after_chunks=3)
        check(part["completed"] is False and part["chunks_done"] == 3,
              f"topo sweep (a): the kill: {part}")
        resumed = run(spec, checkpoint_path=ck)
        check(resumed["resumed_from_chunk"] == 3
              and same_topo(resumed, summary),
              f"topo sweep (a): resumed {tp.strip_topo_timing(resumed)} vs "
              f"{tp.strip_topo_timing(summary)}")
    rechunked = run(dataclasses.replace(spec, chunk_variants=1024))
    check(same_topo(rechunked, summary, drop=("chunks_total",)),
          "topo sweep (a): chunks of 1024 differ from chunks of 4096")
    screen_only = dataclasses.replace(spec, ac_verify=False)
    mine = run(screen_only)
    plain = run(screen_only, plain=True)
    check([(e["open_branches"], e["gid"]) for e in mine["shortlist"]]
          == [(e["open_branches"], e["gid"]) for e in plain["shortlist"]]
          and same_topo(mine, plain, drop=("shortlist",)),
          f"topo sweep (a): the plain versions' shortlist differs: "
          f"{plain['shortlist']} vs {mine['shortlist']}")
    gap = max(abs(a["objective"] - b["objective"])
              for a, b in zip(mine["shortlist"], plain["shortlist"]))
    log(f"topo sweep (a): killed after 3 chunks and resumed, chunks of 1024: "
        f"equal; the plain versions' sweep: the same shortlist, objectives "
        f"within {gap:.1e}")

    spec_b = tp.TopoSweepSpec(case="mesh2000", max_rank=3,
                              search="neighborhood",
                              samples=TOPO_FULL_SAMPLES, seed=7,
                              chunk_variants=TOPO_FULL_CHUNK, top_k=8)
    t0 = time.monotonic()
    tp.sweep_variants(spec_b, case_system("mesh2000").n_branch)
    draw_s = time.monotonic() - t0
    chunk_s = []
    t0 = time.monotonic()
    big = run(spec_b,
              on_chunk=lambda done, total, s, real: chunk_s.append(s))
    total_s = time.monotonic() - t0
    check(big["completed"] and big["variants_total"] == TOPO_FULL_SAMPLES,
          f"topo sweep (b): {tp.strip_topo_timing(big)}")
    worst_b = check_shortlist("topo sweep (b)", big)
    k = timed["mesh2000"]
    t12 = (k["topo_radiality"]["device_ms"]
           + k["topo_screen_SCREEN"]["device_ms"])
    log(f"topo sweep (b): mesh2000 (4000 branches, Z^T 64 MB), "
        f"{TOPO_FULL_SAMPLES} neighborhood samples of rank <= 3 in "
        f"{big['chunks_total']} chunks of {TOPO_FULL_CHUNK}: "
        f"{big['variants_per_sec']} variants/s (wall {big['wall_s']} s; "
        f"{total_s:.2f} s with the builds, the draw and the AC verify); the "
        f"host draw {draw_s:.2f} s; chunk walls "
        + ", ".join(f"{s * 1e3:.1f}" for s in chunk_s)
        + f" ms, T1 + T2 on a chunk {t12:.3f} ms by queued events "
        f"({100 * t12 / (np.mean(chunk_s[1:] or chunk_s) * 1e3):.0f}% of a "
        f"later chunk's wall); the plain T1's sweeps "
        f"{k['topo_radiality']['plain_sweeps_max']} at most, mean "
        f"{k['topo_radiality']['plain_sweeps_mean']:.2f}; "
        f"disconnected {big['disconnected']}, islanded {big['islanded']}; "
        f"top {len(big['shortlist'])} verified, true mismatch <= "
        f"{worst_b:.2e} ({time.monotonic() - t_phase:.1f} s phase)")
    return counts


# ---------------------------------------------------------------------------
# Phase 20: the served topology workload and the sweep jobs
# ---------------------------------------------------------------------------


def serve_topo(torch, tk, tp, dev="cuda"):
    """The default server (cache on) with a ``JobManager``: ``POST
    /v1/topo`` on case14 at rank 2 and mesh118 (16 concurrent rank-1
    requests, after a ``/v1/pf`` request to mesh118: the engine adopts the
    cache entry's B′ LU, no second ``lu_factor``), the sync shortlist
    against ``run_topo_sweep``'s, a keyed mesh118 rank-2 sweep job
    cancelled mid-run and resubmitted, and an invalid spec.  Returns T1's
    and T2's launches on the sync path and the job path."""
    import tempfile

    from freedm_tpu_torch.pf.n1 import secure_outages
    from freedm_tpu_torch.scenarios.jobs import (JobManager,
                                                 parse_topo_job_request)
    from freedm_tpu_torch.serve.http import ServeServer
    from freedm_tpu_torch.serve.service import ServeConfig, Service

    t_phase = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        svc = Service(ServeConfig(device=dev))
        jm = JobManager(workers=1, checkpoint_dir=tmp, device=dev).start()
        server = ServeServer(svc, jobs=jm).start()
        port = server.port
        on_card = svc.device.type == "cuda"
        try:
            sweep14 = tp.run_topo_sweep(tp.TopoSweepSpec(
                case="case14", max_rank=2, top_k=4, ac_verify=False),
                device=dev)
            tk.reset_launches()
            status, r14 = post_json(port, "POST", "/v1/topo", {
                "case": "case14", "max_rank": 2, "timeout_s": 240})
            check(status == 200, f"POST /v1/topo case14: HTTP {status} {r14}")
            parts = (r14["n_feasible"] + r14["n_disconnected"]
                     + r14["n_nonradial"] + r14["n_islanded"])
            bridges = (set(range(20))
                       - set(secure_outages(case_system("case14"))))
            check(r14["n_variants"] == 210 and parts == 210
                  and r14["all_verified"] and len(r14["shortlist"]) == 4
                  and not any(set(e["open_branches"]) & bridges
                              for e in r14["shortlist"]),
                  f"POST /v1/topo case14: {r14}")
            check([e["open_branches"] for e in r14["shortlist"]]
                  == [e["open_branches"] for e in sweep14["shortlist"]],
                  "POST /v1/topo case14: the shortlist differs from "
                  "run_topo_sweep's")
            status, pf = post_json(port, "POST", "/v1/pf",
                                   {"case": "mesh118", "timeout_s": 240})
            check(status == 200 and pf["converged"],
                  f"POST /v1/pf mesh118: {status} {pf}")
            calls = []
            real = torch.linalg.lu_factor

            def counted(*a, **kw):
                calls.append(tuple(a[0].shape))
                return real(*a, **kw)

            torch.linalg.lu_factor = counted
            try:
                t0 = time.monotonic()
                status, r118 = post_json(port, "POST", "/v1/topo", {
                    "case": "mesh118", "max_rank": 1, "timeout_s": 240})
                build_s = time.monotonic() - t0
            finally:
                torch.linalg.lu_factor = real
            eng = svc.engine("topo", "mesh118")
            entry = svc.cache.entry("mesh118", eng._sys, "dense")
            check(status == 200 and r118["all_verified"],
                  f"POST /v1/topo mesh118: {status} {r118}")
            check(eng._lu is entry.precond.bp and (118, 118) not in calls,
                  f"the mesh118 topo engine factorized B' again: {calls}")

            def one(_):
                t0 = time.monotonic()
                st, body = post_json(port, "POST", "/v1/topo", {
                    "case": "mesh118", "max_rank": 1, "timeout_s": 240})
                return st, body, time.monotonic() - t0

            t0 = time.monotonic()
            with cf.ThreadPoolExecutor(16) as ex:
                out = list(ex.map(one, range(16)))
            wall = time.monotonic() - t0
            for st, body, _ in out:
                check(st == 200 and body["all_verified"]
                      and body["n_variants"] == 236
                      and body["shortlist"] == r118["shortlist"],
                      f"16 x POST /v1/topo mesh118: {st} {str(body)[:300]}")
            lat = np.array([x for _, _, x in out]) * 1e3
            sync_counts = tk.launches()
            check(all(c > 0 for c in sync_counts.values()) or not on_card,
                  f"POST /v1/topo: T1/T2 not launched: {sync_counts}")
            status, bad = post_json(port, "POST", "/v1/topo", {
                "case": "mesh118", "objective": "nope"})
            check(status == 400 and bad["error"]["type"] == "invalid_request",
                  f"an invalid topo spec: {status} {bad}")
            log(f"serve topo: case14 rank 2: 210 variants, counts partition, "
                f"top 4 verified and equal to run_topo_sweep's; mesh118 after "
                f"/v1/pf: the cache entry's B' LU adopted, no lu_factor "
                f"({build_s:.2f} s with the engine build); 16 concurrent "
                f"mesh118 rank-1 requests: p50 {np.percentile(lat, 50):.1f} "
                f"ms p99 {np.percentile(lat, 99):.1f} ms, "
                f"{16 / wall:.1f} requests/s; launches {sync_counts}; an "
                f"invalid spec 400")

            tk.reset_launches()
            payload = {"case": "mesh118", "max_rank": 2, "chunk_variants": 64,
                       "job_key": "sweep1"}
            status, d = post_json(port, "POST", "/v1/topo/sweep", payload)
            check(status == 202 and d["kind"] == "topo",
                  f"POST /v1/topo/sweep: {status} {d}")
            wait_job(port, d["job_id"], pred=lambda j: j["chunks_done"] >= 1)
            status, c = post_json(port, "POST",
                                  f"/v1/jobs/{d['job_id']}/cancel", {})
            check(status == 200, f"cancel: {status} {c}")
            j1 = wait_job(port, d["job_id"])
            ck = os.path.join(tmp, "topo_sweep1.json")
            check(j1["state"] == "cancelled" and j1["kind"] == "topo"
                  and os.path.exists(ck), f"sweep job after cancel: {j1}")
            _, d2 = post_json(port, "POST", "/v1/topo/sweep", payload)
            j2 = wait_job(port, d2["job_id"])
            job_counts = tk.launches()
            spec, _, _ = parse_topo_job_request(payload)
            direct = tp.run_topo_sweep(spec, device=dev)
            check(j2["state"] == "completed" and j2["kind"] == "topo"
                  and j2["resumed_from_chunk"] > 0
                  and same_topo(j2["summary"], direct),
                  f"sweep job resubmitted: {j2}")
            check(all(c > 0 for c in job_counts.values()) or not on_card,
                  f"the sweep job did not launch T1/T2: {job_counts}")
            status, bad = post_json(port, "POST", "/v1/topo/sweep",
                                    {"case": "mesh118", "max_rank": 9})
            check(status == 400, f"an invalid sweep job: {status} {bad}")
            log(f"serve topo: a keyed mesh118 rank-2 sweep job (437 chunks of "
                f"64) cancelled after chunk {j1['chunks_done']}, resubmitted: "
                f"resumed from chunk {j2['resumed_from_chunk']}, equal to a "
                f"direct run_topo_sweep; kind 'topo'; launches {job_counts}; "
                f"an invalid job 400 ({time.monotonic() - t_phase:.1f} s "
                f"phase)")
            return sync_counts, job_counts
        finally:
            server.stop()
            jm.stop()
            svc.stop()


# ---------------------------------------------------------------------------
# Phase 21: the solver kernels Y1, F1, J1 and I1 against their plain versions
# ---------------------------------------------------------------------------

SOLVER_CASES = ("case14", "case_ieee30", "mesh118", "mesh2000")
SOLVER_LANES = (1, 3)
#: The reference bench's N-1 batch (``bench.py:343`` ``bench_n1_118``):
#: mesh118, the first 118 branches out one per lane.
N1_118_LANES = 118
#: The CIM feeder of phases 21 and 23: ``synthetic_radial(1000, seed=0,
#: load_kw=1.0)`` with this many closed ties, under ``CIM_LANES`` load
#: scales.
CIM_TIES = 2
CIM_LANES = 64
#: I1's lane counts in phase 21: 64 fills one tile of the tiled product,
#: 67 adds a ragged one.
CIM_CHECK_LANES = (1, 8, CIM_LANES, 67)
#: F1's tile mode (one Ybus for every lane, K2's tiled product): the
#: reference bench's Monte-Carlo batch (``bench_mc_1024``) and the FDLF
#: N-1 width with a shared Ybus.
F1_TILE_SHAPES = (("mesh118", 1024), ("mesh2000", 16))


#: J1's and J2's lane widths whose bits are held equal, at the krylov lane
#: batch's case (phases 21 and 27).
RESIDUAL_WIDTHS = (1, 64, 256)
#: Past the staged route's float64 capacity (48 n bytes a lane of 232,448:
#: n <= 4842): J1 and J2 take the wide route there by default.
RESIDUAL_WIDE_CASE = "mesh5000"


def residual_plans(sol, n, m, lanes, dtype, status):
    """J1's and J2's plans at a shape: the default, the wide route, and the
    staged route at every lanes-a-CTA that fits with one, two and every
    slice's CTA a lane group."""
    plans = [sol.residual_plan(n, m, lanes, dtype, status),
             sol.residual_plan(n, m, lanes, dtype, status, route=sol.WIDE)]
    per = sol.residual_stage_bytes(n, m, dtype, status)
    slices = -(-n // sol.RES_SLICE)
    for lpc in range(1, min(sol.RES_MAX_LANES, sol.RES_SMEM // per) + 1):
        for cpl in sorted({1, min(2, slices), slices}):
            plan = sol.residual_plan(n, m, lanes, dtype, status, lpc, cpl)
            if plan not in plans:
                plans.append(plan)
    return plans


def compare_residual_routes(torch, sol, vjp):
    """J1 (or J2 in both modes, ``vjp``) at the krylov lane batch's case
    (``synthetic_mesh_bench(2000, 1.0)``), float64 and float32, with and
    without a per-lane status: lane 0 gives the same bits at widths
    ``RESIDUAL_WIDTHS`` under every plan of :func:`residual_plans` (the
    wide route included), each call within ``KERNEL_ATOL``
    (``KERNEL_ATOL_F32``) of the plain version's largest entry above 1;
    then ``RESIDUAL_WIDE_CASE`` × 2 in both dtypes and under every plan
    the same way, where float64's default plan is the wide route (past the
    staging capacity); each default plan's route is launched.  Returns
    the largest float64 and float32 gaps by dtype."""
    from freedm_tpu_torch.pf.sparse import sparse_operands

    dev = torch.device("cuda")
    t0 = time.monotonic()
    name = "residual_vjp" if vjp else "residual_jvp"
    worst = {torch.float64: 0.0, torch.float32: 0.0}
    calls = 0
    for case, widths in ((None, RESIDUAL_WIDTHS),
                         (RESIDUAL_WIDE_CASE, (2,))):
        sys_ = (synthetic_mesh_bench(2000, 1.0) if case is None
                else case_system(case))
        n, m = sys_.n_bus, sys_.n_branch
        rng = np.random.default_rng(22 + vjp)
        full = max(widths)
        x64 = torch.cat([torch.as_tensor(rng.normal(0, 0.1, (full, n))),
                         torch.as_tensor(rng.uniform(0.95, 1.05, (full, n)))],
                        1).to(dev)
        u64 = torch.as_tensor(rng.normal(size=(full, 2 * n)), device=dev)
        st64 = torch.as_tensor(
            (rng.random((full, m)) > 0.05).astype(np.float64), device=dev)
        for dtype in (torch.float64, torch.float32):
            atol = KERNEL_ATOL if dtype == torch.float64 else KERNEL_ATOL_F32
            op = sparse_operands(sys_, dtype=dtype, device=dev)
            vop = sol.vjp_operands(op)
            modes = (sol.MASKED, sol.FULL) if vjp else (None,)
            for mode, status in [(md, s_) for md in modes
                                 for s_ in (False, True)]:
                def call(width, plan=None, fn=None):
                    x = x64[:width].to(dtype)
                    u = u64[:width].to(dtype)
                    st = st64[:width].to(dtype) if status else None
                    if vjp:
                        return (fn or sol.residual_vjp)(
                            x, u, op, vop, mode, st,
                            **({} if plan is None else {"plan": plan}))
                    return (fn or sol.residual_jvp)(
                        x, u, op, st, **({} if plan is None else
                                         {"plan": plan}))
                tag = (f"{name} {case or 'mesh2000 (bench)'} "
                       f"{str(dtype)[6:]} mode {mode} status {status}")
                want = call(full, fn=(sol.residual_vjp_plain if vjp
                                      else sol.residual_jvp_plain))
                scale = max(1.0, float(want.abs().max()))
                ref = None
                for width in widths:
                    default = sol.residual_plan(n, m, width, dtype, status)
                    if case is not None and dtype == torch.float64:
                        check(default.route == sol.WIDE,
                              f"{tag}: the default plan is {default}, not "
                              f"the wide route past the capacity")
                    sol.reset_launches()
                    got = call(width)
                    torch.cuda.synchronize()
                    check(sol.route_launches()[name][default.route] == 1,
                          f"{tag} x{width}: the default plan's route "
                          f"{default.route} was not launched")
                    for plan in residual_plans(sol, n, m, width, dtype,
                                               status):
                        k = call(width, plan)
                        again = call(width, plan)
                        e = max_err(k, want[:width]) / scale
                        check(e <= atol, f"{tag} x{width} {plan}: {e:.3e} "
                              f"from the plain version")
                        check(same_bits(torch, k, again),
                              f"{tag} x{width} {plan}: not bit-identical "
                              f"on repeat")
                        check(same_bits(torch, k, got),
                              f"{tag} x{width} {plan}: not the default "
                              f"plan's bits")
                        worst[dtype] = max(worst[dtype], e)
                        calls += 2
                    if ref is None:
                        ref = got[:1]
                    check(same_bits(torch, got[:1], ref),
                          f"{tag}: lane 0's bits differ at width {width}")
        del x64, u64, st64
    log(f"residual routes: {name} lane 0 the same bits at widths "
        f"{list(RESIDUAL_WIDTHS)} under every plan (wide route included; "
        f"{calls} launches), and {RESIDUAL_WIDE_CASE} x2 on the wide route "
        f"by default in float64; f64 {worst[torch.float64]:.2e}, f32 "
        f"{worst[torch.float32]:.2e} of the plain version's largest entry "
        f"({time.monotonic() - t0:.1f} s)")
    return worst


def exact_or_close(torch, a, b):
    """Largest |a − b| counting equal entries (infinities too) as 0."""
    if a.dtype == torch.bool or not a.is_floating_point():
        return 0.0 if torch.equal(a, b) else float("inf")
    d = torch.where(a == b, torch.zeros_like(a), (a - b).abs())
    return float(d.max()) if d.numel() else 0.0


def solver_status(sys_, lanes, seed):
    """``[lanes, m]`` 0/1 status: lane 0 all in service, the others with
    ~10% of their branches out (seeded)."""
    rng = np.random.default_rng(seed)
    st = (rng.random((lanes, sys_.n_branch)) > 0.1).astype(np.float64)
    st[0] = 1.0
    return st


def n1_118_status(sys_):
    st = np.ones((N1_118_LANES, sys_.n_branch))
    st[np.arange(N1_118_LANES), np.arange(N1_118_LANES)] = 0.0
    return st


def cim_feeder():
    """``synthetic_radial(1000, seed=0, load_kw=1.0)`` and ``CIM_TIES``
    ties, each of branch 0's per-unit impedance, from the deepest nodes
    to nodes halfway down the node list (every node is three-phase)."""
    from freedm_tpu_torch.grid.cases import synthetic_radial

    f = synthetic_radial(1000, seed=0, load_kw=1.0)
    deep = np.argsort(-np.asarray(f.depth), kind="stable") + 1
    mid = f.n_nodes // 2
    ties = [(int(deep[k]), mid + 7 * k, f.z_pu[0]) for k in range(CIM_TIES)]
    check(all(a != b for a, b, _ in ties), f"cim: degenerate ties {ties}")
    return f, ties


def cim_loads(f, lanes, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.7, 1.3, (lanes, 1, 1)) * f.s_load[None]


def compare_solver_kernels(torch, sol, nk, errs):
    """Y1 (three modes), F1 (three modes; shared and per-lane Ybus), J1
    (with and without status) and K1/K2 on per-lane Ybus against their
    plain versions at ``SOLVER_CASES`` × ``SOLVER_LANES`` (and mesh118 ×
    118, the reference bench's N-1 batch) in float64 and float32, then I1
    on vvc_9bus and the CIM feeder; each kernel bit-identical on repeat."""
    from freedm_tpu_torch.grid.bus import stamp_operands, ybus_lanes
    from freedm_tpu_torch.pf.cim import make_cim_solver
    from freedm_tpu_torch.pf.sparse import sparse_operands

    dev = torch.device("cuda")
    t0 = time.monotonic()
    worst = {}

    def hold(name, tag, got, want, again, atol, f64):
        e = max(exact_or_close(torch, a, b) for a, b in zip(got, want))
        same = all(torch.equal(a, b) or (a.is_floating_point()
                                        and same_bits(torch, a, b))
                   for a, b in zip(got, again))
        check(e <= atol, f"{name} {tag}: {e:.3e} from its plain version")
        check(same, f"{name} {tag}: not bit-identical on repeat")
        key = (name, f64)
        worst[key] = max(worst.get(key, 0.0), e)

    for cname in SOLVER_CASES:
        sys_ = case_system(cname)
        n = sys_.n_bus
        lane_set = SOLVER_LANES + ((N1_118_LANES,) if cname == "mesh118"
                                   else ())
        for dtype in (torch.float64, torch.float32):
            f64 = dtype == torch.float64
            atol = KERNEL_ATOL if f64 else KERNEL_ATOL_F32
            op = stamp_operands(sys_, dtype=dtype, device=dev)
            sop = sparse_operands(sys_, dtype=dtype, device=dev)
            rng = np.random.default_rng(21)
            for lanes in lane_set:
                tag = f"{cname} x{lanes} {str(dtype)[6:]}"
                st = torch.as_tensor(
                    n1_118_status(sys_) if lanes == N1_118_LANES
                    else solver_status(sys_, lanes, 21), dtype=dtype,
                    device=dev)
                for mode in (sol.YBUS, sol.BPRIME, sol.BDBL):
                    run = [fn(mode, op, st) for fn in
                           (sol.ybus_stamp, sol.ybus_stamp_plain,
                            sol.ybus_stamp)]
                    run = [r if isinstance(r, tuple) else (r,) for r in run]
                    hold("ybus_stamp", f"{tag} mode {mode}", *run, atol, f64)
                y = ybus_lanes(sys_, st, dtype=dtype, device=dev, op=op)
                x = torch.cat([
                    torch.as_tensor(rng.normal(0, 0.1, (lanes, n)),
                                    dtype=dtype, device=dev),
                    torch.as_tensor(rng.uniform(0.95, 1.05, (lanes, n)),
                                    dtype=dtype, device=dev)], 1)
                ps = torch.as_tensor(rng.normal(size=(lanes, n)),
                                     dtype=dtype, device=dev)
                qs = 0.3 * ps
                thf, vf, vs = sop.th_free, sop.v_free, sop.v_set
                k12 = [(nk.newton_assemble, nk.power_injections),
                       (nk.newton_assemble_plain, nk.power_injections_plain),
                       (nk.newton_assemble, nk.power_injections)]
                if n <= 118:
                    hold("newton_assemble", f"{tag} per-lane Ybus",
                         *[k1(x, y[0], y[1], ps, qs, thf, vf, vs)
                           for k1, _ in k12], atol, f64)
                hold("power_injections", f"{tag} per-lane Ybus",
                     *[k2(x, y[0], y[1], ps, qs, thf, vf, vs)
                       for _, k2 in k12], atol, f64)
                d_th = torch.as_tensor(rng.normal(0, 1e-3, (n, lanes)),
                                       dtype=dtype, device=dev).T
                d_v = torch.as_tensor(rng.normal(0, 1e-3, (lanes, n)),
                                      dtype=dtype, device=dev)
                active = torch.as_tensor(np.arange(lanes) % 3 != 1,
                                         device=dev)
                for yy, form in (((y[0][0].contiguous(),
                                   y[1][0].contiguous()), "shared"),
                                 (y, "per-lane")):
                    outs = []
                    for fn in (sol.fdlf_half_step, sol.fdlf_half_step_plain,
                               sol.fdlf_half_step):
                        xx = x.clone()
                        dp = torch.zeros(lanes, n, dtype=dtype, device=dev)
                        dq = torch.zeros_like(dp)
                        err = torch.full((lanes,), float("inf"), dtype=dtype,
                                         device=dev)
                        it = torch.zeros(lanes, dtype=torch.int32,
                                         device=dev)
                        act = active.clone()
                        tol = torch.full((1,), 1e-8, dtype=dtype, device=dev)
                        for mode, d in ((sol.INIT, None), (sol.THETA, d_th),
                                        (sol.VHALF, d_v)):
                            fn(mode, xx, d, yy[0], yy[1], ps, qs, thf, vf, dp,
                               dq, err, it, act, tol, 10, False)
                        outs.append((xx, dp, dq, err, it, act))
                    hold("fdlf_half_step", f"{tag} {form} Ybus", *outs, atol,
                         f64)
                u = torch.as_tensor(rng.normal(size=(lanes, 2 * n)),
                                    dtype=dtype, device=dev)
                for s_ in (None, st):
                    run = [(fn(x, u, sop, s_),) for fn in
                           (sol.residual_jvp, sol.residual_jvp_plain,
                            sol.residual_jvp)]
                    scale = max(1.0, float(run[1][0].abs().max()))
                    hold("residual_jvp", f"{tag} status {s_ is not None}",
                         *run, atol * scale, f64)
    from freedm_tpu_torch.grid.cases import vvc_9bus

    for f, ties, label in ((vvc_9bus(), (), "vvc_9bus"),
                           (*cim_feeder(), "radial1000+ties")):
        for dtype in (torch.float64, torch.float32):
            f64 = dtype == torch.float64
            atol = KERNEL_ATOL if f64 else KERNEL_ATOL_F32
            for lanes in CIM_CHECK_LANES:
                s = cim_loads(f, lanes, seed=lanes)
                outs = []
                for plain in (False, True, False):
                    solve, fixed = make_cim_solver(f, ties=ties, dtype=dtype,
                                                   device=dev, plain=plain,
                                                   max_iter=40)
                    r = solve(s)
                    r3 = fixed(s) if lanes == 1 else r
                    outs.append((r.v_node.re, r.v_node.im, r.iterations,
                                 r.converged, r3.v_node.re))
                hold("cim_iterate", f"{label} x{lanes} {str(dtype)[6:]}",
                     *outs, atol, f64)
    for (name, f64), e in worst.items():
        if name in errs and f64:
            errs[name] = max(errs[name], e)
    log("solver kernels: " + ", ".join(
        f"{name} {'f64' if f64 else 'f32'} {e:.2e}"
        for (name, f64), e in sorted(worst.items()))
        + f" (max abs from the plain versions; J1 relative to max |J u| "
          f"above 1); each bit-identical on repeat "
          f"({time.monotonic() - t0:.1f} s)")
    return {f"{name}{'' if f64 else '_f32'}": e
            for (name, f64), e in worst.items()}


def f1_run(torch, fn, sol, x, d_th, d_v, y, ps, qs, thf, vf, active):
    """F1's three modes in turn (INIT, THETA, V) through ``fn`` from a copy
    of ``x``; returns the state, mismatch and lane carry."""
    lanes, n = ps.shape
    xx = x.clone()
    dp, dq = torch.zeros_like(ps), torch.zeros_like(ps)
    err = torch.full((lanes,), float("inf"), dtype=x.dtype, device=x.device)
    it = torch.zeros(lanes, dtype=torch.int32, device=x.device)
    act = active.clone()
    tol = torch.full((1,), 1e-8, dtype=x.dtype, device=x.device)
    for mode, d in ((sol.INIT, None), (sol.THETA, d_th), (sol.VHALF, d_v)):
        fn(mode, xx, d, y[0], y[1], ps, qs, thf, vf, dp, dq, err, it, act,
           tol, 10, False)
    return xx, dp, dq, err, it, act


def compare_fdlf_tiles(torch, sol, nk):
    """F1's tile mode at ``F1_TILE_SHAPES`` (one Ybus of every lane) against
    its plain version in its three modes, float64 and float32, bit-identical
    on repeat; and its product K2's bits: at |V| = 1 with zero schedules
    and every quantity free, F1's INIT mismatch is exactly -(P, Q), so it
    must equal K2's -P, -Q bit for bit on the same state.  Returns the
    largest gaps by dtype."""
    from freedm_tpu_torch.grid.bus import ybus_dense
    from freedm_tpu_torch.pf.sparse import sparse_operands

    dev = torch.device("cuda")
    worst = {torch.float64: 0.0, torch.float32: 0.0}
    for cname, lanes in F1_TILE_SHAPES:
        sys_ = case_system(cname)
        n = sys_.n_bus
        check(lanes >= sol.TILED_MIN_LANES, "F1 tile shapes take the tile")
        rng = np.random.default_rng(lanes)
        for dtype in (torch.float64, torch.float32):
            f64 = dtype == torch.float64
            y = ybus_dense(sys_, dtype=dtype, device=dev)
            sop = sparse_operands(sys_, dtype=dtype, device=dev)

            def t(a):
                return torch.as_tensor(a, dtype=dtype, device=dev)

            x = torch.cat([t(rng.normal(0, 0.1, (lanes, n))),
                           t(rng.uniform(0.95, 1.05, (lanes, n)))], 1)
            ps = t(rng.normal(size=(lanes, n)))
            d_th = t(rng.normal(0, 1e-3, (n, lanes))).T
            d_v = t(rng.normal(0, 1e-3, (lanes, n)))
            active = torch.as_tensor(np.arange(lanes) % 3 != 1, device=dev)
            outs = [f1_run(torch, fn, sol, x, d_th, d_v, y, ps, 0.3 * ps,
                           sop.th_free, sop.v_free, active)
                    for fn in (sol.fdlf_half_step, sol.fdlf_half_step_plain,
                               sol.fdlf_half_step)]
            e = max(exact_or_close(torch, a, b)
                    for a, b in zip(outs[0], outs[1]))
            tag = f"F1 tile {cname} x{lanes} {str(dtype)[6:]}"
            check(e <= (KERNEL_ATOL if f64 else KERNEL_ATOL_F32),
                  f"{tag}: {e:.3e} from its plain version")
            check(all(torch.equal(a, b) or same_bits(torch, a, b)
                      for a, b in zip(outs[0], outs[2])),
                  f"{tag}: not bit-identical on repeat")
            worst[dtype] = max(worst[dtype], e)
            one = torch.ones(n, dtype=dtype, device=dev)
            zero = torch.zeros(lanes, n, dtype=dtype, device=dev)
            x1 = torch.cat([t(rng.uniform(-0.3, 0.3, (lanes, n))),
                            torch.ones(lanes, n, dtype=dtype, device=dev)], 1)
            p, q, _ = nk.power_injections(x1, y[0], y[1], zero, zero, one,
                                          one, one)
            dp, dq = torch.zeros_like(zero), torch.zeros_like(zero)
            sol.fdlf_half_step(
                sol.INIT, x1, None, y[0], y[1], zero, zero, one, one, dp, dq,
                torch.zeros(lanes, dtype=dtype, device=dev),
                torch.zeros(lanes, dtype=torch.int32, device=dev),
                torch.ones(lanes, dtype=torch.bool, device=dev),
                torch.zeros(1, dtype=dtype, device=dev), 10, False)
            torch.cuda.synchronize()
            check(same_bits(torch, dp, -p) and same_bits(torch, dq, -q),
                  f"{tag}: F1's tiled product is not K2's bits")
            log(f"solver kernels: {tag} (K slices "
                f"{nk.product_splits(n, lanes)}): {e:.2e} from the plain "
                f"version, bit-identical on repeat, its product K2's bits")
    return worst


def time_solver_kernels(torch, sol, nk, rows, extra):
    """Y1, F1, J1 and I1 at the shapes of phase 22's paths, each by CUDA
    events over back-to-back calls and by device time (the profiler, or
    events around each call where its trace has no device events), beside
    the plain version, the bound and the library row; K1/K2 on the
    per-lane Ybus of the mesh118 N-1 batch."""
    from freedm_tpu_torch.grid.bus import stamp_operands, ybus_lanes
    from freedm_tpu_torch.pf.cim import make_cim_solver
    from freedm_tpu_torch.pf.sparse import sparse_operands

    dev = torch.device("cuda")
    f64 = torch.float64
    t0 = time.monotonic()

    def timed(name, fn, plain, reps, preps=3):
        k = time_ms(torch, fn, reps=reps)
        k_dev, src = ladder_device_ms(torch, fn, max(reps // 2, 5), name)
        p = time_ms(torch, plain, reps=preps)
        return k, k_dev, src, p

    # Y1 YBUS at the reference bench's N-1 batch: writes B n² (re, im).
    sys118 = case_system("mesh118")
    n, m = sys118.n_bus, sys118.n_branch
    op = stamp_operands(sys118, dtype=f64, device=dev)
    st = torch.as_tensor(n1_118_status(sys118), dtype=f64, device=dev)
    lanes = st.shape[0]
    k, k_dev, src, p = timed(
        "ybus_stamp", lambda: sol.ybus_stamp(sol.YBUS, op, st),
        lambda: sol.ybus_stamp_plain(sol.YBUS, op, st), 50)
    b_y1 = 8 * (2 * lanes * n * n + lanes * m + 9 * m) + 4 * (n + 1 + 4 * m)
    # The library row: one sparse COO (duplicates summed) to dense, complex.
    lane = torch.arange(lanes, device=dev)[:, None]
    f_, t_ = op.f[None].expand(lanes, m), op.t[None].expand(lanes, m)
    yb = [torch.complex(op.br[2 * r], op.br[2 * r + 1]) * st
          for r in range(4)]
    ar = torch.arange(n, device=dev)[None].expand(lanes, n)
    idx = torch.stack([torch.cat([lane.expand(lanes, 4 * m),
                                  lane.expand(lanes, n)], 1).reshape(-1),
                       torch.cat([f_, t_, f_, t_, ar], 1).reshape(-1),
                       torch.cat([f_, t_, t_, f_, ar], 1).reshape(-1)])
    sh = torch.complex(op.g_sh, op.b_sh)[None].expand(lanes, n)
    vals = torch.cat([yb[0], yb[3], yb[1], yb[2], sh], 1).reshape(-1)

    def library_y1():
        return torch.sparse_coo_tensor(idx, vals, (lanes, n, n)).to_dense()

    want = library_y1()
    got = sol.ybus_stamp(sol.YBUS, op, st)
    check(float((want.real - got[0]).abs().max()) <= KERNEL_ATOL
          and float((want.imag - got[1]).abs().max()) <= KERNEL_ATOL,
          "Y1's library row computes another Ybus")
    lib = time_ms(torch, library_y1, reps=20)
    b, by = bound(b_y1, 0)
    rows["ybus_stamp"] = (k, p, lib, b, by)
    extra["ybus_stamp"] = {"device_ms": k_dev, "device_ms_source": src,
                           "shape": "mesh118 x 118 (bench_n1_118), YBUS",
                           "library": "torch.sparse_coo_tensor(idx, vals, "
                                      "(B, n, n)).to_dense(), complex128"}
    log(f"timing: ybus_stamp YBUS mesh118 x118 kernel {k:.4f} ms (device "
        f"{k_dev:.4f}, {src})  plain {p:.4f} ms  bound {b:.4f} ms ({by})  "
        f"library sparse COO to dense {lib:.4f} ms")
    for mode, key in ((sol.BPRIME, "bprime"), (sol.BDBL, "bdbl")):
        km, km_dev, src, pm = timed(
            "ybus_stamp", lambda: sol.ybus_stamp(mode, op, st),
            lambda: sol.ybus_stamp_plain(mode, op, st), 50)
        bm, _ = bound(b_y1 - 8 * lanes * n * n, 0)
        extra["ybus_stamp"].update({f"ms_{key}": km,
                                    f"device_ms_{key}": km_dev,
                                    f"plain_ms_{key}": pm,
                                    f"bound_ms_{key}": bm})
        log(f"timing: ybus_stamp {key.upper()} mesh118 x118 kernel {km:.4f} "
            f"ms (device {km_dev:.4f})  plain {pm:.4f} ms  bound {bm:.4f} ms")
    # K1/K2 on that per-lane Ybus (the dense N-1 path).
    y = ybus_lanes(sys118, st, dtype=f64, device=dev, op=op)
    rng = np.random.default_rng(22)
    x = torch.cat([torch.zeros(lanes, n, dtype=f64, device=dev),
                   torch.ones(lanes, n, dtype=f64, device=dev)], 1)
    x[:, :n] += torch.as_tensor(rng.normal(0, 0.05, (lanes, n)), device=dev)
    sop = sparse_operands(sys118, dtype=f64, device=dev)
    ps = torch.as_tensor(np.tile(sys118.p_inj, (lanes, 1)), device=dev)
    qs = torch.as_tensor(np.tile(sys118.q_inj, (lanes, 1)), device=dev)
    args = (x, y[0], y[1], ps, qs, sop.th_free, sop.v_free, sop.v_set)
    for name, fn, pfn in (("newton_assemble", nk.newton_assemble,
                           nk.newton_assemble_plain),
                          ("power_injections", nk.power_injections,
                           nk.power_injections_plain)):
        kk, kk_dev, src, pp = timed(name, lambda: fn(*args),
                                    lambda: pfn(*args), 50)
        extra.setdefault(name, {}).update({
            "ms_lanes_ybus_n1_118": kk, "device_ms_lanes_ybus_n1_118": kk_dev,
            "plain_ms_lanes_ybus_n1_118": pp})
        log(f"timing: {name} per-lane Ybus mesh118 x118 kernel {kk:.4f} ms "
            f"(device {kk_dev:.4f}, {src})  plain {pp:.4f} ms")

    # F1 at bench_nr_2000 (mesh2000 x 1, one Ybus), V mode: reads Ybus once.
    sys2k = synthetic_mesh_bench(2000, 1.0)
    n2 = sys2k.n_bus
    from freedm_tpu_torch.grid.bus import ybus_dense

    y2 = ybus_dense(sys2k, dtype=f64, device=dev)
    sop2 = sparse_operands(sys2k, dtype=f64, device=dev)

    def f1_inputs(lanes_, yy):
        x_ = torch.cat([torch.zeros(lanes_, n2, dtype=f64, device=dev),
                        torch.ones(lanes_, n2, dtype=f64, device=dev)], 1)
        ps_ = torch.as_tensor(np.tile(sys2k.p_inj, (lanes_, 1)), device=dev)
        qs_ = torch.as_tensor(np.tile(sys2k.q_inj, (lanes_, 1)), device=dev)
        carry = (sop2.th_free, sop2.v_free,
                 torch.zeros(lanes_, n2, dtype=f64, device=dev),
                 torch.zeros(lanes_, n2, dtype=f64, device=dev),
                 torch.zeros(lanes_, dtype=f64, device=dev),
                 torch.zeros(lanes_, dtype=torch.int32, device=dev),
                 torch.ones(lanes_, dtype=torch.bool, device=dev),
                 torch.zeros(1, dtype=f64, device=dev), 1 << 30, True)
        d_ = torch.zeros(lanes_, n2, dtype=f64, device=dev)
        return (sol.VHALF, x_, d_, yy[0], yy[1], ps_, qs_, *carry)

    # The warp form is one launch a half-step: its device time and the
    # library row's are queued CUDA events (one clock for both).
    a1 = f1_inputs(1, y2)
    k = time_ms(torch, lambda: sol.fdlf_half_step(*a1), reps=50)
    k_dev, src = queued_events_ms(torch, lambda: sol.fdlf_half_step(*a1),
                                  50), "queued events"
    p = time_ms(torch, lambda: sol.fdlf_half_step_plain(*a1), reps=3)
    b_f1 = 8 * (2 * n2 * n2 + 8 * n2 + 3) + 4
    yc = torch.complex(y2[0], y2[1])
    vc = torch.polar(a1[1][:, n2:].T.contiguous(),
                     a1[1][:, :n2].T.contiguous())
    lib_b2b = time_ms(torch, lambda: torch.matmul(yc, vc), reps=50)
    lib = queued_events_ms(torch, lambda: torch.matmul(yc, vc), 50)
    b, by = bound(b_f1, 8 * n2 * n2)
    from torch.profiler import ProfilerActivity, profile

    sol.fdlf_half_step(*a1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sol.fdlf_half_step(*a1)
        torch.cuda.synchronize()
    per_call = sum(e.count for e in device_kernels(prof))
    check(per_call in (0, 1), f"F1's warp form ran {per_call} kernels in one "
          f"call (one launch a half-step)")
    rows["fdlf_half_step"] = (k, p, lib, b, by)
    extra["fdlf_half_step"] = {
        "device_ms": k_dev, "device_ms_source": src,
        "library_ms_source": "queued events",
        "library_ms_back_to_back": lib_b2b,
        "kernels_a_call": per_call if per_call else "not recorded",
        "plan": sol.fdlf_warp_plan(n2, 1, f64)._asdict(),
        "shape": "mesh2000 x 1 (bench_nr_2000), one Ybus, V mode",
        "library": "complex128 torch.matmul of Ybus with V alone"}
    log(f"timing: fdlf_half_step V mesh2000 x1 (warp form, "
        f"{per_call or 'unrecorded'} kernel a call) kernel {k:.4f} ms "
        f"(device {k_dev:.4f}, {src})  plain {p:.4f} ms  bound {b:.4f} ms "
        f"({by})  library complex matmul {lib:.4f} ms by queued events "
        f"({lib_b2b:.4f} back to back); {k_dev / lib:.2f}x its time")
    del yc, vc
    # ... at bench_mc_1024's shape (mesh118 x 1024, one Ybus) and the FDLF
    # N-1 shape (mesh2000 x 16, per-lane Ybus).
    y118 = ybus_dense(sys118, dtype=f64, device=dev)
    x118 = torch.cat([torch.zeros(1024, n, dtype=f64, device=dev),
                      torch.ones(1024, n, dtype=f64, device=dev)], 1)
    car = (sop.th_free, sop.v_free,
           torch.zeros(1024, n, dtype=f64, device=dev),
           torch.zeros(1024, n, dtype=f64, device=dev),
           torch.zeros(1024, dtype=f64, device=dev),
           torch.zeros(1024, dtype=torch.int32, device=dev),
           torch.ones(1024, dtype=torch.bool, device=dev),
           torch.zeros(1, dtype=f64, device=dev), 1 << 30, True)
    ps1k = torch.as_tensor(np.tile(sys118.p_inj, (1024, 1)), device=dev)
    a2 = (sol.VHALF, x118, torch.zeros(1024, n, dtype=f64, device=dev),
          y118[0], y118[1], ps1k, ps1k, *car)
    k2, k2_dev, src, p2 = timed("fdlf_half_step",
                                lambda: sol.fdlf_half_step(*a2),
                                lambda: sol.fdlf_half_step_plain(*a2), 50)
    k2_prof = k2_dev
    k2_dev = queued_events_ms(torch, lambda: sol.fdlf_half_step(*a2), 50)
    # Tile mode runs the dense product on the FP64 tensor cores.
    b2, by2 = bound(8 * (2 * n * n + 1024 * 8 * n), 8 * 1024 * n * n,
                    tensor=True)
    # F1's tile mode there: the library row is the complex product alone.
    yc = torch.complex(y118[0], y118[1])
    vc = torch.polar(x118[:, n:].T.contiguous(), x118[:, :n].T.contiguous())
    lib2 = time_ms(torch, lambda: torch.matmul(yc, vc), reps=50)
    del yc, vc
    a2_32 = tuple(a.float() if torch.is_tensor(a) and a.is_floating_point()
                  else a for a in a2)
    k2_32 = time_ms(torch, lambda: sol.fdlf_half_step(*a2_32), reps=50)
    k2_32_dev = queued_events_ms(torch,
                                 lambda: sol.fdlf_half_step(*a2_32), 50)
    p2_32 = time_ms(torch, lambda: sol.fdlf_half_step_plain(*a2_32), reps=3)
    del a2_32
    opn = stamp_operands(sys2k, dtype=f64, device=dev)
    st16 = torch.ones(16, sys2k.n_branch, dtype=f64, device=dev)
    st16[torch.arange(16), n2 + torch.arange(16)] = 0.0
    y16 = sol.ybus_stamp(sol.YBUS, opn, st16)
    a3 = f1_inputs(16, y16)
    k3 = time_ms(torch, lambda: sol.fdlf_half_step(*a3), reps=20)
    k3_dev = queued_events_ms(torch, lambda: sol.fdlf_half_step(*a3), 20)
    p3 = time_ms(torch, lambda: sol.fdlf_half_step_plain(*a3), reps=3)
    b3, _ = bound(8 * (2 * 16 * n2 * n2 + 16 * 8 * n2), 8 * 16 * n2 * n2)
    extra["fdlf_half_step"].update({
        "ms_mesh118_x1024": k2, "device_ms_mesh118_x1024": k2_dev,
        "device_ms_profiler_mesh118_x1024": k2_prof,
        "plain_ms_mesh118_x1024": p2, "bound_ms_mesh118_x1024": b2,
        "bound_by_mesh118_x1024": by2,
        "library_ms_mesh118_x1024": lib2,
        "k_splits_mesh118_x1024": nk.product_splits(n, 1024),
        "ms_f32_mesh118_x1024": k2_32,
        "device_ms_f32_mesh118_x1024": k2_32_dev,
        "plain_ms_f32_mesh118_x1024": p2_32,
        "ms_mesh2000_x16_lanes_ybus": k3,
        "device_ms_mesh2000_x16_lanes_ybus": k3_dev,
        "plain_ms_mesh2000_x16_lanes_ybus": p3,
        "bound_ms_mesh2000_x16_lanes_ybus": b3})
    log(f"timing: fdlf_half_step V mesh118 x1024 (tile mode) kernel {k2:.4f} "
        f"ms (device {k2_dev:.4f} by queued events, profiler "
        f"{k2_prof:.4f})  plain "
        f"{p2:.4f}  bound {b2:.4f} ({by2})  library complex matmul "
        f"{lib2:.4f}; "
        f"float32 {k2_32:.4f} ms (device {k2_32_dev:.4f})  plain "
        f"{p2_32:.4f}; mesh2000 x16 per-lane Ybus {k3:.4f} ms (device "
        f"{k3_dev:.4f} by queued events)  plain {p3:.4f}  bound {b3:.4f}")
    del y16, a3

    # J1 at bench_nr_2k_krylov_lanes (mesh2000 x 256): x, u in, J u out.
    # Its device time is queued CUDA events around each call, as J2's: the
    # profiler's came back at 0.0593 and 0.0402 ms for one kernel.
    from freedm_tpu_torch.kernels import sparse_kernels as sk

    lanes = 256
    xk = torch.cat([torch.as_tensor(rng.normal(0, 0.1, (lanes, n2)),
                                    device=dev),
                    torch.as_tensor(rng.uniform(0.95, 1.05, (lanes, n2)),
                                    device=dev)], 1)
    u = torch.randn_like(xk)
    ps2 = torch.as_tensor(np.tile(sys2k.p_inj, (lanes, 1)), device=dev)
    m2 = sys2k.n_branch

    def j1_bytes(b_lanes, itemsize=8, status=False):
        # x, u and J u, the incidence operands and bus arrays once
        return (itemsize * (3 * b_lanes * 2 * n2 + 4 * 2 * m2 + 4 * n2
                            + (b_lanes * m2 if status else 0))
                + 4 * (n2 + 1 + 4 * m2))

    def j1(x, uu, op, st=None):
        fn = (lambda: sol.residual_jvp(x, uu, op, st))
        return (time_ms(torch, fn, reps=100), queued_events_ms(torch, fn, 50),
                sol.residual_plan(n2, m2, x.shape[0], x.dtype,
                                  st is not None))

    o_j1 = lanes * (2 * m2 * 60 + n2 * 20)
    k, k_dev, plan = j1(xk, u, sop2)
    p = time_ms(torch, lambda: sol.residual_jvp_plain(xk, u, sop2), reps=3)
    ev, bv, _ = sk.sparse_assemble(xk, ps2, ps2, sop2)
    csr = sparse_library_matvec(torch, sop2, ev, bv)
    ucol = u.reshape(-1, 1)
    e_lib = rel_abs_err(torch, (csr @ ucol).reshape(lanes, 2 * n2),
                        sol.residual_jvp(xk, u, sop2))[0]
    check(e_lib <= 1e-10, f"J1's library row computes another J u: {e_lib}")
    lib = time_ms(torch, lambda: csr @ ucol, reps=100)
    lib_dev = queued_events_ms(torch, lambda: csr @ ucol, 50)
    b, by = bound(j1_bytes(lanes), o_j1)
    rows["residual_jvp"] = (k, p, lib, b, by)
    extra["residual_jvp"] = {
        "device_ms": k_dev, "device_ms_source": "queued events",
        "plan": plan._asdict(), "library_device_ms": lib_dev,
        "shape": "mesh2000 x 256 (bench_nr_2k_krylov_lanes), float64",
        "library": "torch.sparse.mm of the S1-assembled Jacobian (CSR, "
                   "assembly excluded)"}
    log(f"timing: residual_jvp mesh2000 x256 kernel {k:.4f} ms (device "
        f"{k_dev:.4f}, queued events; {plan.route}, {plan.lanes_per_cta} "
        f"lanes and {plan.ctas_per_lane} CTAs a lane, {plan.smem} B shared) "
        f" plain {p:.4f} ms  bound {b:.4f} ms ({by})  library "
        f"torch.sparse.mm {lib:.4f} ms (device {lib_dev:.4f})")
    del csr, ev, bv
    sop2lo = sop2.to_dtype(torch.float32)
    x32, u32 = xk.float(), u.float()
    kf, kf_dev, plan_f = j1(x32, u32, sop2lo)
    pf = time_ms(torch, lambda: sol.residual_jvp_plain(x32, u32, sop2lo),
                 reps=3)
    st256 = torch.ones(lanes, m2, dtype=f64, device=dev)
    st256[torch.arange(lanes), n2 + torch.arange(lanes)] = 0.0
    ks, ks_dev, plan_s = j1(xk, u, sop2, st256)
    ps_ = time_ms(torch, lambda: sol.residual_jvp_plain(xk, u, sop2, st256),
                  reps=3)
    x64_, u64_ = xk[:MAIN_LANES].contiguous(), u[:MAIN_LANES].contiguous()
    k64, k64_dev, plan_64 = j1(x64_, u64_, sop2)
    wide = sol.residual_plan(n2, m2, lanes, f64, False, route=sol.WIDE)
    w_dev = queued_events_ms(
        torch, lambda: sol.residual_jvp(xk, u, sop2, plan=wide), 50)
    extra["residual_jvp"].update({
        "ms_f32": kf, "device_ms_f32": kf_dev, "plain_ms_f32": pf,
        "bound_ms_f32": bound(j1_bytes(lanes, 4), o_j1, fp64=False)[0],
        "plan_f32": plan_f._asdict(),
        "ms_status": ks, "device_ms_status": ks_dev, "plain_ms_status": ps_,
        "bound_ms_status": bound(j1_bytes(lanes, status=True), o_j1)[0],
        "plan_status": plan_s._asdict(),
        "ms_x64": k64, "device_ms_x64": k64_dev,
        "bound_ms_x64": bound(j1_bytes(MAIN_LANES),
                              o_j1 * MAIN_LANES // lanes)[0],
        "plan_x64": plan_64._asdict(), "wide_route_device_ms": w_dev})
    log(f"timing: residual_jvp f32 {kf:.4f} ms (device {kf_dev:.4f}; "
        f"{plan_f.lanes_per_cta} lanes a CTA)  plain {pf:.4f}; with status "
        f"{ks:.4f} ms (device {ks_dev:.4f}; {plan_s.lanes_per_cta} lanes a "
        f"CTA)  plain {ps_:.4f}; x{MAIN_LANES} {k64:.4f} ms (device "
        f"{k64_dev:.4f}; {plan_64.ctas_per_lane} CTAs a lane); the wide "
        f"route at x256 device {w_dev:.4f} ms")

    # I1 on the CIM feeder x 64 (phase 23's batch).  Its device time is
    # queued CUDA events around each call: the profiler's come back short
    # for I1 in the whole script.
    f, ties = cim_feeder()
    s = cim_loads(f, CIM_LANES)
    big_n = 3 * f.n_branches
    a_args = _cim_operands(torch, f, ties, s, dev)
    k = time_ms(torch, lambda: sol.cim_iterate(*a_args), reps=20)
    k_dev = queued_events_ms(torch, lambda: sol.cim_iterate(*a_args), 20)
    src = "queued events"
    p = time_ms(torch, lambda: sol.cim_iterate_plain(*a_args[:-1],
                                                     fixed=True), reps=3)
    a32 = tuple(a.float() if torch.is_tensor(a) and a.is_floating_point()
                else a for a in a_args)
    k32 = time_ms(torch, lambda: sol.cim_iterate(*a32), reps=20)
    k32_dev = queued_events_ms(torch, lambda: sol.cim_iterate(*a32), 20)
    p32 = time_ms(torch, lambda: sol.cim_iterate_plain(*a32[:-1],
                                                       fixed=True), reps=3)
    del a32
    b_i1 = 8 * (2 * big_n * big_n + CIM_LANES * big_n * 8 + big_n) \
        + 13 * CIM_LANES
    o_i1 = 8 * CIM_LANES * big_n * big_n
    ac = torch.complex(a_args[0], a_args[1])
    inj = torch.complex(a_args[2], a_args[3]).T.contiguous()
    lib = time_ms(torch, lambda: torch.matmul(ac, inj), reps=20)
    # The product is a dense fp64 GEMM: its least time is at the tensor
    # cores' rate, which the library row reaches and I1 does not use.
    t_bytes = b_i1 / PEAK_BYTES * 1e3
    b, by = bound(b_i1, o_i1, tensor=True)
    rows["cim_iterate"] = (k, p, lib, b, by)
    extra["cim_iterate"] = {
        "device_ms": k_dev, "device_ms_source": src,
        "shape": f"synthetic_radial(1000) + {CIM_TIES} ties x {CIM_LANES}",
        "library": "complex128 torch.matmul of A with the lanes' "
                   "injections alone",
        "bound_ms_bytes": t_bytes,
        "k_splits": nk.product_splits(big_n, CIM_LANES),
        "ms_f32": k32, "device_ms_f32": k32_dev, "plain_ms_f32": p32}
    log(f"timing: cim_iterate radial1000+ties x{CIM_LANES} kernel {k:.4f} ms "
        f"(device {k_dev:.4f}, {src}; {lib / k_dev:.2f}x its library row's "
        f"speed, {k_dev / lib:.2f}x its time)  plain {p:.4f} ms  bound "
        f"{b:.4f} ms ({by}; A read once {t_bytes:.4f})  library complex "
        f"matmul {lib:.4f} ms; {nk.product_splits(big_n, CIM_LANES)} K "
        f"slices; float32 {k32:.4f} ms (device {k32_dev:.4f})  plain "
        f"{p32:.4f} ({time.monotonic() - t0:.1f} s timings)")


def _cim_operands(torch, f, ties, s, dev):
    """I1's arguments for loads ``s [B, nb, 3]`` at the no-load profile
    (``fixed``: every lane stays active), as ``make_cim_solver`` forms
    them."""
    from freedm_tpu_torch.pf.cim import assemble_yabc
    from freedm_tpu_torch.pf.ladder import SOURCE_UNIT

    y, mask_np = assemble_yabc(f, ties)
    a_inv = np.linalg.inv(y[3:, 3:])
    vb = ((-a_inv @ y[3:, :3]) @ (SOURCE_UNIT * f.v_source_pu)
          ) * mask_np[1:].reshape(-1)
    lanes, big_n = s.shape[0], 3 * f.n_branches
    sp = -(s.reshape(lanes, big_n) / f.s_base_per_phase_kva)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64,
                               device=dev)

    vbl = np.tile(vb, (lanes, 1))
    return (t(a_inv.real), t(a_inv.imag), t(vbl.real), t(vbl.imag),
            t(sp.real), t(sp.imag), t(vbl.real), t(vbl.imag),
            t(mask_np[1:].reshape(-1)),
            torch.zeros(lanes, dtype=torch.float64, device=dev),
            torch.zeros(lanes, dtype=torch.int32, device=dev),
            torch.ones(lanes, dtype=torch.bool, device=dev),
            torch.zeros(1, dtype=torch.float64, device=dev), 1 << 30, True)


def synthetic_mesh_bench(n, chord_frac):
    """The reference bench's meshes: ``synthetic_mesh(n, seed=4,
    load_mw=2.0, chord_frac)`` (``bench.py:130``, ``:149``, ``:172``)."""
    from freedm_tpu_torch.grid.cases import synthetic_mesh

    return synthetic_mesh(n, seed=4, load_mw=2.0, chord_frac=chord_frac)


# ---------------------------------------------------------------------------
# Phase 22: the solvers at the reference bench's sizes
# ---------------------------------------------------------------------------

#: Mixed against f64 on the krylov lane batch (``tests/test_precision.py``
#: ``MIXED_DV_BOUND``).
MIXED_DV_BOUND = 2e-4
KRYLOV_LANES = 256
#: The north star of ``BASELINE.json`` (``bench.py:149``): ms a Newton
#: iteration of the 10k-bus meshed solve.
NORTH_STAR_MS = 10.0


def median_ms(torch, fn, reps, dev="cuda"):
    """Median host wall of ``fn`` over ``reps`` runs, each ending in a
    sync of the device (none on the CPU)."""
    ts = []
    for _ in range(reps):
        sync(torch, dev)
        t0 = time.monotonic()
        fn()
        sync(torch, dev)
        ts.append((time.monotonic() - t0) * 1e3)
    return float(np.median(ts))


def launches_of(sol, fn):
    """``fn()``'s result and Y1/F1/J1/I1's launches over it."""
    sol.reset_launches()
    out = fn()
    return out, {k: v for k, v in sol.launches().items() if v}


def busy_share(torch, fn, label, top=0):
    ops, busy, wall = profile_solve(torch, fn, label, top=top)
    return f"device busy {busy:.1f} of {wall:.1f} ms ({100 * busy / max(wall, 1e-9):.1f}%, {ops} operations)"


def solver_benches(torch, sol):
    """(a)-(g) of the module docstring."""
    from freedm_tpu_torch.pf.fdlf import make_fdlf_solver
    from freedm_tpu_torch.pf.krylov import (build_fdlf_precond,
                                            make_krylov_solver,
                                            true_mismatch)
    from freedm_tpu_torch.pf.newton import make_newton_solver

    dev = torch.device("cuda")
    t_phase = time.monotonic()
    out, paths = {}, {}
    t_step = [t_phase]

    def took():
        now = time.monotonic()
        dt, t_step[0] = now - t_step[0], now
        return f" ({dt:.1f} s)"

    # (a) bench_n1_118: dense solve_fixed over 118 per-lane outages.
    sys_ = case_system("mesh118")
    st = n1_118_status(sys_)
    _, fixed = make_newton_solver(sys_, max_iter=6, device=dev)
    _, fixed_p = make_newton_solver(sys_, max_iter=6, device=dev, plain=True)
    r, counts = launches_of(sol, lambda: fixed(status=st))
    rp = fixed_p(status=st)
    gap = max(max_err(r.v, rp.v), max_err(r.theta, rp.theta))
    check(gap <= SOLVE_ATOL and torch.equal(r.converged, rp.converged),
          f"(a) n1_118: kernel path {gap:.3e} pu from the plain path")
    ms = median_ms(torch, lambda: fixed(status=st), 5)
    check(counts.get("ybus_stamp", 0) == (dev.type == "cuda"),
          f"(a) n1_118: Y1 launches {counts}")
    paths["ybus_stamp"] = (counts.get("ybus_stamp", 0), "solvers phase (a): "
                           "bench_n1_118, mesh118 x 118 dense solve_fixed")
    log(f"solvers (a) bench_n1_118: mesh118 x {N1_118_LANES} outage lanes, "
        f"dense solve_fixed max_iter=6: {ms:.2f} ms (median of 5), "
        f"{int(r.converged.sum())}/{N1_118_LANES} converged, kernel path "
        f"within {gap:.2e} pu of the plain path; launches {counts}; "
        + busy_share(torch, lambda: fixed(status=st), "(a) n1_118") + took())
    out["n1_118_ms"] = ms

    # (b) bench_nr_2000 with make_fdlf_solver, one lane, max_iter=30.
    sys2k = synthetic_mesh_bench(2000, 1.0)
    solve, _ = make_fdlf_solver(sys2k, max_iter=30, device=dev)
    r, counts = launches_of(sol, solve)
    check(bool(r.converged.all()), f"(b) fdlf mesh2000: {r.mismatch}")
    paths["fdlf_half_step"] = (counts.get("fdlf_half_step", 0),
                               "solvers phase (b): fdlf bench_nr_2000, "
                               "mesh2000 x 1 solve")
    ms = median_ms(torch, solve, 10)
    log(f"solvers (b) fdlf bench_nr_2000: mesh2000 x1, {int(r.iterations[0])}"
        f" iterations, mismatch {float(r.mismatch[0]):.2e}: {ms:.2f} ms, "
        f"{1e3 / ms:.1f} solves/s; launches {counts}; "
        + busy_share(torch, solve, "(b) fdlf mesh2000") + took())
    out["fdlf_2000_solves_per_sec"] = 1e3 / ms

    # (c) bench_mc_1024 with make_fdlf_solver: mesh118 x 1024, fixed 16.
    rng = np.random.default_rng(0)
    scale = rng.uniform(0.7, 1.3, (1024, 1))
    p, q = scale * sys_.p_inj[None], scale * sys_.q_inj[None]
    _, fixed = make_fdlf_solver(sys_, max_iter=16, device=dev)
    r, counts = launches_of(sol, lambda: fixed(p_inj=p, q_inj=q))
    ms = median_ms(torch, lambda: fixed(p_inj=p, q_inj=q), 5)
    log(f"solvers (c) fdlf bench_mc_1024: mesh118 x1024, solve_fixed "
        f"max_iter=16: {ms:.2f} ms, {1024e3 / ms:.0f} lane solves/s, "
        f"{int(r.converged.sum())}/1024 converged; launches {counts}; "
        + busy_share(torch, lambda: fixed(p_inj=p, q_inj=q), "(c) fdlf mc")
        + took())
    out["fdlf_mc_1024_lane_solves_per_sec"] = 1024e3 / ms

    # (d) FDLF N-1: mesh2000 x 16 chord outages, per-lane factors.
    n2 = sys2k.n_bus
    st16 = np.ones((16, sys2k.n_branch))
    st16[np.arange(16), n2 + np.arange(16)] = 0.0
    t0 = time.monotonic()
    _, fixed = make_fdlf_solver(sys2k, max_iter=30, device=dev)
    t1 = time.monotonic()
    r, counts = launches_of(sol, lambda: fixed(status=st16))
    sync(torch, dev)
    first = f"build {t1 - t0:.1f} s, first solve {time.monotonic() - t1:.1f} s"
    check(bool(r.converged.all()), f"(d) fdlf N-1: {r.mismatch}")
    ms = median_ms(torch, lambda: fixed(status=st16), 3)
    log(f"solvers (d) fdlf N-1: mesh2000 x16 chord outages, per-lane Ybus, "
        f"B', B'' and LU, solve_fixed max_iter=30: {ms:.1f} ms, all "
        f"converged (worst {float(r.mismatch.max()):.2e}); {first}; "
        f"launches {counts}; " + busy_share(torch, lambda: fixed(status=st16),
                                            "(d) fdlf N-1") + took())
    out["fdlf_n1_2000x16_ms"] = ms

    # (e) bench_nr_2k_krylov_lanes: mesh2000 x 256, fixed 8, inner 16.
    rng = np.random.default_rng(0)
    scale = rng.uniform(0.9, 1.1, (KRYLOV_LANES, 1))
    p, q = scale * sys2k.p_inj[None], scale * sys2k.q_inj[None]
    pc = build_fdlf_precond(sys2k, device=dev)
    res = {}
    for prec in ("mixed", "f64"):
        _, fixed = make_krylov_solver(sys2k, max_iter=8, inner_iters=16,
                                      precision=prec, precond=pc, device=dev)
        r, counts = launches_of(sol, lambda: fixed(p_inj=p, q_inj=q))
        routes = sol.route_launches()["residual_jvp"]
        check(bool(r.converged.all()),
              f"(e) krylov {prec}: {int(r.converged.sum())} converged")
        ms = median_ms(torch, lambda: fixed(p_inj=p, q_inj=q), 3)
        res[prec] = r
        if prec == "mixed":
            paths["residual_jvp"] = (
                counts.get("residual_jvp", 0), "solvers phase (e): krylov "
                "mixed, mesh2000 x 256 solve_fixed max_iter=8 inner 16")
        busy = busy_share(torch, lambda: fixed(p_inj=p, q_inj=q),
                          f"(e) krylov {prec}, 8 Newton steps", top=10)
        j1_ms, j1_share = residual_share(False)
        out[f"krylov_lanes_{prec}_j1_device_ms"] = j1_ms
        out[f"krylov_lanes_{prec}_j1_routes"] = routes
        check(routes[sol.STAGED] == counts.get("residual_jvp", -1),
              f"(e) krylov {prec}: J1 launched {routes} by route, not all "
              f"staged")
        log(f"solvers (e) krylov {prec} bench_nr_2k_krylov_lanes: mesh2000 "
            f"x{KRYLOV_LANES}, solve_fixed max_iter=8 inner 16: {ms:.1f} ms, "
            f"{KRYLOV_LANES * 1e3 / ms:.0f} lane solves/s, all converged, "
            f"fallbacks {int(r.fallbacks.sum())}; launches {counts} (J1 "
            f"{routes}); {busy}; J1 {j1_ms:.2f} ms of the device's busy time "
            f"({100 * j1_share:.1f}%)" + took())
        out[f"krylov_lanes_{prec}_lane_solves_per_sec"] = (
            KRYLOV_LANES * 1e3 / ms)
    dv = max_err(res["mixed"].v, res["f64"].v)
    check(torch.equal(res["mixed"].converged, res["f64"].converged)
          and dv < MIXED_DV_BOUND, f"(e) mixed vs f64: {dv:.3e} pu")
    log(f"solvers (e) mixed vs f64: equal flags, max |dv| {dv:.2e} pu "
        f"(< {MIXED_DV_BOUND})")

    # (f) bench_n1_2000bus_krylov: base solve, then 256 chord outages.
    solve, _ = make_krylov_solver(sys2k, max_iter=8, inner_iters=16,
                                  precond=pc, device=dev)
    base = solve()
    check(bool(base.converged.all()), "(f) krylov base solve")
    _, screen = make_krylov_solver(sys2k, max_iter=3, inner_iters=16,
                                   precond=pc, device=dev)
    stk = np.ones((KRYLOV_LANES, sys2k.n_branch))
    stk[np.arange(KRYLOV_LANES), n2 + np.arange(KRYLOV_LANES)] = 0.0
    v0 = base.v.expand(KRYLOV_LANES, n2)
    th0 = base.theta.expand(KRYLOV_LANES, n2)

    def run_f():
        return screen(status=stk, v0=v0, theta0=th0)

    r, counts = launches_of(sol, run_f)
    check(bool(r.converged.all()),
          f"(f) krylov N-1: {int(r.converged.sum())} converged")
    ms = median_ms(torch, run_f, 3)
    log(f"solvers (f) bench_n1_2000bus_krylov: mesh2000 x{KRYLOV_LANES} "
        f"chord outages warm-started, max_iter=3: {ms:.1f} ms, all "
        f"converged; launches {counts}; "
        + busy_share(torch, run_f, "(f) krylov N-1") + took())
    out["krylov_n1_2000x256_ms"] = ms

    # (g) bench_nr_10k_mesh: the north star.
    t0 = time.monotonic()
    sys10k = synthetic_mesh_bench(10_000, 0.3)
    pre = build_fdlf_precond(sys10k, kind="auto", device=dev)
    solve, _ = make_krylov_solver(sys10k, max_iter=15, inner_iters=16,
                                  precond=pre, device=dev)
    build_s = time.monotonic() - t0
    r, counts = launches_of(sol, solve)
    check(bool(r.converged.all()), f"(g) 10k mesh: {r.mismatch}")
    ms = median_ms(torch, solve, 5)
    its = int(r.iterations[0])
    true = float(true_mismatch(sys10k, r)[0])
    log(f"solvers (g) bench_nr_10k_mesh: mesh10000 (chord_frac 0.3), LU "
        f"preconditioner ({pre.kind}), max_iter=15 inner 16, precision "
        f"auto: {ms:.1f} ms a solve, {its} Newton iterations, "
        f"{ms / its:.2f} ms an iteration (north star {NORTH_STAR_MS} ms an "
        f"iteration) on {torch.cuda.get_device_name(0)}; host f64 true "
        f"mismatch {true:.2e}; build {build_s:.1f} s; launches {counts}; "
        + busy_share(torch, solve, "(g) 10k mesh solve", top=10) + took())
    out.update(nr_10k_ms_per_solve=ms, nr_10k_ms_per_iteration=ms / its,
               nr_10k_true_mismatch=true)
    del pre, solve
    torch.cuda.empty_cache()
    log(f"solvers: phase 22 {time.monotonic() - t_phase:.1f} s")
    return out, paths


# ---------------------------------------------------------------------------
# Phase 23: the three-phase CIM
# ---------------------------------------------------------------------------

#: KCL check of the CIM feeder's solves (kVA per load-node phase).
CIM_KCL_KVA = 1e-6


def cim_phase(torch, sol):
    """vvc_9bus radial against L1's ladder fixed point; then the CIM
    feeder (two closed ties) × ``CIM_LANES`` load scales: converged, KCL,
    kernel path against the plain path, ms a solve."""
    from freedm_tpu_torch.grid.cases import vvc_9bus
    from freedm_tpu_torch.pf.cim import kcl_residual_kva, make_cim_solver
    from freedm_tpu_torch.pf.ladder import make_ladder_solver

    dev = torch.device("cuda")
    t0 = time.monotonic()
    f = vvc_9bus()
    lad, _ = make_ladder_solver(f, eps=1e-12, max_iter=200, device=dev)
    solve, _ = make_cim_solver(f, max_iter=200, device=dev)
    rl, (rc, counts) = lad(f.s_load), launches_of(sol, lambda: solve(
        f.s_load))
    gap = max(max_err(rl.v_node.re, rc.v_node.re),
              max_err(rl.v_node.im, rc.v_node.im))
    check(bool(rl.converged) and bool(rc.converged) and gap <= 1e-8,
          f"cim: vvc_9bus radial {gap:.3e} pu from the ladder")
    log(f"cim: vvc_9bus radial, {int(rc.iterations)} iterations, within "
        f"{gap:.2e} pu of L1's ladder fixed point; launches {counts}")
    f, ties = cim_feeder()
    s = cim_loads(f, CIM_LANES)
    solve, fixed = make_cim_solver(f, ties=ties, device=dev, max_iter=100)
    solve_p, _ = make_cim_solver(f, ties=ties, device=dev, max_iter=100,
                                 plain=True)
    r, counts = launches_of(sol, lambda: solve(s))
    rp = solve_p(s)
    check(bool(r.converged.all()), f"cim: {int(r.converged.sum())} converged")
    gap = max(max_err(r.v_node.re, rp.v_node.re),
              max_err(r.v_node.im, rp.v_node.im))
    check(gap <= SOLVE_ATOL and torch.equal(r.iterations, rp.iterations),
          f"cim: kernel path {gap:.3e} pu from the plain path")
    kcl = float(kcl_residual_kva(f, ties, r, s).max())
    check(kcl < CIM_KCL_KVA, f"cim: KCL residual {kcl:.3e} kVA")
    ms = median_ms(torch, lambda: solve(s), 5)
    log(f"cim: synthetic_radial(1000) + {CIM_TIES} closed ties x "
        f"{CIM_LANES} load scales (0.7-1.3, seed 0): all converged in "
        f"{int(r.iterations.min())}-{int(r.iterations.max())} iterations, "
        f"KCL residual <= {kcl:.2e} kVA, kernel path within {gap:.2e} pu of "
        f"the plain path with equal iterations; {ms:.2f} ms a solve "
        f"(median of 5); launches {counts}; "
        + busy_share(torch, lambda: solve(s), "cim radial1000+ties")
        + f" ({time.monotonic() - t0:.1f} s phase)")
    return counts


# ---------------------------------------------------------------------------
# Phases 24-26: the on-device DGI modules (G1, R1, B1) and the superstep
# ---------------------------------------------------------------------------

#: Phase 24's widths: G1 at each N (lanes of alive masks; the 4096-node
#: matrix takes G1's GLOBAL form), B1 at each N, R1 on the synthetic
#: topology (phase 25 (d)'s).
DGI_G1_NODES = ((3, 8), (16, 8), (256, 8), (256, 256), (1024, 2),
                (4096, 1))
DGI_B1_NODES = (3, 256, 4096)
#: B1's GLOBAL form (the working set in device memory), once.
DGI_B1_GLOBAL_NODES = 20000
DGI_FLEETS = 1024
DGI_FLEET_NODES = 256
DGI_ROUNDS = 64
#: The synthetic topology of phases 25 (d) and 26 (b): vertices, FIDs,
#: FID scenarios, SST nodes of (d).
DGI_VERTICES = 1024
DGI_FIDS = 64
DGI_SCENARIOS = 64
DGI_SST_NODES = 256
#: Phase 26 (b): fleet nodes, the 10k feeder's scenario lanes, rounds.
SUPERSTEP_NODES = 1024
SUPERSTEP_LANES = 64
SUPERSTEP_ROUNDS = 10
SUPERSTEP_FEEDER = 10000
#: The CPU test's tolerances of the superstep's VVC leg (float32 ladder,
#: tests/test_torch_superstep.py): loss relative, q in kvar; the snapshot
#: relative (the same library product on the same inputs).
SUPERSTEP_LOSS_RTOL = 1e-4
SUPERSTEP_Q_ATOL = 1e-3
SUPERSTEP_SC_RTOL = 1e-5
#: The float32 loss is the substation's power less the loads' (a
#: difference of two sums of the lane's size): kernel and plain path may
#: differ by a few float32 ulps of the lane's load power, which is more
#: than 1e-4 of a small loss.  On the dry run's feeder (96 nodes x 5 kW)
#: phase 26 (a) measured 5.0e-4 of the loss, 1.6e-7 of the load power
#: (H100), so the loss gap is held to SUPERSTEP_LOSS_RTOL of the loss or
#: this many ulps of the load power.
SUPERSTEP_LOSS_ULPS = 16


def dgi_topology_text(n_vertices=None, n_fids=None, seed=13):
    """A synthetic ``topology.cfg``: a random tree over ``n_vertices``
    (each vertex's parent among the 8 before it), three quarters of the
    FIDs on tree edges (opening one splits the tree), the rest ties
    between vertices further apart, an ``sst`` line a vertex
    (uuid ``n<i>``)."""
    n_vertices = n_vertices or DGI_VERTICES
    n_fids = n_fids or DGI_FIDS
    rng = np.random.default_rng(seed)
    parent = [int(rng.integers(max(0, i - 8), i)) for i in range(1, n_vertices)]
    on_tree = set(rng.choice(n_vertices - 1, size=3 * n_fids // 4,
                             replace=False).tolist())
    lines, k = [], 0
    for c, p in enumerate(parent):
        if c in on_tree:
            lines.append(f"fid v{p} v{c + 1} F{k}")
            k += 1
        else:
            lines.append(f"edge v{p} v{c + 1}")
    pairs = {frozenset((p, c + 1)) for c, p in enumerate(parent)}
    while k < n_fids:
        a, b = (int(x) for x in rng.integers(0, n_vertices, 2))
        if a != b and frozenset((a, b)) not in pairs:
            pairs.add(frozenset((a, b)))
            lines.append(f"fid v{a} v{b} F{k}")
            k += 1
    lines += [f"sst v{i} n{i}" for i in range(n_vertices)]
    return "\n".join(lines) + "\n"


def g1_graph(n, lanes, seed, chain=False):
    """G1 inputs: a sparse symmetric reachability (a random path through
    each of ``n // 32 + 1`` random groups plus a few chords in the group,
    or one path through every node: diameter n), alive masks with ~10%
    dead nodes (lane 0 all alive) and raw 32-bit priorities."""
    rng = np.random.default_rng(seed)
    reach = np.zeros((n, n), np.float32)
    groups = (np.zeros(n, np.int64) if chain
              else rng.integers(0, n // 32 + 1, n))
    for g in np.unique(groups):
        members = rng.permutation(np.nonzero(groups == g)[0])
        reach[members[:-1], members[1:]] = 1.0
        if not chain and len(members) > 2:
            a, b = rng.choice(members, (2, len(members) // 4))
            reach[a, b] = 1.0
    reach = np.maximum(reach, reach.T)
    alive = rng.uniform(size=(lanes, n)) >= 0.1
    alive[0] = True
    prio = rng.integers(0, 2 ** 32, n).astype(np.float64)
    return reach, alive, prio


def gm_priority(n):
    """The default election priority (``gm.node_priority``)."""
    from freedm_tpu_torch.modules.gm import node_priority

    return node_priority(n).astype(np.float64)


def g1_rank(torch, prio, dev):
    p = torch.as_tensor(prio, device=dev)
    return (torch.argsort(torch.argsort(p, stable=True), stable=True)
            + 1).to(torch.int32)


def same_fields(torch, a, b):
    """Every tensor field of two named tuples equal (bit for bit for
    floats: NaN-free 0/1 and ±step sums)."""
    return all(x is None and y is None or torch.equal(x, y)
               for x, y in zip(a, b))


def compare_dgi(torch, dk, errs, dev="cuda"):
    """Phase 24's checks: G1, R1 and B1 against their plain versions on the
    card, bit for bit, and bit-identical on repeat."""
    from freedm_tpu_torch.grid import topology as top
    from freedm_tpu_torch.modules import lb

    t0 = time.monotonic()
    sweeps_seen = {}
    for n, lanes in DGI_G1_NODES:
        for chain in (False, True, "directed"):
            if chain and n < 256 or chain == "directed" and n > 1024:
                continue
            reach, alive, prio = g1_graph(n, lanes, seed=n + bool(chain),
                                          chain=chain is True)
            if chain == "directed":  # outside the contract: the reference's
                reach = np.triu(reach)  # directed closure, label sweeps
            rank = g1_rank(torch, prio, dev)
            al = torch.as_tensor(alive, device=dev)
            rs = torch.as_tensor(reach, device=dev)[None]
            per_lane = n == 256 and not chain  # [B, N, N]: the lane stride
            if per_lane:
                rs = rs.expand(lanes, n, n).clone()
                rs[1:, :, : n // 2] = 0.0  # other graphs in other lanes
                rs = torch.maximum(rs, rs.mT).contiguous()
            sw = torch.empty(lanes, dtype=torch.int32, device=dev)
            got = dk.form_groups(al, rs, rank, sweeps=sw)
            again = dk.form_groups(al, rs, rank)
            want = dk.form_groups_plain(al, rs, rank)
            sync(torch, dev)
            tag = f"G1 n={n} x{lanes}{' ' + str(chain) if chain else ''}"
            check(same_fields(torch, got, want),
                  f"dgi kernels: {tag} differs from its plain version: "
                  f"{[torch.equal(x, y) for x, y in zip(got, want)]}")
            check(same_fields(torch, got, again),
                  f"dgi kernels: {tag} not bit-identical on repeat")
            sweeps_seen[tag] = (sw.tolist() if dev != "cpu" else [],
                                got.n_groups.tolist())
    log(f"dgi kernels: G1 equal to its plain version and on repeat "
        f"(hooking rounds, or minus the directed label sweeps; groups): "
        f"{sweeps_seen}")
    for v, s in ((48, 4), (DGI_VERTICES, DGI_SCENARIOS), (2048, 4)):
        topo = top.parse_topology(dgi_topology_text(v, min(DGI_FIDS, v // 2)))
        op = dk.reach_operands(topo.adj, topo.fid_edges, torch.device(dev))
        rng = np.random.default_rng(v)
        closed = torch.as_tensor(rng.uniform(size=(s, topo.n_fids)) > 0.3,
                                 dtype=torch.float32, device=dev)
        sw = torch.empty(s, dtype=torch.int32, device=dev)
        got = dk.reach_closure(op, closed, sweeps=sw)
        again = dk.reach_closure(op, closed)
        want = dk.reach_closure_plain(op, closed)
        sync(torch, dev)
        check(torch.equal(got, want),
              f"dgi kernels: R1 V={v} x{s} differs from its plain version "
              f"({int((got != want).sum())} entries)")
        check(torch.equal(got, again),
              f"dgi kernels: R1 V={v} x{s} not bit-identical on repeat")
        comps = [len(torch.unique(got[k], dim=0)) for k in range(min(s, 4))]
        log(f"dgi kernels: R1 V={v} x {s} FID scenarios equal and "
            f"repeatable; components of the first scenarios {comps}; hooking "
            f"rounds {sorted(set(sw.tolist())) if dev != 'cpu' else '-'}; "
            f"form {'SHARED' if dk.r1_smem_bytes(v, True) <= dk.SMEM_LIMIT else 'GLOBAL'}")
    f32, f64 = torch.float32, torch.float64
    b1_cases = [(n, 1, t) for n in DGI_B1_NODES
                for t in ((f32, f32), (f64, f64), (f64, f32))]
    b1_cases += [(DGI_FLEET_NODES, DGI_FLEETS, (f32, f32)),
                 (DGI_B1_GLOBAL_NODES, 1, (f64, f64))]
    for n, fleets, (tn, tg) in b1_cases:
        rng = np.random.default_rng(n + fleets)
        g = rng.integers(0, max(1, n // 48), (fleets, n))
        gid = torch.as_tensor(np.stack([lb_gid(x) for x in g]),
                              dtype=torch.int32, device=dev)
        ng = torch.as_tensor(rng.normal(0, 10, (fleets, n)), dtype=tn,
                             device=dev)
        gw = torch.as_tensor(np.round(rng.normal(0, 2, (fleets, n)), 1),
                             dtype=tg, device=dev)
        mal = torch.as_tensor(rng.uniform(size=(fleets, n)) < 0.2,
                              dtype=torch.float32, device=dev)
        gate = torch.as_tensor(rng.uniform(size=(fleets, n)) < 0.9,
                               device=dev)
        tag = f"B1 n={n} x{fleets} {tn}/{tg}".replace("torch.", "")
        for step, rounds, kw in ((0.5, 1, dict(malicious=mal, gate=gate,
                                                round_outputs=True)),
                                 (1.0, 1, dict(round_outputs=True)),
                                 (1.0, 8 if n > 4096 else DGI_ROUNDS // 2,
                                  dict(malicious=mal))):
            got = dk.lb_rounds(ng, gw, gid, step, rounds, **kw)
            again = dk.lb_rounds(ng, gw, gid, step, rounds, **kw)
            want = dk.lb_rounds_plain(ng, gw, gid, step, rounds, **kw)
            sync(torch, dev)
            check(same_fields(torch, got, want),
                  f"dgi kernels: {tag} step {step} x{rounds} differs from "
                  f"its plain version: "
                  f"{[x is None or torch.equal(x, y) for x, y in zip(got, want)]}")
            check(same_fields(torch, got, again),
                  f"dgi kernels: {tag} x{rounds} not bit-identical on repeat")
        log(f"dgi kernels: {tag} equal and repeatable (one round with "
            f"malicious and gate, one without, {rounds} rounds), form "
            f"{dk.lb_form(n, torch.empty((), dtype=tg).element_size())}, "
            f"migrations of the last round {int(got.migrations[:, -1].sum())}")
    for name in ("form_groups", "reach_closure", "lb_rounds"):
        errs[name] = 0.0  # every comparison above is exact
    log(f"dgi kernels: phase 24 checks {time.monotonic() - t0:.1f} s")


def lb_gid(groups):
    """:func:`lb.group_ids` of a partition given by labels: each node's
    smallest same-label index."""
    first = {}
    for i, g in enumerate(groups.tolist()):
        first.setdefault(g, i)
    return np.array([first[g] for g in groups.tolist()], np.int32)


def events_ms(torch, fn, reps):
    """Median device time of one call of ``fn`` by CUDA events around it,
    the device idle before each (the launch gap counted in: µs)."""
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def dgi_device_ms(torch, fn, reps, label):
    """The profiler's device time of one call (:func:`device_ms`), or CUDA
    events per call where the whole script's traces come back without
    device events (as for L1/L2, T1/T2 before)."""
    try:
        return device_ms(torch, fn, reps)
    except SmokeFailure:
        log(f"timing: {label}: the profiler recorded no device time; CUDA "
            f"events per call")
        return events_ms(torch, fn, reps)


def superstep_reach(torch, dev, rng=None):
    """Phase 26 (b)'s reachability over SUPERSTEP_NODES nodes (the
    synthetic topology with ~10% of its FIDs open: ~98% dense, several
    islands) as ``[1, N, N]`` float32, and its alive mask (2% dead) as
    ``[1, N]`` bool, drawn from ``rng`` (phase 26 (b)'s; by default a new
    one of its seed, 26)."""
    from freedm_tpu_torch.grid import topology as top

    n = SUPERSTEP_NODES
    rng = np.random.default_rng(26) if rng is None else rng
    reach = top.node_reachability(
        top.parse_topology(dgi_topology_text()),
        tuple(f"n{i}" for i in range(n)), device=dev)(
        rng.uniform(size=DGI_FIDS) > 0.1)
    alive = torch.as_tensor(rng.uniform(size=n) >= 0.02, device=dev)[None]
    return reach[None].contiguous(), alive


def g1_bound(n, lanes, reach_lanes):
    """G1's bytes: reach, alive and rank read once; coordinator,
    group_mask, is_coordinator, group_size and n_groups written once."""
    read = reach_lanes * n * n * 4 + lanes * n + 4 * n
    write = lanes * (n * n * 4 + 9 * n + 4)
    return bound(read + write, 0, fp64=False)


def time_dgi(torch, dk, rows, extra):
    """Phase 24's times (events and device time) beside the plain versions,
    the bounds and, for G1 and R1, the plain version's float32 squarings
    alone (a composite of library calls)."""
    from freedm_tpu_torch.grid import topology as top

    dev = torch.device("cuda")
    t0 = time.monotonic()
    g1_rows = {}
    for n, lanes, kind in ((SUPERSTEP_NODES, 1, "superstep"),
                           (SUPERSTEP_NODES, 1, "sparse"),
                           (SUPERSTEP_NODES, 16, "sparse"),
                           (SUPERSTEP_NODES, 64, "sparse"),
                           (DGI_SST_NODES, DGI_SCENARIOS, "sparse"),
                           (4096, 1, "sparse")):
        if kind == "superstep":  # phase 26 (b)'s reach and alive mask
            rs, al = superstep_reach(torch, dev)
            rank = g1_rank(torch, gm_priority(n), dev)
        else:
            reach, alive, prio = g1_graph(n, lanes, seed=7 * n)
            rank = g1_rank(torch, prio, dev)
            al = torch.as_tensor(alive, device=dev)
            rs = torch.as_tensor(reach, device=dev)[None].contiguous()
        k = events_ms(torch, lambda: dk.form_groups(al, rs, rank), 20)
        kq = queued_events_ms(torch, lambda: dk.form_groups(al, rs, rank), 20)
        d = dgi_device_ms(torch, lambda: dk.form_groups(al, rs, rank), 20,
                          f"form_groups n={n} x{lanes}")
        p = time_ms(torch, lambda: dk.form_groups_plain(al, rs, rank), 3)
        adj = rs.expand(lanes, n, n).contiguous()
        sq = dk.closure_rounds(n) + 1
        lib = time_ms(torch, lambda: [torch.bmm(adj, adj) for _ in range(sq)],
                      3)
        b, by = g1_bound(n, lanes, 1)
        g1_rows[f"{n}x{lanes} {kind}"] = dict(
            ms=kq, events_a_call_ms=k, device_ms=d, plain_ms=p, bound_ms=b,
            matmul_squarings_ms=lib, matmul_squarings=sq)
        log(f"timing: form_groups n={n} x{lanes} {kind}"
            f" queued events {kq:.4f} ms, events a call {k:.4f} ms, device "
            f"{d:.4f} ms; plain {p:.4f} ms; bound {b:.5f} ms ({by}); library "
            f"composite: {sq} float32 torch.bmm squarings {lib:.4f} ms")
        del adj
    main = g1_rows[f"{SUPERSTEP_NODES}x1 superstep"]
    rows["form_groups"] = (main["ms"], main["plain_ms"], None,
                           main["bound_ms"], "bytes")
    extra["form_groups"] = {"shape": f"N={SUPERSTEP_NODES} x 1 lane, the "
                                     f"superstep's reach",
                            "ms_source": "queued CUDA events",
                            "events_a_call_ms": main["events_a_call_ms"],
                            "device_ms": main["device_ms"],
                            "library_composite_ms": main[
                                "matmul_squarings_ms"],
                            "library_composite": (
                                f"{main['matmul_squarings']} float32 "
                                "torch.bmm squarings (TF32 off), not one call"),
                            "other_shapes": g1_rows}
    topo = top.parse_topology(dgi_topology_text())
    op = dk.reach_operands(topo.adj, topo.fid_edges, dev)
    rng = np.random.default_rng(1)
    closed = torch.as_tensor(rng.uniform(size=(DGI_SCENARIOS, DGI_FIDS)) > 0.3,
                             dtype=torch.float32, device=dev)
    k = time_ms(torch, lambda: dk.reach_closure(op, closed), 20)
    d = dgi_device_ms(torch, lambda: dk.reach_closure(op, closed), 20,
                      "reach_closure")
    p = time_ms(torch, lambda: dk.reach_closure_plain(op, closed), 3)
    v = DGI_VERTICES
    r = torch.ones(DGI_SCENARIOS, v, v, device=dev)
    sq = dk.closure_rounds(v)
    lib = time_ms(torch, lambda: [torch.bmm(r, r) for _ in range(sq)], 3)
    b, by = bound(op.bits.numel() * 4 + 8 * DGI_FIDS + closed.numel() * 4
                  + DGI_SCENARIOS * v * v * 4, 0)
    rows["reach_closure"] = (k, p, None, b, by)
    extra["reach_closure"] = {
        "shape": f"V={v} x S={DGI_SCENARIOS} FID scenarios, {DGI_FIDS} FIDs",
        "device_ms": d, "library_composite_ms": lib,
        "library_composite": f"{sq} float32 torch.bmm squarings (TF32 off), "
                             "not one call"}
    log(f"timing: reach_closure V={v} x{DGI_SCENARIOS} event {k:.4f} ms, "
        f"device {d:.4f} ms; plain {p:.4f} ms; bound {b:.5f} ms ({by}); "
        f"library composite: {sq} float32 torch.bmm squarings {lib:.4f} ms")
    b1_rows = {}
    for n, fleets, rounds in ((256, 1, DGI_ROUNDS), (SUPERSTEP_NODES, 1, 1),
                              (4096, 1, DGI_ROUNDS),
                              (DGI_FLEET_NODES, DGI_FLEETS, DGI_ROUNDS)):
        rng = np.random.default_rng(0)
        ng = torch.as_tensor(rng.normal(0, 10, (fleets, n)),
                             dtype=torch.float32, device=dev)
        gw = torch.zeros(fleets, n, dtype=torch.float32, device=dev)
        gid = torch.zeros(1, n, dtype=torch.int32, device=dev)
        call = lambda: dk.lb_rounds(ng, gw, gid, 1.0, rounds)  # noqa: E731
        k = time_ms(torch, call, 20)
        d = dgi_device_ms(torch, call, 20, f"lb_rounds n={n} x{fleets}")
        p = time_ms(torch, lambda: dk.lb_rounds_plain(ng, gw, gid, 1.0,
                                                      rounds), 2)
        b, by = bound(fleets * n * 8 + 4 * n + fleets * n * 4
                      + fleets * rounds * (4 + 4 * n), 0, fp64=False)
        b1_rows[f"{n}x{fleets}x{rounds}"] = dict(ms=k, device_ms=d,
                                                 plain_ms=p, bound_ms=b)
        log(f"timing: lb_rounds n={n} x{fleets} fleets x{rounds} rounds "
            f"float32 event {k:.4f} ms, device {d:.4f} ms; plain {p:.4f} "
            f"ms; bound {b:.5f} ms ({by}); no single library call")
    main = b1_rows[f"256x1x{DGI_ROUNDS}"]
    rows["lb_rounds"] = (main["ms"], main["plain_ms"], None, main["bound_ms"],
                         "bytes")
    extra["lb_rounds"] = {"shape": f"bench_lb_256: N=256, {DGI_ROUNDS} "
                                   "rounds, float32",
                          "device_ms": main["device_ms"],
                          "other_shapes": b1_rows}
    log(f"timing: phase 24 times {time.monotonic() - t0:.1f} s")


def lb_trajectory(torch, lb, ng, gw, mask, rounds, dev):
    """``run_rounds`` on the kernel path and its plain twin: equal final
    gateways, per-round migrations and states; the kernel's result."""
    got = lb.run_rounds(ng, gw, mask, 1.0, rounds, device=dev)
    want = lb.run_rounds(ng, gw, mask, 1.0, rounds, device=dev, plain=True)
    check(all(torch.equal(x, y) for x, y in zip(got, want)),
          "dgi: run_rounds differs from its plain twin")
    return got


def converged_at(migs):
    """The first round with no migration (-1 if none)."""
    zero = np.nonzero(np.asarray(migs) == 0)[0]
    return int(zero[0]) if len(zero) else -1


def dgi_phase(torch, dk, dev="cuda"):
    """Phase 25 (a)-(d) of the module docstring; returns R1 and G1's
    launches in (d).  ``dev="cpu"`` rehearses it on the plain versions."""
    from freedm_tpu_torch.grid import topology as top
    from freedm_tpu_torch.modules import gm, lb

    dev = torch.device(dev)
    t0 = time.monotonic()
    rng = np.random.default_rng(0)
    ng = rng.normal(0, 10, 256)
    gw0 = np.zeros(256)
    mask = torch.ones(256, 256, device=dev)
    gw, migs, _ = lb_trajectory(torch, lb, ng.astype(np.float32),
                                gw0.astype(np.float32), mask, DGI_ROUNDS, dev)
    check(int(migs[-1]) == 0, "dgi (a): bench_lb_256 did not converge")
    run = lambda: lb.run_rounds(ng.astype(np.float32),  # noqa: E731
                                gw0.astype(np.float32), mask, 1.0,
                                DGI_ROUNDS, device=dev)
    ms = median_ms(torch, run, 10, dev)
    log(f"dgi (a): bench_lb_256 (N=256, normal(0, 10), seed 0, {DGI_ROUNDS} "
        f"rounds, float32): converged at round {converged_at(migs.tolist())}"
        f", kernel and plain trajectories equal; {ms:.4f} ms a run "
        f"(median of 10, host clock), {DGI_ROUNDS / ms * 1e3:.0f} rounds/s "
        f"(the reference bench's lb_256node_rounds_per_sec)")
    for n in (1024, 4096):
        rng = np.random.default_rng(n)
        ng = rng.normal(0, 10, n).astype(np.float32)
        gw0 = np.zeros(n, np.float32)
        mask = torch.ones(n, n, device=dev)
        rounds = 2 * DGI_ROUNDS
        _, migs, _ = lb_trajectory(torch, lb, ng, gw0, mask, rounds, dev)
        at = converged_at(migs.tolist())
        check(at > 0, f"dgi (b): N={n} did not converge in {rounds} rounds")
        ms = median_ms(torch, lambda: lb.run_rounds(ng, gw0, mask, 1.0,
                                                  rounds, device=dev), 5, dev)
        log(f"dgi (b): N={n} one group, normal(0, 10): converged at round "
            f"{at}; {rounds} rounds {ms:.4f} ms (median of 5), "
            f"{rounds / ms * 1e3:.0f} rounds/s, convergence wall "
            f"{ms * at / rounds:.4f} ms")
    rng = np.random.default_rng(3)
    f, n = DGI_FLEETS, DGI_FLEET_NODES
    ng = rng.normal(0, 10, (f, n)).astype(np.float32)
    groups = rng.integers(0, 4, (f, n))
    masks = torch.as_tensor(groups[:, :, None] == groups[:, None, :],
                            dtype=torch.float32, device=dev)
    gw, migs, _ = lb_trajectory(torch, lb, ng, np.zeros_like(ng), masks,
                                DGI_ROUNDS, dev)
    ms = median_ms(torch, lambda: lb.run_rounds(
        ng, np.zeros_like(ng), masks, 1.0, DGI_ROUNDS, device=dev), 5, dev)
    done = int((migs[:, -1] == 0).sum())
    log(f"dgi (c): {f} fleets x {n} nodes (4 groups each), {DGI_ROUNDS} "
        f"rounds in one launch: {done}/{f} fleets converged, kernel and "
        f"plain equal; {ms:.3f} ms (median of 5), "
        f"{f * DGI_ROUNDS / ms * 1e3:.0f} fleet-rounds/s")
    topo = top.parse_topology(dgi_topology_text())
    uuids = tuple(f"n{4 * i}" for i in range(DGI_SST_NODES))
    closed = rng.uniform(size=(DGI_SCENARIOS, DGI_FIDS)) > 0.3
    alive = rng.uniform(size=(DGI_SCENARIOS, DGI_SST_NODES)) >= 0.05
    dk.reset_launches()
    node_reach = top.node_reachability(topo, uuids, device=dev)
    nr = node_reach(closed)
    g = gm.form_groups(alive, nr, device=dev)
    sync(torch, dev)
    counts = dk.launches()
    nr_p = top.node_reachability(topo, uuids, device=dev, plain=True)(closed)
    g_p = gm.form_groups(alive, nr_p, device=dev, plain=True)
    check(torch.equal(nr, nr_p), "dgi (d): node reachability differs")
    check(torch.equal(g.n_groups, g_p.n_groups)
          and same_fields(torch, g, g_p), "dgi (d): groups differ")
    check(dev.type == "cpu" or counts["reach_closure"] == 1
          and counts["form_groups"] == 1, f"dgi (d): launches {counts}")
    ms = median_ms(torch, lambda: gm.form_groups(alive, node_reach(closed),
                                               device=dev), 5, dev)
    ng_ = g.n_groups.tolist()
    log(f"dgi (d): topology V={DGI_VERTICES}, {DGI_FIDS} FIDs x "
        f"{DGI_SCENARIOS} FID scenarios -> R1 -> node_reachability to "
        f"{DGI_SST_NODES} SST nodes -> batched G1 (5% dead): groups a "
        f"scenario {min(ng_)}-{max(ng_)}, equal to the plain path; "
        f"launches {counts}; {ms:.3f} ms the three (median of 5)")
    log(f"dgi: phase 25 {time.monotonic() - t0:.1f} s")
    return counts


def superstep_fleet(torch, n, seed, dev):
    """Host readings of ``n`` nodes (SST gateway 0, DRER generation and
    LOAD drain |normal(0, 5)|) as a DeviceTensor ``[n, 3, ns]``; the
    netgen and gateway vectors through ``devices.tensor.net_value``."""
    from freedm_tpu_torch.devices import compile_layout
    from freedm_tpu_torch.devices import tensor as dt

    lay = compile_layout()
    rng = np.random.default_rng(seed)
    state = np.zeros((n, 3, lay.n_signals))
    state[:, 1, lay.signal_index("generation")] = np.abs(rng.normal(0, 5, n))
    state[:, 2, lay.signal_index("drain")] = np.abs(rng.normal(0, 5, n))
    one = dt.from_host(lay, 3, ("Sst", "Drer", "Load"), state[0], device=dev)
    t = dt.DeviceTensor(
        state=torch.as_tensor(state, dtype=torch.float32, device=dev),
        command=one.command.expand(n, -1, -1).contiguous(),
        type_id=one.type_id.expand(n, -1).contiguous(),
        alive=one.alive.expand(n, -1).contiguous())
    ids = lay.type_ids
    netgen = (dt.net_value(t, ids["Drer"], lay.signal_index("generation"))
              - dt.net_value(t, ids["Load"], lay.signal_index("drain")))
    gateway = dt.net_value(t, ids["Sst"], lay.signal_index("gateway"))
    return netgen, gateway


def superstep_gaps(torch, out, want):
    """The CPU test's comparison of a kernel-path superstep with its plain
    twin: group and lb_out equal; the snapshot, losses and q gaps."""
    check(same_fields(torch, out.group, want.group), "superstep: groups differ")
    check(same_fields(torch, out.lb_out, want.lb_out),
          "superstep: lb_out differs")
    sc_gap = max(float(((a - b).abs() / b.abs().clamp(min=1.0)).max())
                 for a, b in zip(out.collected[:6], want.collected[:6]))
    check(torch.equal(out.collected.members, want.collected.members)
          and sc_gap <= SUPERSTEP_SC_RTOL, f"superstep: collected {sc_gap:.3e}")
    gap = (out.vvc_loss - want.vvc_loss).abs()
    p_load = want.state.s_load.re.abs().sum(dim=(-2, -1))
    eps = torch.finfo(torch.float32).eps
    limit = torch.maximum(SUPERSTEP_LOSS_RTOL * want.vvc_loss.abs(),
                          SUPERSTEP_LOSS_ULPS * eps * p_load)
    loss = float((gap / want.vvc_loss.abs().clamp(min=1e-30)).max())
    of_load = float((gap / p_load).max())
    q = max_err(out.state.q_ctrl, want.state.q_ctrl)
    check(bool((gap <= limit).all()) and q <= SUPERSTEP_Q_ATOL,
          f"superstep: vvc loss {loss:.3e} relative ({of_load:.3e} of the "
          f"load), q {q:.3e} kvar")
    return sc_gap, loss, q, of_load


def superstep_phase(torch, dk, lk, dev="cuda"):
    """Phase 26 (a) and (b) of the module docstring; returns G1, B1 and
    R1's launches over (b)'s kernel rounds (R1: the reachability) and the
    ms a round by phase.  ``dev="cpu"`` rehearses it on the plain
    versions (no times)."""
    from freedm_tpu_torch.grid.cases import synthetic_radial
    from freedm_tpu_torch.parallel import make_superstep

    dev = torch.device(dev)
    on_card = dev.type == "cuda"
    t0 = time.monotonic()
    feeder = synthetic_radial(96, seed=3, load_kw=5.0)
    step, shard = make_superstep(feeder=feeder, device=dev)
    step_p, _ = make_superstep(feeder=feeder, device=dev, plain=True)
    netgen, gateway = superstep_fleet(torch, 16, 0, dev)
    st = shard(netgen.cpu().numpy(), gateway.cpu().numpy(),
               np.linspace(0.8, 1.2, 8))
    worst = (0.0, 0.0, 0.0, 0.0)
    for _ in range(2):
        out, want = step(st), step_p(st)
        gaps = superstep_gaps(torch, out, want)
        worst = tuple(max(a, b) for a, b in zip(worst, gaps))
        check(bool(torch.isfinite(out.vvc_loss).all()), "superstep (a)")
        st = out.state
    log(f"superstep (a): the dry run's shapes (16 nodes, synthetic_radial(96,"
        f" seed=3, load_kw=5.0), 8 scenario lanes), two rounds: groups and "
        f"lb_out equal to the plain twin, snapshot {worst[0]:.2e}, loss "
        f"{worst[1]:.2e} relative ({worst[3]:.2e} of the load power), q "
        f"{worst[2]:.2e} kvar; "
        f"{int(out.group.n_groups)} group(s), {int(out.lb_out.n_migrations)} "
        f"migrations in round 2")
    n = SUPERSTEP_NODES
    feeder = synthetic_radial(SUPERSTEP_FEEDER, seed=0, load_kw=1.0)
    dk.reset_launches()
    lk.reset_launches()
    rng = np.random.default_rng(26)
    reach, alive = superstep_reach(torch, dev, rng)  # G1's timed input too
    step, shard = make_superstep(feeder=feeder, device=dev)
    step_p, _ = make_superstep(feeder=feeder, device=dev, plain=True)
    netgen, gateway = superstep_fleet(torch, n, 1, dev)
    st = shard(netgen.cpu().numpy(), gateway.cpu().numpy(),
               rng.uniform(0.7, 1.3, SUPERSTEP_LANES),
               alive=alive[0].cpu().numpy().astype(np.float32),
               reachable=reach[0].cpu().numpy())
    split = {k: [] for k in ("gm", "lb", "sc", "vvc")}
    host = {k: [] for k in split}
    worst = (0.0, 0.0, 0.0, 0.0)
    walls, plain_walls = [], []
    for r in range(SUPERSTEP_ROUNDS):
        marks, names, stamps = [], [], []

        def record(name=None):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
            stamps.append(time.perf_counter())
            if name is not None:
                names.append(name)

        sync(torch, dev)
        t1 = time.monotonic()
        if on_card:
            record()
        out = step(st, record=record if on_card else None)
        sync(torch, dev)
        walls.append((time.monotonic() - t1) * 1e3)
        if r > 0 and on_card:
            for a, b, name in zip(marks, marks[1:], names):
                split[name].append(a.elapsed_time(b))
            for a, b, name in zip(stamps, stamps[1:], names):
                host[name].append((b - a) * 1e3)
        t1 = time.monotonic()
        want = step_p(st)
        sync(torch, dev)
        plain_walls.append((time.monotonic() - t1) * 1e3)
        gaps = superstep_gaps(torch, out, want)
        worst = tuple(max(a, b) for a, b in zip(worst, gaps))
        st = out.state
    counts = {**dk.launches(), **lk.launches()}
    check(not on_card or counts["form_groups"] == SUPERSTEP_ROUNDS
          and counts["lb_rounds"] == SUPERSTEP_ROUNDS
          and counts["reach_closure"] == 1 and counts["ladder_solve"] > 0
          and counts["ladder_vjp"] == SUPERSTEP_ROUNDS,
          f"superstep (b): launches {counts}")
    per = {k: float(np.mean(v)) if v else 0.0 for k, v in split.items()}
    if on_card:  # G1 alone on this reachability
        al = st.alive[None] >= 0.5
        rs = st.reachable[None].contiguous()
        rank = g1_rank(torch, gm_priority(n), dev)
        g1 = events_ms(torch, lambda: dk.form_groups(al, rs, rank), 20)
        log(f"superstep (b): G1 alone on the round's reachability (density "
            f"{float(st.reachable.mean()):.3f}), CUDA events per call: "
            f"{g1:.4f} ms")
    busy = (busy_share(torch, lambda: step(st), "superstep 1024 nodes")
            if on_card else "")
    log(f"superstep (b): {n} nodes (readings through devices.tensor."
        f"net_value; reachability from (d)'s topology, 10% FIDs open; 2% "
        f"dead), synthetic_radial({SUPERSTEP_FEEDER}, seed=0, load_kw=1.0) x "
        f"{SUPERSTEP_LANES} lanes, {SUPERSTEP_ROUNDS} rounds, each against "
        f"the plain twin from the same state: groups and lb_out equal, "
        f"snapshot {worst[0]:.2e}, loss {worst[1]:.2e} relative "
        f"({worst[3]:.2e} of the load power), q {worst[2]:.2e} kvar; "
        f"{int(out.group.n_groups)} groups, "
        f"{int(out.lb_out.n_migrations)} migrations in the last round; ms a "
        f"round by CUDA events (rounds 2-{SUPERSTEP_ROUNDS}): "
        + ", ".join(f"{k.upper()} {v:.3f}" for k, v in per.items())
        + " (host, to each phase's return: " + ", ".join(
            f"{k.upper()} {float(np.mean(v)) if v else 0.0:.3f}"
            for k, v in host.items())
        + f"; sum {sum(per.values()):.3f}; host wall median "
        f"{float(np.median(walls[1:])):.3f}; the plain twin's "
        f"{float(np.median(plain_walls)):.1f}); launches a round: G1 "
        f"{counts['form_groups'] / SUPERSTEP_ROUNDS:g}, B1 "
        f"{counts['lb_rounds'] / SUPERSTEP_ROUNDS:g}, L1 "
        f"{counts['ladder_solve'] / SUPERSTEP_ROUNDS:g}, L2 "
        f"{counts['ladder_vjp'] / SUPERSTEP_ROUNDS:g} (R1 once: the "
        f"reachability); {busy}")
    if on_card:
        per["vvc_split"] = vvc_leg_split(torch, lk, feeder, per["vvc"],
                                         counts)
    log(f"superstep: phase 26 {time.monotonic() - t0:.1f} s")
    return counts, per


def vvc_leg_split(torch, lk, feeder, vvc_ms, counts):
    """Phase 26 (b)'s VVC leg (float32, ``SUPERSTEP_LANES`` lanes of the
    10k feeder, ``VVCConfig().pf_iters`` iterations a solve) split by its
    kernels, each timed alone by queued events on the round's shapes: L1's
    saving solve, L2, and L1's trial solves (the round's L1 launches less
    the saving one, each a fixed solve's time); the rest of the leg (its
    host reads and the step's tensor operations) is the leg less their
    sum."""
    from freedm_tpu_torch.modules.vvc import VVCConfig

    iters, dt = VVCConfig().pf_iters, torch.float32
    s, v0, op = preorder_inputs(torch, lk, feeder, SUPERSTEP_LANES, dt)
    saved = lk.ladder_solve(s, v0, op, LADDER_EPS, iters, True,
                            save=True).saved
    gs = _cotangents(torch, np.random.default_rng(26), SUPERSTEP_LANES,
                     op.nb, dt)
    split = {
        "l1_saving": queued_events_ms(torch, lambda: lk.ladder_solve(
            s, v0, op, LADDER_EPS, iters, True, save=True), 5),
        "l2": queued_events_ms(torch, lambda: lk.ladder_vjp(
            saved, s, op, *gs), 5),
        "trials_a_round": counts["ladder_solve"] / SUPERSTEP_ROUNDS - 1}
    trial = queued_events_ms(torch, lambda: lk.ladder_solve(
        s, v0, op, LADDER_EPS, iters, True), 5)
    split["l1_trials"] = split["trials_a_round"] * trial
    split["rest"] = vvc_ms - (split["l1_saving"] + split["l2"]
                              + split["l1_trials"])
    plan = lk.ladder_plan(op.nb, dt)
    log(f"superstep (b): the VVC leg {vvc_ms:.3f} ms a round = L1 saving "
        f"{split['l1_saving']:.3f} + L2 {split['l2']:.3f} ({plan.route} "
        f"route, {plan.cluster} CTAs a lane) + L1 trials "
        f"{split['trials_a_round']:g} x {trial:.3f} + the rest (host reads, "
        f"the step's tensor operations) {split['rest']:.3f} (each kernel "
        f"alone, queued events, float32 x{SUPERSTEP_LANES})")
    return split


# ---------------------------------------------------------------------------
# Phase 27: the reverse modes of the fixed solves
# ---------------------------------------------------------------------------

#: J2's cases and lanes (phase 21's, plus the 64-lane main batch).
REVERSE_CASES = ("case14", "case_ieee30", "mesh118", "mesh2000")
REVERSE_LANES = (1, 3, MAIN_LANES)
#: A Function's kernel route against its plain route on the same card: the
#: same algorithm, its sums in another order.
ROUTE_KERNEL_RTOL = 1e-9
#: Route B (the implicit derivative at the last iterate) against the
#: unrolled plain gradient on lanes that converged; route A (the iterates
#: walked back) against the unrolled plain gradient.
ROUTE_B_RTOL = 1e-6
ROUTE_A_RTOL = 1e-9
#: The reference's gates: central differences, rtol 1e-4, atol 1e-8.
GATE_RTOL = 1e-4
GATE_ATOL = 1e-8
#: Timed turns of each full-width gradient (medians printed).
REVERSE_REPS = 3
#: Lanes of a sparse or krylov full-width batch whose unrolled plain
#: gradient is formed: autograd through every plain GMRES cycle keeps each
#: cycle's basis, which at mesh2000 × 256 would not fit the card.
UNROLLED_LANES = 8


def tie_5_8():
    """The reference's ``TIE_5_8`` (``tests/test_cim.py:18``): a tie from
    node 5 to node 8 of vvc_9bus with line code 0's impedance in pu."""
    from freedm_tpu_torch.grid.cases import Z_CODES_9BUS

    return (5, 8, Z_CODES_9BUS[0] / (1000.0 * 12.47**2 / 1000.0))


#: I2's lane counts at the CIM feeder in phase 27 (a): 3 and 65 give
#: ragged lane tiles.
I2_LANES = (1, 3, CIM_LANES, CIM_LANES + 1)
#: The iterations a CIM backward walks in phase 27 (the (c) solver's).
CIM_WALK_STEPS = 60


def cim_walk_inputs(torch, sol, f, ties, lanes, steps, dev, seed=27):
    """I2's walk operands at ``lanes`` lanes of feeder ``f``: ``(h, g, vs,
    s, mask)`` — the staged Aᴴ, a seeded masked cotangent, the iterates
    ``vs [steps + 1, 2, B, N]`` of ``steps`` fixed CIM iterations from the
    no-load profile at :func:`cim_loads`' loads (I1's plain version, saved
    as ``CimFixed`` saves them), the loads and the phase mask."""
    ops = _cim_operands(torch, f, ties, cim_loads(f, lanes), dev)
    a_re, a_im, _, _, s_re, s_im, vb_re, vb_im, mask = ops[:9]
    big_n = int(mask.shape[0])
    vs = torch.empty(steps + 1, 2, lanes, big_n, dtype=torch.float64,
                     device=dev)
    vs[0, 0], vs[0, 1] = vb_re, vb_im
    for k in range(steps):
        vs[k + 1, 0], vs[k + 1, 1] = sol.cim_iterate_plain(
            a_re, a_im, vs[k, 0], vs[k, 1], *ops[4:])
    rng = np.random.default_rng(seed)
    g = tuple(torch.as_tensor(rng.normal(size=(lanes, big_n)), device=dev)
              * mask for _ in range(2))
    return sol.cim_adjoint_matrix(a_re, a_im), g, vs, (s_re, s_im), mask


def compare_reverse_kernels(torch, sol, errs):
    """J2 in both modes, with and without status, at ``REVERSE_CASES`` ×
    ``REVERSE_LANES`` and I2 on vvc_9bus (:func:`tie_5_8`) × 64 and the CIM
    feeder × ``I2_LANES`` against their plain versions (``KERNEL_ATOL`` of
    the largest entry above 1), each bit-identical on repeat; I2's walk
    over ``CIM_WALK_STEPS`` saved iterates (:func:`cim_walk_inputs`) at the
    CIM feeder × 64 and vvc_9bus × 65 against the chained plain calls and
    bit for bit against the chained single calls of its kernel; J2's
    MASKED mode also against J1 by ``⟨w, J u⟩ = ⟨Jᵀ w, u⟩``."""
    from freedm_tpu_torch.grid.cases import vvc_9bus
    from freedm_tpu_torch.pf.cim import assemble_yabc
    from freedm_tpu_torch.pf.sparse import sparse_operands

    dev = torch.device("cuda")
    t0 = time.monotonic()
    worst = {"residual_vjp": 0.0, "cim_vjp": 0.0}
    dot_gap = 0.0
    for cname in REVERSE_CASES:
        sys_ = case_system(cname)
        n, m = sys_.n_bus, sys_.n_branch
        op = sparse_operands(sys_, device=dev)
        vop = sol.vjp_operands(op)
        for lanes in REVERSE_LANES:
            rng = np.random.default_rng(27 + lanes)

            def t(a):
                return torch.as_tensor(np.ascontiguousarray(a), device=dev)

            x = torch.cat([t(rng.normal(0, 0.1, (lanes, n))),
                           t(rng.uniform(0.95, 1.05, (lanes, n)))], 1)
            w = t(rng.normal(size=(lanes, 2 * n)))
            u = t(rng.normal(size=(lanes, 2 * n)))
            st = t(solver_status(sys_, lanes, 27))
            for mode in (sol.MASKED, sol.FULL):
                for s_ in (None, st):
                    tag = (f"J2 {cname} x{lanes} mode {mode} status "
                           f"{s_ is not None}")
                    k = sol.residual_vjp(x, w, op, vop, mode, s_)
                    again = sol.residual_vjp(x, w, op, vop, mode, s_)
                    p = sol.residual_vjp_plain(x, w, op, vop, mode, s_)
                    e = max_err(k, p) / max(1.0, float(p.abs().max()))
                    check(e <= KERNEL_ATOL, f"{tag}: {e:.3e} from its plain "
                          f"version")
                    check(same_bits(torch, k, again),
                          f"{tag}: not bit-identical on repeat")
                    worst["residual_vjp"] = max(worst["residual_vjp"], e)
                    if mode == sol.MASKED:
                        lhs = w * sol.residual_jvp(x, u, op, s_)
                        rhs = k * u
                        gap = float(((lhs.sum(1) - rhs.sum(1)).abs()
                                     / (lhs.abs().sum(1) + rhs.abs().sum(1)
                                        )).max())
                        check(gap <= 1e-12, f"{tag}: <w, J u> - <J^T w, u> "
                              f"{gap:.3e} relative")
                        dot_gap = max(dot_gap, gap)
    f9 = vvc_9bus()
    for f, ties, label, lane_counts in (
            (f9, [tie_5_8()], "vvc_9bus+tie", (CIM_LANES,)),
            (*cim_feeder(), "radial1000+ties", I2_LANES)):
        y, mask_np = assemble_yabc(f, ties)
        a_inv = np.linalg.inv(y[3:, 3:])
        mask = mask_np[1:].reshape(-1)
        big_n = 3 * f.n_branches
        h = sol.cim_adjoint_matrix(torch.as_tensor(a_inv.real, device=dev),
                                   torch.as_tensor(a_inv.imag, device=dev))
        mk = torch.as_tensor(mask, device=dev)
        for lanes in lane_counts:
            rng = np.random.default_rng(27)

            def lane_c(loc, scale):
                z = (rng.normal(loc, scale, (lanes, big_n))
                     + 1j * rng.normal(0.0, scale, (lanes, big_n))) * mask
                return (torch.as_tensor(z.real.copy(), device=dev),
                        torch.as_tensor(z.imag.copy(), device=dev))

            g, v, s = lane_c(0.0, 1.0), lane_c(1.0, 0.05), lane_c(0.0, 0.3)
            outs = []
            for fn in (sol.cim_vjp, sol.cim_vjp_plain, sol.cim_vjp):
                acc = [torch.full_like(v[0], 0.5) for _ in range(4)]
                outs.append((*fn(*h, *g, *v, *s, mk, *acc), *acc))
            for k, p, again in zip(*outs):
                e = max_err(k, p) / max(1.0, float(p.abs().max()))
                check(e <= KERNEL_ATOL, f"I2 {label} x{lanes}: {e:.3e} "
                      f"from its plain version")
                check(same_bits(torch, k, again),
                      f"I2 {label} x{lanes}: not bit-identical on repeat")
                worst["cim_vjp"] = max(worst["cim_vjp"], e)
    walk = {}
    for f, ties, label, lanes in (
            (f9, [tie_5_8()], "vvc_9bus+tie", CIM_LANES + 1),
            (*cim_feeder(), "radial1000+ties", CIM_LANES)):
        h, g, vs, s, mask = cim_walk_inputs(torch, sol, f, ties, lanes,
                                            CIM_WALK_STEPS, dev)
        args = (*h, *g, vs, *s, mask, CIM_WALK_STEPS)
        got, again = sol.cim_vjp_walk(*args), sol.cim_vjp_walk(*args)
        want = sol.cim_vjp_walk_plain(*args)
        # The same steps as single calls of the kernel: the same bits.
        chain = [torch.zeros_like(s[0]), torch.zeros_like(s[0]),
                 g[0].clone(), g[1].clone()]
        gk = g
        for k in reversed(range(CIM_WALK_STEPS)):
            gk = sol.cim_vjp(*h, *gk, vs[k, 0], vs[k, 1], *s, mask, *chain)
        tag = f"I2 walk {label} x{lanes} x{CIM_WALK_STEPS} steps"
        for k, p, a2, c in zip(got, want, again, chain):
            e = max_err(k, p) / max(1.0, float(p.abs().max()))
            check(e <= KERNEL_ATOL, f"{tag}: {e:.3e} from the chained plain "
                  f"calls")
            check(same_bits(torch, k, a2), f"{tag}: not bit-identical on "
                  f"repeat")
            check(same_bits(torch, k, c), f"{tag}: not the bits of "
                  f"{CIM_WALK_STEPS} chained single calls")
            worst["cim_vjp"] = max(worst["cim_vjp"], e)
            walk[label] = max(walk.get(label, 0.0), e)
    for name, e in worst.items():
        errs[name] = max(errs[name], e)
    log(f"reverse kernels: residual_vjp {worst['residual_vjp']:.2e}, cim_vjp "
        f"{worst['cim_vjp']:.2e} (max abs from the plain versions relative "
        f"to the largest entry above 1; I2 a call at the CIM feeder x "
        f"{list(I2_LANES)} and vvc_9bus+tie x{CIM_LANES}; the walk over "
        f"{CIM_WALK_STEPS} steps "
        + ", ".join(f"{k} {v:.2e}" for k, v in walk.items())
        + f" from the chained plain calls and the bits of the chained "
        f"kernel calls); <w, J1 u> = <J2 w, u> within "
        f"{dot_gap:.2e}; each bit-identical on repeat "
        f"({time.monotonic() - t0:.1f} s)")


def time_reverse_kernels(torch, sol, rows, extra):
    """J2 at the krylov lane batch's adjoint (bench_nr_2k_krylov_lanes:
    mesh2000 × 256, MASKED, its GMRES operator; FULL too) and I2 at the CIM
    feeder × 64 (phase 27 (c)'s backward), by CUDA events and device time,
    beside the plain versions, the bounds and the library rows: J2 against
    ``torch.sparse.mm`` of the transposed S1-assembled Jacobian, I2 against
    the complex ``torch.matmul`` of Aᴴ with the lanes' cotangents."""
    from freedm_tpu_torch.kernels import sparse_kernels as sk
    from freedm_tpu_torch.pf.cim import assemble_yabc
    from freedm_tpu_torch.pf.sparse import sparse_operands

    dev = torch.device("cuda")
    t0 = time.monotonic()
    sys2k = synthetic_mesh_bench(2000, 1.0)
    n, m = sys2k.n_bus, sys2k.n_branch
    lanes = KRYLOV_LANES
    op = sparse_operands(sys2k, device=dev)
    vop = sol.vjp_operands(op)
    rng = np.random.default_rng(5)
    x = torch.cat([torch.as_tensor(rng.normal(0, 0.1, (lanes, n)),
                                   device=dev),
                   torch.as_tensor(rng.uniform(0.95, 1.05, (lanes, n)),
                                   device=dev)], 1)
    w = torch.randn_like(x)
    # Device time by queued CUDA events, as K2's, F1's and I1's: the
    # profiler's came back at 0.0337 and 0.0764 ms in two runs of one tree.
    # Also at the sparse backward's 64 lanes, and on the wide route.
    k, k_dev = {}, {}
    x64_, w64_ = x[:MAIN_LANES].contiguous(), w[:MAIN_LANES].contiguous()
    wide = sol.residual_plan(n, m, lanes, torch.float64, False,
                             route=sol.WIDE)
    for mode in (sol.MASKED, sol.FULL):
        fn = (lambda md=mode: sol.residual_vjp(x, w, op, vop, md))
        k[mode] = time_ms(torch, fn, reps=100)
        k_dev[mode] = queued_events_ms(torch, fn, 50)
        fn = (lambda md=mode: sol.residual_vjp(x64_, w64_, op, vop, md))
        k[mode, MAIN_LANES] = time_ms(torch, fn, reps=100)
        k_dev[mode, MAIN_LANES] = queued_events_ms(torch, fn, 50)
        k_dev[mode, sol.WIDE] = queued_events_ms(
            torch, lambda md=mode: sol.residual_vjp(x, w, op, vop, md,
                                                    plan=wide), 50)
    plan = sol.residual_plan(n, m, lanes, torch.float64, False)
    plan_64 = sol.residual_plan(n, m, MAIN_LANES, torch.float64, False)
    p = time_ms(torch, lambda: sol.residual_vjp_plain(x, w, op, vop,
                                                      sol.MASKED), reps=3)

    def j2_bytes(b_lanes):
        return (8 * (3 * b_lanes * 2 * n + 6 * 2 * m + 4 * n)
                + 4 * (n + 1 + 4 * m))

    b_j2 = j2_bytes(lanes)
    o_j2 = lanes * (2 * m * 80 + n * 30)
    ps = torch.as_tensor(np.tile(sys2k.p_inj, (lanes, 1)), device=dev)
    ev, bv, _ = sk.sparse_assemble(x, ps, ps, op)
    csr_t = sparse_library_matvec(torch, op, ev, bv).to_sparse_coo().t() \
        .coalesce().to_sparse_csr()
    wcol = w.reshape(-1, 1)
    e_lib = rel_abs_err(torch, (csr_t @ wcol).reshape(lanes, 2 * n),
                        sol.residual_vjp(x, w, op, vop, sol.MASKED))[0]
    check(e_lib <= 1e-10, f"J2's library row computes another J^T w: {e_lib}")
    lib = time_ms(torch, lambda: csr_t @ wcol, reps=100)
    lib_dev = queued_events_ms(torch, lambda: csr_t @ wcol, 50)
    b, by = bound(b_j2, o_j2)
    rows["residual_vjp"] = (k[sol.MASKED], p, lib, b, by)
    extra["residual_vjp"] = {
        "device_ms": k_dev[sol.MASKED], "device_ms_source": "queued events",
        "plan": plan._asdict(), "library_device_ms": lib_dev,
        "shape": "mesh2000 x 256 (bench_nr_2k_krylov_lanes' adjoint), "
                 "float64, MASKED",
        "ms_full": k[sol.FULL], "device_ms_full": k_dev[sol.FULL],
        "ms_x64": k[sol.MASKED, MAIN_LANES],
        "device_ms_x64": k_dev[sol.MASKED, MAIN_LANES],
        "device_ms_full_x64": k_dev[sol.FULL, MAIN_LANES],
        "bound_ms_x64": bound(j2_bytes(MAIN_LANES),
                              o_j2 * MAIN_LANES // lanes)[0],
        "plan_x64": plan_64._asdict(),
        "wide_route_device_ms": k_dev[sol.MASKED, sol.WIDE],
        "wide_route_device_ms_full": k_dev[sol.FULL, sol.WIDE],
        "library": "torch.sparse.mm of the transposed S1-assembled "
                   "Jacobian (CSR, assembly and transpose excluded)"}
    log(f"timing: residual_vjp mesh2000 x{lanes} MASKED kernel "
        f"{k[sol.MASKED]:.4f} ms (device {k_dev[sol.MASKED]:.4f}, queued "
        f"events; {plan.lanes_per_cta} lanes a CTA), FULL {k[sol.FULL]:.4f} "
        f"ms (device {k_dev[sol.FULL]:.4f})  plain {p:.4f} ms  bound "
        f"{b:.4f} ms ({by})  library torch.sparse.mm of J^T {lib:.4f} ms "
        f"(device {lib_dev:.4f}); x{MAIN_LANES} MASKED {k[sol.MASKED, MAIN_LANES]:.4f} "
        f"ms (device {k_dev[sol.MASKED, MAIN_LANES]:.4f}; "
        f"{plan_64.ctas_per_lane} CTAs a lane), FULL device "
        f"{k_dev[sol.FULL, MAIN_LANES]:.4f}; the wide route at x{lanes} "
        f"device {k_dev[sol.MASKED, sol.WIDE]:.4f} / "
        f"{k_dev[sol.FULL, sol.WIDE]:.4f}")
    del csr_t, ev, bv

    f, ties = cim_feeder()
    y, mask_np = assemble_yabc(f, ties)
    a_inv = np.linalg.inv(y[3:, 3:])
    big_n = 3 * f.n_branches
    h = sol.cim_adjoint_matrix(torch.as_tensor(a_inv.real, device=dev),
                               torch.as_tensor(a_inv.imag, device=dev))
    mask = mask_np[1:].reshape(-1)
    s = cim_loads(f, CIM_LANES)
    sp = -(s.reshape(CIM_LANES, big_n) / f.s_base_per_phase_kva)
    vb = ((-a_inv @ y[3:, :3]) @ (np.array(
        [1.0, np.exp(-2j * np.pi / 3), np.exp(2j * np.pi / 3)])
        * f.v_source_pu)) * mask

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    g = rng.normal(size=(CIM_LANES, big_n)) * mask
    args = (*h, t(g), t(0.5 * g), t(np.tile(vb.real, (CIM_LANES, 1))),
            t(np.tile(vb.imag, (CIM_LANES, 1))), t(sp.real), t(sp.imag),
            t(mask), *(torch.zeros(CIM_LANES, big_n, dtype=torch.float64,
                                   device=dev) for _ in range(4)))
    k2 = time_ms(torch, lambda: sol.cim_vjp(*args), reps=20)
    k2_dev = queued_events_ms(torch, lambda: sol.cim_vjp(*args), 20)
    p2 = time_ms(torch, lambda: sol.cim_vjp_plain(*args), reps=3)
    hc = torch.complex(h[0], h[1])
    gc = torch.complex(args[2], args[3]).T.contiguous()
    lib2 = time_ms(torch, lambda: torch.matmul(hc, gc), reps=20)
    lib2_dev = queued_events_ms(torch, lambda: torch.matmul(hc, gc), 20)
    b_i2 = 8 * (2 * big_n * big_n + CIM_LANES * big_n * 16 + big_n)
    o_i2 = 8 * CIM_LANES * big_n * big_n
    b2, by2 = bound(b_i2, o_i2, tensor=True)
    del hc, gc
    # The walk over a backward's saved iterates, beside the same steps as
    # single calls in a row (one launch each, as before the walk).
    hw, gw, vs, sw, mw = cim_walk_inputs(torch, sol, f, ties, CIM_LANES,
                                         CIM_WALK_STEPS, dev)
    walk = queued_events_ms(torch, lambda: sol.cim_vjp_walk(
        *hw, *gw, vs, *sw, mw, CIM_WALK_STEPS), 10)
    acc = [torch.zeros_like(sw[0]) for _ in range(4)]

    def chained():
        gk = gw
        for k in reversed(range(CIM_WALK_STEPS)):
            gk = sol.cim_vjp(*hw, *gk, vs[k, 0], vs[k, 1], *sw, mw, *acc)

    chain = queued_events_ms(torch, chained, 5)
    del hw, gw, vs, sw, mw, acc
    rows["cim_vjp"] = (k2, p2, lib2, b2, by2)
    extra["cim_vjp"] = {
        "device_ms": k2_dev, "device_ms_source": "queued events",
        "shape": f"synthetic_radial(1000) + {CIM_TIES} ties x {CIM_LANES}",
        "library": "complex128 torch.matmul of A^H with the lanes' "
                   "cotangents alone",
        "library_device_ms": lib2_dev,
        "bound_ms_bytes": b_i2 / PEAK_BYTES * 1e3,
        "walk_steps": CIM_WALK_STEPS, "walk_device_ms": walk,
        "walk_device_ms_an_iteration": walk / CIM_WALK_STEPS,
        "chained_calls_device_ms": chain,
        "walk_plan": sol.cim_walk_plan(big_n, CIM_LANES)._asdict()}
    log(f"timing: cim_vjp radial1000+ties x{CIM_LANES} kernel {k2:.4f} ms "
        f"(device {k2_dev:.4f}, queued events)  plain {p2:.4f} ms  bound "
        f"{b2:.4f} ms ({by2})  library complex matmul {lib2:.4f} ms (device "
        f"{lib2_dev:.4f}); the walk over {CIM_WALK_STEPS} iterations device "
        f"{walk:.4f} ms = {walk / CIM_WALK_STEPS:.4f} ms an iteration, "
        f"{CIM_WALK_STEPS} single calls in a row {chain:.4f} ms "
        f"({time.monotonic() - t0:.1f} s timings)")


def fd_gate(label, grad, loss, base, points, h):
    """Central differences of ``loss`` around ``base`` at ``points``
    against ``grad`` (the reference's gates: ``GATE_RTOL``,
    ``GATE_ATOL``)."""
    worst = 0.0
    for idx in points:
        e = np.zeros(base.shape)
        e[idx] = h
        fd = (loss(base + e) - loss(base - e)) / (2 * h)
        g = float(grad[idx])
        gap = abs(g - fd)
        check(gap <= GATE_ATOL + GATE_RTOL * abs(fd),
              f"{label} gate at {idx}: gradient {g:.10e}, central "
              f"difference {fd:.10e}")
        worst = max(worst, gap / max(abs(fd), 1e-300))
    return worst


def reverse_gates(torch, sol):
    """The reference's three gradient gates and FDLF's on the card (the
    kernel routes, ``adjoint`` left to its default): dense Newton
    ``synthetic_mesh(20, seed=10)`` 8 iterations, total losses, at the
    gradient's largest coordinate (step 1e-6); the krylov solver on
    ``synthetic_mesh(120, seed=4, load_mw=2.0, chord_frac=1.0)``, 6
    iterations, inner 16, slack P at 3, 47 and 101 (step 1e-5); the CIM on
    vvc_9bus with ``TIE_5_8``, 80 iterations, the voltage-profile loss at
    (1, 0), (4, 2), (7, 1) (step 1e-3); FDLF on case_ieee30, 30
    iterations, slack P at 5, 11 and 20 (step 1e-5)."""
    from freedm_tpu_torch.cplx import C
    from freedm_tpu_torch.grid.cases import synthetic_mesh, vvc_9bus
    from freedm_tpu_torch.pf.cim import make_cim_solver
    from freedm_tpu_torch.pf.fdlf import make_fdlf_solver
    from freedm_tpu_torch.pf.krylov import make_krylov_solver
    from freedm_tpu_torch.pf.newton import branch_flows, make_newton_solver

    dev = torch.device("cuda")
    t0 = time.monotonic()
    out = {}

    def grad_of(loss, a):
        t = torch.as_tensor(a, device=dev).clone().requires_grad_(True)
        (g,) = torch.autograd.grad(loss(t), t)
        return g.cpu().numpy()

    sys_ = synthetic_mesh(20, seed=10)
    _, fixed = make_newton_solver(sys_, max_iter=8, device=dev)

    def losses(q):
        s_f, s_t = branch_flows(sys_, fixed(q_inj=q))
        return (s_f[0] + s_t[0]).sum()

    q0 = sys_.q_inj[None].copy()
    g = grad_of(losses, q0)
    i = int(np.argmax(np.abs(g)))
    out["dense"] = fd_gate("dense", g, lambda q: float(losses(q)), q0,
                           [(0, i)], 1e-6)

    s120 = synthetic_mesh(120, seed=4, load_mw=2.0, chord_frac=1.0)
    _, fixed = make_krylov_solver(s120, max_iter=6, inner_iters=16,
                                  precision="f64", device=dev)

    def slack_p(q):
        return fixed(q_inj=q).p[0, s120.slack]

    q0 = s120.q_inj[None].copy()
    out["krylov"] = fd_gate("krylov", grad_of(slack_p, q0),
                            lambda q: float(slack_p(q)), q0,
                            [(0, 3), (0, 47), (0, 101)], 1e-5)

    f9 = vvc_9bus()
    _, fixed = make_cim_solver(f9, ties=[tie_5_8()], max_iter=80,
                               device=dev)
    p0 = torch.as_tensor(f9.s_load.real, device=dev)

    def profile_loss(q):
        v = fixed(C(p0, torch.as_tensor(q, device=dev))).v_node
        return (((v.re ** 2 + v.im ** 2)[1:] - 1.0) ** 2).sum()

    q0 = f9.s_load.imag.copy()
    out["cim"] = fd_gate("cim", grad_of(profile_loss, q0),
                         lambda q: float(profile_loss(q)), q0,
                         [(1, 0), (4, 2), (7, 1)], 1e-3)

    s30 = case_system("case_ieee30")
    _, fixed = make_fdlf_solver(s30, max_iter=30, device=dev)

    def slack30(q):
        return fixed(q_inj=q).p[0, s30.slack]

    q0 = s30.q_inj[None].copy()
    g = grad_of(slack30, q0)
    out["fdlf"] = fd_gate("fdlf", g, lambda q: float(slack30(q)), q0,
                          [(0, 5), (0, 11), (0, 20)], 1e-5)
    log(f"reverse gates: dense, krylov, cim, fdlf gradients on the card "
        f"against central differences (rtol {GATE_RTOL}, atol {GATE_ATOL}): "
        + ", ".join(f"{k} {v:.2e}" for k, v in out.items())
        + f" worst relative gap; fdlf d(slack P)/d(q_inj[5]) {g[0, 5]:.10f} "
          f"({time.monotonic() - t0:.1f} s)")


def _gradient(torch, fn, args):
    ts = [a.clone().requires_grad_(True) for a in args]
    return torch.autograd.grad(fn(*ts), ts)


def _rel_gap(torch, got, want, rows=None):
    gap = 0.0
    for g, w in zip(got, want):
        if rows is not None:
            g, w = g[rows], w[rows]
        scale = float(w.abs().max())
        gap = max(gap, float((g - w).abs().max()) / max(scale, 1e-300))
    return gap


def reverse_full_width(torch, sol):
    """(c): each solver's ``solve_fixed`` gradient at the reference bench's
    shapes — dense ``bench_n1_118``, sparse mesh2000 × 64 f64 and mixed,
    krylov ``bench_nr_2k_krylov_lanes`` (f64), FDLF mesh2000 × 16 and the
    CIM feeder × 64 — the kernel route against the plain route (rtol
    ``ROUTE_KERNEL_RTOL``) and against the unrolled plain gradient (route B
    on converged lanes, ``ROUTE_B_RTOL``, on ``UNROLLED_LANES`` lanes of the
    sparse and krylov batches; route A ``ROUTE_A_RTOL``), every entry
    finite; forward and backward ms by CUDA events, their ratio, the
    adjoint GMRES cycles, J2 and I2 launches a backward and the peak memory
    of the forward that saves (medians of ``REVERSE_REPS`` turns after a
    warm forward and backward).  Returns each kernel's launches over its
    main path's backward."""
    from freedm_tpu_torch.cplx import C
    from freedm_tpu_torch.pf import adjoint as adj
    from freedm_tpu_torch.pf.cim import make_cim_solver
    from freedm_tpu_torch.pf.fdlf import make_fdlf_solver
    from freedm_tpu_torch.pf.krylov import (build_fdlf_precond,
                                            make_krylov_solver)
    from freedm_tpu_torch.pf.newton import make_newton_solver
    from freedm_tpu_torch.pf.sparse import make_sparse_newton_solver

    dev = torch.device("cuda")
    t_phase = time.monotonic()
    counts, rows = {}, {}

    def events_ms(fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        return out, a.elapsed_time(b)

    def run(label, make, loss, args, kernel, route_rtol, lane_rows=None,
            converged=None, gmres=False, share=False):
        t0 = time.monotonic()
        # The Function's kernel route (the default on the card; named here
        # so that a CPU rehearsal takes it too).
        fixed = make(plain=False, adjoint=True)
        _gradient(torch, lambda *t: loss(fixed, *t), args)  # warm
        fwd, fwd_g, bwd = [], [], []
        for _ in range(REVERSE_REPS):
            with torch.no_grad():
                fwd.append(events_ms(lambda: loss(fixed, *args))[1])
            ts = [a.clone().requires_grad_(True) for a in args]
            torch.cuda.synchronize()
            base_mem = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            val, ms = events_ms(lambda: loss(fixed, *ts))
            fwd_g.append(ms)
            peak = torch.cuda.max_memory_allocated() - base_mem
            sol.reset_launches()
            got, ms = events_ms(lambda: torch.autograd.grad(val, ts))
            launched = sol.launches()
            routes = sol.route_launches().get(kernel)
            bwd.append(ms)
        fwd_ms, fwd_g_ms, bwd_ms = (float(np.median(t))
                                    for t in (fwd, fwd_g, bwd))
        check(launched[kernel] > 0,
              f"{label}: {kernel} launched {launched[kernel]} times")
        check(all(bool(torch.isfinite(g).all()) for g in got),
              f"{label}: a non-finite gradient entry")
        cycles = dict(adj.ADJOINT_STATS)
        want = _gradient(torch, lambda *t: loss(
            make(plain=True, adjoint=True), *t), args)
        gap_route = _rel_gap(torch, got, want)
        check(gap_route <= ROUTE_KERNEL_RTOL,
              f"{label}: kernel route {gap_route:.3e} from the plain route")
        sub = args if lane_rows is None else [a[lane_rows] for a in args]
        unrolled = _gradient(torch, lambda *t: loss(
            make(plain=True, adjoint=False), *t), sub)
        mine = got if lane_rows is None else [g[lane_rows] for g in got]
        keep = None if converged is None else converged(sub)
        gap_unrolled = _rel_gap(torch, mine, unrolled, keep)
        check(gap_unrolled <= route_rtol,
              f"{label}: {gap_unrolled:.3e} from the unrolled plain gradient")
        counts[label] = launched[kernel]
        rows[label] = dict(fwd_ms=fwd_ms, fwd_save_ms=fwd_g_ms,
                           bwd_ms=bwd_ms, ratio=bwd_ms / fwd_ms,
                           launches=launched[kernel], peak_bytes=peak)
        if routes is not None:
            rows[label]["launches_by_route"] = routes
        extra = ""
        if gmres:
            rows[label].update(adjoint_cycles=cycles["cycles"],
                               adjoint_residual=cycles["residual"])
            extra = (f", adjoint GMRES {cycles['cycles']} cycles (residual "
                     f"{cycles['residual']:.1e})")
        if share:  # J2's device time in one profiled backward
            ts = [a.clone().requires_grad_(True) for a in args]
            val = loss(fixed, *ts)
            profile_solve(torch, lambda: torch.autograd.grad(val, ts),
                          f"reverse (c) {label} backward", top=6)
            j2_ms, j2_share = residual_share(True)
            rows[label].update(j2_device_ms=j2_ms,
                               busy_ms=LAST_PROFILE["busy_ms"])
            extra += (f", J2 {j2_ms:.2f} ms of the backward's "
                      f"{LAST_PROFILE['busy_ms']:.2f} ms device busy "
                      f"({100 * j2_share:.1f}%)")
        log(f"reverse (c) {label}: forward {fwd_ms:.2f} ms (saving "
            f"{fwd_g_ms:.2f} ms, peak {peak / 2**20:.1f} MiB above the "
            f"inputs), backward {bwd_ms:.2f} ms, backward/forward "
            f"{bwd_ms / fwd_ms:.2f}; {kernel} {launched[kernel]} launches a "
            f"backward{extra}; kernel route {gap_route:.2e} from the plain "
            f"route, {gap_unrolled:.2e} from the unrolled plain gradient"
            + ("" if lane_rows is None else f" ({len(lane_rows)} lanes)")
            + f" ({time.monotonic() - t0:.1f} s)")

    def newton_loss(fixed, p, q):
        r = fixed(p_inj=p, q_inj=q)
        return ((r.v ** 2).sum() + r.p[:, 0].sum() + (r.q ** 2).sum()
                + torch.sin(r.theta).sum())

    def pq(sys_, lanes, seed):
        scale = np.random.default_rng(seed).uniform(0.9, 1.1, (lanes, 1))
        return (torch.as_tensor(scale * sys_.p_inj[None], device=dev),
                torch.as_tensor(scale * sys_.q_inj[None], device=dev))

    # Dense: bench_n1_118, mesh118 x 118 outage lanes with per-lane status.
    sys118 = case_system("mesh118")
    st118 = n1_118_status(sys118)

    def make_dense(plain, adjoint):
        fixed = make_newton_solver(sys118, max_iter=6, device=dev,
                                   plain=plain, adjoint=adjoint)[1]
        return lambda **kw: fixed(status=st118, **kw)

    p, q = pq(sys118, N1_118_LANES, 1)
    with torch.no_grad():
        conv = make_dense(False, False)(p_inj=p, q_inj=q).converged
    run("dense bench_n1_118", make_dense, newton_loss, (p, q),
        "residual_vjp", ROUTE_B_RTOL, converged=lambda sub: conv)

    # Sparse: mesh2000 x 64, f64 and mixed.
    sys2k = synthetic_mesh_bench(2000, 1.0)
    pc = build_fdlf_precond(sys2k, device=dev)
    sub = list(range(0, MAIN_LANES, MAIN_LANES // UNROLLED_LANES))
    p, q = pq(sys2k, MAIN_LANES, 2)
    for prec in ("f64", "mixed"):
        def make_sparse(plain, adjoint, prec=prec):
            return make_sparse_newton_solver(
                sys2k, precision=prec, precond=pc, device=dev, plain=plain,
                adjoint=adjoint)[1]

        with torch.no_grad():
            conv = make_sparse(False, False)(p_inj=p, q_inj=q).converged
        check(bool(conv.all()), f"sparse {prec}: a lane did not converge")
        run(f"sparse mesh2000 x{MAIN_LANES} {prec}", make_sparse,
            newton_loss, (p, q), "residual_vjp", ROUTE_B_RTOL,
            lane_rows=sub, gmres=True, share=prec == "f64")

    # Krylov: bench_nr_2k_krylov_lanes, mesh2000 x 256, f64.
    p, q = pq(sys2k, KRYLOV_LANES, 0)
    sub = list(range(0, KRYLOV_LANES, KRYLOV_LANES // UNROLLED_LANES))

    def make_krylov(plain, adjoint):
        return make_krylov_solver(sys2k, max_iter=8, inner_iters=16,
                                  precision="f64", precond=pc, device=dev,
                                  plain=plain, adjoint=adjoint)[1]

    with torch.no_grad():
        conv = make_krylov(False, False)(p_inj=p, q_inj=q).converged
    check(bool(conv.all()), "krylov: a lane did not converge")
    run(f"krylov bench_nr_2k_krylov_lanes x{KRYLOV_LANES} f64", make_krylov,
        newton_loss, (p, q), "residual_vjp", ROUTE_B_RTOL, lane_rows=sub,
        gmres=True, share=True)

    # FDLF: mesh2000 x 16, one Ybus (F1's tile mode), 30 iterations.
    p, q = pq(sys2k, 16, 3)

    def make_fdlf(plain, adjoint):
        return make_fdlf_solver(sys2k, max_iter=30, device=dev, plain=plain,
                                adjoint=adjoint)[1]

    run("fdlf mesh2000 x16", make_fdlf, newton_loss, (p, q), "residual_vjp",
        ROUTE_A_RTOL)

    # The CIM feeder x 64, 60 iterations.
    f, ties = cim_feeder()
    s = cim_loads(f, CIM_LANES)

    def make_cim(plain, adjoint):
        return make_cim_solver(f, ties=ties, max_iter=60, device=dev,
                               plain=plain, adjoint=adjoint)[1]

    def cim_loss(fixed, p, q, vs):
        v = fixed(C(p, q), vs).v_node
        return ((v.re ** 2 + v.im ** 2 - 1.0) ** 2).sum()

    run(f"cim radial1000+ties x{CIM_LANES}", make_cim, cim_loss,
        (torch.as_tensor(s.real, device=dev),
         torch.as_tensor(s.imag, device=dev),
         torch.full((CIM_LANES,), 1.02, dtype=torch.float64, device=dev)),
        "cim_vjp", ROUTE_A_RTOL)
    torch.cuda.empty_cache()
    log(f"reverse: phase 27 (c) {time.monotonic() - t_phase:.1f} s")
    return counts, rows


def reverse_phase(torch, sol, errs, rows, extra):
    """Phase 27: the kernels against their plain versions, their times,
    the gates and the full-width gradients; returns J2's and I2's launches
    over their main paths' backward."""
    t27 = time.monotonic()
    compare_reverse_kernels(torch, sol, errs)
    j2_routes = compare_residual_routes(torch, sol, True)
    errs["residual_vjp"] = max(errs["residual_vjp"],
                               j2_routes[torch.float64])
    time_reverse_kernels(torch, sol, rows, extra)
    extra["residual_vjp"]["max_abs_err_f32"] = j2_routes[torch.float32]
    reverse_gates(torch, sol)
    counts, full = reverse_full_width(torch, sol)
    krylov = f"krylov bench_nr_2k_krylov_lanes x{KRYLOV_LANES} f64"
    cim = f"cim radial1000+ties x{CIM_LANES}"
    extra["residual_vjp"].update(
        launches_path=f"reverse phase (c): the {krylov} backward",
        backward=full)
    extra["cim_vjp"].update(launches_path=f"reverse phase (c): the {cim} "
                            "backward", backward=full[cim])
    check(counts[cim] == 1, f"{cim}: I2 launched {counts[cim]} times a "
          f"backward, not once")
    routes = full[krylov]["launches_by_route"]
    check(routes[sol.STAGED] == counts[krylov],
          f"{krylov}: J2 launched {routes} by route, not all staged")
    i2 = extra["cim_vjp"]
    log(f"reverse (c) I2: a call {i2['device_ms']:.4f} ms, an iteration in "
        f"the walk {i2['walk_device_ms_an_iteration']:.4f} ms (queued "
        f"events), {counts[cim]} launch a backward, the library row "
        f"{i2['library_device_ms']:.4f} ms; the {cim} backward/forward "
        f"{full[cim]['ratio']:.2f}")
    log(f"reverse: phase 27 {time.monotonic() - t27:.1f} s")
    return {"residual_vjp": counts[krylov], "cim_vjp": counts[cim]}


# ---------------------------------------------------------------------------
# Phase 28: the dense and doubling ladder forms (L3, L4), the source
# phasors' cotangent of every ladder reverse mode, B1's WIDE form
# ---------------------------------------------------------------------------

FORM_LANES = MAIN_LANES
FORM_ITERS = 20
#: The feeders of each form: the served vvc_9bus, 2048 branches (the
#: largest feeder that compiles a subtree matrix) and, for L4, the
#: reference's 10k-bus path.
FORM_CASES = {"dense": ("vvc_9bus", "radial2048"),
              "doubling": ("vvc_9bus", "radial2048", "radial10k")}
WIDE_ROUNDS = 64
WIDE_SHAPES = ((1 << 15, 4), (40961, 1), (1 << 16, 1))
#: One fleet of the first power of two above B1's cluster capacity, over
#: two rounds: the one-CTA device-memory form (WIDE).
WIDE_ABOVE_ROUNDS = 2
WIDE_GROUP = 512


def form_feeders():
    """Phase 28's feeders.  At its default load every lane of
    ``synthetic_radial(2048, seed=0)`` is in voltage collapse (no version
    converges, ``radial2048_collapse``); the compared one carries 1 kW a
    load, as the 10k feeder does."""
    from freedm_tpu_torch.grid import cases

    return {"vvc_9bus": cases.vvc_9bus(),
            "radial2048": cases.synthetic_radial(2048, seed=0, load_kw=1.0),
            "radial10k": cases.synthetic_radial(10000, seed=0, load_kw=1.0),
            "radial2048_collapse": cases.synthetic_radial(2048, seed=0)}


def compare_forms(torch, errs, dev="cuda"):
    """(a) L3 and L4 through ``make_ladder_solver(sweep_method=...)``
    against their ``plain=True`` twins at ``FORM_CASES`` × 64 lanes ×
    {solve, solve_fixed} × {float64, float32}: ``LADDER_ATOL`` on converged
    lanes, equal flags (float32: outside ``F32_FLAG_ULPS`` of eps) and, in
    float64, equal iterations; L4's bits against its plain version's
    (required in both dtypes); bit-identical on repeat; a lane's bits the same
    in launches of 1 and 64 lanes; the default-load 2048 feeder (every lane
    in collapse) with equal flags and iterations."""
    from freedm_tpu_torch.pf.ladder import make_ladder_solver

    t0 = time.monotonic()
    feeders = form_feeders()
    worst = {}
    for form, names in FORM_CASES.items():
        for name in names:
            f = feeders[name]
            loads = lane_loads(f, FORM_LANES)
            root = torch.as_tensor(f.parent < 0, device=dev)
            for dtype in (torch.float64, torch.float32):
                dn = str(dtype).split(".")[-1]
                kern = make_ladder_solver(f, dtype=dtype, sweep_method=form,
                                          device=dev)
                plain = make_ladder_solver(f, dtype=dtype, sweep_method=form,
                                           device=dev, plain=True)
                bits, its = [], set()
                for mode, label in ((0, "solve"), (1, "solve_fixed")):
                    where = f"forms {form} {name} {dn} x{FORM_LANES} {label}"
                    a, a2 = kern[mode](loads), kern[mode](loads)
                    p = plain[mode](loads)
                    sync(torch, dev)
                    clear = torch.ones_like(p.converged)
                    if dn == "float32":
                        i_root = p.i_branch.abs()[:, root].flatten(1).amax(1)
                        band = F32_FLAG_ULPS * torch.finfo(dtype).eps * i_root
                        clear = (p.residual - LADDER_EPS).abs() > band
                    check(torch.equal(a.converged[clear], p.converged[clear]),
                          f"{where}: converged flags differ")
                    conv = a.converged & p.converged
                    check(bool(conv.all()), f"{where}: "
                          f"{int((~conv).sum())} lanes did not converge")
                    gap = float(lane_gaps(torch, a, p).max())
                    check(gap <= LADDER_ATOL[dn],
                          f"{where}: {gap:.3e} from the plain version")
                    check(dn == "float32"
                          or torch.equal(a.iterations, p.iterations),
                          f"{where}: iterations differ")
                    check(ladder_same_bits(torch, a, a2),
                          f"{where}: not bit-identical on repeat")
                    same = ladder_same_bits(torch, a, p)
                    check(form == "dense" or same,
                          f"{where}: L4 is not its plain version's bits")
                    bits.append(same)
                    its.update(a.iterations.tolist())
                    key = f"{form}_{dn}"
                    worst[key] = max(worst.get(key, 0.0), gap)
                log(f"forms (a): {form:<8} {name:<10} (nb {f.n_branches}) "
                    f"{dn} x{FORM_LANES} solve/fixed: iterations {min(its)}-"
                    f"{max(its)}, flags equal, bit-identical on repeat, "
                    f"{worst[f'{form}_{dn}']:.2e} worst so far; the plain "
                    f"version's bits: {bits}")
            # A lane's bits do not depend on the lanes beside it (the
            # kernels'; a CPU rehearsal's BLAS may sum otherwise).
            for mode in (0, 1) if dev == "cuda" else ():
                solve = make_ladder_solver(f, sweep_method=form,
                                           device=dev)[mode]
                wide = solve(loads)
                for k in (0, FORM_LANES - 1):
                    one = solve(loads[k:k + 1])
                    sync(torch, dev)
                    check(all(torch.equal(getattr(getattr(one, fl), pt)[0],
                                          getattr(getattr(wide, fl), pt)[k])
                              for fl in ("v_node", "i_branch", "i_load")
                              for pt in ("re", "im")),
                          f"forms {form} {name}: lane {k} differs in a "
                          f"launch of 1 lane")
    f = feeders["radial2048_collapse"]
    loads = lane_loads(f, FORM_LANES)
    for form in FORM_CASES:
        kern = make_ladder_solver(f, sweep_method=form, device=dev)[0]
        plain = make_ladder_solver(f, sweep_method=form, device=dev,
                                   plain=True)[0]
        a, p = kern(loads), plain(loads)
        sync(torch, dev)
        check(torch.equal(a.converged, p.converged)
              and torch.equal(a.iterations, p.iterations),
              f"forms {form} radial2048 at its default load: flags or "
              f"iterations differ")
        check(form == "dense" or ladder_same_bits(torch, a, p),
              "forms doubling radial2048 at its default load: not the plain "
              "version's bits")
        log(f"forms (a): {form} synthetic_radial(2048, seed=0) at its default "
            f"load x{FORM_LANES}: {int(a.converged.sum())} lanes converge "
            f"(voltage collapse), flags and iterations equal"
            + ("" if form == "dense" else ", the plain version's bits"))
    errs["ladder_dense"] = worst["dense_float64"]
    errs["ladder_doubling"] = worst["doubling_float64"]
    log(f"forms (a): max |kernel - plain| L3 f64 {worst['dense_float64']:.3e}"
        f" f32 {worst['dense_float32']:.3e}, L4 f64 "
        f"{worst['doubling_float64']:.3e} f32 {worst['doubling_float32']:.3e}"
        f" ({time.monotonic() - t0:.1f} s)")
    return worst


def compare_doubling_routes(torch, lk, dev="cuda"):
    """L4's two routes (``lk.doubling_plan``) against its plain version
    bit for bit at its cluster capacity in each dtype (the cluster route)
    and one branch above (one CTA a lane), x 2 lanes: a fixed solve saving
    its iterates, a solve and the reverse mode on seeded cotangents."""
    from freedm_tpu_torch.grid import cases

    t0 = time.monotonic()
    rng = np.random.default_rng(21)
    for dtype in (torch.float64, torch.float32):
        dn = str(dtype).split(".")[-1]
        cap = lk.doubling_capacity(dtype)
        routes = []
        for nb in (cap, cap + 1):
            f = cases.synthetic_radial(nb, seed=4, load_kw=1.0)
            s, v0 = form_inputs(torch, f, 2, dtype, dev)
            op = lk.doubling_operands(f, dtype, torch.device(dev))
            routes.append(lk.doubling_plan(nb, dtype).route)
            where = f"L4 nb={nb} {dn} ({routes[-1]})"
            for fixed in (True, False):
                a = lk.ladder_doubling(s, v0, op, LADDER_EPS, FORM_ITERS,
                                       fixed, save=fixed)
                p = lk.ladder_doubling_plain(s, v0, op, LADDER_EPS,
                                             FORM_ITERS, fixed, save=fixed)
                sync(torch, dev)
                check(all(torch.equal(getattr(getattr(a, k), q),
                                      getattr(getattr(p, k), q))
                          for k in ("v", "i_branch", "i_load")
                          for q in ("re", "im"))
                      and torch.equal(a.iterations, p.iterations)
                      and (not fixed or torch.equal(a.saved, p.saved)),
                      f"{where} fixed={fixed}: not the plain version's bits")
                if fixed:
                    gs = _cotangents(torch, rng, 2, nb, dtype, dev)
                    got = _flat_vjp(lk.ladder_doubling_vjp(a.saved, s, op,
                                                           *gs))
                    want = _flat_vjp(lk.ladder_doubling_vjp_plain(
                        a.saved, s, op, *gs))
                    sync(torch, dev)
                    check(all(torch.equal(g, w) for g, w in zip(got, want)),
                          f"{where}: the reverse mode is not the plain "
                          f"version's bits")
        check(routes == ["cluster", "cta"],
              f"L4 {dn} at its capacity {cap} and one above: {routes}")
        log(f"forms (a): L4 {dn} at its cluster capacity {cap} ({routes[0]})"
            f" and {cap + 1} ({routes[1]}) x2: fixed, solve and reverse "
            f"mode the plain version's bits")
    log(f"forms (a): L4's routes {time.monotonic() - t0:.1f} s")


def form_grads(torch, f, form, loads, vs, dev, plain):
    """The lanes' summed total loss and its gradient in (Q, vs) through
    ``solve_fixed``."""
    from freedm_tpu_torch.pf.ladder import make_ladder_solver, total_loss_kw

    _, fixed = make_ladder_solver(f, sweep_method=form, device=dev,
                                  plain=plain)
    p = torch.as_tensor(loads.real, dtype=torch.float64, device=dev)
    q = torch.as_tensor(loads.imag, dtype=torch.float64,
                        device=dev).clone().requires_grad_(True)
    v = torch.as_tensor(vs, dtype=torch.float64,
                        device=dev).clone().requires_grad_(True)
    loss = total_loss_kw(f, fixed((p, q), v)).sum()
    gq, gv = torch.autograd.grad(loss, (q, v))
    return float(loss.detach()), gq, gv


def compare_form_vjps(torch, extra, dev="cuda"):
    """(b) Each form's reverse mode through ``solve_fixed`` — L3 and L4, and
    L2 on the Euler form — against ``torch.autograd`` of its plain fixed
    solve, in the loads and in ``v_source_pu`` (per lane), at vvc_9bus ×
    {1, 64} and the larger feeders × {1, 8} (rtol ``GRAD_RTOL``, atol
    ``GRAD_ATOL``); then central differences in ``v_source_pu`` (step 1e-6)
    and in three live loads (step 1e-3 kvar) on the 10k feeder × 1 (L4, L2)
    and the 2048-branch feeder × 1 (L3), relative ``FD_REL``."""
    t0 = time.monotonic()
    feeders = form_feeders()
    worst = {}
    cases = {"dense": FORM_CASES["dense"],
             "doubling": FORM_CASES["doubling"],
             "euler": ("vvc_9bus", "radial10k")}
    for form, names in cases.items():
        for name in names:
            t1 = time.monotonic()
            f = feeders[name]
            # The plain versions' autograd at 64 lanes of the large
            # feeders costs minutes; 8 lanes there.
            for lanes in (1, FORM_LANES if f.n_branches < 100 else 8):
                loads = lane_loads(f, lanes)
                vs = np.linspace(0.98, 1.04, lanes)
                _, gq, gv = form_grads(torch, f, form, loads, vs, dev, False)
                _, wq, wv = form_grads(torch, f, form, loads, vs, dev, True)
                sync(torch, dev)
                for g, w, what in ((gq, wq, "loads"), (gv, wv, "v_source")):
                    check(bool(torch.isfinite(g).all()),
                          f"vjp {form} {name}: non-finite")
                    excess = float(((g - w).abs()
                                    - GRAD_RTOL * w.abs()).max())
                    check(excess <= GRAD_ATOL,
                          f"vjp {form} {name} x{lanes} {what}: beyond rtol "
                          f"{GRAD_RTOL} by {excess:.3e}")
                    rel = float((g - w).abs().max() / w.abs().max())
                    worst[(form, what)] = max(worst.get((form, what), 0.0),
                                              rel)
            log(f"forms (b): {form} {name} x1/x{lanes}: the gradient in "
                f"the loads and in v_source_pu within rtol {GRAD_RTOL} of "
                f"autograd of the plain fixed solve "
                f"({time.monotonic() - t1:.1f} s)")
    from freedm_tpu_torch.pf.ladder import make_ladder_solver, total_loss_kw

    for form, name in (("doubling", "radial10k"), ("euler", "radial10k"),
                       ("dense", "radial2048")):
        f = feeders[name]
        loads = f.s_load[None].copy()
        vs = np.array([f.v_source_pu])
        _, gq, gv = form_grads(torch, f, form, loads, vs, dev, False)
        fixed = make_ladder_solver(f, sweep_method=form, device=dev)[1]

        def loss_at(l, v, f=f, fixed=fixed):
            return float(total_loss_kw(f, fixed(l, torch.as_tensor(
                v, dtype=torch.float64, device=dev))).sum())

        h = 1e-6
        fd = (loss_at(loads, vs + h) - loss_at(loads, vs - h)) / (2 * h)
        rel = abs(fd - float(gv[0])) / max(abs(fd), 1e-30)
        check(rel <= FD_REL, f"vjp {form} {name} x1: d/dv_source "
              f"{float(gv[0]):.9e} vs central difference {fd:.9e}")
        out = [f"v_source {float(gv[0]):.9e} (cd {fd:.9e}, rel {rel:.1e})"]
        live = np.argwhere(f.phase_mask > 0)
        for idx in (live[0], live[len(live) // 2], live[-1]):
            e = np.zeros_like(loads)
            e[0, idx[0], idx[1]] = 1e-3j
            fd = (loss_at(loads + e, vs) - loss_at(loads - e, vs)) / 2e-3
            g = float(gq[0, idx[0], idx[1]])
            rel = abs(fd - g) / max(abs(fd), 1e-30)
            check(rel <= FD_REL, f"vjp {form} {name} x1 dq{tuple(idx)}: "
                  f"{g:.9e} vs central difference {fd:.9e}")
            out.append(f"dq{tuple(int(i) for i in idx)} {g:.6e} (rel "
                       f"{rel:.1e})")
        log(f"forms (b): {form} {name} x1 central differences: "
            + ", ".join(out))
    extra["v0bar_rel_gap"] = worst[("euler", "v_source")]
    log("forms (b): worst relative gap to the plain gradient: "
        + ", ".join(f"{k[0]} {k[1]} {v:.2e}" for k, v in worst.items())
        + f" ({time.monotonic() - t0:.1f} s)")
    return worst


def form_inputs(torch, f, lanes, dtype, dev="cuda"):
    """The kernels' raw inputs in the caller's branch order."""
    from freedm_tpu_torch.cplx import C
    from freedm_tpu_torch.pf.ladder import SOURCE_UNIT

    s = lane_loads(f, lanes) / f.s_base_per_phase_kva
    u = SOURCE_UNIT * f.v_source_pu

    def t(a):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    return (C(t(s.real), t(s.imag)),
            C(t(np.tile(u.real, (lanes, 1))), t(np.tile(u.imag, (lanes, 1)))))


def form_bytes(lanes, nb, w, table_bytes):
    """A solve's inputs read once (loads, source phasors, the tree and the
    form's tables) and outputs written once (v, i_br, i_load)."""
    return (w * (6 * lanes * nb + 6 * lanes) + w * 22 * nb + table_bytes
            + w * 18 * lanes * nb + (4 + w + 1) * lanes)


def time_forms(torch, lk, rows, extra):
    """(c) L3 and L4 beside L1 on the same feeders and lanes: the fixed
    solve of ``FORM_ITERS`` iterations and its reverse mode by queued CUDA
    events (float64; float32 solves too), the plain versions, the bounds,
    and L3's library row: one ``torch.matmul`` of the subtree matrix with
    the packed ``[nb, 6 · 64]`` currents, times the 2 × ``FORM_ITERS``
    products a solve runs.  The three forms compute one function, so each
    is bounded by that function's own work — its inputs read and outputs
    written once (``form_bytes``, the form's tables included) and L1's
    ``L1_OPS`` (a reverse mode L2's ``L2_OPS``) a branch and iteration,
    whose sweeps cost O(nb) — not by a form's redundant work (L3's dense
    nb² products, L4's pointer-jumping rounds).  Each reverse mode's
    cotangents (loads and ``v0``) are held to its plain version's on the
    same random cotangents, within ``GRAD_RTOL`` of the largest.  Returns
    the head-to-head a shape."""
    from freedm_tpu_torch.cplx import C

    t0 = time.monotonic()
    feeders = form_feeders()
    eps, iters = LADDER_EPS, FORM_ITERS
    heads = {}
    rng = np.random.default_rng(5)
    for form, name, lanes, dtype in (
            ("dense", "radial2048", FORM_LANES, torch.float64),
            ("dense", "radial2048", FORM_LANES, torch.float32),
            ("dense", "vvc_9bus", FORM_LANES, torch.float64),
            ("doubling", "radial10k", FORM_LANES, torch.float64),
            ("doubling", "radial10k", FORM_LANES, torch.float32),
            ("doubling", "radial2048", FORM_LANES, torch.float64),
            ("doubling", "vvc_9bus", FORM_LANES, torch.float64),
            ("doubling", "radial10k", 1, torch.float64)):
        f = feeders[name]
        dn = str(dtype).split(".")[-1]
        w = 8 if dtype == torch.float64 else 4
        fp64 = dtype == torch.float64
        nb = f.n_branches
        s, v0 = form_inputs(torch, f, lanes, dtype)
        if form == "dense":
            op = lk.dense_operands(f, dtype, torch.device("cuda"))
            kernel, plain = lk.ladder_dense, lk.ladder_dense_plain
            vjp, vjp_plain = lk.ladder_dense_vjp, lk.ladder_dense_vjp_plain
            tables = 2 * nb * nb
        else:
            op = lk.doubling_operands(f, dtype, torch.device("cuda"))
            kernel, plain = lk.ladder_doubling, lk.ladder_doubling_plain
            vjp, vjp_plain = (lk.ladder_doubling_vjp,
                              lk.ladder_doubling_vjp_plain)
            tables = 4 * (op.jump.numel() + op.pre_ptr.numel()
                          + int(op.pre_idx.shape[0]))
        b, by = bound(form_bytes(lanes, nb, w, tables),
                      L1_OPS * nb * lanes * iters, fp64)
        fixed = lambda: kernel(s, v0, op, eps, iters, True)  # noqa: E731
        k = time_ms(torch, fixed, reps=5)
        kd = queued_events_ms(torch, fixed, 5)
        kd_solve = queued_events_ms(
            torch, lambda: kernel(s, v0, op, eps, iters, False), 5)
        n_it = int(kernel(s, v0, op, eps, iters, False).iterations.sum())
        pl = time_ms(torch, lambda: plain(s, v0, op, eps, iters, True),
                     reps=1)
        # L1 on the same lanes (preorder space, its own operands).
        l1_s, l1_v0, l1_op = preorder_inputs(torch, lk, f, lanes, dtype)
        l1 = queued_events_ms(torch, lambda: lk.ladder_solve(
            l1_s, l1_v0, l1_op, eps, iters, True), 5)
        row = {"ms": k, "device_ms": kd, "plain_ms": pl, "bound_ms": b,
               "bound_by": by, "device_ms_solve": kd_solve,
               "solve_iterations": n_it, "l1_device_ms": l1}
        if form == "doubling":
            plan = lk.doubling_plan(nb, dtype)
            row.update(route=plan.route, cluster=plan.cluster)
        lib = None
        if form == "dense":
            # The library rows: the 2 x iters products of a solve with the
            # packed [nb, 6 B] currents, dense and by S's CSR.
            sub = op.sub.to(dtype)
            csr = sub.to_sparse_csr()
            x = torch.randn(nb, 6 * lanes, dtype=dtype, device="cuda")
            dense_y = sub @ x
            # nb-term sums in two orders: within a few ulps of the largest
            # entry times nb.
            gap = float((torch.sparse.mm(csr, x) - dense_y).abs().max())
            top = float(dense_y.abs().max())
            check(gap <= 4 * nb * torch.finfo(dtype).eps * top,
                  f"forms (c) {name} {dn}: the CSR product is {gap:.3e} from "
                  f"the dense one (largest {top:.3e})")
            one = queued_events_ms(torch, lambda: torch.matmul(sub, x), 5)
            one_sp = queued_events_ms(torch, lambda: torch.sparse.mm(csr, x),
                                      5)
            lib = one * 2 * iters
            row.update(library_ms=lib, library_one_product_ms=one,
                       library_sparse_ms=one_sp * 2 * iters,
                       library_sparse_one_product_ms=one_sp,
                       route=lk.dense_plan(nb, dtype).route,
                       over_library=kd / lib,
                       over_library_sparse=kd / (one_sp * 2 * iters),
                       over_l1=kd / l1)
        extra_vjp = ""
        if fp64:
            sv = kernel(s, v0, op, eps, iters, True, save=True)
            gs = [C(torch.tensor(rng.normal(size=(lanes, nb, 3)),
                                 dtype=dtype, device="cuda"),
                    torch.tensor(rng.normal(size=(lanes, nb, 3)),
                                 dtype=dtype, device="cuda"))
                  for _ in range(3)]
            back = lambda: vjp(sv.saved, s, op, *gs)  # noqa: E731
            kb = queued_events_ms(torch, back, 5)
            kept = []
            pb = time_ms(torch, lambda: kept.append(vjp_plain(
                sv.saved, s, op, *gs)), reps=1)
            got, want = back(), kept[-1]
            sync(torch, "cuda")
            where = f"forms (c) {form} {name} x{lanes} reverse mode"
            rel, same = 0.0, True
            for g, wt in ((got[0].re, want[0].re), (got[0].im, want[0].im),
                          (got[1].re, want[1].re), (got[1].im, want[1].im)):
                check(bool(torch.isfinite(g).all()), f"{where}: non-finite")
                top = float(wt.abs().max())
                gap = float((g - wt).abs().max())
                check(gap <= GRAD_RTOL * top, f"{where}: {gap:.3e} from the "
                      f"plain version (largest {top:.3e})")
                rel = max(rel, gap / max(top, 1e-300))
                same = same and torch.equal(g, wt)
            check(form == "dense" or same, f"{where}: L4's reverse mode is "
                  f"not its plain version's bits")
            # The saved iterates, the loads and three cotangents read, the
            # two cotangents written; L2's operations a branch and iteration.
            bb, bby = bound(w * 6 * lanes * nb * (iters + 5) + w * 22 * nb
                            + tables, L2_OPS * nb * lanes * iters)
            row.update(vjp_device_ms=kb, vjp_plain_ms=pb, vjp_bound_ms=bb,
                       vjp_bound_by=bby, vjp_max_rel_err=rel,
                       vjp_plain_bits=same)
            extra_vjp = (f"; reverse mode {kb:.4f} ms (plain {pb:.4f}, bound "
                         f"{bb:.5f} ({bby}); within {rel:.2e} of the plain "
                         f"version's cotangents"
                         + (", its bits)" if same else ")"))
            del sv, gs, kept, got, want
        key = f"{name}_x{lanes}_{dn}"
        heads[f"{form}_{key}"] = row
        log(f"timing: ladder_{form:<8} {key}"
            + (f" ({row['route']} route, {row['cluster']} CTAs a lane)"
               if "cluster" in row else "")
            + f": fixed x{iters} {k:.4f} ms "
            f"(queued {kd:.4f}), solve mode {kd_solve:.4f} ms for {n_it} "
            f"lane-iterations; L1 fixed x{iters} on the same lanes "
            f"{l1:.4f} ms; plain {pl:.4f} ms; bound {b:.5f} ms ({by})"
            + ("" if lib is None else
               f"; library: torch.matmul x{2 * iters} {lib:.4f} ms, "
               f"torch.sparse.mm x{2 * iters} {row['library_sparse_ms']:.4f}"
               f" ms; L3 ({row['route']} route) / matmul "
               f"{row['over_library']:.3f}, / sparse.mm "
               f"{row['over_library_sparse']:.3f}, / L1 {row['over_l1']:.3f}")
            + extra_vjp)
        del op
    main_dense = heads[f"dense_radial2048_x{FORM_LANES}_float64"]
    main_doub = heads[f"doubling_radial10k_x{FORM_LANES}_float64"]
    doub_2048 = heads[f"doubling_radial2048_x{FORM_LANES}_float64"]
    log(f"forms (c): at synthetic_radial(2048) x{FORM_LANES} f64 fixed x"
        f"{iters}: L3 {main_dense['device_ms']:.4f} ms = "
        f"{main_dense['device_ms'] / main_dense['l1_device_ms']:.1f}x L1 "
        f"({main_dense['l1_device_ms']:.4f}), L4 "
        f"{doub_2048['device_ms']:.4f} ms; L3 "
        f"{main_dense['device_ms'] / main_dense['bound_ms']:.0f}x its bound, "
        f"L1 {main_dense['l1_device_ms'] / main_dense['bound_ms']:.0f}x")
    f32_dense = heads[f"dense_radial2048_x{FORM_LANES}_float32"]
    vvc_dense = heads[f"dense_vvc_9bus_x{FORM_LANES}_float64"]
    vvc_doub = heads[f"doubling_vvc_9bus_x{FORM_LANES}_float64"]
    aims = {
        "fixed f64 vs torch.matmul x40": (main_dense["device_ms"],
                                          main_dense["library_ms"]),
        "reverse f64 vs torch.matmul x40": (main_dense["vjp_device_ms"],
                                            main_dense["library_ms"]),
        "fixed f32 vs torch.matmul x40": (f32_dense["device_ms"],
                                          f32_dense["library_ms"]),
        "vvc_9bus fixed vs L4": (vvc_dense["device_ms"],
                                 vvc_doub["device_ms"])}
    extra_aims = {k: {"ms": a, "against_ms": b, "met": a <= b}
                  for k, (a, b) in aims.items()}
    log("forms (c): L3 against its aims: " + "; ".join(
        f"{k} {v['ms']:.4f} vs {v['against_ms']:.4f} ms ("
        f"{'met' if v['met'] else 'missed'})" for k, v in extra_aims.items()))
    rows["ladder_dense"] = (main_dense["ms"], main_dense["plain_ms"],
                            main_dense["library_ms"], main_dense["bound_ms"],
                            main_dense["bound_by"])
    rows["ladder_doubling"] = (main_doub["ms"], main_doub["plain_ms"], None,
                               main_doub["bound_ms"], main_doub["bound_by"])
    def reverse(row):
        return {k[4:]: row[k] for k in row if k.startswith("vjp_")}

    extra["ladder_dense"] = {
        "shape": f"synthetic_radial(2048, seed=0, load_kw=1.0) x{FORM_LANES} "
                 f"f64, solve_fixed, {iters} iterations",
        "device_ms": main_dense["device_ms"],
        "library_sparse_ms": main_dense["library_sparse_ms"],
        "aims": extra_aims,
        "reverse_mode": reverse(main_dense), "shapes": heads}
    extra["ladder_doubling"] = {
        "shape": f"synthetic_radial(10000, seed=0, load_kw=1.0) x{FORM_LANES}"
                 f" f64, solve_fixed, {iters} iterations",
        "device_ms": main_doub["device_ms"],
        "reverse_mode": reverse(main_doub)}
    torch.cuda.empty_cache()
    log(f"forms (c): {time.monotonic() - t0:.1f} s")
    return heads


def form_main_paths(torch, lk, dev="cuda"):
    """(e) The main paths of L3 and L4, counts set to 0 just before and
    read just after: ``make_ladder_solver(sweep_method=...)`` — a solve and
    a ``solve_fixed`` with the gradient of the total loss in the loads and
    in ``v_source_pu`` — on the 2048-branch feeder × 64 (L3) and the 10k
    feeder × 64 (L4), and L3's CTA route the same way on vvc_9bus × 64
    (``ladder_dense_cta``).  Every kernel launch counts: L3's tiled route
    issues ``2 + 2 · max_iter`` a solve (either mode) and a reverse mode,
    its CTA route and L4 one each.  Returns the counts and their split by
    mode."""
    from freedm_tpu_torch.pf.ladder import make_ladder_solver, total_loss_kw

    feeders = form_feeders()
    counts, modes = {}, {}
    n = FORM_ITERS
    expect = {"ladder_dense": {"forward": 2 * (2 + 2 * n),
                               "reverse": 2 + 2 * n},
              "ladder_doubling": {"forward": 2, "reverse": 1},
              "ladder_dense_cta": {"forward": 2, "reverse": 1}}
    check(lk.dense_plan(feeders["radial2048"].n_branches,
                        torch.float64).route == "tiled"
          and lk.dense_plan(feeders["vvc_9bus"].n_branches,
                            torch.float64).route == "cta",
          "forms (e): the feeders do not take L3's two routes")
    for form, name, key in (("dense", "radial2048", "ladder_dense"),
                            ("doubling", "radial10k", "ladder_doubling"),
                            ("dense", "vvc_9bus", "ladder_dense_cta")):
        f = feeders[name]
        loads = lane_loads(f, FORM_LANES)
        solve, fixed = make_ladder_solver(f, max_iter=n, sweep_method=form,
                                          device=dev)
        p = torch.as_tensor(loads.real, device=dev)
        q = torch.as_tensor(loads.imag, device=dev).requires_grad_(True)
        v = torch.full((FORM_LANES,), f.v_source_pu, dtype=torch.float64,
                       device=dev, requires_grad=True)
        lk.reset_launches()
        res = solve(loads)
        loss = total_loss_kw(f, fixed((p, q), v)).sum()
        gq, gv = torch.autograd.grad(loss, (q, v))
        sync(torch, dev)
        kernel = key.replace("_cta", "")
        counts[key] = lk.launches()[kernel]
        modes[key] = lk.mode_launches()[kernel]
        check(modes[key] == expect[key]
              and counts[key] == sum(expect[key].values())
              and bool(res.converged.all())
              and bool(torch.isfinite(gq).all() & torch.isfinite(gv).all()),
              f"forms (e) {form} {name}: {lk.launches()} "
              f"{lk.mode_launches()} (want {expect[key]}), converged "
              f"{int(res.converged.sum())}/{FORM_LANES}")
        log(f"forms (e): {form} {name} x{FORM_LANES}: solve, solve_fixed and "
            f"its backward: {key} {counts[key]} launches ({modes[key]}), "
            f"every lane converged, the gradients finite")
    return counts, modes


def wide_inputs(torch, n, fleets, dev):
    """B1 WIDE's inputs: ``bench_lb_256``'s draw (``normal(0, 10)``,
    ``default_rng(0)``, float32) for ``fleets`` fleets of ``n`` nodes,
    zero gateways, one group."""
    rng = np.random.default_rng(0)
    ng = torch.as_tensor(rng.normal(0, 10, (fleets, n)), dtype=torch.float32,
                         device=dev)
    gw = torch.zeros(fleets, n, dtype=torch.float32, device=dev)
    gid = torch.zeros(1, n, dtype=torch.int32, device=dev)
    return ng, gw, gid


def round_high_words(torch, ng):
    """The 64-bit high words of a WIDE round's sort keys (group id 0 |
    class | ~bits(float32 |imbalance|)) at a zero gateway, step 1, as
    int64: a stable sort of them gives the key pairs' order, the low word
    being the node index."""
    imb = ng.to(torch.float32)
    cls = torch.where(imb >= 1.0, 0, torch.where(imb <= -1.0, 1, 2))
    bits = imb.abs().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    kb = torch.where(cls < 2, 0xFFFFFFFF - bits, torch.zeros_like(bits))
    return (cls.to(torch.int64) << 32) | kb


def wide_phase(torch, dk, extra, dev="cuda", shapes=WIDE_SHAPES,
               entry_nodes=1 << 15):
    """(d) B1 from 2¹⁵ nodes against its plain version bit for bit (and on
    repeat): its CLUSTER form over ``WIDE_ROUNDS`` rounds at
    ``WIDE_SHAPES``, its one-CTA WIDE form on one fleet of the first power
    of two above the cluster capacity over ``WIDE_ABOVE_ROUNDS``; their
    times, and the sort alone (:func:`round_high_words`) as a yardstick;
    then ``lb.run_rounds`` and ``lb.lb_round(..., gid=...)`` at 2¹⁵ nodes
    from a block-diagonal mask of ``WIDE_GROUP``-node groups built on the
    card (the GM → LB hand-off: ``lb.group_ids``), counts set to 0 before
    and read after; B1's packed form at 2¹⁵ − 1 against its plain version.
    Returns B1's launches over that ``run_rounds``."""
    from freedm_tpu_torch.modules import lb

    t0 = time.monotonic()
    timed = {}
    on_card = dev == "cuda"
    above = 2 * dk.lb_cluster_capacity(4)
    for n, fleets, rounds in ([(n, f, WIDE_ROUNDS) for n, f in shapes]
                              + [(above, 1, WIDE_ABOVE_ROUNDS)]):
        ng, gw, gid = wide_inputs(torch, n, fleets, dev)
        form = dk.lb_form(n, 4)
        check(form == (dk.WIDE if n > dk.lb_cluster_capacity(4)
                       else dk.CLUSTER), f"B1 at n={n}: form {form}")
        call = lambda: dk.lb_rounds(ng, gw, gid, 1.0, rounds)  # noqa: E731
        got, again = call(), call()
        want = dk.lb_rounds_plain(ng, gw, gid, 1.0, rounds)
        sync(torch, dev)
        check(same_fields(torch, got, want) and same_fields(torch, got, again),
              f"B1 {form} n={n} x{fleets}: not its plain version's bits")
        row = {"form": form, "cluster": dk.lb_cluster_plan(n, 4),
               "migrations_first_last": [int(got.migrations[0, 0]),
                                         int(got.migrations[0, -1])]}
        if on_card:
            k = events_ms(torch, call, 3)
            p = time_ms(torch, lambda: dk.lb_rounds_plain(
                ng, gw, gid, 1.0, rounds), 1)
            b, by = bound(fleets * n * 8 + 4 * n + fleets * n * 4
                          + fleets * rounds * (4 + 4 * n), 0, fp64=False)
            row.update(ms=k, plain_ms=p, bound_ms=b, bound_by=by)
        timed[f"{n}x{fleets}x{rounds}"] = row
        log(f"dgi (wide): B1 {form} n={n} x{fleets} fleets x{rounds} "
            f"rounds (cluster {row['cluster']}): the plain version's bits, "
            f"bit-identical on repeat; migrations "
            f"{row['migrations_first_last']} (first, last round)"
            + (f"; {row['ms']:.3f} ms (plain {row['plain_ms']:.3f} ms, bound "
               f"{row['bound_ms']:.5f} ms)" if on_card else ""))
    sort_alone = None
    if on_card:  # the yardstick: the round's sort alone, at 2^16 x 1
        n = 1 << 16
        ng, _, _ = wide_inputs(torch, n, 1, dev)
        hi = round_high_words(torch, ng[0])
        sort_alone = events_ms(torch, lambda: [
            torch.sort(hi, stable=True) for _ in range(WIDE_ROUNDS)], 3)
        log(f"dgi (wide): the sort alone, {WIDE_ROUNDS} torch.sort(stable="
            f"True) of the first round's 64-bit high words at n={n}: "
            f"{sort_alone:.3f} ms")
    n = entry_nodes
    blk = torch.arange(n, device=dev) // WIDE_GROUP
    mask = (blk[:, None] == blk[None, :]).to(torch.float32)
    rng = np.random.default_rng(0)
    ng = torch.as_tensor(rng.normal(0, 10, n), dtype=torch.float32,
                         device=dev)
    gw0 = torch.zeros(n, dtype=torch.float32, device=dev)
    dk.reset_launches()
    t1 = time.monotonic()
    gw, migs, states = lb.run_rounds(ng, gw0, mask, 1.0, WIDE_ROUNDS,
                                     device=dev)
    sync(torch, dev)
    wall = time.monotonic() - t1
    launched = dk.launches()["lb_rounds"]
    gid = lb.group_ids(mask)
    want = dk.lb_rounds_plain(ng[None], gw0[None], gid[None], 1.0,
                              WIDE_ROUNDS)
    check(launched == (1 if on_card else 0) and torch.equal(
        gw, want.gateway[0]) and torch.equal(migs, want.migrations[0])
        and torch.equal(states, want.states[0]),
        f"run_rounds at {n} nodes: {launched} launches, or not B1's plain "
        f"version's trajectory")
    rnd = lb.lb_round(ng, gw, mask, 1.0, gid=gid, device=dev)
    one = dk.lb_rounds_plain(ng[None], gw[None], gid[None], 1.0, 1,
                             round_outputs=True)
    check(torch.equal(rnd.gateway, one.gateway[0])
          and torch.equal(rnd.state, one.states[0, 0])
          and int(rnd.n_migrations) == int(one.migrations[0, 0]),
          f"lb_round at {n} nodes differs from B1's plain version")
    del rnd, mask
    log(f"dgi (wide): lb.run_rounds at N={n} ({n // WIDE_GROUP} groups of "
        f"{WIDE_GROUP} from a block-diagonal mask, group_ids on the card) x"
        f"{WIDE_ROUNDS} rounds: B1 launched {launched} time(s), the plain "
        f"version's trajectory, migrations {int(migs[0])} -> "
        f"{int(migs[-1])}, {wall * 1e3:.1f} ms with group_ids; "
        f"lb_round(..., gid=...) equal too")
    n = (1 << 15) - 1
    ng, gw, gid = wide_inputs(torch, n, 1, dev)
    check(dk.lb_form(n, 4) == dk.GLOBAL, "B1 below 2^15: not GLOBAL")
    got = dk.lb_rounds(ng, gw, gid, 1.0, WIDE_ROUNDS)
    want = dk.lb_rounds_plain(ng, gw, gid, 1.0, WIDE_ROUNDS)
    check(same_fields(torch, got, want), "B1 packed n=2^15-1: not its plain "
          "version's bits")
    packed = {}
    if on_card:
        packed = {"ms": events_ms(torch, lambda: dk.lb_rounds(
            ng, gw, gid, 1.0, WIDE_ROUNDS), 3)}
    log(f"dgi (wide): B1 packed (GLOBAL) n={n} x{WIDE_ROUNDS} rounds: the "
        f"plain version's bits" + (f", {packed['ms']:.3f} ms"
                                   if on_card else "")
        + f" ({time.monotonic() - t0:.1f} s)")
    extra.setdefault("lb_rounds", {}).update(
        wide=timed, packed_at_2_15_minus_1=packed,
        launches_run_rounds_2_15=launched,
        wide_sort_alone_ms_2_16=sort_alone,
        wide_sort_alone=f"{WIDE_ROUNDS} torch.sort(stable=True) of the first "
                        f"round's 64-bit high words at 2^16 x 1")
    return launched


def forms_phase(torch, lk, dk, errs, rows, extra):
    """Phase 28: L3 and L4 against their plain versions, the reverse
    modes with the source phasors' cotangent, the times, B1 WIDE and the
    forms' main paths; returns L3's and L4's main-path launches."""
    t28 = time.monotonic()
    compare_forms(torch, errs)
    compare_doubling_routes(torch, lk)
    compare_form_vjps(torch, extra.setdefault("ladder_vjp", {}))
    time_forms(torch, lk, rows, extra)
    wide_phase(torch, dk, extra)
    counts, modes = form_main_paths(torch, lk)
    extra["ladder_dense"]["launches_cta_route"] = {
        "path": "forms phase (e): make_ladder_solver(sweep_method='dense') on "
                "vvc_9bus x64, solve + solve_fixed + backward",
        "launches": counts.pop("ladder_dense_cta"),
        "launches_by_mode": modes.pop("ladder_dense_cta")}
    for key, path in (("ladder_dense", "forms phase (e): make_ladder_solver("
                       "sweep_method='dense') on synthetic_radial(2048) x64, "
                       "solve + solve_fixed + backward"),
                      ("ladder_doubling", "forms phase (e): make_ladder_solver("
                       "sweep_method='doubling') on synthetic_radial(10000) "
                       "x64, solve + solve_fixed + backward")):
        extra[key]["launches_path"] = path
        extra[key]["launches_by_mode"] = modes[key]
    log(f"forms: phase 28 {time.monotonic() - t28:.1f} s")
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from freedm_tpu_torch.kernels import build
    from freedm_tpu_torch.kernels import cache_kernels as ck
    from freedm_tpu_torch.kernels import dgi_kernels as dk
    from freedm_tpu_torch.kernels import ladder_kernels as lk
    from freedm_tpu_torch.kernels import newton_kernels as nk
    from freedm_tpu_torch.kernels import qsts_kernels as qk
    from freedm_tpu_torch.kernels import screen_kernels as sck
    from freedm_tpu_torch.kernels import solver_kernels as sol
    from freedm_tpu_torch.kernels import sparse_kernels as sk
    from freedm_tpu_torch.kernels import topo_kernels as tk
    from freedm_tpu_torch.pf import topo as tp

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        build_kernels(torch, nk, sk, ck, sck, lk, qk, tk, sol, dk, build)
        errs = dict.fromkeys([*nk.LAUNCHES, *sk.LAUNCHES, *ck.LAUNCHES,
                              *sck.LAUNCHES, *lk.LAUNCHES, *qk.LAUNCHES,
                              *tk.LAUNCHES, *sol.LAUNCHES, *dk.LAUNCHES],
                             0.0)
        k2_f32 = compare_kernels(torch, nk, errs)
        rows, extra = time_kernels(torch, nk)
        extra["power_injections"]["max_abs_err_f32"] = k2_f32
        solve_mesh2000(torch, nk)
        solve_f32(torch, nk)
        compare_sparse_kernels(torch, sk, errs)
        sparse_rows, sparse_extra = time_sparse_kernels(torch, sk)
        rows.update(sparse_rows)
        extra.update(sparse_extra)
        solve_sparse(torch, nk, sk)
        counts = serve(torch, nk)
        sparse_counts, s1_modes = serve_default(torch, sk)
        counts.update(sparse_counts)
        extra["sparse_assemble"]["launches_by_mode"] = s1_modes
        cases = compare_delta_programs(torch, ck, errs, extra)
        delta_rows, delta_extra = time_delta(torch, ck, cases)
        rows.update(delta_rows)
        extra["delta_program"].update(delta_extra["delta_program"])
        counts.update(serve_cache(torch, ck, sk))
        compare_status_assemble(torch, sk, errs)
        compare_smw(torch, sck, errs)
        compare_dc(torch, sck, errs)
        time_screen_kernels(torch, sk, sck, rows, extra)
        counts.update(n1_screens(torch, sk, sck, nk))
        n1_counts, n1_status = serve_n1(torch, sk, sck, nk)
        counts["smw_sweep"] = n1_counts["smw_sweep"]
        extra["sparse_assemble"]["launches_n1_with_status"] = n1_status
        extra["smw_sweep"]["launches_path"] = "serve n1 phase"
        extra["dc_screen"]["launches_path"] = (
            "n1 screens phase: make_dc_solver and dc_prefilter")
        worst = compare_ladder(torch, errs)
        compare_ladder_routes(torch, lk, errs)
        compare_ladder_vjp(torch, errs)
        vjp_worst = compare_vjp_routes(torch, lk, errs)
        time_ladder(torch, lk, rows, extra)
        time_crossover(torch, lk, extra)
        extra["ladder_vjp"]["max_rel_err_routes"] = vjp_worst
        extra["ladder_solve"]["max_abs_err_f32"] = worst["float32"]
        vvc_counts = vvc_phase(torch, lk)
        serve_counts = serve_vvc(torch, lk)
        counts["ladder_solve"] = serve_counts["ladder_solve"]
        counts["ladder_vjp"] = vvc_counts["ladder_vjp"]
        extra["ladder_solve"]["launches_path"] = (
            "serve vvc phase: 64 concurrent POST /v1/vvc")
        extra["ladder_solve"]["launches_vvc_step_10k_x64"] = (
            vvc_counts["ladder_solve"])
        extra["ladder_vjp"]["launches_path"] = (
            "vvc phase: one controller step on synthetic_radial(10000) x64")
        compare_a1(torch, qk, errs)
        compare_q(torch, qk, errs)
        time_qsts(torch, qk, rows, extra)
        counts.update(qsts_phase(torch, qk, lk))
        extra["agent_step"]["launches_path"] = (
            "qsts phase (c): the million-agent day on case_ieee30 x1, the "
            "engine's second run")
        extra["qsts_bus_reduce"]["launches_path"] = (
            "qsts phase (b): mesh2000 x64 x96 steps, sparse mixed")
        extra["qsts_feeder_reduce"]["launches_path"] = (
            "qsts phase (d): vvc_9bus x64 x96 steps, chunks of 24")
        serve_qsts(torch, qk)
        t_topo = time.monotonic()
        margin = compare_topo(torch, tk, tp, errs)
        timed = time_topo(torch, tk, tp, rows, extra)
        extra["topo_screen"].update(margin)
        log(f"topo: phase 18 {time.monotonic() - t_topo:.1f} s")
        t19 = time.monotonic()
        counts.update(topo_sweeps(torch, tk, tp, timed))
        log(f"topo: phase 19 {time.monotonic() - t19:.1f} s")
        t20 = time.monotonic()
        sync_counts, job_counts = serve_topo(torch, tk, tp)
        log(f"topo: phase 20 {time.monotonic() - t20:.1f} s; phases 18-20 "
            f"{time.monotonic() - t_topo:.1f} s")
        for name in tk.LAUNCHES:
            extra[name]["launches_path"] = (
                "topo sweeps phase (a): mesh118, every rank<=2 variant, "
                "chunks of 4096")
            extra[name]["launches_serve_sync"] = sync_counts[name]
            extra[name]["launches_serve_job"] = job_counts[name]
        t21 = time.monotonic()
        f32_errs = compare_solver_kernels(torch, sol, nk, errs)
        j1_routes = compare_residual_routes(torch, sol, False)
        errs["residual_jvp"] = max(errs["residual_jvp"],
                                   j1_routes[torch.float64])
        f32_errs["residual_jvp_f32"] = max(
            f32_errs.get("residual_jvp_f32", 0.0), j1_routes[torch.float32])
        tile_gaps = compare_fdlf_tiles(torch, sol, nk)
        errs["fdlf_half_step"] = max(errs["fdlf_half_step"],
                                     tile_gaps[torch.float64])
        f32_errs["fdlf_half_step_f32"] = max(
            f32_errs.get("fdlf_half_step_f32", 0.0),
            tile_gaps[torch.float32])
        time_solver_kernels(torch, sol, nk, rows, extra)
        log(f"solvers: phase 21 {time.monotonic() - t21:.1f} s")
        bench, paths = solver_benches(torch, sol)
        cim_counts = cim_phase(torch, sol)
        paths["cim_iterate"] = (cim_counts.get("cim_iterate", 0),
                                "cim phase: synthetic_radial(1000) + 2 ties "
                                "x 64 solve")
        for name, (count, path) in paths.items():
            counts[name] = count
            extra[name]["launches_path"] = path
            if name + "_f32" in f32_errs:
                extra[name]["max_abs_err_f32"] = f32_errs[name + "_f32"]
        extra["fdlf_half_step"]["bench"] = bench
        extra["residual_jvp"]["launches_by_route"] = bench[
            "krylov_lanes_mixed_j1_routes"]
        extra["residual_jvp"]["device_ms_on_path"] = bench[
            "krylov_lanes_mixed_j1_device_ms"]
        log(f"solvers: phases 21-23 {time.monotonic() - t21:.1f} s")
        t24 = time.monotonic()
        compare_dgi(torch, dk, errs)
        time_dgi(torch, dk, rows, extra)
        d_counts = dgi_phase(torch, dk)
        s_counts, split = superstep_phase(torch, dk, lk)
        for name in dk.LAUNCHES:
            counts[name] = s_counts[name]
            extra[name]["launches_path"] = (
                "superstep phase (b): 1024 nodes, 10 rounds (R1 once, the "
                "reachability from the synthetic topology)")
            extra[name]["launches_dgi_d"] = d_counts[name]
        extra["form_groups"]["superstep_ms_a_round"] = split
        log(f"dgi: phases 24-26 {time.monotonic() - t24:.1f} s")
        counts.update(reverse_phase(torch, sol, errs, rows, extra))
        counts.update(forms_phase(torch, lk, dk, errs, rows, extra))
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    source = "freedm_tpu_torch/kernels/"
    meta = {
        "newton_assemble": ("cuda", source + "csrc/newton.cu",
                            "freedm_tpu/pf/newton.py:260"),
        "power_injections": ("cuda", source + "csrc/newton.cu",
                             "freedm_tpu/pf/newton.py:144"),
        "newton_update": ("cuda", source + "csrc/newton.cu",
                          "freedm_tpu/pf/newton.py:325"),
        "sparse_assemble": ("cuda", source + "csrc/sparse.cu",
                            "freedm_tpu/pf/sparse.py:307"),
        "sparse_matvec": ("cuda", source + "csrc/sparse.cu",
                          "freedm_tpu/pf/sparse.py:346"),
        "gmres_block_orth": ("cuda", source + "csrc/sparse.cu",
                             "freedm_tpu/pf/krylov.py:451"),
        "gmres_lstsq": ("cuda", source + "csrc/sparse.cu",
                        "freedm_tpu/pf/krylov.py:479"),
        "delta_program": ("cuda", source + "csrc/cache.cu",
                          "freedm_tpu/serve/cache.py:284"),
        "smw_sweep": ("cuda", source + "csrc/screen.cu",
                      "freedm_tpu/pf/n1.py:340"),
        "dc_screen": ("cuda", source + "csrc/screen.cu",
                      "freedm_tpu/pf/dc.py:145"),
        "ladder_solve": ("cuda", source + "csrc/ladder.cu",
                         "freedm_tpu/pf/ladder.py:184"),
        "ladder_vjp": ("cuda", source + "csrc/ladder.cu",
                       "freedm_tpu/pf/ladder.py:209"),
        "ladder_dense": ("cuda", source + "csrc/ladder_dense.cu",
                         "freedm_tpu/pf/sweeps.py:45"),
        "ladder_doubling": ("cuda", source + "csrc/ladder.cu",
                            "freedm_tpu/pf/sweeps.py:60"),
        "agent_step": ("cuda", source + "csrc/qsts.cu",
                       "freedm_tpu/scenarios/agents.py:459"),
        "qsts_bus_reduce": ("cuda", source + "csrc/qsts.cu",
                            "freedm_tpu/scenarios/engine.py:401"),
        "qsts_feeder_reduce": ("cuda", source + "csrc/qsts.cu",
                               "freedm_tpu/scenarios/engine.py:647"),
        "topo_radiality": ("cuda", source + "csrc/topo.cu",
                           "freedm_tpu/pf/topo.py:182"),
        "topo_screen": ("cuda", source + "csrc/topo.cu",
                        "freedm_tpu/pf/topo.py:455"),
        "ybus_stamp": ("cuda", source + "csrc/solvers.cu",
                       "freedm_tpu/grid/bus.py:130"),
        "fdlf_half_step": ("cuda", source + "csrc/solvers.cu",
                           "freedm_tpu/pf/fdlf.py:167"),
        "residual_jvp": ("cuda", source + "csrc/solvers.cu",
                         "freedm_tpu/pf/krylov.py:594"),
        "cim_iterate": ("cuda", source + "csrc/solvers.cu",
                        "freedm_tpu/pf/cim.py:163"),
        "residual_vjp": ("cuda", source + "csrc/solvers.cu",
                         "freedm_tpu/pf/newton.py:341"),
        "cim_vjp": ("cuda", source + "csrc/solvers.cu",
                    "freedm_tpu/pf/cim.py:163"),
        "form_groups": ("cuda", source + "csrc/dgi.cu",
                        "freedm_tpu/modules/gm.py:78"),
        "reach_closure": ("cuda", source + "csrc/dgi.cu",
                          "freedm_tpu/grid/topology.py:131"),
        "lb_rounds": ("cuda", source + "csrc/dgi.cu",
                      "freedm_tpu/modules/lb.py:114"),
    }
    table = []
    for name, (route, src, replaces) in meta.items():
        k, p, lib, b, by = rows[name]
        table.append({
            "name": name, "route": route, "source": src,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": errs[name], "ms": k, "plain_ms": p,
            "bound_ms": b, "bound_by": by, "library_ms": lib,
            **extra.get(name, {}),
        })
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
