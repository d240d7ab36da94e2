#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nonlocalheatequation_torch) on one
NVIDIA GPU.  Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero before the last
line is printed; the phase walls are printed at the end):

1. Device and build: the card's name and power limit, then the kernels built
   by nvcc from csrc/ (one nvcc per source, started together), and each
   source's ptxas report.  The batch CLIs of phase 3 start right after it.
2. Kernels against their plain PyTorch versions on the card, in float64,
   float32 and the bf16 operand tier.  Tolerance: max|kernel - plain| <=
   1e-12 (float64) or 1e-5 (float32) times the largest magnitude of the
   plain result.  2D: nsum2d and step2d over eps in {1, 3, 5, 8, 10, 16, 40}
   and ragged shapes (1x1, non tile multiples, nx < 2*eps, eps above the
   32-point tile); then the multi-step kernels (carried2d; superstep2d at
   K = 1-4 and a 7-step run with a remainder; resident2d, which has no bf16
   tier) over the same shapes and eps up to 60 where each takes it, each
   held to its plain version (in the bf16 tier plus one bfloat16 rounding
   flip per step after the first, see phase_multistep_checks) and BITWISE
   to the same number of step2d launches, resident2d also over 7 and 64
   steps (superstep2d, the register design
   up to eps 8, also BITWISE to its plain version).  3D: nsum3d and step3d
   (production and test form; the register design up to eps 6, the tile
   body at 7 and 8) over eps 0-8 and ragged shapes (1x1x1, non tile
   multiples, n < 2*eps, nx != ny != nz, a frame z that is odd), BITWISE to
   their plain versions (sphere_sum's order); carried3d (the same two
   designs) BITWISE to its plain version and to step3d launches over 1, 2
   and 3 steps, resident3d (no bf16 tier either) held to its plain version
   and BITWISE to step3d launches over 1, 2, 5, 7 and 64 steps.  resident2d at 4096^2 and
   resident3d at 256^3, eps=4, beyond their gates, must raise ValueError.
   The batched kernels (batched_step2d production and test form,
   batched_carried2d, batched_superstep2d at K = 1-4), uniform and mixed
   physics, B in {1, 2, 3, 8}, eps 0-9, 16, 17 and 40 over ragged grids:
   each held BITWISE to its plain version and each lane BITWISE to its solo
   launch (batched_carried2d's also to batched_step2d's, and its next bf16
   shadow to the rounding of its next masters; phase_batched_checks).  The
   solo step kernels, one batched launch at B=1 each: step2d (production
   and test form) and carried2d (into a NaN-filled out) at eps 0, 1, 3, 8,
   16, 17 and 40 over 1x1, ragged shapes, a 512^2 plane (in float32 below
   the card's SM count: the tile body) and 1100 x 700 (the register walk),
   float64, float32 and the bf16 tier, BITWISE to their plain versions
   (phase_solo_checks).
3. The main path's correctness: the batch tables (CASES_2D and CASES_1D of
   tests/cases.py, CASES_3D of tests/test_oracle_3d.py, copied here) through
   the port's CLIs on the card in float64, each must print "Tests Passed"
   (CASES_1D and CASES_3D also with --ensemble); then CASES_2D and CASES_3D
   in float32 through Solver2D and Solver3D, reporting the largest
   error_l2/#points.
4. The 2D headline configuration: 4096^2, eps=8, float32, method="cuda".  At
   the main path's shape every kernel form (nsum2d f32 and bf16 operand,
   and in float64 on the padded G the test-form solve gives it; step2d
   production and test form, f32 and bf16 operand; carried2d and
   superstep2d at K = 2 and 3, also BITWISE to its plain version and to K
   step2d launches) is held against its plain version with the phase-2
   tolerances.  The kernels are timed with CUDA events beside their
   plain versions, their byte/operation bound and F.conv2d (the library
   yardstick for the neighbour sum, with TF32 disabled; the port never calls
   it), and the test-form source's set-up is timed on the card and in NumPy.
   Every multi-step candidate of the tuner is timed in ms/step at 4096^2
   (resident does not fit there) and at 512^2, eps=8, f32, where resident
   fits (resident2d held bitwise to step2d launches there over 1, 2, 7, 20
   and 64 steps).  At both shapes step2d, carried2d, superstep2d at K = 2 and 3 and
   batched_step2d at B=1 (at 4096^2 also step2d and carried2d in the bf16
   tier) are timed in turns, as a replayed CUDA graph of launches (the
   device alone: a loop of launches from Python times the host at 512^2)
   and in a loop of launches.  Then the launch counts and the
   tuner's records are reset and the 2D main path runs through Solver2D:
   the production solve at 4096^2 and at 512^2 (each tunes its shape, as a
   first production call does, and runs the winner) and a test-form solve
   at 4096^2 (whose L(G) goes through nsum2d); the 2D counts must show
   every 2D kernel launched, and exactly the probes' and the winners'
   launches.  The tuner's records are printed.
5. The 3D path, the same way: the kernels at 256^3, eps=4, f32 (every form
   held BITWISE to its plain version, carried3d also to step3d launches;
   timed beside the plain versions, the bound and F.conv3d with TF32
   disabled; step3d and carried3d, both the register design, in turns, also
   at 128^3, eps=6),
   the tuner's candidates at 256^3 and at 128^3, eps=6 (where resident3d
   fits; it is held bitwise to step3d launches there over 1, 2, 7, 20 and 64
   steps and timed), then the
   counts and records reset and the 3D main path through Solver3D: the
   production solves at both shapes (each tuned) and a test-form solve at
   256^3; the 3D counts must equal the probes', the winners' and the test
   form's launches, every 3D kernel among them.  Each shape's tuned
   program is then timed beside the per-step program, in turns.
6. The ensemble engine (phase_ensemble) at the JAX package's ensemble
   size, 8 production cases of 1024^2, eps=8, f32, 500 steps, and a
   mixed-physics 8 x 512^2 bucket: the batched kernels at 8 x 1024^2 held to
   their plain versions and per lane to the solo kernels, bitwise
   (batched_carried2d's lanes also to batched_step2d's), timed beside their
   plain versions and bounds, batched_carried2d in turns with
   batched_step2d at 8 x 1024^2 and at the mixed 8 x 512^2 bucket (in a
   loop of launches and in a CUDA graph);
   step2d alone timed on one of the 1024^2 planes; the engine's run timed
   beside the
   same 8 cases as 8 sequential tuned solves; every lane of both buckets
   bitwise equal to its solo per-step loop.  Then, counted: CASES_2D through
   solve2d --ensemble in float64 (it must print "Tests Passed" and launch
   batched_step2d, never step2d), both buckets through EnsembleEngine (each
   1 bucket, 1 program, 1 dispatch, 500 batched_step2d launches), and both
   under NLHEAT_TUNE_BATCH=1 (the batched tuner's probes and winner); the
   batched counts must equal the rows', buckets', probes' and winners'.
   Each bucket's tuned program is then timed beside its untuned one.
7. The unstructured path (phase_unstructured_checks, phase_unstructured):
   windowed_matvec (f64, f32) and gather_L (f64, f32, bf16 operand) held to
   their plain versions on small clouds (2D jittered and shuffled, 3D, 1D,
   n not a multiple of 128, a forced residual, a self-only horizon, a hub
   node), the windowed operator to the NumPy oracle, and stacked gather
   lanes bitwise their solo runs.  Then the shuffled jittered 512^2 cloud
   (262,144 nodes, eps = 3h, f32): the host walls of the edge and plan
   builds, the card memory of building the windowed exec (its packed
   in-window entries; it must not allocate the dense strips), both kernels
   held and timed beside their plain versions, their bounds and
   torch.sparse.mm of a CSR matrix of the same entries (in turns, in CUDA
   graphs and in loops of launches), one L(u) per layout and one
   auto-picked L(u) (counted: one windowed_matvec).  The CLI on the card:
   data/*.msh with --layout auto and windowed in f64 (error_l2/N <= 1e-6;
   started with phase 3's CLIs and collected after them), then, counted, the 512^2 cloud from a 2.2 .msh
   with --layout auto, which must choose windowed and launch
   windowed_matvec once per step.  Last, bench.py's graded cloud at nm=256
   (65,536 nodes) in a throwaway mesh registry: gather_L held and timed at
   its shape, then, counted, an 8-case bucket and a mixed-physics 8-case
   bucket through EnsembleEngine, each 8 x MESH_STEPS gather_L launches, every
   lane bitwise its solo gather loop and within the manufactured contract.
8. The distributed grid solves (phase_halo_checks, phase_distributed):
   fused_nsum2d and fused_nsum3d (the halo read inside the kernel from the
   blocks around it) over meshes of blocks, and split_nsum2d and
   split_nsum3d (the split kernels, interior then ring, on a filled
   frame), held to their plain versions in float64, float32 and the bf16
   tier on normal, degenerate and multi-hop blocks, and BITWISE to the
   one-pass nsum2d/nsum3d on each halo-exchanged frame; then, at the main
   path's blocks (2048^2, eps=8 and 128^3, eps=4, f32), held and timed
   beside their plain versions, their bounds and F.conv2d/F.conv3d over
   the frame, the split kernels also per phase.  Counted:
   Solver2DDistributed at 4096^2, eps=8, on a 2x2 mesh of virtual devices of the card and Solver3DDistributed at 256^3,
   eps=4, on 2x2x2, 20 production steps each with comm='fused' (the
   in-kernel exchange, the card's default), comm='fused' with
   NLHEAT_FUSED_TRANSPORT=interp (band copies, then the split kernels) and
   comm='collective', all three bitwise equal; and CASES_2D_DISTRIBUTED
   through solve2d_distributed --test_batch (float64, 8 virtual devices,
   --comm fused and the default), which must print "Tests Passed"; the
   counts must be exactly the solves' and the rows'.  Each solve is held
   within 1e-5 of the tuned single-device Solver2D/Solver3D, and the steps
   are timed on the card, three runs each, the 'fused' and 'collective'
   steps also under torch.profiler (device time by kernel).
10. (Run after phase 8, before phase 9's lines.) Async, logs, checkpoints
   (phase_async_logs): Solver2D at 4096^2, eps=8, f32, 500 steps with the
   async binary's throttle nd=5 must hold 5 steps in flight, be bitwise the
   unthrottled tuned solve and launch exactly 500 step2d and nothing else;
   both do_work walls are timed in turns and the throttle's cost printed.
   CASES_2D_ASYNC through solve2d_async --test_batch in float64 (started
   with phase 3's CLIs) must print "Tests Passed".  Checkpoints every 100
   steps of 500 against a run stopped at 300 and resumed from its file,
   bitwise equal, for Solver2D at 4096^2, Solver2DDistributed at 4096^2
   on a 2x2 mesh of virtual devices (comm='fused') and Solver3D at 256^3,
   eps=4, with each save's and load's wall (from the checkpoint.save and
   checkpoint.load spans) and the state's fetch.  solve2d --test --log
   --nlog 5 at 128^2, 20 steps: the CSV rows, scores and VTU snapshots
   counted, each snapshot read back and held to a solve that ends at its
   step.  solve2d --resume --profile at 4096^2, 20 steps: one Chrome trace
   that names the tuned winner's kernel.  Counted, every part; its
   launches join the kernels' rows.  Files go to temporary directories
   that the phase deletes.
11. (Run after phase 10, before phase 9's lines.) Decomposition, partition
   maps, the load balancer and the elastic executor (phase_elastic): (a) the
   reference's documented 4-node run: a binary 4.1 mesh of 400x400 at
   dh=1/400 decomposed by the port's CLI into 20x20 tiles of 20^2 over 4
   owners (edge cut no worse than the quadrant map's), then
   solve2d_distributed --file --eps 8 --dt 1e-5 --nt 20 --test true in
   float64 on 4 virtual devices of the card: the manufactured contract, and
   the state within 1e-12 of the single-device Solver2D; (b) the headline
   4096^2, eps=8, f32, test form through the executor as 8x8 tiles of 512^2
   on 4 virtual devices, from 61 tiles on device 1 and one on each other,
   --nbalance 20, 200 steps: the gang stretches' and the measured windows'
   ms/step, each rebalance's busy rates and moves, the final balance check,
   bitwise equal to the default map without nbalance, to the run whose every
   step is measured (the rectangle walk) and to the single-device Solver2D,
   the manufactured contract; (c) the reference's acceptance check,
   solve2d_distributed --file data/load_balance_25s_2n.txt on 2 virtual
   devices and _4n.txt on 4, --test_load_balance --nbalance 10 --nt 45
   --eps 5, float64, ten runs each: the balancer moves tiles off the start
   and empties no device; the verdict on measured busy rates ("Load
   balanced correctly", max |busy - mean| <= 1500 of 10000) is recorded
   per run, not gated (on the card's wall clock it fails in about a
   quarter of the 4n runs and about 1 in 100 of the 2n runs: PERF.md
   §6).  Which partitioner ran
   (native or NumPy) is printed.  Counted: one nsum2d a tile a step, and
   one a test-form run for L(G).
12. (Run after phase 11, before phase 9's lines.) The stepper tier and the
   spectral method (phase_steppers): (a) the 4096^2, eps=8, f32 test form to
   the horizon of 500 Euler steps at 0.8x the Euler bound with rkc[8] in
   superstep_floor steps (9) through Solver2D(method="cuda"): the contract,
   exactly 8*steps + 1 nsum2d launches and no step2d, bitwise the same solve
   through nsum2d_plain on the card; the 500-step Euler solve to the same
   horizon, both errors and walls, and the steppings alone in turns; (b) the
   same at 256^3, eps=4, through nsum3d; an rkc step's device time at 4096^2
   and 512^2 (torch.profiler); (c) neighbor_sum_fft against nsum2d at 4096^2
   eps=8 and nsum3d at 128^3 eps=4 (f64 within 1e-12, f32 within 1e-5 of the
   largest magnitude), then fft and nsum2d timed in turns at 4096^2 for eps
   8, 16 and 40, and pick_op_method's pick at each; (d) expo at 4096^2, f32,
   45 steps at 0.25x the Euler bound, S=0 and S=1: the contract, finite, no
   larger than max|u0|*1.01, and one step to (a)'s horizon, printed; (e) in
   float64 on the card, solve2d --method fft over CASES_2D, solve2d --stepper
   rkc --superstep-stages 8 over tests/test_cli.py's row, solve1d --method fft
   --stepper rkc over CASES_1D's rows of at most 500 steps, solve3d --method
   fft --stepper rkc --superstep-stages 4 over CASES_3D's first row, each
   "Tests Passed", and solve2d --test --stepper rkc --superstep-stages 2 --dt
   0.1 exiting 2; (f) an 8 x 512^2 mixed-physics bucket through
   EnsembleEngine(stepper="rkc", stages=4), stacked[rkc], 8*20*4 nsum2d
   launches, each lane bitwise its solo Solver2D stepper solve.  Counted:
   every part but the comparisons and timings.
13. (Run after phase 12, before phase 9's lines.) The distributed stepper
   tier, the sharded spectral tier and the sharded unstructured operator
   (phase_dist_steppers): (a) the 4096^2, eps=8, f32 test form on a 2x2 mesh
   of virtual devices of the card to the horizon of 500 Euler steps with
   rkc[8] in 9 steps: per stage 'collective' (nsum2d), 'fused' (fused_nsum2d)
   and 'fused' under NLHEAT_FUSED_TRANSPORT=interp (split_nsum2d), each
   bitwise the single-device rkc solve, and stage batches of 2 and 4 within
   1e-5 of it (bitwise or not, printed); exactly 4 blocks x 8 stages x 9
   steps launches (split: a launch a phase), plus L(G); the contract; the
   do_work walls to the horizon in turns beside the distributed Euler solves
   (500 steps, collective and fused); (b) the same at 256^3, eps=4, on
   2x2x2 (nsum3d, fused_nsum3d, split_nsum3d); (c) the sharded fft solves
   (euler, rkc[8], expo S=0 and S=1, test form, 3 steps) against the
   single-device fft solves: f64 at 512^2 on 2x2 and 64^3 on 2x2x2 within
   1e-12, f32 at 4096^2 and 256^3 within 1e-5 of the largest magnitude, no
   kernel launched, the f32 ms/step in turns; (d) ShardedUnstructuredOp on 4
   virtual devices, f32 test form, 10 steps: the shuffled 512^2 cloud in
   gang_order (export, gather: bitwise each other and the one-device sharded
   solve, within 1e-5 of the single-device ell solve), the same cloud in its
   lattice order (offsets, superstep K=2 and 4: bitwise the single-device
   offsets solve), the graded mesh in gang_order (auto); comm ratios and
   ms/step; (e) in float64, solve2d_distributed --stepper rkc over
   CASES_2D_DISTRIBUTED and solve3d --distributed --method fft --stepper
   expo --superstep-stages 1 over CASES_3D ("Tests Passed"),
   solve_unstructured --devices 4 --superstep 2 --gang-order false on
   data/50x50.msh (the contract), and solve2d_distributed past the rkc bound
   exiting 2.  Counted: every part but the comparisons and timings.
15. (Run after phase 14, before phase 9's lines.) The serving pipeline
   (phase_serve, serve/server.py): (a) 16 production cases of 1024^2, eps=8,
   f32, two physics, 200 steps, submitted one at a time to
   ServePipeline(depth=2, window_ms=5): every lane bitwise the offline
   EnsembleEngine.run(), 2 x 200 batched_step2d launches as offline,
   occupancy 2, fence_scalar once a retire and never between the
   dispatches (spies), zero retries and fallback chunks, the breaker
   closed; a fence probe (a spin kernel queued behind the first chunk still
   runs when the second dispatch returns); serve_fence_ab's depth-1 and
   depth-2 walls; the stream under NLHEAT_TUNE_BATCH=1 (B7/B8 from the
   serving path) bitwise its offline run; (b) 12 cases of 256^2 in f64 under
   raise@1,stall@3,nan@c6x* with a 200 ms fetch deadline (error, hang and
   corrupt classified, case 6 alone quarantined, the rest bitwise offline),
   then raise@0x2 against a threshold-2 breaker: open, the CPU fallback
   within 1e-12 of the card, the half-open probe closes it; (c) in float64,
   solve2d, solve1d and solve3d --test_batch --serve 2 over their tables
   ("Tests Passed"), solve2d with --metrics-out (the resilience block zero,
   --ensemble's dispatches) and --trace (serve.dispatch spans beside the
   torch.profiler trace); (d) two test-form cases on the shuffled 512^2
   cloud through the pipeline, bitwise the offline gather_L run.  Counted:
   every part.
16. (Run after phase 15.) The leaves of the fleet (phase_fleet_leaves:
   serve/program_store.py, obs/slo.py, serve/picker.py, obs/flightrec.py):
   (a) with NLHEAT_PROGRAM_STORE on an empty store and NLHEAT_TUNE_BATCH=1,
   phase 15's stream (16 x 1024^2 f32, 200 steps, depth 2) and a tuned
   Solver2D at 512^2, eps=8, f32, 500 steps, cold: probes, misses, the
   libraries and program entries saved; then a child process from a copy of
   the package with no _build/, NLHEAT_AUTOTUNE_CACHE="" and no nvcc
   reachable (PATH without it, CUDA_HOME empty) boots from the store: no
   nvcc run, no probe, only the recorded winners' launches, programs
   loaded, every state bitwise the cold boot's; its wall from spawn to the
   first retired chunk beside phase 1's nvcc wall for the libraries it
   restored; a program entry with a rewritten fingerprint is refused loudly
   and rebuilt bitwise.  (b) The stream with every case picked
   (pick_engine over record_rate_fn, a tight accuracy: Euler, 200 steps),
   the SLO ledger off and on: the same dispatches and fences (spies), the
   states bitwise, every promise resolved once, the live per-apply rate
   written under the B6 key.  (c) The 1024^2 test form to the horizon of
   500 Euler steps, picked over the live records and served: error_l2/#points
   <= 1e-6 with the launches its stepper predicts; a mesh-axis pick on the
   shuffled 512^2 cloud served through gather_L.  (d) solve2d --serve 2
   --flight-dir under raise@1,stall@3,nan@c6x* writes a postmortem naming
   case 6; a solve2d child SIGTERMed leaves a sigterm dump.  Counted: every
   part, the child's launches too.
17. (Run after phase 16.) The fleet front door (phase_front_door:
   serve/router.py, serve/transport.py, serve/http.py, parallel/gang.py's
   solve_case_sharded, cli/common.run_listen).  Its workers are this
   script's `--fleet-worker` children (the port's worker main; each writes
   its launches and nvcc runs at exit).  (a) ReplicaRouter(replicas=2,
   method="cuda", f32, batch_sizes=(8,), a shared program store, the gang
   on 4 virtual devices): 16 x 1024^2 f32 over two buckets (nt 200 and
   201, one physics each) bitwise the offline engine, one bucket a replica,
   the /replica{r} scrape; die@5: one death, the cases re-routed bitwise,
   a respawn to the floor; add_replica then drain_replica: the newcomer
   serves the drained bucket from the store (programs built 0), no nvcc,
   only batched_step2d.  (c) 4096^2, eps=8, f32, the test form, 100 steps
   on the gang: "peer" (fused_nsum2d), bitwise solve_case_sharded and
   Solver2DDistributed here; an rkc[8] EngineChoice bitwise; a gang
   restarted under NLHEAT_FUSED_TRANSPORT=interp (split_nsum2d) bitwise the
   peer run; the fused step timed by CUDA events.  On threads beside (a)
   and (c): (b) the stream over TCP with a token, bitwise, a garbage
   connection and a wrong-token hello dropped; (e) a worker whose dispatch
   raises "CUDA error: unspecified launch failure" on a marked case ends
   (no retry, no CPU route), the case retires bitwise from a healthy
   replica; with the failure in every worker the case completes
   exceptionally after MAX_REQUEUES and the others are served.  (d)
   `solve2d --listen 0 --replicas 2 --shard-threshold 1048576
   --gang-devices 4 --slo 1` and `solve3d --listen 0 --replicas 1`
   children: an explicit 1024^2 case bitwise offline (?bin=1), a picked
   case within 1e-6, 422 on an unmeetable deadline, 429 with Retry-After
   on a burst, a mesh upload of the shuffled 512^2 cloud and a case on it
   bitwise gather_L offline, the SLO block, both replica namespaces in
   /metrics, /v1/status with its session count, POST /v1/sessions with an
   empty body 400, rc 0 on EOF with --metrics-out; a 128^3 case bitwise
   offline.  Counted: the phase's own runs and every counted worker's (the
   CLI children's workers are not counted).
18. (Run after phase 17.) Live sessions (phase_sessions: serve/sessions.py,
   the session checkpoints of utils/checkpoint.py, the /v1/sessions* routes
   of serve/http.py, the --session-* flags of cli/common.run_listen).  Each
   leg holds the session against its chunked oracle: the chunk-by-chunk
   composition through an EnsembleEngine on the card, the source added on
   the host in f64 at each chunk's end.  (a) A 4096^2, eps=8, f32 session
   over ServePipeline(depth=1), nt 200 in chunks of 50, preview stride 4, a
   checkpoint a chunk, a retarget of k and a source field (a heater disc)
   queued during chunk 1: every preview and the final f64 field bitwise, the retarget
   applied at step 100; fork(step=100) bitwise the parent's frames; a
   manager closed after chunk 2 and a fresh manager's resume: the frames,
   deduped by (step, kind), bitwise the uninterrupted stream; the chunk log
   (staging, card) and one chunk under torch.profiler; a 1024^2 100-step
   session with NLHEAT_TUNE_BATCH=1 (the batched tuner's pick) bitwise.  (d) A
   128^3, eps=4, f32 session: bitwise, launching nsum3d or step3d.  On
   threads: (b) `solve2d --listen 0 --replicas 2 --session-checkpoint-dir
   D --session-checkpoint-every 2 --session-rate 50`: two 1024^2 sessions
   (nt 200, chunks of 25) over HTTP with a retarget of k, a fork from the
   step-100 checkpoint and a third session closed, one replica worker
   SIGKILLed mid-session (the CLI takes no fault plan; the kill is what a
   die@ plan does) and a paced batch load beside: every SSE stream complete,
   in step order and without a duplicate, every preview and result?bin=1
   bitwise; the batch tier's shed count and p99 and the sessions' deferrals
   recorded, not gated.  (c) A session over a shuffled jittered 256^2 cloud
   registered by POST /v1/meshes on an in-process front door whose counted
   worker launches gather_L: bitwise.  Counted: the phase's own runs and
   (c)'s worker.
9. The kernels' JSON line (nsum2d's launches those of phases 4, 8, 10, 11,
   12, 13, 15 and 16, the other kernels' those of their phases and of phases
   10-18), then {"ok": true, "device": {...}}.

Exits non-zero and prints no result when torch.cuda.is_available() is false
or when the port package is not beside this script.

``python3 chip_smoke.py --ab DIR [SECTION ...]`` prints instead one line of
A/B timings of the package under DIR (ab_main: the kernels of phase 4, the
lattice sweep, the tuned and per-step solves; the 3D kernels at 256^3; the
2D halo kernels at the 2048^2 block and split_nsum2d at smaller blocks, and
the 3D ones at the 128^3 block, with their outputs' digests; the 4096^2 2x2
and 256^3 2x2x2 distributed steps; the resident kernels against carried2d/carried3d
in CUDA graphs, resident2d's RUN sweep and its step without the barrier on
scratch builds, the tuned 512^2 and 128^3 eps=6 solves); run it on a parent tree and on this one in turns,
in one call, to compare them on one card.
"""

from __future__ import annotations

import atexit
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 20261016
NX, EPS, STEPS, TEST_STEPS = 4096, 8, 500, 20
RESIDENT_HOLDS = (1, 2, 7, TEST_STEPS, 64)  # the resident runs held bitwise to step launches
SMALL = 512        # the small production grid, where resident fits
VARIANT_STEPS = 100  # steps per timed multi-step run at 4096^2 (500 at 512^2)
GRAPH_LAUNCHES = 100  # launches per CUDA graph when timing a kernel alone at 512^2
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
TOL = {"float64": 1e-12, "float32": 1e-5}
CHILDREN: list = []    # the CLI processes this run started
N3, EPS3 = 256, 4      # the 3D headline: 256^3, eps=4, f32 (64 MiB of state)
N3S, EPS3S = 128, 6    # the small 3D grid, where resident3d fits the L2
STEPS3 = 200           # steps of the 3D production solves and timed variant runs
REPICKS = 5            # fresh 3D tuner picks a shape, after the main path
ENS_B, ENS_N = 8, 1024  # the JAX package's ensemble8x1024: 8 cases of 1024^2 (32 MiB f32)
ENS_MIXED_N = 512      # the mixed-physics ensemble bucket, 8 cases of 512^2
# nx ny nz nt eps k dt dh: a copy of tests/test_oracle_3d.py's CASES_3D (that
# file imports JAX; tests/test_torch_3d.py holds the copy equal to it)
CASES_3D = [
    (16, 16, 16, 20, 3, 1.0, 0.0005, 0.0625),
    (12, 12, 12, 40, 2, 1.0, 0.0002, 1.0 / 12),
    (16, 12, 8, 20, 3, 0.5, 0.0005, 0.05),
    (6, 6, 6, 10, 8, 1.0, 0.0001, 1.0 / 6),   # eps > grid: degenerate halo
]


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str):
    print(msg, flush=True)


def nvidia_smi(query: str) -> str:
    r = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    return r.stdout.strip()


def cases_module():
    path = ROOT / "tests" / "cases.py"
    if not path.is_file():
        fail(f"{path} not found: run from a checkout of the repository")
    spec = importlib.util.spec_from_file_location("nlheat_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cases():
    mod = cases_module()
    return mod.CASES_2D, mod.CASES_1D, mod.L2_THRESHOLD


def cuda_ms(torch, fn, reps: int, warm: int = 3) -> float:
    """Mean milliseconds per call of fn over reps calls, by CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def bound(nbytes: float, ops: float) -> tuple:
    """(least ms, what bounds it) on an H100 SXM at its published peaks."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def kernel_ops(eps: int, epilogue: int) -> float:
    """Operations per output point of the kernels' algorithm (the tile body,
    csrc/stencil_tile.cuh):
    the row window sums add 2*eps terms into each cell of a tile's
    (32+2eps) x 32 window rows, shared by its 32 output rows; each output then
    adds 2*eps+1 of them, and the step ``epilogue`` more: 41 + epilogue at
    eps=8, where the direct sum over the mask takes 196 adds."""
    return 2 * eps * (32 + 2 * eps) / 32 + (2 * eps + 1) + epilogue


def kernel_ops_3d(eps: int, tp: int, epilogue: int) -> float:
    """Operations per output point of the 3D kernels' algorithm (the tile
    body, csrc/stencil_tile3d.cuh, at plane width tp): the z window sums add
    2*eps terms into each of a tile's (tp+2eps)^2 x 32 window cells, shared
    by its tp^2 x 32 outputs; each output then adds one term per sphere
    column, and the step ``epilogue`` more: 81 + epilogue at eps=4, tp=8,
    where the direct sum over the sphere takes 256 adds."""
    from nonlocalheatequation_torch.ops.stencil import sphere_column_heights

    columns = int((sphere_column_heights(eps) >= 0).sum())
    return 2 * eps * (tp + 2 * eps) ** 2 / tp ** 2 + columns + epilogue


def phase_checks(torch, ck, np) -> dict:
    """Phase 2: every kernel against its plain version on the card."""
    rng = np.random.default_rng(SEED)
    shapes = [(1, 1), (37, 50), (64, 64), (13, 45), (3, 100)]
    plan = [(e, s) for e in (1, 3, 5, 8, 10, 16) for s in shapes]
    plan += [(40, (50, 45)), (40, (20, 90))]  # eps above the 32-point tile
    worst = {}
    n = {"nsum2d": 0, "step2d": 0}
    for dtype in (torch.float64, torch.float32):
        tol = TOL[str(dtype).split(".")[1]]
        for prec in ("f32", "bf16"):
            for e, (nx, ny) in plan:
                upad = torch.tensor(rng.standard_normal((nx + 2 * e, ny + 2 * e)),
                                    dtype=dtype, device="cuda")
                u = upad[e:e + nx, e:e + ny].contiguous()
                g, lg = torch.randn_like(u), torch.randn_like(u)
                wsum = float(sum(2 * h + 1 for h in ck.column_half_heights(e)))
                scale, dt = 2.0 + e, 0.8 / ((2.0 + e) * wsum)
                runs = [("nsum2d", lambda p: ck.nsum2d(upad, e, p),
                         lambda p: ck.nsum2d_plain(upad, e, p))]
                for kw in ({}, {"g": g, "lg": lg, "t": 7}):
                    runs.append(("step2d",
                                 lambda p, kw=kw: ck.step2d(u, e, scale, wsum, dt,
                                                            precision=p, **kw),
                                 lambda p, kw=kw: ck.step2d_plain(u, e, scale, wsum, dt,
                                                                  precision=p, **kw)))
                for name, kern, plain in runs:
                    a, b = kern(prec), plain(prec)
                    torch.cuda.synchronize()
                    ref = float(b.abs().max()) or 1.0
                    err = float((a - b).abs().max()) / ref
                    if not err <= tol:
                        fail(f"{name} {dtype} {prec} eps={e} {nx}x{ny}: rel err {err:.3e} "
                             f"> {tol:g}")
                    key = f"{name}/{str(dtype).split('.')[1]}/{prec}"
                    worst[key] = max(worst.get(key, 0.0), err)
                    n[name] += 1
    # a CUDA tensor the kernel cannot take raises; it never falls back
    try:
        ck.nsum2d(torch.zeros(200, 200, device="cuda", dtype=torch.float64), 70)
        fail("nsum2d accepted eps=70 (beyond its shared-memory tile) on the card")
    except ValueError:
        pass
    say("kernel checks (max |kernel-plain| / max|plain|): "
        + ", ".join(f"{k} {v:.2e}" for k, v in sorted(worst.items()))
        + f"; cases nsum2d {n['nsum2d']}, step2d {n['step2d']}: pass")
    return n


SOLO_EPS = (0, 1, 3, 8, 16, 17, 40)


def phase_solo_checks(torch, ck, np) -> dict:
    """Phase 2, the solo step kernels, each one launch of a batched kernel at
    B=1 (csrc/batched_step2d.cu, csrc/batched_carried2d.cu): step2d
    (production and test form) and carried2d (into a NaN-filled ``out``,
    whose halo the wrapper zeroes) in float64, float32 and the bf16 operand
    tier at eps 0, 1, 3, 8, 16, 17 and 40, BITWISE against their plain
    versions, over 1x1, shapes that are no tile multiples, a 512^2 plane (in
    float32 fewer tiles than the card has SMs: the tile body) and 1100 x 700
    (more tiles than SMs, not tile multiples: the register walk up to eps
    16 in both types).  A horizon beyond the kernels' limit raises, naming
    the solo kernel."""
    import torch.nn.functional as F

    rng = np.random.default_rng(SEED + 9)
    shapes = [(1, 1), (37, 50), (130, 45), (512, 512), (1100, 700)]
    n = {"step2d": 0, "carried2d": 0}

    def hold(name, form, got, plain):
        if not torch.equal(got, plain):
            _abs, err = rel_err(torch, got, plain)
            fail(f"{name} {form}: not bitwise equal to its plain version (|kernel-plain| / "
                 f"max|plain| {err:.3e})")
        n[name] += 1

    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[1]
        for prec in ("f32", "bf16"):
            for e in SOLO_EPS:
                wsum = float(sum(2 * h + 1 for h in ck.column_half_heights(e)))
                scale, dt = 2.0 + e, 0.8 / ((2.0 + e) * wsum)
                for nx, ny in shapes:
                    form = f"{dname} {prec} eps={e} {nx}x{ny}"
                    u = torch.tensor(rng.standard_normal((nx, ny)), dtype=dtype, device="cuda")
                    g, lg = torch.randn_like(u), torch.randn_like(u)
                    hold("step2d", form, ck.step2d(u, e, scale, wsum, dt, precision=prec),
                         ck.step2d_plain(u, e, scale, wsum, dt, precision=prec))
                    hold("step2d", f"{form} test form",
                         ck.step2d(u, e, scale, wsum, dt, g=g, lg=lg, t=11, precision=prec),
                         ck.step2d_plain(u, e, scale, wsum, dt, g=g, lg=lg, t=11,
                                         precision=prec))
                    frame = F.pad(u, (e,) * 4).contiguous()
                    plain = ck.carried2d_plain(frame, e, scale, wsum, dt,
                                               ck.shadow_of(frame) if prec == "bf16" else None)
                    hold("carried2d", form,
                         ck.carried2d(frame, e, scale, wsum, dt, prec,
                                      out=torch.full_like(frame, float("nan"))),
                         plain[0] if prec == "bf16" else plain)
    z = torch.zeros(200, 200, device="cuda", dtype=torch.float64)
    for name, call in (("step2d", lambda: ck.step2d(z, 70, 1.0, 1.0, 1e-3)),
                       ("carried2d", lambda: ck.carried2d(F.pad(z, (70,) * 4), 70, 1.0, 1.0,
                                                          1e-3))):
        try:  # a CUDA tensor the kernel cannot take raises; it never falls back
            call()
            fail(f"{name} accepted eps=70 (beyond the kernels' limit) on the card")
        except ValueError as err:
            if not str(err).startswith(f"{name}: eps=70"):
                fail(f"{name}'s refusal does not name it: {err}")
    say(f"solo step kernels (batched_step2d/batched_carried2d at B=1), eps "
        f"{list(SOLO_EPS)}, float64/float32, f32/bf16 tiers, shapes {shapes}: every case "
        f"bitwise equal to its plain version; cases step2d {n['step2d']}, carried2d "
        f"{n['carried2d']}; eps=70 refused by name: pass")
    return n


def rel_err(torch, got, ref) -> tuple:
    """(max|got - ref|, that over max|ref|), after a synchronize."""
    torch.cuda.synchronize()
    abs_err = float((got.double() - ref.double()).abs().max())
    return abs_err, abs_err / (float(ref.abs().max()) or 1.0)


def phase_multistep_checks(torch, ck, np) -> dict:
    """Phase 2, multi-step kernels: each against its plain version and,
    bitwise, against the same number of step2d launches; superstep2d also
    bitwise against its plain version (K plain steps in disc_sum's order).

    Where a kernel and its plain version summed in different orders, in the
    bf16 tier their states differed in the last bits after the first step,
    and a value on a bfloat16 rounding boundary could round the other way:
    the next operand then differed by one bfloat16 ulp (2^-8 relative),
    passed on with the operator's gain dt*scale*wsum.  The tolerance there
    grows by that much per step after the first; the bitwise checks are the
    exact ones."""
    import torch.nn.functional as F

    rng = np.random.default_rng(SEED + 1)
    shapes = [(1, 1), (37, 50), (64, 64), (13, 45), (3, 100), (70, 90)]
    plan = [(e, s) for e in (1, 3, 5, 8, 10, 16) for s in shapes]
    plan += [(40, (50, 45)), (60, (20, 90))]  # eps above the tile; about the largest in f64
    worst, n = {}, {"carried2d": 0, "superstep2d": 0, "resident2d": 0}

    def hold(name, form, got, plain, tol, bits):
        _abs, err = rel_err(torch, got, plain)
        if not torch.equal(got, bits):
            fail(f"{name} {form}: not bitwise equal to the same number of step2d launches")
        if name == "superstep2d" and not torch.equal(got, plain):
            fail(f"{name} {form}: not bitwise equal to its plain version")
        if not err <= tol:
            fail(f"{name} {form}: |kernel-plain| / max|plain| {err:.3e} > {tol:.3e}")
        key = f"{name}/{form.split()[0]}/{form.split()[1]}"
        worst[key] = max(worst.get(key, 0.0), err)
        n[name] += 1

    for dtype in (torch.float64, torch.float32):
        tol = TOL[str(dtype).split(".")[1]]
        for prec in ("f32", "bf16"):
            for e, (nx, ny) in plan:
                u = torch.tensor(rng.standard_normal((nx, ny)), dtype=dtype, device="cuda")
                wsum = float(sum(2 * h + 1 for h in ck.column_half_heights(e)))
                scale, dt = 2.0 + e, 0.8 / ((2.0 + e) * wsum)
                flip = dt * scale * wsum * 2.0 ** -8 if prec == "bf16" else 0.0
                form = f"{str(dtype).split('.')[1]} {prec} eps={e} {nx}x{ny}"
                op = types.SimpleNamespace(eps=e, c=scale, dh=1.0, wsum=wsum, dt=dt,
                                           precision=prec)
                steps = [u]
                for _ in range(7):
                    steps.append(ck.step2d(steps[-1], e, scale, wsum, dt, precision=prec))
                # carried: three launches, the last against one plain step
                frame = F.pad(u, (e,) * 4).contiguous()
                for _ in range(3):
                    prev = frame  # into a NaN-filled out, whose halo the wrapper zeroes
                    frame = ck.carried2d(prev, e, scale, wsum, dt, prec,
                                         out=torch.full_like(prev, float("nan")))
                plain = ck.carried2d_plain(prev, e, scale, wsum, dt,
                                           ck.shadow_of(prev) if prec == "bf16" else None)
                bits = F.pad(steps[3], (e,) * 4)
                hold("carried2d", form, frame, plain[0] if prec == "bf16" else plain, tol,
                     bits)
                # superstep: one launch at each K it takes, and 7 steps at K=3 (3+3+1)
                for k in (1, 2, 3, 4):
                    if ck.fits_superstep(nx, ny, e, k, dtype, prec):
                        hold("superstep2d", f"{form} K={k}",
                             ck.superstep2d(u, e, scale, wsum, dt, k, prec),
                             ck.superstep2d_plain(u, e, scale, wsum, dt, k, prec),
                             tol + (k - 1) * flip, steps[k])
                if ck.fits_superstep(nx, ny, e, 3, dtype, prec):
                    hold("superstep2d", f"{form} 7 steps K=3",
                         ck.make_superstep_multi_step_fn(op, 7, ksteps=3)(u, 0),
                         ck.superstep2d_plain(u, e, scale, wsum, dt, 7, prec),
                         tol + 6 * flip, steps[7])
                # resident: the whole run in one launch (no bf16 tier); over
                # 7 and 64 steps bitwise step2d launches only
                if prec == "f32" and ck.fits_resident(nx, ny, e, dtype):
                    for k in (1, 2, 5):
                        hold("resident2d", f"{form} {k} steps",
                             ck.resident2d(u, e, scale, wsum, dt, k),
                             ck.resident2d_plain(u, e, scale, wsum, dt, k), tol, steps[k])
                    while len(steps) <= 64:
                        steps.append(ck.step2d(steps[-1], e, scale, wsum, dt))
                    for k in (7, 64):
                        hold("resident2d", f"{form} {k} steps",
                             ck.resident2d(u, e, scale, wsum, dt, k), steps[k], tol, steps[k])
    try:  # a grid beyond the gate raises, naming the kernel; nothing falls back
        ck.resident2d(torch.zeros(NX, NX, device="cuda"), EPS, 1.0, 197.0, 1e-3, 2)
        fail(f"resident2d accepted a {NX}^2 grid, beyond its gate, on the card")
    except ValueError as e:
        if "resident kernel" not in str(e):
            fail(f"resident2d's refusal does not name the kernel: {e}")
    say("multi-step kernel checks (max |kernel-plain| / max|plain|; every case bitwise "
        "equal to step2d launches, superstep2d also to its plain version): "
        + ", ".join(f"{k} {v:.2e}" for k, v in sorted(worst.items()))
        + f"; cases carried2d {n['carried2d']}, superstep2d {n['superstep2d']}, resident2d "
        f"{n['resident2d']}; resident2d refuses {NX}^2: pass")
    return n


def phase_checks_3d(torch, k3, np) -> dict:
    """Phase 2, the 3D kernels: nsum3d and step3d (production and test form)
    in float64, float32 and the bf16 operand tier BITWISE against their
    plain versions (which sum in the tile body's order, sphere_sum);
    carried3d and resident3d (no bf16 tier) against theirs and, bitwise,
    against the same number of step3d launches (carried3d after each of 3
    launches, each into a NaN-filled ``out``, also bitwise its plain
    version; resident3d over 1, 2 and 5
    steps); eps 0-8 (the register design up to 6, the tile body at 7 and 8)
    over ragged shapes (1x1x1, non tile multiples, n < 2*eps, nx != ny !=
    nz; nz = 9, whose frame z 9 + 2eps is odd, so carried3d stages one cell a
    copy, and nz = 40, 16 bytes a copy at even eps in float32).  resident3d
    at 256^3, eps=4 must raise ValueError, and nsum3d beyond its eps limit
    too."""
    import torch.nn.functional as F

    from nonlocalheatequation_torch.ops.stencil import horizon_mask_3d

    rng = np.random.default_rng(SEED + 3)
    shapes = [(1, 1, 1), (5, 7, 9), (9, 17, 33), (3, 12, 40), (20, 11, 6)]
    plan = [(e, s) for e in range(9) for s in shapes]
    worst, n = {}, dict.fromkeys(("nsum3d", "step3d", "carried3d", "resident3d"), 0)

    def hold(name, form, got, plain, tol, bits=None):
        _abs, err = rel_err(torch, got, plain)
        if bits is not None and not torch.equal(got, bits):
            fail(f"{name} {form}: not bitwise equal to "
                 + ("its plain version" if bits is plain else
                    "the same number of step3d launches"))
        if not err <= tol:
            fail(f"{name} {form}: |kernel-plain| / max|plain| {err:.3e} > {tol:g}")
        key = f"{name}/{form.split()[0]}/{form.split()[1]}"
        worst[key] = max(worst.get(key, 0.0), err)
        n[name] += 1

    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[1]
        tol = TOL[dname]
        for e, (nx, ny, nz) in plan:
            wsum = float(horizon_mask_3d(e).sum())
            scale, dt = 2.0 + e, 0.8 / ((2.0 + e) * wsum)
            upad = torch.tensor(rng.standard_normal((nx + 2 * e, ny + 2 * e, nz + 2 * e)),
                                dtype=dtype, device="cuda")
            u = upad[e:e + nx, e:e + ny, e:e + nz].contiguous()
            g, lg = torch.randn_like(u), torch.randn_like(u)
            for prec in ("f32", "bf16"):
                form = f"{dname} {prec} eps={e} {nx}x{ny}x{nz}"
                plain = k3.nsum3d_plain(upad, e, prec)
                hold("nsum3d", form, k3.nsum3d(upad, e, prec), plain, tol, plain)
                for kw in ({}, {"g": g, "lg": lg, "t": 7}):
                    plain = k3.step3d_plain(u, e, scale, wsum, dt, precision=prec, **kw)
                    hold("step3d", form + (" test form" if kw else ""),
                         k3.step3d(u, e, scale, wsum, dt, precision=prec, **kw), plain, tol,
                         plain)
            # the multi-step kernels (no bf16 tier) against one chain of plain
            # frame steps from u and, bitwise, against step3d launches
            form = f"{dname} f32 eps={e} {nx}x{ny}x{nz}"
            steps, plain = [u], [F.pad(u, (e,) * 6)]
            for _ in range(5):
                steps.append(k3.step3d(steps[-1], e, scale, wsum, dt))
                plain.append(k3.carried3d_plain(plain[-1], e, scale, wsum, dt))
            frame = plain[0].contiguous()
            for s in range(1, 4):  # out NaN-filled: the wrapper zeroes its halo
                frame = k3.carried3d(frame, e, scale, wsum, dt,
                                     out=torch.full_like(frame, float("nan")))
                hold("carried3d", f"{form} launch {s}", frame, plain[s], tol,
                     F.pad(steps[s], (e,) * 6))
                if not torch.equal(frame, plain[s]):
                    fail(f"carried3d {form} launch {s}: not bitwise equal to its plain version")
            if k3.fits_resident_3d(nx, ny, nz, e, dtype):
                for k in (1, 2, 5):
                    hold("resident3d", f"{form} {k} steps", k3.resident3d(u, e, scale, wsum, dt, k),
                         plain[k][e:e + nx, e:e + ny, e:e + nz], tol, steps[k])
                while len(steps) <= 64:  # over 7 and 64 steps bitwise step3d launches only
                    steps.append(k3.step3d(steps[-1], e, scale, wsum, dt))
                for k in (7, 64):
                    hold("resident3d", f"{form} {k} steps", k3.resident3d(u, e, scale, wsum, dt, k),
                         steps[k], tol, steps[k])
    if not n["resident3d"]:
        fail("resident3d took none of the phase-2 grids")
    try:  # a grid beyond the gate raises, naming the kernel; nothing falls back
        k3.resident3d(torch.zeros(N3, N3, N3, device="cuda"), EPS3, 1.0, 257.0, 1e-3, 2)
        fail(f"resident3d accepted {N3}^3 eps={EPS3} f32, beyond its gate, on the card")
    except ValueError as e:
        if "resident 3D kernel" not in str(e):
            fail(f"resident3d's refusal does not name the kernel: {e}")
    try:
        k3.nsum3d(torch.zeros(30, 30, 30, device="cuda", dtype=torch.float64), 13)
        fail("nsum3d accepted eps=13 (beyond its shared-memory tile) on the card")
    except ValueError:
        pass
    say("3D kernel checks (max |kernel-plain| / max|plain|; nsum3d and step3d every case "
        "bitwise equal to their plain versions, carried3d to its plain version and step3d "
        "launches, resident3d to step3d launches): "
        + ", ".join(f"{k} {v:.2e}" for k, v in sorted(worst.items()))
        + "; cases " + ", ".join(f"{k} {v}" for k, v in n.items())
        + f"; resident3d refuses {N3}^3 eps={EPS3}: pass")
    return n


CLI_ARGS = ["--test_batch", "--platform", "gpu", "--x64", "1"]


def batch_text(rows) -> str:
    """A batch table as the CLIs read it on stdin."""
    return f"{len(rows)}\n" + "".join(" ".join(map(str, r)) + "\n" for r in rows)


def start_cli(module: str, rows, extra=()) -> subprocess.Popen:
    """Start a port CLI's batch mode on the card in float64 with ``rows`` as
    its stdin (a temporary file, so the CLIs run side by side)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    with tempfile.TemporaryFile("w+") as stdin:
        stdin.write(batch_text(rows))
        stdin.seek(0)
        return subprocess.Popen([sys.executable, "-m", module, *CLI_ARGS, *extra], cwd=ROOT,
                                env=env, stdin=stdin, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)


def start_clis(cases_2d, cases_1d) -> tuple:
    """Phase 3's batch tables through the CLIs (CASES_2D, CASES_1D, CASES_3D,
    float64), and CASES_1D and CASES_3D through the ensemble engine
    (``--ensemble``; the 2D table runs it in phase 6, counted), started right
    after the build so that they run beside phase 2; (jobs, start time).
    Any still running at exit are stopped."""
    jobs = {}
    for name, rows, extra in (("solve2d", cases_2d, ()), ("solve1d", cases_1d, ()),
                              ("solve3d", CASES_3D, ()),
                              ("solve1d", cases_1d, ("--ensemble",)),
                              ("solve3d", CASES_3D, ("--ensemble",))):
        proc = start_cli(f"nonlocalheatequation_torch.cli.{name}", rows, extra)
        CHILDREN.append(proc)
        jobs[" ".join((name, *extra))] = (rows, proc)
    return jobs, time.perf_counter()


def end_child(proc):
    """Kill a child that is still up, and its own children with it when it
    leads a session of its own (a --listen CLI and its replica workers)."""
    import signal

    if proc.poll() is not None:
        return
    try:
        if os.getpgid(proc.pid) == proc.pid:
            os.killpg(proc.pid, signal.SIGKILL)
        else:
            proc.kill()
    except ProcessLookupError:
        pass
    proc.wait()


def stop_children():
    for proc in CHILDREN:
        end_child(proc)


def phase_main_path_tables(torch, clis, cases_2d, l2_threshold):
    """Phase 3: the CLIs' batch tables (f64) must print "Tests Passed", then
    CASES_2D and CASES_3D in f32 through Solver2D and Solver3D."""
    from nonlocalheatequation_torch.models.solver2d import Solver2D
    from nonlocalheatequation_torch.models.solver3d import Solver3D

    jobs, t0 = clis
    for name, (rows, proc) in jobs.items():
        out, err = proc.communicate(timeout=600)
        if proc.returncode != 0 or "Tests Passed" not in out:
            fail(f"{name} --test_batch --platform gpu --x64 1: rc {proc.returncode}\n"
                 f"{out}\n{err[-4000:]}")
        summary = [line for line in err.splitlines() if line.startswith("ensemble: ")]
        say(f"cli {name} --test_batch --platform gpu --x64 1: Tests Passed ({len(rows)} rows)"
            + (f"; {summary[-1]}" if summary else ""))
    say(f"cli wall (beside phase 2): {time.perf_counter() - t0:.1f} s")
    worst = 0.0
    for nx, ny, nt, eps, k, dt, dh in cases_2d:
        s = Solver2D(nx, ny, nt, eps, k=k, dt=dt, dh=dh, dtype=torch.float32, device="cuda")
        s.test_init()
        s.do_work()
        worst = max(worst, s.error_l2 / (nx * ny))
    if not worst <= l2_threshold:
        fail(f"CASES_2D in float32: error_l2/#points {worst:.3e} > {l2_threshold:g}")
    say(f"CASES_2D float32 through Solver2D (cuda): largest error_l2/#points {worst:.3e} "
        f"<= {l2_threshold:g}")
    worst = 0.0
    for nx, ny, nz, nt, eps, k, dt, dh in CASES_3D:
        s = Solver3D(nx, ny, nz, nt, eps, k=k, dt=dt, dh=dh, dtype=torch.float32,
                     device="cuda")
        s.test_init()
        s.do_work()
        worst = max(worst, s.error_l2 / (nx * ny * nz))
    if not worst <= l2_threshold:
        fail(f"CASES_3D in float32: error_l2/#points {worst:.3e} > {l2_threshold:g}")
    say(f"CASES_3D float32 through Solver3D (cuda): largest error_l2/#points {worst:.3e} "
        f"<= {l2_threshold:g}")


def phase_headline(torch, np, ck, cb, l2_threshold) -> list:
    """Phase 4: kernel timings at the headline shape, then the main path."""
    import torch.nn.functional as F

    from nonlocalheatequation_torch.models.solver2d import Solver2D
    from nonlocalheatequation_torch.ops.nonlocal_op import (
        NonlocalOp2D,
        case_scale,
        full_fp32,
        make_multi_step_fn,
    )
    from nonlocalheatequation_torch.utils import autotune

    dh = 1.0 / NX
    probe = NonlocalOp2D(EPS, 1.0, 1.0, dh)
    dt = 0.8 / (probe.c * dh * dh * probe.wsum)  # 0.8x the Euler bound, as bench.py
    op = NonlocalOp2D(EPS, 1.0, dt, dh, method="cuda")
    scale, wsum = case_scale(op), op.wsum
    u0 = np.random.default_rng(SEED).standard_normal((NX, NX))
    u = torch.as_tensor(u0, device="cuda").to(torch.float32)
    upad = F.pad(u, (EPS,) * 4)
    out = torch.empty_like(u)
    g, lg = torch.randn_like(u), torch.randn_like(u)
    isz, npts = 4, NX * NX

    # every form at the main path's shape against its plain version
    held = {k: [] for k in ck.LAUNCHES}

    def hold(name, form, got, ref, tol):
        torch.cuda.synchronize()
        abs_err = float((got - ref).abs().max())
        rel = abs_err / (float(ref.abs().max()) or 1.0)
        held[name].append({"form": form, "max_abs_err": abs_err, "rel_err": rel, "tol": tol})
        if not rel <= tol:
            fail(f"{name} {form} at {NX}^2 eps={EPS}: |kernel-plain| / max|plain| "
                 f"{rel:.3e} > {tol:g}")

    tol32 = TOL["float32"]
    for prec in ("f32", "bf16"):
        hold("nsum2d", f"float32 {prec}", ck.nsum2d(upad, EPS, prec),
             ck.nsum2d_plain(upad, EPS, prec), tol32)
        hold("step2d", f"float32 {prec} production",
             ck.step2d(u, EPS, scale, wsum, dt, precision=prec),
             ck.step2d_plain(u, EPS, scale, wsum, dt, precision=prec), tol32)
        hold("step2d", f"float32 {prec} test form",
             ck.step2d(u, EPS, scale, wsum, dt, g=g, lg=lg, t=3, precision=prec),
             ck.step2d_plain(u, EPS, scale, wsum, dt, g=g, lg=lg, t=3, precision=prec), tol32)
    gpad = F.pad(torch.as_tensor(op.spatial_profile(NX, NX), device="cuda"), (EPS,) * 4)
    hold("nsum2d", "float64 f32 (padded G, the test-form source's input)",
         ck.nsum2d(gpad, EPS), ck.nsum2d_plain(gpad, EPS), TOL["float64"])
    del gpad
    say(f"kernels at the main path's shape {NX}^2 eps={EPS} "
        "(|kernel-plain| / max|plain|): "
        + "; ".join(f"{n} {c['form']} {c['rel_err']:.2e} <= {c['tol']:g}"
                    for n, cs in held.items() for c in cs))

    # the test-form source's set-up: (G, L(G)) on the card, as Solver2D makes
    # it (L(G) through nsum2d in float64), against NumPy float64 (the
    # oracle's way); both sum the same 197 terms in other orders, and L(G)
    # cancels them, so the tolerance is relative to the terms' size
    t0 = time.perf_counter()
    g_np, lg_np = op.source_parts(NX, NX)
    src_np_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _g_dev, lg_dev = op.source_parts_on(NX, NX, "cuda")
    torch.cuda.synchronize()
    src_dev_s = time.perf_counter() - t0
    terms = scale * wsum * float(np.abs(g_np).max())
    src_err = float(np.abs(lg_dev.cpu().numpy() - lg_np).max()) / terms
    if not src_err <= TOL["float64"]:
        fail(f"L(G) on the card vs NumPy at {NX}^2: {src_err:.3e} of the terms' size > "
             f"{TOL['float64']:g}")
    del g_np, lg_np, _g_dev, lg_dev
    say(f"test-form source set-up (G, L(G)) float64 {NX}^2 eps={EPS}: on the card "
        f"(Solver2D, nsum2d) {src_dev_s:.4f} s, NumPy (oracle) {src_np_s:.4f} s; "
        f"|card-NumPy| / (scale*wsum*max|G|) {src_err:.2e} <= {TOL['float64']:g}")

    step_ms = cuda_ms(torch, lambda: ck.step2d(u, EPS, scale, wsum, dt, out=out), 200)
    step_test_ms = cuda_ms(torch, lambda: ck.step2d(u, EPS, scale, wsum, dt, g=g, lg=lg,
                                                    t=3, out=out), 200)
    step_plain_ms = cuda_ms(torch, lambda: ck.step2d_plain(u, EPS, scale, wsum, dt), 5, 1)
    nsum_ms = cuda_ms(torch, lambda: ck.nsum2d(upad, EPS), 200)
    nsum_plain_ms = cuda_ms(torch, lambda: ck.nsum2d_plain(upad, EPS), 5, 1)
    kern = torch.as_tensor(op.weights, dtype=torch.float32, device="cuda")[None, None]
    with full_fp32():
        conv_ms = cuda_ms(torch, lambda: F.conv2d(upad[None, None], kern), 20)
        conv_out = F.conv2d(upad[None, None], kern)[0, 0]
    conv_err = float((conv_out - ck.nsum2d_plain(upad, EPS)).abs().max())
    # epilogue: 5 operations for u + dt*(scale*(nsum - wsum*u)), 4 more for the
    # test form's source terms
    nsum_bound = bound(((NX + 2 * EPS) ** 2 + npts) * isz, npts * kernel_ops(EPS, 0))
    step_bound = bound(2 * npts * isz, npts * kernel_ops(EPS, 5))
    step_test_bound = bound(4 * npts * isz, npts * kernel_ops(EPS, 9))
    say("TF32 disabled for the F.conv2d yardstick (cudnn.allow_tf32=False, "
        "cuda.matmul.allow_tf32=False)")
    say(f"nsum2d {NX}^2 eps={EPS} f32: kernel {nsum_ms:.4f} ms, plain {nsum_plain_ms:.3f} ms, "
        f"F.conv2d {conv_ms:.4f} ms (max abs diff to plain {conv_err:.2e}), "
        f"bound {nsum_bound[0]:.4f} ms ({nsum_bound[1]})")
    say(f"step2d {NX}^2 eps={EPS} f32 production: kernel {step_ms:.4f} ms, "
        f"plain {step_plain_ms:.3f} ms, bound {step_bound[0]:.4f} ms ({step_bound[1]})")
    say(f"step2d {NX}^2 eps={EPS} f32 test form: kernel {step_test_ms:.4f} ms, "
        f"bound {step_test_bound[0]:.4f} ms ({step_test_bound[1]})")

    # the multi-step kernels at the main path's shape: against their plain
    # versions, and bitwise against step2d launches
    bits = [u]
    for _ in range(3):
        bits.append(ck.step2d(bits[-1], EPS, scale, wsum, dt))
    frame = F.pad(u, (EPS,) * 4).contiguous()
    fout = torch.zeros_like(frame)  # the timed launches write its interior only
    hold("carried2d", "float32 f32 one launch", ck.carried2d(frame, EPS, scale, wsum, dt),
         ck.carried2d_plain(frame, EPS, scale, wsum, dt), tol32)
    hold("carried2d", "float32 bf16 one launch",
         ck.carried2d(frame, EPS, scale, wsum, dt, "bf16"),
         ck.carried2d_plain(frame, EPS, scale, wsum, dt, ck.shadow_of(frame))[0], tol32)
    bitwise = {"carried2d 3 steps": torch.equal(
        ck.make_carried_multi_step_fn(op, 3)(u, 0), bits[3])}
    for k in (2, 3):
        got = ck.superstep2d(u, EPS, scale, wsum, dt, k)
        plain = ck.superstep2d_plain(u, EPS, scale, wsum, dt, k)
        hold("superstep2d", f"float32 f32 K={k}", got, plain, tol32)
        bitwise[f"superstep2d K={k}"] = torch.equal(got, bits[k])
        bitwise[f"superstep2d K={k} = plain"] = torch.equal(got, plain)
    del bits, got, plain
    if not all(bitwise.values()):
        fail(f"multi-step kernels at {NX}^2 eps={EPS}: bitwise equal to step2d launches "
             f"{bitwise}")
    say(f"multi-step kernels at {NX}^2 eps={EPS}: bitwise equal to step2d launches "
        f"{json.dumps(bitwise)}; |kernel-plain| / max|plain| "
        + "; ".join(f"{n} {c['form']} {c['rel_err']:.2e}" for n in ("carried2d", "superstep2d")
                    for c in held[n]))

    carried_ms = cuda_ms(torch, lambda: ck._carried2d(frame, fout, EPS, scale, wsum, dt, "f32"),
                         200)
    carried_plain_ms = cuda_ms(torch, lambda: ck.carried2d_plain(frame, EPS, scale, wsum, dt),
                               5, 1)
    sup_ms = {k: cuda_ms(torch, lambda k=k: ck.superstep2d(u, EPS, scale, wsum, dt, k,
                                                           out=out), 100) for k in (2, 3)}
    sup_plain_ms = {k: cuda_ms(torch, lambda k=k: ck.superstep2d_plain(u, EPS, scale, wsum,
                                                                       dt, k), 3, 1)
                    for k in (2, 3)}
    # bounds: one frame read and one written per launch; K levels of the
    # step's operations for a K-step launch
    carried_bound = bound(2 * frame.numel() * isz, npts * kernel_ops(EPS, 5))
    sup_bound = {k: bound(2 * npts * isz, k * npts * kernel_ops(EPS, 5)) for k in (2, 3)}
    say(f"carried2d {NX}^2 eps={EPS} f32: kernel {carried_ms:.4f} ms/launch (one step), "
        f"plain {carried_plain_ms:.3f} ms, bound {carried_bound[0]:.4f} ms "
        f"({carried_bound[1]})")
    for k in (2, 3):
        say(f"superstep2d {NX}^2 eps={EPS} f32 K={k}: kernel {sup_ms[k]:.4f} ms/launch "
            f"({sup_ms[k] / k:.4f} ms/step), plain {sup_plain_ms[k]:.3f} ms, bound "
            f"{sup_bound[k][0]:.4f} ms ({sup_bound[k][1]})")
    del frame, fout
    ab_big = kernels_ab(torch, ck, cb, u, EPS, scale, wsum, dt, 50, bf16=True)
    say(ab_line(f"{NX}^2", ab_big))
    big = time_variants(torch, op, u, VARIANT_STEPS)
    fits_big = ck.fits_resident(NX, NX, EPS, torch.float32)
    say(f"multi-step candidates {NX}^2 eps={EPS} f32, {VARIANT_STEPS}-step runs (CUDA events), "
        f"ms/step: {json.dumps(big)}; resident2d "
        + ("fits" if fits_big else "does not fit (its two frames exceed the card's L2)"))

    # the small production grid, where the whole run fits the resident kernel
    dh_s = 1.0 / SMALL
    probe_s = NonlocalOp2D(EPS, 1.0, 1.0, dh_s)
    dt_s = 0.8 / (probe_s.c * dh_s * dh_s * probe_s.wsum)
    op_s = NonlocalOp2D(EPS, 1.0, dt_s, dh_s, method="cuda")
    scale_s, npts_s = case_scale(op_s), SMALL * SMALL
    us0 = np.random.default_rng(SEED + 2).standard_normal((SMALL, SMALL))
    us = torch.as_tensor(us0, device="cuda").to(torch.float32)
    if not ck.fits_resident(SMALL, SMALL, EPS, torch.float32):
        fail(f"resident2d does not fit {SMALL}^2 eps={EPS} f32 on this card")
    ref, done = us, 0
    for k in RESIDENT_HOLDS:
        for _ in range(k - done):
            ref = ck.step2d(ref, EPS, scale_s, wsum, dt_s)
        done = k
        got = ck.resident2d(us, EPS, scale_s, wsum, dt_s, k)
        if k == TEST_STEPS:
            hold("resident2d", f"float32 f32 {SMALL}^2 {TEST_STEPS} steps", got,
                 ck.resident2d_plain(us, EPS, scale_s, wsum, dt_s, TEST_STEPS), tol32)
        if not torch.equal(got, ref):
            fail(f"resident2d at {SMALL}^2: not bitwise equal to {k} step2d launches")
    small = time_variants(torch, op_s, us, STEPS)
    res_ms = cuda_ms(torch, lambda: ck.resident2d(us, EPS, scale_s, wsum, dt_s, STEPS), 3, 1)
    res_plain_ms = cuda_ms(torch, lambda: ck.resident2d_plain(us, EPS, scale_s, wsum, dt_s,
                                                              STEPS), 1, 0)
    res_bound = bound(2 * npts_s * isz, STEPS * npts_s * kernel_ops(EPS, 5))
    say(f"resident2d {SMALL}^2 eps={EPS} f32, {STEPS} steps in one launch: kernel "
        f"{res_ms:.4f} ms/launch ({res_ms / STEPS:.5f} ms/step), plain {res_plain_ms:.1f} ms, "
        f"bound {res_bound[0]:.4f} ms ({res_bound[1]}); |kernel-plain| / max|plain| "
        f"{held['resident2d'][0]['rel_err']:.2e}, bitwise equal to step2d launches over "
        f"{RESIDENT_HOLDS} steps")
    say(f"multi-step candidates {SMALL}^2 eps={EPS} f32, {STEPS}-step runs (CUDA events), "
        f"ms/step: {json.dumps(small)}")
    ab_small = kernels_ab(torch, ck, cb, us, EPS, scale_s, wsum, dt_s, 200)
    say(ab_line(f"{SMALL}^2", ab_small))
    small_kernel_ms = {n: sum(v) / len(v) for n, v in ab_small["graph"].items()}
    big_graph_ms = {n: sum(v) / len(v) for n, v in ab_big["graph"].items()}

    multi = make_multi_step_fn(op, STEPS, dtype=torch.float32)
    multi(u, 0)  # the first call tunes the shape and runs the winner
    loop_ms = cuda_ms(torch, lambda: multi(u, 0), 1, 0) / STEPS
    say(f"headline {NX}^2 eps={EPS} f32, {STEPS} steps (make_multi_step_fn, tuned, CUDA "
        f"events): {loop_ms:.4f} ms/step, {npts / (loop_ms * 1e-3):.4e} points*steps/s; "
        f"byte bound {2 * npts * isz / HBM_BYTES_PER_S * 1e3:.4f} ms/step")
    say(f"clocks/power after timing: {nvidia_smi('clocks.sm,power.draw,power.limit')}")

    # the main path, through the solver entry points, counted: a first
    # production call per shape tunes it (every fitting candidate runs its
    # probe program) and then runs the winner
    autotune.reset()
    ck.reset_launch_counts()
    walls, by = {}, {}
    for n, x0, step_dt, step_dh in ((NX, u0, dt, dh), (SMALL, us0, dt_s, dh_s)):
        s = Solver2D(n, n, STEPS, EPS, k=1.0, dt=step_dt, dh=step_dh, method="cuda",
                     dtype=torch.float32, device="cuda")
        s.input_init(x0)
        t0 = time.perf_counter()
        res = launches_of(ck, by, f"{n}^2 production", s.do_work)
        walls[n] = time.perf_counter() - t0
        if res.shape != (n, n) or not np.isfinite(res).all():
            fail(f"production solve {n}^2: result not finite or of the wrong shape")
        if not float(np.abs(res).max()) <= float(np.abs(x0).max()):
            fail(f"production solve {n}^2: the free decay grew (max|u| rose)")
    st = Solver2D(NX, NX, TEST_STEPS, EPS, k=1.0, dt=dt, dh=dh, method="cuda",
                  dtype=torch.float32, device="cuda")
    st.test_init()
    launches_of(ck, by, f"{NX}^2 test form", st.do_work)
    counts = {k: v for k, v in ck.launch_counts().items()
              if k.endswith("2d") and not k.startswith(("batched_", "split_", "fused_"))}
    recs = autotune.records()
    test_err = st.error_l2 / (NX * NX)
    if len(recs) != 2:
        fail(f"the production solves tuned {len(recs)} shapes, not 2: {sorted(recs)}")
    expected = {f"{NX}^2 test form": {"step2d": TEST_STEPS}}
    for n, o in ((NX, op), (SMALL, op_s)):
        expected[f"{n}^2 production"] = record_launches(
            autotune, recs[autotune.tuning_key(o, (n, n), torch.float32, "cuda")], STEPS)
    wrong = {}
    for label, want in expected.items():
        got = {k: v for k, v in by[label].items() if k in counts and k != "nsum2d"}
        if got != {k: v for k, v in want.items() if v}:
            wrong[label] = (got, want)
    if wrong:
        fail(f"main-path launches by part (got, expected from the probes and the winners): "
             f"{wrong}")
    if not all(counts.values()):
        fail(f"a kernel of the main path was not launched: {json.dumps(counts)}")
    if not test_err <= l2_threshold:
        fail(f"test-form headline solve: error_l2/#points {test_err:.3e} > {l2_threshold:g}")
    say(f"tuner records: {json.dumps(recs)}")
    winner = {n: recs[autotune.tuning_key(o, (n, n), torch.float32, "cuda")]["winner"]
              for n, o in ((NX, op), (SMALL, op_s))}
    say(f"main path: Solver2D eps={EPS} f32 method=cuda production solves of {STEPS} steps, "
        f"tuned, at {NX}^2 (winner {winner[NX]}, do_work wall {walls[NX]:.3f} s incl. tuning "
        f"and host<->device copies) and {SMALL}^2 (winner {winner[SMALL]}, "
        f"{walls[SMALL]:.3f} s) + {TEST_STEPS} test-form steps at {NX}^2 (error_l2/#points "
        f"{test_err:.3e}); launches {json.dumps(counts)} = the probes' and the winners'")

    def row(name, source, line, **kw):
        cs = held[name]
        return {"name": name, "route": "cuda",
                "source": f"nonlocalheatequation_torch/csrc/{source}",
                "replaces": f"nonlocalheatequation_tpu/ops/pallas_kernel.py:{line}", **kw,
                "launches": counts[name], "launches_by_shape": by_label(by, name),
                "max_abs_err": max(c["max_abs_err"] for c in cs),
                "verdict": "pass" if all(c["rel_err"] <= c["tol"] for c in cs) else "fail",
                "main_shape_forms": len(cs)}

    no_call = "no one PyTorch call takes Euler steps"
    return [
        {**row("nsum2d", "nsum2d.cu", 468),
         "ms": nsum_ms, "plain_ms": nsum_plain_ms, "bound_ms": nsum_bound[0],
         "bound_by": nsum_bound[1], "library_ms": conv_ms},
        {**row("step2d", "batched_step2d.cu", 515),
         "ms": step_ms, "plain_ms": step_plain_ms, "bound_ms": step_bound[0],
         "bound_by": step_bound[1], "library_ms": None, "library_note": no_call,
         "ms_graph": big_graph_ms["step2d"], "ms_graph_bf16": big_graph_ms["step2d bf16"],
         "ms_512_graph": small_kernel_ms["step2d"]},
        {**row("carried2d", "batched_carried2d.cu", 856),
         "ms": carried_ms, "plain_ms": carried_plain_ms, "bound_ms": carried_bound[0],
         "bound_by": carried_bound[1], "library_ms": None, "library_note": no_call,
         "shape": f"{NX}^2", "ms_graph": big_graph_ms["carried2d"],
         "ms_graph_bf16": big_graph_ms["carried2d bf16"],
         "ms_512_graph": small_kernel_ms["carried2d"]},
        {**row("superstep2d", "superstep2d.cu", 1032),
         "ms": sup_ms[3], "plain_ms": sup_plain_ms[3], "bound_ms": sup_bound[3][0],
         "bound_by": sup_bound[3][1], "library_ms": None, "library_note": no_call,
         "shape": f"{NX}^2", "ksteps": 3, "ms_k2": sup_ms[2], "bound_ms_k2": sup_bound[2][0],
         "ms_graph": big_graph_ms["superstep2d K=3"],
         "ms_graph_k2": big_graph_ms["superstep2d K=2"],
         "ms_512_graph": small_kernel_ms["superstep2d K=3"],
         "ms_512_graph_k2": small_kernel_ms["superstep2d K=2"],
         "step2d_ms_graph": big_graph_ms["step2d"],
         "batched_step2d_b1_ms_graph": big_graph_ms["batched_step2d B=1"]},
        {**row("resident2d", "resident2d.cu", 1292),
         "ms": res_ms, "plain_ms": res_plain_ms, "bound_ms": res_bound[0],
         "bound_by": res_bound[1], "library_ms": None, "library_note": no_call,
         "shape": f"{SMALL}^2", "steps_per_launch": STEPS},
    ]


def op_3d(n: int, eps: int):
    """The 3D operator on an n^3 unit cube (dh = 1/n) at 0.8x the Euler bound."""
    from nonlocalheatequation_torch.ops.nonlocal_op import NonlocalOp3D

    dh = 1.0 / n
    probe = NonlocalOp3D(eps, 1.0, 1.0, dh)
    return NonlocalOp3D(eps, 1.0, 0.8 / (probe.c * dh**3 * probe.wsum), dh, method="cuda")


def phase_headline_3d(torch, np, ck, k3, l2_threshold) -> list:
    """Phase 4, the 3D path: the kernels at 256^3, eps=4 (held to their plain
    versions, timed beside them, their bound and F.conv3d), the tuner's
    candidates at 256^3 and at 128^3, eps=6 (where resident3d fits), then
    the main path through Solver3D, counted."""
    import torch.nn.functional as F

    from nonlocalheatequation_torch.models.solver3d import Solver3D
    from nonlocalheatequation_torch.ops.nonlocal_op import (
        case_scale,
        full_fp32,
        make_multi_step_fn,
        make_multi_step_fn_base,
    )
    from nonlocalheatequation_torch.utils import autotune

    op = op_3d(N3, EPS3)
    scale, wsum, dt = case_scale(op), op.wsum, op.dt
    u0 = np.random.default_rng(SEED + 4).standard_normal((N3,) * 3)
    u = torch.as_tensor(u0, device="cuda").to(torch.float32)
    upad = F.pad(u, (EPS3,) * 6)
    out = torch.empty_like(u)
    g, lg = torch.randn_like(u), torch.randn_like(u)
    isz, npts, tol32 = 4, N3 ** 3, TOL["float32"]
    tp = k3.tile3d(EPS3, torch.float32)
    held = {k: [] for k in ("nsum3d", "step3d", "carried3d", "resident3d")}

    def hold(name, form, got, ref, tol):
        abs_err, rel = rel_err(torch, got, ref)
        held[name].append({"form": form, "max_abs_err": abs_err, "rel_err": rel, "tol": tol})
        if not rel <= tol:
            fail(f"{name} {form}: |kernel-plain| / max|plain| {rel:.3e} > {tol:g}")

    bitwise = {}  # every form BITWISE its plain version (sphere_sum's order)

    def hold_exact(name, form, got, ref, tol):
        hold(name, form, got, ref, tol)
        bitwise[f"{name} {form}"] = torch.equal(got, ref)

    for prec in ("f32", "bf16"):
        hold_exact("nsum3d", f"float32 {prec} {N3}^3", k3.nsum3d(upad, EPS3, prec),
                   k3.nsum3d_plain(upad, EPS3, prec), tol32)
        hold_exact("step3d", f"float32 {prec} production {N3}^3",
                   k3.step3d(u, EPS3, scale, wsum, dt, precision=prec),
                   k3.step3d_plain(u, EPS3, scale, wsum, dt, precision=prec), tol32)
        hold_exact("step3d", f"float32 {prec} test form {N3}^3",
                   k3.step3d(u, EPS3, scale, wsum, dt, g=g, lg=lg, t=3, precision=prec),
                   k3.step3d_plain(u, EPS3, scale, wsum, dt, g=g, lg=lg, t=3, precision=prec),
                   tol32)
    gpad = F.pad(torch.as_tensor(op.spatial_profile(N3, N3, N3), device="cuda"), (EPS3,) * 6)
    hold_exact("nsum3d", f"float64 f32 {N3}^3 (padded G, the test-form source's input)",
               k3.nsum3d(gpad, EPS3), k3.nsum3d_plain(gpad, EPS3), TOL["float64"])
    del gpad
    if not all(bitwise.values()):
        fail(f"3D kernels at {N3}^3 eps={EPS3}: not bitwise equal to their plain versions "
             f"{bitwise}")
    bits = [u]
    for _ in range(3):
        bits.append(k3.step3d(bits[-1], EPS3, scale, wsum, dt))
    frame = F.pad(u, (EPS3,) * 6).contiguous()
    fout = torch.zeros_like(frame)  # carried3d writes the interior: out's halo is zero
    hold_exact("carried3d", f"float32 f32 {N3}^3 one launch",
               k3.carried3d(frame, EPS3, scale, wsum, dt),
               k3.carried3d_plain(frame, EPS3, scale, wsum, dt), tol32)
    if not bitwise[f"carried3d float32 f32 {N3}^3 one launch"]:
        fail(f"carried3d at {N3}^3: not bitwise equal to its plain version")
    if not torch.equal(k3.make_carried_multi_step_fn_3d(op, 3)(u, 0), bits[3]):
        fail(f"carried3d at {N3}^3: 3 launches not bitwise equal to 3 step3d launches")
    del bits
    say(f"3D kernels at the main path's shape {N3}^3 eps={EPS3} (plane tile {tp}; "
        "|kernel-plain| / max|plain|): "
        + "; ".join(f"{n} {c['form']} {c['rel_err']:.2e} <= {c['tol']:g}"
                    for n, cs in held.items() for c in cs)
        + f"; nsum3d, step3d and carried3d bitwise equal to their plain versions "
        f"({len(bitwise)} forms); carried3d 3 launches bitwise equal to 3 step3d launches")

    nsum_ms = cuda_ms(torch, lambda: k3.nsum3d(upad, EPS3), 50)
    nsum_plain_ms = cuda_ms(torch, lambda: k3.nsum3d_plain(upad, EPS3), 3, 1)
    # step3d and carried3d (one register design, on the state and on the
    # frame) in turns; carried3d as its multi-step maker launches it, into a
    # frame whose halo is already zero
    pair = {"step3d": lambda: k3.step3d(u, EPS3, scale, wsum, dt, out=out),
            "carried3d": lambda: k3._carried3d(frame, fout, EPS3, scale, wsum, dt)}
    turns = turns_of(torch, pair, ("step3d", "carried3d", "carried3d", "step3d"), 50)
    step_ms = sum(turns["step3d"]) / 2
    step_plain_ms = cuda_ms(torch, lambda: k3.step3d_plain(u, EPS3, scale, wsum, dt), 3, 1)
    step_test_ms = cuda_ms(torch, lambda: k3.step3d(u, EPS3, scale, wsum, dt, g=g, lg=lg, t=3,
                                                    out=out), 50)
    step_test_plain_ms = cuda_ms(torch, lambda: k3.step3d_plain(u, EPS3, scale, wsum, dt, g=g,
                                                                lg=lg, t=3), 3, 1)
    carried_ms = sum(turns["carried3d"]) / 2
    carried_plain_ms = cuda_ms(torch, lambda: k3.carried3d_plain(frame, EPS3, scale, wsum, dt),
                               3, 1)
    kern = torch.as_tensor(op.weights, dtype=torch.float32, device="cuda")[None, None]
    with full_fp32():
        conv_ms = cuda_ms(torch, lambda: F.conv3d(upad[None, None], kern), 5, 1)
        conv_out = F.conv3d(upad[None, None], kern)[0, 0]
    conv_err = float((conv_out - k3.nsum3d_plain(upad, EPS3)).abs().max())
    del conv_out, kern
    # epilogue: 5 operations for u + dt*(scale*(nsum - wsum*u)), 4 more for the
    # test form's source terms
    nsum_bound = bound((upad.numel() + npts) * isz, npts * kernel_ops_3d(EPS3, tp, 0))
    step_bound = bound(2 * npts * isz, npts * kernel_ops_3d(EPS3, tp, 5))
    step_test_bound = bound(4 * npts * isz, npts * kernel_ops_3d(EPS3, tp, 9))
    # the frame read once, the interior written once
    carried_bound = bound((frame.numel() + npts) * isz, npts * kernel_ops_3d(EPS3, tp, 5))
    say("TF32 disabled for the F.conv3d yardstick (cudnn.allow_tf32=False, "
        "cuda.matmul.allow_tf32=False)")
    say(f"nsum3d {N3}^3 eps={EPS3} f32: kernel {nsum_ms:.4f} ms, plain {nsum_plain_ms:.3f} ms, "
        f"F.conv3d {conv_ms:.4f} ms (max abs diff to plain {conv_err:.2e}), "
        f"bound {nsum_bound[0]:.4f} ms ({nsum_bound[1]})")
    say(f"step3d {N3}^3 eps={EPS3} f32 production: kernel {step_ms:.4f} ms, "
        f"plain {step_plain_ms:.3f} ms, bound {step_bound[0]:.4f} ms ({step_bound[1]})")
    say(f"step3d {N3}^3 eps={EPS3} f32 test form: kernel {step_test_ms:.4f} ms, "
        f"plain {step_test_plain_ms:.3f} ms, bound {step_test_bound[0]:.4f} ms "
        f"({step_test_bound[1]})")
    say(f"carried3d {N3}^3 eps={EPS3} f32: kernel {carried_ms:.4f} ms/launch (one step), "
        f"plain {carried_plain_ms:.3f} ms, bound {carried_bound[0]:.4f} ms "
        f"({carried_bound[1]})")
    say(f"step3d and carried3d {N3}^3 eps={EPS3} f32 in turns (step3d, carried3d, carried3d, "
        f"step3d), ms/launch: {json.dumps(turns)}")
    del frame, fout, upad
    big = time_variants(torch, op, u, STEPS3)
    say(f"3D multi-step candidates {N3}^3 eps={EPS3} f32, {STEPS3}-step runs (CUDA events), "
        f"ms/step: {json.dumps(big)}; resident3d "
        + ("fits" if k3.fits_resident_3d(N3, N3, N3, EPS3, torch.float32)
           else "does not fit (its two frames exceed the card's L2)"))

    # the small 3D grid, where the whole run fits the resident kernel
    op_s = op_3d(N3S, EPS3S)
    scale_s, wsum_s, dt_s, npts_s = case_scale(op_s), op_s.wsum, op_s.dt, N3S ** 3
    tp_s = k3.tile3d(EPS3S, torch.float32)
    us0 = np.random.default_rng(SEED + 5).standard_normal((N3S,) * 3)
    us = torch.as_tensor(us0, device="cuda").to(torch.float32)
    if not k3.fits_resident_3d(N3S, N3S, N3S, EPS3S, torch.float32):
        fail(f"resident3d does not fit {N3S}^3 eps={EPS3S} f32 on this card")
    ref, done = us, 0
    for k in RESIDENT_HOLDS:
        for _ in range(k - done):
            ref = k3.step3d(ref, EPS3S, scale_s, wsum_s, dt_s)
        done = k
        got = k3.resident3d(us, EPS3S, scale_s, wsum_s, dt_s, k)
        if k == TEST_STEPS:
            hold("resident3d", f"float32 f32 {N3S}^3 eps={EPS3S} {TEST_STEPS} steps", got,
                 k3.resident3d_plain(us, EPS3S, scale_s, wsum_s, dt_s, TEST_STEPS), tol32)
        if not torch.equal(got, ref):
            fail(f"resident3d at {N3S}^3: not bitwise equal to {k} step3d launches")
    del got, ref
    small = time_variants(torch, op_s, us, STEPS3)
    # one launch of TEST_STEPS steps, beside the plain version's same steps
    res_ms = cuda_ms(torch, lambda: k3.resident3d(us, EPS3S, scale_s, wsum_s, dt_s, TEST_STEPS),
                     5, 1)
    res_plain_ms = cuda_ms(torch, lambda: k3.resident3d_plain(us, EPS3S, scale_s, wsum_s, dt_s,
                                                              TEST_STEPS), 1, 0)
    res_bound = bound(2 * npts_s * isz, TEST_STEPS * npts_s * kernel_ops_3d(EPS3S, tp_s, 5))
    outs = torch.empty_like(us)
    frame_s = F.pad(us, (EPS3S,) * 6).contiguous()
    fout_s = torch.zeros_like(frame_s)
    # carried3d at the shape where the tuner can pick it: one launch bitwise
    # its plain version and one step3d launch
    form_s = f"float32 f32 {N3S}^3 eps={EPS3S} one launch"
    got = k3.carried3d(frame_s, EPS3S, scale_s, wsum_s, dt_s)
    hold_exact("carried3d", form_s, got,
               k3.carried3d_plain(frame_s, EPS3S, scale_s, wsum_s, dt_s), tol32)
    if not bitwise[f"carried3d {form_s}"]:
        fail(f"carried3d at {N3S}^3 eps={EPS3S}: not bitwise equal to its plain version")
    if not torch.equal(got[EPS3S:-EPS3S, EPS3S:-EPS3S, EPS3S:-EPS3S],
                       k3.step3d(us, EPS3S, scale_s, wsum_s, dt_s)):
        fail(f"carried3d at {N3S}^3 eps={EPS3S}: not bitwise equal to a step3d launch")
    del got
    pair = {"step3d": lambda: k3.step3d(us, EPS3S, scale_s, wsum_s, dt_s, out=outs),
            "carried3d": lambda: k3._carried3d(frame_s, fout_s, EPS3S, scale_s, wsum_s,
                                               dt_s)}
    turns_s = turns_of(torch, pair, ("step3d", "carried3d", "carried3d", "step3d"), 50)
    step_s_ms = sum(turns_s["step3d"]) / 2
    step_s_bound = bound(2 * npts_s * isz, npts_s * kernel_ops_3d(EPS3S, tp_s, 5))
    carried_s_bound = bound((frame_s.numel() + npts_s) * isz,
                            npts_s * kernel_ops_3d(EPS3S, tp_s, 5))
    del frame_s, fout_s
    say(f"resident3d {N3S}^3 eps={EPS3S} f32 (plane tile {tp_s}), {TEST_STEPS} steps in one "
        f"launch: kernel {res_ms:.4f} ms/launch ({res_ms / TEST_STEPS:.5f} ms/step), plain "
        f"{res_plain_ms:.1f} "
        f"ms, bound {res_bound[0]:.4f} ms ({res_bound[1]}); "
        f"step3d there {step_s_ms:.4f} ms/launch, bound {step_s_bound[0]:.4f} ms "
        f"({step_s_bound[1]}); resident3d bitwise equal to step3d launches over "
        f"{RESIDENT_HOLDS} steps")
    say(f"step3d and carried3d {N3S}^3 eps={EPS3S} f32 in turns, ms/launch: "
        f"{json.dumps(turns_s)}")
    say(f"3D multi-step candidates {N3S}^3 eps={EPS3S} f32, {STEPS3}-step runs (CUDA events), "
        f"ms/step: {json.dumps(small)}")
    say(f"clocks/power after the 3D timing: {nvidia_smi('clocks.sm,power.draw,power.limit')}")

    # the 3D main path, through the solver entry points, counted: a first
    # production call per shape tunes it and then runs the winner
    autotune.reset()
    ck.reset_launch_counts()
    walls, by = {}, {}
    for n, x0, o in ((N3, u0, op), (N3S, us0, op_s)):
        s = Solver3D(n, n, n, STEPS3, o.eps, k=1.0, dt=o.dt, dh=o.dh, method="cuda",
                     dtype=torch.float32, device="cuda")
        s.input_init(x0)
        t0 = time.perf_counter()
        res = launches_of(ck, by, f"{n}^3 eps={o.eps} production", s.do_work)
        walls[n] = time.perf_counter() - t0
        if res.shape != (n, n, n) or not np.isfinite(res).all():
            fail(f"3D production solve {n}^3: result not finite or of the wrong shape")
        if not float(np.abs(res).max()) <= float(np.abs(x0).max()):
            fail(f"3D production solve {n}^3: the free decay grew (max|u| rose)")
    st = Solver3D(N3, N3, N3, TEST_STEPS, EPS3, k=1.0, dt=dt, dh=op.dh, method="cuda",
                  dtype=torch.float32, device="cuda")
    st.test_init()
    launches_of(ck, by, f"{N3}^3 eps={EPS3} test form", st.do_work)
    counts = {k: v for k, v in ck.launch_counts().items()
              if k.endswith("3d") and not k.startswith(("split_", "fused_"))}
    recs = autotune.records()
    test_err = st.error_l2 / npts
    if len(recs) != 2:
        fail(f"the 3D production solves tuned {len(recs)} shapes, not 2: {sorted(recs)}")
    # the test form: L(G) once, then the steps
    expected = {f"{N3}^3 eps={EPS3} test form": {"step3d": TEST_STEPS, "nsum3d": 1}}
    for n, o in ((N3, op), (N3S, op_s)):
        expected[f"{n}^3 eps={o.eps} production"] = record_launches(
            autotune, recs[autotune.tuning_key(o, (n, n, n), torch.float32, "cuda")], STEPS3, 3)
    got = {label: {k: v for k, v in by[label].items() if k in counts} for label in expected}
    if got != {label: {k: v for k, v in want.items() if v} for label, want in expected.items()}:
        fail(f"3D main-path launches by part {got} != {expected} (the probes', the winners' "
             "and the test form's)")
    if not all(counts.values()):
        fail(f"a kernel of the 3D main path was not launched: {json.dumps(counts)}")
    if not test_err <= l2_threshold:
        fail(f"3D test-form solve: error_l2/#points {test_err:.3e} > {l2_threshold:g}")
    say(f"3D tuner records: {json.dumps(recs)}")
    winner = {n: recs[autotune.tuning_key(o, (n, n, n), torch.float32, "cuda")]["winner"]
              for n, o in ((N3, op), (N3S, op_s))}
    say(f"3D main path: Solver3D f32 method=cuda production solves of {STEPS3} steps, tuned, "
        f"at {N3}^3 eps={EPS3} (winner {winner[N3]}, do_work wall {walls[N3]:.3f} s incl. "
        f"tuning and host<->device copies) and {N3S}^3 eps={EPS3S} (winner {winner[N3S]}, "
        f"{walls[N3S]:.3f} s) + {TEST_STEPS} test-form steps at {N3}^3 (error_l2/#points "
        f"{test_err:.3e}); launches {json.dumps(counts)} = the probes', the winners' and the "
        "test form's")
    # each shape's tuned program (the winner above, from the records in
    # memory) beside the per-step program: bitwise the same run, then in
    # turns per-step, tuned, tuned, per-step; after the count, so not in it
    programs_ms = {}
    for n, x, o in ((N3, u, op), (N3S, us, op_s)):
        progs = {"per-step": make_multi_step_fn_base(o, STEPS3, dtype=torch.float32),
                 "tuned": make_multi_step_fn(o, STEPS3, dtype=torch.float32)}
        if not torch.equal(progs["tuned"](x, 0), progs["per-step"](x, 0)):
            fail(f"3D tuned program at {n}^3 ({winner[n]}): not bitwise equal to the per-step "
                 f"program over {STEPS3} steps")
        t = turns_of(torch, {k: (lambda f=f, x=x: f(x, 0)) for k, f in progs.items()},
                     ("per-step", "tuned", "tuned", "per-step"), 2, 1)
        programs_ms[f"{n}^3"] = {"winner": winner[n], "per-step": sum(t["per-step"]) / 2,
                                 "tuned": sum(t["tuned"]) / 2, "turns": t}
    say(f"3D programs on the card, {STEPS3} steps, ms (the per-step program against the tuned "
        f"winner's, bitwise the same run, in turns): {json.dumps(programs_ms)}")
    # the tuner's pick, made anew REPICKS times a shape: each pass forgets
    # this process's records (the file cache is off) and probes again, so a
    # pick that follows the probes' noise shows as a change of winner
    repicks = {}
    for _ in range(REPICKS):
        for n, o in ((N3, op), (N3S, op_s)):
            autotune.reset()
            name = autotune.pick_multi_step_fn(o, STEPS3, (n, n, n), torch.float32, "cuda")[1]
            rec = autotune.records()[autotune.tuning_key(o, (n, n, n), torch.float32, "cuda")]
            repicks.setdefault(f"{n}^3", []).append(
                {"winner": name, "ms_per_step": rec["ms_per_step"]})
    say(f"3D tuner picks made anew, {REPICKS} a shape (winner, each probe's ms/step): "
        f"{json.dumps(repicks)}")

    def row(name, source, line, **kw):
        cs = held[name]
        return {"name": name, "route": "cuda",
                "source": f"nonlocalheatequation_torch/csrc/{source}",
                "replaces": f"nonlocalheatequation_tpu/ops/pallas_kernel.py:{line}", **kw,
                "launches": counts[name], "launches_by_shape": by_label(by, name),
                "max_abs_err": max(c["max_abs_err"] for c in cs),
                "verdict": "pass" if all(c["rel_err"] <= c["tol"] for c in cs) else "fail",
                "main_shape_forms": len(cs)}

    no_call = "no one PyTorch call takes Euler steps"
    return [
        {**row("nsum3d", "nsum3d.cu", 793),
         "ms": nsum_ms, "plain_ms": nsum_plain_ms, "bound_ms": nsum_bound[0],
         "bound_by": nsum_bound[1], "library_ms": conv_ms, "shape": f"{N3}^3"},
        {**row("step3d", "nsum3d.cu", 793),
         "ms": step_ms, "plain_ms": step_plain_ms, "bound_ms": step_bound[0],
         "bound_by": step_bound[1], "library_ms": None, "library_note": no_call,
         "shape": f"{N3}^3", "ms_test_form": step_test_ms,
         "plain_ms_test_form": step_test_plain_ms, "bound_ms_test_form": step_test_bound[0],
         f"ms_{N3S}": step_s_ms, f"bound_ms_{N3S}": step_s_bound[0],
         f"carried3d_ms_{N3S}": sum(turns_s["carried3d"]) / 2, "programs_ms": programs_ms},
        {**row("carried3d", "carried3d.cu", 1507),
         "ms": carried_ms, "plain_ms": carried_plain_ms, "bound_ms": carried_bound[0],
         "bound_by": carried_bound[1], "library_ms": None, "library_note": no_call,
         "shape": f"{N3}^3", f"ms_{N3S}": sum(turns_s["carried3d"]) / 2,
         f"bound_ms_{N3S}": carried_s_bound[0], "turns_with_step3d": turns,
         f"turns_with_step3d_{N3S}": turns_s, "tuner_repicks": repicks},
        {**row("resident3d", "resident3d.cu", 1419),
         "ms": res_ms, "plain_ms": res_plain_ms, "bound_ms": res_bound[0],
         "bound_by": res_bound[1], "library_ms": None, "library_note": no_call,
         "shape": f"{N3S}^3 eps={EPS3S}", "steps_per_launch": TEST_STEPS},
    ]


def phase_batched_checks(torch, ck, cb, np) -> dict:
    """Phase 2, the batched kernels: batched_step2d (production and test
    form), batched_carried2d and batched_superstep2d (K = 1-4) in float64,
    float32 and the bf16 operand tier, uniform and mixed physics, B in
    {1, 2, 3, 8}, eps 1-8 over ragged grids (1x1, smaller than one tile, non
    tile multiples) plus eps 0, 9, 16, 17 and 40: each against its plain
    version (all three BITWISE: their register designs, at eps <= 16 and
    eps <= 8, and the shared tile body above sum in the plain versions'
    disc_sum order) and each lane BITWISE against one solo launch of the
    same kernel (step2d, carried2d, superstep2d) on that case;
    batched_carried2d's lanes also BITWISE batched_step2d's, each into a
    NaN-filled ``out``; in the bf16 tier, where the plain version carries
    (master, shadow) pairs and the kernels the masters alone, each next
    shadow of the plain version must be the rounding of its next master.
    In float32 the lattices of fewer tiles than the card has SMs run the
    tile body and 300 x 1000 at B >= 2 the register walk.  In the bf16 tier
    the K-step
    tolerance grows by one bfloat16 rounding flip per step after the first
    (see phase_multistep_checks)."""
    import torch.nn.functional as F

    rng = np.random.default_rng(SEED + 6)
    shapes = [(1, 1), (13, 45), (37, 50), (70, 90)]
    # in float32 a lattice of fewer tiles than the card has SMs takes the tile
    # body at every eps (reg_tiles_too_few); 300 x 1000 (96 tiles a case, not
    # tile multiples) holds the register walk at B >= 2 in float32 too
    plan = ([(e, s) for e in (1, 2, 3, 5, 8) for s in shapes]
            + [(0, (13, 45)), (0, (70, 90)), (9, (37, 50)), (9, (70, 90)), (16, (20, 90)),
               (16, (150, 45)), (17, (20, 90)), (17, (150, 45)), (40, (50, 45)),
               (3, (300, 1000)), (8, (300, 1000)), (16, (300, 1000))])
    bitwise_plain = ("batched_step2d", "batched_superstep2d", "batched_carried2d")
    worst, n = {}, dict.fromkeys(("batched_step2d", "batched_carried2d",
                                  "batched_superstep2d"), 0)

    def hold(name, form, got, plain, tol, solo):
        _abs, err = rel_err(torch, got, plain)
        if not all(torch.equal(got[b], s) for b, s in enumerate(solo)):
            fail(f"{name} {form}: a lane is not bitwise equal to its solo launch")
        if name in bitwise_plain and not torch.equal(got, plain):
            fail(f"{name} {form}: not bitwise equal to its plain version (largest "
                 f"|kernel-plain| / max|plain| {err:.3e})")
        if not err <= tol:
            fail(f"{name} {form}: |kernel-plain| / max|plain| {err:.3e} > {tol:.3e}")
        key = f"{name}/{form.split()[0]}/{form.split()[1]}"
        worst[key] = max(worst.get(key, 0.0), err)
        n[name] += 1

    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[1]
        tol = TOL[dname]
        for prec in ("f32", "bf16"):
            for e, (nx, ny) in plan:
                wsum = float(sum(2 * h + 1 for h in ck.column_half_heights(e)))
                for batch, mixed in ((1, False), (2, True), (3, False), (3, True), (8, True)):
                    scales = [2.0 + e + (b if mixed else 0) for b in range(batch)]
                    dts = [0.8 / (sc * wsum) * (1 + (0.1 * b if mixed else 0))
                           for b, sc in enumerate(scales)]
                    flip = max(dt * sc * wsum for sc, dt in zip(scales, dts, strict=True)) \
                        * 2.0 ** -8 if prec == "bf16" else 0.0
                    params = cb.case_params(scales, dts, dtype, "cuda")
                    U = torch.tensor(rng.standard_normal((batch, nx, ny)), dtype=dtype,
                                     device="cuda")
                    G, LG = torch.randn_like(U), torch.randn_like(U)
                    coefs = cb.source_coef_table([7], dts, dtype, "cuda")[0]
                    lanes = [U[b].contiguous() for b in range(batch)]
                    form = (f"{dname} {prec} eps={e} {batch}x{nx}x{ny} "
                            + ("mixed" if mixed else "uniform"))
                    step = cb.batched_step2d(U, e, params, wsum, precision=prec)
                    hold("batched_step2d", form, step,
                         cb.batched_step2d_plain(U, e, params, wsum, precision=prec), tol,
                         [ck.step2d(u, e, scales[b], wsum, dts[b], precision=prec)
                          for b, u in enumerate(lanes)])
                    hold("batched_step2d", form + " test form",
                         cb.batched_step2d(U, e, params, wsum, G=G, LG=LG, coefs=coefs,
                                           precision=prec),
                         cb.batched_step2d_plain(U, e, params, wsum, G=G, LG=LG, coefs=coefs,
                                                 precision=prec), tol,
                         [ck.step2d(u, e, scales[b], wsum, dts[b], g=G[b].contiguous(),
                                    lg=LG[b].contiguous(), t=7, precision=prec)
                          for b, u in enumerate(lanes)])
                    frames = F.pad(U, (e,) * 4).contiguous()
                    shadow = ck.shadow_of(frames) if prec == "bf16" else None
                    # out NaN-filled: the wrapper zeroes its halos
                    got = cb.batched_carried2d(frames, e, params, wsum, precision=prec,
                                               out=torch.full_like(frames, float("nan")))
                    plain = cb.batched_carried2d_plain(frames, e, params, wsum, shadow)
                    solo = [ck.carried2d(frames[b].contiguous(), e, scales[b], wsum, dts[b],
                                         precision=prec) for b in range(batch)]
                    if prec == "bf16":
                        # the plain version carries (master, shadow) pairs; the
                        # kernels keep the masters and round them as they stage
                        # them, the same only if each next shadow is the
                        # rounding of its next master
                        if not torch.equal(plain[1], ck.shadow_of(plain[0])):
                            fail(f"batched_carried2d {form}: a next shadow of the plain "
                                 "version is not the rounding of its next master")
                        plain = plain[0]
                    hold("batched_carried2d", form, got, plain, tol, solo)
                    if not torch.equal(got[:, e:e + nx, e:e + ny], step):
                        fail(f"batched_carried2d {form}: a lane is not bitwise equal to "
                             "batched_step2d's")
                    for k in (1, 2, 3, 4):
                        if cb.fits_batched_superstep(e, k, dtype, prec):
                            hold("batched_superstep2d", f"{form} K={k}",
                                 cb.batched_superstep2d(U, e, params, wsum, k, prec),
                                 cb.batched_superstep2d_plain(U, e, params, wsum, k, prec),
                                 tol + (k - 1) * flip,
                                 [ck.superstep2d(u, e, scales[b], wsum, dts[b], k, prec)
                                  for b, u in enumerate(lanes)])
    try:  # a CUDA tensor the kernel cannot take raises; it never falls back
        z = torch.zeros(2, 200, 200, device="cuda", dtype=torch.float64)
        cb.batched_step2d(z, 70, cb.case_params([1.0] * 2, [1e-3] * 2, z.dtype, "cuda"), 1.0)
        fail("batched_step2d accepted eps=70 (beyond its shared-memory tile) on the card")
    except ValueError:
        pass
    say("batched kernel checks (max |kernel-plain| / max|plain|; every lane bitwise equal to "
        "its solo launch): " + ", ".join(f"{k} {v:.2e}" for k, v in sorted(worst.items()))
        + "; cases " + ", ".join(f"{k} {v}" for k, v in n.items()) + ": pass")
    return n


def ensemble_cases(np, n: int, physics, seed: int, nt: int) -> list:
    """``len(physics)`` production cases of n^2, eps=EPS, one per (k, dt, dh),
    each from its own seeded random state."""
    from nonlocalheatequation_torch.serve.ensemble import EnsembleCase

    rng = np.random.default_rng(seed)
    return [EnsembleCase(shape=(n, n), nt=nt, eps=EPS, k=k, dt=dt, dh=dh, test=False,
                         u0=rng.standard_normal((n, n))) for k, dt, dh in physics]


def euler_dt(dh: float, k: float = 1.0, frac: float = 0.8) -> float:
    """dt at which dt*c*dh^2*wsum = frac (at most 1: each step is then a
    convex combination of zero-extended values, so max|u| cannot grow)."""
    from nonlocalheatequation_torch.ops.nonlocal_op import NonlocalOp2D

    probe = NonlocalOp2D(EPS, k, 1.0, dh)
    return frac / (probe.c * dh * dh * probe.wsum)


def phase_ensemble(torch, np, ck, cb, cases_2d) -> list:
    """Phase 6, the ensemble engine at the JAX package's own ensemble size
    (ensemble8x1024: 8 production cases of 1024^2, eps=8, f32, 500 steps)
    and a mixed-physics 8 x 512^2 bucket.  First, outside the count: each
    batched kernel at 8 x 1024^2 held to its plain version and each lane
    bitwise to the solo kernel, the kernels timed beside their plain
    versions and bounds, the engine's run timed (device and wall) beside
    the same 8 cases as 8 sequential tuned Solver2D solves, and each
    bucket's lanes held bitwise to the solo per-step loop; step2d alone is
    timed on the first case's plane.  Then the counted
    main path: CASES_2D through the 2D CLI with --ensemble (float64), both
    buckets through EnsembleEngine(method="cuda"), and both again under
    NLHEAT_TUNE_BATCH=1 (the batched tuner's probes and winner); after the
    count, each bucket's tuned program timed beside its untuned one."""
    import contextlib
    import io

    import torch.nn.functional as F

    from nonlocalheatequation_torch.cli import solve2d
    from nonlocalheatequation_torch.models.solver2d import Solver2D
    from nonlocalheatequation_torch.ops.nonlocal_op import (
        NonlocalOp2D,
        case_scale,
        make_multi_step_fn,
        make_multi_step_fn_base,
    )
    from nonlocalheatequation_torch.serve.ensemble import EnsembleEngine
    from nonlocalheatequation_torch.utils import autotune

    B, N, steps = ENS_B, ENS_N, STEPS
    dh = 1.0 / N
    dt = euler_dt(dh)
    big = ensemble_cases(np, N, [(1.0, dt, dh)] * B, SEED + 7, steps)
    # eight physics: conductivities, spacings and fractions of each one's bound
    mixed = ensemble_cases(
        np, ENS_MIXED_N,
        [(k, euler_dt(h, k, f), h) for k, f, h in (
            (1.0, 0.8, 1 / 512), (0.5, 0.6, 1 / 512), (2.0, 0.7, 1 / 512), (1.0, 0.4, 1 / 640),
            (0.2, 0.8, 1 / 512), (1.0, 0.8, 1 / 400), (0.7, 0.5, 1 / 512), (1.5, 0.3, 1 / 560))],
        SEED + 8, steps)
    op = NonlocalOp2D(EPS, 1.0, dt, dh, method="cuda")
    scale, wsum = case_scale(op), op.wsum
    U = torch.as_tensor(np.stack([c.u0 for c in big]), device="cuda").to(torch.float32)
    params = cb.case_params([scale] * B, [dt] * B, torch.float32, "cuda")
    isz, npts, tol32 = 4, B * N * N, TOL["float32"]
    held = {k: [] for k in ("batched_step2d", "batched_carried2d", "batched_superstep2d")}

    def hold(name, form, got, ref, solo):
        abs_err, rel = rel_err(torch, got, ref)
        held[name].append({"form": form, "max_abs_err": abs_err, "rel_err": rel, "tol": tol32})
        if not rel <= tol32:
            fail(f"{name} {form}: |kernel-plain| / max|plain| {rel:.3e} > {tol32:g}")
        if not torch.equal(got, ref):
            fail(f"{name} {form}: not bitwise equal to its plain version")
        if not all(torch.equal(got[b], s) for b, s in enumerate(solo)):
            fail(f"{name} {form}: a lane is not bitwise equal to its solo launch")

    # every batched kernel at the main path's shape: plain and, per lane, solo
    lanes = [U[b].contiguous() for b in range(B)]
    G, LG = torch.randn_like(U), torch.randn_like(U)
    coefs = cb.source_coef_table([3], [dt] * B, torch.float32, "cuda")[0]
    form = f"float32 f32 {B}x{N}^2 eps={EPS}"
    hold("batched_step2d", form + " production", cb.batched_step2d(U, EPS, params, wsum),
         cb.batched_step2d_plain(U, EPS, params, wsum),
         [ck.step2d(u, EPS, scale, wsum, dt) for u in lanes])
    hold("batched_step2d", form + " test form",
         cb.batched_step2d(U, EPS, params, wsum, G=G, LG=LG, coefs=coefs),
         cb.batched_step2d_plain(U, EPS, params, wsum, G=G, LG=LG, coefs=coefs),
         [ck.step2d(u, EPS, scale, wsum, dt, g=G[b].contiguous(), lg=LG[b].contiguous(), t=3)
          for b, u in enumerate(lanes)])
    frames = F.pad(U, (EPS,) * 4).contiguous()
    carried = cb.batched_carried2d(frames, EPS, params, wsum)
    hold("batched_carried2d", form, carried, cb.batched_carried2d_plain(frames, EPS, params, wsum),
         [ck.carried2d(frames[b].contiguous(), EPS, scale, wsum, dt) for b in range(B)])
    if not torch.equal(carried[:, EPS:EPS + N, EPS:EPS + N], cb.batched_step2d(U, EPS, params,
                                                                                wsum)):
        fail(f"batched_carried2d {form}: a lane is not bitwise equal to batched_step2d's")
    del carried
    for k in (2, 3):
        hold("batched_superstep2d", f"{form} K={k}",
             cb.batched_superstep2d(U, EPS, params, wsum, k),
             cb.batched_superstep2d_plain(U, EPS, params, wsum, k),
             [ck.superstep2d(u, EPS, scale, wsum, dt, k) for u in lanes])
    del lanes
    say(f"batched kernels at the main path's shape {B}x{N}^2 eps={EPS} (|kernel-plain| / "
        "max|plain|; every lane bitwise equal to its solo launch): "
        + "; ".join(f"{n} {c['form']} {c['rel_err']:.2e}" for n, cs in held.items() for c in cs))

    out = torch.empty_like(U)
    step_ms = cuda_ms(torch, lambda: cb.batched_step2d(U, EPS, params, wsum, out=out), 200)
    step_graph_ms = graph_ms(torch, lambda: cb.batched_step2d(U, EPS, params, wsum, out=out))
    step_test_ms = cuda_ms(torch, lambda: cb.batched_step2d(U, EPS, params, wsum, G=G, LG=LG,
                                                            coefs=coefs, out=out), 200)
    step_plain_ms = cuda_ms(torch, lambda: cb.batched_step2d_plain(U, EPS, params, wsum), 5, 1)
    carried_plain_ms = cuda_ms(torch, lambda: cb.batched_carried2d_plain(frames, EPS, params,
                                                                         wsum), 5, 1)
    b7_ab = batched_carried_ab(torch, np, cb, {f"{B}x{N}^2": big,
                                               f"{B}x{ENS_MIXED_N}^2 mixed": mixed})
    carried_ms = b7_ab[f"{B}x{N}^2"]["ms"]
    sup_ms = {k: cuda_ms(torch, lambda k=k: cb.batched_superstep2d(U, EPS, params, wsum, k,
                                                                    out=out), 100)
              for k in (2, 3)}
    sup_plain_ms = cuda_ms(torch, lambda: cb.batched_superstep2d_plain(U, EPS, params, wsum, 3),
                           3, 1)
    # step2d alone on the first case's plane: one batched_step2d launch at B=1
    plane, o1 = U[0].contiguous(), torch.empty_like(U[0])
    if not torch.equal(cb.batched_step2d(U[:1].contiguous(), EPS, params[:1].contiguous(),
                                         wsum)[0], ck.step2d(plane, EPS, scale, wsum, dt)):
        fail(f"batched_step2d 1x{N}^2: not bitwise equal to step2d")
    solo_step_ms = cuda_ms(torch, lambda: ck.step2d(plane, EPS, scale, wsum, dt, out=o1), 200)
    del plane, o1
    step_bound = bound(2 * npts * isz, npts * kernel_ops(EPS, 5))
    step_test_bound = bound(4 * npts * isz, npts * kernel_ops(EPS, 9))
    # the frames read once, the interiors written once
    carried_bound = bound((frames.numel() + npts) * isz, npts * kernel_ops(EPS, 5))
    sup_bound = {k: bound(2 * npts * isz, k * npts * kernel_ops(EPS, 5)) for k in (2, 3)}
    del G, LG, frames
    say(f"batched_step2d {B}x{N}^2 eps={EPS} f32: kernel {step_ms:.4f} ms/launch (in a CUDA "
        f"graph {step_graph_ms:.4f}) "
        f"({step_ms / B:.5f} ms per case-step; step2d alone at {N}^2 {solo_step_ms:.5f} ms), "
        f"plain {step_plain_ms:.3f} ms, bound {step_bound[0]:.4f} ms ({step_bound[1]}); "
        f"test form {step_test_ms:.4f} ms, bound {step_test_bound[0]:.4f} ms "
        f"({step_test_bound[1]})")
    say(f"batched_carried2d {B}x{N}^2 eps={EPS} f32: kernel {carried_ms:.4f} ms/launch, plain "
        f"{carried_plain_ms:.3f} ms, bound {carried_bound[0]:.4f} ms ({carried_bound[1]})")
    say("batched_carried2d in turns with batched_step2d (B6, B7, B7, B6), eps=8, ms per "
        "launch in a loop and in a CUDA graph, each bitwise B6 and its plain version: "
        + "; ".join(
            f"{k} {p}: batched_carried2d {v['ms']:.5f} (graph {v['ms_graph']:.5f}), "
            f"batched_step2d {v['batched_step2d_ms']:.5f} (graph "
            f"{v['batched_step2d_ms_graph']:.5f}), bound {v['bound_ms']:.5f}; turns "
            f"{json.dumps(v['turns'])}, graph {json.dumps(v['turns_graph'])}"
            for k, w in b7_ab.items() for p, v in (("f32", w), ("bf16", w["bf16"]))))
    for k in (2, 3):
        say(f"batched_superstep2d {B}x{N}^2 eps={EPS} f32 K={k}: kernel {sup_ms[k]:.4f} "
            f"ms/launch ({sup_ms[k] / k:.4f} ms/step), bound "
            f"{sup_bound[k][0]:.4f} ms ({sup_bound[k][1]})"
            + (f", plain {sup_plain_ms:.3f} ms" if k == 3 else ""))

    # the engine's run and the same 8 cases as 8 sequential tuned solves
    engine = EnsembleEngine(method="cuda", device="cuda", dtype=torch.float32)
    t0 = time.perf_counter()
    res = engine.run(big)
    first_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.run(big)
    eng_wall = time.perf_counter() - t0
    multi = engine.build_program(big[0].bucket_key(), big)
    eng_ms = cuda_ms(torch, lambda: multi(U, 0), 2, 1)
    for b, case in enumerate(big):
        ref = make_multi_step_fn_base(op, steps)(U[b], 0)
        if not np.array_equal(res[b], ref.cpu().numpy()):
            fail(f"ensemble {B}x{N}^2: lane {b} is not bitwise equal to its solo per-step loop")
    autotune.pick_multi_step_fn(op, steps, (N, N), torch.float32, "cuda")  # tune the shape once
    solo = make_multi_step_fn(op, steps, dtype=torch.float32)
    seq_ms = cuda_ms(torch, lambda: [solo(U[b], 0) for b in range(B)], 2, 1)
    t0 = time.perf_counter()
    for case in big:
        s = Solver2D(N, N, steps, EPS, k=case.k, dt=case.dt, dh=case.dh, method="cuda",
                     dtype=torch.float32, device="cuda")
        s.input_init(case.u0)
        s.do_work()
    seq_wall = time.perf_counter() - t0
    solo_winner = autotune.records()[autotune.tuning_key(op, (N, N), torch.float32, "cuda")][
        "winner"]
    work = B * N * N * steps
    say(f"ensemble {B}x{N}^2 eps={EPS} f32, {steps} steps: EnsembleEngine(method='cuda') "
        f"{eng_ms:.3f} ms on the card ({work / (eng_ms * 1e-3):.4e} cases*points*steps/s), "
        f"run() wall {eng_wall:.3f} s (first run, building the program, {first_wall:.3f} s); "
        f"8 sequential tuned solves (winner {solo_winner}) {seq_ms:.3f} ms on the card "
        f"({work / (seq_ms * 1e-3):.4e} cases*points*steps/s), Solver2D.do_work wall "
        f"{seq_wall:.3f} s; ratio sequential/ensemble on the card {seq_ms / eng_ms:.3f}")
    # the lanes held bitwise here are what the counted runs below must return
    held_res = {"8x1024": res}
    res = held_res["8x512 mixed"] = EnsembleEngine(method="cuda", device="cuda",
                                                   dtype=torch.float32).run(mixed)
    for case, got in zip(mixed, res, strict=True):
        o = NonlocalOp2D(case.eps, case.k, case.dt, case.dh, method="cuda")
        ref = make_multi_step_fn_base(o, case.nt)(
            torch.as_tensor(case.u0, device="cuda").float(), 0)
        if not np.array_equal(got, ref.cpu().numpy()):
            fail(f"mixed ensemble 8x{ENS_MIXED_N}^2: a lane is not bitwise equal to its solo "
                 "per-step loop")
    del U, out
    say(f"mixed-physics ensemble 8x{ENS_MIXED_N}^2 eps={EPS} f32, {steps} steps: every lane "
        "bitwise equal to its solo per-step loop")

    # the counted main path
    autotune.reset()
    ck.reset_launch_counts()
    runs = {}

    def counted(name, fn):
        before = ck.launch_counts()
        t0 = time.perf_counter()
        out = fn()
        runs[name] = {"wall_s": round(time.perf_counter() - t0, 3),
                      "launches": {k: v - before[k] for k, v in ck.launch_counts().items()
                                   if v != before[k]}}
        return out

    def cli_2d():
        stdout, stderr = io.StringIO(), io.StringIO()
        stdin, sys.stdin = sys.stdin, io.StringIO(batch_text(cases_2d))
        try:
            with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(stderr):
                rc = solve2d.main([*CLI_ARGS, "--ensemble"])
        finally:
            sys.stdin = stdin
        if rc != 0 or stdout.getvalue().splitlines()[-1] != "Tests Passed":
            fail(f"solve2d --ensemble: rc {rc}\n{stdout.getvalue()}\n{stderr.getvalue()}")
        return stderr.getvalue().strip().splitlines()[-1]

    cli_summary = counted("cli solve2d --ensemble", cli_2d)
    ran = runs["cli solve2d --ensemble"]["launches"]
    if ran.get("step2d", 0) or not ran.get("batched_step2d", 0):
        fail(f"solve2d --ensemble: launches {ran}; the rows must run batched_step2d, not step2d")
    reports = {}
    for name, cases in (("8x1024", big), ("8x512 mixed", mixed)):
        eng = EnsembleEngine(method="cuda", device="cuda", dtype=torch.float32)
        res = counted(name, lambda eng=eng, cases=cases: eng.run(cases))
        r = eng.report
        reports[name] = r.summary()
        if (r.buckets, r.programs_built, r.dispatches) != (1, 1, 1) \
                or runs[name]["launches"] != {"batched_step2d": steps}:
            fail(f"ensemble {name}: {r.summary()}, launches {runs[name]['launches']}; expected "
                 f"1 bucket, 1 program, 1 dispatch and {steps} batched_step2d launches")
        for case, got in zip(cases, res, strict=True):
            if got.shape != case.shape or not np.isfinite(got).all() \
                    or not float(np.abs(got).max()) <= float(np.abs(case.u0).max()):
                fail(f"ensemble {name}: a result is not finite, of the wrong shape, or grew")
        if not all(np.array_equal(g, h) for g, h in zip(res, held_res[name], strict=True)):
            fail(f"ensemble {name}: a lane of the counted run is not bitwise equal to the "
                 "same lane held against its solo per-step loop above")
    os.environ["NLHEAT_TUNE_BATCH"] = "1"
    try:
        for name, cases in (("tuned 8x1024", big), ("tuned 8x512 mixed", mixed)):
            eng = EnsembleEngine(method="cuda", device="cuda", dtype=torch.float32)
            res = counted(name, lambda eng=eng, cases=cases: eng.run(cases))
            reports[name] = f"{eng.report.summary()}; {list(eng.report.strategies.values())}"
            # every batched winner is bitwise the per-step loop; vmap (an nsum
            # per case, then the update in PyTorch) is held to the tolerance
            exact = "tuned:vmap" not in eng.report.strategies.values()
            for got, want in zip(res, held_res[name[len("tuned "):]], strict=True):
                ok = (np.array_equal(got, want) if exact else
                      float(np.abs(got - want).max()) <= tol32 * float(np.abs(want).max()))
                if not ok:
                    fail(f"ensemble {name}: a lane differs from the lane held against its "
                         f"solo per-step loop ({eng.report.strategies})")
    finally:
        del os.environ["NLHEAT_TUNE_BATCH"]
    recs = autotune.records()
    counts = ck.launch_counts()
    if len(recs) != 2:
        fail(f"ensemble main path: {len(recs)} tuning records, not 2: {sorted(recs)}")
    # each tuned run: its bucket's probes (every round) and its winner's run
    for name, n in (("tuned 8x1024", N), ("tuned 8x512 mixed", ENS_MIXED_N)):
        entry = [e for key, e in recs.items() if f"/{n}x{n}/" in key]
        want = {k: v for k, v in record_launches(autotune, entry[0], steps,
                                                 rounds=autotune.BATCH_PROBE_ROUNDS).items()
                if k in held and v} if len(entry) == 1 else None
        got = {k: v for k, v in runs[name]["launches"].items() if k in held}
        if got != want:
            fail(f"ensemble {name}: batched launches {got} != {want} (the probes' and the "
                 "winner's)")
    got = {k: counts[k] for k in held}
    if got != {k: sum(r["launches"].get(k, 0) for r in runs.values()) for k in held}:
        fail(f"ensemble main path: batched launches {got} outside the counted runs {runs}")
    if not all(got.values()):
        fail(f"a batched kernel of the ensemble path was not launched: {got}")
    say(f"batch tuner records: {json.dumps(recs)}")
    # each bucket's tuned program (the winner above, from the records in
    # memory) beside its untuned per-step program on the card, in turns
    # untuned, tuned, tuned, untuned; after the count, so not in it
    programs_ms = {}
    for name, cases in (("8x1024", big), ("8x512 mixed", mixed)):
        Ub = torch.as_tensor(np.stack([c.u0 for c in cases]), device="cuda").to(torch.float32)
        progs = []
        for tune in ("", "1"):
            os.environ["NLHEAT_TUNE_BATCH"] = tune
            eng = EnsembleEngine(method="cuda", device="cuda", dtype=torch.float32)
            progs.append(eng.build_program(cases[0].bucket_key(), cases))
        del os.environ["NLHEAT_TUNE_BATCH"]
        turns = [cuda_ms(torch, lambda f=f: f(Ub, 0), 2, 1)
                 for f in (progs[0], progs[1], progs[1], progs[0])]
        programs_ms[name] = {"per-step": (turns[0] + turns[3]) / 2,
                             "tuned": (turns[1] + turns[2]) / 2, "turns": turns}
        del Ub
    say(f"ensemble programs on the card, {steps} steps, ms (untuned per-step program against "
        f"the tuned winner's, in turns): {json.dumps(programs_ms)}")
    say(f"ensemble main path (counted): CASES_2D through solve2d --ensemble ({cli_summary}); "
        + "; ".join(f"{k}: {v}" for k, v in reports.items())
        + f"; runs {json.dumps(runs)}; batched launches {json.dumps(got)} = the rows', the "
        "buckets', the probes' and the winners'")

    def row(name, line, source, **kw):
        cs = held[name]
        return {"name": name, "route": "cuda",
                "source": f"nonlocalheatequation_torch/csrc/{source}",
                "replaces": f"nonlocalheatequation_tpu/ops/pallas_kernel.py:{line}", **kw,
                "launches": counts[name],
                "launches_by_shape": by_label({k: r["launches"] for k, r in runs.items()}, name),
                "max_abs_err": max(c["max_abs_err"] for c in cs),
                "verdict": "pass" if all(c["rel_err"] <= c["tol"] for c in cs) else "fail",
                "main_shape_forms": len(cs), "library_ms": None,
                "library_note": "no one PyTorch call takes a batched Euler step",
                "shape": f"{B}x{N}^2"}

    return [
        row("batched_step2d", 1694, "batched_step2d.cu", ms=step_ms, plain_ms=step_plain_ms,
            bound_ms=step_bound[0], bound_by=step_bound[1], ms_test_form=step_test_ms,
            bound_ms_test_form=step_test_bound[0], ms_step2d_one_case=solo_step_ms,
            ms_graph=step_graph_ms, ensemble_ms=eng_ms,
            sequential_ms=seq_ms, programs_ms=programs_ms),
        row("batched_carried2d", 1839, "batched_carried2d.cu", ms=carried_ms,
            plain_ms=carried_plain_ms, bound_ms=carried_bound[0], bound_by=carried_bound[1],
            ab_with_batched_step2d=b7_ab),
        row("batched_superstep2d", 1963, "batched_superstep2d.cu", ms=sup_ms[3],
            plain_ms=sup_plain_ms, bound_ms=sup_bound[3][0], bound_by=sup_bound[3][1],
            ksteps=3, ms_k2=sup_ms[2], bound_ms_k2=sup_bound[2][0]),
    ]


# -- phase 7: the unstructured path ------------------------------------------------

UN_M = 512           # the shuffled jittered 512^2 cloud, eps = 3h: 262,144 nodes
UN_STEPS = 20        # steps of the CLI run on it (B13 launches exactly this many)
MESH_NM = 256        # bench.py's graded cloud at grid 512 (nm = grid // 2): 65,536 nodes
MESH_STEPS = 100     # steps of each 8-case mesh bucket
MESHES = ("10x10", "50x50", "100x100", "200x200")


def jittered_cloud(np, m: int, d: int, seed: int, shuffle: bool = False):
    """An m^d lattice on [0, 1)^d jittered by +/-0.2 spacings, optionally
    shuffled; (points, spacing)."""
    rng = np.random.default_rng(seed)
    h = 1.0 / m
    grids = np.meshgrid(*([np.arange(m) * h] * d), indexing="ij")
    pts = np.stack([g.ravel() for g in grids], axis=1)
    pts += rng.uniform(-0.2 * h, 0.2 * h, pts.shape)
    return (pts[rng.permutation(len(pts))] if shuffle else pts), h


def graded_cloud(np, nm: int, eps_factor: float = EPS, a: float = 0.6):
    """bench.py's BENCH_MESH cloud (bench.py:1236-1248), copied: the
    tensor-product map g(xi) = xi + a*sin(2*pi*xi)/(2*pi) on [0,1]^2, spacing
    (1-a)/nm at the centre and (1+a)/nm at the edge, eps = eps_factor x the
    local spacing, vol = the local cell volume; (points, eps, vol)."""
    xi = (np.arange(nm) + 0.5) / nm
    gmap = xi + a * np.sin(2 * np.pi * xi) / (2 * np.pi)
    gp = 1 + a * np.cos(2 * np.pi * xi)
    X, Y = np.meshgrid(gmap, gmap, indexing="ij")
    HX, HY = np.meshgrid(gp / nm, gp / nm, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel()], axis=1)
    return pts, float(eps_factor) * (0.5 * (HX + HY)).ravel(), (HX * HY).ravel()


def small_clouds(np):
    """Phase 7a's clouds: (name, points, eps, vol, windowed-plan kwargs)."""
    out = []
    pts, h = jittered_cloud(np, 40, 2, SEED)
    out.append(("2D jittered", pts, 3 * h * (1 + 0.2 * np.sin(7 * pts[:, 0])), h * h, {}))
    pts, h = jittered_cloud(np, 40, 2, SEED + 1, shuffle=True)
    out.append(("2D shuffled", pts, 3 * h, h * h, {}))
    pts, h = jittered_cloud(np, 12, 3, SEED + 2)
    out.append(("3D", pts, 2.5 * h, h ** 3, {}))
    pts, h = jittered_cloud(np, 700, 1, SEED + 3)
    out.append(("1D", pts, 4 * h, h, {}))
    rng = np.random.default_rng(SEED + 4)
    out.append(("n=1000 (not a multiple of 128)", rng.uniform(size=(1000, 2)), 0.08, 1e-3, {}))
    pts, h = jittered_cloud(np, 40, 2, SEED + 5)
    out.append(("forced residual (wmax=128)", pts, 3 * h, h * h, {"wmax": 128}))
    out.append(("self-only horizon", np.stack([np.linspace(0, 1, 300), np.zeros(300)], 1),
                1e-6, 1.0, {}))
    pts = rng.uniform(size=(600, 2))
    eps = 0.06 * (1 + 0.5 * rng.uniform(size=600))
    eps[0] = 2.0  # a hub sees every node
    out.append(("variable horizon with a hub", pts, eps, 1.0 / 600, {}))
    return out


def phase_unstructured_checks(torch, np) -> dict:
    """Phase 7a: windowed_matvec (f64, f32) and gather_L (f64, f32, bf16
    operand) against their plain versions on small clouds, the windowed
    operator (residual included) against the NumPy oracle, and each lane of
    a stacked gather chunk bitwise equal to its solo run."""
    from nonlocalheatequation_torch.ops import cuda_unstructured as cu
    from nonlocalheatequation_torch.ops.gather import (
        GatherTable,
        make_batched_gather_multi_step_fn,
        make_gather_multi_step_fn,
    )
    from nonlocalheatequation_torch.ops.unstructured import UnstructuredNonlocalOp

    rng = np.random.default_rng(SEED + 6)
    worst, n = {}, {"windowed_matvec": 0, "gather_L": 0}

    def held(key, got, ref, tol):
        err = rel_err(torch, got, ref)[1]
        if not err <= tol:
            fail(f"{key}: |kernel-plain| / max|plain| {err:.3e} > {tol:g}")
        worst[key] = max(worst.get(key, 0.0), err)

    for name, pts, eps, vol, kw in small_clouds(np):
        op = UnstructuredNonlocalOp(pts, eps, k=1.0, dt=1e-6, vol=vol, device="cuda")
        plan = op.windowed_plan(**kw)
        for dtype in (torch.float64, torch.float32):
            tname = str(dtype).split(".")[1]
            tol = TOL[tname]
            u = torch.tensor(rng.standard_normal(op.n), device="cuda", dtype=dtype)
            ex = plan.for_dtype(dtype, "cuda")
            packed = (ex.rowptr, ex.cols, ex.vals, ex.s128)
            held(f"windowed_matvec/{tname}", cu.windowed_matvec(*packed, u, ex.we),
                 cu.windowed_matvec_plain(*packed, u, ex.we), tol)
            held(f"windowed L vs oracle/{tname}", ex.L(u),
                 torch.as_tensor(op.apply_np(u.double().cpu().numpy()), device="cuda"), tol)
            n["windowed_matvec"] += 1
            table = GatherTable(op, dtype, "cuda")
            for prec in ("f32", "bf16"):
                got = cu.gather_L(table.rowptr, table.col, table.w, u, prec)
                held(f"gather_L/{tname}/{prec}", got,
                     cu.gather_L_plain(table.rowptr, table.col, table.w, u, prec), tol)
                if not torch.equal(got, cu.gather_L(table.rowptr, table.col, table.w, u, prec)):
                    fail(f"gather_L {name} {tname} {prec}: two launches differ")
                n["gather_L"] += 1
        say(f"  {name}: {op.n} nodes, {len(op.tgt)} edges, kmax {op.kmax}, windows "
            f"{plan.R} x {plan.we}, coverage {plan.coverage:.4f}")
    # a stacked chunk of three physics: every lane bitwise its solo run
    pts, h = jittered_cloud(np, 30, 2, SEED + 7)
    ops = [UnstructuredNonlocalOp(pts, 3 * h, k=k, dt=dt, vol=h * h, device="cuda")
           for k, dt in ((1.0, 1e-5), (0.5, 2e-5), (2.0, 5e-6))]
    U0 = torch.tensor(rng.standard_normal((3, ops[0].n)), device="cuda")
    for dtype in (torch.float64, torch.float32):
        for test in (False, True):
            out = make_batched_gather_multi_step_fn(ops, 5, dtype=dtype, test=test)(U0, 0)
            for b, op in enumerate(ops):
                solo = make_gather_multi_step_fn(op, 5, dtype=dtype, test=test)(U0[b], 0)
                if not torch.equal(out[b], solo):
                    fail(f"stacked gather lane {b} ({dtype}, test={test}) is not bitwise its "
                         "solo run")
    say("unstructured kernel checks (max |kernel-plain| / max|plain|): "
        + ", ".join(f"{k} {v:.2e}" for k, v in sorted(worst.items()))
        + f"; cases windowed_matvec {n['windowed_matvec']}, gather_L {n['gather_L']}; "
        "stacked gather lanes bitwise solo: pass")
    return n


def csr_library(torch, rowptr, col, w, n: int):
    """``x -> torch.sparse.mm(A, x)`` for the CSR matrix (rowptr, col, w):
    the library yardstick (the port never calls it)."""
    A = torch.sparse_csr_tensor(rowptr, col.long(), w, size=(n, n))
    return lambda x: torch.sparse.mm(A, x.unsqueeze(1)).squeeze(1)


def start_unstructured_clis() -> tuple:
    """solve_unstructured --test on each data/*.msh on the card in float64,
    --layout auto then windowed, one process per mesh running the two in
    turn, started right after the build so that they run beside phase 2;
    (jobs, start time)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    jobs = {}
    for name in MESHES:
        runs = " && ".join(
            f"{sys.executable} -m nonlocalheatequation_torch.cli.solve_unstructured --mesh "
            f"data/{name}.msh --test --platform gpu --x64 1 --layout {lay}"
            for lay in ("auto", "windowed"))
        proc = subprocess.Popen(["bash", "-c", runs], cwd=ROOT, env=env, stdin=subprocess.DEVNULL,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        CHILDREN.append(proc)
        jobs[name] = proc
    return jobs, time.perf_counter()


def phase_unstructured_cli(clis, l2_threshold):
    """Phase 3b: each data/*.msh solve (f64, auto and windowed) must print
    error_l2/N <= 1e-6."""
    jobs, t0 = clis
    errs = {}
    for name, proc in jobs.items():
        out, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            fail(f"solve_unstructured on data/{name}.msh: rc {proc.returncode}\n{out}\n"
                 f"{err[-4000:]}")
        lines = [x for x in out.splitlines() if x.startswith("error_l2/N ")]
        if len(lines) != 2:
            fail(f"solve_unstructured on data/{name}.msh: {len(lines)} error lines\n{out}")
        for lay, line in zip(("auto", "windowed"), lines, strict=True):
            errs[f"{name} {lay}"] = cli_error(line, f"solve_unstructured {name} --layout {lay}",
                                              l2_threshold)
    say("solve_unstructured --test --platform gpu --x64 1 on data/*.msh (error_l2/N, --layout "
        "auto and windowed): " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f"; wall (beside phase 2) {time.perf_counter() - t0:.1f} s")


def run_cli_unstructured(argv) -> str:
    """solve_unstructured in-process on the card; its stdout (fails on rc != 0)."""
    import contextlib
    import io

    from nonlocalheatequation_torch.cli import solve_unstructured

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = solve_unstructured.main(argv)
    if rc != 0:
        fail(f"solve_unstructured {' '.join(argv)}: rc {rc}\n{out.getvalue()}\n"
             f"{err.getvalue()}")
    return out.getvalue()


def cli_error(text: str, what: str, l2_threshold: float) -> float:
    line = next((x for x in text.splitlines() if x.startswith("error_l2/N ")), None)
    if line is None:
        fail(f"{what}: no error_l2/N line\n{text}")
    err = float(line.split()[1])
    if not err <= l2_threshold:
        fail(f"{what}: error_l2/N {err:.3e} > {l2_threshold:g}")
    return err


def phase_unstructured(torch, np, ck, l2_threshold) -> list:
    """Phase 7, the unstructured path: (b) the shuffled jittered 512^2 cloud
    (eps = 3h, f32): host walls of the edge and plan builds, the card memory
    of building the windowed exec (the packed in-window entries; the dense
    strips are never allocated), windowed_matvec and gather_L held to their
    plain versions and timed beside them, their bounds and torch.sparse.mm,
    one step of each layout and one auto-picked step (counted); (c) counted, the
    CLI on the 512^2 cloud from a 2.2 .msh with --layout auto (windowed,
    UN_STEPS launches; data/*.msh ran beside phase 2, phase_unstructured_cli);
    (d) bench.py's graded cloud at nm=256 in a throwaway mesh
    registry: gather_L held and timed at its shape, then, counted, an 8-case
    bucket and a mixed-physics 8-case bucket through EnsembleEngine (lanes x
    MESH_STEPS launches each), every lane bitwise its solo gather loop."""
    from nonlocalheatequation_torch.ops import cuda_unstructured as cu
    from nonlocalheatequation_torch.ops.gather import GatherTable, make_gather_multi_step_fn
    from nonlocalheatequation_torch.ops.unstructured import UnstructuredNonlocalOp
    from nonlocalheatequation_torch.serve.ensemble import EnsembleCase, EnsembleEngine
    from nonlocalheatequation_torch.serve.meshes import MeshStore, get_mesh_op
    from nonlocalheatequation_torch.utils.gmsh import write_point_cloud_msh

    f32, tol32, isz = torch.float32, TOL["float32"], 4
    rng = np.random.default_rng(SEED + 8)
    t_phase = time.perf_counter()
    held = {"windowed_matvec": [], "gather_L": []}

    def hold(name, form, got, ref, tol):
        abs_err, rel = rel_err(torch, got, ref)
        held[name].append({"form": form, "max_abs_err": abs_err, "rel_err": rel, "tol": tol})
        if not rel <= tol:
            fail(f"{name} {form}: |kernel-plain| / max|plain| {rel:.3e} > {tol:g}")

    # (b) the realistic cloud
    pts, h = jittered_cloud(np, UN_M, 2, SEED + 9, shuffle=True)
    t0 = time.perf_counter()
    op = UnstructuredNonlocalOp(pts, 3 * h, k=1.0, dt=1.0, vol=h * h, device="cuda")
    edge_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    layout = op.choose_layout()
    gate_wall = time.perf_counter() - t0
    if layout != "windowed":
        fail(f"the shuffled {UN_M}^2 cloud: auto chose {layout!r} on the card, not windowed")
    t0 = time.perf_counter()
    plan = op.windowed_plan()
    plan_wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    ex = plan.for_dtype(f32, "cuda")
    torch.cuda.synchronize()
    fill_wall = time.perf_counter() - t0
    exec_peak = torch.cuda.max_memory_allocated() - mem0
    n, nnz_w = op.n, len(plan.p_vals)
    packed = (ex.rowptr, ex.cols, ex.vals, ex.s128)
    packed_bytes = sum(t.numel() * t.element_size() for t in packed)
    if hasattr(ex, "P") or exec_peak >= plan.p_bytes_f32:
        fail(f"the windowed exec allocated {exec_peak} B on the card: the dense strips "
             f"({plan.p_bytes_f32} B) must never be allocated")
    shape13 = f"{n} nodes, R={plan.R} windows of we={plan.we}, {nnz_w} packed entries"
    say(f"shuffled {UN_M}^2 cloud, eps=3h: {n} nodes, {len(op.tgt)} edges, kmax {op.kmax}; "
        f"host walls: build_edges {edge_wall:.2f} s, auto gate (offset stats + window search) "
        f"{gate_wall:.2f} s, plan {plan_wall:.2f} s, exec built (packed on the host, copied) "
        f"{fill_wall:.2f} s; windows {plan.R} x {plan.we}, coverage {plan.coverage:.4f}, "
        f"{nnz_w} in-window entries ({nnz_w / (plan.n_pad * plan.W):.4f} of the dense "
        f"strips' {plan.p_bytes_f32} B), packed rowptr+cols+vals+s128 {packed_bytes} B; "
        f"torch.cuda.max_memory_allocated while building the f32 windowed exec: {exec_peak} B "
        f"above the {mem0} B before it; residual {plan.ov_tgt.size} edges")
    u = torch.tensor(rng.standard_normal(n), device="cuda", dtype=f32)
    mv = cu.windowed_matvec(*packed, u, ex.we)
    hold("windowed_matvec", f"float32 shuffled {UN_M}^2", mv,
         cu.windowed_matvec_plain(*packed, u, ex.we), tol32)
    if not torch.equal(mv, cu.windowed_matvec(*packed, u, ex.we)):
        fail("windowed_matvec: two launches on the same input differ")
    u64 = u.double()
    ex64 = plan.for_dtype(torch.float64, "cuda")
    packed64 = (ex64.rowptr, ex64.cols, ex64.vals, ex64.s128)
    hold("windowed_matvec", f"float64 shuffled {UN_M}^2",
         cu.windowed_matvec(*packed64, u64, ex64.we),
         cu.windowed_matvec_plain(*packed64, u64, ex64.we), TOL["float64"])
    del ex64, packed64
    torch.cuda.empty_cache()
    # the library yardstick for B13: the in-window entries as one CSR matrix
    s128 = plan.s128.astype(np.int64)
    gcol = s128[plan.p_rows // 128, plan.p_cols // plan.we] * 128 + plan.p_cols % plan.we
    by = np.lexsort((gcol, plan.p_rows))
    rowptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(plan.p_rows, minlength=plan.n_pad)[:n], out=rowptr[1:])
    lib13 = csr_library(torch, torch.as_tensor(rowptr, device="cuda"),
                        torch.as_tensor(gcol[by], device="cuda"),
                        torch.as_tensor(plan.p_vals[by], device="cuda", dtype=f32), n)
    lib_err = rel_err(torch, lib13(u), mv)[1]
    if not lib_err <= tol32:
        fail(f"torch.sparse.mm of the in-window entries differs from windowed_matvec: "
             f"{lib_err:.3e}")
    # in turns: library, kernel, kernel, library; each as a replayed CUDA
    # graph of launches (the wrapper's host cost per call is of the order of
    # the kernel's time here) and as a loop of launches from Python
    k13 = lambda: cu.windowed_matvec(*packed, u, ex.we)  # noqa: E731
    l13 = lambda: lib13(u)  # noqa: E731
    t13 = [graph_ms(torch, f) for f in (l13, k13, k13, l13)]
    t13_loop = [cuda_ms(torch, f, 100) for f in (l13, k13, k13, l13)]
    out13 = {"ms": (t13[1] + t13[2]) / 2, "library_ms": (t13[0] + t13[3]) / 2, "turns": t13,
             "ms_loop": (t13_loop[1] + t13_loop[2]) / 2,
             "library_ms_loop": (t13_loop[0] + t13_loop[3]) / 2, "turns_loop": t13_loop,
             "plain_ms": cuda_ms(torch, lambda: cu.windowed_matvec_plain(*packed, u, ex.we),
                                 10, 2)}
    # the same work done the least way: each packed entry (value, uint16
    # column), the row pointer and the window starts read once, u read once,
    # out written once; a multiply-add an entry
    b13_bytes = nnz_w * (isz + 2) + packed[0].numel() * 4 + packed[3].numel() * 4 + 2 * n * isz
    b13 = bound(b13_bytes, 2 * nnz_w)
    del lib13
    # B12 at the same cloud (original order)
    table = GatherTable(op, f32, "cuda")
    g = cu.gather_L(table.rowptr, table.col, table.w, u)
    hold("gather_L", f"float32 shuffled {UN_M}^2", g,
         cu.gather_L_plain(table.rowptr, table.col, table.w, u), tol32)
    lib12 = csr_library(torch, table.rowptr, table.col, table.w, n)
    out12s = {"ms": cuda_ms(torch, lambda: cu.gather_L(table.rowptr, table.col, table.w, u),
                            50),
              "plain_ms": cuda_ms(torch, lambda: cu.gather_L_plain(table.rowptr, table.col,
                                                                   table.w, u), 5, 1),
              "library_ms": cuda_ms(torch, lambda: lib12(u), 20)}
    b12s = bound(table.nnz * (isz + 4) + (n + 1) * 8 + 2 * n * isz, 2 * table.nnz)
    del lib12, table
    say(f"B13 windowed_matvec {UN_M}^2 f32: kernel {out13['ms']:.4f} ms in a CUDA graph "
        f"({out13['ms_loop']:.4f} in a loop of launches), plain (gather from the windows, row "
        f"segment sum) {out13['plain_ms']:.3f} ms, torch.sparse.mm CSR of the {nnz_w} "
        f"in-window entries {out13['library_ms']:.4f} ms in a graph "
        f"({out13['library_ms_loop']:.4f} in a loop; turns library, kernel, kernel, library: "
        f"graph {json.dumps([round(t, 5) for t in t13])}, loop "
        f"{json.dumps([round(t, 5) for t in t13_loop])}), bound {b13[0]:.4f} ms ({b13[1]}: "
        f"{b13_bytes} B = the packed entries at {isz + 2} B, rowptr, s128, u, out)")
    say(f"B12 gather_L {UN_M}^2 f32 (CSR, {len(op.tgt) + n} entries with the centres): kernel "
        f"{out12s['ms']:.4f} ms, plain {out12s['plain_ms']:.3f} ms, torch.sparse.mm "
        f"{out12s['library_ms']:.4f} ms, bound {b12s[0]:.4f} ms ({b12s[1]})")
    # one L(u) per layout, each held to the float64 NumPy oracle (a random
    # state: a smooth one cancels in L and leaves float32 noise in its place)
    steps = {}
    uo_np = rng.standard_normal(n)
    uo = torch.tensor(uo_np, device="cuda", dtype=f32)
    oracle = torch.as_tensor(op.apply_np(uo_np), device="cuda")
    for lay in ("windowed", "offsets", "ell", "edges"):
        lay_err = rel_err(torch, op.apply(uo, layout=lay), oracle)[1]
        if not lay_err <= tol32:
            fail(f"layout {lay} on the shuffled cloud: |L - oracle| / max|oracle| "
                 f"{lay_err:.3e} > {tol32:g}")
        steps[lay] = cuda_ms(torch, lambda lay=lay: op.apply(uo, layout=lay), 5, 1)
    # one auto-picked L(u), counted: the layout the card's policy takes
    ck.reset_launch_counts()
    auto_err = rel_err(torch, op.apply(uo), oracle)[1]
    auto_launches = {k: v for k, v in ck.launch_counts().items() if v}
    if not auto_err <= tol32 or auto_launches != {"windowed_matvec": 1}:
        fail(f"auto L(u) on the shuffled cloud: error {auto_err:.3e}, launches {auto_launches}"
             " (the policy picks windowed on the card)")
    steps["auto"] = cuda_ms(torch, lambda: op.apply(uo), 5, 1)
    off = op.offset_plan()
    say(f"one L(u) per layout at {UN_M}^2 f32, ms: {json.dumps(steps)} (auto picks "
        f"{op.choose_layout()!r}, launches {json.dumps(auto_launches)}, |L - oracle| / "
        f"max|oracle| {auto_err:.3e}; offsets keeps {len(off.offs)} diagonals, coverage "
        f"{off.coverage:.4f})")
    plan_strip_bytes = plan.p_bytes_f32
    del ex, op, off, uo, oracle, u, mv, g, packed
    plan = None
    torch.cuda.empty_cache()

    walls = {"b": time.perf_counter() - t_phase}

    # (c) the CLI on the card, counted (data/*.msh ran beside phase 2)
    counted = {}
    with tempfile.TemporaryDirectory() as tmp:
        msh = os.path.join(tmp, f"shuffled{UN_M}.msh")
        write_point_cloud_msh(msh, pts)
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        text = run_cli_unstructured(["--mesh", msh, "--test", "--platform", "gpu", "--layout",
                                     "auto", "--eps", repr(3 * h), "--nt", str(UN_STEPS)])
        cli_wall = time.perf_counter() - t0
        counted["cli"] = {k: v for k, v in ck.launch_counts().items() if v}
    err = cli_error(text, f"solve_unstructured shuffled {UN_M}^2", l2_threshold)
    if counted["cli"] != {"windowed_matvec": UN_STEPS}:
        fail(f"solve_unstructured --layout auto on the shuffled {UN_M}^2 cloud: launches "
             f"{counted['cli']}, expected windowed_matvec x {UN_STEPS} (auto must choose "
             "windowed on the card)")
    say(f"main path (counted): solve_unstructured --layout auto on the shuffled {UN_M}^2 cloud "
        f"(a 2.2 .msh, f32, {UN_STEPS} steps): launches {json.dumps(counted['cli'])}, "
        f"error_l2/N {err:.3e}, wall {cli_wall:.2f} s; "
        + " | ".join(x for x in text.splitlines()[1:2]))

    walls["c"] = time.perf_counter() - t_phase - walls["b"]

    # (d) the mesh buckets on bench.py's graded cloud
    mpts, meps, mvol = graded_cloud(np, MESH_NM)
    with tempfile.TemporaryDirectory() as mdir:
        os.environ["NLHEAT_MESH_DIR"] = mdir
        try:
            t0 = time.perf_counter()
            mhash = MeshStore(mdir).put(mpts, meps, mvol)
            put_wall = time.perf_counter() - t0
            t0 = time.perf_counter()
            mop = get_mesh_op(mhash, 1.0, 1.0, device="cuda")
            op_wall = time.perf_counter() - t0
            bound1 = float(np.max(mop.c * mop.wsum))
            dt1 = 0.8 / bound1
            nm = mop.n
            # B12 at the bucket's shape, every tier against its plain version, on a
            # random state as in the other checks (on the smooth profile G, L(G) is a
            # small difference of large sums, and two float32 orders of the same
            # sum differ by more than 1e-5 of its largest value: printed below)
            u = torch.tensor(rng.standard_normal(mop.n), device="cuda", dtype=f32)
            for dtype, tname in ((torch.float64, "float64"), (f32, "float32")):
                table = GatherTable(mop, dtype, "cuda")
                ud = u.to(dtype)
                for prec in ("f32", "bf16"):
                    hold("gather_L", f"{tname} {prec} graded nm={MESH_NM}",
                         cu.gather_L(table.rowptr, table.col, table.w, ud, prec),
                         cu.gather_L_plain(table.rowptr, table.col, table.w, ud, prec),
                         TOL[tname])
            gp = torch.tensor(mop.spatial_profile(), device="cuda", dtype=f32)
            smooth = rel_err(torch, cu.gather_L(table.rowptr, table.col, table.w, gp),
                             cu.gather_L_plain(table.rowptr, table.col, table.w, gp))[1]
            lib12 = csr_library(torch, table.rowptr, table.col, table.w, nm)
            lib_err = rel_err(torch, lib12(u), cu.gather_L(table.rowptr, table.col, table.w,
                                                           u))[1]
            if not lib_err <= tol32:
                fail(f"torch.sparse.mm of the baked table differs from gather_L: {lib_err:.3e}")
            out12 = {"ms": cuda_ms(torch, lambda: cu.gather_L(table.rowptr, table.col,
                                                              table.w, u), 100),
                     "plain_ms": cuda_ms(torch, lambda: cu.gather_L_plain(
                         table.rowptr, table.col, table.w, u), 5, 1),
                     "library_ms": cuda_ms(torch, lambda: lib12(u), 50)}
            b12 = bound(table.nnz * (isz + 4) + (nm + 1) * 8 + 2 * nm * isz, 2 * table.nnz)
            kpad = -(-(mop.kmax + 1) // 128) * 128
            say(f"graded cloud nm={MESH_NM}: {nm} nodes, {len(mop.tgt)} edges, kmax "
                f"{mop.kmax} (strips kpad {kpad}; CSR {table.nnz} entries with the centres); "
                f"host walls: MeshStore.put {put_wall:.2f} s, get_mesh_op {op_wall:.2f} s; "
                f"B12 gather_L f32: kernel {out12['ms']:.4f} ms, plain {out12['plain_ms']:.3f} "
                f"ms, torch.sparse.mm {out12['library_ms']:.4f} ms, bound {b12[0]:.4f} ms "
                f"({b12[1]}); on the smooth profile G (not held: cancellation) the float32 "
                f"|kernel-plain| / max|plain| is {smooth:.3e}")
            del lib12, table
            mixed_phys = [(1.0, 0.8), (0.5, 0.6), (2.0, 0.7), (1.0, 0.4), (0.2, 0.8),
                          (1.5, 0.5), (0.7, 0.5), (3.0, 0.3)]
            buckets = {
                "uniform": [EnsembleCase(shape=(nm,), nt=MESH_STEPS, eps=0, k=1.0, dt=dt1,
                                         dh=0.0, test=True, mesh=mhash)] * 8,
                "mixed": [EnsembleCase(shape=(nm,), nt=MESH_STEPS, eps=0, k=k,
                                       dt=f * 0.8 / (k * bound1), dh=0.0, test=True,
                                       mesh=mhash) for k, f in mixed_phys],
            }
            run_wall, dev_ms = {}, {}
            for name, cases in buckets.items():
                eng = EnsembleEngine(device="cuda", dtype=f32)
                ck.reset_launch_counts()
                t0 = time.perf_counter()
                res = eng.run(cases)
                run_wall[name] = time.perf_counter() - t0
                counted[name] = {k: v for k, v in ck.launch_counts().items() if v}
                r = eng.report
                if (r.buckets, r.programs_built, r.dispatches) != (1, 1, 1) \
                        or counted[name] != {"gather_L": 8 * MESH_STEPS}:
                    fail(f"mesh bucket {name}: {r.summary()}, launches {counted[name]}; "
                         f"expected 1 bucket, 1 program, 1 dispatch, gather_L x "
                         f"{8 * MESH_STEPS}")
                worst = 0.0
                for case, got in zip(cases, res, strict=True):
                    cop = eng._make_op(case)
                    solo = make_gather_multi_step_fn(cop, MESH_STEPS, dtype=f32, test=True)(
                        torch.as_tensor(cop.spatial_profile(), device="cuda"), 0)
                    if got.shape != (nm,) or not np.array_equal(got, solo.cpu().numpy()):
                        fail(f"mesh bucket {name}: a lane is not bitwise its solo gather loop")
                    d = got.astype(np.float64) - cop.manufactured_solution(MESH_STEPS)
                    worst = max(worst, float(np.sum(d * d)) / nm)
                if not worst <= l2_threshold:
                    fail(f"mesh bucket {name}: error_l2/#points {worst:.3e} > {l2_threshold:g}")
                key = cases[0].bucket_key()
                multi = eng.build_program(key, cases)
                U0 = eng.stage_inputs(cases)
                dev_ms[name] = cuda_ms(torch, lambda multi=multi, U0=U0: multi(U0, 0), 1, 1)
                say(f"mesh bucket {name} (8 x {nm} nodes, f32, {MESH_STEPS} steps; "
                    f"{r.strategies[key]}): run() wall {run_wall[name]:.3f} s (first run, "
                    f"building the tables), {dev_ms[name]:.3f} ms on the card per run "
                    f"({dev_ms[name] / (8 * MESH_STEPS):.4f} ms per case-step); launches "
                    f"{json.dumps(counted[name])}; every lane bitwise its solo loop; largest "
                    f"error_l2/#points {worst:.3e}")
        finally:
            del os.environ["NLHEAT_MESH_DIR"]
    walls["d"] = time.perf_counter() - t_phase - walls["b"] - walls["c"]
    say(f"phase 7 part walls, s: (b) the 512^2 cloud {walls['b']:.1f}, (c) the counted CLI "
        f"{walls['c']:.1f}, (d) the mesh buckets {walls['d']:.1f}")

    launches = {"windowed_matvec": counted["cli"].get("windowed_matvec", 0),
                "gather_L": counted["uniform"].get("gather_L", 0)
                + counted["mixed"].get("gather_L", 0)}

    def row(name, source, replaces, **kw):
        cs = held[name]
        return {"name": name, "route": "cuda",
                "source": f"nonlocalheatequation_torch/csrc/{source}",
                "replaces": replaces, **kw, "launches": launches[name],
                "max_abs_err": max(c["max_abs_err"] for c in cs),
                "verdict": "pass" if all(c["rel_err"] <= c["tol"] for c in cs) else "fail",
                "main_shape_forms": len(cs)}

    return [
        row("windowed_matvec", "windowed_matvec.cu",
            "nonlocalheatequation_tpu/ops/windowed.py:151", ms=out13["ms"],
            plain_ms=out13["plain_ms"], bound_ms=b13[0], bound_by=b13[1],
            library_ms=out13["library_ms"],
            library_note="torch.sparse.mm of the in-window entries as one CSR matrix; ms "
                         "and library_ms in a replayed CUDA graph, *_loop in a loop of launches",
            ms_loop=out13["ms_loop"], library_ms_loop=out13["library_ms_loop"],
            shape=f"shuffled {UN_M}^2, eps=3h, {shape13}",
            layout_step_ms=steps, exec_peak_bytes=exec_peak, packed_bytes=packed_bytes,
            dense_strip_bytes_f32=plan_strip_bytes),
        row("gather_L", "gather_L.cu", "nonlocalheatequation_tpu/ops/pallas_gather.py:144",
            ms=out12["ms"], plain_ms=out12["plain_ms"], bound_ms=b12[0], bound_by=b12[1],
            library_ms=out12["library_ms"],
            library_note="torch.sparse.mm of the baked table as one CSR matrix",
            shape=f"graded nm={MESH_NM} ({nm} nodes, kpad {kpad})",
            ms_shuffled=out12s["ms"], plain_ms_shuffled=out12s["plain_ms"],
            bound_ms_shuffled=b12s[0], library_ms_shuffled=out12s["library_ms"],
            bucket_ms=dev_ms, bucket_wall_s=run_wall),
    ]


# -- phase 8: the distributed grid solves ----------------------------------------------

DN, DEPS = 4096, 8       # the 2D distributed solve: 4096^2, eps=8, 2x2 mesh (2048^2 blocks)
D3N, D3EPS = 256, 4      # the 3D distributed solve: 256^3, eps=4, 2x2x2 mesh (128^3 blocks)
DSTEPS = 20              # steps of each distributed solve


def phase_halo_checks(torch, np) -> dict:
    """Phase 8 (kernels): split_nsum2d and split_nsum3d on frames, and
    fused_nsum2d and fused_nsum3d on every block of meshes of virtual
    devices of the card, against their plain versions in float64, float32
    and the bf16 operand tier, on normal, degenerate (a side <= 2*eps) and
    multi-hop (eps above the block edge) blocks, and BITWISE against the
    one-pass nsum2d/nsum3d on the same (halo-exchanged) frame; the
    refusals beyond the shared-memory tile and the neighbour table."""
    from nonlocalheatequation_torch.ops import cuda_halo as th
    from nonlocalheatequation_torch.ops import cuda_kernel as ck
    from nonlocalheatequation_torch.ops import cuda_kernel3d as k3
    from nonlocalheatequation_torch.parallel import halo as thalo
    from nonlocalheatequation_torch.parallel import mesh as tmesh

    rng = np.random.default_rng(SEED + 20)
    cases2 = [((70, 45), 5), ((300, 200), 8), ((100, 90), 40), ((2048, 64), 8),
              ((8, 40), 4), ((33, 33), 16), ((8, 8), 9), ((5, 7), 12)]
    # split_nsum3d: its register design up to eps 6 (16-byte staging at (16,
    # 16, 64) and (24, 24, 100) eps 4, the latter with a lattice interior;
    # unaligned bz at eps 3 and 6), its tile body at eps 7
    cases3 = [((20, 12, 40), 3), ((33, 17, 40), 4), ((16, 16, 70), 6), ((12, 12, 12), 1),
              ((4, 4, 4), 2), ((6, 9, 8), 3), ((4, 4, 4), 5), ((3, 5, 2), 6),
              ((16, 16, 64), 4), ((24, 24, 100), 4), ((9, 7, 13), 3), ((18, 17, 70), 6),
              ((16, 16, 72), 7)]
    worst, n = {}, {"split_nsum2d": 0, "split_nsum3d": 0}
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[1]
        tol = TOL[dname]
        for prec in ("f32", "bf16"):
            for name, cases, split, plain, one_pass in (
                    ("split_nsum2d", cases2, th.split_nsum2d, th.split_nsum2d_plain, ck.nsum2d),
                    ("split_nsum3d", cases3, th.split_nsum3d, th.split_nsum3d_plain,
                     k3.nsum3d)):
                for block, e in cases:
                    frame = torch.tensor(rng.standard_normal(tuple(b + 2 * e for b in block)),
                                         dtype=dtype, device="cuda")
                    got, ref = split(frame, e, prec), plain(frame, e, prec)
                    _abs, rel = rel_err(torch, got, ref)
                    kind = ("degenerate" if th.degenerate(block, e)
                            else "multi-hop" if e > min(block) else "normal")
                    if not rel <= tol:
                        fail(f"{name} {dname} {prec} {block} eps={e} ({kind}): rel err "
                             f"{rel:.3e} > {tol:g}")
                    if not torch.equal(got, one_pass(frame, e, prec)):
                        fail(f"{name} {dname} {prec} {block} eps={e} ({kind}): not bitwise the "
                             "one-pass sum on the same frame")
                    key = f"{name}/{dname}/{prec}"
                    worst[key] = max(worst.get(key, 0.0), rel)
                    n[name] += 1
    # the in-kernel exchange: every block of a mesh of virtual devices of
    # the card, its halo read from the blocks around it
    # fused_nsum2d: its register design up to eps 10 (16-byte staging of
    # interior windows at (300, 200) eps 8; a row across two block edges at
    # (40, 12); multi-hop and degenerate blocks), the tile body from eps 11;
    # fused_nsum3d: its register design up to eps 6 (windows staged from the
    # mesh 16 bytes a copy at eps 4 with bz a multiple of 4; unaligned bz;
    # multi-hop in z at (6, 8, 4) eps 6), the tile body from eps 7
    meshes = [((2, 2), (70, 45), 5), ((2, 2), (300, 200), 8), ((4, 2), (8, 8), 9),
              ((3, 3), (2, 2), 5), ((2, 4), (33, 33), 16), ((1, 3), (5, 7), 12),
              ((2, 2), (8, 40), 4), ((2, 2), (100, 90), 40), ((2, 2), (40, 12), 8),
              ((2, 2), (24, 24), 10), ((2, 3), (200, 70), 10), ((2, 2), (50, 30), 11),
              ((1, 3), (5, 7), 10), ((2, 2, 2), (20, 12, 40), 3),
              ((2, 2, 2), (33, 17, 40), 4), ((2, 2, 2), (4, 4, 4), 5), ((3, 2, 2), (6, 9, 8), 3),
              ((2, 2, 2), (12, 12, 12), 1), ((2, 2, 2), (16, 16, 70), 6),
              ((2, 2, 2), (3, 5, 2), 6), ((2, 2, 2), (16, 16, 64), 4),
              ((2, 2, 2), (24, 24, 100), 4), ((2, 2, 2), (9, 7, 13), 3),
              ((1, 2, 3), (6, 8, 4), 6), ((2, 2, 2), (16, 16, 72), 7)]
    n.update(fused_nsum2d=0, fused_nsum3d=0)
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[1]
        for prec in ("f32", "bf16"):
            for mesh_shape, block, e in meshes:
                d = len(mesh_shape)
                name = f"fused_nsum{d}d"
                fused = th.fused_nsum2d if d == 2 else th.fused_nsum3d
                one_pass = ck.nsum2d if d == 2 else k3.nsum3d
                mesh = tmesh.create_mesh(("x", "y", "z")[:d], mesh_shape,
                                         tmesh.device_list("cuda", int(np.prod(mesh_shape))))
                u = rng.standard_normal(tuple(m * b for m, b in zip(mesh_shape, block)))
                blocks = tmesh.put_global(u, mesh, dtype)
                frames = thalo.halo_pad_nd(blocks, e)
                kind = ("degenerate" if th.degenerate(block, e)
                        else "multi-hop" if e > min(block) else "normal")
                for pos in np.ndindex(*mesh_shape):
                    got = fused(blocks, pos, e, prec)
                    if not torch.equal(got, one_pass(frames[pos], e, prec)):
                        fail(f"{name} {dname} {prec} mesh {mesh_shape} {block} eps={e} ({kind}) "
                             f"block {pos}: not bitwise the one-pass sum on the exchanged frame")
                    _abs, rel = rel_err(torch, got, th.fused_nsum_plain(blocks, pos, e, prec))
                    if not rel <= TOL[dname]:
                        fail(f"{name} {dname} {prec} mesh {mesh_shape} {block} eps={e} block "
                             f"{pos}: rel err {rel:.3e} > {TOL[dname]:g}")
                    key = f"{name}/{dname}/{prec}"
                    worst[key] = max(worst.get(key, 0.0), rel)
                    n[name] += 1
    for what, call in (
            ("split_nsum2d accepted eps=70 (beyond its shared-memory tile)",
             lambda: th.split_nsum2d(torch.zeros(200, 200, device="cuda",
                                                 dtype=torch.float64), 70)),
            ("fused_nsum2d accepted eps=70 (beyond its shared-memory tile)",
             lambda: th.fused_nsum2d(tmesh.put_global(
                 np.zeros((400, 400)), tmesh.make_mesh(2, 2, tmesh.device_list("cuda", 4)),
                 torch.float64), (0, 0), 70)),
            ("fused_nsum2d accepted a neighbour table beyond 125 blocks",
             lambda: th.fused_nsum2d(tmesh.put_global(
                 np.zeros((12, 12)), tmesh.make_mesh(12, 12, tmesh.device_list("cuda", 144)),
                 torch.float64), (0, 0), 6))):
        try:
            call()
            fail(f"{what} on the card")
        except ValueError:
            pass
    say("halo kernel checks (max |kernel-plain| / max|plain|; every case bitwise the one-pass "
        "nsum2d/nsum3d on its halo-exchanged frame; normal, degenerate and multi-hop blocks): "
        + ", ".join(f"{k} {v:.2e}" for k, v in sorted(worst.items()))
        + "; cases " + ", ".join(f"{k} {v}" for k, v in n.items()) + ": pass")
    return n


def split_launches(grid, mesh_shape, eps: int, nt: int) -> int:
    """split_nsum launches of an nt-step comm='fused' solve: one per phase
    per block per step (interior and ring, or one whole-block pass)."""
    block = [g // m for g, m in zip(grid, mesh_shape)]
    nblocks = 1
    for m in mesh_shape:
        nblocks *= m
    phases = 1 if eps == 0 or any(b <= 2 * eps for b in block) else 2
    return nt * nblocks * phases


def phase_distributed(torch, np, ck, l2_threshold) -> list:
    """Phase 8: (a) the halo kernels at the main path's blocks, f32:
    fused_nsum2d on the (0, 0) 2048^2 block of a 2x2 mesh of virtual
    devices at eps=8 and fused_nsum3d on the (0, 0, 0) 128^3 block of a
    2x2x2 mesh at eps=4, split_nsum2d/3d on that block's exchanged frame,
    each held to its plain version and bitwise to the one-pass sum on the
    frame, timed per call (CUDA events; and in a CUDA graph, without the
    host's cost) beside its plain version, its bound and F.conv2d/F.conv3d
    over the frame (TF32 off); (b) counted, the main path:
    Solver2DDistributed at 4096^2, eps=8, on a 2x2 mesh of virtual devices
    of the card and Solver3DDistributed at 256^3, eps=4, on a 2x2x2 mesh,
    each DSTEPS production steps in f32 with comm='fused' (the in-kernel
    exchange), comm='fused' under NLHEAT_FUSED_TRANSPORT=interp (band
    copies, then the split kernels) and comm='collective', all bitwise
    equal; then the distributed CLI's CASES_2D_DISTRIBUTED table (float64,
    8 virtual devices, --comm fused and the collective default); the counts
    must be exactly the solves' and the rows'; (c) each solve within the
    f32 tolerance of the tuned single-device Solver2D/Solver3D, and the
    distributed steps timed on the card."""
    import contextlib
    import io

    import torch.nn.functional as F

    from nonlocalheatequation_torch.cli import solve2d_distributed
    from nonlocalheatequation_torch.models.solver2d import Solver2D
    from nonlocalheatequation_torch.models.solver3d import Solver3D
    from nonlocalheatequation_torch.ops import cuda_halo as th
    from nonlocalheatequation_torch.ops import cuda_kernel3d as k3
    from nonlocalheatequation_torch.ops.nonlocal_op import (
        NonlocalOp2D,
        full_fp32,
        make_multi_step_fn,
    )
    from nonlocalheatequation_torch.parallel.distributed2d import (
        Solver2DDistributed,
        choose_mesh_shape,
    )
    from nonlocalheatequation_torch.parallel.distributed3d import Solver3DDistributed
    from nonlocalheatequation_torch.parallel.halo import halo_pad_nd
    from nonlocalheatequation_torch.parallel.mesh import (
        create_mesh,
        device_list,
        make_mesh,
        make_mesh_3d,
        put_global,
    )

    f32, tol32, isz = torch.float32, TOL["float32"], 4
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    names = ("split_nsum2d", "fused_nsum2d", "split_nsum3d", "fused_nsum3d")
    held = {k: [] for k in names}

    def hold(name, form, got, ref, tol):
        abs_err, rel = rel_err(torch, got, ref)
        held[name].append({"form": form, "max_abs_err": abs_err, "rel_err": rel, "tol": tol})
        if not rel <= tol:
            fail(f"{name} {form}: |kernel-plain| / max|plain| {rel:.3e} > {tol:g}")

    # (a) the kernels at the blocks of the main path
    timing = {}
    for d, nblk, e, conv in ((2, DN // 2, DEPS, F.conv2d), (3, D3N // 2, D3EPS, F.conv3d)):
        block, pos = (nblk,) * d, (0,) * d
        shape = "x".join(map(str, block))
        mesh = create_mesh(("x", "y", "z")[:d], (2,) * d, device_list("cuda", 2 ** d))
        blocks = put_global(torch.randn((2 * nblk,) * d, generator=gen, device="cuda"), mesh,
                            f32)
        frame = halo_pad_nd(blocks, e)[pos]
        one_pass = ck.nsum2d if d == 2 else k3.nsum3d
        split = th.split_nsum2d if d == 2 else th.split_nsum3d
        fused = th.fused_nsum2d if d == 2 else th.fused_nsum3d
        kernels = {
            f"split_nsum{d}d": (lambda p, split=split: split(frame, e, p),
                                lambda p, split=split: (th.split_nsum2d_plain if d == 2
                                                        else th.split_nsum3d_plain)(frame, e, p)),
            f"fused_nsum{d}d": (lambda p, fused=fused: fused(blocks, pos, e, p),
                                lambda p: th.fused_nsum_plain(blocks, pos, e, p)),
        }
        ops = (NonlocalOp2D(e, 1.0, 1.0, 1.0) if d == 2 else op_3d(8, e))
        kern = torch.as_tensor(ops.weights, dtype=f32, device="cuda")[None, None]
        with full_fp32():
            lib_ms = cuda_ms(torch, lambda: conv(frame[None, None], kern), 5, 1)
            lib_err = float((conv(frame[None, None], kern)[0, 0] - one_pass(frame, e)).abs().max())
        one_pass_ms = cuda_ms(torch, lambda: one_pass(frame, e), 50)
        npts = int(np.prod(block))
        per_point = kernel_ops(e, 0) if d == 2 else kernel_ops_3d(e, k3.tile3d(e, f32), 0)
        bnd = bound((frame.numel() + npts) * isz, npts * per_point)
        for name, (call, plain) in kernels.items():
            for prec in ("f32", "bf16"):
                got = call(prec)
                hold(name, f"float32 {prec} {shape} block eps={e}", got, plain(prec), tol32)
                if not torch.equal(got, one_pass(frame, e, prec)):
                    fail(f"{name} {prec} at the {shape} block: not bitwise the one-pass sum on "
                         "the exchanged frame")
            ms = cuda_ms(torch, lambda call=call: call("f32"), 50)
            ms_graph = graph_ms(torch, lambda call=call: call("f32"), 20)
            plain_ms = cuda_ms(torch, lambda plain=plain: plain("f32"), 3, 1)
            timing[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1],
                                library_ms=lib_ms, ms_graph=ms_graph, one_pass_ms=one_pass_ms,
                                shape=f"{shape} block of a {'x'.join(['2'] * d)} mesh, "
                                      f"eps={e}, f32")
            extra = ""
            if name.startswith("split_"):
                out = torch.empty(block, dtype=f32, device="cuda")
                phase_ms = {p: cuda_ms(torch, lambda p=p: th.launch_phase(name, frame, out, e,
                                                                          "f32", p), 50)
                            for p in ("interior", "ring")}
                timing[name].update(ms_interior=phase_ms["interior"], ms_ring=phase_ms["ring"])
                extra = (f" (interior {phase_ms['interior']:.4f} + ring "
                         f"{phase_ms['ring']:.4f} ms alone)")
                del out
            say(f"{name} {shape} block eps={e} f32: kernel {ms:.4f} ms per call{extra}, "
                f"{ms_graph:.4f} in a CUDA graph; one-pass nsum on the exchanged frame "
                f"{one_pass_ms:.4f} ms, plain {plain_ms:.3f} ms, {conv.__name__} {lib_ms:.4f} "
                f"ms (TF32 off; max abs diff to one-pass {lib_err:.2e}), bound {bnd[0]:.4f} "
                f"ms ({bnd[1]})")
        del blocks, frame, kern

    # (b) the main path, counted
    devs4, devs8 = device_list("cuda", 4), device_list("cuda", 8)
    dh = 1.0 / DN
    probe = NonlocalOp2D(DEPS, 1.0, 1.0, dh)
    dt = 0.8 / (probe.c * dh * dh * probe.wsum)  # 0.8x the Euler bound, as phase 4
    u2 = np.random.default_rng(SEED + 22).standard_normal((DN, DN))
    op3 = op_3d(D3N, D3EPS)
    u3 = np.random.default_rng(SEED + 23).standard_normal((D3N,) * 3)
    cases = cases_module().CASES_2D_DISTRIBUTED
    forms = (("fused", ""), ("fused", "interp"), ("collective", ""))
    solvers, res, walls, by = {}, {}, {}, {}
    blocks_of = {"2d": f"{DN // 2}^2 blocks f32", "3d": f"{D3N // 2}^3 blocks f32"}
    ck.reset_launch_counts()
    for comm, transport in forms:
        os.environ["NLHEAT_FUSED_TRANSPORT"] = transport
        label = f"{comm} {transport}".strip()
        for d in ("2d", "3d"):
            if d == "2d":
                s = Solver2DDistributed(DN // 2, DN // 2, 2, 2, DSTEPS, DEPS, k=1.0, dt=dt,
                                        dh=dh, mesh=make_mesh(2, 2, devs4), method="cuda",
                                        dtype=f32, comm=comm)
                s.input_init(u2)
            else:
                s = Solver3DDistributed(D3N, D3N, D3N, DSTEPS, D3EPS, k=1.0, dt=op3.dt,
                                        dh=op3.dh, mesh=make_mesh_3d(2, 2, 2, devs8),
                                        method="cuda", dtype=f32, comm=comm)
                s.input_init(u3)
            t0 = time.perf_counter()
            res[f"{d} {label}"] = launches_of(ck, by, f"{blocks_of[d]}, {label}", s.do_work)
            walls[f"{d} {label}"] = time.perf_counter() - t0
            solvers[f"{d} {label}"] = (s, transport)
    os.environ.pop("NLHEAT_FUSED_TRANSPORT")
    cli_out = {}
    for extra in (["--method", "cuda", "--comm", "fused"], []):
        stdout, stderr = io.StringIO(), io.StringIO()
        stdin, sys.stdin = sys.stdin, io.StringIO(batch_text(cases))
        label = " ".join(extra) or "--comm collective (default, method auto)"
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(stderr):
                rc = launches_of(ck, by, f"CASES_2D_DISTRIBUTED rows f64, {label}",
                                 lambda: solve2d_distributed.main(
                                     [*CLI_ARGS, "--devices", "8", *extra]))
        finally:
            sys.stdin = stdin
        if rc != 0 or stdout.getvalue().splitlines()[-1] != "Tests Passed":
            fail(f"solve2d_distributed --test_batch {label}: rc {rc}\n{stdout.getvalue()}\n"
                 f"{stderr.getvalue()[-4000:]}")
        cli_out[label] = time.perf_counter() - t0
    counts = {k: v for k, v in ck.launch_counts().items() if v}

    # the counts each part must show: each solve's, and each CLI run's (its
    # rows' steps, a launch a block a step, and L(G) once a row)
    row_blocks = sum(nt * int(np.prod(choose_mesh_shape(nx * npx, ny * npy, 8)))
                     for nx, ny, npx, npy, nt, *_ in cases)
    rows = "CASES_2D_DISTRIBUTED rows f64"
    expected = {
        f"{blocks_of['2d']}, fused": {"fused_nsum2d": DSTEPS * 4},
        f"{blocks_of['3d']}, fused": {"fused_nsum3d": DSTEPS * 8},
        f"{blocks_of['2d']}, fused interp": {
            "split_nsum2d": split_launches((DN, DN), (2, 2), DEPS, DSTEPS)},
        f"{blocks_of['3d']}, fused interp": {
            "split_nsum3d": split_launches((D3N,) * 3, (2, 2, 2), D3EPS, DSTEPS)},
        f"{blocks_of['2d']}, collective": {"nsum2d": DSTEPS * 4},
        f"{blocks_of['3d']}, collective": {"nsum3d": DSTEPS * 8},
        f"{rows}, --method cuda --comm fused": {"fused_nsum2d": row_blocks,
                                                "nsum2d": len(cases)},
        f"{rows}, --comm collective (default, method auto)": {
            "nsum2d": row_blocks + len(cases)},
    }
    if by != expected:
        fail(f"distributed main path: launches by part {by} != {expected} (each solve's and "
             "each CLI run's)")
    for d in ("2d", "3d"):
        for label in ("fused", "fused interp"):
            if not np.array_equal(res[f"{d} {label}"], res[f"{d} collective"]):
                fail(f"the {d} distributed solve: comm='{label}' is not bitwise "
                     "comm='collective'")
        if not np.isfinite(res[f"{d} fused"]).all():
            fail(f"the {d} distributed solve: non-finite values")
    say(f"distributed main path: {DN}^2 eps={DEPS} on a 2x2 mesh of virtual devices of the "
        f"card and {D3N}^3 eps={D3EPS} on 2x2x2, {DSTEPS} production steps f32 each, "
        "comm='fused' (in-kernel exchange), 'fused' under NLHEAT_FUSED_TRANSPORT=interp (split "
        "kernels) and 'collective' bitwise equal (do_work walls, s: "
        f"{json.dumps({k: round(v, 3) for k, v in walls.items()})}); CASES_2D_DISTRIBUTED "
        "through solve2d_distributed --test_batch --platform gpu --x64 1 --devices 8: Tests "
        f"Passed ({json.dumps({k: round(v, 2) for k, v in cli_out.items()})} s); launches "
        f"{json.dumps(counts)} = the solves' and the rows'")

    # (c) against the tuned single-device solves, and the steps timed on the card
    solo = {"2d": Solver2D(DN, DN, DSTEPS, DEPS, k=1.0, dt=dt, dh=dh, method="cuda",
                           dtype=f32, device="cuda"),
            "3d": Solver3D(D3N, D3N, D3N, DSTEPS, D3EPS, k=1.0, dt=op3.dt, dh=op3.dh,
                           method="cuda", dtype=f32, device="cuda")}
    solo["2d"].input_init(u2)
    solo["3d"].input_init(u3)
    step_ms, profiles = {}, {}
    for d, s in solo.items():
        ref = s.do_work()
        rel = float(np.abs(res[f"{d} fused"] - ref).max()) / float(np.abs(ref).max())
        if not rel <= tol32:
            fail(f"the {d} distributed solve vs the tuned single-device solve: {rel:.3e} > "
                 f"{tol32:g}")
        step_ms[f"{d} vs tuned solo, max rel diff"] = rel
        for comm, transport in forms:
            label = f"{comm} {transport}".strip()
            dist, transport = solvers[f"{d} {label}"]
            os.environ["NLHEAT_FUSED_TRANSPORT"] = transport
            blocks = dist._device_state()[0]
            run = dist._make_runner(DSTEPS)
            step_ms[f"{d} {label}"] = [cuda_ms(torch, lambda: run(blocks, 0, ()), 1, 1) / DSTEPS
                                       for _ in range(3)]
            if label in ("fused", "collective"):
                profiles[f"{d} {label}"] = device_profile(torch, lambda: run(blocks, 0, ()),
                                                          DSTEPS)
        os.environ.pop("NLHEAT_FUSED_TRANSPORT")
        u_dev = torch.as_tensor(s.u0, device="cuda").to(f32)
        multi = make_multi_step_fn(s.op, DSTEPS, dtype=f32)
        step_ms[f"{d} tuned solo"] = [cuda_ms(torch, lambda: multi(u_dev, 0), 1, 1) / DSTEPS
                                      for _ in range(3)]
    say(f"distributed steps on the card, ms/step (CUDA events over {DSTEPS}-step runs, three "
        f"runs each, the exchange's copies included): {json.dumps(step_ms)}")
    say("the comm='fused' and 'collective' steps under torch.profiler, per step (device time "
        f"by kernel, the device's busy and idle share of the window): {json.dumps(profiles)}")
    del res, solvers, solo

    def row(name, source, line):
        cs = held[name]
        return {"name": name, "route": "cuda",
                "source": f"nonlocalheatequation_torch/csrc/{source}",
                "replaces": f"nonlocalheatequation_tpu/ops/pallas_halo.py:{line}",
                **timing[name], "launches": counts.get(name, 0),
                "launches_by_shape": by_label(by, name),
                "max_abs_err": max(c["max_abs_err"] for c in cs),
                "verdict": "pass" if all(c["rel_err"] <= c["tol"] for c in cs) else "fail",
                "main_shape_forms": len(cs),
                "library_note": "F.conv over the exchanged frame in full f32 (TF32 off)"}

    return [row("split_nsum2d", "split_nsum2d.cu", 437),
            row("split_nsum3d", "split_nsum3d.cu", 474),
            row("fused_nsum2d", "fused_nsum2d.cu", 611),
            row("fused_nsum3d", "fused_nsum3d.cu", 653)], by


# -- phase 10: async, logs, checkpoints ---------------------------------------------------

ASYNC_ND = 5                  # the throttle's depth (the async CLI's default --nd)
CKPT_EVERY, CKPT_STOP = 100, 300  # checkpoint cadence, and the step a run is stopped at
LOG_N, LOG_STEPS, LOG_EVERY = 128, 20, 5  # the logged CLI solve: 128^2, 20 steps, --nlog 5
PROFILE_STEPS = 20            # the profiled CLI solve's steps at 4096^2
#: the tuner's 2D candidates -> the prefix of their kernels' symbols
WINNER_SYMBOL = {"per-step": "batched_step2d", "carried": "batched_carried2d",
                 "superstep2": "superstep2d", "superstep3": "superstep2d",
                 "resident": "resident2d"}


def start_async_cli() -> tuple:
    """CASES_2D_ASYNC through solve2d_async --test_batch on the card in
    float64, started with phase 3's CLIs and collected in phase 10;
    (rows, process)."""
    rows = cases_module().CASES_2D_ASYNC
    proc = start_cli("nonlocalheatequation_torch.cli.solve2d_async", rows)
    CHILDREN.append(proc)
    return rows, proc


def spans_of(tracer, name: str) -> list:
    """The milliseconds of each ``name`` span the tracer recorded."""
    return [e["dur"] / 1e3 for e in tracer.events if e["name"] == name]


def run_cli(main, argv) -> str:
    """A port CLI's main(argv) in this process, counted by the caller; its
    stdout, or a failure on a non-zero exit code."""
    import contextlib
    import io

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    if rc != 0:
        fail(f"{' '.join(argv)}: rc {rc}\n{out.getvalue()}\n{err.getvalue()[-4000:]}")
    return out.getvalue()


def phase_async_logs(torch, np, ck, l2_threshold, async_cli) -> dict:
    """Phase 10: the async binary's throttle, checkpoints, CSV/VTU logs and
    --profile on the card; returns the launches by part."""
    from nonlocalheatequation_torch.cli import solve2d
    from nonlocalheatequation_torch.models.solver2d import Solver2D
    from nonlocalheatequation_torch.models.solver3d import Solver3D
    from nonlocalheatequation_torch.obs import trace as obs_trace
    from nonlocalheatequation_torch.ops.nonlocal_op import NonlocalOp2D
    from nonlocalheatequation_torch.parallel.distributed2d import Solver2DDistributed
    from nonlocalheatequation_torch.parallel.mesh import device_list, make_mesh
    from nonlocalheatequation_torch.utils import autotune
    from nonlocalheatequation_torch.utils.checkpoint import fetch_state
    from nonlocalheatequation_torch.utils.vtu import read_vtu_point_data

    f32, by = torch.float32, {}
    dh = 1.0 / NX
    probe = NonlocalOp2D(EPS, 1.0, 1.0, dh)
    dt = 0.8 / (probe.c * dh * dh * probe.wsum)  # 0.8x the Euler bound, as phase 4
    u0 = np.random.default_rng(SEED + 30).standard_normal((NX, NX))

    def solo(nt, **kw):
        s = Solver2D(NX, NX, nt, EPS, k=1.0, dt=dt, dh=dh, method="cuda", dtype=f32,
                     device="cuda", **kw)
        s.input_init(u0)
        return s

    # (a) the throttle at full width against the unthrottled tuned solve
    tuned = solo(STEPS)
    ref = launches_of(ck, by, f"phase 10 {NX}^2 tuned", tuned.do_work)
    key = autotune.tuning_key(tuned.op, (NX, NX), f32, "cuda")
    winner = autotune.records()[key]["winner"]
    throttled = solo(STEPS, nd=ASYNC_ND)
    res = launches_of(ck, by, f"phase 10 {NX}^2 nd={ASYNC_ND}", throttled.do_work)
    if throttled.max_inflight_ != ASYNC_ND:
        fail(f"the throttle held {throttled.max_inflight_} steps in flight, not {ASYNC_ND}")
    if not np.array_equal(res, ref):
        fail(f"the nd={ASYNC_ND} solve at {NX}^2 is not bitwise the tuned solve "
             f"(winner {winner})")
    if by[f"phase 10 {NX}^2 nd={ASYNC_ND}"] != {"step2d": STEPS}:
        fail(f"the nd={ASYNC_ND} solve launched {by[f'phase 10 {NX}^2 nd={ASYNC_ND}']}, not "
             f"{STEPS} step2d and nothing else")
    walls = {"throttled": [], "tuned": []}
    for name in ("throttled", "tuned", "tuned", "throttled") * 2:
        s = solo(STEPS, nd=ASYNC_ND if name == "throttled" else None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.do_work()
        walls[name].append((time.perf_counter() - t0) * 1e3 / STEPS)
    cost = min(walls["throttled"]) - min(walls["tuned"])
    say(f"throttle {NX}^2 eps={EPS} f32 nd={ASYNC_ND}, {STEPS} steps: max in flight "
        f"{throttled.max_inflight_}, bitwise the tuned solve (winner {winner}), launches "
        f"{json.dumps(by[f'phase 10 {NX}^2 nd={ASYNC_ND}'])}; do_work wall ms/step in turns "
        f"(the state's copies included): {json.dumps(walls)}; the throttle's cost "
        f"{cost:.5f} ms/step ({cost / min(walls['tuned']) * 100:.1f}% of the tuned solve)")

    # (b) the async CLI, started with phase 3's CLIs
    rows, proc = async_cli
    out, err = proc.communicate(timeout=600)
    if proc.returncode != 0 or "Tests Passed" not in out:
        fail(f"solve2d_async --test_batch --platform gpu --x64 1: rc {proc.returncode}\n"
             f"{out}\n{err[-4000:]}")
    say(f"cli solve2d_async --test_batch --platform gpu --x64 1: Tests Passed ({len(rows)} "
        f"rows, CASES_2D_ASYNC, nd {ASYNC_ND})")

    # (c) checkpoints at full width: stopped at CKPT_STOP and resumed, bitwise the
    # uninterrupted run; each save's and load's wall
    mesh = make_mesh(2, 2, device_list("cuda", 4))
    op3 = op_3d(N3, EPS3)
    u3 = np.random.default_rng(SEED + 31).standard_normal((N3,) * 3)

    def dist(nt, **kw):
        s = Solver2DDistributed(NX // 2, NX // 2, 2, 2, nt, EPS, k=1.0, dt=dt, dh=dh, mesh=mesh,
                                method="cuda", dtype=f32, comm="fused", **kw)
        s.input_init(u0)
        return s

    def solo3(nt, **kw):
        s = Solver3D(N3, N3, N3, nt, EPS3, k=1.0, dt=op3.dt, dh=op3.dh, method="cuda",
                     dtype=f32, device="cuda", **kw)
        s.input_init(u3)
        return s

    ckpt = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, make in ((f"{NX}^2", solo), (f"{NX}^2 2x2 fused", dist),
                           (f"{N3}^3 eps={EPS3}", solo3)):
            path = os.path.join(tmp, name.replace(" ", "_").replace("^", "") + ".npz")
            tracer = obs_trace.Tracer()
            prev = obs_trace.set_tracer(tracer)
            try:
                full = make(STEPS, checkpoint_path=path + ".full", ncheckpoint=CKPT_EVERY)
                launches_of(ck, by, f"phase 10 {name} checkpointed", full.do_work)
                first = make(STEPS, checkpoint_path=path, ncheckpoint=CKPT_EVERY)
                first.nt = CKPT_STOP  # stopped after CKPT_STOP steps, its last save there
                launches_of(ck, by, f"phase 10 {name} stopped", first.do_work)
                second = make(STEPS)
                second.resume(path)
                launches_of(ck, by, f"phase 10 {name} resumed", second.do_work)
            finally:
                obs_trace.set_tracer(prev)
            if second.t0 != CKPT_STOP or not np.array_equal(second.u, full.u):
                fail(f"checkpoints {name}: the run resumed at step {second.t0} is not bitwise "
                     "the uninterrupted run")
            # the fetch before a save, alone: the state's blocks, or its tensor
            on_card = (full._device_state()[0] if isinstance(full, Solver2DDistributed)
                       else torch.as_tensor(full.u, device="cuda"))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            host = fetch_state(on_card)
            fetch_ms = (time.perf_counter() - t0) * 1e3
            ckpt[name] = {"saves": STEPS // CKPT_EVERY + CKPT_STOP // CKPT_EVERY,
                          "state_MiB": host.nbytes / 2**20, "fetch_ms": fetch_ms,
                          "save_ms": spans_of(tracer, "checkpoint.save"),
                          "load_ms": spans_of(tracer, "checkpoint.load"),
                          "launches": {part: by[f"phase 10 {name} {part}"]
                                       for part in ("checkpointed", "stopped", "resumed")}}
            if len(ckpt[name]["save_ms"]) != ckpt[name]["saves"]:
                fail(f"checkpoints {name}: {len(ckpt[name]['save_ms'])} saves, not "
                     f"{ckpt[name]['saves']}")
            del full, first, second, on_card, host
    for name, c in ckpt.items():
        say(f"checkpoints {name} f32, {STEPS} steps every {CKPT_EVERY} against a run stopped at "
            f"{CKPT_STOP} and resumed: bitwise equal; {c['state_MiB']:.0f} MiB a state, fetch "
            f"{c['fetch_ms']:.1f} ms, each save (npz, CRC and fsync) ms "
            f"{[round(x, 1) for x in c['save_ms']]}, load ms "
            f"{[round(x, 1) for x in c['load_ms']]}; launches {json.dumps(c['launches'])}")
    if by[f"phase 10 {NX}^2 2x2 fused stopped"] != {"fused_nsum2d": 4 * CKPT_STOP}:
        fail(f"the 2x2 run stopped at {CKPT_STOP} launched "
             f"{by[f'phase 10 {NX}^2 2x2 fused stopped']}, not {4 * CKPT_STOP} fused_nsum2d")

    # (d) logs: solve2d --log at LOG_N^2, the snapshots held to solves that end there
    argv = ["--test", "--log", "--nlog", str(LOG_EVERY), "--nx", str(LOG_N), "--ny", str(LOG_N),
            "--nt", str(LOG_STEPS), "--cmp", "false", "--platform", "gpu"]
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            launches_of(ck, by, f"phase 10 {LOG_N}^2 --log", lambda: run_cli(solve2d.main, argv))
        finally:
            os.chdir(cwd)
        logged = list(range(0, LOG_STEPS, LOG_EVERY))
        with open(os.path.join(tmp, "out_csv", "simulate_2d.csv")) as f:
            nrows = sum(1 for _ in f)
        with open(os.path.join(tmp, "out_csv", "score_2d.csv")) as f:
            nscore = sum(1 for _ in f)
        snaps = sorted(os.listdir(os.path.join(tmp, "out_vtk")))
        if (nrows, nscore, len(snaps)) != (len(logged) * LOG_N**2, len(logged), len(logged)):
            fail(f"solve2d --log: {nrows} rows, {nscore} scores, snapshots {snaps}; expected "
                 f"{len(logged)} logs of {LOG_N}^2")
        worst, bitwise = 0.0, True
        for i, t in enumerate(logged):
            data = read_vtu_point_data(os.path.join(tmp, "out_vtk", f"simulate_{i}.vtu"))
            got = data["Temperature"].reshape(LOG_N, LOG_N).T
            s = Solver2D(LOG_N, LOG_N, t + 1, 5, dtype=f32, device="cuda")
            s.test_init()
            want = launches_of(ck, by, f"phase 10 {LOG_N}^2 log reference {t + 1} steps",
                               s.do_work)
            err = float(np.abs(got - want).max() / np.abs(want).max())
            worst, bitwise = max(worst, err), bitwise and np.array_equal(got, want)
            if not err <= TOL["float32"] or data["TIME"][0] != t * s.op.dt:
                fail(f"solve2d --log: snapshot {i} (t={t}) differs from a {t + 1}-step solve "
                     f"by {err:.3e}, or its TIME {data['TIME'][0]} is not {t * s.op.dt}")
    if by[f"phase 10 {LOG_N}^2 --log"] != {"step2d": LOG_STEPS, "nsum2d": 1}:
        fail(f"solve2d --log launched {by[f'phase 10 {LOG_N}^2 --log']}")
    say(f"logs: solve2d --test --log --nlog {LOG_EVERY} at {LOG_N}^2, {LOG_STEPS} steps: {nrows} "
        f"csv rows, {nscore} scores, {len(snaps)} snapshots read back; each within "
        f"{worst:.2e} of a solve ending at its step (bitwise: {bitwise})")

    # (e) --profile at 4096^2: resumed from a checkpoint (the production form,
    # no state on stdin), the trace must name the tuned winner's kernel
    with tempfile.TemporaryDirectory() as tmp:
        path, pdir = os.path.join(tmp, "state.npz"), os.path.join(tmp, "profile")
        s = solo(CKPT_STOP, checkpoint_path=path, ncheckpoint=CKPT_STOP)
        launches_of(ck, by, f"phase 10 {NX}^2 profile's checkpoint", s.do_work)
        del s
        argv = ["--nx", str(NX), "--ny", str(NX), "--nt", str(CKPT_STOP + PROFILE_STEPS),
                "--eps", str(EPS), "--k", "1.0", "--dt", repr(dt), "--dh", repr(dh),
                "--method", "cuda", "--checkpoint", path, "--resume", "--profile", pdir,
                "--cmp", "false", "--platform", "gpu", "--x64", "0"]
        t0 = time.perf_counter()
        launches_of(ck, by, f"phase 10 {NX}^2 --profile", lambda: run_cli(solve2d.main, argv))
        wall = time.perf_counter() - t0
        traces = [os.path.join(r, f) for r, _, fs in os.walk(pdir) for f in fs]
        if len(traces) != 1:
            fail(f"--profile wrote {traces}, not one trace")
        with open(traces[0]) as f:
            text = f.read()
        size = len(text)
    symbol = WINNER_SYMBOL[winner]
    n_symbol = text.count(symbol)
    kernel, k = variant_launches(winner, PROFILE_STEPS)
    if n_symbol == 0 or by[f"phase 10 {NX}^2 --profile"] != {kernel: k}:
        fail(f"--profile: the trace names {symbol} (the winner {winner}'s kernel) {n_symbol} "
             f"times; launches {by[f'phase 10 {NX}^2 --profile']}, expected {{{kernel}: {k}}}")
    say(f"profile: solve2d --resume --profile at {NX}^2, {PROFILE_STEPS} steps (winner {winner}, "
        f"{k} {kernel} launches): one Chrome trace of {size} bytes naming {symbol} {n_symbol} "
        f"times; CLI wall {wall:.2f} s")
    return by


# -- phase 11: decomposition, partition maps, the balancer, the elastic executor ----------

REF_N, REF_TILE, REF_EPS, REF_DT, REF_STEPS = 400, 20, 8, 1e-5, 20  # the reference's 4-node run
EL_TILES, EL_STEPS, EL_NBALANCE, EL_DEVICES = 8, 200, 20, 4  # 4096^2 as 8x8 tiles of 512^2
#: the reference's acceptance fixtures, each on its number of virtual devices
ACCEPT_FIXTURES = (("data/load_balance_25s_2n.txt", 2), ("data/load_balance_25s_4n.txt", 4))
ACCEPT_ARGS = ["--test_load_balance", "--nbalance", "10", "--nt", "45", "--eps", "5"]
ACCEPT_REPEATS = 10  # runs of each fixture: the verdict is recorded per run


def l2_line(text: str, what: str) -> float:
    """error_l2 from a distributed CLI's ``l2: X linfinity: Y`` line."""
    line = next((x for x in text.splitlines() if x.startswith("l2: ")), None)
    if line is None:
        fail(f"{what}: no l2 line\n{text[-2000:]}")
    return float(line.split()[1])


def instrument_elastic(torch, np, s, gang_cls) -> dict:
    """Wrap an ElasticSolver2D's gang stretches, measured steps and
    rebalances to record their walls (between card synchronizations), the
    busy rates each rebalance read and the tiles it moved."""
    stats = {"gang": [], "window": [], "rebalances": []}
    s._gang = gang_cls(s)
    stretch, measured, rebalance = s._gang.run_stretch, s._step_all_measured, s._rebalance

    def timed(kind, fn, *args, steps=1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        stats[kind].append(((time.perf_counter() - t0) * 1e3, steps))
        return out

    def logged_rebalance():
        busy = np.asarray(s.telemetry.busy_rates(s.assignment), dtype=np.float64)
        moved = rebalance()
        stats["rebalances"].append({
            "busy": [round(float(b), 1) for b in busy], "moved": int(moved),
            "tiles": np.bincount(s.assignment.ravel(), minlength=len(s.devices)).tolist()})
        return moved

    s._gang.run_stretch = lambda t0, n: timed("gang", stretch, t0, n, steps=n)
    s._step_all_measured = lambda t: timed("window", measured, t)
    s._rebalance = logged_rebalance
    return stats


def ms_per_step(parts) -> float:
    steps = sum(n for _, n in parts)
    return sum(ms for ms, _ in parts) / steps if steps else float("nan")


def phase_elastic(torch, np, ck, l2_threshold) -> dict:
    """Phase 11: (a) the reference's documented 4-node run: a binary 4.1
    mesh of 400x400 at dh=1/400, split by the port's decomposition CLI into
    20x20 tiles of 20^2 over 4 owners (its edge cut no worse than the
    quadrant map's), then solve2d_distributed --file on 4 virtual devices of
    the card, eps=8, dt=1e-5, 20 steps, float64: the manufactured contract,
    and the state (from its checkpoint at the last step) within 1e-12 of
    the single-device Solver2D.  (b) Full width: 4096^2, eps=8, float32,
    test form, as 8x8 tiles of 512^2 on 4 virtual devices, from 61 tiles on
    device 1 and one on each of the others, --nbalance 20, 200 steps: the
    gang stretches' and measured windows' ms/step, the rates and moves of
    each rebalance, the final balance check, the device time of a 10-step
    gang stretch by kernel (torch.profiler); bitwise equal to the default
    map without nbalance, to the imbalanced map with every step measured
    (the rectangle walk, no gang stretch) and to the single-device Solver2D;
    the manufactured contract.  (c) The reference's acceptance check:
    solve2d_distributed --file data/load_balance_25s_2n.txt on 2 virtual
    devices and _4n.txt on 4, --test_load_balance --nbalance 10 --nt 45
    --eps 5, float64, ten runs each: the balancer must move tiles
    off the fixture's start and empty no device; the report's verdict (max
    |busy - mean| <= 1500 of 10000, measured) is recorded.  Every run
    counted: each tile's frame is one nsum2d launch a step, and each
    test-form run's L(G) one more.  Returns the launches by part."""
    from nonlocalheatequation_torch.cli import decompose as decompose_cli
    from nonlocalheatequation_torch.cli import solve2d_distributed
    from nonlocalheatequation_torch.models.solver2d import Solver2D
    from nonlocalheatequation_torch.ops.nonlocal_op import NonlocalOp2D
    from nonlocalheatequation_torch.parallel.elastic import ElasticSolver2D
    from nonlocalheatequation_torch.parallel.gang import GangExecutor
    from nonlocalheatequation_torch.parallel.load_balance import balance_check
    from nonlocalheatequation_torch.parallel.mesh import device_list
    from nonlocalheatequation_torch.utils import decompose
    from nonlocalheatequation_torch.utils.checkpoint import load_state
    from nonlocalheatequation_torch.utils.gmsh import write_structured_msh
    from nonlocalheatequation_torch.utils.partition_map import read_partition_map

    by = {}
    say(f"elastic: partitioner {decompose.PARTITIONER} ("
        + ("native/build/libpartition.so" if decompose.PARTITIONER == "native"
           else "rcb_numpy + refine_cut_numpy: native/build/libpartition.so is not built")
        + ")")

    def expect(label, want):
        got = by[label]
        if got != want:
            fail(f"{label}: launched {json.dumps(got)}, expected {json.dumps(want)}")

    # (a) the reference's documented 4-node run, float64
    n_t = REF_N // REF_TILE
    with tempfile.TemporaryDirectory() as tmp:
        mesh, map_path, ck_path = (os.path.join(tmp, f) for f in ("mesh.msh", "map.txt", "c.npz"))
        t0 = time.perf_counter()
        write_structured_msh(mesh, REF_N, REF_N, 1.0 / REF_N, binary=True)
        run_cli(decompose_cli.main, [mesh, map_path, "4", "--sx", str(REF_TILE),
                                     "--sy", str(REF_TILE)])
        decompose_s = time.perf_counter() - t0
        pmap = read_partition_map(map_path)
        quad = (np.arange(n_t)[:, None] // (n_t // 2)) * 2 + np.arange(n_t)[None, :] // (n_t // 2)
        cut, quad_cut = decompose.edge_cut(pmap.assignment), decompose.edge_cut(quad)
        owners = np.bincount(pmap.assignment.ravel(), minlength=4)
        if ((pmap.nx, pmap.ny, pmap.npx, pmap.npy) != (REF_TILE, REF_TILE, n_t, n_t)
                or cut > quad_cut or owners.max() - owners.min() > 1):
            fail(f"decompose {REF_N}^2 into {REF_TILE}^2 tiles over 4: map {pmap.nx}x{pmap.ny} "
                 f"tiles on {pmap.npx}x{pmap.npy}, owners {owners.tolist()}, edge cut {cut} "
                 f"(quadrants {quad_cut})")
        label = f"phase 11 {REF_N}^2 map, {n_t * n_t} tiles of {REF_TILE}^2 eps={REF_EPS} f64"
        argv = ["--file", map_path, "--eps", str(REF_EPS), "--dt", repr(REF_DT), "--nt",
                str(REF_STEPS), "--test", "true", "--cmp", "false", "--method", "cuda",
                "--platform", "gpu", "--x64", "1", "--devices", "4", "--checkpoint", ck_path,
                "--ncheckpoint", str(REF_STEPS), "--no-header"]
        t0 = time.perf_counter()
        text = launches_of(ck, by, label, lambda: run_cli(solve2d_distributed.main, argv))
        cli_s = time.perf_counter() - t0
        expect(label, {"nsum2d": n_t * n_t * REF_STEPS + 1})
        err = l2_line(text, "solve2d_distributed --file") / REF_N**2
        if not err <= l2_threshold:
            fail(f"solve2d_distributed --file ({REF_N}^2 map): error_l2/#points {err:.3e} > "
                 f"{l2_threshold:g}")
        u, t_saved, _ = load_state(ck_path)
    ref = Solver2D(REF_N, REF_N, REF_STEPS, REF_EPS, k=1.0, dt=REF_DT, dh=pmap.dh, method="cuda",
                   dtype=torch.float64, device="cuda")
    ref.test_init()
    launches_of(ck, by, f"phase 11 {REF_N}^2 single-device reference", ref.do_work)
    diff = float(np.abs(u - ref.u).max())
    if t_saved != REF_STEPS or not diff <= TOL["float64"]:
        fail(f"solve2d_distributed --file at t={t_saved}: max|elastic - Solver2D| {diff:.3e} > "
             f"{TOL['float64']:g}")
    say(f"elastic (a): {REF_N}^2 binary 4.1 mesh decomposed by cli.decompose into {n_t}x{n_t} "
        f"tiles of {REF_TILE}^2 over 4 owners {owners.tolist()} in {decompose_s:.2f} s, edge cut "
        f"{cut} (quadrants {quad_cut}); solve2d_distributed --file on 4 virtual devices, "
        f"eps={REF_EPS}, dt={REF_DT:g}, {REF_STEPS} steps, f64: error_l2/#points {err:.3e} <= "
        f"{l2_threshold:g}, max|u - Solver2D| {diff:.3e} <= {TOL['float64']:g}, "
        f"{by[label]['nsum2d']} nsum2d launches, CLI wall {cli_s:.2f} s")

    # (b) full width: the headline grid through the executor, float32
    tile = NX // EL_TILES
    dh = 1.0 / NX
    probe = NonlocalOp2D(EPS, 1.0, 1.0, dh)
    dt = 0.8 / (probe.c * dh * dh * probe.wsum)  # 0.8x the Euler bound, as phase 4
    devs = device_list("cuda", EL_DEVICES)
    start = np.ones((EL_TILES, EL_TILES), dtype=np.int64)
    start[0, 0], start[0, -1], start[-1, 0] = 0, 2, 3  # 61 tiles on device 1
    shape = f"{EL_TILES}x{EL_TILES} tiles of {tile}^2 eps={EPS} f32"
    want = {"nsum2d": EL_TILES * EL_TILES * EL_STEPS + 1}

    def elastic(assignment, nbalance, measure=False):
        s = ElasticSolver2D(tile, tile, EL_TILES, EL_TILES, EL_STEPS, EPS, nbalance=nbalance,
                            k=1.0, dt=dt, dh=dh, assignment=assignment, devices=devs,
                            method="cuda", dtype=torch.float32)
        # without nbalance, measure=True (--test_load_balance) measures every
        # step: each runs the rectangle walk, device group after group
        s.measure = s.measure or measure
        s.test_init()
        return s

    runs, walls, stats = {}, {}, None
    for name, args in (("imbalanced, nbalance", (start, EL_NBALANCE)),
                       ("default map", (None, None)),
                       ("imbalanced, every step measured", (start, None, True))):
        s = elastic(*args)
        if stats is None:
            stats, main = instrument_elastic(torch, np, s, GangExecutor), s
        label = f"phase 11 {NX}^2 {shape} {name}"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[name] = launches_of(ck, by, label, s.do_work)
        walls[name] = (time.perf_counter() - t0) * 1e3 / EL_STEPS
        expect(label, want)
    names = list(runs)
    for other in names[1:]:
        if not np.array_equal(runs[names[0]], runs[other]):
            fail(f"elastic {NX}^2: the run '{other}' is not bitwise the run '{names[0]}'")
    err = main.error_l2 / NX**2
    if not err <= l2_threshold:
        fail(f"elastic {NX}^2 test form: error_l2/#points {err:.3e} > {l2_threshold:g}")
    ok, max_dev = balance_check(main.busy_rates())
    if not stats["rebalances"] or sum(r["moved"] for r in stats["rebalances"]) == 0:
        fail(f"elastic {NX}^2: the balancer moved no tile: {stats['rebalances']}")
    solo = Solver2D(NX, NX, EL_STEPS, EPS, k=1.0, dt=dt, dh=dh, method="cuda",
                    dtype=torch.float32, device="cuda")
    solo.test_init()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    launches_of(ck, by, f"phase 11 {NX}^2 single-device reference", solo.do_work)
    solo_ms = (time.perf_counter() - t0) * 1e3 / EL_STEPS
    solo_err = solo.error_l2 / NX**2
    if not solo_err <= l2_threshold:
        fail(f"Solver2D {NX}^2 test form: error_l2/#points {solo_err:.3e} > {l2_threshold:g}")
    if not np.array_equal(runs[names[0]], solo.u):
        rel = float(np.abs(runs[names[0]] - solo.u).max() / np.abs(solo.u).max())
        fail(f"elastic {NX}^2: not bitwise the single-device Solver2D (max|elastic - Solver2D| "
             f"/ max|Solver2D| {rel:.3e}): the tiles' nsum2d and euler_update no longer add "
             "as the solo step kernel does")
    # where a gang step's time goes: a 10-step stretch at the final
    # placement under torch.profiler (not counted: it repeats the path)
    gang = GangExecutor(main)
    gang.rebuild(main._tiles, main._gtiles)
    prof = device_profile(torch, lambda: gang.run_stretch(0, 10), 10)
    del gang
    say(f"elastic (b): {NX}^2 as {shape}, test form, {EL_STEPS} steps on {EL_DEVICES} virtual "
        f"devices from {np.bincount(start.ravel()).tolist()} tiles, --nbalance {EL_NBALANCE}: "
        f"gang stretches {ms_per_step(stats['gang']):.3f} ms/step over "
        f"{sum(n for _, n in stats['gang'])} steps, measured windows "
        f"{ms_per_step(stats['window']):.3f} ms/step over {len(stats['window'])} steps; "
        f"do_work wall ms/step {json.dumps({k: round(v, 3) for k, v in walls.items()})}, "
        f"single-device Solver2D {solo_ms:.3f}; rebalances (busy read, tiles moved, tiles "
        f"after) {json.dumps(stats['rebalances'])}; final balance_check {ok} (max |busy - "
        f"mean| {max_dev:.1f} of 10000, rates {np.round(main.busy_rates(), 1).tolist()}); "
        f"bitwise equal across the {len(runs)} runs and to the single-device Solver2D; "
        f"error_l2/#points {err:.3e} (Solver2D {solo_err:.3e}) <= {l2_threshold:g}; "
        f"{want['nsum2d']} nsum2d launches a run; a 10-step gang stretch at the "
        f"final placement under torch.profiler: {json.dumps(prof)}")

    # (c) the reference's acceptance check on measured busy rates, float64
    acceptance_runs(np, ck, by, ACCEPT_REPEATS)
    return by


def acceptance_runs(np, ck, by: dict, repeats: int, verbose: bool = True) -> dict:
    """The reference's acceptance check on measured busy rates, float64:
    ``repeats`` runs of solve2d_distributed --file on each fixture of
    ACCEPT_FIXTURES (on as many virtual devices of the card as it names),
    ACCEPT_ARGS.  Recorded, not a gate: the windows are 4 host-bound steps
    of a few hundred microseconds, and the verdict fails in about a quarter
    of the 4n runs (25 tiles on 4 devices leave 1071 of the 1500 at the best
    split, 7/6/6/6) and in about 1 of 100 of the 2n runs (PERF.md §6).
    Gated: the launches, the report, and that the balancer moved
    tiles off the fixture's start without emptying a device.  Returns each
    fixture's max |busy - mean| per run."""
    from nonlocalheatequation_torch.cli import solve2d_distributed
    from nonlocalheatequation_torch.utils.partition_map import read_partition_map

    devs = {}
    for path, ndev in ACCEPT_FIXTURES:
        name = os.path.basename(path)
        start = read_partition_map(str(ROOT / path)).assignment
        start_counts = np.bincount(start.ravel(), minlength=ndev)
        passed, devs[name] = [], []
        for rep in range(repeats):
            label = f"phase 11 {name} on {ndev} devices, 25 tiles of 20^2 eps=5 f64, run {rep + 1}"
            argv = ["--file", str(ROOT / path), *ACCEPT_ARGS, "--devices", str(ndev),
                    "--method", "cuda", "--platform", "gpu", "--x64", "1", "--cmp", "false",
                    "--no-header"]
            t0 = time.perf_counter()
            text = launches_of(ck, by, label, lambda: run_cli(solve2d_distributed.main, argv))
            wall = time.perf_counter() - t0
            if by[label] != {"nsum2d": 25 * 45 + 1}:
                fail(f"{label}: launched {json.dumps(by[label])}, expected 1126 nsum2d")
            lines = text.splitlines()
            i = lines.index("Visualizing Load Balance across nodes")
            grid = np.array([[int(v) for v in row.split()] for row in lines[i + 1:i + 1 + len(start)]])
            counts = np.bincount(grid.ravel(), minlength=ndev)
            rates = [float(x.split()[-1]) for x in lines if x.startswith("Test: counter value:")]
            verdict = next(x for x in lines if x.startswith("Load ") and x.endswith("correctly"))
            if len(rates) != ndev or np.array_equal(counts, start_counts) or not counts.all():
                fail(f"{path}: the balancer left tiles {counts.tolist()} from {start_counts.tolist()}"
                     f" (rates {rates})")
            dev = max(abs(r - sum(rates) / ndev) for r in rates)
            passed.append(verdict == "Load balanced correctly")
            devs[name].append(round(dev, 1))
            if verbose:
                say(f"elastic (c): {name} on {ndev} virtual devices, {' '.join(ACCEPT_ARGS)}, run "
                    f"{rep + 1}: rates {[round(r, 1) for r in rates]}, max |busy - mean| {dev:.1f} "
                    f"of 10000, tiles {start_counts.tolist()} -> {counts.tolist()}; \"{verdict}\"; "
                    f"CLI wall {wall:.2f} s")
        say(f"elastic (c): {name}: the reference's check (max |busy - mean| <= 1500) passed "
            f"{sum(passed)} of {len(passed)} runs on the card's wall clock; max |busy - mean| "
            f"median {float(np.median(devs[name])):.1f}, max {max(devs[name]):.1f}")
    return devs


def accept_main(repeats: int) -> int:
    """``chip_smoke.py --accept N``: only phase 11's acceptance check, N runs
    of each fixture (builds nsum2d.cu), to read the verdict's failure rate."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from nonlocalheatequation_torch.ops import _build
    from nonlocalheatequation_torch.ops import cuda_kernel as ck

    say(nvidia_smi("name,power.limit"))
    say(f"build: {json.dumps(_build.build(('nsum2d.cu',)))}")
    say(f"accept: {json.dumps(acceptance_runs(np, ck, {}, repeats, verbose=False))}")
    return 0


# -- phase 12: the stepper tier and the spectral method -------------------------------------

RKC_STAGES = 8               # the CLIs' default rkc stage count
FFT_EPS = (8, 16, 40)        # the fft-against-nsum2d sweep at 4096^2, f32
EXPO_STEPS, EXPO_FRAC = 45, 0.25  # the JAX expo gate: 45 steps at 0.25x the Euler bound
STACK_STAGES, STACK_STEPS, STACK_DT = 4, 20, 6.0  # rkc[4], 20 steps, 6x each case's Euler dt
CLI_ROW_RKC = (50, 50, 5, 5, 1.0, 0.0045, 0.02)  # tests/test_cli.py's rkc row: 9x the dt


def run_batch_cli(main, argv, rows) -> str:
    """:func:`run_cli` of a batch CLI with ``rows`` on its stdin."""
    import io

    old = sys.stdin
    sys.stdin = io.StringIO(batch_text(rows))
    try:
        return run_cli(main, argv)
    finally:
        sys.stdin = old


def rkc_to_horizon(torch, np, ck, k3, by: dict, dim: int, l2_threshold) -> dict:
    """Phase 12 (a)/(b): the test-form solve of the headline (4096^2 eps=8, or
    256^3 eps=4), f32, to the horizon of STEPS Euler steps at 0.8x the Euler
    bound, with rkc[RKC_STAGES] in superstep_floor steps through
    nsum2d/nsum3d: the contract, exactly RKC_STAGES*steps + 1 launches, bitwise
    the same solve through the plain version on the card; then the Euler
    solve to the same horizon (counted), both walls, and both steppings timed
    alone with CUDA events in turns."""
    from nonlocalheatequation_torch.models.solver2d import Solver2D
    from nonlocalheatequation_torch.models.solver3d import Solver3D
    from nonlocalheatequation_torch.models.steppers import make_multi_step_fn, superstep_floor
    from nonlocalheatequation_torch.ops.constants import stable_dt_op
    from nonlocalheatequation_torch.ops.nonlocal_op import NonlocalOp2D, NonlocalOp3D

    n, eps = (NX, EPS) if dim == 2 else (N3, EPS3)
    cls, op_cls = (Solver2D, NonlocalOp2D) if dim == 2 else (Solver3D, NonlocalOp3D)
    kernel, mod = ("nsum2d", ck) if dim == 2 else ("nsum3d", k3)
    shape, dh, f32 = (n,) * dim, 1.0 / n, torch.float32
    probe = op_cls(eps, 1.0, 1.0, dh)
    dt_e = 0.8 * stable_dt_op(probe)
    horizon = STEPS * dt_e
    steps = superstep_floor(probe, horizon, "rkc", RKC_STAGES)

    def solver(nt, dt, **kw):
        s = cls(*shape, nt, eps, k=1.0, dt=dt, dh=dh, method="cuda", dtype=f32,
                device="cuda", **kw)
        s.test_init()
        return s

    name = f"{n}^{dim} eps={eps}"
    label = f"phase 12 {name} rkc[{RKC_STAGES}] {steps} steps"
    rkc = solver(steps, horizon / steps, stepper="rkc", stages=RKC_STAGES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u = launches_of(ck, by, label, rkc.do_work)
    rkc_wall = time.perf_counter() - t0
    want = {kernel: RKC_STAGES * steps + 1}
    if by[label] != want:
        fail(f"rkc {name}: launched {by[label]}, not {want} (a stage a launch, and L(G))")
    err = rkc.error_l2 / n**dim
    if not err <= l2_threshold:
        fail(f"rkc {name}: error_l2/#points {err:.3e} > {l2_threshold:g}")
    real = getattr(mod, kernel)
    setattr(mod, kernel, getattr(mod, f"{kernel}_plain"))
    try:
        plain = solver(steps, horizon / steps, stepper="rkc", stages=RKC_STAGES).do_work()
    finally:
        setattr(mod, kernel, real)
    if not np.array_equal(u, plain):
        rel = float(np.abs(u - plain).max() / np.abs(plain).max())
        fail(f"rkc {name}: not bitwise the same solve through {kernel}_plain (max rel "
             f"{rel:.3e}): the difference is in the stepper's code")
    eu = solver(STEPS, dt_e)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    launches_of(ck, by, f"phase 12 {name} Euler {STEPS} steps", eu.do_work)
    eu_wall = time.perf_counter() - t0
    eu_err = eu.error_l2 / n**dim
    # the steppings alone: the sources on the device, a state, CUDA events in turns
    op_r = op_cls(eps, 1.0, horizon / steps, dh, method="cuda")
    op_e = op_cls(eps, 1.0, dt_e, dh, method="cuda")
    g, lg = op_r.source_parts_on(*shape, "cuda")
    u0 = torch.as_tensor(rkc.u0, device="cuda").to(f32)
    runs = {"rkc": make_multi_step_fn(op_r, steps, g, lg, f32, stepper="rkc",
                                      stages=RKC_STAGES),
            "euler": make_multi_step_fn(op_e, STEPS, g, lg, f32)}
    ms = turns_of(torch, {k: (lambda f=f: f(u0, 0)) for k, f in runs.items()},
                  ("rkc", "euler", "euler", "rkc"), reps=2, warm=1)
    say(f"rkc {name} f32 test form to the horizon {horizon:.6e} of {STEPS} Euler steps at 0.8x "
        f"the bound: rkc[{RKC_STAGES}] {steps} steps ({RKC_STAGES * steps} applies) "
        f"error_l2/#points {err:.6e}, launches {json.dumps(by[label])}, bitwise the same solve "
        f"through {kernel}_plain, do_work wall {rkc_wall:.3f} s; Euler {STEPS} steps "
        f"error_l2/#points {eu_err:.6e}, launches "
        f"{json.dumps(by[f'phase 12 {name} Euler {STEPS} steps'])}, do_work wall "
        f"{eu_wall:.3f} s; the steppings alone, ms in turns (CUDA events): {json.dumps(ms)}")
    return {"steps": steps, "horizon": horizon, "ms": ms, "err": err, "euler_err": eu_err}


def phase_steppers(torch, np, ck, k3, l2_threshold) -> dict:
    """Phase 12: the stepper tier (rkc, expo) and the spectral method (fft)
    on the card; returns the launches by part."""
    import torch.nn.functional as F

    from nonlocalheatequation_torch.cli import solve1d, solve2d, solve3d
    from nonlocalheatequation_torch.models.solver2d import Solver2D
    from nonlocalheatequation_torch.models.steppers import make_multi_step_fn
    from nonlocalheatequation_torch.ops import spectral
    from nonlocalheatequation_torch.ops.constants import stable_dt_op
    from nonlocalheatequation_torch.ops.nonlocal_op import NonlocalOp2D, NonlocalOp3D
    from nonlocalheatequation_torch.serve.ensemble import EnsembleEngine
    from nonlocalheatequation_torch.utils import autotune

    by, walls, f32, f64 = {}, {}, torch.float32, torch.float64
    t_phase = time.perf_counter()
    # (a), (b): rkc to the headlines' horizons through nsum2d and nsum3d
    head = rkc_to_horizon(torch, np, ck, k3, by, 2, l2_threshold)
    rkc_to_horizon(torch, np, ck, k3, by, 3, l2_threshold)
    # where an rkc step's time goes, production form: 4096^2 and 512^2
    for n in (NX, SMALL):
        dh = 1.0 / n
        op = NonlocalOp2D(EPS, 1.0, 0.8 * stable_dt_op(NonlocalOp2D(EPS, 1.0, 1.0, dh), "rkc",
                                                       RKC_STAGES), dh, method="cuda")
        u = torch.from_numpy(np.random.default_rng(SEED + 41).standard_normal((n, n))).to(
            "cuda", f32)
        multi = make_multi_step_fn(op, 4, dtype=f32, stepper="rkc", stages=RKC_STAGES)
        say(f"rkc[{RKC_STAGES}] {n}^2 eps={EPS} f32 production, 4 steps under torch.profiler, "
            f"per step: {json.dumps(device_profile(torch, lambda: multi(u, 0), 4))}")
    walls["a, b"] = time.perf_counter() - t_phase

    # (c) fft against the stencil kernels, then the crossover over eps
    gen = np.random.default_rng(SEED + 42)
    errs = {}
    for dtype, tol in ((f64, TOL["float64"]), (f32, TOL["float32"])):
        for shape, eps, kernel in (((NX, NX), EPS, ck.nsum2d), ((N3S,) * 3, EPS3, k3.nsum3d)):
            u = torch.from_numpy(gen.standard_normal(shape)).to("cuda", dtype)
            cls = NonlocalOp2D if len(shape) == 2 else NonlocalOp3D
            op = cls(eps, 1.0, 1e-5, 1.0 / shape[0], method="fft")
            got = spectral.neighbor_sum_fft(op, u)
            want = kernel(F.pad(u, (eps,) * (2 * len(shape))), eps)
            rel = float((got - want).abs().max() / want.abs().max())
            errs[f"{shape[0]}^{len(shape)} eps={eps} {str(dtype)[6:]}"] = rel
            if got.device.type != "cuda" or not rel <= tol:
                fail(f"fft at {shape} eps={eps} {dtype}: max rel {rel:.3e} > {tol:g} against "
                     f"the kernel (or off the card: {got.device})")
    sweep, picks = {}, {}
    u = torch.from_numpy(gen.standard_normal((NX, NX))).to("cuda", f32)
    for eps in FFT_EPS:
        dh = 1.0 / NX
        op = NonlocalOp2D(eps, 1.0, 0.8 * stable_dt_op(NonlocalOp2D(eps, 1.0, 1.0, dh)), dh,
                          method="cuda")
        fop = op.with_method("fft")
        upad = F.pad(u, (eps,) * 4)
        sweep[eps] = turns_of(torch, {"fft": lambda: spectral.neighbor_sum_fft(fop, u),
                                      "nsum2d": lambda: ck.nsum2d(upad, eps)},
                              ("fft", "nsum2d", "nsum2d", "fft"), reps=10)
        picked = launches_of(ck, by, f"phase 12 pick_op_method {NX}^2 eps={eps}",
                             lambda: autotune.pick_op_method(op, (NX, NX), f32, "cuda"))
        rec = next(v for k, v in autotune.records().items()
                   if "method-ab" in k and f"/eps{eps}/" in k and f"/{NX}x{NX}/" in k)
        picks[eps] = {"picked": picked.method, "ms_per_step": rec["ms_per_step"]}
    wins = [e for e in FFT_EPS if min(sweep[e]["fft"]) < min(sweep[e]["nsum2d"])]
    say(f"fft against the kernels, max |fft - kernel| / max |kernel|: {json.dumps(errs)}; "
        f"{NX}^2 f32 neighbour sum, ms a call in turns (CUDA events) by eps: "
        f"{json.dumps(sweep)}; fft wins from eps "
        f"{wins[0] if wins else f'none up to {FFT_EPS[-1]}'}; pick_op_method (per-step "
        f"probes, ms/step) by eps: {json.dumps(picks)}")
    walls["c"] = time.perf_counter() - t_phase - sum(walls.values())

    # (d) expo: the JAX gate at full width, then one step to (a)'s horizon
    dh = 1.0 / NX
    dt_e = stable_dt_op(NonlocalOp2D(EPS, 1.0, 1.0, dh))
    expo = {}
    for stages in (0, 1):
        s = Solver2D(NX, NX, EXPO_STEPS, EPS, k=1.0, dt=EXPO_FRAC * dt_e, dh=dh, method="fft",
                     stepper="expo", stages=stages, dtype=f32, device="cuda")
        s.test_init()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        label = f"phase 12 {NX}^2 expo S={stages} {EXPO_STEPS} steps"
        u = launches_of(ck, by, label, s.do_work)
        wall = time.perf_counter() - t0
        err = s.error_l2 / NX**2
        peak, bound0 = float(np.abs(u).max()), float(np.abs(s.u0).max()) * 1.01
        if not (err <= l2_threshold and np.isfinite(u).all() and peak <= bound0):
            fail(f"expo S={stages} {NX}^2: error_l2/#points {err:.3e}, max|u| {peak:.6f} "
                 f"(bound {bound0:.6f}), finite {bool(np.isfinite(u).all())}")
        one = Solver2D(NX, NX, 1, EPS, k=1.0, dt=head["horizon"], dh=dh, method="fft",
                       stepper="expo", stages=stages, dtype=f32, device="cuda")
        one.test_init()
        one.do_work()
        expo[f"S={stages}"] = {"error_l2_per_n": err, "do_work_s": round(wall, 3),
                               "launches": by[label],
                               "one_step_to_horizon_error_l2_per_n": one.error_l2 / NX**2}
    say(f"expo {NX}^2 eps={EPS} f32 test form, {EXPO_STEPS} steps at {EXPO_FRAC}x the Euler "
        f"bound: {json.dumps(expo)} (the contract is {l2_threshold:g}; one step to the "
        f"horizon {head['horizon']:.6e} is printed, not gated)")
    walls["d"] = time.perf_counter() - t_phase - sum(walls.values())

    # (e) the CLIs on the card, float64
    cases_2d, cases_1d, _ = load_cases()
    gpu = ["--test_batch", "--platform", "gpu", "--x64", "1"]
    rows_1d = [r for r in cases_1d if r[1] <= 500]  # 1D rkc over fft: the shorter rows
    clis = (("solve2d --method fft", solve2d.main, ["--method", "fft"], cases_2d),
            ("solve2d --stepper rkc --superstep-stages 8", solve2d.main,
             ["--stepper", "rkc", "--superstep-stages", "8"], [CLI_ROW_RKC]),
            ("solve1d --method fft --stepper rkc", solve1d.main,
             ["--method", "fft", "--stepper", "rkc"], rows_1d),
            ("solve3d --method fft --stepper rkc --superstep-stages 4", solve3d.main,
             ["--method", "fft", "--stepper", "rkc", "--superstep-stages", "4"], CASES_3D[:1]))
    for name, main, argv, rows in clis:
        out = launches_of(ck, by, f"phase 12 {name}",
                          lambda m=main, a=argv, r=rows: run_batch_cli(m, gpu + a, r))
        if out.splitlines()[-1] != "Tests Passed":
            fail(f"{name} --test_batch on the card: {out[-2000:]}")
    import contextlib
    import io

    err_out = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err_out):
        rc = solve2d.main(["--test", "--platform", "gpu", "--stepper", "rkc",
                           "--superstep-stages", "2", "--dt", "0.1"])
    if rc != 2 or "exceeds the rkc[s=2] stability bound" not in err_out.getvalue():
        fail(f"solve2d --stepper rkc --superstep-stages 2 --dt 0.1: rc {rc}, not 2\n"
             f"{err_out.getvalue()}")
    say(f"CLIs on the card (f64): {', '.join(c[0] for c in clis)} each print Tests Passed "
        f"({len(cases_2d)}, 1, {len(rows_1d)} and 1 rows), launches "
        f"{json.dumps({c[0]: by[f'phase 12 {c[0]}'] for c in clis})}; solve2d --stepper rkc "
        "--superstep-stages 2 --dt 0.1 exits 2")
    walls["e"] = time.perf_counter() - t_phase - sum(walls.values())

    # (f) a stacked rkc bucket: 8 x 512^2 mixed physics, each lane bitwise its solo solve
    cases = ensemble_cases(
        np, ENS_MIXED_N,
        [(k, STACK_DT * euler_dt(h, k, f), h) for k, f, h in (
            (1.0, 0.8, 1 / 512), (0.5, 0.6, 1 / 512), (2.0, 0.7, 1 / 512), (1.0, 0.4, 1 / 640),
            (0.2, 0.8, 1 / 512), (1.0, 0.8, 1 / 400), (0.7, 0.5, 1 / 512), (1.5, 0.3, 1 / 560))],
        SEED + 43, STACK_STEPS)
    engine = EnsembleEngine(method="cuda", stepper="rkc", stages=STACK_STAGES, device="cuda",
                            dtype=f32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    label = f"phase 12 8x{ENS_MIXED_N}^2 stacked rkc[{STACK_STAGES}]"
    states = launches_of(ck, by, label, lambda: engine.run(cases))
    eng_wall = time.perf_counter() - t0
    want = {"nsum2d": len(cases) * STACK_STEPS * STACK_STAGES}
    strategy = engine.report.strategies[cases[0].bucket_key()]
    if by[label] != want or strategy != "stacked[rkc]":
        fail(f"the stacked rkc bucket ran {strategy!r} with {by[label]}, not stacked[rkc] "
             f"with {want}")
    for case, got in zip(cases, states, strict=True):
        s = Solver2D(ENS_MIXED_N, ENS_MIXED_N, case.nt, case.eps, k=case.k, dt=case.dt,
                     dh=case.dh, method="cuda", stepper="rkc", stages=STACK_STAGES, dtype=f32,
                     device="cuda")
        s.input_init(case.u0)
        if not np.array_equal(got, s.do_work()):
            fail(f"stacked rkc bucket: the lane of (k={case.k}, dt={case.dt:g}) is not bitwise "
                 "its solo stepper solve")
    say(f"stacked rkc[{STACK_STAGES}] bucket 8x{ENS_MIXED_N}^2 eps={EPS} f32 mixed physics "
        f"({STACK_STEPS} steps at {STACK_DT}x each case's Euler dt): {strategy}, launches "
        f"{json.dumps(by[label])}, run() wall {eng_wall:.3f} s, every lane bitwise its solo "
        "Solver2D stepper solve")
    walls["f"] = time.perf_counter() - t_phase - sum(walls.values())
    say(f"phase 12 part walls, s: {json.dumps({k: round(v, 1) for k, v in walls.items()})}")
    return by


# -- phase 13: the distributed stepper tier, the sharded spectral tier, the sharded
# -- unstructured operator ---------------------------------------------------------------

FFT_SMALL_2D, FFT_SMALL_3D = 512, 64  # the f64 sharded-fft holds (2x2, 2x2x2)
FFT_STEPS = 2                        # steps of each sharded fft solve
FFT_RUNS = (("euler", 0), ("rkc", RKC_STAGES), ("expo", 0), ("expo", 1))
USH_STEPS = 8                        # steps of each sharded unstructured solve
USH_DEVICES = 4                      # the 1D mesh of the sharded unstructured solves


def rkc_forms(torch, np, ck, by: dict, dim: int, l2_threshold) -> dict:
    """Phase 13 (a)/(b): the test-form headline (4096^2 eps=8 on 2x2 virtual
    devices of the card, or 256^3 eps=4 on 2x2x2), f32, to the horizon of
    STEPS Euler steps at 0.8x the Euler bound with rkc[RKC_STAGES] in
    superstep_floor steps: per stage 'collective' (nsum2d/nsum3d), 'fused'
    (the in-kernel exchange, fused_nsum2d/3d), 'fused' under
    NLHEAT_FUSED_TRANSPORT=interp (the split kernels), then stage batches of
    2 and 4 (collective), and the distributed Euler solves (STEPS steps,
    collective and fused).  Each do_work is counted (exactly blocks x stages
    x steps launches, plus L(G)) and holds the contract; the per-stage forms
    are the single-device rkc solve bitwise, the stage batches within the
    f32 tolerance of it (bitwise or not, printed).  Then the steppings alone
    (each form's runner from its device state, and the single-device rkc
    stepping), CUDA events, in turns."""
    from nonlocalheatequation_torch.models.solver2d import Solver2D
    from nonlocalheatequation_torch.models.solver3d import Solver3D
    from nonlocalheatequation_torch.models.steppers import make_multi_step_fn, superstep_floor
    from nonlocalheatequation_torch.ops.constants import stable_dt_op
    from nonlocalheatequation_torch.ops.nonlocal_op import NonlocalOp2D, NonlocalOp3D
    from nonlocalheatequation_torch.parallel.distributed2d import Solver2DDistributed
    from nonlocalheatequation_torch.parallel.distributed3d import Solver3DDistributed
    from nonlocalheatequation_torch.parallel.mesh import device_list, make_mesh, make_mesh_3d

    n, eps = (DN, DEPS) if dim == 2 else (D3N, D3EPS)
    shape, dh, f32 = (n,) * dim, 1.0 / n, torch.float32
    nblk = 2 ** dim
    probe = (NonlocalOp2D if dim == 2 else NonlocalOp3D)(eps, 1.0, 1.0, dh)
    dt_e = 0.8 * stable_dt_op(probe)
    horizon = STEPS * dt_e
    steps = superstep_floor(probe, horizon, "rkc", RKC_STAGES)
    dt_r = horizon / steps
    devs = device_list("cuda", nblk)

    def dist(nt, dt, comm="collective", **kw):
        if dim == 2:
            s = Solver2DDistributed(n // 2, n // 2, 2, 2, nt, eps, k=1.0, dt=dt, dh=dh,
                                    mesh=make_mesh(2, 2, devs), method="cuda", dtype=f32,
                                    comm=comm, **kw)
        else:
            s = Solver3DDistributed(n, n, n, nt, eps, k=1.0, dt=dt, dh=dh,
                                    mesh=make_mesh_3d(2, 2, 2, devs), method="cuda",
                                    dtype=f32, comm=comm, **kw)
        s.test_init()
        return s

    name = f"{n}^{dim} eps={eps} on {'x'.join(['2'] * dim)}"
    solo_cls = Solver2D if dim == 2 else Solver3D
    solo = solo_cls(*shape, steps, eps, k=1.0, dt=dt_r, dh=dh, method="cuda", dtype=f32,
                    device="cuda", stepper="rkc", stages=RKC_STAGES)
    solo.test_init()
    ref = launches_of(ck, by, f"phase 13 {name} single-device rkc[{RKC_STAGES}]",
                      solo.do_work)
    rkc = dict(stepper="rkc", stages=RKC_STAGES)
    forms = {"collective": (lambda: dist(steps, dt_r, **rkc), ""),
             "fused": (lambda: dist(steps, dt_r, comm="fused", **rkc), ""),
             "fused interp": (lambda: dist(steps, dt_r, comm="fused", **rkc), "interp"),
             "stage batches K=2": (lambda: dist(steps, dt_r, superstep=2, **rkc), ""),
             "stage batches K=4": (lambda: dist(steps, dt_r, superstep=4, **rkc), ""),
             f"Euler {STEPS} steps collective": (lambda: dist(STEPS, dt_e), ""),
             f"Euler {STEPS} steps fused": (lambda: dist(STEPS, dt_e, comm="fused"), "")}
    applies = nblk * RKC_STAGES * steps
    kernel = f"nsum{dim}d"
    want = {"collective": {kernel: applies + 1},
            "fused": {f"fused_nsum{dim}d": applies, kernel: 1},
            "fused interp": {f"split_nsum{dim}d": split_launches(
                shape, (2,) * dim, eps, RKC_STAGES * steps), kernel: 1},
            "stage batches K=2": {kernel: applies + 1},
            "stage batches K=4": {kernel: applies + 1},
            f"Euler {STEPS} steps collective": {kernel: nblk * STEPS + 1},
            f"Euler {STEPS} steps fused": {f"fused_nsum{dim}d": nblk * STEPS, kernel: 1}}
    errs, walls, held, runs = {}, {}, {}, {}
    for form, (make, transport) in forms.items():
        os.environ["NLHEAT_FUSED_TRANSPORT"] = transport
        s = make()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        label = f"phase 13 {name} {form}"
        u = launches_of(ck, by, label, s.do_work)
        walls[form] = round(time.perf_counter() - t0, 4)
        if by[label] != want[form]:
            fail(f"{name} {form}: launched {by[label]}, not {want[form]}")
        # the stepping alone: the runner from the solver's device state
        blocks, srcs = s._device_state()
        if srcs and s.ksteps > 1:
            srcs = s._prep_sources(*srcs)
        run = s._make_runner(s.nt)
        runs[form] = (lambda run=run, b=blocks, sr=srcs: run(b, 0, sr), transport)
        os.environ.pop("NLHEAT_FUSED_TRANSPORT")
        err = s.error_l2 / n**dim
        errs[form] = err
        if not (err <= l2_threshold and np.isfinite(u).all()):
            fail(f"{name} {form}: error_l2/#points {err:.3e} > {l2_threshold:g} (or not finite)")
        if form.startswith("Euler"):
            continue
        rel = float(np.abs(u - ref).max() / np.abs(ref).max())
        bitwise = bool(np.array_equal(u, ref))
        held[form] = {"bitwise": bitwise, "max_rel": rel}
        if form.startswith("stage") and not rel <= TOL["float32"]:
            fail(f"{name} {form}: {rel:.3e} from the single-device rkc solve > 1e-5")
        if not form.startswith("stage") and not bitwise:
            fail(f"{name} {form}: per-stage distributed rkc is not the single-device rkc "
                 f"solve bitwise (max rel {rel:.3e})")
    g, lg = solo.op.source_parts_on(*shape, "cuda")
    u0 = torch.as_tensor(solo.u0, device="cuda").to(f32)
    multi = make_multi_step_fn(solo.op, steps, g, lg, f32, stepper="rkc", stages=RKC_STAGES)
    runs[f"single-device rkc[{RKC_STAGES}]"] = (lambda: multi(u0, 0), "")
    ms = {k: [] for k in runs}
    for form in list(runs) + list(runs)[::-1]:  # in turns: a, b, ..., b, a
        fn, transport = runs[form]
        os.environ["NLHEAT_FUSED_TRANSPORT"] = transport
        ms[form].append(cuda_ms(torch, fn, 1, 1))
        os.environ.pop("NLHEAT_FUSED_TRANSPORT")
    say(f"phase 13 distributed rkc[{RKC_STAGES}] {name} f32 test form to the horizon "
        f"{horizon:.6e} of {STEPS} Euler steps at 0.8x the bound, {steps} steps: against the "
        f"single-device rkc solve {json.dumps(held)}; error_l2/#points {json.dumps(errs)}; "
        f"launches {json.dumps({f: by[f'phase 13 {name} {f}'] for f in forms})}; do_work "
        f"walls (set-up included), s: {json.dumps(walls)}; the steppings to the horizon "
        f"alone, ms, in turns (CUDA events): {json.dumps(ms)}")
    del runs
    return {"steps": steps, "ms": ms, "held": held}


def sharded_fft(torch, np, ck, by: dict) -> dict:
    """Phase 13 (c): the sharded spectral tier against the single-device fft
    solve: euler, rkc[RKC_STAGES] and expo at S=0 and S=1, test form,
    FFT_STEPS steps, on 2x2 (2D) and 2x2x2 (3D) virtual devices of the card:
    float64 at 512^2 and 64^3 within 1e-12 of the largest magnitude; float32
    at 4096^2 and 256^3 within 1e-5 of the single-device float32 solve, or,
    where the two float32 solves' rounding differs by more (rkc's stage
    recurrence amplifies it), within twice the single-device float32 solve's
    distance from the single-device float64 one; counted (no kernel
    launches: the transforms are cuFFT's); the f32 euler and rkc ms/step,
    sharded against single-device, CUDA events, in turns."""
    from nonlocalheatequation_torch.models.solver2d import Solver2D
    from nonlocalheatequation_torch.models.solver3d import Solver3D
    from nonlocalheatequation_torch.models.steppers import make_multi_step_fn
    from nonlocalheatequation_torch.ops.constants import stable_dt_op
    from nonlocalheatequation_torch.ops.nonlocal_op import NonlocalOp2D, NonlocalOp3D
    from nonlocalheatequation_torch.parallel.distributed2d import Solver2DDistributed
    from nonlocalheatequation_torch.parallel.distributed3d import Solver3DDistributed
    from nonlocalheatequation_torch.parallel.mesh import device_list, make_mesh, make_mesh_3d

    out = {}
    for dim, n, eps, dtype in ((2, FFT_SMALL_2D, DEPS, torch.float64),
                               (3, FFT_SMALL_3D, D3EPS, torch.float64),
                               (2, DN, DEPS, torch.float32), (3, D3N, D3EPS, torch.float32)):
        dh = 1.0 / n
        op_cls = NonlocalOp2D if dim == 2 else NonlocalOp3D
        devs = device_list("cuda", 2 ** dim)
        f32 = dtype == torch.float32
        tol = TOL["float32"] if f32 else TOL["float64"]
        for stepper, stages in FFT_RUNS:
            dt = (0.8 * stable_dt_op(op_cls(eps, 1.0, 1.0, dh), stepper, stages)
                  if stepper != "expo" else 4 * stable_dt_op(op_cls(eps, 1.0, 1.0, dh)))
            kw = dict(k=1.0, dt=dt, dh=dh, method="fft", stepper=stepper, stages=stages)

            def single(dt_):
                s_ = (Solver2D(n, n, FFT_STEPS, eps, device="cuda", dtype=dt_, **kw)
                      if dim == 2 else
                      Solver3D(n, n, n, FFT_STEPS, eps, device="cuda", dtype=dt_, **kw))
                s_.test_init()
                return s_

            if dim == 2:
                d = Solver2DDistributed(n // 2, n // 2, 2, 2, FFT_STEPS, eps, dtype=dtype,
                                        mesh=make_mesh(2, 2, devs), **kw)
            else:
                d = Solver3DDistributed(n, n, n, FFT_STEPS, eps, dtype=dtype,
                                        mesh=make_mesh_3d(2, 2, 2, devs), **kw)
            d.test_init()
            s = single(dtype)
            key = f"{n}^{dim} {str(dtype)[6:]} {stepper}" + (f" S={stages}" if stepper ==
                                                              "expo" else "")
            label = f"phase 13 sharded fft {key}"
            ud = launches_of(ck, by, label, d.do_work)
            us = s.do_work()
            scale = np.abs(us).max()
            rel = float(np.abs(ud - us).max() / scale)
            row = {"max_rel": rel, "error_l2_per_n": d.error_l2 / n**dim}
            ok = rel <= tol
            if f32 and not ok:
                u64 = single(torch.float64).do_work()
                row["sharded_f32_vs_f64"] = float(np.abs(ud - u64).max() / scale)
                row["single_f32_vs_f64"] = float(np.abs(us - u64).max() / scale)
                ok = ok or row["sharded_f32_vs_f64"] <= 2 * row["single_f32_vs_f64"]
            if by[label] or not (ok and np.isfinite(ud).all()):
                fail(f"sharded fft {key}: {json.dumps(row)} against the single-device fft "
                     f"solve (tolerance {tol:g}; launched {by[label]})")
            if f32 and stepper != "expo":
                blocks, srcs = d._device_state()
                srcs = d._spectral_args() + srcs
                run = d._make_runner(FFT_STEPS)
                u_dev = torch.as_tensor(s.u0, device="cuda").to(dtype)
                g, lg = s.op.source_parts_on(*s._grid_shape, "cuda")
                multi = make_multi_step_fn(s.op, FFT_STEPS, g, lg, dtype, stepper=stepper,
                                           stages=stages)
                ms = turns_of(torch, {"sharded": lambda: run(blocks, 0, srcs),
                                      "single": lambda: multi(u_dev, 0)},
                              ("sharded", "single", "single", "sharded"), reps=1, warm=1)
                row["ms_per_step"] = {k: [v / FFT_STEPS for v in vs] for k, vs in ms.items()}
                del blocks, srcs, g, lg, u_dev
            out[key] = row
            del d, s
    say(f"phase 13 sharded fft against the single-device fft solve (test form, {FFT_STEPS} "
        f"steps; euler and rkc at 0.8x their bound, expo at 4x the Euler bound): "
        f"{json.dumps(out)}")
    return out


def sharded_unstructured(torch, np, ck, by: dict) -> dict:
    """Phase 13 (d): ShardedUnstructuredOp on USH_DEVICES virtual devices of
    the card, f32, test form, USH_STEPS steps at 0.8x the Euler bound: the
    shuffled 512^2 cloud of phase 7 in gang_order with the export and the
    gather halo (bitwise each other and the same op on one device, the
    order-fixed padded-row sum; within 1e-5 of the single-device ell solve);
    the same cloud in its lattice order in the offsets form and its
    superstep at K=2 and 4 (bitwise the single-device offsets solve); the
    graded mesh of phase 7 in gang_order, auto.  Counted (no kernel: the
    sharded forms are torch ops); the comm ratio and ms/step (the do_work
    wall of a first, counted call and of a second, warm one, beside the
    single-device solve's warm one) printed."""
    from nonlocalheatequation_torch.ops.unstructured import (
        ShardedUnstructuredOp,
        UnstructuredNonlocalOp,
        UnstructuredSolver,
    )
    from nonlocalheatequation_torch.parallel.mesh import device_list
    from nonlocalheatequation_torch.serve.meshes import gang_order

    f32 = torch.float32
    devs, one = device_list("cuda", USH_DEVICES), device_list("cuda", 1)
    shuffled, h = jittered_cloud(np, UN_M, 2, SEED + 9, shuffle=True)
    lattice, _ = jittered_cloud(np, UN_M, 2, SEED + 9)  # the same points, unshuffled
    mpts, meps, mvol = graded_cloud(np, MESH_NM)
    t0 = time.perf_counter()
    perm_s, perm_m = gang_order(shuffled, USH_DEVICES), gang_order(mpts, USH_DEVICES)
    order_wall = time.perf_counter() - t0
    clouds = {"shuffled 512^2 cloud, gang order": (shuffled[perm_s], 3 * h, h * h),
              "512^2 cloud, lattice order": (lattice, 3 * h, h * h),
              "graded mesh nm=256, gang order": (mpts[perm_m], meps[perm_m], mvol[perm_m])}
    ops = {}
    for key, (pts, eps, vol) in clouds.items():
        op = UnstructuredNonlocalOp(pts, eps, k=1.0, dt=1.0, vol=vol, device="cuda")
        op.dt = 0.8 / float(np.max(op.c * op.wsum))
        ops[key] = op
    gang, lat, graded = ops.values()
    runs = {  # name: (op, sharded kwargs, superstep, single-device layout, bitwise to it)
        "export": (gang, dict(halo="export"), 1, "ell", False),
        "gather": (gang, dict(halo="gather"), 1, "ell", False),
        "offsets": (lat, dict(layout="offsets"), 1, "offsets", True),
        "superstep K=2": (lat, dict(layout="offsets"), 2, "offsets", True),
        "superstep K=4": (lat, dict(layout="offsets"), 4, "offsets", True),
        "graded auto": (graded, {}, 1, "ell", False),
    }
    singles, out, results = {}, {}, {}
    for name, (op, kw, K, layout, exact) in runs.items():
        sh = ShardedUnstructuredOp(op, devices=devs, **kw)
        s = UnstructuredSolver(sh, nt=USH_STEPS, superstep=K, dtype=f32)
        s.test_init()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        label = f"phase 13 sharded unstructured {name}"
        u = launches_of(ck, by, label, s.do_work)
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        s.do_work()  # warm: the blocks' tables are on the card
        warm = time.perf_counter() - t0
        results[name] = u
        skey = (id(op), layout)
        if skey not in singles:
            ref = UnstructuredSolver(op, nt=USH_STEPS, layout=layout, dtype=f32)
            ref.test_init()
            ref.do_work()
            t0 = time.perf_counter()
            singles[skey] = (ref.do_work(), (time.perf_counter() - t0) * 1e3 / USH_STEPS)
        ref, ref_ms = singles[skey]
        rel = float(np.abs(u - ref).max() / np.abs(ref).max())
        bitwise = bool(np.array_equal(u, ref))
        if by[label] or not np.isfinite(u).all() or (exact and not bitwise) or \
                not rel <= TOL["float32"]:
            fail(f"sharded unstructured {name}: {rel:.3e} from the single-device {layout} "
                 f"solve (bitwise required: {exact}, got {bitwise}; launched {by[label]})")
        out[name] = {"n": op.n, "layout": sh.layout, "halo": sh.halo_mode,
                     "comm_ratio": sh.halo_comm_ratio,
                     "ms_per_step": {"warm": warm * 1e3 / USH_STEPS,
                                     "cold (set-up included)": cold * 1e3 / USH_STEPS,
                                     f"single-device {layout} warm": ref_ms},
                     f"vs single-device {layout}": {"bitwise": bitwise, "max_rel": rel},
                     "error_l2_per_n": s.error_l2 / op.n}
    # the padded-row sums' order does not depend on the shard count: export and
    # gather bitwise each other and the same operator on one device
    one_sh = UnstructuredSolver(ShardedUnstructuredOp(gang, devices=one), nt=USH_STEPS,
                                dtype=f32)
    one_sh.test_init()
    u1 = one_sh.do_work()
    for name in ("export", "gather"):
        if not np.array_equal(results[name], u1):
            fail(f"sharded unstructured {name}: not bitwise the one-device sharded solve")
    say(f"phase 13 sharded unstructured, {USH_DEVICES} virtual devices, f32 test form, "
        f"{USH_STEPS} steps (gang_order {order_wall:.3f} s for two clouds): export and gather "
        f"bitwise each other and the one-device sharded solve; {json.dumps(out)}")
    return out


def phase_dist_steppers(torch, np, ck, k3, l2_threshold) -> dict:
    """Phase 13: the distributed stepper tier (rkc over the halo transports),
    the sharded spectral tier and the sharded unstructured operator with its
    superstep, on virtual devices of the card; returns the launches by part."""
    import contextlib
    import io

    from nonlocalheatequation_torch.cli import solve2d_distributed, solve3d, solve_unstructured
    from nonlocalheatequation_torch.parallel.distributed2d import choose_mesh_shape

    by, walls = {}, {}
    t_phase = time.perf_counter()
    rkc_forms(torch, np, ck, by, 2, l2_threshold)
    walls["a"] = time.perf_counter() - t_phase
    rkc_forms(torch, np, ck, by, 3, l2_threshold)
    walls["b"] = time.perf_counter() - t_phase - sum(walls.values())
    sharded_fft(torch, np, ck, by)
    walls["c"] = time.perf_counter() - t_phase - sum(walls.values())
    sharded_unstructured(torch, np, ck, by)
    walls["d"] = time.perf_counter() - t_phase - sum(walls.values())

    # (e) the CLIs on the card, float64
    gpu = ["--test_batch", "--platform", "gpu", "--x64", "1"]
    cases = cases_module().CASES_2D_DISTRIBUTED
    label = "phase 13 solve2d_distributed --stepper rkc CASES_2D_DISTRIBUTED"
    out = launches_of(ck, by, label, lambda: run_batch_cli(
        solve2d_distributed.main, gpu + ["--devices", "8", "--stepper", "rkc"], cases))
    want = {"nsum2d": sum(nt * RKC_STAGES * int(np.prod(choose_mesh_shape(nx * px, ny * py, 8)))
                          + 1 for nx, ny, px, py, nt, *_ in cases)}
    if out.splitlines()[-1] != "Tests Passed" or by[label] != want:
        fail(f"solve2d_distributed --stepper rkc over CASES_2D_DISTRIBUTED: launches "
             f"{by[label]} (want {want})\n{out[-2000:]}")
    label3 = "phase 13 solve3d --distributed --method fft --stepper expo CASES_3D"
    out = launches_of(ck, by, label3, lambda: run_batch_cli(
        solve3d.main, gpu + ["--distributed", "--method", "fft", "--stepper", "expo",
                             "--superstep-stages", "1"], CASES_3D))
    if out.splitlines()[-1] != "Tests Passed" or by[label3]:
        fail(f"solve3d --distributed --method fft --stepper expo: launches {by[label3]}\n"
             f"{out[-2000:]}")
    argv = ["--mesh", "data/50x50.msh", "--test", "--platform", "gpu", "--x64", "1",
            "--devices", "4", "--superstep", "2", "--gang-order", "false", "--nt", "30"]
    labelu = "phase 13 solve_unstructured --devices 4 --superstep 2"
    text = launches_of(ck, by, labelu, lambda: run_cli_unstructured(argv))
    uerr = cli_error(text, "solve_unstructured --devices 4 --superstep 2", l2_threshold)
    shard_line = next((x for x in text.splitlines() if x.startswith("sharded over")), "")
    if "offsets-ppermute" not in shard_line or by[labelu]:
        fail(f"solve_unstructured --devices 4 --superstep 2: {shard_line!r}, launches "
             f"{by[labelu]}")
    err_out = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err_out):
        rc = solve2d_distributed.main(["--test", "true", "--platform", "gpu", "--nx", "12",
                                       "--ny", "12", "--nt", "3", "--eps", "2", "--dt", "0.05",
                                       "--stepper", "rkc", "--superstep-stages", "4"])
    if rc != 2 or "rkc[s=4] stability bound" not in err_out.getvalue():
        fail(f"solve2d_distributed past the rkc bound: rc {rc}, not 2\n{err_out.getvalue()}")
    say(f"phase 13 CLIs on the card (f64): solve2d_distributed --devices 8 --stepper rkc over "
        f"CASES_2D_DISTRIBUTED Tests Passed, launches {json.dumps(by[label])}; solve3d "
        "--distributed --method fft --stepper expo --superstep-stages 1 over CASES_3D Tests "
        f"Passed (no kernel); solve_unstructured --mesh data/50x50.msh --devices 4 --superstep "
        f"2 --gang-order false: {shard_line}, error_l2/N {uerr:.3e}; solve2d_distributed "
        "--stepper rkc --superstep-stages 4 --dt 0.05 exits 2")
    walls["e"] = time.perf_counter() - t_phase - sum(walls.values())
    say(f"phase 13 part walls, s: {json.dumps({k: round(v, 1) for k, v in walls.items()})}")
    return by


MH_STEPS, MH_RKC_STEPS = 50, 10  # phase 14: Euler steps, rkc[8] steps (each at 5x the dt)
MH_TIMEOUT = 420                 # seconds a phase-14 rank may run before it is killed
MH_FORMS = [(dim, comm, stepper) for dim in (2, 3) for comm in ("collective", "fused")
            for stepper in ("euler", "rkc")]


def mh_label(dim: int, comm: str, stepper: str) -> str:
    shape = f"{DN}^2 eps={DEPS} 2x2" if dim == 2 else f"{D3N}^3 eps={D3EPS} 2x2x2"
    steps = f"euler {MH_STEPS}" if stepper == "euler" else f"rkc[{RKC_STAGES}] {MH_RKC_STEPS}"
    return f"{shape} {comm} {steps}"


def mh_solver(dim: int, comm: str, stepper: str, devs):
    """Phase 14's solves, f32 test form, method="cuda": 4096^2 eps=8 on a 2x2
    mesh or 256^3 eps=4 on 2x2x2 over ``devs``, MH_STEPS Euler steps at 0.8x
    the Euler bound or MH_RKC_STEPS rkc[8] steps at 5x that dt."""
    import torch

    from nonlocalheatequation_torch.ops.constants import stable_dt_op
    from nonlocalheatequation_torch.ops.nonlocal_op import NonlocalOp2D, NonlocalOp3D
    from nonlocalheatequation_torch.parallel.distributed2d import Solver2DDistributed
    from nonlocalheatequation_torch.parallel.distributed3d import Solver3DDistributed
    from nonlocalheatequation_torch.parallel.mesh import make_mesh, make_mesh_3d

    n, eps = (DN, DEPS) if dim == 2 else (D3N, D3EPS)
    dh = 1.0 / n
    dt = 0.8 * stable_dt_op((NonlocalOp2D if dim == 2 else NonlocalOp3D)(eps, 1.0, 1.0, dh))
    kw = dict(k=1.0, dh=dh, method="cuda", dtype=torch.float32, comm=comm)
    if stepper == "euler":
        nt = MH_STEPS
    else:
        nt, dt = MH_RKC_STEPS, 5 * dt
        kw.update(stepper="rkc", stages=RKC_STAGES)
    if dim == 2:
        s = Solver2DDistributed(n // 2, n // 2, 2, 2, nt, eps, dt=dt,
                                mesh=make_mesh(2, 2, devs), **kw)
    else:
        s = Solver3DDistributed(n, n, n, nt, eps, dt=dt, mesh=make_mesh_3d(2, 2, 2, devs), **kw)
    s.test_init()
    return s


def mh_want(dim: int, comm: str, stepper: str, nblocks: int, transport: str) -> dict:
    """The launches of one phase-14 do_work over ``nblocks`` blocks of this
    process: one sum a block an apply (split: a launch a phase, two here),
    and L(G) once."""
    applies = nblocks * (MH_STEPS if stepper == "euler" else RKC_STAGES * MH_RKC_STEPS)
    kernel = f"nsum{dim}d"
    if comm == "collective":
        return {kernel: applies + 1}
    if transport == "peer":
        return {f"fused_nsum{dim}d": applies, kernel: 1}
    return {f"split_nsum{dim}d": 2 * applies, kernel: 1}


def mh_run(torch, np, ck, s, barrier=None) -> dict:
    """One phase-14 solve: its do_work counted, the state's digest and the
    contract, then the stepping alone (the runner from the device state;
    ``barrier`` first, so that the ranks start together), wall ms a step."""
    import hashlib

    before = ck.launch_counts()
    u = s.do_work()
    launches = {k: v - before[k] for k, v in ck.launch_counts().items() if v != before[k]}
    blocks, srcs = s._device_state()
    run = s._make_runner(s.nt)
    torch.cuda.synchronize()
    if barrier is not None:
        barrier()
    t0 = time.perf_counter()
    run(blocks, 0, srcs)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / s.nt
    return {"u": u, "digest": hashlib.sha256(u.tobytes()).hexdigest()[:16],
            "err": float(s.error_l2 / u.size), "finite": bool(np.isfinite(u).all()),
            "launches": launches, "ms_per_step": round(ms, 4)}


def mh_rank_main(init: str, world: int, rank: int) -> int:
    """One rank of phase 14 (b): ``chip_smoke.py --mh-rank INIT WORLD RANK``.
    Joins the gloo group (bands staged through host memory; the ranks share
    the one card), owns 2 of the 2x2 mesh's blocks (4 of the 2x2x2 mesh's),
    runs MH_FORMS and prints one JSON line of digests, launches and walls."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from nonlocalheatequation_torch.ops import cuda_kernel as ck
    from nonlocalheatequation_torch.parallel import multihost
    from nonlocalheatequation_torch.parallel.mesh import device_list

    multihost.init_from_env(init, world, rank, backend="gloo", platform="gpu",
                            timeout=MH_TIMEOUT)
    import torch.distributed as dist

    devs = {2: device_list("cuda", 4 // world), 3: device_list("cuda", 8 // world)}
    out = {}
    for dim, comm, stepper in MH_FORMS:
        label = mh_label(dim, comm, stepper)
        r = mh_run(torch, np, ck, mh_solver(dim, comm, stepper, devs[dim]), dist.barrier)
        multihost.assert_same_on_all_hosts(r.pop("u"), label)
        out[label] = r
    print("MH14 " + json.dumps({"rank": rank, "results": out}), flush=True)
    multihost.shutdown()
    return 0


def phase_multihost(torch, np, ck, l2_threshold) -> dict:
    """Phase 14: blocks owned by ranks (parallel/multihost.py) on the one card.
    (a) MH_FORMS in this process with no group, then around a 1-rank nccl
    group (bitwise, the same launches); (b) two ranks, spawned here, in a
    gloo group, each owning half of the blocks: every form bitwise the
    no-group solve, B2/B9 (collective) and B14/B15 (fused: a mesh across
    ranks takes 'interp') launched exactly in each rank; (c)
    solve2d_distributed --devices 2 on two ranks over CASES_2D_DISTRIBUTED:
    "Tests Passed" from rank 0, nothing from rank 1.  Returns the launches
    by part."""
    import socket

    from nonlocalheatequation_torch.ops.cuda_halo import fused_transport
    from nonlocalheatequation_torch.parallel import multihost
    from nonlocalheatequation_torch.parallel.mesh import device_list

    def free_port() -> int:
        with socket.socket() as sk:
            sk.bind(("localhost", 0))
            return sk.getsockname()[1]

    by, walls = {}, {}
    t_phase = time.perf_counter()
    # (a) no group, then one nccl rank
    devs = {2: device_list("cuda", 4), 3: device_list("cuda", 8)}
    transport = fused_transport(devs[2])
    ref, grouped = {}, {}
    for dim, comm, stepper in MH_FORMS:
        label = mh_label(dim, comm, stepper)
        r = mh_run(torch, np, ck, mh_solver(dim, comm, stepper, devs[dim]))
        del r["u"]
        ref[label] = r
        by[f"phase 14 (a) no group {label}"] = r["launches"]
        want = mh_want(dim, comm, stepper, 2 ** dim, transport)
        if r["launches"] != want or not r["finite"] or not r["err"] <= l2_threshold:
            fail(f"phase 14 {label}: launches {r['launches']} (want {want}), error_l2/#points "
                 f"{r['err']:.3e}")
    multihost.init_from_env(f"tcp://localhost:{free_port()}", 1, 0, backend="nccl",
                            platform="gpu", timeout=MH_TIMEOUT)
    try:
        import torch.distributed as dist

        if (multihost.backend(), multihost.process_count()) != ("nccl", 1):
            fail(f"phase 14: the group is {multihost.backend()} x{multihost.process_count()}")
        dist.barrier()
        gdevs = {2: device_list("cuda", 4), 3: device_list("cuda", 8)}
        for dim, comm, stepper in MH_FORMS:
            label = mh_label(dim, comm, stepper)
            r = mh_run(torch, np, ck, mh_solver(dim, comm, stepper, gdevs[dim]), dist.barrier)
            del r["u"]
            grouped[label] = r
            by[f"phase 14 (a) 1-rank nccl {label}"] = r["launches"]
            if (r["digest"], r["launches"]) != (ref[label]["digest"], ref[label]["launches"]):
                fail(f"phase 14 (a) {label} in a 1-rank nccl group: digest {r['digest']}, "
                     f"launches {r['launches']}; with no group {ref[label]['digest']}, "
                     f"{ref[label]['launches']}")
    finally:
        multihost.shutdown()
    walls["a"] = time.perf_counter() - t_phase
    say("phase 14 (a) no group: "
        + json.dumps({k: {key: v[key] for key in ("digest", "err", "ms_per_step", "launches")}
                      for k, v in ref.items()})
        + "; in a 1-rank nccl group, bitwise with the same launches, ms a step "
        + json.dumps({k: v["ms_per_step"] for k, v in grouped.items()}))
    torch.cuda.empty_cache()  # the ranks below share the card

    # (b) two ranks in a gloo group on the one card
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{tmp}/pg"
        procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--mh-rank",
                                   init, "2", str(r)], cwd=ROOT, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True) for r in range(2)]
        CHILDREN.extend(procs)
        results = []
        deadline = time.monotonic() + MH_TIMEOUT
        for r, proc in enumerate(procs):
            try:
                out, err = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                stop_children()
                fail(f"phase 14 (b): rank {r} still running after {MH_TIMEOUT} s; killed")
            if proc.returncode != 0:
                stop_children()
                fail(f"phase 14 (b): rank {r} exited {proc.returncode}\n{out[-2000:]}\n"
                     f"{err[-4000:]}")
            line = next((x for x in out.splitlines() if x.startswith("MH14 ")), None)
            if line is None:
                fail(f"phase 14 (b): rank {r} printed no result\n{out[-2000:]}")
            results.append(json.loads(line[5:])["results"])
    rank_ms = {}
    for r, res in enumerate(results):
        for dim, comm, stepper in MH_FORMS:
            label = mh_label(dim, comm, stepper)
            got = res[label]
            by[f"phase 14 (b) rank {r} {label}"] = got["launches"]
            want = mh_want(dim, comm, stepper, 2 ** dim // 2, "interp")
            if got["digest"] != ref[label]["digest"] or got["launches"] != want:
                fail(f"phase 14 (b) rank {r} {label}: digest {got['digest']} (one process "
                     f"{ref[label]['digest']}), launches {got['launches']} (want {want})")
            rank_ms.setdefault(label, []).append(got["ms_per_step"])
    walls["b"] = time.perf_counter() - t_phase - sum(walls.values())
    say(f"phase 14 (b) two gloo ranks on the one card, 2+2 (2D) and 4+4 (3D) virtual devices: "
        f"every form bitwise the one-process solve; ms a step, the stepping alone, [rank 0, "
        f"rank 1] beside one process: "
        + json.dumps({k: {"ranks": v, "one process": ref[k]["ms_per_step"]}
                      for k, v in rank_ms.items()})
        + "; launches of each rank: "
        + json.dumps({mh_label(*f): results[0][mh_label(*f)]["launches"] for f in MH_FORMS}))

    # (c) the distributed CLI under two ranks
    cases = cases_module().CASES_2D_DISTRIBUTED
    port = free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, COORDINATOR_ADDRESS=f"localhost:{port}", JAX_NUM_PROCESSES="2",
                   JAX_PROCESS_ID=str(r), NLHEAT_DIST_BACKEND="gloo",
                   NLHEAT_DIST_TIMEOUT=str(MH_TIMEOUT),
                   PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "nonlocalheatequation_torch.cli.solve2d_distributed",
             *CLI_ARGS, "--devices", "2"], cwd=ROOT, env=env, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for proc in procs:  # every rank's stdin closed at once: no rank waits on another's read
        proc.stdin.write(batch_text(cases))
        proc.stdin.close()
        proc.stdin = None
    CHILDREN.extend(procs)
    outs = []
    deadline = time.monotonic() + MH_TIMEOUT
    for r, proc in enumerate(procs):
        try:
            out, err = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            stop_children()
            fail(f"phase 14 (c): CLI rank {r} still running after {MH_TIMEOUT} s; killed")
        if proc.returncode != 0:
            stop_children()
            fail(f"phase 14 (c): CLI rank {r} exited {proc.returncode}\n{out[-2000:]}\n"
                 f"{err[-4000:]}")
        outs.append(out)
    noise = [x for x in outs[1].splitlines() if x.strip() and not x.startswith("[Gloo]")]
    if outs[0].splitlines()[-1:] != ["Tests Passed"] or noise:
        fail(f"phase 14 (c): rank 0 ended {outs[0].splitlines()[-1:]}, rank 1 printed "
             f"{noise[:5]}")
    walls["c"] = time.perf_counter() - t_phase - sum(walls.values())
    say(f"phase 14 (c) solve2d_distributed --test_batch --devices 2 on two gloo ranks over "
        f"CASES_2D_DISTRIBUTED ({len(cases)} rows, f64): rank 0 Tests Passed, rank 1 silent")
    say(f"phase 14 part walls, s: {json.dumps({k: round(v, 1) for k, v in walls.items()})}")
    return by


# -- phase 15: the serving pipeline -------------------------------------------------

SERVE_CASES, SERVE_N, SERVE_STEPS = 16, ENS_N, 200  # (a) ensemble8x1024, two chunks of 8
SERVE_PHYSICS = ((1.0, 0.8), (0.5, 0.6))  # (k, fraction of the Euler bound), case i: i % 2
CHAOS_CASES, CHAOS_N, CHAOS_STEPS = 12, 256, 20  # (b) the f64 supervision stream
CHAOS_PLAN = "raise@1,stall@3,nan@c6x*"  # (b) one fault of each kind, case 6 poison
BREAKER_PLAN = "raise@0x2"  # (b) two failed attempts open a threshold-2 breaker
SPIN_MS = 500  # the spin queued behind the first chunk of the fence probe
MESH_SERVE_STEPS = 20  # (d) steps of each mesh case


def spin_cycles(torch, ms: float) -> int:
    """Cycles of ``torch.cuda._sleep`` that keep the card busy about ``ms``."""
    cycles = 10 ** 7
    for _ in range(3):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        torch.cuda._sleep(cycles)
        t1.record()
        t1.synchronize()
        took = t0.elapsed_time(t1)
    return int(cycles * ms / max(took, 1e-3))


def phase_serve(torch, np, ck, cases_2d, cases_1d, l2_threshold) -> dict:
    """Phase 15, the serving pipeline (serve/server.py, serve/resilience.py,
    cli/common.serve_batch), every part counted.  (a) The production stream
    at full width: SERVE_CASES cases of 1024^2, eps=8, f32, two physics a
    bucket, SERVE_STEPS steps, submitted one at a time to
    ServePipeline(depth=2, window_ms=5): every lane bitwise the offline
    EnsembleEngine.run(), batched_step2d launches equal to the offline
    run's, occupancy 2, fence_scalar once a retire and never between the
    dispatches, zero retries, fallback chunks and a closed breaker; a fence
    probe (a spin kernel queued behind the first chunk must still be running
    when the second dispatch returns); serve_fence_ab's depth-1 and depth-2
    walls; the stream's device time and idle share under torch.profiler; the
    same stream under NLHEAT_TUNE_BATCH=1 (the batched tuner's probes from
    the serving path, B7/B8) bitwise its offline run.  (b)
    Supervision: a 256^2 f64 stream under CHAOS_PLAN with a 200 ms fetch
    deadline (error, hang, corrupt classified; case 6 quarantined; the rest
    bitwise offline), then BREAKER_PLAN with breaker_threshold=2: the
    breaker opens, the CPU fallback serves within 1e-12 of the card, the
    half-open probe re-closes it.  (c) The CLIs in f64: solve2d, solve1d and
    solve3d --test_batch --serve 2 over their tables, each run's resilience
    block zero, solve2d's launches batched_step2d and solve3d's nsum3d; solve2d with
    --metrics-out and --trace (the resilience block zero, the dispatches
    --ensemble's, serve.dispatch spans beside the torch.profiler trace).
    (d) Two cases on the shuffled 512^2 cloud through the pipeline, bitwise
    the engine's offline gather_L run.  Returns the launches by part."""
    from nonlocalheatequation_torch.cli import solve1d, solve2d, solve3d
    from nonlocalheatequation_torch.serve import server as srv
    from nonlocalheatequation_torch.serve.ensemble import EnsembleCase, EnsembleEngine
    from nonlocalheatequation_torch.serve.meshes import MeshStore, get_mesh_op
    from nonlocalheatequation_torch.serve.server import ServePipeline, serve_fence_ab
    from nonlocalheatequation_torch.utils import autotune
    from nonlocalheatequation_torch.utils.faults import FaultPlan

    card = nvidia_smi("name,power.limit")
    f32, f64 = torch.float32, torch.float64
    by, walls = {}, {}
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 15)

    def engine(dtype=f32, **kw):
        return EnsembleEngine(method="cuda", device="cuda", dtype=dtype, **kw)

    def same(got, want, what):
        if len(got) != len(want) or not all(
                g is not None and np.array_equal(g, w) for g, w in zip(got, want)):
            fail(f"phase 15 {what}: a served lane is not bitwise the offline run's")

    def quiet(res, what):
        if (res["retries"], res["faults"], res["bisections"], res["fallback_chunks"],
                res["quarantined"], res["breaker"]["state"]) != (0, {}, 0, 0, [], "closed"):
            fail(f"phase 15 {what}: the happy path reported {json.dumps(res)}")

    # (a) the production stream at full width
    dh = 1.0 / SERVE_N
    phys = [(k, euler_dt(dh, k, frac)) for k, frac in SERVE_PHYSICS]
    cases = [EnsembleCase(shape=(SERVE_N, SERVE_N), nt=SERVE_STEPS, eps=EPS,
                          k=phys[i % 2][0], dt=phys[i % 2][1], dh=dh, test=False,
                          u0=rng.standard_normal((SERVE_N, SERVE_N)))
             for i in range(SERVE_CASES)]
    chunks = SERVE_CASES // ENS_B
    want_b6 = {"batched_step2d": chunks * SERVE_STEPS}
    offline = launches_of(ck, by, "15a offline run", lambda: engine().run(cases))
    if by["15a offline run"] != want_b6:
        fail(f"phase 15 (a): the offline run launched {by['15a offline run']}, not {want_b6}")
    eng = engine()
    events = []
    real_fence, real_dispatch = srv.fence_scalar, eng.dispatch_chunk
    srv.fence_scalar = lambda x: (events.append("fence"), real_fence(x))[1]
    eng.dispatch_chunk = lambda m, U: (events.append("dispatch"), real_dispatch(m, U))[1]

    def stream(pipe_kw, eng=eng):
        with ServePipeline(engine=eng, **pipe_kw) as pipe:
            handles = [pipe.submit(c) for c in cases]
            pipe.drain()
        return pipe, [h.result for h in handles]

    try:
        t0 = time.perf_counter()
        pipe, served = launches_of(ck, by, "15a served stream",
                                   lambda: stream({"depth": 2, "window_ms": 5.0}))
        stream_wall = time.perf_counter() - t0
    finally:
        srv.fence_scalar = real_fence
        del eng.dispatch_chunk
    m = pipe.metrics()
    same(served, offline, "(a)")
    if by["15a served stream"] != want_b6:
        fail(f"phase 15 (a): the stream launched {by['15a served stream']}, not {want_b6}")
    if events != ["dispatch"] * chunks + ["fence"] * chunks:
        fail(f"phase 15 (a): dispatches and fences ran as {events}: a fence sat between "
             "the dispatches, or not one fence a retire")
    if m["occupancy"]["max"] != 2 or m["forced_closes"] != {"size": chunks}:
        fail(f"phase 15 (a): occupancy {m['occupancy']}, closes {m['forced_closes']}")
    quiet(m["resilience"], "(a)")
    say(f"{card}: phase 15 (a) {SERVE_CASES} x {SERVE_N}^2 eps={EPS} f32, {SERVE_STEPS} "
        f"steps, 2 physics, ServePipeline(depth=2, window_ms=5): every lane bitwise the "
        f"offline run, batched_step2d {by['15a served stream']['batched_step2d']} launches "
        f"(offline the same), events {events}, occupancy {json.dumps(m['occupancy'])}, "
        f"stream wall {stream_wall:.3f} s (first pass, pinned blocks allocated), chunk log "
        f"{json.dumps([{k: c[k] for k in ('cases', 'build_ms', 'device_ms', 'fetch_ms')} for c in m['chunk_log']])}")

    # the fence probe: a spin queued behind the first chunk's kernels is still
    # running when the second dispatch returns, unless something fenced
    cycles = spin_cycles(torch, SPIN_MS)
    probe = {}

    def spun(m_, U):
        out = real_dispatch(m_, U)
        if "spin" not in probe:
            torch.cuda._sleep(cycles)
            probe["spin"] = torch.cuda.Event()
            probe["spin"].record()
            probe["t0"] = time.perf_counter()
        else:
            probe.setdefault("spin_done_after_2nd", probe["spin"].query())
            probe.setdefault("stream_idle_after_2nd", torch.cuda.current_stream().query())
            probe.setdefault("host_ms_to_2nd", (time.perf_counter() - probe["t0"]) * 1e3)
        return out

    eng.dispatch_chunk = spun
    try:
        _, probed = launches_of(ck, by, "15a fence probe",
                                lambda: stream({"depth": 2, "window_ms": 5.0}))
    finally:
        del eng.dispatch_chunk
    same(probed, offline, "(a) fence probe")
    if probe.get("spin_done_after_2nd") is not False or probe["stream_idle_after_2nd"]:
        fail(f"phase 15 (a): the second dispatch returned after the first chunk's spin "
             f"({SPIN_MS} ms) had ended: a fence between dispatches ({probe})")
    build_s, fenced_s, piped_s, rep = launches_of(
        ck, by, "15a serve_fence_ab", lambda: serve_fence_ab(eng, cases, 2, iters=2))
    say(f"{card}: phase 15 (a) fence probe: a {SPIN_MS} ms spin queued behind chunk 0 was "
        f"still running when the second dispatch returned {probe['host_ms_to_2nd']:.1f} ms "
        f"later, the stream busy; serve_fence_ab (window_ms=0: a case a chunk, B=1), "
        f"walls in turns, best of 2: depth 1 {fenced_s:.4f} s, depth 2 {piped_s:.4f} s "
        f"(ratio {fenced_s / piped_s:.3f}; first pass {build_s:.3f} s), max in flight "
        f"{rep.max_inflight}")
    # the served stream's device time under torch.profiler: a chunk's kernels
    # against the stream's wall, so the idle share says whether the host or
    # the card sets the pace (the profiler's own host cost included)
    sprof = launches_of(ck, by, "15a profiled stream", lambda: device_profile(
        torch, lambda: stream({"depth": 2, "window_ms": 5.0}), chunks * SERVE_STEPS))
    if "device_busy_ms_per_step" in sprof:
        chunk_dev = (f"{sprof['device_busy_ms_per_step'] * SERVE_STEPS:.3f} ms of device "
                     f"time a chunk, idle share {sprof['idle_share']:.3f} of the stream's "
                     f"{sprof['window_ms_per_step'] * chunks * SERVE_STEPS:.1f} ms")
    else:
        chunk_dev = sprof["device_time"]
    say(f"{card}: phase 15 (a) the served stream (depth 2) under torch.profiler, after a "
        f"warm-up: {chunk_dev}; per launch {json.dumps(sprof)}")
    os.environ["NLHEAT_TUNE_BATCH"] = "1"
    autotune.reset()
    try:
        tuned_eng = engine()
        tpipe, tserved = launches_of(ck, by, "15a tuned stream",
                                     lambda: stream({"depth": 2, "window_ms": 5.0},
                                                    tuned_eng))
        toffline = launches_of(ck, by, "15a tuned offline", lambda: engine().run(cases))
    finally:
        del os.environ["NLHEAT_TUNE_BATCH"]
    same(tserved, toffline, "(a) tuned")
    tuned_ran = by["15a tuned stream"]
    if not (tuned_ran.get("batched_carried2d") or tuned_ran.get("batched_superstep2d")):
        fail(f"phase 15 (a): the tuned stream launched {tuned_ran}: no B7/B8 probe or winner")
    quiet(tpipe.metrics()["resilience"], "(a) tuned")
    say(f"{card}: phase 15 (a) NLHEAT_TUNE_BATCH=1: strategies "
        f"{sorted(set(tpipe.report.strategies.values()))}, stream launches {tuned_ran} "
        f"(probes and winner), bitwise its offline run ({by['15a tuned offline']})")
    walls["a"] = time.perf_counter() - t_phase

    # (b) supervision on the card, f64
    cdh = 1.0 / CHAOS_N
    cdt = euler_dt(cdh, 1.0, 0.8)
    chaos = [EnsembleCase(shape=(CHAOS_N, CHAOS_N), nt=CHAOS_STEPS, eps=EPS, k=1.0,
                          dt=cdt * (1.0 - 0.02 * (i % 3)), dh=cdh, test=False,
                          u0=rng.standard_normal((CHAOS_N, CHAOS_N)))
             for i in range(CHAOS_CASES)]
    coffline = launches_of(ck, by, "15b offline", lambda: engine(f64, batch_sizes=(4,)).run(
        chaos))
    def submit_all(pipe, batch):
        handles = [pipe.submit(c) for c in batch]
        pipe.drain()
        return handles

    with ServePipeline(engine=engine(f64, batch_sizes=(4,)), depth=2, window_ms=10_000.0,
                       retries=1, backoff_ms=0.0, fallback=False, fetch_deadline_ms=200.0,
                       faults=FaultPlan.parse(CHAOS_PLAN)) as cpipe:
        handles = launches_of(ck, by, "15b chaos stream", lambda: submit_all(cpipe, chaos))
    res = cpipe.metrics()["resilience"]
    if set(res["faults"]) != {"error", "hang", "corrupt"} or res["faults"]["error"] != 1 \
            or res["faults"]["hang"] != 1 or [q["case"] for q in res["quarantined"]] != [6]:
        fail(f"phase 15 (b) {CHAOS_PLAN}: {json.dumps(res)}")
    same([h.result for i, h in enumerate(handles) if i != 6],
         [w for i, w in enumerate(coffline) if i != 6], "(b) chaos")
    if not isinstance(handles[6].error, srv.ServeError):
        fail(f"phase 15 (b): case 6 ended {handles[6].error!r}, not a ServeError")
    clock = [0.0]
    with ServePipeline(engine=engine(f64, batch_sizes=(4,)), depth=1, window_ms=10_000.0,
                       clock=lambda: clock[0], retries=2, backoff_ms=0.0,
                       breaker_threshold=2, breaker_cooldown_ms=1000.0,
                       faults=FaultPlan.parse(BREAKER_PLAN)) as bpipe:
        bh = launches_of(ck, by, "15b breaker open", lambda: submit_all(bpipe, chaos[:8]))
        opened = bpipe.metrics()["resilience"]
        clock[0] += 1.1  # past the cooldown: the next chunk is the half-open probe
        bh += launches_of(ck, by, "15b breaker probe", lambda: submit_all(bpipe, chaos[8:]))
    bres = bpipe.metrics()["resilience"]
    moves = [(t["from"], t["to"]) for t in bres["breaker"]["transitions"]]
    if opened["breaker"]["state"] != "open" or opened["fallback_chunks"] != 2 \
            or moves != [("closed", "open"), ("open", "half-open"), ("half-open", "closed")]:
        fail(f"phase 15 (b) {BREAKER_PLAN}: open {json.dumps(opened)}, then {json.dumps(bres)}")
    fb_err = max(float(np.abs(h.result - w).max()) / float(np.abs(w).max())
                 for h, w in zip(bh[:8], coffline[:8]))
    if not fb_err <= TOL["float64"]:
        fail(f"phase 15 (b): the CPU fallback's lanes differ from the card's by {fb_err:.3e}")
    same([h.result for h in bh[8:]], coffline[8:], "(b) half-open probe")
    if by["15b breaker open"] or by["15b breaker probe"] != {"batched_step2d": CHAOS_STEPS}:
        fail(f"phase 15 (b): the fallback chunks launched {by['15b breaker open']}, the "
             f"probe {by['15b breaker probe']}")
    say(f"{card}: phase 15 (b) {CHAOS_CASES} x {CHAOS_N}^2 f64 chunks of 4, {CHAOS_PLAN}, "
        f"fetch deadline 200 ms: faults {res['faults']}, retries {res['retries']}, "
        f"bisections {res['bisections']}, quarantined {[q['case'] for q in res['quarantined']]}, "
        f"the other 11 lanes bitwise the offline run; {BREAKER_PLAN} with threshold 2: "
        f"breaker {moves}, {opened['fallback_chunks']} chunks served by the CPU fallback "
        f"(no launch) within {fb_err:.3e} of the card's lanes (relative), the probe chunk "
        f"bitwise ({CHAOS_STEPS} batched_step2d launches)")
    walls["b"] = time.perf_counter() - t_phase - sum(walls.values())

    # (c) the CLIs on the card, f64: each --serve run's resilience block is
    # read back, so a stream the CPU fallback served cannot pass
    serve_args = [*CLI_ARGS, "--serve", "2"]
    with tempfile.TemporaryDirectory() as tmp:
        for label, main, rows in (("solve2d", solve2d.main, cases_2d),
                                  ("solve1d", solve1d.main, cases_1d),
                                  ("solve3d", solve3d.main, CASES_3D)):
            mfile = os.path.join(tmp, f"{label}.json")
            out = launches_of(ck, by, f"15c {label} --serve 2",
                              lambda main=main, rows=rows, mfile=mfile: run_batch_cli(
                                  main, [*serve_args, "--metrics-out", mfile], rows))
            if out.splitlines()[-1] != "Tests Passed":
                fail(f"phase 15 (c) {label} --serve 2: {out.splitlines()[-1:]}")
            quiet(json.loads(Path(mfile).read_text())["resilience"], f"(c) {label} --serve 2")
    if not by["15c solve2d --serve 2"].get("batched_step2d") \
            or by["15c solve2d --serve 2"].get("step2d"):
        fail(f"phase 15 (c): solve2d --serve 2 launched {by['15c solve2d --serve 2']}")
    if not by["15c solve3d --serve 2"].get("nsum3d"):
        fail(f"phase 15 (c): solve3d --serve 2 launched {by['15c solve3d --serve 2']}")
    with tempfile.TemporaryDirectory() as tmp:
        sm, em, tdir = (os.path.join(tmp, x) for x in ("serve.json", "ensemble.json", "trace"))
        launches_of(ck, by, "15c solve2d --serve 2 --metrics-out --trace",
                    lambda: run_batch_cli(solve2d.main, [*serve_args, "--metrics-out", sm,
                                                         "--trace", tdir], cases_2d))
        launches_of(ck, by, "15c solve2d --ensemble --metrics-out",
                    lambda: run_batch_cli(solve2d.main, [*CLI_ARGS, "--ensemble",
                                                         "--metrics-out", em], cases_2d))
        sjs, ejs = json.loads(Path(sm).read_text()), json.loads(Path(em).read_text())
        spans = [e["name"] for e in json.loads(Path(tdir, "host_trace.json").read_text())[
            "traceEvents"]]
        prof = [f for f in os.listdir(tdir) if f.endswith(".pt.trace.json")]
        prof_text = Path(tdir, prof[0]).read_text() if len(prof) == 1 else ""
    quiet(sjs["resilience"], "(c) --metrics-out")
    if sjs["dispatches"] != ejs["dispatches"] or sjs["cases"] != len(cases_2d):
        fail(f"phase 15 (c): --serve {sjs['dispatches']} dispatches, --ensemble "
             f"{ejs['dispatches']}")
    if spans.count("serve.dispatch") != sjs["dispatches"] or "batched_step2d" not in prof_text:
        fail(f"phase 15 (c) --trace: {spans.count('serve.dispatch')} serve.dispatch spans for "
             f"{sjs['dispatches']} dispatches, profiler traces {prof}")
    say(f"{card}: phase 15 (c) f64 --serve 2: solve2d over CASES_2D, solve1d over CASES_1D, "
        f"solve3d over CASES_3D Tests Passed, each resilience block zero ({json.dumps({k[4:]: v for k, v in by.items() if k.startswith('15c') and '--serve 2' in k and 'metrics' not in k})}); "
        f"--metrics-out: {sjs['dispatches']} dispatches (--ensemble {ejs['dispatches']}), "
        f"resilience zero; --trace: {spans.count('serve.dispatch')} serve.dispatch spans of "
        f"{len(spans)} beside the torch.profiler trace (batched_step2d in it)")
    walls["c"] = time.perf_counter() - t_phase - sum(walls.values())

    # (d) a mesh bucket through the pipeline
    pts, h = jittered_cloud(np, UN_M, 2, SEED + 9, shuffle=True)
    with tempfile.TemporaryDirectory() as mdir:
        os.environ["NLHEAT_MESH_DIR"] = mdir
        try:
            mhash = MeshStore(mdir).put(pts, 3 * h, h * h)
            mop = get_mesh_op(mhash, 1.0, 1.0, device="cuda")
            mdt = 0.8 / float(np.max(mop.c * mop.wsum))
            mcases = [EnsembleCase(shape=(mop.n,), nt=MESH_SERVE_STEPS, eps=0, k=k,
                                   dt=mdt * f, dh=0.0, test=True, mesh=mhash)
                      for k, f in ((1.0, 1.0), (0.5, 0.8))]
            moff = launches_of(ck, by, "15d offline", lambda: EnsembleEngine(
                device="cuda", dtype=f32).run(mcases))
            with ServePipeline(engine=EnsembleEngine(device="cuda", dtype=f32), depth=2,
                               window_ms=10_000.0) as mpipe:
                mserved = launches_of(ck, by, "15d served", lambda: mpipe.serve_cases(mcases))
        finally:
            del os.environ["NLHEAT_MESH_DIR"]
    same(mserved, moff, "(d) mesh bucket")
    want12 = {"gather_L": len(mcases) * MESH_SERVE_STEPS}
    if by["15d served"] != want12 or by["15d offline"] != want12:
        fail(f"phase 15 (d): gather_L launches served {by['15d served']}, offline "
             f"{by['15d offline']}, not {want12}")
    quiet(mpipe.metrics()["resilience"], "(d)")
    say(f"{card}: phase 15 (d) 2 test-form cases on the shuffled {UN_M}^2 cloud ({mop.n} "
        f"nodes), {MESH_SERVE_STEPS} steps, one chunk: bitwise the offline gather_L run, "
        f"{want12['gather_L']} gather_L launches each way")
    walls["d"] = time.perf_counter() - t_phase - sum(walls.values())
    say(f"phase 15 part walls, s: {json.dumps({k: round(v, 1) for k, v in walls.items()})}")
    return by


# -- phase 16: the leaves of the fleet -----------------------------------------------

FLEET_SOLO_STEPS = 500    # (a) the tuned solo leg: Solver2D at 512^2, eps=8, f32
FLEET_HORIZON = 500       # (c) the test form's horizon: 500 Euler steps at 0.8x the bound
FLEET_MESH_STEPS = 20     # (c) steps of the picked mesh case
FLEET_CHILD_TIMEOUT = 300  # seconds the warm-boot child may run


def fleet_stream(np, dt=None) -> list:
    """Phase 15's stream made anew from the seed: SERVE_CASES production
    cases of 1024^2, eps=8, two physics, SERVE_STEPS steps; with ``dt`` every
    case steps at that dt (a picked schedule)."""
    from nonlocalheatequation_torch.serve.ensemble import EnsembleCase

    dh = 1.0 / SERVE_N
    phys = [(k, euler_dt(dh, k, frac)) for k, frac in SERVE_PHYSICS]
    rng = np.random.default_rng(SEED + 16)
    return [EnsembleCase(shape=(SERVE_N, SERVE_N), nt=SERVE_STEPS, eps=EPS, k=phys[i % 2][0],
                         dt=phys[i % 2][1] if dt is None else dt, dh=dh, test=False,
                         u0=rng.standard_normal((SERVE_N, SERVE_N)))
            for i in range(SERVE_CASES)]


def sha16(a) -> str:
    import hashlib

    return hashlib.sha256(a.tobytes()).hexdigest()[:16]


def fleet_boot(torch, np, ck) -> dict:
    """One boot of phase 16 (a): the tuned stream through ServePipeline(depth
    2) and the tuned solo Solver2D at 512^2, each leg's launches, states'
    digests, programs and the tuner winners it ran; ``t_first`` is the wall
    clock when the first chunk had retired."""
    from nonlocalheatequation_torch.models.solver2d import Solver2D
    from nonlocalheatequation_torch.ops.nonlocal_op import NonlocalOp2D
    from nonlocalheatequation_torch.serve.ensemble import EnsembleEngine
    from nonlocalheatequation_torch.serve.server import ServePipeline
    from nonlocalheatequation_torch.utils import autotune

    out = {}
    cases = fleet_stream(np)
    before = ck.launch_counts()
    with ServePipeline(engine=EnsembleEngine(method="cuda", device="cuda",
                                             dtype=torch.float32),
                       depth=2, window_ms=5.0) as pipe:
        handles = [pipe.submit(c) for c in cases]
        handles[0].wait()
        out["t_first"] = time.time()
        pipe.drain()
    out["stream_launches"] = {k: v - before[k] for k, v in ck.launch_counts().items()
                              if v != before[k]}
    out["stream"] = [sha16(h.result) for h in handles]
    m = pipe.metrics()
    out["programs"] = {"built": m["programs_built"], "loaded": m["programs_loaded"]}
    out["strategies"] = sorted(set(pipe.report.strategies.values()))
    out["store"] = {k: m["store"][k] for k in ("hits", "misses", "saves", "refusals")}
    recs = autotune.records()
    out["stream_winner"] = recs[autotune.batched_key(
        [NonlocalOp2D(EPS, 1.0, 1.0, 1.0 / SERVE_N)] * ENS_B, (SERVE_N, SERVE_N),
        torch.float32, "cuda")]["winner"]
    dh = 1.0 / SMALL
    s = Solver2D(SMALL, SMALL, FLEET_SOLO_STEPS, EPS, k=1.0, dt=euler_dt(dh), dh=dh,
                 method="cuda", dtype=torch.float32, device="cuda")
    s.input_init(np.random.default_rng(SEED + 161).standard_normal((SMALL, SMALL)))
    before = ck.launch_counts()
    u = s.do_work()
    out["solo_launches"] = {k: v - before[k] for k, v in ck.launch_counts().items()
                            if v != before[k]}
    out["solo"] = sha16(u)
    out["solo_winner"] = autotune.records()[autotune.tuning_key(
        s.op, (SMALL, SMALL), torch.float32, "cuda")]["winner"]
    return out


def fleet_child_main(out_path: str) -> int:
    """phase 16 (a)'s warm-boot child (``chip_smoke.py --fleet-child OUT``,
    run from a copy of the package with no _build/): one fleet_boot, the
    nvcc runs counted, its report written to OUT as JSON."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from nonlocalheatequation_torch.ops import _build
    from nonlocalheatequation_torch.ops import cuda_kernel as ck

    had_build = _build.BUILD_DIR.exists()
    nvcc = []
    real = _build.find_nvcc
    _build.find_nvcc = lambda: nvcc.append(1) or real()
    rep = fleet_boot(torch, np, ck)
    rep.update(nvcc_runs=len(nvcc), had_build=had_build,
               restored=sorted(p.name for p in _build.BUILD_DIR.glob("*.so")))
    Path(out_path).write_text(json.dumps(rep))
    return 0


def rewrite_fingerprint(path: Path, ps) -> None:
    """Rewrite the torch version in a program store entry's header (the
    payload and its CRC untouched): a load must then refuse it."""
    raw = path.read_bytes()
    body = raw[len(ps.MAGIC):]
    hlen = int.from_bytes(body[:8], "little")
    header = json.loads(body[8:8 + hlen])
    header["fingerprint"]["torch"] = "0.0.0"
    new = json.dumps(header).encode()
    path.write_bytes(ps.MAGIC + len(new).to_bytes(8, "little") + new + body[8 + hlen:])


def entry_key(path: Path, ps) -> str:
    body = path.read_bytes()[len(ps.MAGIC):]
    return json.loads(body[8:8 + int.from_bytes(body[:8], "little")])["key"]


def phase_fleet_leaves(torch, np, ck, cases_2d, built) -> dict:
    """Phase 16 (see the module docstring): the program store's warm boot,
    the SLO ledger on the served stream, picked engines served, the flight
    recorder's postmortems.  ``built`` is phase 1's nvcc walls by source.
    Returns the launches by part."""
    import shutil
    import signal

    from nonlocalheatequation_torch.cli import solve2d
    from nonlocalheatequation_torch.ops.nonlocal_op import NonlocalOp2D
    from nonlocalheatequation_torch.serve import program_store as ps
    from nonlocalheatequation_torch.serve import server as srv
    from nonlocalheatequation_torch.serve.ensemble import EnsembleCase, EnsembleEngine
    from nonlocalheatequation_torch.serve.meshes import MeshStore, get_mesh_op
    from nonlocalheatequation_torch.serve.picker import (
        ERR_SAFETY,
        modeled_error,
        pick_engine,
        record_rate_fn,
    )
    from nonlocalheatequation_torch.serve.server import ServePipeline
    from nonlocalheatequation_torch.utils import autotune

    card = nvidia_smi("name,power.limit")
    name = torch.cuda.get_device_name(0)
    f32 = torch.float32
    by, walls = {}, {}
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="phase16-"))
    saved_env = {k: os.environ.get(k) for k in ("NLHEAT_PROGRAM_STORE", "NLHEAT_TUNE_BATCH",
                                                "NLHEAT_AUTOTUNE_CACHE", "NLHEAT_FAULT_PLAN",
                                                "NLHEAT_MESH_DIR")}
    # (d)'s SIGTERM child starts first: by (d) it blocks on its stdin, armed
    sig_dir = tmp / "sigterm"
    sig = subprocess.Popen([sys.executable, "-m", "nonlocalheatequation_torch.cli.solve2d",
                            *CLI_ARGS, "--serve", "2", "--flight-dir", str(sig_dir)],
                           cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True,
                           env=dict(os.environ, PYTHONPATH=str(ROOT)))
    CHILDREN.append(sig)
    try:
        store_dir = tmp / "store"
        os.environ.update(NLHEAT_PROGRAM_STORE=str(store_dir), NLHEAT_TUNE_BATCH="1",
                          NLHEAT_AUTOTUNE_CACHE=str(tmp / "autotune.json"))
        autotune.reset()
        # (a) the cold boot, then the warm child
        cold = launches_of(ck, by, "16a cold boot", lambda: fleet_boot(torch, np, ck))
        by["16a cold stream"], by["16a cold solo"] = (cold.pop("stream_launches"),
                                                      cold.pop("solo_launches"))
        del by["16a cold boot"]
        entries = sorted(store_dir.glob("*" + ps.PROGRAM_SUFFIX))
        libs = sorted(store_dir.glob("*" + ps.LIBRARY_SUFFIX))
        if cold["programs"] != {"built": 1, "loaded": 0} or len(entries) != 2 or not libs:
            fail(f"phase 16 (a) cold boot: programs {cold['programs']}, {len(entries)} "
                 f"program and {len(libs)} library entries, store {cold['store']}")
        tree = tmp / "tree"
        shutil.copytree(ROOT / "nonlocalheatequation_torch", tree / "nonlocalheatequation_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        shutil.copy(ROOT / "chip_smoke.py", tree / "chip_smoke.py")
        (tmp / "no_cuda").mkdir()
        path = os.pathsep.join(d for d in os.environ.get("PATH", "").split(os.pathsep)
                               if d and not os.access(os.path.join(d, "nvcc"), os.X_OK))
        env = dict(os.environ, NLHEAT_PROGRAM_STORE=str(store_dir), NLHEAT_AUTOTUNE_CACHE="",
                   NLHEAT_TUNE_BATCH="1", PATH=path, CUDA_HOME=str(tmp / "no_cuda"),
                   PYTHONPATH=str(tree))
        report = tmp / "child.json"
        t_spawn = time.time()
        child = subprocess.Popen([sys.executable, "chip_smoke.py", "--fleet-child",
                                  str(report)], cwd=tree, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
        CHILDREN.append(child)
        try:
            c_out, c_err = child.communicate(timeout=FLEET_CHILD_TIMEOUT)
        except subprocess.TimeoutExpired:
            child.kill()
            c_out, c_err = child.communicate()
            fail(f"phase 16 (a): the warm-boot child ran past {FLEET_CHILD_TIMEOUT} s: "
                 f"{c_err[-3000:]}")
        if child.returncode != 0 or not report.exists():
            fail(f"phase 16 (a): the warm-boot child exited {child.returncode}: "
                 f"{c_err[-4000:]}")
        warm = json.loads(report.read_text())
        by["16a warm child stream"] = warm["stream_launches"]
        by["16a warm child solo"] = warm["solo_launches"]
        chunks = SERVE_CASES // ENS_B
        kernel, per = variant_launches(warm["stream_winner"], SERVE_STEPS)
        want_stream = {kernel: per * chunks}
        want_solo = dict([variant_launches(warm["solo_winner"], FLEET_SOLO_STEPS)])
        bad = []
        if warm["nvcc_runs"] or warm["had_build"]:
            bad.append(f"nvcc runs {warm['nvcc_runs']}, _build present {warm['had_build']}")
        if warm["stream_launches"] != want_stream or warm["solo_launches"] != want_solo:
            bad.append(f"launches {warm['stream_launches']} / {warm['solo_launches']}, the "
                       f"winners' {want_stream} / {want_solo}")
        if warm["programs"]["loaded"] < 1 or warm["programs"]["built"] != 0:
            bad.append(f"programs {warm['programs']}, strategies {warm['strategies']}")
        if warm["stream"] != cold["stream"] or warm["solo"] != cold["solo"]:
            bad.append("a state differs from the cold boot's")
        if (warm["stream_winner"], warm["solo_winner"]) != (cold["stream_winner"],
                                                            cold["solo_winner"]):
            bad.append(f"winners {warm['stream_winner']}/{warm['solo_winner']}, cold "
                       f"{cold['stream_winner']}/{cold['solo_winner']}")
        if bad:
            fail(f"phase 16 (a) warm boot: {'; '.join(bad)}\n{c_err[-2000:]}")
        restored = [s for s in built if any(r.startswith(f"lib{Path(s).stem}-")
                                            for r in warm["restored"])]
        nvcc_wall = max(built[s] for s in restored) if restored else 0.0
        say(f"{card}: phase 16 (a) cold boot (empty store): stream {by['16a cold stream']} "
            f"(probes and winner {cold['stream_winner']}), solo 512^2 {by['16a cold solo']} "
            f"(winner {cold['solo_winner']}), store {json.dumps(cold['store'])}, "
            f"{len(entries)} program and {len(libs)} library entries; warm child (no _build, "
            f"no nvcc, NLHEAT_AUTOTUNE_CACHE=''): nvcc runs {warm['nvcc_runs']}, stream "
            f"{warm['stream_launches']}, solo {warm['solo_launches']}, programs "
            f"{json.dumps(warm['programs'])}, strategies {warm['strategies']}, libraries "
            f"restored {warm['restored']}, every state bitwise the cold boot's; wall from spawn "
            f"to the first retired chunk {warm['t_first'] - t_spawn:.2f} s, phase 1's nvcc "
            f"wall for {restored} {nvcc_wall:.1f} s")
        # a program entry with a rewritten fingerprint: refused loudly, rebuilt bitwise
        stream_entry = next(e for e in entries if f"({SERVE_N}, {SERVE_N})" in entry_key(e, ps))
        rewrite_fingerprint(stream_entry, ps)
        autotune.reset()
        cases = fleet_stream(np)
        reng = EnsembleEngine(method="cuda", device="cuda", dtype=f32)
        with ServePipeline(engine=reng, depth=2, window_ms=5.0) as rpipe:
            rstates = launches_of(ck, by, "16a refused entry", lambda: rpipe.serve_cases(cases))
        rstore = rpipe.metrics()["store"]
        if rstore["refusals"] != {ps.REFUSE_FINGERPRINT: 1} or rstore["hits"] != 0 \
                or [sha16(u) for u in rstates] != cold["stream"]:
            fail(f"phase 16 (a) rewritten fingerprint: store {json.dumps(rstore)}")
        say(f"{card}: phase 16 (a) the stream's program entry with a rewritten fingerprint: "
            f"refusals {rstore['refusals']}, rebuilt ({by['16a refused entry']}), bitwise the "
            "cold boot")
        walls["a"] = time.perf_counter() - t_phase
        for k in ("NLHEAT_PROGRAM_STORE", "NLHEAT_TUNE_BATCH"):
            del os.environ[k]

        # (b) the SLO ledger on the picked stream
        dh = 1.0 / SERVE_N
        dt_t = euler_dt(dh, 1.0, 0.6)
        T = SERVE_STEPS * dt_t
        acc = ERR_SAFETY * modeled_error(2, T, dt_t) * (1.0 + 1e-9)
        rate = record_rate_fn(name)
        picks = [pick_engine((SERVE_N, SERVE_N), EPS, k, dh, T, acc, method="cuda",
                             allow_fft=False, rate_fn=rate) for k, _ in SERVE_PHYSICS]
        if {(p.stepper, p.stages, p.method, p.precision, p.steps) for p in picks} != {
                ("euler", 0, "cuda", "f32", SERVE_STEPS)} or picks[0].dt != picks[1].dt:
            fail(f"phase 16 (b): the picks {[p.wire() for p in picks]}")
        pcases = fleet_stream(np, dt=picks[0].dt)

        def slo_stream(slo):
            eng = EnsembleEngine(method="cuda", device="cuda", dtype=f32)
            events = []
            real_fence, real_dispatch = srv.fence_scalar, eng.dispatch_chunk
            srv.fence_scalar = lambda x: (events.append("fence"), real_fence(x))[1]
            eng.dispatch_chunk = lambda m, U: (events.append("dispatch"),
                                               real_dispatch(m, U))[1]
            try:
                with ServePipeline(engine=eng, depth=2, window_ms=5.0, slo=slo) as pipe:
                    hs = [pipe.submit(c, engine=picks[i % 2]) for i, c in enumerate(pcases)]
                    pipe.drain()
            finally:
                srv.fence_scalar = real_fence
            return events, [h.result for h in hs], pipe.metrics()

        off_events, off_states, _ = launches_of(ck, by, "16b stream, ledger off",
                                                lambda: slo_stream(False))
        on_events, on_states, on_m = launches_of(ck, by, "16b stream, ledger on",
                                                 lambda: slo_stream(True))
        s = on_m["slo"]
        want_b6 = {"batched_step2d": chunks * SERVE_STEPS}
        if on_events != off_events or on_events != ["dispatch"] * chunks + ["fence"] * chunks \
                or by["16b stream, ledger on"] != want_b6 != by["16b stream, ledger off"] \
                or any(not np.array_equal(a, b) for a, b in zip(on_states, off_states)):
            fail(f"phase 16 (b): events {on_events} (off {off_events}), launches "
                 f"{by['16b stream, ledger on']}, or a state not bitwise the ledger-off run")
        if (s["promised"], s["resolved"], s["open"], s["duplicate"], s["unmatched"]) != (
                SERVE_CASES, SERVE_CASES, 0, 0, 0):
            fail(f"phase 16 (b): the ledger {json.dumps(s)}")
        live_key = autotune.record_key(name, "cuda", (SERVE_N, SERVE_N), EPS, "float32")
        live = (autotune._load_file_cache().get(live_key) or {}).get("live")
        if not live or live.get("provenance") != "live":
            fail(f"phase 16 (b): no live rate under {live_key}")
        say(f"{card}: phase 16 (b) {SERVE_CASES} x {SERVE_N}^2 picked "
            f"({picks[0].stepper}/{picks[0].method}/{picks[0].precision}, {picks[0].steps} "
            f"steps at dt {picks[0].dt:.6e}, est {picks[0].est_ms:.1f} ms, {picks[0].rates} "
            f"rates), ledger off and on: events {on_events} both, {want_b6} each, states "
            f"bitwise; promised {s['promised']}, resolved {s['resolved']}, duplicate "
            f"{s['duplicate']}, unmatched {s['unmatched']}, drift warnings "
            f"{s['drift_warnings']}, cost ratio p50 {s['drift_ratio_p50']}; live per-apply "
            f"{live['per-step']} ms a lane (x{ENS_B} = {live['per-step'] * ENS_B:.5f} ms a "
            f"launch's worth, n {live['n']}) under {live_key}; PERF.md's B6 row: 0.0569 ms a "
            f"launch at 8 x {SERVE_N}^2")
        walls["b"] = time.perf_counter() - t_phase - sum(walls.values())

        # (c) picked engines served: the test form to a horizon, a mesh case
        rate = record_rate_fn(name)
        T_h = FLEET_HORIZON * euler_dt(dh, 1.0, 0.8)
        ch = pick_engine((SERVE_N, SERVE_N), EPS, 1.0, dh, T_h, 1e-6, method="cuda",
                         rate_fn=rate)
        case = EnsembleCase(shape=(SERVE_N, SERVE_N), nt=ch.steps, eps=EPS, k=1.0, dt=ch.dt,
                            dh=dh, test=True)
        with ServePipeline(engine=EnsembleEngine(method="cuda", device="cuda", dtype=f32),
                           depth=2, window_ms=0.0) as pipe:
            u = launches_of(ck, by, "16c picked engine",
                            lambda: pipe.submit(case, engine=ch).wait())
        want = NonlocalOp2D(EPS, 1.0, ch.dt, dh).manufactured_solution(SERVE_N, SERVE_N,
                                                                      ch.steps)
        err = float(np.sum((np.asarray(u, np.float64) - want) ** 2)) / SERVE_N ** 2
        predicted = ({"nsum2d": ch.steps * ch.stages + 1} if ch.stepper == "rkc"
                     else {"nsum2d": 1, "batched_step2d": ch.steps} if ch.stepper == "euler"
                     else {})
        if not err <= 1e-6 or by["16c picked engine"] != predicted:
            fail(f"phase 16 (c) picked {ch.wire()}: error_l2/#points {err:.3e}, launches "
                 f"{by['16c picked engine']}, predicted {predicted}")
        pts, h = jittered_cloud(np, UN_M, 2, SEED + 9, shuffle=True)
        mdir = tmp / "meshes"
        os.environ["NLHEAT_MESH_DIR"] = str(mdir)
        mhash = MeshStore(str(mdir)).put(pts, 3 * h, h * h)
        host = get_mesh_op(mhash, 1.0, 1.0, device="cpu")
        T_m = (FLEET_MESH_STEPS - 0.5) * 0.8 / float(np.max(host.c * host.wsum))
        chm = pick_engine((1,), 0, 1.0, 1.0, T_m, 1e-6, mesh=mhash, rate_fn=rate)
        mcase = EnsembleCase(shape=(host.n,), nt=chm.steps, eps=0, k=1.0, dt=chm.dt, dh=0.0,
                             test=True, mesh=mhash)
        with ServePipeline(engine=EnsembleEngine(device="cuda", dtype=f32), depth=2,
                           window_ms=0.0) as mpipe:
            um = launches_of(ck, by, "16c picked mesh case",
                             lambda: mpipe.submit(mcase, engine=chm).wait())
        wantm = get_mesh_op(mhash, 1.0, chm.dt, device="cpu").manufactured_solution(chm.steps)
        errm = float(np.sum((np.asarray(um, np.float64) - wantm) ** 2)) / host.n
        if (chm.method, chm.stepper) != ("gather", "euler") or not errm <= 1e-6 \
                or by["16c picked mesh case"] != {"gather_L": chm.steps}:
            fail(f"phase 16 (c) mesh pick {chm.wire()}: error {errm:.3e}, launches "
                 f"{by['16c picked mesh case']}")
        say(f"{card}: phase 16 (c) {SERVE_N}^2 test form to {FLEET_HORIZON} Euler steps' "
            f"horizon: picked {ch.stepper}[s={ch.stages}]/{ch.method}/{ch.precision}, "
            f"{ch.steps} steps, est {ch.est_ms:.4f} ms ({ch.rates} rates), served: "
            f"error_l2/#points {err:.3e}, launches {by['16c picked engine']} as predicted; "
            f"mesh pick on the shuffled {UN_M}^2 cloud ({host.n} nodes): {chm.stepper}/"
            f"{chm.method}/{chm.precision}, {chm.steps} steps ({chm.rates} rates), served: "
            f"error {errm:.3e}, {by['16c picked mesh case']}")
        walls["c"] = time.perf_counter() - t_phase - sum(walls.values())

        # (d) the flight recorder: a quarantine postmortem, a SIGTERM dump
        fdir = tmp / "flight"
        os.environ["NLHEAT_FAULT_PLAN"] = CHAOS_PLAN
        import contextlib
        import io

        old_stdin, sys.stdin = sys.stdin, io.StringIO(batch_text(cases_2d))
        out, errs = io.StringIO(), io.StringIO()
        try:
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(errs):
                rc = launches_of(ck, by, "16d solve2d --serve 2 --flight-dir",
                                 lambda: solve2d.main([*CLI_ARGS, "--serve", "2",
                                                       "--flight-dir", str(fdir)]))
        finally:
            sys.stdin = old_stdin
            del os.environ["NLHEAT_FAULT_PLAN"]
        docs = [json.loads(p.read_text()) for p in sorted(fdir.glob("postmortem-*.json"))]
        quarantines = [d for d in docs if d["postmortem"] == "quarantine"]
        if rc != 1 or not out.getvalue().rstrip().endswith("Tests Failed") \
                or [d["case"] for d in quarantines] != [6]:
            fail(f"phase 16 (d) {CHAOS_PLAN}: rc {rc}, postmortems "
                 f"{[(d['postmortem'], d.get('case')) for d in docs]}\n"
                 f"{errs.getvalue()[-2000:]}")
        deadline = time.monotonic() + 60
        while not sig_dir.is_dir() and sig.poll() is None and time.monotonic() < deadline:
            time.sleep(0.05)
        time.sleep(0.5)
        sig.send_signal(signal.SIGTERM)
        _, sig_err = sig.communicate(timeout=60)
        sdocs = [json.loads(p.read_text()) for p in sig_dir.glob("postmortem-*.json")] \
            if sig_dir.is_dir() else []
        if sig.returncode != -signal.SIGTERM or [d["postmortem"] for d in sdocs] != ["sigterm"]:
            fail(f"phase 16 (d) SIGTERM: rc {sig.returncode}, dumps "
                 f"{[d['postmortem'] for d in sdocs]}\n{sig_err[-2000:]}")
        q = quarantines[0]
        say(f"{card}: phase 16 (d) solve2d --serve 2 --flight-dir under {CHAOS_PLAN} over "
            f"CASES_2D (f64): Tests Failed, postmortems {[d['postmortem'] for d in docs]}, the "
            f"quarantine's case {q['case']} ({q['classification']}), in flight "
            f"{q.get('inflight')}, {len(q['events'])} events; a solve2d child SIGTERMed: rc "
            f"{sig.returncode}, dump {[d['postmortem'] for d in sdocs]}")
        walls["d"] = time.perf_counter() - t_phase - sum(walls.values())
    finally:
        if sig.poll() is None:
            sig.kill()
            sig.communicate()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)
    say(f"phase 16 part walls, s: {json.dumps({k: round(v, 1) for k, v in walls.items()})}")
    return by


# -- phase 17: the fleet front door ----------------------------------------------------

FLEET_STEPS = (SERVE_STEPS, SERVE_STEPS + 1)  # (a) the two buckets' steps
GANG_STEPS = 100        # (c) the gang's 4096^2 eps=8 f32 test form
GANG_DEVICES = 4        # (c) the gang's devices: virtual devices of one card
GANG_RKC = (8, 8)       # (c) the rkc EngineChoice: stages, dt in Euler bounds
FAIL_NT = 77            # (e) the marked case's steps: its chunk fails on the card
FAIL_N = 256            # (e) the grid of the failure leg's cases
BURST = 192             # (d) POSTs of the burst past the ingress's cap of 2 x 64
BURST_STEPS = 2000      # (d) steps of each burst case (1024^2 test form)
FLEET_WAIT = 600        # seconds any fleet wait may take
FLEET_TOKEN = "phase17-token"


def fleet_worker_main(connect=None) -> int:
    """A replica worker of phase 17 (``chip_smoke.py --fleet-worker
    [HOST:PORT]``, started by fleet_transports): the port's worker main
    (serve/router.py ``_worker_main``) behind the pipe worker's fd 1
    hand-over, taken before torch is imported.  At exit it writes its
    launches by kernel and its nvcc runs to NLHEAT_FLEET_COUNTS/worker-PID.
    With NLHEAT_FLEET_FAIL_REPLICAS naming its replica id (or "*"), a chunk
    holding a case of FAIL_NT steps raises "CUDA error: unspecified launch
    failure" at dispatch, as a failed launch would."""
    frame_fd = None
    if connect is None:
        frame_fd = os.dup(1)
        os.dup2(2, 1)
    sys.path.insert(0, str(ROOT))
    from nonlocalheatequation_torch.ops import _build
    from nonlocalheatequation_torch.ops import cuda_kernel as ck
    from nonlocalheatequation_torch.serve import router
    from nonlocalheatequation_torch.serve.ensemble import EnsembleEngine

    nvcc = []
    real = _build.find_nvcc
    _build.find_nvcc = lambda: nvcc.append(1) or real()
    rid = os.environ.get("NLHEAT_REPLICA_ID")
    failing = os.environ.get("NLHEAT_FLEET_FAIL_REPLICAS", "").split(",")
    if "*" in failing or rid in failing:
        stage, dispatch = EnsembleEngine.stage_inputs, EnsembleEngine.dispatch_chunk

        def staged(self, chunk):
            self.fleet_marked = any(c.nt == FAIL_NT for c in chunk)
            return stage(self, chunk)

        def dispatched(self, multi, U0):
            if getattr(self, "fleet_marked", False):
                raise RuntimeError("CUDA error: unspecified launch failure")
            return dispatch(self, multi, U0)

        EnsembleEngine.stage_inputs, EnsembleEngine.dispatch_chunk = staged, dispatched
    out_dir = os.environ.get("NLHEAT_FLEET_COUNTS")

    def report():
        if out_dir:
            Path(out_dir, f"worker-{os.getpid()}.json").write_text(json.dumps({
                "leg": os.environ.get("NLHEAT_FLEET_LEG"), "replica": rid,
                "transport": "tcp" if connect else "pipe",
                "nvcc": len(nvcc), "launches": {k: v for k, v in ck.launch_counts().items()
                                                if v}}))

    atexit.register(report)
    router._worker_main(connect=connect, frame_fd=frame_fd)
    return 0


def fleet_transports(counts_dir: Path):
    """(pipe, tcp) transport objects whose workers are fleet_worker_main
    children of this script, counting their launches into counts_dir."""
    from nonlocalheatequation_torch.serve import transport as tr

    def env_of(env):
        return dict(env, NLHEAT_FLEET_COUNTS=str(counts_dir))

    class Pipe(tr.PipeTransport):
        def spawn(self, rid, env, timeout_s=180.0):
            proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                                     "--fleet-worker"], stdin=subprocess.PIPE,
                                    stdout=subprocess.PIPE, env=env_of(env), cwd=ROOT)
            CHILDREN.append(proc)
            return tr.WorkerHandle(proc, proc.stdout, proc.stdin, transport=self.name)

    class Tcp(tr.SocketTransport):
        def spawn(self, rid, env, timeout_s=180.0):
            env = env_of(env)
            if self.token is not None:
                env[tr.WORKER_TOKEN_ENV] = self.token
            proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                                     "--fleet-worker", self.connect_arg()],
                                    stdin=subprocess.DEVNULL, env=env, cwd=ROOT)
            CHILDREN.append(proc)
            try:
                conn = self._accept(rid, timeout_s, proc)
            except BaseException:
                proc.kill()
                raise
            return tr.WorkerHandle(proc, conn.makefile("rb"), conn.makefile("wb"), sock=conn,
                                   transport=self.name)

    return Pipe, Tcp


def restart_gang(router, env: dict) -> None:
    """Stop the router's gang replica cleanly (its launches reported at exit)
    and start a new one with ``env`` added to its environment."""
    rep = router._gang_rep()
    rep.closing = True
    rep.send({"op": "stop"})
    rep.sendq.put(None)
    rep.handle.reap(timeout_s=FLEET_WAIT)
    router.child_env.update(env)
    router._spawn(gang=True)


def closed_by_peer(sock) -> bool:
    """The listener closed this connection (EOF, or a reset when it left
    bytes unread)."""
    try:
        return sock.recv(1) == b""
    except ConnectionResetError:
        return True


def worker_counts(counts_dir: Path) -> list:
    return [json.loads(p.read_text()) for p in sorted(counts_dir.glob("worker-*.json"))]


def fleet_http(port: int, method: str, path: str, body=None, raw: bool = False):
    """(status, JSON body or raw bytes, Retry-After) of one request to the
    ingress on 127.0.0.1:port."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=FLEET_WAIT) as r:
            code, payload, retry = r.status, r.read(), r.headers.get("Retry-After")
    except urllib.error.HTTPError as e:
        code, payload, retry = e.code, e.read(), e.headers.get("Retry-After")
    return code, (payload if raw else json.loads(payload.decode())), retry


def start_listen(module: str, argv, env) -> tuple:
    """A --listen CLI child and a thread collecting its stderr lines.  The
    child leads a session of its own, so that stop_children can end its
    replica workers with it."""
    import threading

    proc = subprocess.Popen([sys.executable, "-m", module, "--listen", "0", *argv], cwd=ROOT,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            start_new_session=True)
    CHILDREN.append(proc)
    lines: list = []
    t = threading.Thread(target=lambda: lines.extend(iter(proc.stderr.readline, "")),
                         daemon=True)
    t.start()
    return proc, lines, t


def listen_port(proc, lines, what: str) -> int:
    deadline = time.monotonic() + FLEET_WAIT
    while time.monotonic() < deadline and proc.poll() is None:
        for line in list(lines):
            m = re.search(r"ingress: http://127.0.0.1:(\d+)/v1/cases", line)
            if m:
                return int(m.group(1))
        time.sleep(0.2)
    fail(f"{what} printed no ingress line (rc {proc.poll()}):\n"
         + "".join(lines)[-4000:])


def stop_listen(proc, lines, t, what: str) -> str:
    proc.stdin.close()  # EOF = shutdown
    try:
        rc = proc.wait(timeout=FLEET_WAIT)
    except subprocess.TimeoutExpired:
        proc.kill()
        fail(f"{what} did not stop on EOF")
    t.join(timeout=30)
    err = "".join(lines)
    if rc != 0:
        fail(f"{what} exited {rc}:\n{err[-4000:]}")
    return err


def fleet_latency(m: dict) -> str:
    p = m.get("request_latency_ms") or {}
    return f"p50 {p.get('p50', 0.0):.1f} ms, p99 {p.get('p99', 0.0):.1f} ms"


def phase_front_door(torch, np, ck, l2_threshold) -> dict:
    """Phase 17 (see the module docstring): the replica router's pipe and TCP
    fleets, the gang replica, the --listen front door and a card failure in
    a worker.  Legs (b) and (e) run on threads beside (a) and (c), and (d)'s
    CLI children boot from the start: a worker takes seconds to be ready,
    and the legs' spawns overlap.  Returns the launches by part: the phase
    process's own runs and each counted worker's."""
    import concurrent.futures
    import io
    import shutil
    import socket

    from nonlocalheatequation_torch.models.solver2d import Solver2D
    from nonlocalheatequation_torch.parallel.distributed2d import (
        Solver2DDistributed,
        choose_mesh_for_grid,
    )
    from nonlocalheatequation_torch.parallel.gang import solve_case_sharded
    from nonlocalheatequation_torch.parallel.mesh import device_list
    from nonlocalheatequation_torch.serve import router as router_mod
    from nonlocalheatequation_torch.serve import transport as tr
    from nonlocalheatequation_torch.serve.ensemble import EnsembleCase, EnsembleEngine
    from nonlocalheatequation_torch.serve.meshes import get_mesh_op
    from nonlocalheatequation_torch.serve.picker import EngineChoice
    from nonlocalheatequation_torch.serve.router import ReplicaRouter
    from nonlocalheatequation_torch.utils.faults import FaultPlan

    card = nvidia_smi("name,power.limit")
    f32 = torch.float32
    by, walls = {}, {}
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="phase17-"))
    counts = tmp / "counts"
    counts.mkdir()
    Pipe, Tcp = fleet_transports(counts)
    saved_mesh_dir = os.environ.get("NLHEAT_MESH_DIR")

    def mark(part):
        walls[part] = round(time.perf_counter() - t_phase, 1)

    def same(got, want, what):
        bad = [i for i, (a, b) in enumerate(zip(got, want, strict=True))
               if a is None or not np.array_equal(a, b)]
        if bad:
            fail(f"phase 17 {what}: cases {bad} are not bitwise the offline run")

    # (d)'s CLI children boot while the other legs run
    mdir = tmp / "meshes"
    cli_env = dict(os.environ, NLHEAT_MESH_DIR=str(mdir), PYTHONPATH=str(ROOT))
    cli_env.pop("NLHEAT_PROGRAM_STORE", None)
    metrics_out = tmp / "listen-metrics.json"
    cli2 = start_listen("nonlocalheatequation_torch.cli.solve2d",
                        ["--replicas", "2", "--shard-threshold", str(ENS_N * ENS_N),
                         "--gang-devices", str(GANG_DEVICES), "--slo", "1",
                         "--metrics-out", str(metrics_out)], cli_env)
    cli3 = start_listen("nonlocalheatequation_torch.cli.solve3d", ["--replicas", "1"], cli_env)
    pool = concurrent.futures.ThreadPoolExecutor(3)
    try:
        # the offline references, in this thread before the legs start (the
        # launch counts of this process are read as differences)
        dh = 1.0 / ENS_N
        rng = np.random.default_rng(SEED + 17)
        phys = [(k, euler_dt(dh, k, frac)) for k, frac in SERVE_PHYSICS]
        # one physics a bucket: a chunk's program is keyed on its lanes'
        # physics, so whatever the arrival timing splits, the padded chunk
        # of a bucket keys one program (the warm newcomer finds it stored)
        cases = [EnsembleCase(shape=(ENS_N, ENS_N), nt=FLEET_STEPS[i % 2], eps=EPS,
                              k=phys[i % 2][0], dt=phys[i % 2][1], dh=dh, test=False,
                              u0=rng.standard_normal((ENS_N, ENS_N)))
                 for i in range(SERVE_CASES)]
        offline = launches_of(ck, by, "17a offline", lambda: EnsembleEngine(
            method="cuda", device="cuda", dtype=f32, batch_sizes=(ENS_B,)).run(cases))
        fdh = 1.0 / FAIL_N
        frng = np.random.default_rng(SEED + 171)
        fcases = [EnsembleCase(shape=(FAIL_N, FAIL_N), nt=FAIL_NT if i == 0 else 20 + i % 2,
                               eps=EPS, k=1.0, dt=euler_dt(fdh), dh=fdh, test=False,
                               u0=frng.standard_normal((FAIL_N, FAIL_N))) for i in range(5)]
        fwant = launches_of(ck, by, "17e offline", lambda: EnsembleEngine(
            method="cuda", device="cuda", dtype=f32, batch_sizes=(ENS_B,)).run(fcases))

        def leg_tcp() -> dict:
            # (b) TCP with a token: the stream bitwise (a); a garbage
            # connection and a wrong-token hello are dropped while it serves
            t0 = time.perf_counter()
            tcp = Tcp(token=FLEET_TOKEN)
            with ReplicaRouter(replicas=2, transport=tcp, method="cuda", dtype=f32,
                               batch_sizes=(ENS_B,), program_store=str(tmp / "store"),
                               child_env={"NLHEAT_FLEET_LEG": "b"},
                               spawn_timeout_s=FLEET_WAIT) as trouter:
                spawn = time.perf_counter() - t0
                same(trouter.serve_cases(cases), offline, "(b) TCP")
                garbage = socket.create_connection(("127.0.0.1", tcp.port))
                garbage.sendall(b"\xff" * 64)
                wrong = socket.create_connection(("127.0.0.1", tcp.port))
                tr.write_json_frame(wrong.makefile("wb"), {"op": "hello", "replica": 9,
                                                           "token": "wrong"})
                same(trouter.serve_cases(cases), offline, "(b) TCP beside the bad peers")
                try:  # an accept round with no worker due reads and drops both
                    tcp._accept(99, timeout_s=5.0)
                except TimeoutError:
                    pass
                garbage.settimeout(30)
                wrong.settimeout(30)
                dropped = closed_by_peer(garbage) and closed_by_peer(wrong)
                garbage.close()
                wrong.close()
                same(trouter.serve_cases(cases), offline, "(b) TCP after the drops")
                m = trouter.metrics()
            if not dropped or m["deaths"] != 0 or m["transport"] != "tcp":
                fail(f"phase 17 (b): dropped {dropped}, {m}")
            mark("b")
            return {"spawn": spawn, "m": m}

        def leg_failure_one() -> dict:
            # (e) replica 0's dispatch fails on the marked case: it ends, the
            # router counts a death, a healthy replica serves the case
            ekw = dict(method="cuda", dtype=f32, batch_sizes=(ENS_B,), transport=Pipe(),
                       spawn_timeout_s=FLEET_WAIT)
            with ReplicaRouter(replicas=2, child_env={"NLHEAT_FLEET_FAIL_REPLICAS": "0",
                                                      "NLHEAT_FLEET_LEG": "e1"},
                               **ekw) as erouter:
                hs = [erouter.submit(c) for c in fcases]  # the marked case first: replica 0
                erouter.drain(timeout_s=FLEET_WAIT)
                em = erouter.metrics()
                if any(x.error is not None for x in hs) or em["deaths"] != 1 \
                        or hs[0].replica == 0:
                    fail(f"phase 17 (e): errors {[str(x.error) for x in hs if x.error]}, "
                         f"{em}, marked case on replica {hs[0].replica}")
                same([x.result for x in hs], fwant, "(e) the re-routed card failure")
                pulled = erouter.refresh_stats()
                res = [pulled[r]["metrics"]["resilience"] for r in em["live"]]
                if any(d["fallback_chunks"] or d["retries"] for d in res):
                    fail(f"phase 17 (e): a survivor retried or fell back: {res}")
            mark("e1")
            return {"m": em, "replica": hs[0].replica}

        def leg_failure_every() -> dict:
            # (e) the failure in every worker: the case completes
            # exceptionally after MAX_REQUEUES, the other cases are served
            ekw = dict(method="cuda", dtype=f32, batch_sizes=(ENS_B,), transport=Pipe(),
                       spawn_timeout_s=FLEET_WAIT)
            with ReplicaRouter(replicas=1, child_env={"NLHEAT_FLEET_FAIL_REPLICAS": "*",
                                                      "NLHEAT_FLEET_LEG": "e2"},
                               **ekw) as erouter:
                others = [erouter.submit(c) for c in fcases[1:]]
                erouter.drain(timeout_s=FLEET_WAIT)
                marked = erouter.submit(fcases[0])
                try:
                    marked.wait(FLEET_WAIT)
                    fail("phase 17 (e): the case that fails on every worker was served")
                except router_mod.ServeError as e:
                    why = str(e)
                later = [erouter.submit(c) for c in fcases[1:]]
                erouter.drain(timeout_s=FLEET_WAIT)
                qm = erouter.metrics()
            if "MAX_REQUEUES" not in why or qm["deaths"] != router_mod.MAX_REQUEUES + 1:
                fail(f"phase 17 (e): {why}; {qm}")
            same([x.result for x in others + later], fwant[1:] * 2, "(e) the other cases")
            mark("e2")
            return {"m": qm, "why": why}

        legs = {"b": pool.submit(leg_tcp), "e1": pool.submit(leg_failure_one),
                "e2": pool.submit(leg_failure_every)}

        # (a) the pipe fleet: 2 replicas and the gang, one shared store
        t0 = time.perf_counter()
        router = ReplicaRouter(replicas=2, transport=Pipe(), method="cuda", dtype=f32,
                               batch_sizes=(ENS_B,), program_store=str(tmp / "store"),
                               shard_threshold=ENS_N * ENS_N, gang_devices=GANG_DEVICES,
                               max_replicas=3, child_env={"NLHEAT_FLEET_LEG": "a"},
                               spawn_timeout_s=FLEET_WAIT)
        spawn_wall = time.perf_counter() - t0
        try:
            t0 = time.perf_counter()
            got = router.serve_cases(cases)
            serve_wall = time.perf_counter() - t0
            same(got, offline, "(a) the pipe fleet")
            owners = {k: router._owner[k] for k in {c.bucket_key() for c in cases}}
            if sorted(owners.values()) != [0, 1]:
                fail(f"phase 17 (a): bucket owners {owners}, not one bucket a replica")
            stats = router.refresh_stats()
            names = router.registry.names()
            for rid in (0, 1):
                if not any(n.startswith(f"/replica{{{rid}}}/serve/") for n in names):
                    fail(f"phase 17 (a): no /replica{{{rid}}} namespace after refresh_stats")
            busy = {rid: router.registry.get(f"/replica{{{rid}}}/busy-rate").value
                    for rid in (0, 1)}
            m = router.metrics()
            say(f"{card}: phase 17 (a) ReplicaRouter(2 replicas + the gang, pipe): 3 workers "
                f"ready in {spawn_wall:.2f} s; {SERVE_CASES} x {ENS_N}^2 f32 over buckets nt "
                f"{FLEET_STEPS} served in {serve_wall:.2f} s, bitwise the offline run, owners "
                f"{sorted(owners.values())}; busy rates (of 10000) {busy}; latency "
                f"{fleet_latency(m)}; stats from {sorted(stats)}")
            router._faults = FaultPlan.parse("die@5")
            got = router.serve_cases(cases)
            router._faults = None
            same(got, offline, "(a) die@5")
            m = router.metrics()
            if m["deaths"] != 1 or m["requeued"] < 1 or m["replicas"] != 2 or m["spawns"] != 4 \
                    or m["outstanding"] != 0:
                fail(f"phase 17 (a) die@5: {m}")
            say(f"{card}: phase 17 (a) die@5: deaths {m['deaths']}, requeued {m['requeued']}, "
                f"respawned to {m['replicas']} replicas (spawns {m['spawns']}), every case once "
                f"and bitwise; latency {fleet_latency(m)}")
            # scale out, then in: the newcomer inherits the drained replica's
            # bucket and boots it from the shared store
            t0 = time.perf_counter()
            new = router.add_replica()
            add_wall = time.perf_counter() - t0
            key = cases[0].bucket_key()
            victim = router._owner[key]
            router.drain_replica(victim)
            got = router.serve_cases(cases)
            same(got, offline, "(a) the added replica")
            fresh = ReplicaRouter.refresh_stats(router)[new]["metrics"]
            if router._owner.get(key) != new or fresh["cases"] < 1 \
                    or fresh["programs_built"] != 0 or fresh["programs_loaded"] < 1:
                fail(f"phase 17 (a) add_replica: owner {router._owner.get(key)}, "
                     f"{fresh['cases']} cases, programs built {fresh['programs_built']}, "
                     f"loaded {fresh['programs_loaded']}")
            m = router.metrics()
            say(f"{card}: phase 17 (a) add_replica: replica {new} ready in {add_wall:.2f} s; "
                f"replica {victim} drained, its bucket served by the newcomer bitwise, programs "
                f"built {fresh['programs_built']}, loaded {fresh['programs_loaded']} (store "
                f"hits {fresh['store']['hits']}, misses {fresh['store']['misses']}); latency "
                f"over the leg {fleet_latency(m)}")
            mark("a")

            # (c) the gang: 4096^2, eps=8, f32, the test form, GANG_STEPS steps
            gdh = 1.0 / NX
            gdt = euler_dt(gdh)
            gcase = EnsembleCase(shape=(NX, NX), nt=GANG_STEPS, eps=EPS, k=1.0, dt=gdt, dh=gdh,
                                 test=True)
            gvals = router.submit(gcase).wait(FLEET_WAIT)
            if router.metrics()["sharded_cases"] != 1:
                fail(f"phase 17 (c): the {NX}^2 case did not go to the gang")
            cache: dict = {}
            want, ginfo = launches_of(ck, by, "17c offline solve_case_sharded",
                                      lambda: solve_case_sharded(
                                          gcase, ndevices=GANG_DEVICES, method="cuda",
                                          dtype=f32, solver_cache=cache))
            if not np.array_equal(gvals, want) or ginfo.get("transport") != "peer":
                fail(f"phase 17 (c): the gang's {NX}^2 state bitwise the offline "
                     f"solve_case_sharded: {np.array_equal(gvals, want)}; info {ginfo}")
            mesh = choose_mesh_for_grid(NX, NX, device_list("cuda", GANG_DEVICES))
            mx, my = mesh.shape["x"], mesh.shape["y"]
            s = Solver2DDistributed(NX // mx, NX // my, mx, my, GANG_STEPS, EPS, k=1.0, dt=gdt,
                                    dh=gdh, mesh=mesh, method="cuda", dtype=f32, comm="fused")
            s.test_init()
            direct = launches_of(ck, by, "17c offline Solver2DDistributed", s.do_work)
            err = s.error_l2 / (NX * NX)
            if not np.array_equal(np.asarray(direct, np.float64), gvals) or err > l2_threshold:
                fail(f"phase 17 (c): Solver2DDistributed bitwise {np.array_equal(direct, gvals)}"
                     f", error_l2/#points {err}")
            stages, mult = GANG_RKC
            rcase = EnsembleCase(shape=(NX, NX), nt=GANG_STEPS // mult, eps=EPS, k=1.0,
                                 dt=mult * gdt, dh=gdh, test=True)
            pick = EngineChoice("rkc", stages, "cuda", "f32", rcase.dt, rcase.nt, 0.0, 0.0,
                                "analytic")
            rvals = router.submit(rcase, engine=pick).wait(FLEET_WAIT)
            rwant, rinfo = launches_of(ck, by, "17c offline rkc", lambda: solve_case_sharded(
                rcase, ndevices=GANG_DEVICES, method="cuda", dtype=f32, stepper="rkc",
                stages=stages))
            if not np.array_equal(rvals, rwant) or rinfo.get("stepper") != "rkc":
                fail(f"phase 17 (c): the rkc[{stages}] pick on the gang: bitwise "
                     f"{np.array_equal(rvals, rwant)}, info {rinfo}")
            # the interp repeat: the gang stops (its launches reported) and a
            # new one starts under NLHEAT_FUSED_TRANSPORT=interp (split kernels)
            restart_gang(router, {"NLHEAT_FUSED_TRANSPORT": "interp"})
            ivals = router.submit(gcase).wait(FLEET_WAIT)
            os.environ["NLHEAT_FUSED_TRANSPORT"] = "interp"
            try:
                iwant, iinfo = launches_of(ck, by, "17c offline interp", lambda:
                                           solve_case_sharded(gcase, ndevices=GANG_DEVICES,
                                                              method="cuda", dtype=f32))
            finally:
                os.environ.pop("NLHEAT_FUSED_TRANSPORT", None)
            m = router.metrics()
            if not np.array_equal(ivals, iwant) or not np.array_equal(ivals, gvals) \
                    or iinfo.get("transport") != "interp" or m["deaths"] != 1 \
                    or len(m["gang"]) != 1:
                fail(f"phase 17 (c) interp: bitwise offline {np.array_equal(ivals, iwant)}, "
                     f"bitwise peer {np.array_equal(ivals, gvals)}, info {iinfo}, "
                     f"deaths {m['deaths']}, gang {m['gang']}")
            if torch.cuda.device_count() >= GANG_DEVICES:
                vwant, _ = solve_case_sharded(gcase, ndevices=GANG_DEVICES, method="cuda",
                                              dtype=f32, device="cuda:0")
                if not np.array_equal(vwant, gvals):
                    fail("phase 17 (c): the gang on real cards is not bitwise the virtual run")
                say(f"phase 17 (c) the gang on {GANG_DEVICES} real cards: bitwise the "
                    "virtual run")
            mark("c")
        finally:
            router.close()
        b, e1, e2 = (legs[k].result() for k in ("b", "e1", "e2"))
        say(f"{card}: phase 17 (b) TCP on 127.0.0.1 with a token: 2 workers dialed in in "
            f"{b['spawn']:.2f} s, the stream bitwise (a); a garbage connection and a "
            f"wrong-token hello dropped while serving, deaths 0; latency "
            f"{fleet_latency(b['m'])}")
        say(f"{card}: phase 17 (e) dispatch raising 'CUDA error: unspecified launch failure' "
            f"on the marked case in replica 0: the worker ended, deaths {e1['m']['deaths']}, "
            f"the case retired from replica {e1['replica']} bitwise, no survivor retried or "
            f"fell back to the CPU; the failure in every worker: {e2['m']['deaths']} deaths, "
            f"the case '{e2['why']}', the other cases served bitwise")

        # the gang's step, timed alone on the card (CUDA events, the test form)
        solver = next(iter(cache.values()))[0]
        blocks, srcs = solver._device_state()
        run = solver._make_runner(GANG_STEPS)
        step_ms = launches_of(ck, by, "17c timed", lambda: [
            cuda_ms(torch, lambda: run(blocks, 0, srcs), 1, 1) / GANG_STEPS for _ in range(3)])
        say(f"{card}: phase 17 (c) the gang replica, {NX}^2 eps={EPS} f32 test form, "
            f"{GANG_STEPS} steps over {GANG_DEVICES} virtual devices of the card: info "
            f"{json.dumps(ginfo)}; bitwise solve_case_sharded and Solver2DDistributed "
            f"(comm=fused); error_l2/#points {err:.3e}; an rkc[{stages}] EngineChoice "
            f"({rcase.nt} steps of {mult} Euler bounds) bitwise offline, info "
            f"{json.dumps(rinfo)}; a gang restarted under NLHEAT_FUSED_TRANSPORT=interp "
            f"bitwise offline and the peer run; the fused test-form step "
            f"{[round(x, 4) for x in step_ms]} ms (CUDA events over {GANG_STEPS}-step runs, "
            f"mesh {mx}x{my})")

        # (d) the CLI front door
        port = listen_port(*cli2[:2], "phase 17 (d): solve2d --listen")
        cdt = euler_dt(dh)
        explicit = {"shape": [ENS_N, ENS_N], "nt": 20, "eps": EPS, "k": 1.0, "dt": cdt,
                    "dh": dh, "test": True}
        code, resp, _ = fleet_http(port, "POST", "/v1/cases", explicit)
        code_w, done, _ = fleet_http(port, "GET", f"/v1/cases/{resp['id']}?wait=1")
        code_r, raw, _ = fleet_http(port, "GET", f"/v1/cases/{resp['id']}/result?bin=1",
                                    raw=True)
        got = np.load(io.BytesIO(raw))
        ecase = EnsembleCase(shape=(ENS_N, ENS_N), nt=20, eps=EPS, k=1.0, dt=cdt, dh=dh)
        ewant = launches_of(ck, by, "17d offline", lambda: EnsembleEngine(
            device="cuda").run([ecase])[0])
        if (code, code_w, code_r) != (202, 200, 200) or done["status"] != "done" \
                or not np.array_equal(got, ewant):
            fail(f"phase 17 (d) explicit case: {code} {code_w} {code_r} {done}, bitwise "
                 f"{np.array_equal(got, ewant)}")
        T = 200 * cdt
        picked = {"shape": [ENS_N, ENS_N], "eps": EPS, "k": 1.0, "dh": dh, "T_final": T,
                  "accuracy": 1e-6, "test": True}
        code, presp, _ = fleet_http(port, "POST", "/v1/cases", picked)
        if code != 202:
            fail(f"phase 17 (d) picked case: {code} {presp}")
        fleet_http(port, "GET", f"/v1/cases/{presp['id']}?wait=1")
        code, raw, _ = fleet_http(port, "GET", f"/v1/cases/{presp['id']}/result?bin=1",
                                  raw=True)
        ps_ = Solver2D(ENS_N, ENS_N, presp["nt"], EPS, k=1.0, dt=presp["dt"], dh=dh,
                       method="cuda", dtype=f32, device="cuda")
        ps_.test_init()
        ps_.u = np.load(io.BytesIO(raw))
        perr = ps_.compute_l2(ps_.nt) / (ENS_N * ENS_N)
        if code != 200 or not perr <= 1e-6:
            fail(f"phase 17 (d) picked case: {code}, error_l2/#points {perr}")
        code422, body422, _ = fleet_http(port, "POST", "/v1/cases",
                                         {**picked, "deadline_ms": 1e-9})
        pts, hh = jittered_cloud(np, UN_M, 2, SEED + 9, shuffle=True)
        t0 = time.perf_counter()
        code, meta, _ = fleet_http(port, "POST", "/v1/meshes",
                                   {"points": pts.tolist(), "eps": 3 * hh, "vol": hh * hh})
        mesh_wall = time.perf_counter() - t0
        if code != 201:
            fail(f"phase 17 (d) mesh upload: {code} {meta}")
        os.environ["NLHEAT_MESH_DIR"] = str(mdir)
        mop = get_mesh_op(meta["hash"], 1.0, 1.0, device="cpu")
        mdt = 0.8 / float(np.max(mop.c * mop.wsum))
        mbody = {"mesh": meta["hash"], "nt": MESH_SERVE_STEPS, "k": 1.0, "dt": mdt,
                 "test": True}
        code, mresp, _ = fleet_http(port, "POST", "/v1/cases", mbody)
        if code != 202:
            fail(f"phase 17 (d) mesh case: {code} {mresp}")
        fleet_http(port, "GET", f"/v1/cases/{mresp['id']}?wait=1")
        code_m, raw, _ = fleet_http(port, "GET", f"/v1/cases/{mresp['id']}/result?bin=1",
                                    raw=True)
        mcase = EnsembleCase(shape=(mop.n,), nt=MESH_SERVE_STEPS, eps=0, k=1.0, dt=mdt, dh=0.0,
                             test=True, mesh=meta["hash"])
        mwant = launches_of(ck, by, "17d offline mesh", lambda: EnsembleEngine(
            device="cuda").run([mcase])[0])
        if (code, code_m) != (202, 200) or not np.array_equal(np.load(io.BytesIO(raw)), mwant):
            fail(f"phase 17 (d) mesh case: {code} {code_m}")
        burst = {"shape": [ENS_N, ENS_N], "nt": BURST_STEPS, "eps": EPS, "k": 1.0, "dt": cdt,
                 "dh": dh, "test": True}
        with concurrent.futures.ThreadPoolExecutor(16) as posters:
            answers = list(posters.map(
                lambda _: fleet_http(port, "POST", "/v1/cases", burst), range(BURST)))
        shed = [a for a in answers if a[0] == 429]
        accepted = [a for a in answers if a[0] == 202]
        if code422 != 422 or body422.get("refused") != "picker" or not shed \
                or not all(a[2] and int(a[2]) >= 1 for a in shed) \
                or len(shed) + len(accepted) != BURST:
            fail(f"phase 17 (d): 422 {code422} {body422}; burst {len(accepted)} accepted, "
                 f"{len(shed)} shed ({shed[:1]})")
        for _ in range(60):  # the fleet scrape: the stats loop runs every 10 s
            text = fleet_http(port, "GET", "/metrics", raw=True)[1].decode()
            if all(f'replica="{r}"' in text for r in (0, 1)):
                break
            time.sleep(0.5)
        code_s, status, _ = fleet_http(port, "GET", "/v1/status")
        code_x, sess, _ = fleet_http(port, "POST", "/v1/sessions", {})
        if not all(f'nlheat_replica_serve_depth{{replica="{r}"}}' in text for r in (0, 1)) \
                or code_s != 200 or "slo" not in status or code_x != 400 \
                or "missing case field" not in sess.get("error", "") \
                or status.get("sessions") != 0:
            fail(f"phase 17 (d): /metrics replicas "
                 f"{[r for r in (0, 1) if f'replica={r}' in text]}, status {code_s} "
                 f"{sorted(status)}, sessions {code_x} {sess}")
        err2 = stop_listen(*cli2, "phase 17 (d): solve2d --listen")
        if "router:" not in err2:
            fail("phase 17 (d): no router line at exit")
        listen_m = json.loads(metrics_out.read_text())
        # solve3d --listen: one 3D case bitwise the offline engine
        port3 = listen_port(*cli3[:2], "phase 17 (d): solve3d --listen")
        c3 = {"shape": [N3S, N3S, N3S], "nt": 10, "eps": 4, "k": 1.0, "dt": 1e-5,
              "dh": 1.0 / N3S, "test": True}
        code, r3, _ = fleet_http(port3, "POST", "/v1/cases", c3)
        fleet_http(port3, "GET", f"/v1/cases/{r3['id']}?wait=1")
        code3, raw, _ = fleet_http(port3, "GET", f"/v1/cases/{r3['id']}/result?bin=1",
                                   raw=True)
        w3 = launches_of(ck, by, "17d offline 3d", lambda: EnsembleEngine(device="cuda").run(
            [EnsembleCase(shape=(N3S,) * 3, nt=10, eps=4, k=1.0, dt=1e-5, dh=1.0 / N3S)])[0])
        stop_listen(*cli3, "phase 17 (d): solve3d --listen")
        if code3 != 200 or not np.array_equal(np.load(io.BytesIO(raw)), w3):
            fail(f"phase 17 (d) solve3d --listen: {code3}")
        say(f"{card}: phase 17 (d) solve2d --listen 0 --replicas 2 --shard-threshold "
            f"{ENS_N * ENS_N} --gang-devices {GANG_DEVICES} --slo 1: the explicit {ENS_N}^2 "
            f"case bitwise the offline engine; the picked case {json.dumps(presp['engine'])} "
            f"error_l2/#points {perr:.3e}; a 1e-9 ms deadline: 422 ({body422['refused']}); a "
            f"burst of {BURST} x {BURST_STEPS} steps: {len(accepted)} accepted, {len(shed)} "
            f"shed 429 (Retry-After {shed[0][2]} s); the shuffled {UN_M}^2 cloud uploaded in "
            f"{mesh_wall:.2f} s ({meta['nodes']} nodes, {meta['edges']} edges) and a case on "
            f"it bitwise gather_L offline; /v1/status SLO block promised "
            f"{status['slo']['promised']}, open {status['slo']['open']}; both replica "
            f"namespaces in /metrics; /v1/sessions 400 on an empty body; EOF: rc 0, --metrics-out cases "
            f"{listen_m['cases']}, latency through HTTP {fleet_latency(listen_m)}; solve3d "
            f"--listen {N3S}^3 bitwise offline (the CLI children's workers use the real pipe "
            f"transport: their launches are not counted)")
        mark("d")
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        for proc, _, _ in (cli2, cli3):  # still up only when a leg failed
            end_child(proc)
        if saved_mesh_dir is None:
            os.environ.pop("NLHEAT_MESH_DIR", None)
        else:
            os.environ["NLHEAT_MESH_DIR"] = saved_mesh_dir
    workers = worker_counts(counts)
    for w in workers:
        if w["nvcc"]:
            fail(f"phase 17: worker {w['leg']}/{w['replica']} ran nvcc {w['nvcc']} times")
        by[f"17{w['leg']} worker r{w['replica']} {w['transport']}"] = w["launches"]
    new_w = [w for w in workers if w["leg"] == "a" and w["replica"] == str(new)]
    if len(new_w) != 1 or set(new_w[0]["launches"]) != {"batched_step2d"}:
        fail(f"phase 17 (a): the added replica's launches {new_w}: a probe or another kernel")
    if not any(w["launches"].get("fused_nsum2d") for w in workers) \
            or not any(w["launches"].get("split_nsum2d") for w in workers):
        fail(f"phase 17 (c): fused_nsum2d / split_nsum2d not launched in a gang worker: "
             f"{workers}")
    shutil.rmtree(tmp, ignore_errors=True)
    say(f"{card}: phase 17 workers: {len(workers)} reports (a SIGKILLed or failed worker "
        f"writes none), nvcc runs 0; the added replica {new}: {new_w[0]['launches']} (no "
        f"probe); add_replica wall {add_wall:.2f} s")
    say(f"phase 17 legs end at, s: {json.dumps(walls)}")
    return by


SESSION_NT, SESSION_CHUNK = 200, 50   # (a) the 4096^2 session: 4 chunks, one bucket key
SESSION_STRIDE = 4                    # (a) the preview downsample
FLEET_SESSION_CHUNK = 25              # (b) the 1024^2 sessions' chunks (nt SESSION_NT)
FLEET_SESSION_RATE = 50.0             # (b) --session-rate: steps/s across the fleet (the
                                      # sessions then last seconds: the verbs land mid-session)
FLEET_BATCH = 16                      # (b) paced batch cases beside the sessions
FLEET_BATCH_HZ = 8.0                  # (b) their pace, cases/s
FLEET_BATCH_STEPS = 100               # (b) steps of each batch case (1024^2 test form)
MESH_SESSION = (256, 40, 10)          # (c) the 256^2-node cloud, nt, chunk
SESSION3D = (128, 4, 40, 10)          # (d) 128^3, eps, nt, chunk


def session_oracle(np, eng, case_kw: dict, u0, plan) -> list:
    """The chunked oracle of a session: ``plan`` is a list of (steps, k,
    source) chunks, each one EnsembleEngine run from the last boundary (the
    state staged from f64, as the session stages it) with the source added
    on the host in f64 at the chunk's end.  Every boundary state, the initial
    one first."""
    from nonlocalheatequation_torch.serve.ensemble import EnsembleCase

    states = [np.asarray(u0, np.float64)]
    for n, k, source in plan:
        u = np.asarray(eng.run([EnsembleCase(nt=n, k=k, test=False, u0=states[-1],
                                             **case_kw)])[0], np.float64)
        if source is not None:
            u = u + (n * case_kw["dt"]) * source
        states.append(u)
    return states


def session_plan(nt: int, chunk: int, k0: float, changes=()) -> list:
    """(steps, k, source) chunks of an nt-step session whose retargets
    ``changes`` = [(applied_at_step, k, source)] apply at boundaries."""
    plan, k, src, t = [], k0, None, 0
    pending = sorted(changes, key=lambda c: c[0])
    while t < nt:
        while pending and pending[0][0] <= t:
            _, k, src = pending.pop(0)
        n = min(chunk, nt - t)
        plan.append((n, k, src))
        t += n
    return plan


def frames_ok(frames, steps, what: str) -> None:
    """SSE (or buffered) frames: previews at each boundary of ``steps`` in
    order, then one final at the last, with no duplicate."""
    keys = [(f["step"], f["kind"]) if isinstance(f, dict) else (f.step, f.kind)
            for f in frames]
    want = [(t, "preview") for t in steps] + [(steps[-1], "final")]
    if keys != want:
        fail(f"phase 18 {what}: frames {keys}, not {want}")


def sse_frames(port: int, path: str) -> tuple:
    """(data frames, the end event's status) of one SSE stream read to its end."""
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=FLEET_WAIT) as r:
        raw = r.read().decode()
    frames, end = [], None
    for block in raw.split("\n\n"):
        if block.startswith("event: end\ndata: "):
            end = json.loads(block[len("event: end\ndata: "):])
        elif block.startswith("data: "):
            frames.append(json.loads(block[len("data: "):]))
    return frames, end


def worker_pids(pid: int) -> list:
    """The replica workers among a --listen CLI's children (read from /proc)."""
    out = []
    try:
        kids = Path(f"/proc/{pid}/task/{pid}/children").read_text().split()
    except OSError:
        return out
    for kid in kids:
        try:
            cmd = Path(f"/proc/{kid}/cmdline").read_bytes().replace(b"\0", b" ").decode()
        except OSError:
            continue
        if "serve.router" in cmd:
            out.append(int(kid))
    return out


def phase_sessions(torch, np, ck, device: str = "cuda") -> dict:
    """Phase 18 (see the module docstring): the live-session tier.  (b)'s
    CLI child and (c)'s counted worker boot while (a) and (d) run in this
    process; (b) and (c) then run on threads beside each other.  Returns
    the launches by part: this process's runs and (c)'s worker's."""
    import concurrent.futures
    import io
    import shutil
    import signal
    import threading

    from nonlocalheatequation_torch.ops.nonlocal_op import NonlocalOp3D
    from nonlocalheatequation_torch.serve.ensemble import EnsembleCase, EnsembleEngine
    from nonlocalheatequation_torch.serve.http import IngressServer
    from nonlocalheatequation_torch.serve.meshes import get_mesh_op
    from nonlocalheatequation_torch.serve.router import ReplicaRouter
    from nonlocalheatequation_torch.serve.server import ServePipeline
    from nonlocalheatequation_torch.serve.sessions import SessionManager

    card = nvidia_smi("name,power.limit") if device == "cuda" else "cpu"
    f32 = torch.float32
    by, walls = {}, {}
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="phase18-"))
    counts = tmp / "counts"
    counts.mkdir()
    Pipe, _ = fleet_transports(counts)
    rng = np.random.default_rng(SEED + 18)

    def mark(part):
        walls[part] = round(time.perf_counter() - t_phase, 1)

    def same(got, want, what):
        if got is None or not np.array_equal(got, want):
            fail(f"phase 18 {what}: not bitwise the chunked oracle")

    def engine(**kw):
        return EnsembleEngine(method="cuda", device=device, dtype=f32, batch_sizes=(1,), **kw)

    # (b)'s CLI child and (c)'s counted worker boot first
    n_b, dh_b = ENS_N, 1.0 / ENS_N
    cli_env = dict(os.environ, PYTHONPATH=str(ROOT))
    cli_env.pop("NLHEAT_PROGRAM_STORE", None)
    sess_dir, metrics_out = tmp / "sessions-b", tmp / "listen-metrics.json"
    cli = start_listen("nonlocalheatequation_torch.cli.solve2d",
                       ["--replicas", "2", "--platform", "gpu" if device == "cuda" else "cpu",
                        "--session-checkpoint-dir", str(sess_dir),
                        "--session-checkpoint-every", "2",
                        "--session-rate", str(FLEET_SESSION_RATE),
                        "--metrics-out", str(metrics_out)], cli_env)
    mdir = tmp / "meshes"
    pool = concurrent.futures.ThreadPoolExecutor(2)
    boot_c = pool.submit(lambda: ReplicaRouter(
        replicas=1, transport=Pipe(), device=device, dtype=f32, batch_sizes=(1,),
        mesh_dir=str(mdir), child_env={"NLHEAT_FLEET_LEG": "18c"}, spawn_timeout_s=FLEET_WAIT))
    router_c = None
    try:
        # (a) the main path's width in process: 4096^2, eps=8, f32
        n, dh = NX, 1.0 / NX
        dt = euler_dt(dh)
        kw = dict(shape=(n, n), eps=EPS, dt=dt, dh=dh)
        u0 = rng.standard_normal((n, n))
        # a heater: 1 on a disc of radius n/8 at the centre, 0 elsewhere (the
        # checkpoint keeps the source as a JSON list: short values keep it cheap)
        yy, xx = np.mgrid[0:n, 0:n]
        src = ((xx - n / 2) ** 2 + (yy - n / 2) ** 2 <= (n / 8) ** 2).astype(np.float64)
        ckpt_a, ckpt_b = tmp / "ckpt-a", tmp / "ckpt-b"
        t0 = time.perf_counter()

        def pipe():
            return ServePipeline(depth=1, window_ms=0.0, method="cuda", device=device,
                                 dtype=f32, batch_sizes=(1,))

        def open_a(mgr):
            return mgr.open(u0=u0, nt=SESSION_NT, k=1.0, preview_stride=SESSION_STRIDE,
                            checkpoint_every=1, **kw)

        def drive_to(mgr, s, step):
            while s.step < step:
                if s.state != "running":
                    fail(f"phase 18 (a): session {s.state} at step {s.step}: "
                         f"{s.status()['error']}")
                mgr.pump(block=True)

        def retarget_in_chunk_1(mgr, s):
            drive_to(mgr, s, SESSION_CHUNK)
            mgr.pump()  # chunk 1 (steps 50-100) in flight
            if s.inflight is None:
                fail("phase 18 (a): chunk 1 not in flight when the retarget was queued")
            mgr.retarget(s.sid, k=0.5, source=src)

        def session_a():
            with pipe() as p, SessionManager(p, checkpoint_dir=str(ckpt_a),
                                             chunk_steps=SESSION_CHUNK) as mgr:
                s = open_a(mgr)
                retarget_in_chunk_1(mgr, s)
                mgr.drive(timeout_s=FLEET_WAIT)
                frames = s.frames_after(-1)
                fork = mgr.fork(s.sid, step=2 * SESSION_CHUNK)
                mgr.drive(timeout_s=FLEET_WAIT)
                return s, frames, fork, fork.frames_after(-1), mgr.metrics(), p.metrics()

        s, frames, fork, fork_frames, sm, pm = launches_of(ck, by, "18a session", session_a)
        wall_a = time.perf_counter() - t0
        want_launches = {"batched_step2d": (SESSION_NT + 2 * SESSION_CHUNK)}
        if device == "cuda" and by["18a session"] != want_launches:
            fail(f"phase 18 (a): the session and its fork launched {by['18a session']}, not "
                 f"{want_launches}")
        audit = s.status()["audit"]
        if s.state != "done" or audit != [{"verb": "retarget", "applied_at_step": 100,
                                           "requested_at_step": SESSION_CHUNK, "k": 0.5,
                                           "source": "set"}]:
            fail(f"phase 18 (a): state {s.state}, audit {audit}")
        eng_a = engine()
        plan = session_plan(SESSION_NT, SESSION_CHUNK, 1.0, [(100, 0.5, src)])
        states = launches_of(ck, by, "18a oracle", lambda: session_oracle(
            np, eng_a, kw, u0, plan))
        frames_ok(frames, list(range(0, SESSION_NT + 1, SESSION_CHUNK)), "(a)")
        for f, u in zip(frames[:-1], states, strict=True):
            same(f.values, u[::SESSION_STRIDE, ::SESSION_STRIDE].astype(np.float32),
                 f"(a) preview at step {f.step}")
        same(frames[-1].values, states[-1], "(a) final")
        # the fork from the step-100 checkpoint (its state, k and source)
        # continues the parent's physics: bitwise its frames
        frames_ok(fork_frames, list(range(100, SESSION_NT + 1, SESSION_CHUNK)), "(a) fork")
        for f in fork_frames:
            same(f.values, next(g.values for g in frames if (g.step, g.kind) == (f.step, f.kind)),
                 f"(a) fork frame {f.step} {f.kind}")
        # the manager dies after chunk 2; a fresh manager resumes
        t0 = time.perf_counter()

        def session_b():
            with pipe() as p:
                mgr = SessionManager(p, checkpoint_dir=str(ckpt_b), chunk_steps=SESSION_CHUNK)
                s = open_a(mgr)
                retarget_in_chunk_1(mgr, s)
                drive_to(mgr, s, 2 * SESSION_CHUNK)
                pre = s.frames_after(-1)
                mgr.close()
            t_resume = time.perf_counter()
            with pipe() as p, SessionManager(p, checkpoint_dir=str(ckpt_b)) as mgr2:
                r = mgr2.resume(s.sid)
                resumed = (r.resumed_from, r.step)
                mgr2.drive(timeout_s=FLEET_WAIT)
                return pre, r.frames_after(-1), resumed, time.perf_counter() - t_resume

        pre, post, resumed, resume_wall = launches_of(ck, by, "18a resume", session_b)
        wall_b = time.perf_counter() - t0
        got = {(f.step, f.kind): f.values for f in pre}
        dupes = sum((f.step, f.kind) in got for f in post)
        got.update({(f.step, f.kind): f.values for f in post})
        want = {(f.step, f.kind): f.values for f in frames}
        if resumed != (100, 100) or set(got) != set(want) or dupes < 1 \
                or not all(np.array_equal(got[key], want[key]) for key in want):
            fail(f"phase 18 (a) resume: from {resumed}, keys {sorted(got)}, dupes {dupes}, "
                 f"bitwise {[key for key in want if not np.array_equal(got[key], want[key])]}")
        # the chunks' host and card times: the pipeline's chunk log, the
        # session histogram, and one chunk under the profiler
        log = pm["chunk_log"]
        prof = launches_of(ck, by, "18a profiled chunk", lambda: device_profile(
            torch, lambda: eng_a.run([EnsembleCase(nt=SESSION_CHUNK, k=1.0, test=False, u0=u0,
                                                   **kw)]),
            SESSION_CHUNK)) if device == "cuda" else {}
        card_ms = (f"{prof['device_busy_ms_per_step'] * SESSION_CHUNK:.3f} ms a chunk, idle "
                   f"share {prof['idle_share']:.3f} of its {prof['window_ms_per_step'] * SESSION_CHUNK:.1f} ms"
                   if "device_busy_ms_per_step" in prof else prof.get("device_time", "not measured"))
        say(
            f"{card}: phase 18 (a) a {n}^2 eps={EPS} f32 session, nt {SESSION_NT} in chunks of "
            f"{SESSION_CHUNK}, preview stride {SESSION_STRIDE}, a checkpoint a chunk, over "
            f"ServePipeline(depth=1): every preview and the final f64 field bitwise the chunked "
            f"oracle; the retarget (k and a source) queued in chunk 1 applied at step 100; the "
            f"fork from step 100 bitwise the parent's frames; a manager closed after chunk 2 "
            f"and resumed by a fresh one: the frames, deduped by (step, kind), bitwise the "
            f"uninterrupted stream ({dupes} re-emitted); walls: session + fork "
            f"{wall_a:.2f} s, the killed and resumed run {wall_b:.2f} s (resume to done "
            f"{resume_wall:.2f} s); chunk ms (submit to retire) {json.dumps(sm['chunk_ms'])}; "
            f"the pipeline's chunk log (build = staging, device = dispatch to fence) "
            f"{json.dumps([{k: c[k] for k in ('build_ms', 'device_ms', 'fetch_ms')} for c in log])}; "
            f"one {SESSION_CHUNK}-step chunk under torch.profiler: {card_ms}; launches "
            f"{json.dumps(by['18a session'])}")
        # a tuned engine (NLHEAT_TUNE_BATCH=1) at the fleet's 1024^2: the
        # batched tuner's pick among B6, B7 and B8 serves the chunks, bitwise
        # the per-step chunked oracle (the kernels are bitwise each other)
        kw_t = dict(shape=(ENS_N, ENS_N), eps=EPS, dt=euler_dt(1.0 / ENS_N), dh=1.0 / ENS_N)
        u_t = rng.standard_normal((ENS_N, ENS_N))
        os.environ["NLHEAT_TUNE_BATCH"] = "1"
        try:
            def tuned():
                with ServePipeline(engine=engine(), depth=1, window_ms=0.0) as p, \
                        SessionManager(p, chunk_steps=SESSION_CHUNK) as mgr:
                    t = mgr.open(u0=u_t, nt=2 * SESSION_CHUNK, k=1.0, checkpoint_every=0,
                                 **kw_t)
                    mgr.drive(timeout_s=FLEET_WAIT)
                    return t.result(), dict(p.engine.report.strategies)

            tres, strategies = launches_of(ck, by, "18a tuned session", tuned)
        finally:
            del os.environ["NLHEAT_TUNE_BATCH"]
        same(tres, session_oracle(np, engine(), kw_t, u_t,
                                  session_plan(2 * SESSION_CHUNK, SESSION_CHUNK, 1.0))[-1],
             "(a) tuned")
        say(f"{card}: phase 18 (a) a {ENS_N}^2 session with NLHEAT_TUNE_BATCH=1: strategies "
                            f"{sorted(set(strategies.values()))}, launches "
                            f"{json.dumps(by['18a tuned session'])} (probes and winner), the "
                            f"session bitwise the per-step oracle")
        mark("a")

        # (d) a 3D session, 128^3, eps=4, in process
        n3, e3, nt3, c3 = SESSION3D
        dh3 = 1.0 / n3
        probe = NonlocalOp3D(e3, 1.0, 1.0, dh3)
        kw3 = dict(shape=(n3,) * 3, eps=e3, dt=0.8 / (probe.c * dh3 ** 3 * probe.wsum), dh=dh3)
        u3 = rng.standard_normal((n3,) * 3)

        def session_3d():
            with pipe() as p, SessionManager(p, chunk_steps=c3) as mgr:
                s3 = mgr.open(u0=u3, nt=nt3, k=1.0, preview_stride=SESSION_STRIDE,
                              checkpoint_every=0, **kw3)
                mgr.drive(timeout_s=FLEET_WAIT)
                return s3.frames_after(-1)

        frames3 = launches_of(ck, by, "18d session", session_3d)
        states3 = launches_of(ck, by, "18d oracle", lambda: session_oracle(
            np, engine(), kw3, u3, session_plan(nt3, c3, 1.0)))
        frames_ok(frames3, list(range(0, nt3 + 1, c3)), "(d)")
        for f, u in zip(frames3[:-1], states3, strict=True):
            same(f.values, u[::SESSION_STRIDE, ::SESSION_STRIDE, ::SESSION_STRIDE].astype(
                np.float32), f"(d) preview at step {f.step}")
        same(frames3[-1].values, states3[-1], "(d) final")
        if device == "cuda" and not (by["18d session"].get("nsum3d")
                                     or by["18d session"].get("step3d")):
            fail(f"phase 18 (d): the 3D session launched {by['18d session']}, no B9")
        say(f"{card}: phase 18 (d) a {n3}^3 eps={e3} f32 session, nt {nt3} in chunks "
                      f"of {c3}: bitwise the chunked oracle, launches "
                      f"{json.dumps(by['18d session'])}")
        mark("d")

        # the oracles of (b) and (c) in this process, before their legs start
        port = listen_port(*cli[:2], "phase 18 (b): solve2d --listen")
        router_c = boot_c.result()
        kw_b = dict(shape=(n_b, n_b), eps=EPS, dt=euler_dt(dh_b), dh=dh_b)
        ub = [rng.standard_normal((n_b, n_b)) for _ in range(3)]
        eng_b = EnsembleEngine(device=device)
        pool_b = concurrent.futures.ThreadPoolExecutor(4)
        pts, hh = jittered_cloud(np, MESH_SESSION[0], 2, SEED + 18, shuffle=True)
        mesh_body = {"points": pts.tolist(), "eps": 3 * hh, "vol": hh * hh}

        def leg_fleet() -> dict:
            # (b) sessions over the CLI's HTTP with a retarget, a fork and a
            # close, a worker SIGKILLed mid-session, a paced batch load beside
            body = lambda u: dict(shape=[n_b, n_b], nt=SESSION_NT, k=1.0, u0=u.tolist(),
                                  chunk_steps=FLEET_SESSION_CHUNK, preview_stride=SESSION_STRIDE,
                                  eps=EPS, dt=kw_b["dt"], dh=dh_b)
            out = {"batch": []}
            t0 = time.perf_counter()
            streams = {}

            def open_session(u, **more):
                code, r, _ = fleet_http(port, "POST", "/v1/sessions", dict(body(u), **more))
                if code != 201:
                    fail(f"phase 18 (b): open {code} {r}")
                streams[r["session"]] = pool_b.submit(
                    sse_frames, port, f"/v1/sessions/{r['session']}/stream"
                    f"?timeout_s={FLEET_WAIT}")
                return r["session"]

            def status(sid):
                return fleet_http(port, "GET", f"/v1/sessions/{sid}")[1]

            def wait_step(sid, step):
                deadline = time.monotonic() + FLEET_WAIT
                while (now := status(sid)["step"]) < step:
                    if time.monotonic() > deadline:
                        fail(f"phase 18 (b): session {sid} stuck before step {step}")
                    time.sleep(0.02)
                return now

            # session A: a retarget queued before its first chunk retires, and
            # one replica worker SIGKILLed while A runs (the rate gate paces it)
            a_sid = open_session(ub[0])
            out["ticket"] = fleet_http(port, "POST", f"/v1/sessions/{a_sid}/retarget",
                                       {"k": 0.75})[:2]
            out["killed_at"] = wait_step(a_sid, 2 * FLEET_SESSION_CHUNK)
            workers = worker_pids(cli[0].pid)
            if not workers:
                fail("phase 18 (b): no replica worker found under the CLI")
            os.kill(workers[0], signal.SIGKILL)
            b_sid = open_session(ub[1])
            closing = open_session(ub[2], nt=10 ** 6)
            opened = [a_sid, b_sid]

            def batch_load():
                case = {"shape": [n_b, n_b], "nt": FLEET_BATCH_STEPS, "eps": EPS, "k": 1.0,
                        "dt": kw_b["dt"], "dh": dh_b, "test": True}
                for i in range(FLEET_BATCH):
                    t = time.perf_counter()
                    code, r, _ = fleet_http(port, "POST", "/v1/cases", case)
                    if code == 202:
                        fleet_http(port, "GET", f"/v1/cases/{r['id']}?wait=1")
                    out["batch"].append((code, time.perf_counter() - t))
                    time.sleep(max(0.0, 1.0 / FLEET_BATCH_HZ - (time.perf_counter() - t)))

            loader = threading.Thread(target=batch_load, daemon=True)
            loader.start()
            wait_step(b_sid, 100)
            code_f, forked, _ = fleet_http(port, "POST", f"/v1/sessions/{b_sid}/fork",
                                           {"step": 100})
            if code_f != 201:
                fail(f"phase 18 (b): fork {code_f} {forked}")
            streams[forked["session"]] = pool_b.submit(
                sse_frames, port, f"/v1/sessions/{forked['session']}/stream"
                f"?timeout_s={FLEET_WAIT}")
            wait_step(closing, FLEET_SESSION_CHUNK)
            code_c, closed, _ = fleet_http(port, "POST", f"/v1/sessions/{closing}/close", {})
            out["streams"] = {sid: f.result() for sid, f in streams.items()}
            out["closed_frames"] = out["streams"].pop(closing)
            loader.join(timeout=FLEET_WAIT)
            out["wall"] = time.perf_counter() - t0
            out.update(closed=(code_c, closed), opened=opened,
                       forked=forked, closing=closing)
            out["status"] = {sid: status(sid) for sid in opened + [forked["session"], closing]}
            out["bin"] = {sid: np.load(io.BytesIO(fleet_http(
                port, "GET", f"/v1/sessions/{sid}/result?bin=1", raw=True)[1]))
                for sid in out["status"]}
            out["health"] = fleet_http(port, "GET", "/healthz")[1]
            snap = fleet_http(port, "GET", "/metrics.json")[1]
            out["session_metrics"] = {k: v for k, v in snap.items() if k.startswith("/session/")}
            return out

        def leg_mesh() -> dict:
            # (c) a mesh session over an in-process front door whose worker counts
            t0 = time.perf_counter()
            with SessionManager(router_c, chunk_steps=MESH_SESSION[2]) as mgr:
                mgr.start_driver()
                with IngressServer(0, router_c, sessions=mgr, mesh_dir=str(mdir)) as ing:
                    code, meta, _ = fleet_http(ing.port, "POST", "/v1/meshes", mesh_body)
                    if code != 201:
                        fail(f"phase 18 (c): mesh upload {code} {meta}")
                    os.environ["NLHEAT_MESH_DIR"] = str(mdir)
                    try:
                        mop = get_mesh_op(meta["hash"], 1.0, 1.0, device="cpu")
                    finally:
                        del os.environ["NLHEAT_MESH_DIR"]
                    mdt = 0.8 / float(np.max(mop.c * mop.wsum))
                    um = np.random.default_rng(SEED + 181).standard_normal(mop.n)
                    code, r, _ = fleet_http(ing.port, "POST", "/v1/sessions", {
                        "mesh": meta["hash"], "nt": MESH_SESSION[1], "k": 1.0, "dt": mdt,
                        "u0": um.tolist(), "preview_stride": SESSION_STRIDE})
                    if code != 201:
                        fail(f"phase 18 (c): open {code} {r}")
                    frames, end = sse_frames(ing.port, f"/v1/sessions/{r['session']}/stream"
                                             f"?timeout_s={FLEET_WAIT}")
                    raw = fleet_http(ing.port, "GET", f"/v1/sessions/{r['session']}/result"
                                     "?bin=1", raw=True)[1]
            return {"meta": meta, "dt": mdt, "u0": um, "frames": frames, "end": end,
                    "result": np.load(io.BytesIO(raw)), "wall": time.perf_counter() - t0}

        legs = {"b": pool.submit(leg_fleet), "c": pool.submit(leg_mesh)}
        b, c = legs["b"].result(), legs["c"].result()
        pool_b.shutdown(wait=True)
        mark("b, c")

        # (b) against its chunked oracles
        a_sid, b_sid = b["opened"]
        fork_sid, c_sid = b["forked"]["session"], b["closing"]
        applied = [e["applied_at_step"] for e in b["status"][a_sid]["audit"]
                   if e["verb"] == "retarget"]
        if b["ticket"][0] != 202 or len(applied) != 1 or not b["killed_at"] < SESSION_NT:
            fail(f"phase 18 (b): the retarget {b['ticket']}, applied at {applied}; the kill "
                 f"at step {b['killed_at']} of {SESSION_NT}")
        at = applied[0]
        boundaries = list(range(0, SESSION_NT + 1, FLEET_SESSION_CHUNK))
        plan_a = session_plan(SESSION_NT, FLEET_SESSION_CHUNK, 1.0, [(at, 0.75, None)])
        want_a = launches_of(ck, by, "18b oracle", lambda: session_oracle(
            np, eng_b, kw_b, ub[0], plan_a))
        want_b = launches_of(ck, by, "18b oracle b", lambda: session_oracle(
            np, eng_b, kw_b, ub[1], session_plan(SESSION_NT, FLEET_SESSION_CHUNK, 1.0)))
        c_step = b["status"][c_sid]["step"]
        want_c = launches_of(ck, by, "18b oracle closed", lambda: session_oracle(
            np, eng_b, kw_b, ub[2], session_plan(c_step, FLEET_SESSION_CHUNK, 1.0)))
        for sid, want, steps in ((a_sid, want_a, boundaries), (b_sid, want_b, boundaries),
                                 (fork_sid, want_b[4:], boundaries[4:])):
            frames, end = b["streams"][sid]
            frames_ok(frames, steps, f"(b) SSE of {sid}")
            if end is None or end["state"] != "done":
                fail(f"phase 18 (b): {sid}'s stream ended {end}")
            for f, u in zip(frames[:-1], want, strict=True):
                same(np.asarray(f["values"], np.float32).reshape(f["shape"]),
                     u[::SESSION_STRIDE, ::SESSION_STRIDE].astype(np.float32),
                     f"(b) {sid} preview at step {f['step']}")
            same(b["bin"][sid], want[-1], f"(b) {sid} result?bin=1")
        same(b["bin"][c_sid], want_c[-1], f"(b) the closed session at step {c_step}")
        frames, end = b["closed_frames"]
        frames_ok(frames, list(range(0, c_step + 1, FLEET_SESSION_CHUNK)), "(b) SSE closed")
        if end is None or end["state"] != "closed" or frames[-1]["step"] != c_step:
            fail(f"phase 18 (b): the closed session's stream ended {end}")
        stop_listen(*cli, "phase 18 (b): solve2d --listen")
        lm = json.loads(metrics_out.read_text())
        ckpts = sorted(p.name for p in sess_dir.iterdir())
        shed = sum(1 for code, _ in b["batch"] if code == 429)
        lat = sorted(t for code, t in b["batch"] if code == 202)
        p99 = float(np.percentile(lat, 99)) * 1e3 if lat else float("nan")
        deferrals = {sid: b["status"][sid]["deferrals"] for sid in b["status"]}
        if b["closed"][0] != 200 or b["closed"][1]["state"] != "closed" \
                or lm["deaths"] < 1 or f"{b_sid}@100.ckpt.npz" not in ckpts \
                or "sessions" not in b["health"]:
            fail(f"phase 18 (b): retarget {b['ticket']}, close {b['closed'][0]}, deaths "
                 f"{lm['deaths']}, checkpoints {ckpts}, health {b['health']}")
        say(
            f"{card}: phase 18 (b) solve2d --listen 0 --replicas 2 --session-checkpoint-every "
            f"2 --session-rate {FLEET_SESSION_RATE:g}: two {n_b}^2 eps={EPS} f32 sessions "
            f"(nt {SESSION_NT}, chunks of {FLEET_SESSION_CHUNK}) over HTTP, a retarget of k "
            f"applied at step {at}, a fork from the step-100 checkpoint, a third session "
            f"closed at step {c_step}; a worker SIGKILLed at step {b['killed_at']} (deaths "
            f"{lm['deaths']}, requeued {lm.get('requeued')}): every SSE stream complete, in "
            f"step order, no duplicate, every preview and result?bin=1 bitwise the chunked "
            f"oracle; deferrals {json.dumps(deferrals)}; the paced batch load "
            f"({FLEET_BATCH} x {FLEET_BATCH_STEPS} steps at {FLEET_BATCH_HZ:g}/s): shed "
            f"{shed}, p99 {p99:.1f} ms (client, POST to done); the CLI's session metrics "
            f"{json.dumps(b['session_metrics'])}; wall {b['wall']:.2f} s; "
            f"checkpoints {len(ckpts)} files; router cases {lm['cases']}")
        # (c) against its chunked oracle
        meta = c["meta"]
        mkw = dict(shape=(meta["nodes"],), eps=0, dt=c["dt"], dh=0.0, mesh=meta["hash"])
        os.environ["NLHEAT_MESH_DIR"] = str(mdir)
        try:
            want_m = launches_of(ck, by, "18c oracle", lambda: session_oracle(
                np, EnsembleEngine(device=device, dtype=f32), mkw, c["u0"],
                session_plan(MESH_SESSION[1], MESH_SESSION[2], 1.0)))
        finally:
            del os.environ["NLHEAT_MESH_DIR"]
        frames_ok(c["frames"], list(range(0, MESH_SESSION[1] + 1, MESH_SESSION[2])), "(c)")
        for f, u in zip(c["frames"][:-1], want_m, strict=True):
            same(np.asarray(f["values"], np.float32), u[::SESSION_STRIDE].astype(np.float32),
                 f"(c) preview at step {f['step']}")
        same(c["result"], want_m[-1], "(c) result?bin=1")
        mark("c checked")
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        if router_c is None and boot_c.done() and boot_c.exception() is None:
            router_c = boot_c.result()
        if router_c is not None:
            router_c.close()
        end_child(cli[0])
    workers = worker_counts(counts)
    for w in workers:
        if w["nvcc"]:
            fail(f"phase 18: worker {w['leg']}/{w['replica']} ran nvcc {w['nvcc']} times")
        by[f"{w['leg']} worker r{w['replica']} {w['transport']}"] = w["launches"]
    if device == "cuda" and not any(w["launches"].get("gather_L") for w in workers):
        fail(f"phase 18 (c): the mesh session's worker launched no gather_L: {workers}")
    say(f"{card}: phase 18 (c) a session over the shuffled {MESH_SESSION[0]}^2 "
                  f"cloud ({meta['nodes']} nodes, {meta['edges']} edges) registered by POST "
                  f"/v1/meshes, nt {MESH_SESSION[1]} in chunks of {MESH_SESSION[2]}, over an "
                  f"in-process front door: the SSE stream and result?bin=1 bitwise the chunked "
                  f"oracle; its worker's launches {json.dumps([w['launches'] for w in workers])}; "
                  f"wall {c['wall']:.2f} s")
    shutil.rmtree(tmp, ignore_errors=True)
    say(f"phase 18 legs end at, s: {json.dumps(walls)}")
    return by


def variant_launches(name: str, nsteps: int, ndim: int = 2) -> tuple:
    """(kernel, launches) of an nsteps run of the tuner's candidate ``name``
    for an ``ndim``-D solve."""
    if name == "per-step":
        return f"step{ndim}d", nsteps
    if name == "vmap":  # one nsum2d per case per step
        return "nsum2d", nsteps * ENS_B
    if name.startswith("batched-"):
        kernel, k = variant_launches(name[len("batched-"):], nsteps, ndim)
        return f"batched_{kernel}", k
    if name in ("carried", "carried3d"):
        return f"carried{ndim}d", nsteps
    if name in ("resident", "resident3d"):
        return f"resident{ndim}d", 1
    return "superstep2d", -(-nsteps // int(name[len("superstep"):]))


def record_launches(autotune, entry: dict, nsteps: int, ndim: int = 2, rounds: int = 1) -> dict:
    """The launches, by kernel, of a tuner record's probes (``rounds`` of
    each candidate) and of its winner's nsteps run."""
    out = {}
    for name in entry["ms_per_step"]:
        kernel, k = variant_launches(name, autotune.PROBE_STEPS, ndim)
        out[kernel] = out.get(kernel, 0) + rounds * (1 + autotune.PROBE_ITERS) * k
    kernel, k = variant_launches(entry["winner"], nsteps, ndim)
    out[kernel] = out.get(kernel, 0) + k
    return out


def launches_of(ck, by: dict, label: str, fn):
    """fn(), its launches (by kernel, the nonzero ones) put in by[label]."""
    before = ck.launch_counts()
    out = fn()
    by[label] = {k: v - before[k] for k, v in ck.launch_counts().items() if v != before[k]}
    return out


def by_label(by: dict, name: str) -> dict:
    """The launches of kernel ``name`` in each counted part of a run where it ran."""
    return {label: d[name] for label, d in by.items() if d.get(name)}


def device_profile(torch, fn, nsteps: int) -> dict:
    """One run of fn (nsteps steps) under torch.profiler after a warm-up
    run: per step, the device milliseconds of the kernels (the five
    largest by name, the rest summed), the window's milliseconds (CUDA
    events inside the profile) and the device's busy and idle share of it.
    Where the profiler records no device time, says so: not measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        a.record()
        fn()
        b.record()
        b.synchronize()
    window_us = a.elapsed_time(b) * 1e3
    kernels = {}  # the device's own events (kernels, copies), not the host ops above them
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            kernels[e.key] = kernels.get(e.key, 0.0) + us
    busy_us = sum(kernels.values())
    if busy_us == 0:
        return {"window_ms_per_step": window_us / 1e3 / nsteps,
                "device_time": "not measured (the profiler recorded no device time)"}
    named = {}  # by the name's first 60 characters (templates differ further on)
    for k, us in kernels.items():
        named[k[:60]] = named.get(k[:60], 0.0) + us
    top = sorted(named.items(), key=lambda kv: -kv[1])
    by_kernel = {k: us / 1e3 / nsteps for k, us in top[:5]}
    by_kernel["the rest"] = sum(us for _, us in top[5:]) / 1e3 / nsteps
    return {"window_ms_per_step": window_us / 1e3 / nsteps,
            "device_busy_ms_per_step": busy_us / 1e3 / nsteps,
            "busy_share": busy_us / window_us, "idle_share": 1 - busy_us / window_us,
            "by_kernel_ms_per_step": by_kernel}


def batched_carried_ab(torch, np, cb, buckets: dict) -> dict:
    """batched_carried2d (B7) in turns with batched_step2d (B6): B6, B7, B7,
    B6, each bucket's stack (``{label: [EnsembleCase]}``, eps=EPS, f32 and
    the bf16 tier) one step a launch, in a loop of launches and in a CUDA
    graph (the device alone: at 512^2 the host's cost per launch nears the
    kernel's), with B7's bound (the frames read once, the interiors written
    once).  B7 launches as its multi-step maker does, into a stack whose
    halos are already zero; the last timed launch of each, B7's interiors
    and whole frames, is then held bitwise to B6's and to B7's plain
    version."""
    import torch.nn.functional as F

    from nonlocalheatequation_torch.ops.nonlocal_op import NonlocalOp2D, case_scale

    out = {}
    for label, cases in buckets.items():
        U = torch.as_tensor(np.stack([c.u0 for c in cases]), device="cuda").to(torch.float32)
        ops = [NonlocalOp2D(c.eps, c.k, c.dt, c.dh, method="cuda") for c in cases]
        params = cb.case_params([case_scale(o) for o in ops], [o.dt for o in ops],
                                torch.float32, "cuda")
        wsum = ops[0].wsum
        frames = F.pad(U, (EPS,) * 4).contiguous()
        o6, o7 = torch.empty_like(U), torch.zeros_like(frames)  # B7 writes the interiors
        for prec in ("f32", "bf16"):
            pair = {"batched_step2d": lambda p=prec: cb.batched_step2d(U, EPS, params, wsum,
                                                                       precision=p, out=o6),
                    "batched_carried2d": lambda p=prec: cb._batched_carried2d(
                        frames, o7, EPS, params, wsum, p)}
            order = ("batched_step2d", "batched_carried2d", "batched_carried2d",
                     "batched_step2d")
            loop = turns_of(torch, pair, order, 200)
            graph = {n: [] for n in pair}
            for n in order:
                graph[n].append(graph_ms(torch, pair[n]))
            plain = cb.batched_carried2d_plain(
                frames, EPS, params, wsum, cb.shadow_of(frames) if prec == "bf16" else None)
            if not (torch.equal(o7[:, EPS:-EPS, EPS:-EPS], o6)
                    and torch.equal(o7, plain if prec == "f32" else plain[0])):
                fail(f"batched_carried2d {label} {prec}: its timed launches are not bitwise "
                     "batched_step2d's (interiors) and its plain version's (frames)")
            res = {
                "ms": sum(loop["batched_carried2d"]) / 2,
                "ms_graph": sum(graph["batched_carried2d"]) / 2,
                "batched_step2d_ms": sum(loop["batched_step2d"]) / 2,
                "batched_step2d_ms_graph": sum(graph["batched_step2d"]) / 2,
                "turns": loop, "turns_graph": graph,
                "bound_ms": bound((frames.numel() + U.numel()) * 4,
                                  U.numel() * kernel_ops(EPS, 5))[0]}
            if prec == "f32":
                out[label] = res
            else:
                out[label]["bf16"] = res
        del U, frames, o6, o7
    return out


def turns_of(torch, fns: dict, order, reps: int, warm: int = 3) -> dict:
    """{name: [ms per call, ...]}: cuda_ms of fns[name] for each name of
    ``order`` in that order (turns such as a, b, b, a)."""
    out = {n: [] for n in fns}
    for n in order:
        out[n].append(cuda_ms(torch, fns[n], reps, warm))
    return out


def graph_ms(torch, fn, launches: int = GRAPH_LAUNCHES, reps: int = 5) -> float:
    """Device milliseconds per call of fn: a CUDA graph of ``launches`` calls,
    replayed ``reps`` times, so the host's cost per launch is not in it."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(launches):
            fn()
    return cuda_ms(torch, graph.replay, reps, 1) / launches


def carried_launch(torch, ck, frame, eps: int, scale: float, wsum: float, dt: float,
                   precision: str = "f32"):
    """A call of one carried2d launch into an output frame made once, on
    either carried2d API: this tree's private launcher (its interior
    written into a frame whose halo stays zero; the bf16 tier rounds the
    master as it stages it), or the earlier public wrapper (the whole frame
    written; the bf16 tier a (master, bf16 shadow) pair), which --ab times
    on a parent tree's package."""
    out = torch.zeros_like(frame)
    if hasattr(ck, "_carried2d"):
        return lambda: ck._carried2d(frame, out, eps, scale, wsum, dt, precision)
    if precision == "f32":
        return lambda: ck.carried2d(frame, eps, scale, wsum, dt, out=out)
    shadow = ck.shadow_of(frame)
    out_shadow = torch.empty_like(shadow)
    return lambda: ck.carried2d(frame, eps, scale, wsum, dt, shadow=shadow, out=out,
                                out_shadow=out_shadow)


def kernels_ab(torch, ck, cb, u, eps: int, scale: float, wsum: float, dt: float,
               reps: int, bf16: bool = False) -> dict:
    """ms per launch of nsum2d (on u's zero-halo frame), the per-step,
    carried and superstep kernels and of batched_step2d at B=1 on u (with
    ``bf16``, step2d and carried2d in the bf16 tier too): as a replayed
    CUDA graph of launches (the device alone;
    at a small grid the host's cost per launch is larger than the kernel's)
    and in a loop of ``reps`` launches (CUDA events), each twice, in turns
    (the order, then the order reversed).  Returns {"graph": {name: [ms,
    ms]}, "loop": {...}}."""
    import torch.nn.functional as F

    out = torch.empty_like(u)
    frame = F.pad(u, (eps,) * 4).contiguous()
    one = u[None].contiguous()
    bout = torch.empty_like(one)
    params = cb.case_params([scale], [dt], u.dtype, u.device)
    runs = {"nsum2d": lambda: ck.nsum2d(frame, eps),
            "step2d": lambda: ck.step2d(u, eps, scale, wsum, dt, out=out),
            "carried2d": carried_launch(torch, ck, frame, eps, scale, wsum, dt),
            "batched_step2d B=1": lambda: cb.batched_step2d(one, eps, params, wsum, out=bout)}
    for k in (2, 3):
        runs[f"superstep2d K={k}"] = lambda k=k: ck.superstep2d(u, eps, scale, wsum, dt, k,
                                                                out=out)
    if bf16:
        runs["step2d bf16"] = lambda: ck.step2d(u, eps, scale, wsum, dt, precision="bf16",
                                                out=out)
        runs["carried2d bf16"] = carried_launch(torch, ck, frame, eps, scale, wsum, dt, "bf16")
    order = list(runs) + list(runs)[::-1]
    res = {"graph": {n: [] for n in runs}, "loop": {n: [] for n in runs}}
    for name in order:
        res["graph"][name].append(graph_ms(torch, runs[name]))
    for name in order:
        res["loop"][name].append(cuda_ms(torch, runs[name], reps))
    return res


def ab_line(shape: str, ab: dict) -> str:
    """The kernels_ab timings as one line, superstep also per step."""
    per_step = {n: [round(t / int(n[-1]), 6) for t in v]
                for n, v in ab["graph"].items() if n.startswith("superstep")}
    return (f"kernels at {shape} eps={EPS} f32, in turns (two runs each), ms/launch: in a CUDA "
            f"graph of {GRAPH_LAUNCHES} launches replayed {json.dumps(ab['graph'])}; in a loop "
            f"of launches {json.dumps(ab['loop'])}; superstep per step in the graph "
            f"{json.dumps(per_step)}")


def time_variants(torch, op, u, nsteps: int) -> dict:
    """ms/step of every candidate the tuner has for u's shape, each by CUDA
    events over one nsteps run after a warm-up run."""
    from nonlocalheatequation_torch.utils import autotune

    out = {}
    for name, maker in autotune.candidates(op, tuple(u.shape), nsteps, u.dtype, u.device):
        fn = maker(op, nsteps, u.dtype)
        out[name] = cuda_ms(torch, lambda fn=fn: fn(u, 0), 1, 1) / nsteps
    return out


LATTICE_SIDES = (256, 384, 512, 768, 1024)  # the solo planes of the lattice sweep


def op_2d(n: int):
    """The 2D operator on an n^2 unit square (dh = 1/n) at 0.8x the Euler
    bound, as bench.py and phase 4 make it."""
    from nonlocalheatequation_torch.ops.nonlocal_op import NonlocalOp2D

    dh = 1.0 / n
    probe = NonlocalOp2D(EPS, 1.0, 1.0, dh)
    return NonlocalOp2D(EPS, 1.0, 0.8 / (probe.c * dh * dh * probe.wsum), dh, method="cuda")


def lattice_sweep(torch, ck, cb) -> dict:
    """ms per launch in a CUDA graph of step2d and carried2d against
    batched_step2d and batched_carried2d at B=1 on one plane of each side
    of LATTICE_SIDES, eps=EPS, float32 and float64, in turns (solo,
    batched, batched, solo).  On a package whose solo kernels run the tile
    body and whose batched kernels the register walk at every lattice, this
    is where reg_tiles_too_few's threshold comes from; on this tree's the
    two run the same launches."""
    import torch.nn.functional as F

    out = {}
    for dtype in (torch.float32, torch.float64):
        for n in LATTICE_SIDES:
            u = torch.randn(n, n, device="cuda", dtype=dtype)
            frame = F.pad(u, (EPS,) * 4).contiguous()
            one, frames = u[None].contiguous(), frame[None].contiguous()
            o, bo, bfo = torch.empty_like(u), torch.empty_like(one), torch.zeros_like(frames)
            params = cb.case_params([1.0], [1e-3], dtype, "cuda")
            runs = {"step2d": lambda: ck.step2d(u, EPS, 1.0, 197.0, 1e-3, out=o),
                    "batched_step2d B=1": lambda: cb.batched_step2d(one, EPS, params, 197.0,
                                                                    out=bo),
                    "carried2d": carried_launch(torch, ck, frame, EPS, 1.0, 197.0, 1e-3),
                    "batched_carried2d B=1": lambda: cb._batched_carried2d(
                        frames, bfo, EPS, params, 197.0, "f32")}
            order = list(runs) + list(runs)[::-1]
            res = {name: [] for name in runs}
            for name in order:
                res[name].append(graph_ms(torch, runs[name]))
            if not (torch.equal(bo[0], o) and torch.equal(bfo[0, EPS:-EPS, EPS:-EPS], o)):
                fail(f"lattice sweep {dtype} {n}^2: the solo and B=1 launches differ")
            out[f"{str(dtype).split('.')[1]} {n}^2"] = res
    return out


def solve_ab(torch, np, reps: int = 3) -> dict:
    """The tuned 4096^2 eps=EPS f32 solve of STEPS steps
    (make_multi_step_fn: the first call tunes the shape and runs the
    winner, then ``reps`` runs timed by CUDA events) and the per-step loop
    (make_multi_step_fn_base, ``reps`` runs) at 4096^2 and 512^2, in ms per
    step: at 512^2 the loop runs at the host's pace, so a copy from the host
    per step shows there."""
    from nonlocalheatequation_torch.ops.nonlocal_op import (
        make_multi_step_fn,
        make_multi_step_fn_base,
    )
    from nonlocalheatequation_torch.utils import autotune

    out = {}
    for n in (NX, SMALL):
        op = op_2d(n)
        u = torch.as_tensor(np.random.default_rng(SEED).standard_normal((n, n)),
                            device="cuda").to(torch.float32)
        if n == NX:
            multi = make_multi_step_fn(op, STEPS, dtype=torch.float32)
            multi(u, 0)
            (entry,) = [v for k, v in autotune.records().items() if f"/{n}x{n}/" in k]
            out[f"tuned {n}^2"] = {"winner": entry["winner"], "probes": entry["ms_per_step"],
                                   "ms_per_step": [cuda_ms(torch, lambda: multi(u, 0), 1, 0)
                                                   / STEPS for _ in range(reps)]}
        loop = make_multi_step_fn_base(op, STEPS, dtype=torch.float32)
        out[f"per-step loop {n}^2"] = [cuda_ms(torch, lambda: loop(u, 0), 1, 1) / STEPS
                                       for _ in range(reps)]
    return out


def kernels3d_ab(torch, k3, case_scale, reps: int = 20) -> dict:
    """ms per launch of nsum3d (on the zero-halo frame), step3d and carried3d
    (the register design of stencil_tile3d.cuh) at N3^3, eps=EPS3 and at
    N3S^3, eps=EPS3S, f32: in a CUDA graph of 20 launches and in a loop of
    ``reps`` launches, each twice, in turns."""
    import torch.nn.functional as F

    out = {}
    for n, e in ((N3, EPS3), (N3S, EPS3S)):
        op = op_3d(n, e)
        u = torch.randn((n,) * 3, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(SEED + 25))
        frame = F.pad(u, (e,) * 6).contiguous()
        o, fo = torch.empty_like(u), torch.zeros_like(frame)
        scale = case_scale(op)
        runs = {"nsum3d": lambda: k3.nsum3d(frame, e),
                "step3d": lambda: k3.step3d(u, e, scale, op.wsum, op.dt, out=o),
                "carried3d": lambda: k3._carried3d(frame, fo, e, scale, op.wsum, op.dt)}
        order = list(runs) + list(runs)[::-1]
        res = {"graph": {k: [] for k in runs}, "loop": {k: [] for k in runs}}
        for name in order:
            res["graph"][name].append(graph_ms(torch, runs[name], 20))
        for name in order:
            res["loop"][name].append(cuda_ms(torch, runs[name], reps))
        out[f"{n}^3 eps={e}"] = res
    return out


def digest(t) -> str:
    """The first 16 hex digits of the sha256 of a tensor's bytes: two trees'
    outputs on the same inputs are bitwise equal where their digests are."""
    import hashlib

    return hashlib.sha256(t.cpu().contiguous().numpy().tobytes()).hexdigest()[:16]


HALO2D_FORMS = ((8, "float32", "f32"), (8, "float32", "bf16"), (16, "float32", "f32"),
                (17, "float32", "f32"), (8, "float64", "f32"))  # (eps, dtype, tier)
HALO2D_SMALL = (256, 512, 1024)  # the smaller square blocks of halo2d_ab, eps=DEPS


def ab_turns(torch, runs: dict, reps: int, launches: int = 20) -> dict:
    """ms per call of each of ``runs`` in a CUDA graph of ``launches`` calls
    and (reps > 0) in a loop of ``reps`` calls, each twice, in turns (the
    order, then the order reversed)."""
    order = list(runs) + list(runs)[::-1]
    res = {"graph": {n: [] for n in runs}}
    for name in order:
        res["graph"][name].append(graph_ms(torch, runs[name], launches))
    if reps:
        res["loop"] = {n: [] for n in runs}
        for name in order:
            res["loop"][name].append(cuda_ms(torch, runs[name], reps))
    return res


def halo2d_ab(torch, np, reps: int = 50) -> dict:
    """The 2D halo kernels at the main path's block, (0, 0) of a 2x2 mesh of
    virtual devices of the card holding a seeded DN^2 state: split_nsum2d
    on the block's exchanged frame and each of its phases alone, nsum2d on
    the same frame and fused_nsum2d on the block, for each of HALO2D_FORMS
    (eps=8 in float32 and the bf16 tier, eps=16 and 17 in float32, eps=8 in
    float64); ms per call in a CUDA graph of 20 calls and in a loop of
    ``reps``, each twice in turns.  Each output's digest, to hold two trees'
    outputs bitwise equal, and whether it is bitwise nsum2d on the frame.
    Then split_nsum2d (per call and each phase) and nsum2d on the frames of
    square blocks of HALO2D_SMALL sides, eps=DEPS, float32 and float64, in
    a CUDA graph only, with the digests: where a phase has few tiles."""
    import torch.nn.functional as F

    from nonlocalheatequation_torch.ops import cuda_halo as th
    from nonlocalheatequation_torch.ops import cuda_kernel as ck
    from nonlocalheatequation_torch.parallel.halo import halo_pad_nd
    from nonlocalheatequation_torch.parallel.mesh import create_mesh, device_list, put_global

    mesh = create_mesh(("x", "y"), (2, 2), device_list("cuda", 4))
    rng = np.random.default_rng(SEED + 27)
    u = rng.standard_normal((DN, DN))
    pos, out = (0, 0), {}

    def split_runs(frame, ob, e, prec):
        return {"split_nsum2d": lambda: th.split_nsum2d(frame, e, prec),
                "split_nsum2d interior": lambda: th.launch_phase("split_nsum2d", frame, ob, e,
                                                                 prec, "interior"),
                "split_nsum2d ring": lambda: th.launch_phase("split_nsum2d", frame, ob, e,
                                                             prec, "ring"),
                "nsum2d": lambda: ck.nsum2d(frame, e, prec)}

    for e, dname, prec in HALO2D_FORMS:
        dtype = getattr(torch, dname)
        blocks = put_global(u, mesh, dtype)
        frame = halo_pad_nd(blocks, e)[pos]
        ob = torch.empty(blocks[pos].shape, dtype=dtype, device="cuda")
        runs = {"fused_nsum2d": lambda: th.fused_nsum2d(blocks, pos, e, prec),
                **split_runs(frame, ob, e, prec)}
        one_pass = ck.nsum2d(frame, e, prec)
        res = {"digest": {"nsum2d": digest(one_pass)}, "bitwise_nsum2d": {}}
        for name in ("fused_nsum2d", "split_nsum2d"):
            got = runs[name]()
            res["digest"][name] = digest(got)
            res["bitwise_nsum2d"][name] = bool(torch.equal(got, one_pass))
        res.update(ab_turns(torch, runs, reps))
        out[f"{dname} {prec} eps={e}"] = res
        del blocks, frame, ob, one_pass
    for dtype in (torch.float32, torch.float64):
        for n in HALO2D_SMALL:
            frame = F.pad(torch.as_tensor(rng.standard_normal((n, n)), device="cuda").to(dtype),
                          (DEPS,) * 4).contiguous()
            ob = torch.empty((n, n), dtype=dtype, device="cuda")
            runs = split_runs(frame, ob, DEPS, "f32")
            got = runs["split_nsum2d"]()
            res = {"digest": {"split_nsum2d": digest(got),
                              "nsum2d": digest(runs["nsum2d"]())},
                   "bitwise_nsum2d": bool(torch.equal(got, runs["nsum2d"]()))}
            res.update(ab_turns(torch, runs, 0))
            out[f"{str(dtype).split('.')[1]} {n}^2 block eps={DEPS}"] = res
            del frame, ob
    return out


def dist2d_ab(torch, np, reps: int = 5) -> dict:
    """The DN^2, eps=DEPS, f32 solve on a 2x2 mesh of virtual devices of the
    card (2048^2 blocks), each comm form (the in-kernel exchange, 'fused'
    under NLHEAT_FUSED_TRANSPORT=interp, 'collective'), as phase 8 makes it:
    the digest of a DSTEPS-step solve, then ms per step over ``reps``
    DSTEPS-step runs (CUDA events; the host's loop binds them, so they
    spread), and the step's device time by kernel (torch.profiler), which
    the host does not move."""
    from nonlocalheatequation_torch.ops.nonlocal_op import NonlocalOp2D
    from nonlocalheatequation_torch.parallel.distributed2d import Solver2DDistributed
    from nonlocalheatequation_torch.parallel.mesh import device_list, make_mesh

    dh = 1.0 / DN
    probe = NonlocalOp2D(DEPS, 1.0, 1.0, dh)
    dt = 0.8 / (probe.c * dh * dh * probe.wsum)  # 0.8x the Euler bound, as phase 8
    u2 = np.random.default_rng(SEED + 22).standard_normal((DN, DN))
    devs4 = device_list("cuda", 4)
    out = {}
    for comm, transport in (("fused", ""), ("fused", "interp"), ("collective", "")):
        label = f"{comm} {transport}".strip()
        os.environ["NLHEAT_FUSED_TRANSPORT"] = transport
        s = Solver2DDistributed(DN // 2, DN // 2, 2, 2, DSTEPS, DEPS, k=1.0, dt=dt, dh=dh,
                                mesh=make_mesh(2, 2, devs4), method="cuda",
                                dtype=torch.float32, comm=comm)
        s.input_init(u2)
        res = {"digest": digest(torch.as_tensor(s.do_work()))}
        blocks = s._device_state()[0]
        run = s._make_runner(DSTEPS)
        res["ms_per_step"] = [cuda_ms(torch, lambda: run(blocks, 0, ()), 1, 1) / DSTEPS
                              for _ in range(reps)]
        res["profile"] = device_profile(torch, lambda: run(blocks, 0, ()), DSTEPS)
        out[label] = res
        del s, blocks, run
    os.environ.pop("NLHEAT_FUSED_TRANSPORT")
    return out


def halo3d_ab(torch, np, reps: int = 50) -> dict:
    """The 3D halo kernels at the main path's block, (0, 0, 0) of a 2x2x2
    mesh of virtual devices of the card holding a seeded D3N^3 state:
    fused_nsum3d, split_nsum3d on the block's exchanged frame, and each split
    phase alone, at eps=4 in float32 and the bf16 tier, eps=6 in float32 and
    eps=4 in float64; ms per call in a CUDA graph of 20 calls and in a loop of
    ``reps``, each twice in turns.  Each output's digest, to hold two trees'
    outputs bitwise equal, and whether it is bitwise nsum3d on the frame."""
    from nonlocalheatequation_torch.ops import cuda_halo as th
    from nonlocalheatequation_torch.ops import cuda_kernel3d as k3
    from nonlocalheatequation_torch.parallel.halo import halo_pad_nd
    from nonlocalheatequation_torch.parallel.mesh import create_mesh, device_list, put_global

    mesh = create_mesh(("x", "y", "z"), (2, 2, 2), device_list("cuda", 8))
    u = np.random.default_rng(SEED + 24).standard_normal((D3N,) * 3)
    pos, out = (0, 0, 0), {}
    for dtype, e, prec in ((torch.float32, 4, "f32"), (torch.float32, 4, "bf16"),
                           (torch.float32, 6, "f32"), (torch.float64, 4, "f32")):
        blocks = put_global(u, mesh, dtype)
        frame = halo_pad_nd(blocks, e)[pos]
        ob = torch.empty(blocks[pos].shape, dtype=dtype, device="cuda")
        runs = {"fused_nsum3d": lambda: th.fused_nsum3d(blocks, pos, e, prec),
                "split_nsum3d": lambda: th.split_nsum3d(frame, e, prec),
                "split_nsum3d interior": lambda: th.launch_phase("split_nsum3d", frame, ob, e,
                                                                 prec, "interior"),
                "split_nsum3d ring": lambda: th.launch_phase("split_nsum3d", frame, ob, e,
                                                             prec, "ring")}
        one_pass = k3.nsum3d(frame, e, prec)
        res = {"digest": {"nsum3d": digest(one_pass)}, "bitwise_nsum3d": {}}
        for name in ("fused_nsum3d", "split_nsum3d"):
            got = runs[name]()
            res["digest"][name] = digest(got)
            res["bitwise_nsum3d"][name] = bool(torch.equal(got, one_pass))
        order = list(runs) + list(runs)[::-1]
        res["graph"] = {n: [] for n in runs}
        res["loop"] = {n: [] for n in runs}
        for name in order:
            res["graph"][name].append(graph_ms(torch, runs[name], 20))
        for name in order:
            res["loop"][name].append(cuda_ms(torch, runs[name], reps))
        out[f"{str(dtype).split('.')[1]} {prec} eps={e}"] = res
        del blocks, frame, ob, one_pass
    return out


def dist3d_ab(torch, np, reps: int = 5) -> dict:
    """The D3N^3, eps=D3EPS, f32 solve on a 2x2x2 mesh of virtual devices
    of the card, each comm form (the in-kernel exchange, 'fused' under
    NLHEAT_FUSED_TRANSPORT=interp, 'collective'): the digest of a
    DSTEPS-step solve, then ms per step over ``reps`` DSTEPS-step runs (CUDA
    events; the host's loop binds them, so they spread), and the step's
    device time by kernel (torch.profiler), which the host does not move."""
    from nonlocalheatequation_torch.parallel.distributed3d import Solver3DDistributed
    from nonlocalheatequation_torch.parallel.mesh import device_list, make_mesh_3d

    op3 = op_3d(D3N, D3EPS)
    u3 = np.random.default_rng(SEED + 23).standard_normal((D3N,) * 3)
    devs8 = device_list("cuda", 8)
    out = {}
    for comm, transport in (("fused", ""), ("fused", "interp"), ("collective", "")):
        label = f"{comm} {transport}".strip()
        os.environ["NLHEAT_FUSED_TRANSPORT"] = transport
        s = Solver3DDistributed(D3N, D3N, D3N, DSTEPS, D3EPS, k=1.0, dt=op3.dt, dh=op3.dh,
                                mesh=make_mesh_3d(2, 2, 2, devs8), method="cuda",
                                dtype=torch.float32, comm=comm)
        s.input_init(u3)
        res = {"digest": digest(torch.as_tensor(s.do_work()))}
        blocks = s._device_state()[0]
        run = s._make_runner(DSTEPS)
        res["ms_per_step"] = [cuda_ms(torch, lambda: run(blocks, 0, ()), 1, 1) / DSTEPS
                              for _ in range(reps)]
        res["profile"] = device_profile(torch, lambda: run(blocks, 0, ()), DSTEPS)
        out[label] = res
        del s, blocks, run
    os.environ.pop("NLHEAT_FUSED_TRANSPORT")
    return out


RESIDENT_SIDES = (128, 256, 400, 512, 1024)  # the 2D planes of the resident section
RESIDENT_SHORT = 100  # the shorter run of the resident section's slope over nsteps
RESIDENT2D_RUNS = (32, 16, 8)  # the RUNs of resident2d's sweep (float64 has no 32)
_PICK_RUN = "int pick_run(int nx, int ny, int sms) {"  # in csrc/resident2d.cu
_STEP_BARRIER = "if (s + 1 < nsteps) grid.sync();"    # its register design's, the first


def resident_launch(torch, ck, u, eps: int, scale: float, wsum: float, dt: float,
                    nsteps: int, entry=None):
    """A call of one resident2d (2D u) or resident3d (3D u) launch of nsteps
    on frames made once, through a C entry point with no wrapper around it
    (the wrapper's frame copies are not in its time): this tree's, or
    ``entry``, a variant's nlheat_resident2d (resident2d_variants)."""
    fa = ck.resident_frame(u, eps)
    fb = torch.zeros_like(fa)
    code = ck._DTYPE_CODE[u.dtype]
    if entry is None:
        entry = ck._entry("nlheat_resident2d" if u.dim() == 2 else "nlheat_resident3d")
    args = (*u.shape, fa.shape[-1], eps, nsteps)

    def launch():
        rc = entry(code, fa.data_ptr(), fb.data_ptr(), *args, float(scale), float(wsum),
                   float(dt), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"resident launch {tuple(u.shape)} eps={eps}: status {rc}")

    launch.state = lambda: (fb if nsteps % 2 else fa)[tuple(slice(eps, eps + n)
                                                            for n in u.shape)]
    return launch


def bare_ms(torch, ck, u, args, steps: int, reps: int) -> dict:
    """ms of resident_launch: 1, RESIDENT_SHORT and ``steps`` steps a launch
    by CUDA events, in turns, and one step a launch in a CUDA graph of 20."""
    runs = {k: resident_launch(torch, ck, u, *args, k) for k in (1, RESIDENT_SHORT, steps)}
    out = turns_of(torch, runs, list(runs) + list(runs)[::-1], reps, 1)
    out["1 in a graph"] = [graph_ms(torch, runs[1], 20) for _ in range(2)]
    return out


def resident2d_variants(build) -> dict:
    """Scratch builds of csrc/resident2d.cu for resident_ab, for timing and
    never part of the package: "RUN=r", pick_run made to return r, for each
    r of RESIDENT2D_RUNS, and "no barrier", the register design's grid.sync()
    between steps deleted (its steps race: its output is not read).  The
    sources and libraries go to the package's _build/variants/, one nvcc
    each, all started together.  {name: nlheat_resident2d of the variant};
    {} where csrc/resident2d.cu has no pick_run (a parent tree)."""
    import ctypes
    import subprocess

    from nonlocalheatequation_torch.ops import cuda_kernel as ck

    text = (build.CSRC / "resident2d.cu").read_text()
    if _PICK_RUN not in text:
        return {}
    if _STEP_BARRIER not in text:
        fail("resident2d.cu: no grid.sync() between steps to take out")
    texts = {f"RUN={r}": text.replace(_PICK_RUN, f"{_PICK_RUN}\n  return {r};")
             for r in RESIDENT2D_RUNS}
    texts["no barrier"] = text.replace(_STEP_BARRIER, "", 1)
    where = build.BUILD_DIR / "variants"
    where.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, body in texts.items():
        src = where / f"resident2d_{name.replace('=', '').replace(' ', '_')}.cu"
        src.write_text(body)
        cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
               str(src.with_suffix(".so")), str(src)]
        jobs[name] = (src.with_suffix(".so"), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    entries = {}
    for name, (lib, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            fail(f"resident2d.cu variant {name} did not build:\n{log[-3000:]}")
        fn = ctypes.CDLL(str(lib)).nlheat_resident2d
        fn.argtypes, fn.restype = ck._ENTRIES["nlheat_resident2d"][1], ctypes.c_int
        entries[name] = fn
    return entries


def resident_ab(torch, np, reps: int = 5) -> dict:
    """The resident kernels on the package under test, in turns, against the
    same steps of carried2d/carried3d in a CUDA graph: resident2d at each side
    of RESIDENT_SIDES, eps=EPS, float32 and float64, STEPS and RESIDENT_SHORT
    steps a launch (the slope over nsteps is the step's time in the launch);
    resident3d at N3S^3 at eps=EPS3S and EPS3 in float32 and EPS3 in float64,
    TEST_STEPS and RESIDENT_SHORT steps; ms per launch by CUDA events, and
    each STEPS (TEST_STEPS) run's digest, to hold two trees bitwise equal.
    On this tree's package also each kernel's bare launch (resident_launch)
    of 1 step in a CUDA graph and of RESIDENT_SHORT and STEPS (TEST_STEPS)
    steps, and resident2d's variants (resident2d_variants), in turns: each
    RUN at STEPS steps, its output held bitwise to the package's, and the
    one without the barrier at 1, RESIDENT_SHORT and STEPS steps.  Then the
    tuned SMALL^2 and N3S^3, eps=EPS3S solves (make_multi_step_fn: the first
    call tunes the shape and runs the winner, then ``reps`` runs): winner,
    probes, ms per step."""
    import torch.nn.functional as F

    from nonlocalheatequation_torch.ops import _build
    from nonlocalheatequation_torch.ops import cuda_kernel as ck
    from nonlocalheatequation_torch.ops import cuda_kernel3d as k3
    from nonlocalheatequation_torch.ops.nonlocal_op import case_scale, make_multi_step_fn
    from nonlocalheatequation_torch.utils import autotune

    out = {}
    rng = np.random.default_rng(SEED + 26)
    bare = hasattr(ck, "resident_frame")
    variants = resident2d_variants(_build) if bare else {}
    for dtype, n in [(d, n) for d in (torch.float32, torch.float64) for n in RESIDENT_SIDES]:
        op = op_2d(n)
        args = (EPS, case_scale(op), op.wsum, op.dt)
        u = torch.as_tensor(rng.standard_normal((n, n)), device="cuda").to(dtype)
        frame = F.pad(u, (EPS,) * 4).contiguous()
        runs = {f"resident2d {k}": lambda k=k: ck.resident2d(u, *args, k)
                for k in (STEPS, RESIDENT_SHORT)}
        order = list(runs) + list(runs)[::-1]
        res = {"ms": turns_of(torch, runs, order, reps, 1),
               "digest": digest(ck.resident2d(u, *args, STEPS))}
        carried = carried_launch(torch, ck, frame, *args)
        res["carried2d graph ms"] = [graph_ms(torch, carried) for _ in range(2)]
        if bare:
            res["bare ms"] = bare_ms(torch, ck, u, args, STEPS, reps)
        if variants:
            vruns = {}
            for name, entry in variants.items():
                if name == f"RUN={RESIDENT2D_RUNS[0]}" and dtype == torch.float64:
                    continue
                for k in ((1, RESIDENT_SHORT, STEPS) if name == "no barrier" else (STEPS,)):
                    vruns[f"{name} {k}"] = resident_launch(torch, ck, u, *args, k, entry)
                if name != "no barrier":
                    once = resident_launch(torch, ck, u, *args, STEPS, entry)
                    once()
                    if digest(once.state()) != res["digest"]:
                        fail(f"resident2d {name} at {n}^2 {dtype}: not bitwise the package's")
            res["variants ms"] = turns_of(torch, vruns, list(vruns) + list(vruns)[::-1],
                                          reps, 1)
        out[f"{str(dtype).split('.')[1]} {n}^2 eps={EPS}"] = res
    for dtype, e in ((torch.float32, EPS3S), (torch.float32, EPS3), (torch.float64, EPS3)):
        op = op_3d(N3S, e)
        args = (e, case_scale(op), op.wsum, op.dt)
        u = torch.as_tensor(rng.standard_normal((N3S,) * 3), device="cuda").to(dtype)
        frame = F.pad(u, (e,) * 6).contiguous()
        fout = torch.zeros_like(frame)
        runs = {f"resident3d {k}": lambda k=k: k3.resident3d(u, *args, k)
                for k in (TEST_STEPS, RESIDENT_SHORT)}
        order = list(runs) + list(runs)[::-1]
        res = {"ms": turns_of(torch, runs, order, reps, 1),
               "digest": digest(k3.resident3d(u, *args, TEST_STEPS)),
               "carried3d graph ms": [graph_ms(torch, lambda: k3._carried3d(frame, fout, *args),
                                               20) for _ in range(2)]}
        if bare:
            res["bare ms"] = bare_ms(torch, ck, u, args, TEST_STEPS, reps)
        out[f"{str(dtype).split('.')[1]} {N3S}^3 eps={e}"] = res
    for label, op, shape, nsteps in ((f"tuned {SMALL}^2", op_2d(SMALL), (SMALL, SMALL), STEPS),
                                     (f"tuned {N3S}^3 eps={EPS3S}", op_3d(N3S, EPS3S),
                                      (N3S,) * 3, STEPS3)):
        u = torch.as_tensor(rng.standard_normal(shape), device="cuda").to(torch.float32)
        multi = make_multi_step_fn(op, nsteps, dtype=torch.float32)
        multi(u, 0)
        entry = autotune.records()[autotune.tuning_key(op, shape, torch.float32, "cuda")]
        out[label] = {"winner": entry["winner"], "probes": entry["ms_per_step"],
                      "ms_per_step": [cuda_ms(torch, lambda: multi(u, 0), 1, 0) / nsteps
                                      for _ in range(reps)]}
    return out


AB_SECTIONS = ("2d", "3d", "halo2d", "dist2d", "halo3d", "dist3d", "resident")


def ab_main(package_root: str, sections=AB_SECTIONS) -> int:
    """``python3 chip_smoke.py --ab DIR [SECTION ...]``: the A/B timings of
    this script on the package under DIR (a checkout of this tree, or of a
    parent tree unpacked into a git-ignored directory), as one JSON line:
    the card, then each section asked for (all by default): "2d" the kernels
    of phase 4 at 4096^2 (the bf16 tier too) and 512^2 (kernels_ab), the
    lattice sweep and the tuned and per-step solves (solve_ab); "3d" nsum3d,
    step3d and carried3d at 256^3 and 128^3 eps=6 (kernels3d_ab); "halo2d"
    the 2D halo kernels at the 2048^2 block and split_nsum2d at smaller
    blocks (halo2d_ab); "dist2d" the 4096^2 2x2 steps (dist2d_ab); "halo3d"
    the 3D halo kernels at the 128^3 block (halo3d_ab); "dist3d" the 256^3
    2x2x2 steps (dist3d_ab); "resident" the resident kernels against carried2d/carried3d
    and the tuned 512^2 and 128^3 eps=6 solves (resident_ab).  Run it for
    two trees in turns in one call (parent, this, this, parent) to compare
    them on one card."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the A/B timings need a CUDA card")
    unknown = set(sections) - set(AB_SECTIONS)
    if unknown:
        fail(f"--ab: unknown sections {sorted(unknown)}; known: {AB_SECTIONS}")
    root = str(Path(package_root).resolve())
    sys.path.insert(0, root)
    from nonlocalheatequation_torch.ops import _build
    from nonlocalheatequation_torch.ops import cuda_batched as cb
    from nonlocalheatequation_torch.ops import cuda_kernel as ck
    from nonlocalheatequation_torch.ops import cuda_kernel3d as k3
    from nonlocalheatequation_torch.ops.nonlocal_op import case_scale

    if not ck.__file__.startswith(root):
        fail(f"--ab {package_root}: imported {ck.__file__}, not the package under it")
    os.environ["NLHEAT_AUTOTUNE_CACHE"] = ""
    t0 = time.perf_counter()
    card = nvidia_smi("name,power.limit")
    sources = (_build.SOURCES_2D if {"2d", "halo2d", "dist2d", "resident"} & set(sections)
               else ()) + (
        _build.SOURCES_3D if {"3d", "halo3d", "dist3d", "resident"} & set(sections) else ()) + (
        _build.SOURCES_HALO if {"halo2d", "dist2d", "halo3d", "dist3d"} & set(sections) else ())
    built = _build.build(sources)
    res = {"package": root, "card": card, "build_s": built}
    if "2d" in sections:
        for n, reps, bf16 in ((NX, 50, True), (SMALL, 200, False)):
            op = op_2d(n)
            u = torch.as_tensor(np.random.default_rng(SEED).standard_normal((n, n)),
                                device="cuda").to(torch.float32)
            res[f"kernels {n}^2"] = kernels_ab(torch, ck, cb, u, EPS, case_scale(op), op.wsum,
                                               op.dt, reps, bf16=bf16)
        res["lattice"] = lattice_sweep(torch, ck, cb)
        res["solves"] = solve_ab(torch, np)
    if "3d" in sections:
        res["kernels 3d"] = kernels3d_ab(torch, k3, case_scale)
    if "halo2d" in sections:
        res["halo2d"] = halo2d_ab(torch, np)
    if "dist2d" in sections:
        res["dist2d"] = dist2d_ab(torch, np)
    if "halo3d" in sections:
        res["halo3d"] = halo3d_ab(torch, np)
    if "dist3d" in sections:
        res["dist3d"] = dist3d_ab(torch, np)
    if "resident" in sections:
        res["resident"] = resident_ab(torch, np)
    res["wall_s"] = time.perf_counter() - t0
    say(f"ab: {json.dumps(res)}")
    return 0


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"numpy and torch are required: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    try:
        from nonlocalheatequation_torch.ops import _build
        from nonlocalheatequation_torch.ops import cuda_batched as cb
        from nonlocalheatequation_torch.ops import cuda_kernel as ck
        from nonlocalheatequation_torch.ops import cuda_kernel3d as k3
    except ImportError as e:
        fail(f"the port package nonlocalheatequation_torch is not beside this script: {e}")
    cases_2d, cases_1d, l2_threshold = load_cases()
    # the default production path: tuned on the card, records kept in this
    # process only (nothing written outside the checkout)
    os.environ.pop("NLHEAT_TUNE_PRECISION", None)
    os.environ.pop("NLHEAT_TUNE_METHOD", None)
    os.environ["NLHEAT_AUTOTUNE_CACHE"] = ""
    t_start = time.perf_counter()

    say(nvidia_smi("name,power.limit"))
    say(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    built = _build.build(_build.ALL_SOURCES)
    say(f"build: {time.perf_counter() - t0:.1f} s ({json.dumps(built)})")
    for source in _build.ALL_SOURCES:
        log = _build.library_path(source).with_suffix(".log")
        if log.exists():
            text = log.read_text()
            regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers", text)})
            spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", text))
            say(f"ptxas {source}: {len(re.findall('Compiling entry', text))} kernels, "
                f"registers per thread {regs}, spill stores {spills} bytes")

    walls = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = round(time.perf_counter() - t0, 1)
        return out

    atexit.register(stop_children)
    clis = start_clis(cases_2d, cases_1d)
    async_cli = start_async_cli()
    uclis = start_unstructured_clis()
    checks = timed("checks 2d", phase_checks, torch, ck, np)
    checks.update(timed("multi-step checks 2d", phase_multistep_checks, torch, ck, np))
    for name, count in timed("solo checks 2d", phase_solo_checks, torch, ck, np).items():
        checks[name] += count
    checks.update(timed("checks 3d", phase_checks_3d, torch, k3, np))
    checks.update(timed("batched checks", phase_batched_checks, torch, ck, cb, np))
    checks.update(timed("unstructured checks", phase_unstructured_checks, torch, np))
    checks.update(timed("halo checks", phase_halo_checks, torch, np))
    timed("tables", phase_main_path_tables, torch, clis, cases_2d, l2_threshold)
    timed("unstructured cli", phase_unstructured_cli, uclis, l2_threshold)
    kernels = timed("headline 2d", phase_headline, torch, np, ck, cb, l2_threshold)
    kernels += timed("headline 3d", phase_headline_3d, torch, np, ck, k3, l2_threshold)
    kernels += timed("ensemble", phase_ensemble, torch, np, ck, cb, cases_2d)
    kernels += timed("unstructured", phase_unstructured, torch, np, ck, l2_threshold)
    halo_rows, halo_by = timed("distributed", phase_distributed, torch, np, ck, l2_threshold)
    for k in kernels:  # nsum2d/nsum3d run phase 8's collective steps (and CLI rows) too
        more = by_label(halo_by, k["name"])
        if more:
            k["launches"] += sum(more.values())
            k.setdefault("launches_by_shape", {}).update(more)
    kernels += halo_rows
    async_by = timed("async, logs, checkpoints", phase_async_logs, torch, np, ck, l2_threshold,
                     async_cli)
    elastic_by = timed("elastic", phase_elastic, torch, np, ck, l2_threshold)
    stepper_by = timed("steppers, spectral", phase_steppers, torch, np, ck, k3, l2_threshold)
    dist_by = timed("distributed steppers, sharded", phase_dist_steppers, torch, np, ck, k3,
                    l2_threshold)
    mh_by = timed("blocks owned by ranks", phase_multihost, torch, np, ck, l2_threshold)
    serve_by = timed("serving", phase_serve, torch, np, ck, cases_2d, cases_1d, l2_threshold)
    fleet_by = timed("fleet leaves", phase_fleet_leaves, torch, np, ck, cases_2d, built)
    front_by = timed("fleet front door", phase_front_door, torch, np, ck, l2_threshold)
    sess_by = timed("sessions", phase_sessions, torch, np, ck)
    for k in kernels:  # phases 10-18 launch the kernels of phases 4-8 again
        for part in (async_by, elastic_by, stepper_by, dist_by, mh_by, serve_by, fleet_by,
                     front_by, sess_by):
            more = by_label(part, k["name"])
            if more:
                k["launches"] += sum(more.values())
                k.setdefault("launches_by_shape", {}).update(more)
    say(f"phase walls, s: {json.dumps(walls)}")
    for k in kernels:
        k["checks"] = checks[k["name"]]
    say(f"total: {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ab"]:
        sys.exit(ab_main(sys.argv[2], sys.argv[3:] or AB_SECTIONS))
    if sys.argv[1:2] == ["--mh-rank"]:
        sys.exit(mh_rank_main(sys.argv[2], int(sys.argv[3]), int(sys.argv[4])))
    if sys.argv[1:2] == ["--accept"]:
        sys.exit(accept_main(int(sys.argv[2])))
    if sys.argv[1:2] == ["--fleet-child"]:
        sys.exit(fleet_child_main(sys.argv[2]))
    if sys.argv[1:2] == ["--fleet-worker"]:
        sys.exit(fleet_worker_main(sys.argv[2] if len(sys.argv) > 2 else None))
    sys.exit(main())
