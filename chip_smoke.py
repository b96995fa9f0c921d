#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``photon_ml_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --time-re-update CHECKOUT [CHECKOUT ...]

The second form only times run P's replicated random-effect update in
each checkout in turn, each with its own package (e.g. parent, change,
change, parent, with the parent unpacked by ``git archive``), then the
kernel's products at run G's first bucket where the checkout has it.

Phases, each printing its own lines:

1. device: the card's name and power limit (nvidia-smi), and the builds of
   the CUDA kernels K1, K2 and K4 (nvcc, sm_90a, side by side) and of the
   native schedule builder and Avro decoder (g++);
2. K1, the bilinear pass, and K2, its grid form over a [G, d] bank,
   against their plain PyTorch versions on the card: at a small shape
   (forced spills, ragged tiles; K2 for G = 1, 3, 4, 5, 7, 9), at the work
   plan's edge cases (a pass with fewer steps than the card's CTA slots,
   an output block of one step, a chunk that is not a multiple of 4, a
   row with many entries in one block; each without a NaN in the source,
   with one where a nonzero entry reads, and with one at the first slot
   of a window that a padded step reads, held against the real entries;
   and an output block without steps) and at the ads shape (2^18 rows x
   64 nnz x 2^20 features; K2 for G = 4, also against 4 launches of K1):
   z-pass, g-pass and the g-pass over squared values;
3. times at the ads shape (CUDA events over 50 launches queued behind a
   sleep, so they are the card's and not the wrappers'): K1 beside its
   plain version and one torch.sparse CSR matvec of the same X; K2 at
   G = 4 beside its plain version, the CSR product with the bank (SpMM)
   and 4 launches of K1; K3, the spill remainder, folded into K1 and K2:
   each ads pass with and without its spill, in turns, and the time the
   fold adds, beside ``index_add_`` of the spilled products, for a vector
   and for the bank (the fused passes bitwise the unfused launch followed
   by ``spill_ordered`` at the small and ads shapes, and within RTOL of
   ``index_add_``); each with its bound, and each pass's launch
   plan (CTAs, entries per work item, resident CTAs per SM) and share of
   its bound. The CSR calls are yardsticks the port never makes;
4. the sequential path at full width on planted-model logistic data: the
   warm-started L-BFGS lambda-grid [10, 1] with variances and a TRON fit
   through ``train_generalized_linear_model(kernel="tiled")``, then scores
   and AUC, with K1's launches over exactly that run, the passes that
   carried the spill remainder (K1's launches that folded it in),
   and K4's row launches (the optimizers' member-wise dots and norms);
   then K4's row_dot, row_norm and row_dots (four pairs) at the bank's
   shape [2, 2^20] (one launch each: a row's CTAs merged by tickets),
   bitwise their row_sum forms, within 1e-5 of .sum's and vector_norm's
   scale, timed beside them and torch.linalg.vecdot / vector_norm;
5. the batched grid path at full width on the same data, through
   ``train_grid_batched(kernel="tiled")``: L-BFGS over [10, 1, 0.1, 0.01]
   with variances, TRON over [10, 1] and OWL-QN elastic net over [1, 0.1],
   with K2's, K1's and K4's row launches and the host fetches over
   exactly each run, and K4's row kernel checked and timed at the grid's
   bank [4, 2^20] as in phase 4;
   then the bank objective against K1's objective at every L-BFGS
   member's final point, each L-BFGS member against a cold sequential
   fit of its lambda, the batched L-BFGS grid's seconds against the
   warm-started sequential grid's over the same lambdas, in turns, and
   both grids under torch.profiler (``tools/profile_grid.py``: device
   busy time and idle share); then ``GLMOptimizationProblem.run_grid(
   offsets_bank=)`` on the tiled objective at the mesh cell's shape
   (2^17 rows x 2^19 features of the same data, nonzero offsets), G = 4:
   a bank repeating the batch's offsets gives the plain ``run_grid``'s
   bits, on K2 alone, and K2 on that batch against its plain version;
6. the mesh path: a 2 x 2 (data, model) mesh of 4 spawned ranks on the
   card (gloo), each holding one cell of the same data: K1 and K2 against
   their plain versions on every cell, the cell-shape times (rank 0, the
   others idle; warm and with the L2 flushed before each launch) and
   plans, the mesh objective against the single-card one, then
   ``train_feature_sharded`` (L-BFGS over [10, 1] with variances, TRON at
   1), ``train_grid_batched_feature_sharded`` (L-BFGS over the four grid
   lambdas) and the data-parallel ``train_generalized_linear_model(mesh=)``
   on a 4-rank data mesh, each against phase 4's or 5's fit of its lambda,
   with every rank's launches, host fetches, collectives and seconds; then
   the TRON fit twice more with ``tile_cache_dir`` and ``track_models``:
   every rank stores its cell cold and loads it warm, the warm fit equals
   the cold one and each fit has one per-iteration model per iterate. Four
   ranks share one card and gloo stages each collective through the host:
   this checks the path and counts it; it measures no scaling;
7. the GLM driver end to end through its CLI entry point,
   ``photon_ml_tpu_torch.cli.glm_driver.main(argv)``, over LibSVM files
   the script writes (2^13 training rows in 4 files and 2^13 validation
   rows at the ads width, planted-model labels from the seed), with the
   intercept: run A, the warm-started sequential L-BFGS grid [10, 1] with
   variances (K1) and a cold ``--tile-cache-dir``; run B, the same with
   ``--grid-mode batched`` (K2), the cache now warm. Each run's stage
   timers, launches and cache counters; the written outputs, the models
   read back, each lambda's held-out AUC in metrics.json against the AUC
   of the written model, run B's train schedule from the cache, and A's
   and B's objective at each lambda (float64, by its definition) within
   1e-4 of ``train_generalized_linear_model(kernel="tiled")``'s on the
   batch the port's LibSVM loader gives, with a wrong model as the
   control; the direct fit repeated on the same batch, sequential (K1)
   and batched (K2), bitwise. Each lambda's stop reason and gradient
   max-abs for A, B and the direct fit: a fit that stops for another
   reason than convergence or its budget with 10x the others' gradient
   fails. Then run D over
   run A's files: ``feature_indexing_driver.main`` builds the off-heap
   index store (checked against the files' keys and run A's index map),
   and ``glm_driver.main`` trains at lambda = 1 over it (K1) with
   ``--validate-per-iteration true --diagnostic-mode ALL``: one
   per-iteration metric per iterate ending at the final model's, the HTML
   report with every chapter and section and only finite numbers, the
   bootstrap and fitting refits through K1, and the objective within 1e-4
   of run A's. Then run C, run A with ``--intercept false`` and no
   validation, whose lambda = 1 model must be within 1e-4 of the direct
   trainer's on that batch without its intercept column, with
   ``--obs-dir`` (trace, flight and snapshot files, a span per lambda
   solve) and ``--profile-dir`` (a ``torch.profiler`` trace listing each
   of K1's launches by the kernel's name);
8. GAME (``photon_ml_tpu_torch.game``): run G, the JAX package's config-4
   GLMix through the coordinate API on rows both coordinates share (100,000
   users x 16 rows; a global shard of 2^20 features, 64 a row and the
   intercept; a user shard of 32 a row from each user's pool of 1,000 ids,
   INDEX_MAP-projected, banks cut into buckets of 25,000 entities as
   bench.py cuts them): ``CoordinateDescent.run(2)`` with the fixed effect
   on ``create_glm_problem(kernel="tiled")`` (K1; L-BFGS, L2 1, 50
   iterations) and the user random effect (L-BFGS config, L2 1, 30
   iterations, history 5, tolerance 1e-5; the dense Newton solver), each
   sweep's seconds of FE fit, RE update and scores, the FE's iterations
   and K1 launches, one schedule build over both sweeps (the in-memory
   ``ensure_tiled`` tier), the RE tracker, a non-increasing objective,
   the float64 gradient of 256 sampled entities under its limit, the
   scatter densification against compare-and-reduce on one bucket, K4
   (the per-entity products in row_sum's order) on the first bucket as
   the Newton solver calls it (the Gram, X c, X^T r, G r, and the row
   dots and norms of [E, S] values and [E, D] rows), each bitwise its
   row_sum form and within 1e-5 of its plain version's scale (torch.bmm,
   .sum, vector_norm), timed beside it, the library call and its bound,
   K4's launches over the two sweeps by wrapper (each at least one), the
   bucket witness (the first bucket cut to 8,192 entities solved whole
   and as padded blocks of 4,130 and 2,777 by the dense Newton solver,
   dense L-BFGS and TRON: the shared entities' rows, iterations and
   reasons bitwise; the first 512 entities' card rows against a float64
   solve on the host, each entity's float64 objective within the
   solver's tolerance of |f(0)| of the float64 row's), the
   device memory peak, the tiled objective against the scatter objective
   at each sweep's fixed-effect coefficients (value 1e-5, gradient 1e-4),
   K1 against its plain version at that shape (each output within 1e-5
   of its addends' magnitude) and its pass times beside its plain
   version's and one torch.sparse CSR matvec's, a profiled warm sweep
   (device busy and idle share), and the same two sweeps with the fixed
   effect on the scatter objective (non-increasing; its CD objectives
   beside the tiled run's are printed, a measurement: the two paths sum
   in other orders); on either path a refit of sweep 2's fixed effect
   from the start and residual it got is the run's, bitwise; and both
   paths' refits of the tiled run's sweep-2 fixed effect (the same start
   and residual) with a cap of 500 iterations, at the default tolerance
   (printed) and stopping below float32's resolution of the objective
   (tolerance 1e-10; the cap not reached): their objectives within 1e-4;
   then run H, the GAME
   drivers' CLI entry points, ``game_training_driver.main`` (2^13
   training rows of 512 users at run G's widths, as Avro written in
   worker processes; FE lambda grid [10, 1], 2 iterations, AUC,
   variances, BEST) and ``game_scoring_driver.main`` over the 2^13
   validation rows: the output tree, a non-increasing objective, and the
   scoring AUC equal to the training driver's validation AUC within 1e-6;
9. the factored random effect, MF and the reliability layer: run F, run
   G's rows and fixed effect (K1, its schedule from the in-memory tier)
   with the user random effect factored (IDENTITY-projected user shard,
   latent dimension 8, one inner iteration, L-BFGS 30 iterations for the
   latent banks and the projection fit) through
   ``CoordinateDescent.run(2)``: per sweep the FE, bank and projection-fit
   seconds and the readbacks (one a sweep), the projection problem's
   dimension and held entries, the device memory peak, a non-increasing
   objective, and the scores within 1e-5 of a float64 recomputation
   from the bank, B and the rows; run M, ``MatrixFactorizationCoordinate``
   at MovieLens-20M entity counts (bench.py's settings: 138,493 x 26,744,
   K = 32, 2,000,000 ratings from the seed, LINEAR, L2 1, L-BFGS 20),
   uninterrupted for two sweeps, then with a ``TrainingCheckpointer`` and
   an installed ``PreemptionGuard``: a SIGTERM to the process in sweep 1
   stops the run after it, a new run resumes from the checkpoint (its
   factors bitwise the checkpoint's) and ends within 1e-6 of the
   uninterrupted objective, and 1,000 sampled row and column entities
   each within 1e-4 of a float64 CPU solve of their own objective; run R,
   run A's argv with ``--checkpoint-dir`` and a fault plan that kills the
   driver (SIGKILL) in lambda = 1's snapshot, in a subprocess, then the
   same argv through ``glm_driver.main``: lambda = 10 from its snapshot
   (bitwise, no K1 launch), lambda = 1 warm-started from the snapshotted
   means, both lambdas' models bitwise run A's (the kill -9 resume is
   bitwise on the card: K1, K2 and K3 add in a fixed order), and the
   reliability block of metrics.json;
10. out-of-core training: run S, ``glm_driver.main`` with ``--streaming
   true --stream-memory-budget 1048576`` over 2^13 x 64 x 2^20 rows
   (phase 4's planted model) in 8 Avro part files written by worker
   processes, with 2^12 validation rows: the L-BFGS grid [10, 1] with
   variances, the intercept, streamed validation and a cold
   ``--scan-cache-dir`` (5 chunks of 1,971 rows: 1 on the device tier,
   4 spilled, all 5 in K1's tiled cache); each lambda's float64 objective
   within 1e-4 of ``train_generalized_linear_model(kernel="tiled")`` on
   the batch the port's Avro loader gives (a wrong model as the
   control), the streamed AUC within 1e-3 of the
   written model's exact AUC, one decode pass to fill the tiers; then a
   direct ``StreamingGLMObjective``: value and gradient (and Hv, Hdiag)
   against the in-memory tiled objective (1e-5, 1e-4 of the scale), K1
   launches of 2 x tiled chunks per value+gradient, and the same with a
   tiled cache of 2 chunks and 3 on the scatter overflow; K1 checked and
   timed at the chunk shape beside its bound, its plain version and one
   torch.sparse CSR matvec of the chunk's X; then run S2, the same
   files with the scan cache warm (every partition cached, the same map
   and stats), TRON at lambda = 1 and ``--diagnostic-mode ALL`` over the
   reservoir (every chapter, finite numbers). Printed: stage timers, tier
   counts, spill bytes, host RSS growth in training against the staged
   bytes, the device memory peak, host fetches per iteration;
11. online serving (``photon_ml_tpu_torch.serving``): run V, the JAX
   package's on-chip serving configuration (bench.py:1971-1976: a [2^20]
   fixed effect with 64 features a request and 600,000 users x 1,000
   with 32, from ``bank_from_arrays``, ~2.40 GB on the card, the native
   row index), the ladder (1, 8, 64, 256) captured as CUDA graphs (one
   capture a rung, none after), 2,000 requests closed-loop (every
   dispatch shape 1) and 20,000 open-loop at concurrency 32 (p50, p99,
   mean, QPS, dispatches, shape counts, occupancy, pad waste, one
   readback a dispatch), the host costs of a dispatch apart from each
   rung's replay on the card, a profiled open loop (device busy and idle
   share), 4,096 served scores bitwise against the batch algebra at n =
   4,096, and a generation 2 from the seed swapped in place in the middle
   of an open loop (no capture, none lost, each score bitwise its
   generation's); run W, inside run H's directory (phase 8):
   ``serving_driver.main`` closed over run H's first validation part
   (2,048 rows; written scores bitwise run H's ``game_scoring_driver``
   scores, the AUC equal to the evaluator's over those scores) and open
   at concurrency 8 over all the validation rows twice with a hot swap
   after the first half of them (both generations serve), then the
   driver's front end (``--frontend-port 0``) in a subprocess: 400 of
   the rows on 4 connections, status ops, a SIGTERM drain (every request
   a named outcome, the scores bitwise, exit 0, no leaked connection);
12. the serving fleet (``serving/routing.py``, ``serving/shard_server.py``,
   ``obs/``): run Y, the serving driver's fleet modes over run H's files
   (kept from phase 8): two ``--shard-index`` driver processes on the card
   (shard 0 with ``--obs-dir`` and ``--profile-dir``) and a router driver
   process (``--wire binary --fleet-obs-dir --slo default
   --swap-model-dir``) replaying run H's first validation part (2,048
   rows) closed-loop: routed scores bitwise run W's single server, the
   AUC equal, the two-step flip landed, the fleet trace verified and the
   fleet books balanced, CUDA kernels in shard 0's profile, no CUDA
   context in the router; then run X, the JAX package's
   chip-class routing shapes (bench.py:2328-2340: 200,000 users x 256, a
   2^18 fixed effect, 32 and 16 features a request, the shard ladder (1,
   8, 64)): fleets of 1, 2 and 4 shard-server children of this script
   (7 processes on the one card, each 1/N of the random-effect bank from
   the seed), each flooded open-loop with 4,000 zipf(1.3) requests (4
   payloads an entity) from 32 threads, then at N = 4 the fleet-wide
   two-step swap under load and 2,000 cache-missing requests with child 3
   SIGKILLed a quarter in: every routed score bitwise an in-process single
   server's over the whole bank of its generation, degraded rows bitwise
   their FE-only score plus the offset, outcomes conserved, no capture
   after warmup in any child; aggregate QPS, router latency and fan-out
   p50 / p99, cache hit rate and the router's host CPU a request per N,
   and routed N = 1 against the single in-process server;
13. the model registry and the determinism harness (``registry/``,
   ``testing/determinism.py``): run L, the JAX package's retrain
   configuration (bench.py:3572-3573: 8 Avro parts x 4,000 rows from a
   planted model, d = 2,000, 12 nonzeros a row, 4,000 validation rows,
   L-BFGS at lambda 1, 30 iterations), through the GLM driver streamed
   with ``--scan-cache-dir --retrain-from R --publish-registry R``: L1
   cold publishes generation 1; L2 after a 1% append scans one
   partition, warm-starts bitwise from generation 1's coefficients and
   publishes generation 2 (gates PASS, lineage [2, 1]); L3 after a
   label-flipped flood as large as the base is refused with
   AUC_REGRESSION (generations stay [1, 2], the refusal on record). Run
   Q, the GAME loop behind a live server over run H's files (kept from
   phase 8, whose training driver published generation 1 with
   ``--publish-registry``): a serving driver process follows the
   registry (``--registry-dir --registry-poll-s 0.3 --rollback-window 16
   --rollback-min-requests 6 --rollback-max-unhealthy 0.5``) while a
   client thread scores run H's first validation part closed-loop; the
   GAME training driver retrains from generation 1 over the training
   rows plus a part holding a new user (drift: the user at the prior
   mean; gates PASS) and publishes generation 2, which the watcher
   promotes under traffic; ``quarantine_re`` makes responses degraded
   and the watcher rolls back on its own: every undegraded score bitwise
   the batch score of the generation its response names, generation 2
   quarantined, ``watcher_history`` ["swap", "rollback"], no leaked
   connection, exit 0 on SIGTERM. Then the determinism matrix: the five
   artifact classes twin-run byte-identical, the positive control
   diverged;
14. several ranks (``parallel/multihost.py``, ``FixedEffectCoordinate(mesh=)``),
   over run S's files while phase 10 holds them: run H's fixed effect
   (its global shard at 2^20 features, 512 users x 16 rows, on the tiled
   kernel) over a 2 x 1 and a 1 x 2 (data, model) mesh of gloo ranks on
   the one card, spawned side by side (K1 on every rank's cell; two cold
   fits bitwise, every rank's bits the same, each objective within 1e-4
   of the single card's), then on the same ranks the library surface:
   on 2 x 1 both ranks tile run H's whole shard under one cold cache
   directory (the same keys: rank 0 stores them, rank 1 waits, loads
   and builds nothing; the schedules and K1's passes on them bitwise) and
   ``data_parallel_fit_lbfgs`` (K1 on each rank's shard, the ranks
   bitwise, within 1e-4 of the single card's fit); on 1 x 2
   ``feature_sharded_tiled_fit`` and ``_tron`` bitwise
   ``feature_sharded_glm_fit`` on the rank's cell, K1 counted a rank,
   and the dense ``feature_sharded_fit`` at 2^16 x 2,048 float32
   (512 MiB) twice, bitwise, within 1e-5 of the one-card dense fit's
   scale; beside them two runs of ``glm_driver
   --streaming`` as 2 processes each (``--coordinator-address
   --num-processes --process-id``, each process streaming its shard of
   the files over an off-heap store built from them): the two runs'
   models bitwise, the objective at lambda = 1 within 1e-4 of run S's;
   two runs of the GLM driver in memory over 2 of run S's files as 2
   processes each with ``--distributed feature --model-shards 2`` over
   one ``--tile-cache-dir``, the second starting when the first ends:
   cold, the builds over the processes equal the schedule keys (two
   cells of two passes), each stored once, none waited for; warm, no
   build in either process; the two runs' models bitwise, the objective
   within 1e-4 of the trainer's single-card fit; and two runs of run H's GAME training driver as 2 processes each with
   ``--distributed feature --model-shards 2`` over run H's files (the
   fixed effect over the processes' 1 x 2 mesh): the two runs' CD
   objective histories bitwise, within 1e-4 of run H's;
15. (after phase 12, before phase 13 adds a part to run H's training
   files) the entity-sharded random effect (``game/pod.py``) and the
   unified (grid x entity) mesh (``game/unified.py``), N entity shards as N gloo
   ranks sharing the one card (a path check: it measures no scaling):
   run P, run G's user random effect (100,000 users x 16 rows, INDEX_MAP,
   buckets of 25,000) at its sweep-1 residual through
   ``PodRandomEffectProblem`` on entity meshes of 1 rank (in process) and
   of 2 and 4 ranks (spawned side by side, the inputs handed over in a
   file): one update with variances and one score against the single
   card's replicated ``update_bank`` and ``score_random_effect`` (rows,
   variances and scores within 1e-5 of their scale at N = 1, 2 and 4,
   bitwise at N = 1, the trackers equal: K4 gives an entity the same
   arithmetic in a shard's block as in its bucket; whether N = 2 and 4
   were bitwise is printed; the float64 gradient under 2e-3 at each
   sampled entity's row, and both paths' float64 banks at a tolerance of
   1e-12 within 1e-5), two updates bitwise, every rank's gathered bank the
   same bits, each rank's bytes its shard's share, K1's and K4's launches
   counted in every rank; run E, run H's
   files through the GAME training driver with ``--entity-shards 1`` in
   this process (its objective history bitwise run H's) and
   ``--entity-shards 2`` as 2 processes, twice: the two 2-process runs'
   models bitwise, their histories within 1e-4 of run H's, the model's
   scores through ``game_scoring_driver`` within 1e-4 of run H's (its
   fixed effect runs data-parallel over the processes); the streamed
   entity shards, run T's streamed
   GAME through ``train_streaming_game(entity_mesh=)`` on 2 ranks twice
   (bitwise, within 1e-4 of run T's objective) and run T's driver with
   ``--streaming true --entity-shards 1``; run U, ``run_game_grid`` on a
   (grid 2, entity 2) mesh of 4 ranks at the JAX package's configuration
   (``bench.py:1537-1660``) against the per-member pod CD on the same
   ranks, duplicate-lambda members bitwise, one readback a CD iteration;
16. a ``kernels`` JSON line (K1, K2, K3 and K4, with each kernel's launches
   in the driver runs, K1's in run D's diagnose stage, in the GAME runs,
   in runs F and R, in phase 10's runs, in run L's, in phase 15's and in
   phase 14's surface checks; K2's in ``run_grid(offsets_bank=)``;
   K1's at the GAME shape with its plain and library times; K3 folded
   into K1/K2: the passes that carried it, the
   time the fold adds to a pass, its library time (``index_add_``); K4
   as three entries, one per wrapper: the Gram
   and the matvecs with their launches in run G and times at its bucket
   (library time ``torch.bmm``'s), the Gram's with phase 15's launches and
   the bucket witness; row_dot (row_norm and row_dots with it) with its
   launches on the sequential path and times at its bank (library time
   ``torch.linalg.vecdot``'s), the batched path's and run G's launches
   and shapes beside), the nvidia-smi line, and the last line
   ``{"ok": true, "device": {...}}``.

Every kernel check also launches K1 (z, g, g_sq) and K2, each with the
spill remainder folded in, twice on the same operands at the small, ads,
mesh-cell, GAME and streamed-chunk shapes and fails unless the two give
the same bits: the kernels add in a fixed order
(``ops/csrc/bilinear_pass_core.cuh``).

It exits non-zero without a CUDA card, without the package beside it, or
when any check fails. It imports nothing of JAX.
"""

import argparse
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and f32 (non-tensor-core)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

N_ROWS, NNZ_PER_ROW, DIM = 1 << 18, 64, 1 << 20
N_HELD_OUT = 1 << 16
# of the output's largest magnitude, or of each output's sum of its
# addends' magnitudes (the pass checks): f32 sums, another order
RTOL = 1e-5
GRID_G = 4  # members of the bank K2 is checked and timed at, ads shape
EDGE_GS = (1, 3, 4, 5, 7, 9)  # banks K2 is checked at: 1, 2 and 3+ tiles
GRID_LAMBDAS = [10.0, 1.0, 0.1, 0.01]
MESH_SHAPE = (2, 2)  # (data, model) ranks of the mesh phase
MESH_TIMEOUT_S = 600.0
# the driver phase's training and validation rows: the ads shape's 2^18
# rows took 250 s of host time for runs A and B together on an H100 host
# (preprocess 53-57 s a run), which cut them to 2^16; the script then
# passed the 1,200 s limit with phase 11, which cut them to 2^15, and
# phase 12 (the script at 1,025 s on a slow H100 host) to 2^14, and the
# script at 867.9 s (a 1.4x slower host would pass the limit) to 2^13: the
# model writes (most of a run) scale with the features the rows touch. The
# width stays
DRIVER_TRAIN_ROWS = 1 << 13
DRIVER_HELD_OUT = 1 << 13
DRIVER_PARTS = 4  # LibSVM part files of the training rows
DRIVER_RTOL = 1e-4  # run C's model vs the direct trainer, of the max-abs
# runs A and B (with the intercept) vs the direct fit: the objective at
# each lambda, relative. Their inputs differ (the driver's own load and
# index map; run B a cold batched grid), so the coefficients are held by
# the objective: fits stopping at a relative change of 1e-7 sit up to a
# few 1e-6 above the optimum (the batched grid, without warm starts, the
# furthest), and a model of the other lambda is percents off. Two fits of
# the same inputs are held bitwise (the kernels add in a fixed order).
DRIVER_OBJ_RTOL = 1e-4
# a fit that stops for another reason than convergence or its budget with
# a gradient max-abs this many times the other fits' at its lambda fails
GRADIENT_RATIO_LIMIT = 10.0
# stop reasons that end a fit normally
DONE_REASONS = ("FunctionValuesWithinTolerance", "GradientWithinTolerance", "MaxIterations")
# run D (feature-indexing driver, per-iteration validation, diagnostics):
# the reference's refits, 5 bootstrap resamples and 5 training portions,
# each at least two evaluations of one z-pass and one g-pass
DIAGNOSTIC_REFITS = 10
DIAGNOSE_MIN_K1 = DIAGNOSTIC_REFITS * 2 * 2


def say(*parts):
    print(*parts, flush=True)


def fail(msg):
    say(f"FAILED: {msg}")
    sys.exit(1)


def planted_data(rng, n, w_true):
    """Rows of NNZ_PER_ROW uniform features with normal values; labels
    drawn from the logistic model w_true."""
    idx = rng.integers(0, DIM, size=(n, NNZ_PER_ROW), dtype=np.int64)
    vals = rng.normal(size=(n, NNZ_PER_ROW)).astype(np.float32)
    margin = (vals * w_true[idx]).sum(axis=1)
    labels = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-margin))).astype(np.float32)
    return idx, vals, labels


def ads_data(seed):
    """The ads-shape training rows and held-out rows, from a generator of
    their own: the mesh ranks make the same data from the same seed."""
    rng = np.random.default_rng([seed, 1])
    w_true = (rng.normal(size=DIM) * 0.3).astype(np.float32)
    return planted_data(rng, N_ROWS, w_true), planted_data(rng, N_HELD_OUT, w_true)


def pass_args(tb, w, c):
    """(name, schedule, source, output blocks, values) of the z, g and
    g_sq passes for sources ``w`` (coefficients) and ``c`` (rows)."""
    return (
        ("z", tb.z_sched, w, tb.num_row_blocks, None),
        ("g", tb.g_sched, c, tb.num_feat_blocks, None),
        ("g_sq", tb.g_sched, c, tb.num_feat_blocks, tb.g_vals_sq),
    )


def check_close(what, got, ref, quiet=False, mag=None):
    """Normwise: max |got - ref| <= 1e-6 + RTOL * max |ref|, over the
    finite elements, with NaN in the same places; with ``mag`` (the same
    pass over |values| and |source|: each output's sum of its addends'
    magnitudes) elementwise |got - ref| <= 1e-6 + RTOL * mag, the bound
    of a sum taken in another order. -> (abs, rel to the scale)."""
    torch.cuda.synchronize()
    nan = torch.isnan(ref)
    if not torch.equal(torch.isnan(got), nan):
        fail(f"{what}: NaN in other places than in the plain version")
    if bool(nan.any()):
        got, ref = got[~nan], ref[~nan]
        mag = None if mag is None else mag[~nan]
    diff = (got - ref).abs()
    err = float(diff.max()) if ref.numel() else 0.0
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    rel = err / max(scale, 1e-30)
    if mag is None:
        bad = not err <= 1e-6 + RTOL * scale
        of = ""
    else:
        # where the plain version's padding carried a NaN into the
        # magnitude, the normwise bound
        mag = torch.where(torch.isnan(mag), torch.full_like(mag, scale), mag)
        over = int((diff > 1e-6 + RTOL * mag).sum()) if ref.numel() else 0
        bad = over > 0 or not np.isfinite(err)
        of = f" outputs over 1e-6 + {RTOL!r} x their addends' magnitude={over}"
    if not quiet:
        say(f"{what}: max_abs_err={err!r} max_rel_err={rel!r} scale={scale!r}{of}")
    if bad or not np.isfinite(err):
        fail(f"{what} disagrees: max_abs_err={err!r} scale={scale!r}{of}")
    return err, rel


def addend_magnitude(plain, sched, src, n_out, win, vals):
    """A pass's output-wise sum of its addends' magnitudes: the plain
    version over |values| and |source| (NaN kept where the source has
    one)."""
    v = (sched.vals if vals is None else vals).abs()
    return plain(sched, src.abs(), n_out, win, vals=v)


def compare_passes(k1, tb, rng, label):
    """K1 against its plain version on z, g and g_sq passes; -> worst
    (abs, rel) error."""
    win = tb.params.window
    w = torch.as_tensor(rng.normal(size=tb.dim).astype(np.float32), device="cuda")
    c = torch.as_tensor(rng.normal(size=tb.num_rows).astype(np.float32), device="cuda")
    worst = (0.0, 0.0)
    for name, sched, src, n_out, vals in pass_args(tb, w, c):
        got = k1.bilinear_pass(sched, src, n_out, win, vals=vals)
        ref = k1.bilinear_pass_plain(sched, src, n_out, win, vals=vals)
        mag = addend_magnitude(k1.bilinear_pass_plain, sched, src, n_out, win, vals)
        err = check_close(f"k1_check {label} {name}", got, ref, mag=mag)
        worst = tuple(map(max, worst, err))
    return worst


def compare_grid_passes(k1, k2, tb, rng, label, G, against_k1=False):
    """K2 against its plain version (and, if asked, against G launches of
    K1) on z, g and g_sq passes over a bank of G members; -> worst (abs,
    rel) error."""
    win = tb.params.window
    w = torch.as_tensor(rng.normal(size=(G, tb.dim)).astype(np.float32), device="cuda")
    c = torch.as_tensor(rng.normal(size=(G, tb.num_rows)).astype(np.float32), device="cuda")
    worst = (0.0, 0.0)
    for name, sched, src, n_out, vals in pass_args(tb, w, c):
        got = k2.grid_bilinear_pass(sched, src, n_out, win, vals=vals)
        ref = k2.grid_bilinear_pass_plain(sched, src, n_out, win, vals=vals)
        mag = addend_magnitude(k2.grid_bilinear_pass_plain, sched, src, n_out, win, vals)
        err = check_close(f"k2_check {label} G={G} {name}", got, ref, mag=mag)
        worst = tuple(map(max, worst, err))
        if against_k1:
            per_member = torch.stack([
                k1.bilinear_pass(sched, src[g], n_out, win, vals=vals)
                for g in range(G)
            ])
            err = check_close(f"k2_vs_k1 {label} G={G} {name}", got, per_member, mag=mag)
            worst = tuple(map(max, worst, err))
    return worst


# run_grid(offsets_bank=) at phase 6's cell shape: the ads rows' first 2^17
# and their entries below feature 2^19
OFFSETS_BANK_ROWS, OFFSETS_BANK_DIM = 1 << 17, 1 << 19


def offsets_bank_check(idx, vals, labels, k1, k2, rng, smi, device="cuda"):
    """``GLMOptimizationProblem.run_grid(offsets_bank=)`` on the tiled
    objective at the mesh cell's shape over a bank of GRID_G: a bank whose
    every row is the batch's offsets gives the plain ``run_grid``'s bits
    (K2 launched, K1 not, in each), and K2 on this batch is held to its
    plain version; -> (K2's launches with the bank, its error)."""
    from photon_ml_tpu_torch.ops import tiled_sparse as ts
    from photon_ml_tpu_torch.optim.config import (
        OptimizerConfig,
        RegularizationContext,
        RegularizationType,
    )
    from photon_ml_tpu_torch.optim.problem import create_glm_problem
    from photon_ml_tpu_torch.task import TaskType

    t_check = time.perf_counter()
    n, d = OFFSETS_BANK_ROWS, OFFSETS_BANK_DIM
    rows = np.repeat(np.arange(n, dtype=np.int64), idx.shape[1])
    feats, v = idx[:n].reshape(-1), vals[:n].reshape(-1)
    keep = feats < d
    offsets = (rng.normal(size=n) * 0.1).astype(np.float32)
    tb = ts.build_tiled_batch(rows[keep], feats[keep], v[keep], labels[:n], offsets,
                              np.ones(n, np.float32), d, device=device)
    problem = create_glm_problem(
        TaskType.LOGISTIC_REGRESSION, d, kernel="tiled",
        config=OptimizerConfig(max_iter=10),
        regularization=RegularizationContext(RegularizationType.L2),
    )
    runs = {}
    for label, bank in (("plain", None), ("bank", tb.offsets.expand(GRID_G, -1).clone())):
        k1.launches = k2.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, result = problem.run_grid(tb, GRID_LAMBDAS, offsets_bank=bank)
        torch.cuda.synchronize()
        runs[label] = dict(result=result, seconds=time.perf_counter() - t0,
                           k1=k1.launches, k2=k2.launches)
    a, b = runs["bank"]["result"], runs["plain"]["result"]
    same = (torch.equal(a.coefficients, b.coefficients) and torch.equal(a.value, b.value)
            and a.iterations == b.iterations)
    say(f"run_grid offsets_bank at {n} x {d}, G = {GRID_G} ({smi}): "
        f"{runs['bank']['seconds']!r} s with the bank vs {runs['plain']['seconds']!r} s "
        f"plain, K2 launches {runs['bank']['k2']} / {runs['plain']['k2']}, K1 "
        f"{runs['bank']['k1']} / {runs['plain']['k1']}, iterations {a.iterations}; "
        f"bitwise the plain run_grid {same}")
    if not same:
        fail("run_grid with a bank repeating the batch's offsets is not the plain grid's bits")
    if runs["bank"]["k2"] == 0 or runs["bank"]["k1"]:
        fail("run_grid(offsets_bank=) did not run on K2 alone")
    err = compare_grid_passes(k1, k2, tb, rng, "offsets bank cell", GRID_G)
    say(f"run_grid offsets_bank check: {time.perf_counter() - t_check!r} s of host time "
        f"({smi})")
    return runs["bank"]["k2"], err


def edge_checks(k1, k2, seed):
    """K1 and K2 (G in EDGE_GS) on the work plan's edge cases
    (``tools/kernel_cases.edge_case_batches``), each with a finite source
    and with a NaN where a nonzero entry reads (against the plain version),
    and with a NaN at the first slot of a window that a padded step reads
    (against the pass over the real entries: the plain version's padding
    slots carry that NaN into slot 0 of their output block, the kernels'
    do not); then an output block without steps, into an output whose
    memory held NaN just before. One line per case. -> worst (abs, rel)
    error of K1 and of K2."""
    from photon_ml_tpu_torch.tools.kernel_cases import (
        edge_case_batches,
        nan_at_window_start,
        nan_source,
        real_entries_pass,
        schedule_without_block,
    )

    worst = {"k1": (0.0, 0.0), "k2": (0.0, 0.0)}
    rng = np.random.default_rng([seed, 4])

    def kernel_pass(G, sched, src, n_out, win, vals):
        if G is None:
            return k1.bilinear_pass(sched, src, n_out, win, vals=vals)
        return k2.grid_bilinear_pass(sched, src, n_out, win, vals=vals)

    batches = edge_case_batches("cuda", seed)
    for name, tb in batches:
        win = tb.params.window
        cfg = k1.launch_config(tb.z_sched, tb.z_sched.vals, torch.device("cuda"))
        items = cfg.plan.items.cpu().numpy()
        split = int(np.count_nonzero((items[:, 1] == items[:, 3]) & (items[:, 2] > 0)))
        for nan in ("none", "entry", "window_start"):
            for G in (None,) + EDGE_GS:
                shape = () if G is None else (G,)
                w = torch.as_tensor(rng.normal(size=shape + (tb.dim,)).astype(np.float32), device="cuda")
                c = torch.as_tensor(rng.normal(size=shape + (tb.num_rows,)).astype(np.float32), device="cuda")
                kernel = "k1" if G is None else "k2"
                for pname, sched, src, n_out, vals in pass_args(tb, w, c):
                    if nan == "window_start":
                        src, _, ref = nan_at_window_start(sched, src, n_out, win, vals)
                    else:
                        if nan == "entry":
                            src = nan_source(sched, src)
                        ref = (k1.bilinear_pass_plain(sched, src, n_out, win, vals=vals)
                               if G is None else
                               k2.grid_bilinear_pass_plain(sched, src, n_out, win, vals=vals))
                    if nan != "none" and not bool(torch.isnan(ref).any()):
                        fail(f"edge {name} {pname}: the NaN reached no output")
                    got = kernel_pass(G, sched, src, n_out, win, vals)
                    mag = addend_magnitude(
                        k1.bilinear_pass_plain if G is None else k2.grid_bilinear_pass_plain,
                        sched, src, n_out, win, vals)
                    err = check_close(f"edge {name} {kernel} G={G} {pname} nan={nan}",
                                      got, ref, quiet=True, mag=mag)
                    worst[kernel] = tuple(map(max, worst[kernel], err))
            say(f"edge_check {name} nan={nan}: window {win}, chunk "
                f"{tb.params.chunk}, z steps {tb.z_sched.num_steps}, z plan "
                f"{cfg.ctas} CTAs ({split} inside a step), K1 and K2 at G in "
                f"{list(EDGE_GS)} on z, g, g_sq within {RTOL} of each output's addends' "
                f"magnitude"
                + (" (against the real entries; the plain version has more "
                   "NaN)" if nan == "window_start" else ""))

    tb = dict(batches)["one_step_block"]
    sched = schedule_without_block(tb.z_sched, 1)
    win, n_out = tb.params.window, tb.num_row_blocks
    for G in (None,) + EDGE_GS:
        shape = () if G is None else (G,)
        src = torch.as_tensor(rng.normal(size=shape + (tb.dim,)).astype(np.float32), device="cuda")
        torch.full(shape + (n_out * win,), float("nan"), device="cuda")  # freed
        got = kernel_pass(G, sched, src, n_out, win, None)
        ref = real_entries_pass(sched, src, n_out, win)
        if bool(got[..., win : 2 * win].any()) or bool(torch.isnan(got).any()):
            fail(f"edge block_without_steps G={G}: the block is not zero")
        kernel = "k1" if G is None else "k2"
        err = check_close(f"edge block_without_steps {kernel} G={G}", got, ref, quiet=True)
        worst[kernel] = tuple(map(max, worst[kernel], err))
    say(f"edge_check block_without_steps: z steps {sched.num_steps} (block 1's "
        f"taken out), K1 and K2 at G in {list(EDGE_GS)} write its window as zeros")
    return worst


def plan_fields(cfg, sched):
    """A pass's launch plan and occupancy (``launch_config``), as numbers."""
    return dict(
        ctas=cfg.ctas, items=cfg.plan.num_items, tiles=cfg.tiles,
        members_per_cta=cfg.members_per_cta,
        entries_per_item=int(sched.step_sizes.sum()) / max(cfg.plan.num_items, 1),
        ctas_per_sm=cfg.ctas_per_sm, threads=cfg.threads, vec=cfg.vec,
        shared_blocks=cfg.plan.num_shared, scratch_rows=cfg.plan.scratch_rows,
        mode="staged" if cfg.mode == 0 else "gathered",
    )


def plan_line(what, plan, bound, ms):
    """One line: a pass's launch plan, occupancy and share of its bound."""
    say(f"{what}: {plan['ctas']} CTAs ({plan['items']} work items x "
        f"{plan['tiles']} member tiles of {plan['members_per_cta']}), "
        f"{plan['entries_per_item']:.0f} entries per item, "
        f"{plan['ctas_per_sm']} resident CTAs per SM of {plan['threads']} "
        f"threads, {'16' if plan['vec'] else '4'}-byte entry loads, "
        f"{plan['mode']} windows, {plan['shared_blocks']} blocks shared by "
        f"{plan['scratch_rows']} items (summed in a fixed order); "
        f"{ms!r} ms against a {bound!r} ms bound, share of bound {bound / ms!r}")


def pass_plans(k1, k2, tb, G):
    """The launch plans of K1's and K2's (bank of G) z and g passes on
    ``tb``: {"k1_z": fields, ...}."""
    cuda = torch.device("cuda")
    plans = {}
    for p, sched in (("z", tb.z_sched), ("g", tb.g_sched)):
        plans[f"k1_{p}"] = plan_fields(k1.launch_config(sched, sched.vals, cuda), sched)
        plans[f"k2_{p}"] = plan_fields(k2.launch_config(sched, sched.vals, cuda, G), sched)
    return plans


def time_ms(fn, flush=None):
    """Device ms per call of ``fn``: CUDA events over 50 calls queued
    behind a sleep, so the card and not the wrapper's Python sets the pace;
    with ``flush``, the L2 is evicted before each call
    (``tools/device_timing.py``)."""
    from photon_ml_tpu_torch.tools.device_timing import device_ms

    return device_ms(fn, 50, flush=flush)


def pass_bound_ms(sched, n_src, n_out, members=1):
    """Least time for one pass over ``members`` source vectors: each
    entry's (in_pos, out_pos, val) read once, each source read once, each
    output written once, over the HBM rate; or 2 flops per entry and
    member over the f32 rate, whichever is larger. Entries are the slots
    of the G steps that hold a value (the data's values are normal draws,
    never 0); padding slots do no work of the kernel's function, and the
    spilled entries (K3, folded into the pass, bounded and timed apart by
    ``spill_bound_ms``) are not counted."""
    entries = int(torch.count_nonzero(sched.vals[: sched.num_steps]))
    nbytes = 12 * entries + 4 * members * (n_src + n_out)
    bound = max(
        nbytes / HBM_BYTES_PER_S, 2 * members * entries / F32_FLOPS_PER_S
    ) * 1e3
    return bound, nbytes, entries


def spill_bound_ms(sched, members=1):
    """Least time for K3, the spill remainder folded into a pass: each
    spilled entry's (out, in, val) read once and its source element read
    once per member, over the HBM rate (its 2 flops per entry and member
    bound it far less); the output element is the pass's, read by no one
    and written once by the pass either way."""
    spills = int(torch.count_nonzero(sched.spill_vals))
    nbytes = 12 * spills + 4 * members * spills
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes, spills


def pass_errors(k1, k2, tb, rng, G):
    """K1 (z, g, g_sq) and K2 over a bank of G against their plain
    versions on ``tb``; -> [(name, max abs error, scale, outputs over
    1e-6 + RTOL x their addends' magnitude)]."""
    win = tb.params.window
    out = []
    for label, kernel, plain, shape in (
        ("k1", k1.bilinear_pass, k1.bilinear_pass_plain, ()),
        (f"k2 G={G}", k2.grid_bilinear_pass, k2.grid_bilinear_pass_plain, (G,)),
    ):
        w = torch.as_tensor(rng.normal(size=shape + (tb.dim,)).astype(np.float32), device="cuda")
        c = torch.as_tensor(rng.normal(size=shape + (tb.num_rows,)).astype(np.float32), device="cuda")
        for name, sched, src, n_out, v in pass_args(tb, w, c):
            got = kernel(sched, src, n_out, win, vals=v)
            ref = plain(sched, src, n_out, win, vals=v)
            diff = (got - ref).abs()
            mag = addend_magnitude(plain, sched, src, n_out, win, v)
            out.append((f"{label} {name}", float(diff.max()), float(ref.abs().max()),
                        int((diff > 1e-6 + RTOL * mag).sum())))
    return out


def repeat_checks(k1, k2, tb, rng, label, G=GRID_G, quiet=False):
    """The fixed order of additions: K1 (z, g, g_sq) and K2 over a bank of
    G, each with its spill remainder folded in (K3, as the objective runs
    them), launched twice on the same operands, must give the same bits.
    Fails otherwise; -> the number of pairs compared."""
    win = tb.params.window
    w = torch.as_tensor(rng.normal(size=(G, tb.dim)).astype(np.float32), device=tb.device)
    c = torch.as_tensor(rng.normal(size=(G, tb.num_rows)).astype(np.float32), device=tb.device)
    pairs = 0
    for name, sched, src, n_out, vals in pass_args(tb, w, c):
        spill_vals = None if vals is None else sched.spill_vals ** 2
        for kernel, run, x in (("K1", k1.bilinear_pass, src[0]), ("K2", k2.grid_bilinear_pass, src)):
            first, again = (run(sched, x, n_out, win, vals=vals, spill=True, spill_vals=spill_vals)
                            for _ in range(2))
            if not torch.equal(first, again):
                fail(f"repeat {label} {kernel} {name}: two launches gave other bits")
            pairs += 1
    if not quiet:
        say(f"repeat {label}: K1 z/g/g_sq and K2 G={G}, the spill folded in (K3), each "
            f"bitwise on two launches ({pairs} pairs)")
    return pairs


def fold_checks(k1, k2, tb, rng, label, G=GRID_G):
    """K3 folded into K1 and K2: the z, g and g_sq passes with their spill
    are bitwise the same launch without it followed by ``spill_ordered``
    (the fold's plain form: each slot's spilled products fused-multiply-
    added in entry order, then added once), and within RTOL of each output's addends'
    magnitude of ``index_add_`` of the spilled products after it, for K1
    and K2 over a bank of G. Fails otherwise; -> the worst (abs, rel)
    error against ``index_add_``."""
    win = tb.params.window
    cuda = torch.device("cuda")
    w = torch.as_tensor(rng.normal(size=(G, tb.dim)).astype(np.float32), device=cuda)
    c = torch.as_tensor(rng.normal(size=(G, tb.num_rows)).astype(np.float32), device=cuda)
    worst, slots = (0.0, 0.0), 0
    for name, sched, src, n_out, vals in pass_args(tb, w, c):
        v = sched.vals if vals is None else vals
        sv = sched.spill_vals if vals is None else sched.spill_vals ** 2
        spill = k1.spill_operands(sched, sv)
        if spill is None:
            fail(f"fold {label} {name}: the schedule has no spill")
        slots = max(slots, spill[0].num_segments)
        for kernel, mod, x, cfg in (
            ("K1", k1, src[0], k1.launch_config(sched, v, cuda)),
            ("K2", k2, src, k2.launch_config(sched, v, cuda, G)),
        ):
            fused = mod.launch_with(cfg, sched, x, n_out, win, v, spill)
            unfused = mod.launch_with(cfg, sched, x, n_out, win, v)
            if not torch.equal(fused, k1.spill_ordered(unfused.clone(), x, *spill)):
                fail(f"fold {label} {kernel} {name}: the fused pass is not the unfused pass "
                     "followed by spill_ordered, bit for bit")
            products = sv * x.index_select(-1, sched.spill_in)
            # the addends: the unfused pass's output and the spilled products
            mag = unfused.abs().index_add_(-1, sched.spill_out, products.abs())
            plain = unfused.index_add_(-1, sched.spill_out, products)
            err = check_close(f"fold {label} {kernel} {name} vs index_add_", fused, plain,
                              quiet=True, mag=mag)
            worst = tuple(map(max, worst, err))
    say(f"fold {label}: K1 and K2 G={G} z/g/g_sq with the spill folded in ({slots} spilled "
        f"slots at most) bitwise the unfused launch + spill_ordered; against index_add_ "
        f"max abs err {worst[0]!r}, rel {worst[1]!r}")
    return worst


def cell_times(k1, k2, tb, rows, feats, vals, rng):
    """K1 and K2 (G = GRID_G) on one cell: device ms per z and g pass (warm,
    and with the L2 flushed before each launch: the cell's ~53 MB of
    schedule barely exceeds the 50 MB L2), their plain versions', the
    cell's CSR matvec / SpMM, the bounds and the launch plans."""
    from photon_ml_tpu_torch.tools.device_timing import l2_flush_buffer

    win = tb.params.window
    G = GRID_G
    w = torch.as_tensor(rng.normal(size=tb.dim).astype(np.float32), device="cuda")
    c = torch.as_tensor(rng.normal(size=tb.num_rows).astype(np.float32), device="cuda")
    wb = torch.as_tensor(rng.normal(size=(G, tb.dim)).astype(np.float32), device="cuda")
    cb = torch.as_tensor(rng.normal(size=(G, tb.num_rows)).astype(np.float32), device="cuda")
    coo = torch.stack([torch.as_tensor(rows, device="cuda"), torch.as_tensor(feats, device="cuda")])
    x_vals = torch.as_tensor(vals, device="cuda")
    x = torch.sparse_coo_tensor(coo, x_vals, (tb.num_rows, tb.dim)).coalesce().to_sparse_csr()
    xt = torch.sparse_coo_tensor(coo.flip(0), x_vals, (tb.dim, tb.num_rows)).coalesce().to_sparse_csr()
    z = (tb.z_sched, tb.num_row_blocks, win)
    g = (tb.g_sched, tb.num_feat_blocks, win)
    times = {}
    for name, fn in (
        ("k1_z_ms", lambda: k1.bilinear_pass(z[0], w, *z[1:])),
        ("k1_g_ms", lambda: k1.bilinear_pass(g[0], c, *g[1:])),
        ("k1_z_plain_ms", lambda: k1.bilinear_pass_plain(z[0], w, *z[1:])),
        ("k1_g_plain_ms", lambda: k1.bilinear_pass_plain(g[0], c, *g[1:])),
        ("k1_z_library_ms", lambda: x @ w[:, None]),
        ("k1_g_library_ms", lambda: xt @ c[:, None]),
        ("k2_z_ms", lambda: k2.grid_bilinear_pass(z[0], wb, *z[1:])),
        ("k2_g_ms", lambda: k2.grid_bilinear_pass(g[0], cb, *g[1:])),
        ("k2_z_plain_ms", lambda: k2.grid_bilinear_pass_plain(z[0], wb, *z[1:])),
        ("k2_g_plain_ms", lambda: k2.grid_bilinear_pass_plain(g[0], cb, *g[1:])),
        ("k2_z_library_ms", lambda: x @ wb.T),
        ("k2_g_library_ms", lambda: xt @ cb.T),
    ):
        times[name] = time_ms(fn)
    flush = l2_flush_buffer()
    for name in ("k1_z_ms", "k1_g_ms", "k2_z_ms", "k2_g_ms"):
        fn = dict(
            k1_z_ms=lambda: k1.bilinear_pass(z[0], w, *z[1:]),
            k1_g_ms=lambda: k1.bilinear_pass(g[0], c, *g[1:]),
            k2_z_ms=lambda: k2.grid_bilinear_pass(z[0], wb, *z[1:]),
            k2_g_ms=lambda: k2.grid_bilinear_pass(g[0], cb, *g[1:]),
        )[name]
        times[name.replace("_ms", "_l2_flushed_ms")] = time_ms(fn, flush)
    del flush
    times["plans"] = pass_plans(k1, k2, tb, G)
    for kernel, members in (("k1", 1), ("k2", G)):
        times[f"{kernel}_z_bound_ms"] = pass_bound_ms(tb.z_sched, tb.dim, tb.num_rows, members)[0]
        times[f"{kernel}_g_bound_ms"] = pass_bound_ms(tb.g_sched, tb.num_rows, tb.dim, members)[0]
    times["entries"] = pass_bound_ms(tb.z_sched, tb.dim, tb.num_rows)[2]
    return times


def mesh_rank(mesh, seed, w_eval, cache_dir):
    """One rank of the mesh phase (a spawned process); -> its numbers. It
    makes the phase-4 data from the seed, builds its own cell, checks K1
    and K2 on it, and runs the mesh path's fits, each with every count at
    0 just before it and read just after; the TRON fit twice more with
    ``tile_cache_dir=cache_dir`` and ``track_models``, cold then warm."""
    import hashlib

    import torch.distributed as dist

    from photon_ml_tpu_torch.ops import schedule_cache

    from photon_ml_tpu_torch.data.batch import sparse_batch_from_arrays
    from photon_ml_tpu_torch.ops import losses
    from photon_ml_tpu_torch.ops import tiled_sparse as ts
    from photon_ml_tpu_torch.ops.kernels import bilinear_pass as k1
    from photon_ml_tpu_torch.ops.kernels import grid_bilinear_pass as k2
    from photon_ml_tpu_torch.ops.normalization import NormalizationContext
    from photon_ml_tpu_torch.optim import common
    from photon_ml_tpu_torch.optim.config import OptimizerType, RegularizationType
    from photon_ml_tpu_torch.parallel.distributed import block_local_vg
    from photon_ml_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, make_mesh
    from photon_ml_tpu_torch.task import TaskType
    from photon_ml_tpu_torch.training import (
        iteration_models,
        train_feature_sharded,
        train_generalized_linear_model,
        train_grid_batched_feature_sharded,
    )

    out = {"rank": mesh.rank, "coords": mesh.coords}
    (idx, vals, labels), _ = ads_data(seed)
    batch = sparse_batch_from_arrays(
        idx, vals, labels, np.zeros(N_ROWS, np.float32),
        np.ones(N_ROWS, np.float32), device="cpu",
    )
    d_i, m_i = mesh.index(DATA_AXIS), mesh.index(MODEL_AXIS)
    t0 = time.perf_counter()
    cell, block_dim = ts.feature_shard_tiled_batch(
        batch, DIM, *mesh.shape, d_i, m_i, device=mesh.device,
    )
    torch.cuda.synchronize()
    tb = cell.cell
    out["cell"] = dict(
        build_s=time.perf_counter() - t0, rows=tb.num_rows, block_dim=block_dim,
        chunk=tb.params.chunk, z_steps=tb.z_sched.num_steps,
        g_steps=tb.g_sched.num_steps,
    )
    rng = np.random.default_rng([seed, 2, mesh.rank])
    out["checks"] = pass_errors(k1, k2, tb, rng, GRID_G)
    out["repeat_pairs"] = repeat_checks(k1, k2, tb, rng, f"cell {mesh.coords}", quiet=True)

    # cell-shape times on rank 0 while the other ranks wait
    if mesh.rank == 0:
        rows = np.repeat(np.arange(N_ROWS, dtype=np.int64), NNZ_PER_ROW)
        feats = idx.reshape(-1)
        R = cell.meta.rows_per_shard
        mine = (rows // R == d_i) & (feats // block_dim == m_i)
        out["times"] = cell_times(
            k1, k2, tb, rows[mine] - d_i * R, feats[mine] - m_i * block_dim,
            vals.reshape(-1)[mine], rng,
        )
    dist.barrier(group=mesh.world)

    # the mesh objective at w_eval, l2 = 0
    dg, mg = mesh.groups[DATA_AXIS], mesh.groups[MODEL_AXIS]
    own = slice(m_i * block_dim, (m_i + 1) * block_dim)
    w_block = torch.as_tensor(w_eval[own], device=mesh.device)
    value, grad = block_local_vg(
        losses.LOGISTIC, cell, dg, mg, 0.0, NormalizationContext()
    )(w_block)
    out["objective"] = (float(value), common.all_gather_last(grad, mg))

    # what one collective costs here (host clock, every rank taking part):
    # the fetch alone and with its flag broadcast, and all-reduces of one
    # value, of the partial margins and of the block gradient
    def per_call_us(fn, reps=50):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e6

    reductions = common.MeshReductions(model=mg, world=mesh.world)
    flag = torch.zeros(1, device=mesh.device)
    rows_vec = torch.zeros(tb.num_rows + 1, device=mesh.device)
    block_vec = torch.zeros(block_dim + 2, device=mesh.device)
    out["collective_us"] = {
        "fetch": per_call_us(lambda: common.fetch(flag)),
        "fetch_with_broadcast": per_call_us(lambda: common.fetch(flag, mesh=reductions)),
        "all_reduce_1": per_call_us(lambda: common.all_reduce(flag.clone(), mg)),
        "all_reduce_margins": per_call_us(lambda: common.all_reduce(rows_vec.clone(), mg)),
        "all_reduce_gradient": per_call_us(lambda: common.all_reduce(block_vec.clone(), dg)),
    }
    del cell, tb

    def counted(fn):
        k1.launches = k2.launches = 0
        common.host_fetches = common.collectives = 0
        schedule_cache.reset_stats()
        t0 = time.perf_counter()
        models, results = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        cache = schedule_cache.stats()
        fits = {}
        for lam, model in models.items():
            means, variances = model.coefficients.means, model.coefficients.variances
            ok = bool(torch.isfinite(means).all()) and (
                variances is None
                or bool(torch.isfinite(variances).all() and (variances > 0).all())
            )
            fits[lam] = dict(
                value=float(results[lam].value),
                iterations=results[lam].iterations,
                reason=results[lam].reason_name, finite=ok,
                variances=variances is not None,
                digest=hashlib.sha256(means.cpu().numpy().tobytes()).hexdigest()[:16],
            )
            if results[lam].tracker.coefs is not None:
                tracked = iteration_models(results[lam], task)
                fits[lam]["tracked"] = len(tracked)
                fits[lam]["last_is_final"] = bool(torch.equal(tracked[-1].means, means))
        return dict(
            seconds=seconds, k1=k1.launches, k2=k2.launches,
            fetches=common.host_fetches, collectives=common.collectives,
            fits=fits, cache_hits=cache.hits, cache_builds=cache.builds,
            cache_stores=cache.stores,
        )

    task = TaskType.LOGISTIC_REGRESSION
    l2 = dict(regularization_type=RegularizationType.L2, kernel="tiled")
    out["lbfgs"] = counted(lambda: train_feature_sharded(
        batch, task, DIM, mesh=mesh, regularization_weights=[10.0, 1.0],
        max_iter=10, compute_variances=True, **l2,
    ))
    out["tron"] = counted(lambda: train_feature_sharded(
        batch, task, DIM, mesh=mesh, regularization_weights=[1.0], max_iter=3,
        optimizer_type=OptimizerType.TRON, **l2,
    ))
    # the same fit through the schedule cache with per-iteration models:
    # cold (each rank stores its cell), then warm (each rank loads it)
    for label in ("tron_cache_cold", "tron_cache_warm"):
        out[label] = counted(lambda: train_feature_sharded(
            batch, task, DIM, mesh=mesh, regularization_weights=[1.0], max_iter=3,
            optimizer_type=OptimizerType.TRON, tile_cache_dir=cache_dir,
            track_models=True, **l2,
        ))
    out["grid"] = counted(lambda: train_grid_batched_feature_sharded(
        batch, task, DIM, mesh=mesh, regularization_weights=GRID_LAMBDAS,
        max_iter=10, compute_variances=True, **l2,
    ))
    data_mesh = make_mesh((mesh.world_size,), (DATA_AXIS,))
    out["data_parallel"] = counted(lambda: train_generalized_linear_model(
        batch, task, DIM, mesh=data_mesh, regularization_weights=[10.0, 1.0],
        max_iter=10, compute_variances=True, **l2,
    ))
    return out


def mesh_fields(kernel, launches, cell, errs):
    """A kernel's mesh-phase fields for the ``kernels`` line: its launches
    over the mesh fits (all ranks), its times per pass at the cell shape
    with their plain, library and bound times, and its worst error on
    the cells."""
    fields = {"mesh_launches": launches[kernel]}
    for key in ("z_ms", "g_ms", "z_l2_flushed_ms", "g_l2_flushed_ms",
                "z_plain_ms", "g_plain_ms", "z_library_ms", "g_library_ms",
                "z_bound_ms", "g_bound_ms"):
        fields[f"cell_{key}"] = cell[f"{kernel}_{key}"]
    fields["cell_max_abs_err"], fields["cell_max_rel_err"] = errs[kernel]
    return fields


def write_libsvm(path, idx, vals, labels):
    """Rows as LibSVM text (1-based indices, 0/1 labels), one numpy
    format string per row; ``%.9g`` round-trips every float32 value."""
    n, k = idx.shape
    table = np.empty((n, 1 + 2 * k), np.float64)
    table[:, 0] = labels
    table[:, 1::2] = idx + 1
    table[:, 2::2] = vals
    np.savetxt(path, table, fmt=" ".join(["%d"] + ["%d:%.9g"] * k))


def driver_data(seed, tmp):
    """Planted-model logistic rows at the ads width from the seed, written
    as LibSVM files: DRIVER_TRAIN_ROWS training rows in DRIVER_PARTS part
    files and DRIVER_HELD_OUT validation rows; -> (train dir, validation dir,
    seconds to make and write them)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng([seed, 2])
    w_true = (rng.normal(size=DIM) * 0.3).astype(np.float32)
    dirs = []
    for name, n, parts in (
        ("train", DRIVER_TRAIN_ROWS, DRIVER_PARTS), ("validate", DRIVER_HELD_OUT, 1)
    ):
        idx, vals, labels = planted_data(rng, n, w_true)
        order = np.argsort(idx, axis=1, kind="stable")
        idx = np.take_along_axis(idx, order, axis=1)
        vals = np.take_along_axis(vals, order, axis=1)
        d = f"{tmp}/{name}"
        os.makedirs(d)
        for p, rows in enumerate(np.array_split(np.arange(n), parts)):
            write_libsvm(f"{d}/part-{p:05d}.txt", idx[rows], vals[rows], labels[rows])
        dirs.append(d)
    return dirs[0], dirs[1], time.perf_counter() - t0


DRIVER_OUTPUTS = (
    "feature-index/index.json", "models/models.avro", "best-model/model.avro",
    "models-text", "optimization-log.txt", "metrics.json",
)


def objective64(batch, means, lam):
    """The L2-regularized logistic objective at ``means``, in float64 and
    from its definition (no code of the port's objectives):
    sum_i w_i (log(1 + e^z_i) - y_i z_i) + lam / 2 |means|^2 with
    z_i = x_i . means + o_i; -> (value, max-abs of its gradient)."""
    w = means.double()
    idx = batch.indices.long()
    v = batch.values.double()
    z = (v * w[idx]).sum(1) + batch.offsets.double()
    y, wt = batch.labels.double(), batch.weights.double()
    value = (wt * (torch.nn.functional.softplus(z) - y * z)).sum() + 0.5 * lam * (w @ w)
    r = wt * (torch.sigmoid(z) - y)
    grad = torch.zeros_like(w).index_add_(0, idx.reshape(-1), (v * r[:, None]).reshape(-1))
    return float(value), float((grad + lam * w).abs().max())


def driver_run(label, argv, out, k1, k2, smi, outputs=DRIVER_OUTPUTS, keep_driver=False):
    """One ``glm_driver.main(argv)`` with the launch and cache counters
    set to 0 just before it; fails unless it writes ``outputs``; -> its
    record (output dir, seconds, launches, timers, metrics.json,
    iterations, stop reasons; the driver itself with ``keep_driver``)."""
    from photon_ml_tpu_torch.cli import glm_driver
    from photon_ml_tpu_torch.ops import schedule_cache

    k1.launches = 0
    k2.launches = 0
    schedule_cache.reset_stats()
    t0 = time.perf_counter()
    driver = glm_driver.main(argv + ["--output-directory", out])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    missing = [f for f in outputs if not os.path.exists(f"{out}/{f}")]
    if missing:
        fail(f"driver run {label} wrote no {missing}")
    with open(f"{out}/metrics.json") as f:
        metrics = json.load(f)
    run = dict(
        out=out, seconds=seconds, k1=k1.launches, k2=k2.launches,
        timers=driver.timer.durations, metrics=metrics,
        iterations={lam: r.iterations for lam, r in driver.results.items()},
        reasons={lam: r.reason_name for lam, r in driver.results.items()},
    )
    if keep_driver:
        run["driver"] = driver
    timers = " ".join(
        f"{k}={driver.timer.durations[k]!r}"
        for k in ("preprocess", "train", "validate", "diagnose", "write")
        if k in driver.timer.durations
    )
    say(f"driver run {label} ({smi}): {seconds!r} s; stage timers s: {timers}; "
        f"K1 launches {k1.launches}, K2 launches {k2.launches}; iterations "
        f"{run['iterations']}, stop reasons {run['reasons']}; train rows per second of preprocess "
        f"{DRIVER_TRAIN_ROWS / driver.timer.durations['preprocess']!r}")
    sc = metrics["schedule_cache"]
    say(f"driver run {label} schedule cache ({smi}): builds={sc['builds']} "
        f"hits={sc['hits']} misses={sc['misses']} stores={sc['stores']} "
        f"build_s={sc['build_s']!r} load_s={sc['load_s']!r} "
        f"hash_s={sc['hash_s']!r} store_s={sc['store_s']!r}")
    return run


def driver_obs_check(obs_dir, prof_dir, k1_launches, smi):
    """Run C's ``--obs-dir`` and ``--profile-dir``: the trace, flight and
    snapshot files with a span per lambda solve, and a profiler trace
    that lists K1's launches by the kernel's name. The session's tracing
    and flight recorder are process-wide: reset after the check."""
    from photon_ml_tpu_torch import obs

    files = sorted(os.listdir(obs_dir))
    with open(f"{obs_dir}/trace.json") as f:
        spans = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    solves = sum(e["name"] == "glm.lambda_solve" for e in spans)
    prof = [n for n in os.listdir(prof_dir) if n.endswith(".pt.trace.json")]
    with open(f"{prof_dir}/{prof[0]}") as f:
        kernels = [e["name"] for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    named = sum("bilinear_pass_kernel" in k and "grid_bilinear" not in k for k in kernels)
    say(f"driver run C --obs-dir ({smi}): {files}, {len(spans)} spans, {solves} "
        f"glm.lambda_solve; --profile-dir: {len(kernels)} CUDA kernel events, {named} named "
        f"bilinear_pass_kernel against {k1_launches} K1 launches counted by its wrapper")
    if files != ["flight.json", "metrics_snapshot.json", "trace.json"] or not solves:
        fail(f"driver run C: --obs-dir wrote {files} with {solves} lambda spans")
    if named != k1_launches:
        fail(f"driver run C: the profile lists {named} bilinear_pass_kernel launches")
    obs.set_tracing(False)
    obs.reset_tracer()
    obs.reset_flight_recorder()
    obs.reset_default_registry()


def driver_phase(seed, smi, k1, k2):
    """Phase 7 (:func:`driver_runs`) in a temp directory that outlives it
    for run R; removed here only if the phase fails."""
    tmp = tempfile.mkdtemp(prefix="photon_driver_phase_")
    try:
        return driver_runs(seed, smi, k1, k2, tmp)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def driver_runs(seed, smi, k1, k2, tmp):
    """Phase 7: the port's CLI entry point, ``glm_driver.main(argv)``, over
    the same LibSVM files with the intercept (the driver's default): run
    A, the warm-started sequential grid (K1) with a cold schedule cache;
    run B, the batched grid (K2) with the cache now warm. Then run C, run
    A without the intercept and without validation. Fails unless A and B
    write every output, the models read back, each lambda's held-out AUC
    in metrics.json is above 0.5 and equals the AUC of the written model
    on the loaded validation rows, run B takes the train schedule from the
    cache, A's and B's objective at each lambda is within DRIVER_OBJ_RTOL
    of ``train_generalized_linear_model(kernel="tiled")``'s on the batch
    the port's LibSVM loader gives (and A's lambda = 10 model is not, at
    lambda = 1), and run C's lambda = 1 model is within DRIVER_RTOL of the
    direct trainer's on that batch without its intercept column; -> (the
    launches of each run, run A's argv, models, objectives and loaded
    batch for run R, in a temp directory the caller removes)."""
    from photon_ml_tpu_torch.data.batch import SparseBatch
    from photon_ml_tpu_torch.evaluation.metrics import area_under_roc_curve
    from photon_ml_tpu_torch.io.input_format import create_input_format
    from photon_ml_tpu_torch.io.model_io import load_glm_models_avro
    from photon_ml_tpu_torch.models.glm import compute_margins
    from photon_ml_tpu_torch.optim.config import OptimizerType, RegularizationType
    from photon_ml_tpu_torch.task import TaskType
    from photon_ml_tpu_torch.training import train_generalized_linear_model, train_grid_batched
    from photon_ml_tpu_torch.utils.index_map import IndexMap

    train_dir, val_dir, data_s = driver_data(seed, tmp)
    say(f"driver data: {DRIVER_TRAIN_ROWS} train rows in {DRIVER_PARTS} LibSVM "
        f"files, {DRIVER_HELD_OUT} validation rows, {NNZ_PER_ROW} nnz per row, "
        f"{DIM} features; made and written in {data_s:.2f} s")
    common = [
        "--training-data-directory", train_dir,
        "--input-file-format", "LIBSVM", "--feature-dimension", str(DIM),
        "--regularization-weights", "10,1", "--optimizer", "LBFGS",
        "--compute-variances", "true", "--tile-cache-dir", f"{tmp}/tile-cache",
    ]
    validated = common + ["--validating-data-directory", val_dir]
    runs = {
        label: driver_run(label, argv + ["--grid-mode", mode], f"{tmp}/out-{label}",
                          k1, k2, f"{mode}, {smi}", keep_driver=label == "A")
        for label, mode, argv in (
            ("A", "sequential", validated), ("B", "batched", validated),
        )
    }
    a, b = runs["A"], runs["B"]
    # run A's models as it fitted them, for run R's bitwise resume
    a_driver = a.pop("driver")
    a_means = {lam: a_driver.models[lam].means.clone() for lam in (10.0, 1.0)}
    del a_driver
    if a["k1"] == 0 or a["k2"]:
        fail(f"driver run A launched {a['k1']} K1 and {a['k2']} K2")
    if b["k2"] == 0:
        fail("driver run B never launched K2")
    sc_a, sc_b = a["metrics"]["schedule_cache"], b["metrics"]["schedule_cache"]
    if sc_a["builds"] < 2 or sc_a["stores"] < 2:
        fail("driver run A did not build and store both train schedules")
    if sc_b["hits"] < 1 or sc_b["builds"]:
        fail("driver run B did not take the train schedule from the cache")
    say(f"driver schedule ({smi}): built cold in {sc_a['build_s']!r} s (run A), "
        f"from the cache in {sc_b['load_s'] + sc_b['hash_s']!r} s "
        f"(run B: load {sc_b['load_s']!r} + content hash {sc_b['hash_s']!r})")

    # the validation rows and the written models, read back
    index_map = IndexMap.load(f"{a['out']}/feature-index/index.json")
    fmt = create_input_format("LIBSVM", feature_dimension=DIM)
    val = fmt.load(val_dir, index_map=index_map, device="cuda").batch
    for label, run in runs.items():
        models = load_glm_models_avro(
            f"{run['out']}/models/models.avro", index_map, device="cuda"
        )
        best = load_glm_models_avro(
            f"{run['out']}/best-model/model.avro", index_map, device="cuda"
        )
        if sorted(models) != ["1.0", "10.0"] or len(best) != 1:
            fail(f"driver run {label}: models {sorted(models)}, best {sorted(best)}")
        run["models"] = models
        for lam, m in models.items():
            auc_file = run["metrics"]["validation"][lam]["AUC"]
            auc = float(area_under_roc_curve(
                compute_margins(m.means, val), val.labels, val.weights))
            say(f"driver run {label} lambda={lam}: held-out AUC {auc_file!r} "
                f"(metrics.json), {auc!r} (written model); variances "
                f"{'present' if m.coefficients.variances is not None else 'missing'}")
            if not auc_file > 0.5 or auc != auc_file:
                fail(f"driver run {label} lambda={lam}: held-out AUC off")
            if m.coefficients.variances is None:
                fail(f"driver run {label} lambda={lam}: no variances written")

    # runs A and B against the trainer called directly on the batch the
    # port's loader gives for the same files: the objective at each
    # lambda, in float64
    t0 = time.perf_counter()
    direct = fmt.load(train_dir, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    say(f"driver load ({smi}): {DRIVER_TRAIN_ROWS} train rows in {load_s!r} s, "
        f"{DRIVER_TRAIN_ROWS / load_s!r} rows per second")
    fit = dict(
        optimizer_type=OptimizerType.LBFGS,
        regularization_type=RegularizationType.L2,
        regularization_weights=[10.0, 1.0], compute_variances=True,
        kernel="tiled", device="cuda",
    )
    batch = a_batch = direct.batch
    d_models, d_results = train_generalized_linear_model(
        batch, TaskType.LOGISTIC_REGRESSION, direct.num_features,
        intercept_index=direct.intercept_index, **fit,
    )
    # the fixed order of additions: the same fit with the intercept on the
    # same batch, repeated, sequential (K1) and batched (K2), gives the
    # same bits
    again, _ = train_generalized_linear_model(
        batch, TaskType.LOGISTIC_REGRESSION, direct.num_features,
        intercept_index=direct.intercept_index, **fit,
    )
    grids = [train_grid_batched(
        batch, TaskType.LOGISTIC_REGRESSION, direct.num_features,
        intercept_index=direct.intercept_index, **fit,
    )[0] for _ in range(2)]
    for lam in (10.0, 1.0):
        seq_same = torch.equal(again[lam].means, d_models[lam].means) and torch.equal(
            again[lam].coefficients.variances, d_models[lam].coefficients.variances)
        grid_same = torch.equal(grids[0][lam].means, grids[1][lam].means)
        say(f"driver direct repeat lambda={lam} ({smi}): the sequential fit (K1) bitwise "
            f"{seq_same}, the batched fit (K2) bitwise {grid_same}")
        if not (seq_same and grid_same):
            fail(f"driver direct lambda={lam}: a repeated fit with the intercept is not bitwise")
    del again, grids
    _, g0 = objective64(batch, torch.zeros_like(d_models[1.0].means), 1.0)
    objectives = {}  # (run, lambda) -> objective
    for lam in (10.0, 1.0):
        ref = d_models[lam].means
        f_ref, g_ref = objective64(batch, ref, lam)
        say(f"driver direct lambda={lam} ({smi}): objective {f_ref!r}, "
            f"gradient max-abs {g_ref!r} ({g0!r} at 0), iterations "
            f"{d_results[lam].iterations}, stop reason {d_results[lam].reason_name}")
        # the stop reason and the gradient max-abs at each returned point
        # (no box: the projected gradient is the gradient)
        stops = {"direct": (d_results[lam].reason_name, g_ref)}
        for label, run in runs.items():
            # other inputs than the direct fit's (the driver's own load and
            # index map; run B a cold batched grid): held by the objective,
            # the spread printed as a measurement
            m = run["models"][str(lam)].means
            f_run, g_run = objective64(batch, m, lam)
            rel = (f_run - f_ref) / abs(f_ref)
            spread = float((m - ref).abs().max() / ref.abs().max())
            stops[label] = (run["reasons"][lam], g_run)
            objectives[label, lam] = f_run
            say(f"driver run {label} lambda={lam} vs the direct fit ({smi}): "
                f"objective {f_run!r}, relative difference {rel!r}; gradient "
                f"max-abs {g_run!r}, stop reason {run['reasons'][lam]}; "
                f"intercept_spread {spread!r} of the coefficients' max-abs")
            if not abs(rel) <= DRIVER_OBJ_RTOL:
                fail(f"driver run {label} lambda={lam}: objective off the "
                     "direct fit's")
        for label, (reason, g) in stops.items():
            others = max(g_o for other, (_, g_o) in stops.items() if other != label)
            if reason not in DONE_REASONS and g > GRADIENT_RATIO_LIMIT * others:
                fail(f"driver {label} lambda={lam} stopped ({reason}) with a "
                     f"gradient max-abs {g!r}, over {GRADIENT_RATIO_LIMIT}x the "
                     f"other fits' {others!r}")
    # the check tells models apart: run A's lambda = 10 model at lambda = 1
    f_wrong, _ = objective64(batch, a["models"]["10.0"].means, 1.0)
    f_ref, _ = objective64(batch, d_models[1.0].means, 1.0)
    rel = (f_wrong - f_ref) / abs(f_ref)
    say(f"driver control ({smi}): run A's lambda=10 model at lambda=1, "
        f"objective relative difference {rel!r}")
    if abs(rel) <= DRIVER_OBJ_RTOL:
        fail("the objective check does not tell the lambda = 10 model apart")

    runs["D"] = diagnostics_run(
        train_dir, val_dir, tmp, index_map, batch, objectives["A", 1.0], k1, k2, smi,
    )

    # run C: without the intercept, the coefficients themselves. The
    # loader appends the intercept after a row's entries and pads the
    # width to a multiple of 8, so the batch's first NNZ_PER_ROW columns
    # are the loader's batch without the intercept.
    k = NNZ_PER_ROW
    if not (bool((batch.indices[:, k] == DIM).all())
            and bool((batch.values[:, k] == 1.0).all())
            and bool((batch.values[:, k + 1:] == 0.0).all())):
        fail("the loaded batch does not hold the intercept after each row's entries")
    runs["C"] = c = driver_run(
        "C", common + ["--grid-mode", "sequential", "--intercept", "false",
                       "--obs-dir", f"{tmp}/obs-C", "--profile-dir", f"{tmp}/prof-C"],
        f"{tmp}/out-C", k1, k2, f"sequential, no intercept, {smi}",
        outputs=[f for f in DRIVER_OUTPUTS if not f.startswith("best-model")],
    )
    if c["k1"] == 0:
        fail("driver run C never launched K1")
    driver_obs_check(f"{tmp}/obs-C", f"{tmp}/prof-C", c["k1"], smi)
    bare = SparseBatch(
        batch.indices[:, :k].contiguous(), batch.values[:, :k].contiguous(),
        batch.labels, batch.offsets, batch.weights,
    )
    del direct, batch, d_models
    c_models, _ = train_generalized_linear_model(
        bare, TaskType.LOGISTIC_REGRESSION, DIM, **fit,
    )
    ref = c_models[1.0].means
    got = load_glm_models_avro(
        f"{c['out']}/models/models.avro",
        IndexMap.load(f"{c['out']}/feature-index/index.json"), device="cuda",
    )["1.0"].means
    err = float((got - ref).abs().max() / ref.abs().max())
    say(f"driver run C lambda=1 vs the direct trainer: max-abs difference "
        f"{err!r} of the coefficients' max-abs")
    if not err <= DRIVER_RTOL:
        fail("driver run C's lambda=1 model is off the direct trainer's")
    out = {label: {"k1": r["k1"], "k2": r["k2"]} for label, r in runs.items()}
    out["D"]["diagnose_k1"] = runs["D"]["diagnose_k1"]
    run_a = dict(
        tmp=tmp, argv=validated + ["--grid-mode", "sequential"], batch=a_batch,
        models={lam: a["models"][str(lam)].means for lam in (10.0, 1.0)},
        means=a_means,
        objectives={lam: objectives["A", lam] for lam in (10.0, 1.0)},
        seconds=a["seconds"], timers=a["timers"],
    )
    return out, run_a


DIAGNOSTIC_CHAPTERS = ("Model lambda=1.0", "Bootstrap analysis", "Fitting analysis")
DIAGNOSTIC_SECTIONS = (
    "Feature importance", "Hosmer-Lemeshow calibration",
    "Prediction-error independence (Kendall tau)",
    "Bootstrap (5 resamples, lambda=1.0)", "Learning curves",
)


def diagnostics_run(train_dir, val_dir, tmp, a_index_map, batch, f_a, k1, k2, smi):
    """Run D of phase 7, over run A's files: ``feature_indexing_driver.main``
    builds the off-heap store, then ``glm_driver.main`` trains over it at
    lambda = 1 (sequential, K1; the intercept on, no variances) with
    per-iteration validation and every diagnostic. Fails unless the store
    holds exactly the training files' keys and the intercept, each of
    them a key of run A's index map, as a bijection onto [0, size); the
    per-iteration metrics are one per iterate and the last is the final
    model's; the HTML report holds every chapter and section the
    reference's report writes, with finite numbers only; the refits
    launched K1 (at least DIAGNOSE_MIN_K1 times in the diagnose stage);
    and the lambda = 1 model, read back in run A's index space, is within
    DRIVER_OBJ_RTOL of run A's objective ``f_a``; -> its record."""
    import re

    from photon_ml_tpu_torch.cli import feature_indexing_driver, glm_driver
    from photon_ml_tpu_torch.io.model_io import load_glm_models_avro
    from photon_ml_tpu_torch.utils.index_map import feature_key, intercept_key
    from photon_ml_tpu_torch.utils.native_index import load_offheap_index_map

    t0 = time.perf_counter()
    feature_indexing_driver.main([
        "--input-paths", train_dir, "--output-dir", f"{tmp}/store", "--format", "LIBSVM",
    ])
    index_s = time.perf_counter() - t0
    store = load_offheap_index_map(f"{tmp}/store")
    cols = batch.indices[:, :NNZ_PER_ROW]
    present = torch.unique(cols[batch.values[:, :NNZ_PER_ROW] != 0]).cpu().tolist()
    keys = [feature_key(str(i)) for i in present] + [intercept_key()]
    got = store._stores[0].get_indices(keys) if len(store._stores) == 1 else np.array(
        [store.get_index(k) for k in keys])
    bijection = sorted(got.tolist()) == list(range(store.size))
    in_a = all(a_index_map.get_index(k) >= 0 for k in keys)
    say(f"driver run D store ({smi}): {store.size} keys ({len(present)} features of the "
        f"training files + the intercept) built in {index_s!r} s; a bijection onto "
        f"[0, size): {bijection}; every key in run A's index map: {in_a}")
    if store.size != len(keys) or not bijection or not in_a:
        fail("run D's index store does not hold exactly the training files' keys")
    if store.get_feature_name(int(got[0])) != keys[0]:
        fail("run D's index store does not map an index back to its key")
    store.close()

    # the diagnose stage's launches: K1's count read on entering and leaving it
    at_diagnose = {}
    run_diagnostics = glm_driver.run_glm_diagnostics

    def counted_diagnostics(driver):
        at_diagnose["start"] = k1.launches
        run_diagnostics(driver)
        at_diagnose["end"] = k1.launches

    glm_driver.run_glm_diagnostics = counted_diagnostics
    try:
        d = driver_run("D", [
            "--training-data-directory", train_dir, "--validating-data-directory", val_dir,
            "--input-file-format", "LIBSVM", "--offheap-indexmap-dir", f"{tmp}/store",
            "--regularization-weights", "1", "--optimizer", "LBFGS",
            "--validate-per-iteration", "true", "--diagnostic-mode", "ALL",
            "--grid-mode", "sequential",
        ], f"{tmp}/out-D", k1, k2, f"sequential, diagnostics, {smi}", keep_driver=True)
    finally:
        glm_driver.run_glm_diagnostics = run_diagnostics
    driver = d.pop("driver")
    diag_k1 = at_diagnose["end"] - at_diagnose["start"]
    say(f"driver run D diagnose ({smi}): {diag_k1} K1 launches over "
        f"{DIAGNOSTIC_REFITS} refits in {d['timers']['diagnose']!r} s; "
        f"{d['k1'] - diag_k1} K1 launches in the fit; K2 launches {d['k2']}")
    if diag_k1 < DIAGNOSE_MIN_K1 or d["k2"]:
        fail(f"run D's refits launched {diag_k1} K1 (at least {DIAGNOSE_MIN_K1}) "
             f"and {d['k2']} K2")

    per_iter = driver.per_iteration_metrics[1.0]
    final = driver.validation_metrics[1.0]
    last_gap = max(abs(per_iter[-1][k] - v) for k, v in final.items())
    say(f"driver run D per-iteration validation: {len(per_iter)} entries for "
        f"{d['iterations'][1.0]} iterations; first {per_iter[0]}, last {per_iter[-1]}, "
        f"final {final}; last vs final {last_gap!r}")
    if len(per_iter) != d["iterations"][1.0] + 1 or not last_gap <= 1e-6:
        fail("run D's per-iteration metrics do not end at the final model's")
    if d["metrics"]["per_iteration_validation"]["1.0"] != per_iter:
        fail("run D's metrics.json does not hold the per-iteration metrics")

    report = f"{d['out']}/model-diagnostics/report.html"
    if not os.path.isfile(report):
        fail("run D wrote no diagnostics report")
    with open(report) as f:
        html = f.read()
    missing = [t for t in DIAGNOSTIC_CHAPTERS + DIAGNOSTIC_SECTIONS if t not in html]
    text = re.sub(r"<[^>]*>", " ", html)
    numbers = re.findall(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?", text)
    bad = re.findall(r"\b(?:nan|inf)\b", html, flags=re.IGNORECASE)
    say(f"driver run D report ({smi}): {len(html)} bytes, {len(numbers)} numbers, "
        f"missing titles {missing}, non-finite {bad}")
    if missing or bad or not numbers:
        fail("run D's report lacks a chapter or section, or holds a non-finite number")

    # run D's model in run A's index space (the model file maps names)
    d_model = load_glm_models_avro(
        f"{d['out']}/models/models.avro", a_index_map, device="cuda")["1.0"]
    f_d, g_d = objective64(batch, d_model.means, 1.0)
    rel = (f_d - f_a) / abs(f_a)
    say(f"driver run D lambda=1 vs run A ({smi}): objective {f_d!r} vs {f_a!r}, "
        f"relative difference {rel!r}; gradient max-abs {g_d!r}; "
        f"stop reason {d['reasons'][1.0]}")
    if not abs(rel) <= DRIVER_OBJ_RTOL:
        fail("run D's lambda=1 objective is off run A's")
    d["diagnose_k1"] = diag_k1
    return d


# -- phase 8: GAME ---------------------------------------------------------

# Run G: the JAX package's config-4 GLMix (bench.py:4149-4162) through the
# coordinate API, its rows shared by both coordinates: 100,000 users of 16
# rows, a global shard of 2^20 features (64 a row and the intercept) and a
# user shard of 32 a row drawn from each user's pool of 1,000 feature ids
GAME_USERS = 100_000
GAME_ROWS_PER_USER = 16
GAME_USER_NNZ = 32
GAME_USER_POOL = 1000
# entities per random-effect bucket: bench.py's chunk, so that a bucket's
# dense block X [E, 16, D] fits the 2 GiB dense_bytes_budget and takes the
# Newton solver
GAME_BUCKET_ENTITIES = 25_000
# run G, the tiled objective (K1) against the scatter objective at each
# sweep's fixed-effect coefficients, on the same rows: the value relative,
# the gradient of its max-abs (float32 sums of up to 1.6M terms)
GAME_FN_RTOL = 1e-5
GAME_GRAD_RTOL = 1e-4
# run G, the CD objectives of the same two sweeps with the fixed effect on
# the scatter objective are printed beside the tiled run's, as a
# measurement (two paths whose sums differ in order: held by GAME_FN_RTOL
# at each sweep's coefficients); a refit of sweep 2's fixed effect from
# the same start and residual is bitwise on either path
GAME_RE_SAMPLE = 256  # entities whose gradient is checked in float64
# max-abs of a sampled entity's float64 gradient: 5x the first measurement
# (4.3e-4, NVIDIA H100 80GB HBM3 at 700 W); the gradient at a row solved
# against the wrong offsets or left at zero is of order 1
GAME_RE_GRAD_LIMIT = 2e-3
# densify by scatter vs compare-and-reduce where a row holds an index more
# than once: three or more addends sum in another order, so the error is
# held to 1e-6 of the sum of the addends' magnitudes
GAME_DENSIFY_RTOL = 1e-6
# Run H: the GAME drivers over Avro files at run G's widths; 512 users
# (2^13 rows each of training and validation; 4,096 users took 237 s with
# run W, and the script passed the 1,200 s limit; 1,024 users 95.4 s with
# run W, cut with the script at 867.9 s)
GAME_H_USERS = 512
GAME_H_PARTS = 4  # Avro part files each of training and validation rows
GAME_H_AUC_TOL = 1e-6


def user_features(users, picks, dim):
    """A user's pool of GAME_USER_POOL feature ids, distinct, spread over
    the user shard's dim - 1 features (the last is the intercept)."""
    return (users * 7919 + picks * 1031) % (dim - 1)


def game_rows(rng, users, w_global, w_user):
    """GLMix rows for the given users: global features (64 uniform, then
    the intercept), user features (32 from the user's pool, then the
    intercept), planted-model logistic labels; -> (global idx, global
    values, user idx, user values, labels, each user feature's index in
    its user's pool), widths padded to 8."""
    n, dim = len(users), len(w_global)
    g_idx = rng.integers(0, dim - 1, size=(n, NNZ_PER_ROW))
    g_val = rng.normal(size=(n, NNZ_PER_ROW)).astype(np.float32)
    picks = rng.integers(0, GAME_USER_POOL, size=(n, GAME_USER_NNZ))
    u_val = rng.normal(size=(n, GAME_USER_NNZ)).astype(np.float32)
    z = (g_val * w_global[g_idx]).sum(1) + (u_val * w_user[users[:, None], picks]).sum(1)
    labels = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-z))).astype(np.float32)

    def with_intercept(idx, val):
        k = idx.shape[1] + 1
        width = (k + 7) // 8 * 8
        out_i = np.zeros((n, width), np.int32)
        out_v = np.zeros((n, width), np.float32)
        out_i[:, : k - 1], out_v[:, : k - 1] = idx, val
        out_i[:, k - 1], out_v[:, k - 1] = dim - 1, 1.0
        return out_i, out_v

    return (*with_intercept(g_idx, g_val),
            *with_intercept(user_features(users[:, None], picks, dim), u_val), labels, picks)


def game_model(rng, n_users, dim):
    w_global = (rng.normal(size=dim) * 0.3).astype(np.float32)
    w_user = (rng.normal(size=(n_users, GAME_USER_POOL)) * 0.3).astype(np.float32)
    return w_global, w_user


def split_buckets(red, entities):
    """The random-effect dataset with each bucket cut into buckets of at
    most ``entities`` entities (bench.py's chunked banks)."""
    import dataclasses

    out = []
    for b in red.buckets:
        for s in range(0, b.num_entities, entities):
            sl = slice(s, s + entities)
            out.append(dataclasses.replace(
                b, entity_codes=b.entity_codes[sl], row_index=b.row_index[sl],
                indices=b.indices[sl], values=b.values[sl], labels=b.labels[sl],
                offsets=b.offsets[sl], weights=b.weights[sl],
            ))
    return dataclasses.replace(red, buckets=out)


class TimedCoordinate:
    """A coordinate whose updates and scores are timed on the card (each
    between two synchronizations), logged as (what, coordinate, seconds,
    K1 launches, result, readbacks before it, the model it got);
    ``on_first_update`` runs as its first update starts (a signal sent
    during sweep 1)."""

    def __init__(self, coord, k1, log, on_first_update=None):
        self.coord, self.k1, self.log = coord, k1, log
        self.on_first_update = on_first_update

    def __getattr__(self, name):
        return getattr(self.coord, name)

    def _timed(self, what, fn, *args):
        from photon_ml_tpu_torch.parallel import overlap

        torch.cuda.synchronize()
        readbacks = overlap.readback_stats()
        k0, t0 = self.k1.launches, time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        self.log.append((what, self.coord.name, time.perf_counter() - t0,
                         self.k1.launches - k0, out, readbacks, args[0], args[1:]))
        return out

    def update_model(self, model, residual=None):
        if self.on_first_update is not None:
            first, self.on_first_update = self.on_first_update, None
            first()
        return self._timed("update", self.coord.update_model, model, residual)

    def score(self, model):
        return self._timed("score", self.coord.score, model)


def game_cd(ds, red, kernel, k1, smi, label, sweeps=2, initial_model=None, profile=False):
    """CoordinateDescent.run(sweeps) over the fixed effect (``kernel``) and
    the user random effect, from ``initial_model``; with ``profile`` under
    torch.profiler, printing the device's busy time and idle share; ->
    (result, per-step log, the RE coordinate, the FE coordinate)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from photon_ml_tpu_torch.game import (
        CoordinateDescent,
        FixedEffectCoordinate,
        RandomEffectCoordinate,
        RandomEffectOptimizationProblem,
    )
    from photon_ml_tpu_torch.ops.losses import LOGISTIC
    from photon_ml_tpu_torch.optim.config import (
        OptimizerConfig,
        OptimizerType,
        RegularizationContext,
        RegularizationType,
    )
    from photon_ml_tpu_torch.optim.problem import create_glm_problem
    from photon_ml_tpu_torch.task import TaskType

    log = []
    l2 = RegularizationContext(RegularizationType.L2)
    fe = FixedEffectCoordinate(
        name="global", dataset=ds,
        problem=create_glm_problem(
            TaskType.LOGISTIC_REGRESSION, DIM, config=OptimizerConfig(max_iter=50),
            regularization=l2, intercept_index=DIM - 1, kernel=kernel,
        ),
        feature_shard_id="global", reg_weight=1.0,
    )
    re = RandomEffectCoordinate(
        name="per-user", dataset=ds, re_dataset=red,
        problem=RandomEffectOptimizationProblem(
            LOGISTIC,
            OptimizerConfig(OptimizerType.LBFGS, max_iter=30, tolerance=1e-5, lbfgs_history=5),
            l2, reg_weight=1.0,
        ),
    )
    coords = {"global": TimedCoordinate(fe, k1, log), "per-user": TimedCoordinate(re, k1, log)}
    cd = CoordinateDescent(coords, ds, TaskType.LOGISTIC_REGRESSION)
    if profile:
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            result = cd.run(sweeps, initial_model=initial_model)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        kernels = sorted(
            (e for e in prof.key_averages() if e.device_type.name == "CUDA"),
            key=lambda e: e.self_device_time_total, reverse=True,
        )
        busy = sum(e.self_device_time_total for e in kernels) / 1e6
        top = "; ".join(
            f"{e.self_device_time_total / 1e3:.3f} ms in {e.count} calls: {e.key[:60]}"
            for e in kernels[:6]
        )
        say(f"game run G profile ({smi}): one sweep {seconds!r} s host, {busy!r} s device "
            f"busy, idle share {1 - busy / seconds!r}; top kernels: {top}")
    else:
        t0 = time.perf_counter()
        result = cd.run(sweeps, initial_model=initial_model)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    hist = result.objective_history
    say(f"game run G {label} ({smi}): CD {sweeps} sweeps {seconds!r} s; objective history {hist}")
    if not all(np.isfinite(hist)) or any(b > a for a, b in zip(hist, hist[1:])):
        fail(f"game run G {label}: the CD objective is not finite and non-increasing: {hist}")
    return result, log, re, fe


def game_re_gradient_rows(red, bank, fe_score, entities):
    """Each entity's gradient at its bank row, in float64 from its
    definition: sum_s w_s (sigmoid(z_s) - y_s) x_s + l2 c with z_s = x_s .
    c + o_s, o_s the fixed effect's score (the residual its last update
    saw), l2 = 1; -> (the entities' codes, [m, D] gradients), bucket by
    bucket (padding rows have weight and values 0)."""
    dev = bank.device
    want = torch.as_tensor(np.asarray(entities, dtype=np.int64), device=dev)
    codes, grads = [], []
    for b in red.buckets:
        ecodes = torch.as_tensor(b.entity_codes, device=dev).long()
        sel = torch.nonzero(torch.isin(ecodes, want)).flatten()
        if sel.numel() == 0:
            continue
        m = sel.numel()
        rows = torch.as_tensor(b.row_index, device=dev)[sel].long()
        ix = torch.as_tensor(b.indices, device=dev)[sel].long()
        v = torch.as_tensor(b.values, device=dev)[sel].double()
        y = torch.as_tensor(b.labels, device=dev)[sel].double()
        w = torch.as_tensor(b.weights, device=dev)[sel].double()
        off = torch.where(rows >= 0, fe_score[rows.clamp_min(0)].double(), 0.0)
        c = bank[ecodes[sel]].double()
        flat = ix.reshape(m, -1)
        z = (v * torch.gather(c, 1, flat).reshape(v.shape)).sum(-1) + off
        r = w * (torch.sigmoid(z) - y)
        g = torch.zeros_like(c).scatter_add_(1, flat, (v * r[..., None]).reshape(m, -1)) + c
        codes.append(ecodes[sel])
        grads.append(g)
    if not codes:
        return want[:0], torch.zeros(0, bank.shape[1], dtype=torch.float64, device=dev)
    return torch.cat(codes), torch.cat(grads)


def game_re_gradients(ds, red, bank, fe_score, sample):
    """Max-abs of each sampled entity's float64 gradient at its bank row
    (:func:`game_re_gradient_rows`)."""
    _, g = game_re_gradient_rows(red, bank, fe_score, sample)
    return float(g.abs().max()) if g.numel() else 0.0


def game_densify_check(red, smi, device):
    """The scatter densification against the compare-and-reduce version on
    the first bucket: bitwise where a row has no duplicate index, within
    GAME_DENSIFY_RTOL of the addends' magnitudes where it has one; ->
    (rows with a duplicate, max relative error on them)."""
    from photon_ml_tpu_torch.game.random_effect import densify, densify_compare

    b = red.buckets[0]
    ix = torch.as_tensor(b.indices, device=device).long()
    v = torch.as_tensor(b.values, device=device)
    got = densify(ix, v, red.local_dim)
    plain = densify_compare(ix, v, red.local_dim, chunk=512)
    key = torch.where(v != 0, ix, -1 - torch.arange(ix.shape[-1], device=device))
    srt = key.sort(dim=-1).values
    dup = (srt[..., 1:] == srt[..., :-1]).any(dim=-1)
    if not torch.equal(got[~dup], plain[~dup]):
        fail("game densify: the scatter differs from compare-and-reduce on rows without duplicates")
    mag = densify(ix, v.abs(), red.local_dim)[dup]
    err = float(((got[dup] - plain[dup]).abs() / mag.clamp_min(1e-30)).max()) if bool(dup.any()) else 0.0
    n_dup = int(dup.sum())
    say(f"game densify ({smi}): bucket of {b.num_entities} entities x {b.capacity} rows x "
        f"{red.local_dim} local features; rows without a duplicate index bitwise equal; "
        f"{n_dup} rows with one, max relative error {err!r}")
    if err > GAME_DENSIFY_RTOL:
        fail(f"game densify: rows with a duplicate index part by {err!r}")
    return n_dup, err


# K4 (the per-entity products) at run G's first bucket, and the bucket
# witness: what its order buys on the card
K4_RESULTS = {}
K4_RTOL = 1e-5  # K4 vs its plain version (torch.bmm, .sum, vector_norm), of the output's scale
WITNESS_ENTITIES = 8192  # run G's first bucket, cut to this many entities
WITNESS_F64_ENTITIES = 512  # of them, solved in float64 on the host too


def product_bound_ms(E, I, J, K, reads):
    """Least time for ``E * I * J`` outputs of ``K`` products each, with
    ``reads`` input floats read once and the outputs written once: the
    larger of bytes over HBM bandwidth and the products' multiplies and
    adds over the f32 peak (-> ms, 'bytes' or 'operations')."""
    byte_s = 4 * (reads + E * I * J) / HBM_BYTES_PER_S
    op_s = 2 * E * I * J * K / F32_FLOPS_PER_S
    return 1e3 * max(byte_s, op_s), "bytes" if byte_s >= op_s else "operations"


def k4_checks(label, calls, smi):
    """Each of ``calls`` (name -> (kernel, plain version, ``*_ordered``
    form, library call, (bound ms, bound by))): bitwise its ordered form
    (row_sum's order, on the card), within K4_RTOL of its plain version's
    scale, then timed beside the plain version and the library call. ->
    the kernels line's fields (the calls' times summed), each call's own
    under ``calls``."""
    out = {"max_abs_err": 0.0, "max_rel_err": 0.0, "ordered_bitwise": True, "ms": 0.0,
           "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0, "calls": {}}
    bound_by = set()
    for name, (kern, plain, ordered, library, (bound, by)) in calls.items():
        got, want = kern(), plain()
        same = bool(torch.equal(got, ordered()))
        err = float((got - want).abs().max())
        rel = err / max(float(want.abs().max()), 1e-30)
        if not same:
            fail(f"K4 {label} {name}: the kernel's bits are not row_sum's order's")
        if not rel <= K4_RTOL:
            fail(f"K4 {label} {name}: {rel!r} of scale off its plain version")
        ms, plain_ms, library_ms = time_ms(kern), time_ms(plain), time_ms(library)
        out["calls"][name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                  bound_ms=bound, bound_by=by, max_abs_err=err)
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out["max_rel_err"] = max(out["max_rel_err"], rel)
        for key, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", library_ms),
                       ("bound_ms", bound)):
            out[key] += v
        bound_by.add(by)
    out["bound_by"] = "operations" if bound_by == {"operations"} else "bytes"
    say(f"k4 {label} ({smi}): " + "; ".join(
        f"{n} {v['ms']!r} ms (plain {v['plain_ms']!r} ms, library {v['library_ms']!r} ms, "
        f"bound {v['bound_ms']!r} ms by {v['bound_by']}, max abs err {v['max_abs_err']!r})"
        for n, v in out["calls"].items()) + "; every output bitwise row_sum's order")
    return out


def row_dot_calls(rng, shapes, device):
    """K4's row kernel checks at each ``[n, k]`` of ``shapes`` (normal
    operands from ``rng``): row_dot, row_norm (its operand read once) and
    row_dots of TRON's four pairs over three banks, ``(x, y), (x, x), (z,
    x), (z, z)``, in one launch. The plain versions are ``.sum``,
    ``vector_norm`` and a stack of ``.sum``s; the library calls
    ``torch.linalg.vecdot``, ``vector_norm`` and one ``vecdot`` of the
    pairs stacked beforehand."""
    from photon_ml_tpu_torch.ops.kernels import entity_products as k4

    calls = {}
    for n, k in shapes:
        a, b, z = (torch.as_tensor(rng.normal(size=(n, k)).astype(np.float32), device=device)
                   for _ in range(3))
        if not hasattr(k4, "row_dots"):  # a checkout before the row kernel
            z = None
        calls[f"dot_{n}x{k}"] = (
            lambda a=a, b=b: k4.row_dot(a, b), lambda a=a, b=b: k4.row_dot_plain(a, b),
            lambda a=a, b=b: k4.row_dot_ordered(a, b),
            lambda a=a, b=b: torch.linalg.vecdot(a, b), product_bound_ms(n, 1, 1, k, 2 * n * k))
        calls[f"norm_{n}x{k}"] = (
            lambda a=a: k4.row_norm(a), lambda a=a: k4.row_norm_plain(a),
            lambda a=a: torch.sqrt(k4.row_dot_ordered(a, a)),
            lambda a=a: torch.linalg.vector_norm(a, dim=-1), product_bound_ms(n, 1, 1, k, n * k))
        if z is None:
            continue
        pairs = [(a, b), (a, a), (z, a), (z, z)]
        left, right = (torch.stack(t) for t in zip(*pairs))
        calls[f"dots4_{n}x{k}"] = (
            lambda p=pairs: k4.row_dots(p),
            lambda p=pairs: torch.stack([k4.row_dot_plain(x, y) for x, y in p]),
            lambda p=pairs: torch.stack([k4.row_dot_ordered(x, y) for x, y in p]),
            lambda x=left, y=right: torch.linalg.vecdot(x, y),
            product_bound_ms(4 * n, 1, 1, k, 3 * n * k))
    return calls


def game_products_check(red, smi, device):
    """K4 at run G's first bucket, as the Newton solver calls it: the Gram
    X X^T, X c, X^T r (a strided view) and G v, and the row dots and norms
    of the per-entity values ([E, S]) and coefficients ([E, D]); each
    checked and timed by ``k4_checks`` (the library call of the Gram and
    the matvecs is torch.bmm, which is also their plain version). -> per
    wrapper (gram, bmv, row_dot), the kernels line's fields."""
    from photon_ml_tpu_torch.game.random_effect import densify
    from photon_ml_tpu_torch.ops.kernels import entity_products as k4

    b = red.buckets[0]
    ix = torch.as_tensor(b.indices, device=device).long()
    X = densify(ix, torch.as_tensor(b.values, device=device), red.local_dim)
    E, S, D = X.shape
    rng = np.random.default_rng(16)
    c = torch.as_tensor(rng.normal(size=(E, D)).astype(np.float32), device=device)
    r = torch.as_tensor(rng.normal(size=(E, S)).astype(np.float32), device=device)
    Xt = X.transpose(1, 2)
    G = k4.gram(X)
    out = {"gram": k4_checks(f"run G bucket {E} x {S} x {D} gram", {
        "gram": (lambda: k4.gram(X), lambda: k4.gram_plain(X), lambda: k4.gram_ordered(X),
                 lambda: k4.gram_plain(X), product_bound_ms(E, S, S, D, E * S * D)),
    }, smi), "bmv": k4_checks(f"run G bucket {E} x {S} x {D} bmv", {
        "X_c": (lambda: k4.bmv(X, c), lambda: k4.bmv_plain(X, c),
                lambda: k4.bmv_ordered(X, c), lambda: k4.bmv_plain(X, c),
                product_bound_ms(E, S, 1, D, E * S * D + E * D)),
        "Xt_r": (lambda: k4.bmv(Xt, r), lambda: k4.bmv_plain(Xt, r),
                 lambda: k4.bmv_ordered(Xt, r), lambda: k4.bmv_plain(Xt, r),
                 product_bound_ms(E, D, 1, S, E * S * D + E * S)),
        "G_r": (lambda: k4.bmv(G, r), lambda: k4.bmv_plain(G, r),
                lambda: k4.bmv_ordered(G, r), lambda: k4.bmv_plain(G, r),
                product_bound_ms(E, S, 1, S, E * S * S + E * S)),
    }, smi), "row_dot": k4_checks(f"run G bucket {E} x {S} x {D} row_dot",
                                  row_dot_calls(rng, ((E, S), (E, D)), device), smi)}
    for v in out.values():
        v["shape"] = [E, S, D]
    del X, G
    return out


def witness_against_float64(problem, kind, rows, start, ix, v, lab, off, w):
    """The card's float32 rows of a bucket's first WITNESS_F64_ENTITIES
    entities against the same solve in float64 on the host: -> (the
    largest (f(card row) - f(float64 row)) / |f(start)| of an entity's
    float64 objective f, the rows' error of the float64 rows' scale). The
    solver stops when an iteration changes f by tol |f(start)| or less, so
    a float32 row is held to that gap; by strong convexity (l2 = 1) it
    bounds the row's error by sqrt(2 tol |f(start)|)."""
    from photon_ml_tpu_torch.game.random_effect import densify
    from photon_ml_tpu_torch.ops.losses import LOGISTIC

    h = min(WITNESS_F64_ENTITIES, rows.shape[0])
    host = [t[:h].cpu() for t in (ix, v, lab, off, w)]
    ix64, v64, lab64, off64, w64 = host[:1] + [t.double() for t in host[1:]]
    start64 = start[:h].cpu().double()
    c64, _, _ = problem._solve(kind, start64, ix64, v64, lab64, off64, w64, 0.0, 1.0)
    X = densify(ix64, v64, start64.shape[1])

    def f(c):
        z = torch.bmm(X, c[..., None])[..., 0] + off64
        return (w64 * LOGISTIC.value(z, lab64)).sum(-1) + 0.5 * (c * c).sum(-1)

    card = rows[:h].cpu().double()
    gap = float(((f(card) - f(c64)) / f(start64).abs()).max())
    return gap, scale_err(card, c64)


def game_bucket_witness(red, offsets, smi, device):
    """Run G's first bucket, cut to WITNESS_ENTITIES, solved whole and as
    padded sub-blocks of other entity counts (the pod's block layout:
    every other entity padded to 4,130, every third to 2,777) by the dense
    Newton solver, dense L-BFGS and TRON, at the given row-aligned
    offsets: the shared entities' rows, iterations and stop reasons must
    be bitwise equal. -> per solver, the entities and the spread of their
    iterations."""
    import dataclasses

    from photon_ml_tpu_torch.optim.config import OptimizerType

    b = red.buckets[0]
    n = min(WITNESS_ENTITIES, b.num_entities)
    dev = torch.device(device)

    def up(a, dtype=None):
        t = torch.as_tensor(np.asarray(a[:n]), device=dev)
        return t if dtype is None else t.to(dtype)

    rows = torch.as_tensor(np.asarray(b.row_index[:n]), device=dev).long()
    off_all = torch.as_tensor(offsets, device=dev)
    off = torch.where(rows >= 0, off_all[rows.clamp_min(0)], 0.0)
    ix, v = up(b.indices, torch.int64), up(b.values, torch.float32)
    lab, w = up(b.labels, torch.float32), up(b.weights, torch.float32)
    start = torch.zeros(n, red.local_dim, device=dev)
    base = pod_problem()
    tron = dataclasses.replace(
        base, config=dataclasses.replace(base.config, optimizer_type=OptimizerType.TRON))
    out = {}
    for label, problem, kind in (("newton", base, "newton"), ("lbfgs", base, "dense"),
                                 ("tron", tron, "dense")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        whole, it, rs = problem._solve(kind, start, ix, v, lab, off, w, 0.0, 1.0)
        it = torch.as_tensor(it, device=dev)
        rs = torch.as_tensor(rs, device=dev)
        torch.cuda.synchronize()
        whole_s = time.perf_counter() - t0
        f64_gap, f64_row = witness_against_float64(problem, kind, whole, start, ix, v, lab, off, w)
        if not f64_gap <= problem.config.tolerance:
            fail(f"bucket witness {label}: an entity's float64 objective at its card row is "
                 f"{f64_gap!r} of its objective at zero over the float64 solve's")
        for pick, width in ((torch.arange(0, n, 2, device=dev), 4130),
                            (torch.arange(1, n, 3, device=dev), 2777)):
            m = pick.numel()

            def block(t):
                blk = t.new_zeros((width,) + tuple(t.shape[1:]))
                blk[:m] = t[pick]
                return blk

            got, git, grs = problem._solve(kind, block(start), block(ix), block(v), block(lab),
                                           block(off), block(w), 0.0, 1.0)
            git = torch.as_tensor(git, device=dev)[:m]
            grs = torch.as_tensor(grs, device=dev)[:m]
            if not (torch.equal(got[:m], whole[pick]) and torch.equal(git, it[pick])
                    and torch.equal(grs, rs[pick])):
                fail(f"bucket witness {label}: a block of {width} gives its {m} entities "
                     "other bits than the whole bucket")
        out[label] = dict(entities=n, whole_s=whole_s, iterations_min=int(it.min()),
                          iterations_max=int(it.max()), f64_entities=WITNESS_F64_ENTITIES,
                          f64_objective_gap=f64_gap, f64_row_err=f64_row)
    say(f"bucket witness ({smi}): run G's first bucket cut to {n} entities, solved whole and as "
        f"blocks of 4130 (every other entity) and 2777 (every third): rows, iterations and "
        f"reasons bitwise for " + ", ".join(
            f"{k} ({v['whole_s']!r} s whole, iterations {v['iterations_min']}-"
            f"{v['iterations_max']}; against float64 on the host over the first "
            f"{v['f64_entities']} entities: objective gap {v['f64_objective_gap']!r} of |f0|, "
            f"rows {v['f64_row_err']!r} of scale)" for k, v in out.items()))
    return out


def sched_csr(sched, n_src):
    """One pass's matrix as torch.sparse CSR (output x source): the
    schedule's real entries, so ``csr @ src`` is the pass (the yardstick
    the port never calls)."""
    G, W = sched.num_steps, sched.window
    v = sched.vals[:G].reshape(-1)
    rows = (sched.step_out[:, None].long() * W + sched.out_pos[:G]).reshape(-1)
    cols = (sched.step_in[:, None].long() * W + sched.in_pos[:G]).reshape(-1)
    keep = v != 0
    return torch.sparse_coo_tensor(
        torch.stack([rows[keep], cols[keep]]), v[keep], (sched.num_out_blocks * W, n_src)
    ).coalesce().to_sparse_csr()


def game_k1_times(k1, tb, rng, smi, label="game", library=False):
    """K1 against its plain version at the GAME fixed effect's shape, each
    output held to its own magnitude, |got - ref| <= 1e-6 + RTOL * mag with
    mag the plain pass over |values| and |source| (the intercept's output
    sums 1.6M terms of both signs, an ordinary feature's about 100); then
    its device ms per z / g pass with their bounds and, with ``library``,
    the plain version's and one torch.sparse CSR matvec's; -> those
    numbers."""
    win = tb.params.window
    w = torch.as_tensor(rng.normal(size=tb.dim).astype(np.float32), device=tb.device)
    c = torch.as_tensor(rng.normal(size=tb.num_rows).astype(np.float32), device=tb.device)
    err = (0.0, 0.0)
    for name, sched, src, n_out, vals in pass_args(tb, w, c):
        got = k1.bilinear_pass(sched, src, n_out, win, vals=vals)
        ref = k1.bilinear_pass_plain(sched, src, n_out, win, vals=vals)
        mag = k1.bilinear_pass_plain(
            sched, src.abs(), n_out, win, vals=(sched.vals if vals is None else vals).abs())
        diff = (got - ref).abs()
        abs_err = float(diff.max())
        rel_err = float((diff / mag.clamp_min(1e-30)).max())
        bad = int((diff > 1e-6 + RTOL * mag).sum())
        say(f"k1_check {label} {name}: max_abs_err={abs_err!r} max error over the output's "
            f"magnitude {rel_err!r}; outputs over 1e-6 + {RTOL!r} x magnitude: {bad}")
        if bad or not np.isfinite(abs_err):
            fail(f"k1_check {label} {name}: {bad} outputs disagree with the plain version")
        err = tuple(map(max, err, (abs_err, rel_err)))
    from photon_ml_tpu_torch.ops.kernels import grid_bilinear_pass as k2

    repeat_checks(k1, k2, tb, rng, label)
    z_ms = time_ms(lambda: k1.bilinear_pass(tb.z_sched, w, tb.num_row_blocks, win))
    g_ms = time_ms(lambda: k1.bilinear_pass(tb.g_sched, c, tb.num_feat_blocks, win))
    z_bound, _, entries = pass_bound_ms(tb.z_sched, tb.dim, tb.num_rows)
    g_bound, _, _ = pass_bound_ms(tb.g_sched, tb.num_rows, tb.dim)
    out = dict(z_ms=z_ms, g_ms=g_ms, z_bound_ms=z_bound, g_bound_ms=g_bound,
               max_abs_err=err[0], max_rel_err=err[1], entries=entries)
    if library:
        z_csr, g_csr = sched_csr(tb.z_sched, tb.dim), sched_csr(tb.g_sched, tb.num_rows)
        out.update(
            z_plain_ms=time_ms(lambda: k1.bilinear_pass_plain(tb.z_sched, w, tb.num_row_blocks, win)),
            g_plain_ms=time_ms(lambda: k1.bilinear_pass_plain(tb.g_sched, c, tb.num_feat_blocks, win)),
            z_library_ms=time_ms(lambda: z_csr @ w[:, None]),
            g_library_ms=time_ms(lambda: g_csr @ c[:, None]),
        )
        del z_csr, g_csr
    say(f"{label} K1 ({smi}): {entries} entries; z {z_ms!r} ms (bound {z_bound!r}), "
        f"g {g_ms!r} ms (bound {g_bound!r}); max_abs_err {err[0]!r}" + "".join(
            f"; {k} {out[k]!r}" for k in ("z_plain_ms", "g_plain_ms", "z_library_ms",
                                          "g_library_ms") if k in out))
    return out


def game_objective_parity(ds, tb, log, smi):
    """The tiled objective (K1 over ``tb``) against the scatter objective
    (gather / index_add_) on the same rows, at each sweep's fixed-effect
    coefficients of the tiled run, l2 = 1."""
    from photon_ml_tpu_torch.ops import tiled_sparse as ts
    from photon_ml_tpu_torch.ops.losses import LOGISTIC
    from photon_ml_tpu_torch.ops.objective import GLMObjective

    batch = ds.batch_for_shard("global")
    tiled, scatter = ts.TiledGLMObjective(LOGISTIC, DIM), GLMObjective(LOGISTIC, DIM)
    fits = [out[0] for what, name, _, _, out, *_ in log if what == "update" and name == "global"]
    for sweep, model in enumerate(fits, 1):
        w = model.model.means
        vt, gt = tiled.value_and_gradient(w, tb, 1.0)
        vs, gs = scatter.value_and_gradient(w, batch, 1.0)
        dv = abs(float(vt) - float(vs)) / abs(float(vs))
        dg = float((gt - gs).abs().max()) / float(gs.abs().max())
        say(f"game run G sweep {sweep} objective ({smi}): tiled {float(vt)!r} vs scatter "
            f"{float(vs)!r}, value gap {dv!r}, gradient gap {dg!r} of its max-abs")
        if not (dv <= GAME_FN_RTOL and dg <= GAME_GRAD_RTOL):
            fail(f"game run G: the tiled objective is off the scatter one at sweep {sweep}")


def game_fe_refit(fe, log, label, smi):
    """Refit sweep 2's fixed effect from the start and the residual it got
    in the run: the coefficients must be the run's, bitwise; -> the refit's
    seconds."""
    fe_up = [e for e in log if e[0] == "update" and e[1] == "global"][1]
    start, (residual,) = fe_up[6], fe_up[7]
    t0 = time.perf_counter()
    model, result = fe.update_model(start, residual)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    same = torch.equal(model.model.means, fe_up[4][0].model.means)
    say(f"game run G {label} refit of sweep 2's fixed effect ({smi}): {seconds!r} s, "
        f"{result.iterations} iterations; coefficients bitwise the run's {same}")
    if not same:
        fail(f"game run G: the {label} fixed effect's refit is not bitwise")
    return seconds


# run G's sweep-2 fixed effect refit on both paths with a cap it does not
# reach, stopping where an iteration moves the objective by under 1e-10 of
# its start (below float32's resolution of it): their objectives within
# this, relative (ROADMAP Queue 3). At the trainers' default tolerance,
# 1e-7, one slow L-BFGS step stops a fit early: printed, a measurement.
GAME_FE_CONVERGED_CAP = 500
GAME_FE_CONVERGED_TOL = 1e-10
GAME_FE_CONVERGED_RTOL = 1e-4


def game_fe_converged(tiled_fe, scatter_fe, log, smi):
    """Refit sweep 2's fixed effect of the tiled run from its start and
    residual on the tiled (K1) and the scatter objective, capped at
    GAME_FE_CONVERGED_CAP iterations, at the default tolerance and at
    GAME_FE_CONVERGED_TOL: at the latter the two fits' objectives must
    agree within GAME_FE_CONVERGED_RTOL (at the run's cap of 50 they
    part), neither reaching the cap."""
    import dataclasses

    t_check = time.perf_counter()
    fe_up = [e for e in log if e[0] == "update" and e[1] == "global"][1]
    start, (residual,) = fe_up[6], fe_up[7]
    for tol in (tiled_fe.problem.config.tolerance, GAME_FE_CONVERGED_TOL):
        fits = {}
        for label, fe in (("tiled", tiled_fe), ("scatter", scatter_fe)):
            config = dataclasses.replace(
                fe.problem.config, max_iter=GAME_FE_CONVERGED_CAP, tolerance=tol)
            capped = dataclasses.replace(fe, problem=dataclasses.replace(fe.problem, config=config))
            t0 = time.perf_counter()
            _, result = capped.update_model(start, residual)
            torch.cuda.synchronize()
            fits[label] = dict(value=float(result.value), iterations=result.iterations,
                               reason=result.reason_name, seconds=time.perf_counter() - t0)
        gap = abs(fits["tiled"]["value"] - fits["scatter"]["value"]) / abs(fits["scatter"]["value"])
        say(f"game run G sweep-2 fixed effect, cap {GAME_FE_CONVERGED_CAP}, tolerance {tol!r} "
            f"({smi}): tiled {fits['tiled']}, scatter {fits['scatter']}; objectives {gap!r} "
            f"apart" + (f" (limit {GAME_FE_CONVERGED_RTOL!r})" if tol == GAME_FE_CONVERGED_TOL
                        else " (a measurement)"))
    say(f"game run G converged refits: {time.perf_counter() - t_check!r} s of host time ({smi})")
    # the loop ends on the converged pair
    if not gap <= GAME_FE_CONVERGED_RTOL or any(
            f["iterations"] >= GAME_FE_CONVERGED_CAP for f in fits.values()):
        fail("game run G: the converged tiled and scatter fixed effects disagree")


def game_data(seed, device):
    """Run G's rows as a GameDataset built from arrays (bench.py's
    ShardData), and its user random-effect dataset cut into buckets of
    GAME_BUCKET_ENTITIES."""
    from photon_ml_tpu_torch.game import EntityIndex, GameDataset, ShardData
    from photon_ml_tpu_torch.game import RandomEffectDataConfiguration, build_random_effect_dataset
    from photon_ml_tpu_torch.utils.index_map import IdentityIndexMap

    t0 = time.perf_counter()
    rng = np.random.default_rng([seed, 3])
    w_global, w_user = game_model(rng, GAME_USERS, DIM)
    users = np.repeat(np.arange(GAME_USERS), GAME_ROWS_PER_USER)
    n = len(users)
    g_idx, g_val, u_idx, u_val, labels, picks = game_rows(rng, users, w_global, w_user)
    imap = IdentityIndexMap(DIM - 1, add_intercept=True)
    # run F's IDENTITY user shard: each user feature folded onto its index
    # in the user's pool, the intercept after them (an IDENTITY projection
    # table is [entities, shard width]: 400 GB at 2^20)
    pool_idx = u_idx.copy()
    pool_idx[:, :GAME_USER_NNZ] = picks
    pool_idx[:, GAME_USER_NNZ] = GAME_USER_POOL
    ds = GameDataset(
        uids=[""] * n, labels=labels, offsets=np.zeros(n, np.float32),
        weights=np.ones(n, np.float32),
        shards={"global": ShardData(g_idx, g_val, imap, DIM - 1),
                "user": ShardData(u_idx, u_val, imap, DIM - 1),
                "user_pool": ShardData(
                    pool_idx, u_val, IdentityIndexMap(GAME_USER_POOL, add_intercept=True),
                    GAME_USER_POOL,
                )},
        entity_codes={"userId": users.astype(np.int32)},
        entity_indexes={"userId": EntityIndex.build("userId", [f"{u:06d}" for u in range(GAME_USERS)])},
        num_real_rows=n, device=torch.device(device),
    )
    make_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    red = build_random_effect_dataset(ds, RandomEffectDataConfiguration("userId", "user"), seed=seed)
    red_s = time.perf_counter() - t0
    red = split_buckets(red, GAME_BUCKET_ENTITIES)
    say(f"game run G data: {n} rows ({GAME_USERS} users x {GAME_ROWS_PER_USER}), global shard "
        f"{DIM} features x {g_idx.shape[1]} slots, user shard {GAME_USER_NNZ} + intercept a row "
        f"from pools of {GAME_USER_POOL}; made in {make_s!r} s; random-effect dataset built in "
        f"{red_s!r} s: {len(red.buckets)} buckets of {[b.num_entities for b in red.buckets]} "
        f"entities x {red.buckets[0].capacity} rows, bank D = {red.local_dim}")
    return ds, red


def game_run_g(seed, smi, k1, device="cuda"):
    """Run G; -> (K1's launches over its two sweeps on the tiled problem,
    K1's times and errors at its shape, its GameDataset for run F)."""
    from photon_ml_tpu_torch.ops import tiled_sparse as ts

    ds, red = game_data(seed, device)

    # the tiled fixed effect (K1): two sweeps, one schedule build
    from photon_ml_tpu_torch.ops.kernels import entity_products as k4

    ts.tilings, ts.tiling_seconds = 0, 0.0
    k1.launches = 0
    k4.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    result, log, re, fe = game_cd(ds, red, "tiled", k1, smi, "tiled")
    peak = torch.cuda.max_memory_allocated()
    game_launches = k1.launches
    K4_RESULTS["game_launches"] = dict(k4.launches_by)
    say(f"game run G K4 launches over both sweeps ({smi}): row_dot "
        f"{k4.launches_by['row_dot']}, by wrapper {dict(k4.launches_by)}")
    idle = [kind for kind, n in k4.launches_by.items() if n == 0]
    if idle and torch.device(device).type == "cuda":
        fail(f"game run G: the random effect launched no K4 {idle}")
    tiled_refit = game_fe_refit(fe, log, "tiled", smi)
    kinds = sorted({re.problem._bucket_kind(b, red.local_dim) for b in red.buckets})
    for it in range(2):
        steps = log[2 + 4 * it: 6 + 4 * it]  # after the two initial scores
        fe_up, fe_sc, re_up, re_sc = steps
        tracker = re_up[4][1]
        say(f"game run G sweep {it + 1} ({smi}): FE fit {fe_up[2]!r} s, {fe_up[4][1].iterations} "
            f"iterations, {fe_up[3]} K1 launches, reason {fe_up[4][1].reason_name}; FE score "
            f"{fe_sc[2]!r} s; RE bank update {re_up[2]!r} s ({kinds}), "
            f"{GAME_USERS / re_up[2]!r} entities/s, iterations mean "
            f"{tracker.iterations_mean!r} max {tracker.iterations_max}, reasons "
            f"{tracker.reason_counts}; RE score {re_sc[2]!r} s")
    say(f"game run G ({smi}): schedule builds over both sweeps {ts.tilings}, "
        f"{ts.tiling_seconds!r} s (in sweep 1's FE fit); K1 launches {game_launches}; "
        f"device memory peak {peak} bytes")
    if ts.tilings != 1:
        fail(f"game run G: {ts.tilings} schedule builds over two sweeps, not 1")
    if game_launches == 0:
        fail("game run G: the tiled fixed effect launched no K1")
    # run P (phase 15): the user random effect at sweep 1's residual
    POD_INPUTS["red"] = red
    POD_INPUTS["offsets"] = (ds.row_tensors()[1] + log[4][7][0]).cpu().numpy()

    # K1 at the shape this path gives it (an intercept column in every row)
    tb = ts.ensure_tiled(ds.batch_for_shard("global"), DIM, device=device)
    if ts.tilings != 1:
        fail("game run G: the in-memory tier missed")
    game_k1 = game_k1_times(k1, tb, np.random.default_rng([seed, 7]), smi, library=True)

    # where a warm sweep's time goes (the tier hits: no schedule build)
    game_cd(ds, red, "tiled", k1, smi, "profiled", sweeps=1, initial_model=result.model,
            profile=True)

    # the random effect's optimality on a sample, in float64
    fe_model = result.model.models["global"]
    fe_score = fe_model.score(ds)
    sample = np.random.default_rng([seed, 4]).choice(GAME_USERS, GAME_RE_SAMPLE, replace=False)
    grad = game_re_gradients(ds, red, result.model.models["per-user"].bank, fe_score, sample)
    say(f"game run G ({smi}): RE gradient max-abs over {GAME_RE_SAMPLE} sampled entities "
        f"(float64) {grad!r}, limit {GAME_RE_GRAD_LIMIT!r}")
    if not grad <= GAME_RE_GRAD_LIMIT:
        fail(f"game run G: a sampled entity's gradient is {grad!r}")
    game_densify_check(red, smi, device)
    K4_RESULTS["check"] = game_products_check(red, smi, device)
    K4_RESULTS["witness"] = game_bucket_witness(red, POD_INPUTS["offsets"], smi, device)

    # the tiled objective against the scatter objective at each sweep's FE
    game_objective_parity(ds, tb, log, smi)

    # the same two sweeps with the fixed effect on the scatter objective:
    # its objective non-increasing (game_cd), the gaps a measurement
    scatter, s_log, _, s_fe = game_cd(ds, red, "scatter", k1, smi, "scatter")
    game_fe_refit(s_fe, s_log, "scatter", smi)
    game_fe_converged(fe, s_fe, log, smi)
    gaps = [abs(a - b) / abs(b) for a, b in zip(result.objective_history, scatter.objective_history)]
    say(f"game run G ({smi}): tiled vs scatter CD objectives, relative gaps {gaps}, "
        f"the largest {max(gaps)!r} {'within' if max(gaps) <= 1e-4 else 'over'} 1e-4 "
        f"(a measurement, not a check; neither path varies from run to run: the "
        f"sweep-2 refits were bitwise, the tiled one {tiled_refit})")
    return game_launches, game_k1, ds


GAME_H_SCHEMA_EXTRA = {"name": "userFeatures", "type": {"type": "array", "items": "FeatureAvro"}}


def game_h_part(args):
    """One Avro part file of run H's rows (runs in a worker process):
    TrainingExampleAvro-shaped records plus a userFeatures bag, the user
    id in metadataMap."""
    seed, path, kind, part, n_parts, n_users, dim = args
    from photon_ml_tpu_torch.io import schemas
    from photon_ml_tpu_torch.io.avro_codec import write_container

    w_global, w_user = game_model(np.random.default_rng([seed, 5]), n_users, dim)
    rng = np.random.default_rng([seed, 6, kind == "train", part])
    if kind == "train":
        users = np.repeat(np.arange(n_users), GAME_ROWS_PER_USER)
    else:
        users = rng.integers(0, n_users, size=n_users * GAME_ROWS_PER_USER)
    users = np.array_split(users, n_parts)[part]
    g_idx, g_val, u_idx, u_val, labels, _ = game_rows(rng, users, w_global, w_user)
    icept = dim - 1

    def bag(idx, val):  # the driver adds the intercept itself
        return [{"name": str(i), "term": "", "value": v}
                for i, v in zip(idx, val) if v != 0 and i != icept]

    recs = [{
        "uid": f"{kind}-{part}-{r}", "label": float(labels[r]),
        "features": bag(g_idx[r].tolist(), g_val[r].tolist()),
        "userFeatures": bag(u_idx[r].tolist(), u_val[r].tolist()),
        "metadataMap": {"userId": f"user{users[r]:05d}"}, "weight": None, "offset": None,
    } for r in range(len(users))]
    schema = dict(schemas.TRAINING_EXAMPLE_AVRO)
    schema["fields"] = list(schema["fields"]) + [GAME_H_SCHEMA_EXTRA]
    write_container(path, schema, recs)
    return len(recs)


def game_run_h(seed, smi, k1, device_args=(), then=None):
    """Run H: ``game_training_driver.main`` and ``game_scoring_driver.main``
    over Avro files; -> K1's launches over both drivers (the driver's fixed
    effect is the scatter objective, as in the JAX driver). ``then(tmp,
    shards, scorer)`` runs inside run H's directory before it goes."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from photon_ml_tpu_torch.cli import game_scoring_driver, game_training_driver

    with tempfile.TemporaryDirectory(prefix="photon_game_phase_") as tmp:
        t0 = time.perf_counter()
        jobs = []
        for kind in ("train", "validate"):
            os.makedirs(f"{tmp}/{kind}")
            for p in range(GAME_H_PARTS):
                jobs.append((seed, f"{tmp}/{kind}/part-{p:05d}.avro", kind, p,
                             GAME_H_PARTS, GAME_H_USERS, DIM))
        with ProcessPoolExecutor(len(jobs), mp_context=multiprocessing.get_context("spawn")) as pool:
            written = list(pool.map(game_h_part, jobs))
        say(f"game run H data: {sum(written[:GAME_H_PARTS])} training and "
            f"{sum(written[GAME_H_PARTS:])} validation Avro records ({GAME_H_USERS} users) "
            f"written in {time.perf_counter() - t0!r} s")
        shards = "globalShard:features|userShard:userFeatures"
        train_argv = [
            "--train-input-dirs", f"{tmp}/train", "--validate-input-dirs", f"{tmp}/validate",
            "--output-dir", f"{tmp}/out",
            "--feature-shard-id-to-feature-section-keys-map", shards,
            "--fixed-effect-data-configurations", "global:globalShard,1",
            "--fixed-effect-optimization-configurations",
            "global:50,1e-7,10,1,LBFGS,L2;50,1e-7,1,1,LBFGS,L2",
            "--random-effect-data-configurations",
            "per-user:userId,userShard,1,none,none,none,INDEX_MAP",
            "--random-effect-optimization-configurations", "per-user:30,1e-5,1,1,LBFGS,L2",
            "--num-iterations", "2", "--evaluator-types", "AUC",
            "--compute-variance", "true", "--model-output-mode", "BEST",
        ]
        k1.launches = 0
        t0 = time.perf_counter()
        # run Q's generation 1: this training driver publishes its best model
        trainer = game_training_driver.main(
            train_argv + ["--publish-registry", f"{tmp}/registry", *device_args])
        train_s = time.perf_counter() - t0
        timers = " ".join(f"{k}={v!r}" for k, v in trainer.timer.durations.items())
        with open(f"{tmp}/out/metrics.json") as f:
            metrics = json.load(f)
        hist = metrics["objective_history"]
        say(f"game run H training driver ({smi}): {train_s!r} s; stage timers s: {timers}; "
            f"best combo {trainer.best_config['global'].render()}; validation AUC "
            f"{metrics['best_metric']!r}; objective history {hist}; registry "
            f"{metrics['registry']}")
        if metrics["registry"]["published_generation"] != 1:
            fail(f"run Q1: run H's training driver did not publish generation 1: "
                 f"{metrics['registry']}")
        if any(b > a for a, b in zip(hist, hist[1:])):
            fail(f"game run H: the CD objective rose: {hist}")
        want = [
            "metrics.json", "best-model/model-spec",
            "best-model/fixed-effect/global/id-info",
            "best-model/fixed-effect/global/coefficients/part-00000.avro",
            "best-model/random-effect/per-user/id-info",
            "best-model/random-effect/per-user/coefficients/part-00000.avro",
        ]
        missing = [f for f in want if not os.path.isfile(f"{tmp}/out/{f}")]
        if missing or os.path.exists(f"{tmp}/out/all"):
            fail(f"game run H: the output tree lacks {missing} or holds all/")
        t0 = time.perf_counter()
        scorer = game_scoring_driver.main([
            "--input-data-dirs", f"{tmp}/validate",
            "--game-model-input-dir", f"{tmp}/out/best-model",
            "--output-dir", f"{tmp}/scores",
            "--feature-shard-id-to-feature-section-keys-map", shards,
            "--evaluator-types", "AUC", *device_args,
        ])
        score_s = time.perf_counter() - t0
        timers = " ".join(f"{k}={v!r}" for k, v in scorer.timer.durations.items())
        auc = scorer.metrics["AUC"]
        say(f"game run H scoring driver ({smi}): {score_s!r} s; stage timers s: {timers}; "
            f"AUC {auc!r} against the training driver's {metrics['best_metric']!r}")
        if not os.path.isfile(f"{tmp}/scores/scores/part-00000.avro"):
            fail("game run H: the scoring driver wrote no scores")
        if not abs(auc - metrics["best_metric"]) <= GAME_H_AUC_TOL or not auc > 0.5:
            fail(f"game run H: scoring AUC {auc!r} is not the training driver's")
        if then is not None:
            then(tmp, shards, scorer)
    say(f"game run H ({smi}): K1 launches {k1.launches} (the driver's fixed effect is scatter)")
    return k1.launches


def game_phase(seed, smi, k1, then=None):
    """Phase 8: runs G and H (``then`` inside run H's directory); -> (K1's
    launches in each, K1 at run G's shape, run G's GameDataset)."""
    t0 = time.perf_counter()
    launches_g, game_k1, ds = game_run_g(seed, smi, k1)
    say(f"game run G: {time.perf_counter() - t0!r} s of host time ({smi})")
    t0 = time.perf_counter()
    launches_h = game_run_h(seed, smi, k1, then=then)
    say(f"game run H: {time.perf_counter() - t0!r} s of host time ({smi})")
    return {"G": launches_g, "H": launches_h}, game_k1, ds


# -- phase 9: the factored random effect, MF, checkpoints, kill -9 resume ----

# Run F: run G's rows with the per-user random effect factored
FACTORED_LATENT = 8
FACTORED_SCORE_RTOL = 1e-5  # of the scores' max-abs, against float64
# Run M: the JAX package's MF settings (bench.py:3930-4030) at MovieLens-20M
# entity counts
MF_ROWS, MF_COLS, MF_K, MF_RATINGS = 138_493, 26_744, 32, 2_000_000
MF_SAMPLE = 1000  # row and column entities checked against a float64 solve
MF_OBJ_RTOL = 1e-6  # resumed vs uninterrupted final CD objective, relative
MF_L2 = 1.0  # run M's L2 weight: the coordinate's and its entity check's
MF_ENTITY_RTOL = 1e-8  # an entity's objective above its float64 optimum, relative
# Run R: killed at λ = 1's snapshot. ckpt_save crossings: 1 = the run
# manifest, 2-3 = λ = 10's npz and marker, 4 = λ = 1's npz
RUN_R_PLAN = "ckpt_save:4:KILL"
RUN_R_WARM_RTOL = 1e-5  # λ = 1's first tracked value vs float64 at the warm start


def timed_calls(obj, name, log):
    """Replace ``obj.name`` with a wrapper logging each call's card
    seconds."""
    fn = getattr(obj, name)

    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        log.append(time.perf_counter() - t0)
        return out

    setattr(obj, name, wrapper)


def factored_scores64(red, bank, projection, chunk=1 << 18):
    """Run F's scores in float64 from their definition:
    sum_s v_s (B[ix_s] . bank[entity])."""
    dev = bank.device
    codes = torch.as_tensor(red.row_entity_codes, device=dev).long()
    out = []
    for s in range(0, codes.shape[0], chunk):
        ix = torch.as_tensor(red.row_local_indices[s:s + chunk], device=dev).long()
        v = torch.as_tensor(red.row_local_values[s:s + chunk], device=dev).double()
        c = codes[s:s + chunk]
        x = (v[..., None] * projection.double()[ix]).sum(1)
        sc = (x * bank.double()[c.clamp_min(0)]).sum(-1)
        out.append(torch.where(c >= 0, sc, 0.0))
    return torch.cat(out)


def factored_run_f(ds, seed, smi, k1, k2):
    """Run F: run G's 1.6M rows and global fixed effect (K1, the schedule
    from the in-memory tier) with the user random effect factored
    (IDENTITY-projected user features folded onto their pool indices,
    latent dimension 8, one inner iteration; RE and projection fit
    L-BFGS, 30 iterations); ``CoordinateDescent.run(2)``; -> K1's and
    K2's launches in that run."""
    from photon_ml_tpu_torch.game import (
        CoordinateDescent,
        FactoredRandomEffectConfiguration,
        FactoredRandomEffectCoordinate,
        FixedEffectCoordinate,
        ProjectorType,
        RandomEffectDataConfiguration,
        RandomEffectOptimizationProblem,
        build_random_effect_dataset,
    )
    from photon_ml_tpu_torch.ops import tiled_sparse as ts
    from photon_ml_tpu_torch.ops.losses import LOGISTIC
    from photon_ml_tpu_torch.optim.config import (
        OptimizerConfig,
        OptimizerType,
        RegularizationContext,
        RegularizationType,
    )
    from photon_ml_tpu_torch.optim.problem import create_glm_problem
    from photon_ml_tpu_torch.parallel import overlap
    from photon_ml_tpu_torch.task import TaskType

    t0 = time.perf_counter()
    red = build_random_effect_dataset(
        ds, RandomEffectDataConfiguration(
            "userId", "user_pool", projector_type=ProjectorType.IDENTITY
        ),
        seed=seed,
    )
    red_s = time.perf_counter() - t0
    l2 = RegularizationContext(RegularizationType.L2)
    re_opt = OptimizerConfig(OptimizerType.LBFGS, max_iter=30, tolerance=1e-5, lbfgs_history=5)
    fe = FixedEffectCoordinate(
        name="global", dataset=ds,
        problem=create_glm_problem(
            TaskType.LOGISTIC_REGRESSION, DIM, config=OptimizerConfig(max_iter=50),
            regularization=l2, intercept_index=DIM - 1, kernel="tiled",
        ),
        feature_shard_id="global", reg_weight=1.0,
    )
    fre = FactoredRandomEffectCoordinate(
        name="per-user", dataset=ds, re_dataset=red,
        problem=RandomEffectOptimizationProblem(LOGISTIC, re_opt, l2, reg_weight=1.0),
        projection_problem=create_glm_problem(
            TaskType.LOGISTIC_REGRESSION, red.local_dim * FACTORED_LATENT, config=re_opt,
            regularization=l2,
        ),
        config=FactoredRandomEffectConfiguration(FACTORED_LATENT, 1),
        reg_weight_projection=1.0,
    )
    bank_s, proj_s = [], []
    timed_calls(fre.problem, "update_bank", bank_s)
    timed_calls(fre, "_update_projection", proj_s)
    log = []
    coords = {"global": TimedCoordinate(fe, k1, log), "per-user": TimedCoordinate(fre, k1, log)}
    tilings = ts.tilings
    k1.launches = k2.launches = 0
    overlap.reset_readback_stats()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = CoordinateDescent(coords, ds, TaskType.LOGISTIC_REGRESSION).run(2)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"k1": k1.launches, "k2": k2.launches}
    readbacks = overlap.readback_stats()
    peak = torch.cuda.max_memory_allocated()
    hist = result.objective_history
    updates = [e for e in log if e[0] == "update"]
    n, k = red.row_local_indices.shape
    held = int((torch.as_tensor(red.row_local_values) != 0).sum()) * FACTORED_LATENT
    say(f"factored run F data ({smi}): IDENTITY user view over {n} rows x {k} slots, "
        f"{red.num_entities} entities, built in {red_s!r} s; projection problem dimension "
        f"{red.local_dim * FACTORED_LATENT}, {n * k * FACTORED_LATENT} slots a pass of which "
        f"{held} held entries; schedule builds in run F {ts.tilings - tilings} "
        f"(tilings {ts.tilings})")
    for it in range(2):
        fe_up, fr_up = updates[2 * it], updates[2 * it + 1]
        end = updates[2 * it + 2][5] if it == 0 else readbacks
        say(f"factored run F sweep {it + 1} ({smi}): FE fit {fe_up[2]!r} s, factored update "
            f"{fr_up[2]!r} s = bank {bank_s[it]!r} s + projection fit {proj_s[it]!r} s; "
            f"readbacks in the sweep {end - fe_up[5]}")
    say(f"factored run F ({smi}): CD 2 sweeps {seconds!r} s, objective history {hist}; "
        f"launches {launches}; readbacks {readbacks}; device memory peak {peak} bytes")
    if ts.tilings != tilings:
        fail("factored run F: the fixed effect's schedule missed the in-memory tier")
    if launches["k1"] == 0:
        fail("factored run F: the tiled fixed effect launched no K1")
    if readbacks != 2:
        fail(f"factored run F: {readbacks} readbacks over two CD sweeps, not 2")
    if not all(np.isfinite(hist)) or any(b > a for a, b in zip(hist, hist[1:])):
        fail(f"factored run F: the CD objective is not finite and non-increasing: {hist}")
    model = result.model.models["per-user"]
    got = fre.score(model)
    want = factored_scores64(red, model.bank, model.projection)
    err = float((got.double() - want).abs().max() / want.abs().max())
    say(f"factored run F scores vs float64 from bank, B and the rows: {err!r} of the "
        f"max-abs (limit {FACTORED_SCORE_RTOL}); bank {tuple(model.bank.shape)}, "
        f"B {tuple(model.projection.shape)}")
    if not err <= FACTORED_SCORE_RTOL or not bool(torch.isfinite(got).all()):
        fail("factored run F: the scores are off their float64 recomputation")
    return launches


def mf_data(seed, device):
    """Run M's ratings (bench.py's ``_mf_config`` draws from the seed):
    uniform entities, planted latent factors, noise 0.3; -> GameDataset on
    ``device``."""
    from photon_ml_tpu_torch.game import EntityIndex, GameDataset

    rng = np.random.default_rng([seed, 9])
    rows = rng.integers(0, MF_ROWS, size=MF_RATINGS).astype(np.int32)
    cols = rng.integers(0, MF_COLS, size=MF_RATINGS).astype(np.int32)
    row_true = rng.normal(0, 0.4, size=(MF_ROWS, MF_K)).astype(np.float32)
    col_true = rng.normal(0, 0.4, size=(MF_COLS, MF_K)).astype(np.float32)
    ratings = ((row_true[rows] * col_true[cols]).sum(1)
               + 0.3 * rng.normal(size=MF_RATINGS)).astype(np.float32)
    n = MF_RATINGS
    return GameDataset(
        uids=[""] * n, labels=ratings, offsets=np.zeros(n, np.float32),
        weights=np.ones(n, np.float32), shards={},
        entity_codes={"userId": rows, "itemId": cols},
        entity_indexes={
            "userId": EntityIndex.build("userId", [f"u{i:06d}" for i in range(MF_ROWS)]),
            "itemId": EntityIndex.build("itemId", [f"i{i:05d}" for i in range(MF_COLS)]),
        },
        num_real_rows=n, device=torch.device(device),
    )


def mf_entity_check(ds, solve_codes, fixed_codes, partner, solved, control, sample):
    """Each sampled entity's own objective (float64, from its definition:
    sum_s (x_s . c - y_s)^2 / 2 + MF_L2 |c|^2 / 2, x_s the partner factors
    of its ratings) at the card's factors ``solved`` and at ``control``,
    over its minimum, the closed form c* = (X^T X + MF_L2 I)^-1 X^T y
    solved in float64 on the CPU; -> the worst relative excess of each."""
    lists = [np.nonzero(solve_codes == e)[0] for e in sample]
    S = max(len(r) for r in lists)
    E = len(sample)
    X = np.zeros((E, S, MF_K))
    y = np.zeros((E, S))
    partner = partner.double().cpu().numpy()
    for i, r in enumerate(lists):
        X[i, :len(r)] = partner[fixed_codes[r]]
        y[i, :len(r)] = ds.labels[r]
    X, y = torch.as_tensor(X), torch.as_tensor(y)
    Xt = X.transpose(1, 2)
    gram = Xt @ X + MF_L2 * torch.eye(MF_K, dtype=torch.float64)
    c_star = torch.linalg.solve(gram, (Xt @ y[..., None]))[..., 0]

    def f(c):
        r = (X * c[:, None, :]).sum(-1) - y
        return 0.5 * (r * r).sum(-1) + 0.5 * MF_L2 * (c * c).sum(-1)

    f_star = f(c_star)
    pick = torch.as_tensor(sample).long()

    def excess(factors):
        return float(((f(factors.double().cpu()[pick]) - f_star) / f_star.abs()).max())

    return excess(solved), excess(control)


def mf_run_m(seed, smi, k1, device="cuda"):
    """Run M: ``MatrixFactorizationCoordinate`` in ``CoordinateDescent`` at
    MovieLens-20M entity counts, uninterrupted for two sweeps, then with a
    ``TrainingCheckpointer`` and an installed ``PreemptionGuard``: a
    SIGTERM to the process during sweep 1 stops the run after it, and a
    new run over the same directory resumes and finishes sweep 2."""
    from photon_ml_tpu_torch.game import (
        CoordinateDescent,
        MatrixFactorizationCoordinate,
        RandomEffectOptimizationProblem,
    )
    from photon_ml_tpu_torch.ops.losses import LINEAR
    from photon_ml_tpu_torch.optim.config import (
        OptimizerConfig,
        OptimizerType,
        RegularizationContext,
        RegularizationType,
    )
    from photon_ml_tpu_torch.task import TaskType
    from photon_ml_tpu_torch.utils.checkpoint import TrainingCheckpointer
    from photon_ml_tpu_torch.utils.preemption import PreemptionGuard

    t0 = time.perf_counter()
    ds = mf_data(seed, device)
    say(f"mf run M data: {MF_RATINGS} ratings of {MF_ROWS} x {MF_COLS} entities, K = {MF_K}, "
        f"made in {time.perf_counter() - t0!r} s")

    def coord():
        return MatrixFactorizationCoordinate(
            name="mf", dataset=ds, row_effect_type="userId", col_effect_type="itemId",
            num_latent_factors=MF_K,
            problem=RandomEffectOptimizationProblem(
                LINEAR,
                OptimizerConfig(OptimizerType.LBFGS, max_iter=20, tolerance=1e-5, lbfgs_history=5),
                RegularizationContext(RegularizationType.L2), reg_weight=MF_L2,
            ),
        )

    def run(log, sweeps, **kw):
        first = kw.pop("on_first_update", None)
        c = TimedCoordinate(coord(), k1, log, first)
        t0 = time.perf_counter()
        result = CoordinateDescent({"mf": c}, ds, TaskType.LINEAR_REGRESSION, **kw).run(sweeps)
        torch.cuda.synchronize()
        return result, time.perf_counter() - t0, c

    full_log = []
    full, full_s, _ = run(full_log, 2)
    steps = [e[2] for e in full_log if e[0] == "update"]
    say(f"mf run M uninterrupted ({smi}): CD 2 sweeps {full_s!r} s; ALS step cold "
        f"(side structures built) {steps[0]!r} s, warm {steps[1]!r} s; objective history "
        f"{full.objective_history}")
    with tempfile.TemporaryDirectory(prefix="photon_mf_ckpt_") as ckdir:
        guard = PreemptionGuard().install()
        try:
            log = []
            stopped, stop_s, _ = run(
                log, 2, checkpointer=TrainingCheckpointer(ckdir), preemption_guard=guard,
                on_first_update=lambda: os.kill(os.getpid(), signal.SIGTERM),
            )
        finally:
            guard.uninstall()
        say(f"mf run M preempted ({smi}): SIGTERM in sweep 1; preempted {stopped.preempted}, "
            f"{len(stopped.objective_history)} sweep(s), {stop_s!r} s; objective "
            f"{stopped.objective_history}")
        if not stopped.preempted or len(stopped.objective_history) != 1:
            fail("mf run M: the SIGTERM did not stop the run after sweep 1")
        ck = TrainingCheckpointer(ckdir)
        if ck.latest_step() != 1:
            fail(f"mf run M: latest checkpoint step {ck.latest_step()}, not 1")
        log = []
        resumed, resume_s, c = run(log, 2, checkpointer=ck)
        restored = log[0][6]  # the model the resumed run's first update got
        with np.load(os.path.join(ckdir, "1", "state.npz")) as z:
            saved = {k: np.array(z[k]) for k in z.files}
    sweep1 = stopped.model.models["mf"]
    bitwise_restore = all(
        np.array_equal(saved[f"mf/{name}"], getattr(restored, name).cpu().numpy())
        and torch.equal(getattr(restored, name), getattr(sweep1, name))
        for name in ("row_latent", "col_latent")
    )
    f_full, f_res = full.objective_history[-1], resumed.objective_history[-1]
    rel = abs(f_res - f_full) / abs(f_full)
    final, ref = resumed.model.models["mf"], full.model.models["mf"]
    bitwise_final = all(
        torch.equal(getattr(final, n), getattr(ref, n)) for n in ("row_latent", "col_latent")
    )
    say(f"mf run M resumed ({smi}): from step 1, {len(resumed.objective_history)} sweep, "
        f"{resume_s!r} s (ALS step {[e[2] for e in log if e[0] == 'update']}); restored "
        f"factors bitwise the checkpoint's: {bitwise_restore}; final objective {f_res!r} vs "
        f"uninterrupted {f_full!r} (rel {rel!r}, limit {MF_OBJ_RTOL}); final factors bitwise "
        f"the uninterrupted run's: {bitwise_final}")
    if not bitwise_restore:
        fail("mf run M: the restored sweep-1 factors are not the checkpoint's")
    if not rel <= MF_OBJ_RTOL or resumed.preempted:
        fail("mf run M: the resumed run's objective is off the uninterrupted run's")
    # each sampled entity's optimality: rows were solved in sweep 2 against
    # the sweep-1 column factors, columns against the final rows. The
    # control, each side's sweep-1 factors in the same final problem, is a
    # converged solve of the neighbouring problem and must read above the
    # limit
    rng = np.random.default_rng([seed, 10])
    rows, cols = ds.entity_codes["userId"], ds.entity_codes["itemId"]
    worst = {}
    for side, solve, fixed, partner, solved, control, count in (
        ("row", rows, cols, sweep1.col_latent, final.row_latent, sweep1.row_latent, MF_ROWS),
        ("col", cols, rows, final.row_latent, final.col_latent, sweep1.col_latent, MF_COLS),
    ):
        sample = rng.choice(count, MF_SAMPLE, replace=False)
        worst[side] = mf_entity_check(ds, solve, fixed, partner, solved, control, sample)
    say(f"mf run M entities ({smi}): worst objective excess over the float64 closed-form "
        f"optimum, {MF_SAMPLE} rows {worst['row'][0]!r}, {MF_SAMPLE} columns "
        f"{worst['col'][0]!r} (limit {MF_ENTITY_RTOL}); control, the sweep-1 factors in the "
        f"same problems: rows {worst['row'][1]!r}, columns {worst['col'][1]!r} (must exceed "
        f"the limit)")
    if not max(worst["row"][0], worst["col"][0]) <= MF_ENTITY_RTOL:
        fail("mf run M: a sampled entity's factors are off its float64 optimum")
    if not min(worst["row"][1], worst["col"][1]) > MF_ENTITY_RTOL:
        fail("mf run M: the entity check's control passed it: the check cannot tell")


def run_r(seed, smi, k1, k2, run_a, device_args=()):
    """Run R: run A's argv with ``--checkpoint-dir`` and the fault plan
    ``RUN_R_PLAN`` in a subprocess, which must die by SIGKILL with λ = 10
    snapshotted; then the same argv without the plan through
    ``glm_driver.main``: λ = 10 loads from its snapshot (bitwise, no K1
    launch), λ = 1 warm-starts from its snapshotted means, and both λs'
    models are run A's bitwise; -> the resumed run's launches."""
    from photon_ml_tpu_torch.reliability import checkpoint as reliability_checkpoint

    tmp = run_a["tmp"]
    ckdir, out = f"{tmp}/ckpt-R", f"{tmp}/out-R"
    argv = run_a["argv"] + ["--checkpoint-dir", ckdir, "--delete-output-dirs-if-exist", "true",
                            *device_args]
    cmd = [sys.executable, "-m", "photon_ml_tpu_torch.cli.glm_driver", *argv,
           "--output-directory", out, "--fault-plan", RUN_R_PLAN]
    t0 = time.perf_counter()
    killed = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                            capture_output=True, text=True, timeout=600)
    killed_s = time.perf_counter() - t0
    committed = sorted(f for f in os.listdir(ckdir) if f.endswith(".json") and f != "manifest.json")
    log_tail = ""
    if os.path.exists(f"{out}/photon.log"):
        with open(f"{out}/photon.log") as f:
            log_tail = " | ".join(line.strip() for line in f.readlines()[-3:])
    say(f"run R killed ({smi}): rc {killed.returncode} after {killed_s!r} s (process start, "
        f"preprocess, the λ = 10 fit and its snapshot); committed snapshots {committed}; "
        f"its log ends: {log_tail}")
    if killed.returncode != -signal.SIGKILL:
        fail(f"run R: the killed run ended with rc {killed.returncode}, not by SIGKILL: "
             f"{killed.stderr[-2000:]}")
    if len(committed) != 1:
        fail(f"run R: {len(committed)} committed snapshots before the kill, not λ = 10's")
    with np.load(f"{ckdir}/{committed[0][:-len('.json')]}.npz") as z:
        snap = {k: np.array(z[k]) for k in z.files}

    # the resumed run, in this process: which λ loaded, at what K1 count
    loads = []
    load = reliability_checkpoint.GridCheckpointer.load

    def counted_load(self, lam):
        loads.append((lam, k1.launches))
        out_ = load(self, lam)
        loads.append((lam, k1.launches, out_ is not None))
        return out_

    reliability_checkpoint.GridCheckpointer.load = counted_load
    try:
        r = driver_run("R", argv, out, k1, k2, f"sequential, resumed, {smi}", keep_driver=True)
    finally:
        reliability_checkpoint.GridCheckpointer.load = load
    driver = r["driver"]
    (lam10_in, lam10_out, lam1_in) = loads[0], loads[1], loads[2]
    launches_10 = lam1_in[1] - lam10_in[1]
    m10 = driver.models[10.0].means.cpu().numpy()
    bitwise = np.array_equal(m10, snap["model_means"])
    batch = run_a["batch"]
    warm = torch.as_tensor(snap["warm_means"], device=batch.labels.device)
    f_warm, _ = objective64(batch, warm, 1.0)
    first = float(driver.results[1.0].tracker.values[0])
    warm_rel = abs(first - f_warm) / abs(f_warm)
    f_zero, _ = objective64(batch, torch.zeros_like(warm), 1.0)
    say(f"run R resumed ({smi}): λ = 10 loaded from its snapshot {lam10_out[2]}, bitwise the "
        f"snapshotted model {bitwise}, K1 launches for it {launches_10}; λ = 1's first "
        f"tracked value {first!r} vs the float64 objective at the snapshotted warm means "
        f"{f_warm!r} (rel {warm_rel!r}; at zero {f_zero!r}); reliability block "
        f"{json.dumps(r['metrics']['reliability'])}")
    if not (lam10_out[0] == 10.0 and lam10_out[2] and bitwise and launches_10 == 0):
        fail("run R: λ = 10 was not restored from its snapshot without a solve")
    if lam1_in[0] != 1.0 or not warm_rel <= RUN_R_WARM_RTOL:
        fail("run R: λ = 1 did not warm-start from the snapshotted means")
    for lam in (10.0, 1.0):
        # run A's argv, its inputs: the resumed sweep is run A's, bitwise
        m = driver.models[lam].means
        f_r, _ = objective64(batch, m, lam)
        rel = (f_r - run_a["objectives"][lam]) / abs(run_a["objectives"][lam])
        same = torch.equal(m, run_a["means"][lam])
        say(f"run R lambda={lam} vs run A ({smi}): objective {f_r!r} vs "
            f"{run_a['objectives'][lam]!r} (rel {rel!r}); coefficients bitwise run A's {same}")
        if not same:
            fail(f"run R lambda={lam}: the resumed fit is not bitwise run A's")
    say(f"run R ({smi}): killed run {killed_s!r} s; resumed run {r['seconds']!r} s; run A "
        f"{run_a['seconds']!r} s, stage timers {run_a['timers']}")
    return {"k1": r["k1"], "k2": r["k2"]}


def reliability_phase(seed, smi, k1, k2, game_ds, run_a, device="cuda", device_args=()):
    """Phase 9: runs F (factored random effect), M (MF with a checkpoint
    and a SIGTERM) and R (the GLM driver's kill -9 resume); -> K1's and
    K2's launches in runs F and R."""
    t0 = time.perf_counter()
    launches_f = factored_run_f(game_ds, seed, smi, k1, k2)
    say(f"factored run F: {time.perf_counter() - t0!r} s of host time ({smi})")
    t0 = time.perf_counter()
    mf_run_m(seed, smi, k1, device)
    say(f"mf run M: {time.perf_counter() - t0!r} s of host time ({smi})")
    t0 = time.perf_counter()
    launches_r = run_r(seed, smi, k1, k2, run_a, device_args)
    say(f"run R: {time.perf_counter() - t0!r} s of host time ({smi})")
    return {"F": launches_f, "R": launches_r}


# -- phase 10: out-of-core training -------------------------------------------

STREAM_PARTS = 8  # Avro part files of run S's training rows (and 1 of validation)
# run S's rows: 2^13 training and 2^12 validation (2^18 and 2^16 took
# 322 s for the phase, and the script passed the 1,200 s limit; 2^16 until
# phase 13 needed the time, 2^15 until phase 14 did, 2^14 until phase 15)
STREAM_ROWS, STREAM_HELD_OUT = 1 << 13, 1 << 12
# run S's --stream-memory-budget: 1,048,576 B // 532 B a row (65 slots of
# 8 B + 12 B) = 1,971 rows a chunk, so the 2^13 rows are 5 chunks: 1 on
# the device tier (the budget holds one), 4 spilled, all 5 tiled (the
# budget halved with the rows keeps the tiers of 2^14 rows at 2,097,152 B,
# of 2^15 at 4,194,304 B and of 2^16 at 8,388,608 B)
STREAM_BUDGET = 1048576
STREAM_TIERS = {"device": 1, "disk": 4, "tiled": 5, "overflow": 0}
STREAM_TILED_KEEP = 2  # tiled chunks of the direct overflow objective
STREAM_AUC_TOL = 1e-3  # streamed (4,096-bin) AUC vs the exact AUC
STREAM_VALUE_RTOL = 1e-5  # streamed vs in-memory objective, relative
STREAM_GRAD_RTOL = 1e-4  # of the gradient's (Hv's, Hdiag's) max-abs


def stream_part(args):
    """One Avro part file of run S's rows (runs in a worker process): phase
    4's planted model, rows from a generator of the part's own."""
    seed, path, kind, part, n = args
    from photon_ml_tpu_torch.io import schemas
    from photon_ml_tpu_torch.io.avro_codec import write_container

    w_true = (np.random.default_rng([seed, 1]).normal(size=DIM) * 0.3).astype(np.float32)
    idx, vals, labels = planted_data(
        np.random.default_rng([seed, 10, kind == "train", part]), n, w_true
    )
    recs = [{
        "uid": None, "label": float(labels[r]), "offset": None, "weight": None,
        "features": [{"name": str(i), "term": "", "value": v}
                     for i, v in zip(idx[r].tolist(), vals[r].tolist())],
    } for r in range(n)]
    write_container(path, schemas.TRAINING_EXAMPLE_AVRO, recs)
    return n


def rss_bytes():
    """This process's resident set now (not its peak)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def stream_run(label, argv, out, k1, k2, smi, device_args=()):
    """One ``glm_driver.main(argv)`` with ``--streaming true``, the launch
    counts, the decode-pass count and the device memory peak set to 0 just
    before it, and the host fetches, K1 launches and RSS read around its
    train stage; -> its record."""
    from photon_ml_tpu_torch.cli import glm_driver
    from photon_ml_tpu_torch.io import streaming
    from photon_ml_tpu_torch.parallel import overlap

    seen = {}
    train = glm_driver.GLMDriver.train

    def measured_train(driver):
        seen.update(rss0=rss_bytes(), fetch0=overlap.readback_stats(), k1_0=k1.launches)
        train(driver)
        torch.cuda.synchronize()
        seen.update(rss1=rss_bytes(), fetches=overlap.readback_stats() - seen["fetch0"],
                    train_k1=k1.launches - seen["k1_0"])

    glm_driver.GLMDriver.train = measured_train
    k1.launches = 0
    k2.launches = 0
    streaming.decode_passes = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        driver = glm_driver.main(argv + ["--output-directory", out, *device_args])
    finally:
        glm_driver.GLMDriver.train = train
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    want = ["feature-index/index.json", "models/models.avro", "metrics.json"]
    if "--validating-data-directory" in argv:
        want.append("best-model/model.avro")
    missing = [f for f in want if not os.path.exists(f"{out}/{f}")]
    if missing:
        fail(f"streamed run {label} wrote no {missing}")
    with open(f"{out}/metrics.json") as f:
        metrics = json.load(f)
    st = metrics["streaming"]
    stats = driver._stream[1]
    staged = stats.num_rows * (stats.max_nnz * 8 + 12)
    iters = sum(r.iterations for r in driver.results.values())
    run = dict(driver=driver, out=out, metrics=metrics, seconds=seconds, k1=k1.launches,
               k2=k2.launches, train_k1=seen["train_k1"], stats=stats,
               decode_passes=streaming.decode_passes)
    timers = " ".join(f"{k}={v!r}" for k, v in driver.timer.durations.items())
    say(f"streamed run {label} ({smi}): {seconds!r} s; stage timers s: {timers}; K1 "
        f"launches {k1.launches} ({seen['train_k1']} in training), K2 launches {k2.launches}; "
        f"iterations {dict((k, r.iterations) for k, r in driver.results.items())}, stop "
        f"reasons {dict((k, r.reason_name) for k, r in driver.results.items())}")
    say(f"streamed run {label} tiers ({smi}): {stats.num_rows} rows x {stats.max_nnz} slots, "
        f"{st['rows_per_chunk']} rows a chunk, tiers {st['tiers']}, spill bytes "
        f"{st['spill_bytes']}, decode passes of the objective {st['decode_passes']} "
        f"(all iter_chunks passes of the run {streaming.decode_passes}: the data checks, the "
        f"fill, the reservoir and validation); scan cache {metrics.get('scan_cache')}")
    say(f"streamed run {label} memory ({smi}): host RSS growth in training "
        f"{seen['rss1'] - seen['rss0']} B against {staged} B of staged rows; peak RSS "
        f"{st['peak_rss_bytes']} B; device memory peak {torch.cuda.max_memory_allocated()} B; "
        f"host fetches in training {seen['fetches']} over {iters} iterations "
        f"({seen['fetches'] / max(iters, 1)!r} per iteration)")
    if st["decode_passes"] != 1:
        fail(f"streamed run {label}: the objective decoded {st['decode_passes']} times")
    if seen["train_k1"] == 0 or k2.launches:
        fail(f"streamed run {label}: K1 never launched in training, or K2 launched")
    return run


def stream_objective_checks(k1, train_dir, fmt, imap, stats, batch, smi, seed, device="cuda"):
    """A direct ``StreamingGLMObjective`` over run S's files on the card:
    value and gradient (and Hv, Hdiag) against the in-memory tiled
    objective on the loaded batch at one fixed w, K1's launches per
    evaluation (2 x tiled chunks for value+gradient, 3 x for Hv, 2 x for
    Hdiag) and no decode after the fill; then the same with a tiled cache
    of STREAM_TILED_KEEP chunks and the rest on the scatter overflow. K1
    checked and timed at the chunk shape. -> the chunk's K1 numbers."""
    from photon_ml_tpu_torch.io.streaming import StreamingGLMObjective, sparse_row_bytes
    from photon_ml_tpu_torch.ops import tiled_sparse as ts
    from photon_ml_tpu_torch.ops.losses import loss_for_task
    from photon_ml_tpu_torch.task import TaskType

    task = TaskType.LOGISTIC_REGRESSION
    loss = loss_for_task(task)
    rng = np.random.default_rng([seed, 11])
    dim = imap.size
    w = torch.as_tensor((rng.normal(size=dim) * 0.05).astype(np.float32), device=device)
    d = torch.as_tensor(rng.normal(size=dim).astype(np.float32), device=device)
    tb = ts.tiled_batch_from_sparse(batch, dim, device=device)
    tobj = ts.TiledGLMObjective(loss, dim)
    ref = dict(
        vg=tobj.value_and_gradient(w, tb, 1.0), hv=tobj.hessian_vector(w, d, tb, 1.0),
        hd=tobj.hessian_diagonal(w, tb, 1.0),
    )
    del tb
    rows = STREAM_BUDGET // sparse_row_bytes(stats.max_nnz)

    def check(label, obj, expect_k1):
        launches = {}
        got = {}
        seconds = {}
        for name, fn in (("vg", lambda: obj.value_and_gradient(w, 1.0)),
                         ("hv", lambda: obj.hessian_vector(w, d, 1.0)),
                         ("hd", lambda: obj.hessian_diagonal(w, 1.0))):
            k1.launches = 0
            t0 = time.perf_counter()
            got[name] = fn()
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
            launches[name] = k1.launches
        v, g = got["vg"]
        v_ref, g_ref = ref["vg"]
        v_rel = abs(float(v) - float(v_ref)) / abs(float(v_ref))
        errs = {name: float((a - b).abs().max() / b.abs().max())
                for name, a, b in (("gradient", g, g_ref), ("hv", got["hv"], ref["hv"]),
                                   ("hdiag", got["hd"], ref["hd"]))}
        tiers = obj.tier_counts
        say(f"stream objective {label} ({smi}): tiers {tiers}; value {float(v)!r} vs "
            f"{float(v_ref)!r} in memory, relative {v_rel!r}; max-abs errors over the "
            f"scale {errs}; K1 launches per evaluation {launches} (expected {expect_k1}); "
            f"decode passes {obj.decode_passes}; host seconds per evaluation (the tiers read, "
            f"the passes run, synchronized) {seconds}")
        if not v_rel <= STREAM_VALUE_RTOL or not all(e <= STREAM_GRAD_RTOL for e in errs.values()):
            fail(f"stream objective {label}: off the in-memory tiled objective")
        if launches != expect_k1 or obj.decode_passes != 1:
            fail(f"stream objective {label}: K1 launches {launches} or decode passes "
                 f"{obj.decode_passes} off")
        return tiers, seconds

    obj = StreamingGLMObjective([train_dir], fmt, imap, stats, task, rows_per_chunk=rows,
                                cache_bytes=STREAM_BUDGET, kernel="tiled", device=device)
    obj.value_and_gradient(w, 1.0)  # the fill pass (scatter over decoded chunks)
    obj.value_and_gradient(w, 1.0)  # builds the tiled chunks
    n = len(obj._tiled)
    if obj.tier_counts != STREAM_TIERS:
        fail(f"stream objective: tiers {obj.tier_counts}, expected {STREAM_TIERS}")
    _, seconds = check("all tiled", obj, {"vg": 2 * n, "hv": 3 * n, "hd": 2 * n})
    chunk = game_k1_times(k1, obj._tiled[0], rng, smi, label="stream chunk", library=True)
    chunk.update(rows=rows, evaluation_s=seconds)
    # the same tiers with a tiled cache that keeps STREAM_TILED_KEEP chunks
    # (the schedules are built again from the tiers; nothing is decoded)
    obj.tiled_cache_bytes = (
        sum(obj.tiled_nbytes[:STREAM_TILED_KEEP]) + obj.tiled_nbytes[STREAM_TILED_KEEP] // 2
    )
    obj._tiled = None
    k = STREAM_TILED_KEEP
    tiers, _ = check("overflow", obj, {"vg": 2 * k, "hv": 3 * k, "hd": 2 * k})
    if tiers["tiled"] != k or tiers["overflow"] != n - k:
        fail(f"stream objective overflow: tiers {tiers}")
    obj.close()
    return chunk


# run T: the streamed GAME drivers at run H's widths, the user shard
# IDENTITY over each user's pool indices (d = 1,001: an IDENTITY bank over
# the 2^20-wide user shard of run H would be 1,024 x 2^20 floats, with an
# L-BFGS history beside it), 2^11 rows of 128 users each of training and
# validation (cut from run H's 2^16 of 4,096 users when the script passed
# 900 s, from 2^13 of 512 when phase 14 came, from 2^12 of 256 when phase
# 15 did)
STREAM_T_USERS = 128
STREAM_T_PARTS = 4
# 512 KiB: 912 B a staged row (72 + 40 slots of 8 B, 12 B and a code) ->
# 574 rows a chunk, 4 chunks of the 2^11 rows; 5,376 B an entity of 16
# rows -> 97 entities a segment, 2 segments of the 128 users (the budget
# halved with the rows keeps the chunks and segments of 2^12 rows at 1 MiB)
STREAM_T_BUDGET = 1 << 19
STREAM_T_OBJ_RTOL = 1e-3  # streamed vs in-memory CD objective, relative
STREAM_T_AUC_TOL = 1e-3  # streamed vs in-memory scoring AUC


def stream_game_part(args):
    """One Avro part file of run T's rows (runs in a worker process): run
    H's rows with each user feature named by its index in the user's pool
    (the IDENTITY user shard), the user id in metadataMap."""
    seed, path, kind, part, n_parts, n_users, dim = args
    from photon_ml_tpu_torch.io import schemas
    from photon_ml_tpu_torch.io.avro_codec import write_container

    w_global, w_user = game_model(np.random.default_rng([seed, 5]), n_users, dim)
    rng = np.random.default_rng([seed, 12, kind == "train", part])
    if kind == "train":
        users = np.repeat(np.arange(n_users), GAME_ROWS_PER_USER)
    else:
        users = rng.integers(0, n_users, size=n_users * GAME_ROWS_PER_USER)
    users = np.array_split(users, n_parts)[part]
    g_idx, g_val, _, u_val, labels, picks = game_rows(rng, users, w_global, w_user)
    icept = dim - 1
    recs = [{
        "uid": f"{kind}-{part}-{r}", "label": float(labels[r]),
        "features": [{"name": str(i), "term": "", "value": v}
                     for i, v in zip(g_idx[r].tolist(), g_val[r].tolist()) if v != 0 and i != icept],
        "userFeatures": [{"name": str(p), "term": "", "value": v}
                         for p, v in zip(picks[r].tolist(), u_val[r, :GAME_USER_NNZ].tolist())],
        "metadataMap": {"userId": f"user{users[r]:05d}"}, "weight": None, "offset": None,
    } for r in range(len(users))]
    schema = dict(schemas.TRAINING_EXAMPLE_AVRO)
    schema["fields"] = list(schema["fields"]) + [GAME_H_SCHEMA_EXTRA]
    write_container(path, schema, recs)
    return len(recs)


def stream_run_t(seed, smi, device_args=()):
    """Run T: ``game_training_driver.main`` over the same Avro files in
    memory, then with ``--streaming true`` and ``--checkpoint-dir``, then
    ``game_scoring_driver.main`` over the validation files in memory and
    with ``--streaming true`` on the streamed model. Fails unless the
    streamed CD objective never rises and is within STREAM_T_OBJ_RTOL of
    the in-memory run's, the checkpointer holds one step a CD iteration
    whose restore is the final states bitwise, and the streamed scoring
    AUC is within STREAM_T_AUC_TOL of the in-memory scoring's."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from photon_ml_tpu_torch.cli import game_scoring_driver, game_training_driver
    from photon_ml_tpu_torch.game.config import FeatureShardConfiguration
    from photon_ml_tpu_torch.io.name_term_list import save_name_and_term_feature_sets
    from photon_ml_tpu_torch.reliability import StreamingCDCheckpointer
    from photon_ml_tpu_torch.utils.index_map import intercept_key

    with tempfile.TemporaryDirectory(prefix="photon_stream_game_") as tmp:
        t0 = time.perf_counter()
        jobs = []
        for kind in ("train", "validate"):
            os.makedirs(f"{tmp}/{kind}")
            for p in range(STREAM_T_PARTS):
                jobs.append((seed, f"{tmp}/{kind}/part-{p:05d}.avro", kind, p,
                             STREAM_T_PARTS, STREAM_T_USERS, DIM))
        with ProcessPoolExecutor(len(jobs), mp_context=multiprocessing.get_context("spawn")) as pool:
            written = list(pool.map(stream_game_part, jobs))
        say(f"streamed run T data: {sum(written[:STREAM_T_PARTS])} training and "
            f"{sum(written[STREAM_T_PARTS:])} validation Avro records ({STREAM_T_USERS} users) "
            f"written in {time.perf_counter() - t0!r} s")
        shards = "globalShard:features|userShard:userFeatures"
        argv = [
            "--train-input-dirs", f"{tmp}/train", "--validate-input-dirs", f"{tmp}/validate",
            "--feature-shard-id-to-feature-section-keys-map", shards,
            "--fixed-effect-data-configurations", "global:globalShard,1",
            "--fixed-effect-optimization-configurations", "global:50,1e-7,1,1,TRON,L2",
            "--random-effect-data-configurations",
            "per-user:userId,userShard,1,none,none,none,IDENTITY",
            "--random-effect-optimization-configurations", "per-user:30,1e-5,1,1,LBFGS,L2",
            "--num-iterations", "2", "--evaluator-types", "AUC", *device_args,
        ]
        runs = {}
        for label, extra in (
            ("in memory", ["--output-dir", f"{tmp}/mem", "--model-output-mode", "NONE"]),
            ("streamed", ["--output-dir", f"{tmp}/stream", "--model-output-mode", "BEST",
                          "--streaming", "true", "--stream-memory-budget",
                          str(STREAM_T_BUDGET), "--checkpoint-dir", f"{tmp}/ck"]),
        ):
            t0 = time.perf_counter()
            driver = game_training_driver.main(argv + extra)
            seconds = time.perf_counter() - t0
            with open(f"{extra[1]}/metrics.json") as f:
                metrics = json.load(f)
            runs[label] = (driver, metrics)
            timers = " ".join(f"{k}={v!r}" for k, v in driver.timer.durations.items())
            say(f"streamed run T {label} training driver ({smi}): {seconds!r} s; stage timers s: "
                f"{timers}; objective history {metrics['objective_history']}; validation AUC "
                f"{metrics['best_metric']!r}; streaming block {metrics.get('streaming')}")
        mem, stream = runs["in memory"][1], runs["streamed"][1]
        hist, ref = stream["objective_history"], mem["objective_history"]
        # phase 15's streamed entity shards: run T's objectives and files
        POD_INPUTS["t_history"] = hist
        POD_INPUTS["t_train"] = shutil.copytree(
            f"{tmp}/train", os.path.join(tempfile.mkdtemp(prefix="photon_pod_t_"), "train"))
        gap = max(abs(a - b) / abs(b) for a, b in zip(hist, ref))
        say(f"streamed run T ({smi}): CD objective gap to the in-memory run {gap!r} "
            f"(limit {STREAM_T_OBJ_RTOL}); chunks {stream['streaming']['num_chunks']}")
        if any(b > a for a, b in zip(hist, hist[1:])) or len(hist) != len(ref):
            fail(f"streamed run T: the streamed CD objective rose or stopped early: {hist}")
        if not gap <= STREAM_T_OBJ_RTOL:
            fail("streamed run T: the streamed CD objective is off the in-memory run's")
        if stream["streaming"]["num_chunks"] < 4:
            fail(f"streamed run T: {stream['streaming']['num_chunks']} chunks, not >= 4")
        # the checkpointer: one step a CD iteration, the last one's restore
        # the final states bit for bit
        (combo,) = [d for d in os.listdir(f"{tmp}/ck") if d.startswith("combo-")]
        ck = StreamingCDCheckpointer(f"{tmp}/ck/{combo}/cd")
        states, _, _ = ck.load(ck.latest_step())
        final = runs["streamed"][0].best_result[0].models
        bitwise = all(
            np.array_equal(states[name], final[name].detach().cpu().numpy()) for name in final
        )
        segments = sorted(d for d in os.listdir(f"{tmp}/ck/{combo}/stage-train")
                          if "__seg" in d)
        say(f"streamed run T checkpoints ({smi}): steps {ck.steps()}, the last restore equals "
            f"the final states bitwise: {bitwise}; RE segments {len(segments)}")
        if ck.steps() != [1, 2] or not bitwise:
            fail("streamed run T: the CD checkpoints are not one a step with a bitwise restore")
        if len(segments) < 2:
            fail(f"streamed run T: {len(segments)} RE segment(s), not >= 2")
        # scoring: prebuilt feature maps from the in-memory run's index maps
        maps = f"{tmp}/maps"
        shard_cfgs = [FeatureShardConfiguration("globalShard", ["features"]),
                      FeatureShardConfiguration("userShard", ["userFeatures"])]
        ds = runs["in memory"][0]._train_dataset
        save_name_and_term_feature_sets({
            bag: [k for k, _ in ds.shards[cfg.shard_id].index_map.items() if k != intercept_key()]
            for cfg in shard_cfgs for bag in cfg.feature_bags
        }, maps)
        del ds, runs
        score_argv = [
            "--input-data-dirs", f"{tmp}/validate", "--game-model-input-dir",
            f"{tmp}/stream/best-model", "--feature-shard-id-to-feature-section-keys-map", shards,
            "--evaluator-types", "AUC", "--feature-name-and-term-set-path", maps, *device_args,
        ]
        aucs = {}
        for label, extra in (("in memory", ["--output-dir", f"{tmp}/score-mem"]),
                             ("streamed", ["--output-dir", f"{tmp}/score-stream",
                                           "--streaming", "true", "--rows-per-chunk", "4096"])):
            t0 = time.perf_counter()
            scorer = game_scoring_driver.main(score_argv + extra)
            aucs[label] = scorer.metrics["AUC"]
            timers = " ".join(f"{k}={v!r}" for k, v in scorer.timer.durations.items())
            say(f"streamed run T {label} scoring driver ({smi}): {time.perf_counter() - t0!r} s; "
                f"stage timers s: {timers}; AUC {aucs[label]!r}")
        if not abs(aucs["streamed"] - aucs["in memory"]) <= STREAM_T_AUC_TOL or \
                not aucs["streamed"] > 0.5:
            fail("streamed run T: the streamed scoring AUC is off the in-memory scoring's")


def stream_phase(seed, smi, k1, k2, device="cuda", device_args=(), then=None):
    """Phase 10: runs S and S2 and the direct objective checks over Avro
    files written by worker processes; -> (K1's and K2's launches in each
    run, the chunk's K1 numbers). ``device`` / ``device_args``: the CPU for
    a rehearsal at a small size. ``then(train_dir, tmp, run S's index map,
    the batch loaded with it, run S's float64 objective at lambda = 1)``
    runs over run S's files before they go (phase 14)."""
    import multiprocessing
    import re
    from concurrent.futures import ProcessPoolExecutor

    from photon_ml_tpu_torch.evaluation.metrics import area_under_roc_curve
    from photon_ml_tpu_torch.io.input_format import AvroInputDataFormat
    from photon_ml_tpu_torch.io.model_io import load_glm_models_avro
    from photon_ml_tpu_torch.models.glm import compute_margins
    from photon_ml_tpu_torch.optim.config import OptimizerType, RegularizationType
    from photon_ml_tpu_torch.task import TaskType
    from photon_ml_tpu_torch.training import train_generalized_linear_model
    from photon_ml_tpu_torch.utils.index_map import IndexMap

    with tempfile.TemporaryDirectory(prefix="photon_stream_phase_") as tmp:
        t0 = time.perf_counter()
        jobs = [(seed, f"{tmp}/train/part-{p:05d}.avro", "train", p, STREAM_ROWS // STREAM_PARTS)
                for p in range(STREAM_PARTS)]
        jobs.append((seed, f"{tmp}/validate/part-00000.avro", "validate", 0, STREAM_HELD_OUT))
        for kind in ("train", "validate"):
            os.makedirs(f"{tmp}/{kind}")
        with ProcessPoolExecutor(len(jobs), mp_context=multiprocessing.get_context("spawn")) as pool:
            written = list(pool.map(stream_part, jobs))
        say(f"stream data: {sum(written[:-1])} training rows in {STREAM_PARTS} Avro parts and "
            f"{written[-1]} validation rows, written by {len(jobs)} worker processes in "
            f"{time.perf_counter() - t0!r} s")
        train_dir, val_dir = f"{tmp}/train", f"{tmp}/validate"
        common = ["--training-data-directory", train_dir,
                  "--streaming", "true", "--stream-memory-budget", str(STREAM_BUDGET),
                  "--scan-cache-dir", f"{tmp}/scan-cache"]
        s = stream_run("S", common + ["--validating-data-directory", val_dir,
                                      "--regularization-weights", "10,1",
                                      "--compute-variances", "true"],
                       f"{tmp}/out-S", k1, k2, f"L-BFGS [10, 1], cold scan cache, {smi}", device_args)
        if s["metrics"]["streaming"]["tiers"] != STREAM_TIERS:
            fail(f"streamed run S: tiers {s['metrics']['streaming']['tiers']}, expected "
                 f"{STREAM_TIERS}")
        sc = s["metrics"]["scan_cache"]
        if sc["scanned"] != STREAM_PARTS or sc["cached"]:
            fail(f"streamed run S: the cold scan cache {sc}")

        # the direct trainer on the batch the port's Avro loader gives
        imap = IndexMap.load(f"{tmp}/out-S/feature-index/index.json")
        fmt = AvroInputDataFormat()
        t0 = time.perf_counter()
        loaded = fmt.load(train_dir, index_map=imap, device=device)
        batch = loaded.batch
        say(f"stream load ({smi}): {STREAM_ROWS} rows loaded in memory in "
            f"{time.perf_counter() - t0!r} s")
        d_models, d_results = train_generalized_linear_model(
            batch, TaskType.LOGISTIC_REGRESSION, imap.size,
            optimizer_type=OptimizerType.LBFGS, regularization_type=RegularizationType.L2,
            regularization_weights=[10.0, 1.0], intercept_index=loaded.intercept_index,
            kernel="tiled", device=device,
        )
        written_models = load_glm_models_avro(f"{tmp}/out-S/models/models.avro", imap,
                                              device=device)
        vdata = fmt.load(val_dir, index_map=imap, device=device)
        for lam in (10.0, 1.0):
            ref = d_models[lam].means
            f_ref, g_ref = objective64(batch, ref, lam)
            m = s["driver"].models[lam].means
            f_s, g_s = objective64(batch, m, lam)
            rel = (f_s - f_ref) / abs(f_ref)
            spread = float((m - ref).abs().max() / ref.abs().max())
            auc_file = s["metrics"]["validation"][str(lam)]["AUC"]
            auc = float(area_under_roc_curve(
                compute_margins(written_models[str(lam)].means, vdata.batch),
                vdata.batch.labels, vdata.batch.weights))
            say(f"streamed run S lambda={lam} vs the direct fit ({smi}): objective {f_s!r} vs "
                f"{f_ref!r}, relative {rel!r}; gradient max-abs {g_s!r} ({g_ref!r} direct); "
                f"intercept_spread {spread!r}; streamed AUC {auc_file!r}, exact AUC of the "
                f"written model {auc!r}")
            # another algorithm over the same rows (the host optimizer over
            # streamed chunks against the in-memory fit): held by the
            # objective, the spread printed as a measurement
            if not abs(rel) <= DRIVER_OBJ_RTOL:
                fail(f"streamed run S lambda={lam}: objective off the direct fit's")
            if not abs(auc_file - auc) <= STREAM_AUC_TOL or not auc > 0.5:
                fail(f"streamed run S lambda={lam}: the streamed AUC is off the exact one")
            if s["driver"].models[lam].coefficients.variances is None:
                fail(f"streamed run S lambda={lam}: no variances")
        f_wrong, _ = objective64(batch, s["driver"].models[10.0].means, 1.0)
        f_ref, _ = objective64(batch, d_models[1.0].means, 1.0)
        rel = (f_wrong - f_ref) / abs(f_ref)
        say(f"stream control ({smi}): run S's lambda=10 model at lambda=1, objective "
            f"relative difference {rel!r}")
        if abs(rel) <= DRIVER_OBJ_RTOL:
            fail("the streamed objective check does not tell the lambda = 10 model apart")
        f_s1 = objective64(batch, s["driver"].models[1.0].means, 1.0)[0]
        del d_models, vdata, written_models
        s["driver"] = None

        chunk = stream_objective_checks(k1, train_dir, fmt, imap, s["stats"], batch, smi, seed,
                                        device)
        torch.cuda.empty_cache()

        # S2 repeats neither S's validation nor its data checks (its
        # chapters need no validation rows: a streamed run has none in
        # memory, as in the JAX package)
        s2 = stream_run("S2", common + ["--regularization-weights", "1", "--optimizer", "TRON",
                                        "--diagnostic-mode", "ALL",
                                        "--data-validation-type", "VALIDATE_DISABLED"],
                        f"{tmp}/out-S2", k1, k2, f"TRON at 1, warm scan cache, reservoir, {smi}",
                        device_args)
        sc2 = s2["metrics"]["scan_cache"]
        same_map = open(f"{tmp}/out-S/feature-index/index.json").read() == \
            open(f"{tmp}/out-S2/feature-index/index.json").read()
        say(f"streamed run S2 scan cache ({smi}): {sc2}; the same index map as S: {same_map}; "
            f"the same stats: {s2['stats'] == s['stats']}")
        if sc2["cached"] != STREAM_PARTS or sc2["scanned"] or not same_map \
                or s2["stats"] != s["stats"]:
            fail("streamed run S2: the warm scan cache did not serve every partition as S saw it")
        f_tron = objective64(batch, s2["driver"].models[1.0].means, 1.0)[0]
        rel = (f_tron - f_s1) / abs(f_s1)
        with open(f"{tmp}/out-S2/model-diagnostics/report.txt") as f:
            report = f.read()
        chapters = [c for c in ("Model lambda=1.0", "Bootstrap analysis") if c in report]
        bad = re.findall(r"\b(nan|inf)\b", report, re.IGNORECASE)
        say(f"streamed run S2 ({smi}): TRON objective at lambda=1 {f_tron!r}, relative to run "
            f"S's L-BFGS {rel!r}; report chapters {chapters}, non-finite numbers {len(bad)}; "
            f"reservoir rows {s2['driver']._stream_sample.num_rows}")
        if not abs(rel) <= DRIVER_OBJ_RTOL:
            fail("streamed run S2: the TRON fit is off run S's objective at lambda = 1")
        if len(chapters) != 2 or bad:
            fail("streamed run S2: the diagnostics report lacks a chapter or holds non-finite numbers")
        s2["driver"] = None
        if then is not None:
            then(train_dir, tmp, imap, batch, f_s1)
    k1.launches = 0
    k2.launches = 0
    t0 = time.perf_counter()
    stream_run_t(seed, smi, device_args)
    say(f"streamed run T: {time.perf_counter() - t0!r} s of host time ({smi}); K1 launches "
        f"{k1.launches} (the streamed fixed effect is the scatter partial, as in the JAX "
        f"package), K2 launches {k2.launches}")
    return ({"S": s["k1"], "S2": s2["k1"], "T": k1.launches},
            {"S": s["k2"], "S2": s2["k2"], "T": k2.launches}, chunk)


# -- phase 14: GAME's fixed effect over meshes, multi-process streaming ----------

P14_MESHES = ((2, 1), (1, 2))  # (data, model) gloo ranks on the one card
P14_TIMEOUT_S = 300


def p14_game_rows(seed, device):
    """Run H's global shard as a GameDataset on ``device``: GAME_H_USERS
    users x GAME_ROWS_PER_USER rows at DIM features (64 a row and the
    intercept; run H's model from the seed, its rows from another draw),
    and a residual from the seed."""
    from photon_ml_tpu_torch.game import GameDataset, ShardData
    from photon_ml_tpu_torch.utils.index_map import IdentityIndexMap

    w_global, w_user = game_model(np.random.default_rng([seed, 5]), GAME_H_USERS, DIM)
    rng = np.random.default_rng([seed, 14])
    users = np.repeat(np.arange(GAME_H_USERS), GAME_ROWS_PER_USER)
    n = len(users)
    g_idx, g_val, _, _, labels, _ = game_rows(rng, users, w_global, w_user)
    ds = GameDataset(
        uids=[""] * n, labels=labels, offsets=np.zeros(n, np.float32),
        weights=np.ones(n, np.float32),
        shards={"global": ShardData(g_idx, g_val, IdentityIndexMap(DIM - 1, add_intercept=True),
                                    DIM - 1)},
        entity_codes={}, entity_indexes={}, num_real_rows=n, device=torch.device(device),
    )
    residual = torch.as_tensor(rng.normal(scale=0.3, size=n).astype(np.float32), device=device)
    return ds, residual


def mesh_fe_rank(mesh, seed, device="cuda"):
    """Phase 14, one rank (``mesh``) or the single card (None): the fixed
    effect on the tiled kernel (K1 on the rank's cell) over run H's global
    shard: two cold fits, then one with a residual, each with K1's count
    at 0 just before it; -> [{coefficients, iterations, value, seconds,
    K1 launches}]."""
    from photon_ml_tpu_torch.game import FixedEffectCoordinate
    from photon_ml_tpu_torch.ops.kernels import bilinear_pass as k1
    from photon_ml_tpu_torch.optim.config import (
        OptimizerConfig,
        RegularizationContext,
        RegularizationType,
    )
    from photon_ml_tpu_torch.optim.problem import create_glm_problem
    from photon_ml_tpu_torch.task import TaskType

    ds, residual = p14_game_rows(seed, device if mesh is None else mesh.device)
    fe = FixedEffectCoordinate(
        name="global", dataset=ds,
        problem=create_glm_problem(
            TaskType.LOGISTIC_REGRESSION, DIM, config=OptimizerConfig(max_iter=50),
            regularization=RegularizationContext(RegularizationType.L2),
            intercept_index=DIM - 1, kernel="tiled",
        ),
        feature_shard_id="global", reg_weight=1.0, mesh=mesh,
    )
    fe.prepare()
    fits = []
    for r in (None, None, residual):
        k1.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, result = fe.update_model(None, r)
        torch.cuda.synchronize()
        fits.append(dict(
            coef=model.model.means.cpu().numpy(), iterations=int(result.iterations),
            value=float(result.value), seconds=time.perf_counter() - t0, k1=k1.launches,
        ))
    return fits


# the dense feature-sharded fit on the 1 x 2 mesh: 2^16 rows x 2,048
# features of float32 (512 MiB in all, a block of 256 MiB a rank)
P14_DENSE_ROWS, P14_DENSE_DIM = 1 << 16, 2048
P14_DENSE_RTOL = 1e-5  # of the one-card fit's coefficients' max-abs
P14_PUBLIC_ITERS = 20  # the public entry points' fits' budget (TRON: 5)


def p14_dense_data(seed, device):
    """The dense fit's rows, made on the card from the seed (the same bits
    in every process): normal features, planted logistic labels."""
    from photon_ml_tpu_torch.data.batch import DenseBatch

    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(P14_DENSE_ROWS, P14_DENSE_DIM, generator=gen, device=device)
    w = torch.randn(P14_DENSE_DIM, generator=gen, device=device) / P14_DENSE_DIM**0.5
    u = torch.rand(P14_DENSE_ROWS, generator=gen, device=device)
    labels = (u < torch.sigmoid(x @ w)).float()
    zeros = torch.zeros(P14_DENSE_ROWS, device=device)
    return DenseBatch(x, labels, zeros, torch.ones_like(zeros))


def p14_counted(fn):
    """``fn()`` with K1's count at 0 just before it; -> (its result, K1
    launches, seconds to a synchronised end)."""
    from photon_ml_tpu_torch.ops.kernels import bilinear_pass as k1

    k1.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, k1.launches, time.perf_counter() - t0


def p14_fit_record(result, launches, seconds):
    return dict(coef=result.coefficients.cpu().numpy(), value=float(result.value),
                iterations=int(result.iterations), reason=result.reason_name,
                k1=launches, seconds=seconds)


def p14_same_key(ds, cache_dir, device):
    """Every process tiles run H's whole global shard (one key a pass)
    under one cold cache directory: process 0 stores, the others wait for
    its artifacts; -> the cache counters, a digest of the schedules and
    K1's z- and g-pass outputs on them (bitwise across the processes)."""
    import hashlib

    from photon_ml_tpu_torch.ops import schedule_cache
    from photon_ml_tpu_torch.ops import tiled_sparse as ts

    schedule_cache.reset_stats()
    with schedule_cache.cache_scope(cache_dir):
        tb = ts.tiled_batch_from_sparse(ds.batch_for_shard("global"), DIM, device=device)
    stats = schedule_cache.stats().as_dict()
    digest = hashlib.blake2b(digest_size=16)
    for sched in (tb.z_sched, tb.g_sched):
        for t in (sched.step_out, sched.step_in, sched.step_init, sched.out_pos, sched.in_pos,
                  sched.vals, sched.spill_out, sched.spill_in, sched.spill_vals):
            digest.update(t.cpu().numpy().tobytes())
    rng = np.random.default_rng(16)
    w = torch.as_tensor(rng.normal(size=tb.dim).astype(np.float32), device=device)
    c = torch.as_tensor(rng.normal(size=tb.num_rows).astype(np.float32), device=device)
    (z, g), launches, _ = p14_counted(lambda: (ts.tiled_z_pass(tb, w), ts.tiled_g_pass(tb, c)))
    return dict(stats=stats, digest=digest.hexdigest(), builder=tb.builder,
                z=z.cpu().numpy(), g=g.cpu().numpy(), k1=launches)


def p14_surface(mesh, ds, cache_dir, seed):
    """The library surface's checks on one rank of phase 14's meshes: on the
    2 x 1 mesh the schedule cache's roles over one key and
    ``data_parallel_fit_lbfgs`` (K1 on each rank's shard); on the 1 x 2
    mesh ``feature_sharded_tiled_fit`` and ``_tron`` against
    ``feature_sharded_glm_fit`` on the rank's cell (K1), and the dense
    ``feature_sharded_fit`` twice."""
    from photon_ml_tpu_torch.ops import tiled_sparse as ts
    from photon_ml_tpu_torch.ops.losses import LOGISTIC
    from photon_ml_tpu_torch.ops.objective import GLMObjective
    from photon_ml_tpu_torch.parallel import distributed as fits
    from photon_ml_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS

    t_surface = time.perf_counter()
    batch = ds.batch_for_shard("global")
    tiled = ts.TiledGLMObjective(LOGISTIC, DIM)
    out = {}
    if mesh.size(DATA_AXIS) > 1:
        out["same_key"] = p14_same_key(ds, cache_dir, mesh.device)
        fit = fits.data_parallel_fit_lbfgs(tiled, mesh, max_iter=P14_PUBLIC_ITERS)
        out["data_parallel"] = p14_fit_record(*p14_counted(
            lambda: fit(torch.zeros(DIM, device=mesh.device), batch, 1.0)))
        out["seconds"] = time.perf_counter() - t_surface
        return out
    cell, block_dim = ts.feature_shard_tiled_batch(
        batch, DIM, 1, mesh.size(MODEL_AXIS), 0, mesh.index(MODEL_AXIS), device=mesh.device,
        builders=mesh.ranks_sharing((DATA_AXIS, MODEL_AXIS)),
    )
    w0 = torch.zeros(mesh.size(MODEL_AXIS) * block_dim, device=mesh.device)
    for name, public, general in (
        ("tiled_fit", fits.feature_sharded_tiled_fit(
            tiled, mesh, cell.meta, max_iter=P14_PUBLIC_ITERS),
         fits.feature_sharded_glm_fit(tiled, mesh, max_iter=P14_PUBLIC_ITERS)),
        ("tiled_fit_tron", fits.feature_sharded_tiled_fit_tron(tiled, mesh, cell.meta, max_iter=5),
         fits.feature_sharded_glm_fit(tiled, mesh, optimizer="tron", max_iter=5, tol=1e-5)),
    ):
        a = p14_fit_record(*p14_counted(lambda: public(w0, cell, 1.0)))
        b = p14_fit_record(*p14_counted(lambda: general(w0, cell, 1.0)))
        a["bitwise_general"] = bool(np.array_equal(a["coef"], b["coef"])
                                    and a["value"] == b["value"]
                                    and a["iterations"] == b["iterations"])
        a["general_k1"] = b["k1"]
        del a["coef"]
        out[name] = a
    dense = p14_dense_data(seed, mesh.device)
    fit = fits.feature_sharded_fit(GLMObjective(LOGISTIC, P14_DENSE_DIM), mesh,
                                   max_iter=P14_PUBLIC_ITERS)
    runs = [p14_fit_record(*p14_counted(lambda: fit(
        torch.zeros(P14_DENSE_DIM, device=mesh.device), dense.features, dense.labels,
        dense.offsets, dense.weights, 1.0))) for _ in range(2)]
    out["dense"] = dict(runs[0], repeat=bool(np.array_equal(runs[0]["coef"], runs[1]["coef"])))
    out["seconds"] = time.perf_counter() - t_surface
    return out


def p14_rank(mesh, seed, cache_dir):
    """One rank of phase 14's meshes: run H's fixed effect
    (``mesh_fe_rank``), then the library surface's checks."""
    ds, _ = p14_game_rows(seed, mesh.device)
    return dict(fe=mesh_fe_rank(mesh, seed), surface=p14_surface(mesh, ds, cache_dir, seed))


def p14_single(seed, device="cuda"):
    """The single card's counterparts of phase 14's meshes: run H's fixed
    effect, the data-parallel fit's problem on the whole shard, and the
    dense fit."""
    from photon_ml_tpu_torch.ops.losses import LOGISTIC
    from photon_ml_tpu_torch.ops.objective import GLMObjective
    from photon_ml_tpu_torch.optim.lbfgs import minimize_lbfgs
    from photon_ml_tpu_torch.ops import tiled_sparse as ts

    t_surface = time.perf_counter()
    ds, _ = p14_game_rows(seed, device)
    tiled = ts.TiledGLMObjective(LOGISTIC, DIM)
    tb = ts.tiled_batch_from_sparse(ds.batch_for_shard("global"), DIM, device=device)
    data_parallel = p14_fit_record(*p14_counted(lambda: minimize_lbfgs(
        lambda w: tiled.value_and_gradient(w, tb, 1.0), torch.zeros(DIM, device=device),
        max_iter=P14_PUBLIC_ITERS)))
    dense = p14_dense_data(seed, device)
    obj = GLMObjective(LOGISTIC, P14_DENSE_DIM)
    dense_fit = p14_fit_record(*p14_counted(lambda: minimize_lbfgs(
        lambda w: obj.value_and_gradient(w, dense, 1.0),
        torch.zeros(P14_DENSE_DIM, device=device), max_iter=P14_PUBLIC_ITERS)))
    del dense
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_surface
    return dict(fe=mesh_fe_rank(None, seed, device), data_parallel=data_parallel,
                dense=dense_fit, seconds=seconds)


def p14_meshes(seed, smi, device="cuda"):
    """Phase 14's meshes: the fixed effect over a 2 x 1 and a 1 x 2 mesh
    (spawned side by side), each rank's two cold fits bitwise and every
    rank's bits the same, K1 launched on every rank, each fit's objective
    within DRIVER_OBJ_RTOL of the single card's (the cells sum in another
    order); then the library surface's checks on the same ranks
    (``p14_surface``, ``p14_surface_checks``); -> per mesh its fits'
    seconds and launches, and the surface's numbers."""
    with tempfile.TemporaryDirectory(prefix="photon_p14_cache_") as cache_dir, \
            ThreadPoolExecutor(len(P14_MESHES)) as pool:
        futures = {
            shape: pool.submit(spawn_mesh_checked, p14_rank, shape, (seed, cache_dir), device)
            for shape in P14_MESHES
        }
        single = p14_single(seed, device)  # while the ranks start
        ranks = {shape: f.result() for shape, f in futures.items()}
        stored = len(os.listdir(f"{cache_dir}/v1")) if os.path.isdir(f"{cache_dir}/v1") else 0
    out = {}
    for shape, runs in ranks.items():
        first = runs[0]["fe"]
        repeat = np.array_equal(first[0]["coef"], first[1]["coef"])
        agree = all(
            np.array_equal(a["coef"], b["coef"]) and a["iterations"] == b["iterations"]
            for r in runs[1:] for a, b in zip(first, r["fe"])
        )
        rels = [abs(f["value"] - s["value"]) / abs(s["value"])
                for f, s in zip((first[0], first[2]), (single["fe"][0], single["fe"][2]))]
        launches = [f["k1"] for r in runs for f in r["fe"]]
        say(f"phase 14 mesh {shape} ({smi}): fits {[f['seconds'] for f in first]} s, "
            f"iterations {[f['iterations'] for f in first]} (single card "
            f"{[f['iterations'] for f in single['fe']]}), K1 launches a rank and fit {launches}; "
            f"two cold fits bitwise {repeat}, ranks bitwise {agree}; objective vs the single "
            f"card cold / with a residual {rels}")
        if not (repeat and agree):
            fail(f"phase 14 mesh {shape}: the fits do not repeat bitwise on every rank")
        if min(launches) == 0:
            fail(f"phase 14 mesh {shape}: a rank's fit launched no K1")
        if max(rels) > DRIVER_OBJ_RTOL:
            fail(f"phase 14 mesh {shape}: the fit is off the single card's")
        out["x".join(map(str, shape))] = dict(
            seconds=[f["seconds"] for f in first], k1=launches)
    out["surface"] = p14_surface_checks(
        [r["surface"] for r in ranks[(2, 1)]], [r["surface"] for r in ranks[(1, 2)]],
        single, stored, smi)
    return out


def p14_surface_checks(data_ranks, model_ranks, single, stored, smi):
    """The library surface's checks on phase 14's ranks: (b) one key that
    both ranks of the 2 x 1 mesh build: rank 0 stores it, rank 1 waits,
    loads and builds nothing, their schedules and K1's passes on them
    bitwise; ``data_parallel_fit_lbfgs`` the same bits on both ranks,
    within DRIVER_OBJ_RTOL of the single card's fit, K1 on each rank;
    (c) on the 1 x 2 mesh ``feature_sharded_tiled_fit`` and ``_tron``
    bitwise ``feature_sharded_glm_fit`` with K1 on each rank, the dense
    ``feature_sharded_fit`` repeating bitwise and within P14_DENSE_RTOL
    of the one-card dense fit; -> the numbers."""
    r0, r1 = (r["same_key"] for r in data_ranks)
    s0, s1 = r0["stats"], r1["stats"]
    same_bits = (r0["digest"] == r1["digest"] and np.array_equal(r0["z"], r1["z"])
                 and np.array_equal(r0["g"], r1["g"]))
    say(f"phase 14 cache roles, one key on 2 ranks ({smi}): rank 0 builds={s0['builds']} "
        f"stores={s0['stores']} wait_s={s0['wait_s']!r}; rank 1 builds={s1['builds']} "
        f"stores={s1['stores']} hits={s1['hits']} wait_s={s1['wait_s']!r} (its schedules "
        f"by {r1['builder']}); artifacts stored {stored}; schedules and K1 z / g passes "
        f"bitwise {same_bits} (K1 launches {r0['k1']} / {r1['k1']})")
    if not (s0["builds"] == s0["stores"] == 2 and s1["builds"] == s1["stores"] == 0
            and s1["hits"] == 2 and s1["wait_s"] > 0 and stored == 2):
        fail("phase 14: the process that shares a key did not wait for its writer's artifacts")
    if not same_bits or min(r0["k1"], r1["k1"]) == 0:
        fail("phase 14: the loaded schedules or K1's passes on them are not the writer's bits")
    dp = [r["data_parallel"] for r in data_ranks]
    rel = abs(dp[0]["value"] - single["data_parallel"]["value"]) / abs(
        single["data_parallel"]["value"])
    say(f"phase 14 data_parallel_fit_lbfgs on 2 x 1 ({smi}): {dp[0]['seconds']!r} s, "
        f"{dp[0]['iterations']} iterations ({dp[0]['reason']}), K1 launches a rank "
        f"{[d['k1'] for d in dp]}; ranks bitwise {np.array_equal(dp[0]['coef'], dp[1]['coef'])}; "
        f"objective vs the single card's {single['data_parallel']['value']!r} (rel {rel!r})")
    if not np.array_equal(dp[0]["coef"], dp[1]["coef"]) or min(d["k1"] for d in dp) == 0:
        fail("phase 14: data_parallel_fit_lbfgs differs between ranks or launched no K1")
    if rel > DRIVER_OBJ_RTOL:
        fail("phase 14: data_parallel_fit_lbfgs is off the single card's fit")
    out = dict(cache=dict(rank0=s0, rank1=s1, stored=stored),
               data_parallel=dict(k1=[d["k1"] for d in dp], rel=rel, seconds=dp[0]["seconds"]))
    for name in ("tiled_fit", "tiled_fit_tron"):
        runs = [r[name] for r in model_ranks]
        say(f"phase 14 {name} on 1 x 2 ({smi}): {runs[0]['seconds']!r} s, "
            f"{runs[0]['iterations']} iterations ({runs[0]['reason']}), K1 launches a rank "
            f"{[r['k1'] for r in runs]} (feature_sharded_glm_fit {[r['general_k1'] for r in runs]}); "
            f"bitwise feature_sharded_glm_fit on every rank "
            f"{all(r['bitwise_general'] for r in runs)}")
        if not all(r["bitwise_general"] for r in runs) or min(r["k1"] for r in runs) == 0:
            fail(f"phase 14: {name} is not feature_sharded_glm_fit's bits, or launched no K1")
        out[name] = dict(k1=[r["k1"] for r in runs], seconds=runs[0]["seconds"])
    dense = [r["dense"] for r in model_ranks]
    one = single["dense"]
    err = float(np.abs(dense[0]["coef"] - one["coef"]).max() / np.abs(one["coef"]).max())
    say(f"phase 14 dense feature_sharded_fit on 1 x 2, {P14_DENSE_ROWS} x {P14_DENSE_DIM} "
        f"float32 ({smi}): {dense[0]['seconds']!r} s, {dense[0]['iterations']} iterations "
        f"({dense[0]['reason']}; one card {one['iterations']}, {one['reason']}, "
        f"{one['seconds']!r} s); repeats bitwise {[d['repeat'] for d in dense]}, ranks bitwise "
        f"{np.array_equal(dense[0]['coef'], dense[1]['coef'])}; coefficients "
        f"{err!r} of the one-card fit's max-abs off it")
    if not (all(d["repeat"] for d in dense) and np.array_equal(dense[0]["coef"], dense[1]["coef"])):
        fail("phase 14: the dense feature-sharded fit does not repeat bitwise")
    if not err <= P14_DENSE_RTOL:
        fail("phase 14: the dense feature-sharded fit is off the one-card fit")
    out["dense"] = dict(err=err, seconds=dense[0]["seconds"], one_card_s=one["seconds"])
    out["seconds"] = dict(ranks=[r["seconds"] for r in data_ranks + model_ranks],
                          single=single["seconds"])
    say(f"phase 14 surface checks ({smi}): {out['seconds']['ranks']} s of host time in "
        f"the 2 x 1 and 1 x 2 ranks, {single['seconds']!r} s in this process, each beside "
        "run H's fixed-effect fits")
    return out


def spawn_mesh_checked(fn, shape, args, device="cuda"):
    """``spawn_mesh`` (on the card); a failure fails the script."""
    from photon_ml_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, spawn_mesh

    try:
        return spawn_mesh(fn, shape, (DATA_AXIS, MODEL_AXIS), device=device, args=args,
                          timeout_s=P14_TIMEOUT_S)
    except (RuntimeError, TimeoutError) as e:
        fail(f"phase 14 mesh {shape}: {e}")


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def p14_stream_start(train_dir, tmp, device_args=()):
    """Phase 14: two runs of ``glm_driver --streaming`` as 2 processes each
    (one a rank, gloo on the one card, ``--coordinator-address``) over run
    S's files and an off-heap store built from them, the runs side by
    side; -> (the processes, the output dirs)."""
    from photon_ml_tpu_torch.cli import feature_indexing_driver

    store = feature_indexing_driver.run_feature_indexing([train_dir], f"{tmp}/p14-store")
    here = os.path.dirname(os.path.abspath(__file__))
    procs, outs = [], []
    for run in range(2):
        port, out = free_port(), f"{tmp}/p14-out-{run}"
        outs.append(out)
        for rank in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "photon_ml_tpu_torch.cli.glm_driver",
                 "--training-data-directory", train_dir, "--streaming", "true",
                 "--stream-memory-budget", str(STREAM_BUDGET), "--regularization-weights", "1",
                 "--offheap-indexmap-dir", store, "--output-directory", out,
                 "--coordinator-address", f"127.0.0.1:{port}", "--num-processes", "2",
                 "--process-id", str(rank), *device_args],
                cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
    return procs, outs


def p14_feature_procs(sub, out, cache, device_args):
    """One run of the GLM driver in memory as 2 processes over a 1 x 2
    (data, model) mesh (``--distributed feature --model-shards 2``), its
    schedules through the cache directory ``cache``."""
    here = os.path.dirname(os.path.abspath(__file__))
    port = free_port()
    return [subprocess.Popen(
        [sys.executable, "-m", "photon_ml_tpu_torch.cli.glm_driver",
         "--training-data-directory", sub, "--regularization-weights", "1",
         "--distributed", "feature", "--model-shards", "2",
         "--output-directory", out, "--tile-cache-dir", cache,
         "--coordinator-address", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(rank), *device_args],
        cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    ) for rank in range(2)]


def p14_wait(procs, what):
    """-> each process's output; fails on a timeout or an exit code."""
    logs = []
    for p in procs:
        try:
            log, _ = p.communicate(timeout=P14_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            fail(f"phase 14: a {what} driver process did not end")
        if p.returncode != 0:
            fail(f"phase 14: a {what} driver process ended with {p.returncode}: {log[-3000:]}")
        logs.append(log)
    return logs


def p14_feature_start(train_dir, tmp, device_args=()):
    """Phase 14: two runs of the GLM driver in memory over 2 of run S's 8
    part files as 2 processes each, the coefficients over the processes'
    1 x 2 (data, model) mesh (``--distributed feature --model-shards 2``),
    both over one ``--tile-cache-dir``: the first cold; the second, warm,
    starts when the first ends (a thread waits for both) -> (the thread,
    the runs' processes and logs, the output dirs, the training dir, the
    cache dir)."""
    import threading

    sub, cache = f"{tmp}/p14-feature-train", f"{tmp}/p14-tile-cache"
    os.makedirs(sub)
    for part in sorted(os.listdir(train_dir))[:2]:
        shutil.copy(f"{train_dir}/{part}", sub)
    outs = [f"{tmp}/p14-feature-{run}" for run in range(2)]
    runs = {"cold": p14_feature_procs(sub, outs[0], cache, device_args)}

    def warm_after_cold():
        try:
            runs["cold_logs"] = p14_wait(runs["cold"], "feature-sharded (cold cache)")
            t0 = time.perf_counter()
            runs["warm"] = p14_feature_procs(sub, outs[1], cache, device_args)
            runs["warm_logs"] = p14_wait(runs["warm"], "feature-sharded (warm cache)")
            runs["warm_s"] = time.perf_counter() - t0
        except SystemExit:
            return

    chain = threading.Thread(target=warm_after_cold, daemon=True)
    chain.start()
    return chain, runs, outs, sub, cache


def p14_feature_procs_all(runs):
    return runs["cold"] + runs.get("warm", [])


CACHE_LOG = re.compile(
    r"tile-schedule cache: (\d+) hit\(s\), (\d+) miss\(es\), (\d+) build\(s\), "
    r"(\d+) store\(s\) .*wait ([0-9.]+)s\)")


def p14_cache_counters(logs, what):
    """Each process's schedule-cache counters from its driver log line."""
    out = []
    for log in logs:
        m = CACHE_LOG.search(log)
        if m is None:
            fail(f"phase 14: a {what} driver process logged no schedule-cache counters")
        hits, misses, builds, stores = (int(v) for v in m.groups()[:4])
        out.append(dict(hits=hits, misses=misses, builds=builds, stores=stores,
                        wait_s=float(m.group(5))))
    return out


def p14_feature_finish(chain, runs, outs, sub, cache, smi, device="cuda"):
    """Wait for phase 14's feature-sharded GLM driver processes: the cold
    run's builds over its processes equal the number of schedule keys (two
    cells of two passes), each key stored by one process and none waited
    for; the warm run builds nothing in either process; the two runs'
    models bitwise equal, the objective at lambda = 1 within
    DRIVER_OBJ_RTOL of the trainer's single-card fit on the rows the
    port's loader gives (its own sums)."""
    from photon_ml_tpu_torch.io.input_format import AvroInputDataFormat
    from photon_ml_tpu_torch.io.model_io import load_glm_models_avro
    from photon_ml_tpu_torch.optim.config import OptimizerType, RegularizationType
    from photon_ml_tpu_torch.task import TaskType
    from photon_ml_tpu_torch.training import train_generalized_linear_model
    from photon_ml_tpu_torch.utils.index_map import IndexMap

    chain.join(timeout=2 * P14_TIMEOUT_S)
    if "warm_logs" not in runs:
        for q in p14_feature_procs_all(runs):
            q.kill()
        fail("phase 14: the feature-sharded driver runs did not end")
    cold = p14_cache_counters(runs["cold_logs"], "feature-sharded (cold cache)")
    warm = p14_cache_counters(runs["warm_logs"], "feature-sharded (warm cache)")
    warm_s = runs["warm_s"]
    keys = len(os.listdir(f"{cache}/v1"))
    say(f"phase 14 feature-sharded GLM driver cache roles ({smi}): cold per process "
        f"{cold}; warm per process {warm}; {keys} artifacts stored; the warm run "
        f"{warm_s!r} s, started when the cold one ended")
    if not (sum(c["builds"] for c in cold) == sum(c["stores"] for c in cold) == keys == 4
            and all(c["wait_s"] == 0 for c in cold)):
        fail("phase 14: the cold driver run's builds, stores and keys disagree")
    if any(w["builds"] or w["stores"] or w["hits"] != 2 for w in warm):
        fail("phase 14: the warm driver run built a schedule")
    imap = IndexMap.load(f"{outs[0]}/feature-index/index.json")
    means = [load_glm_models_avro(f"{o}/models/models.avro", imap, device=device)["1.0"].means
             for o in outs]
    loaded = AvroInputDataFormat().load([sub], index_map=imap, device=device)
    direct, _ = train_generalized_linear_model(
        loaded.batch, TaskType.LOGISTIC_REGRESSION, imap.size,
        optimizer_type=OptimizerType.LBFGS, regularization_type=RegularizationType.L2,
        regularization_weights=[1.0], intercept_index=loaded.intercept_index,
        kernel="tiled", device=device,
    )
    f_mp, _ = objective64(loaded.batch, means[0], 1.0)
    f_one, _ = objective64(loaded.batch, direct[1.0].means, 1.0)
    rel = (f_mp - f_one) / abs(f_one)
    same = torch.equal(means[0], means[1])
    with open(f"{outs[0]}/metrics.json") as f:
        timers = json.load(f)["timers"]
    with open(f"{outs[1]}/metrics.json") as f:
        warm_timers = json.load(f)["timers"]
    say(f"phase 14 feature-sharded GLM driver, 2 processes over a 1 x 2 mesh ({smi}): "
        f"{loaded.batch.num_rows} rows x {imap.size} features, train {timers['train']!r} s "
        f"cold, {warm_timers['train']!r} s warm; the warm run bitwise the cold one {same}; "
        f"objective at lambda=1 {f_mp!r} vs the single card's {f_one!r} (rel {rel!r})")
    if not same:
        fail("phase 14: the warm feature-sharded multi-process driver run is not the cold one's bits")
    if not abs(rel) <= DRIVER_OBJ_RTOL:
        fail("phase 14: the feature-sharded driver fit is off the single card's")
    return dict(train_s=timers["train"], warm_train_s=warm_timers["train"], rel=rel,
                warm_s=warm_s, cache=dict(cold=cold, warm=warm, keys=keys))


def p14_stream_finish(procs, outs, imap, batch, f_s1, smi, device="cuda"):
    """Wait for phase 14's driver processes; the two runs' models must be
    bitwise equal and their objective at lambda = 1 within DRIVER_OBJ_RTOL
    of run S's (one process, warm-started from lambda = 10)."""
    from photon_ml_tpu_torch.io.model_io import load_glm_models_avro

    for p in procs:
        try:
            log, _ = p.communicate(timeout=P14_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            fail("phase 14: a streamed driver process did not end")
        if p.returncode != 0:
            fail(f"phase 14: a streamed driver process ended with {p.returncode}: {log[-3000:]}")
    means = [load_glm_models_avro(f"{o}/models/models.avro", imap, device=device)["1.0"].means
             for o in outs]
    with open(f"{outs[0]}/metrics.json") as f:
        metrics = json.load(f)
    f_mp, _ = objective64(batch, means[0], 1.0)
    rel = (f_mp - f_s1) / abs(f_s1)
    same = torch.equal(means[0], means[1])
    say(f"phase 14 streamed driver, 2 processes ({smi}): train {metrics['timers']['train']!r} s, "
        f"streaming {metrics['streaming']['tiers']} tiers in process 0; the two runs bitwise "
        f"{same}; objective at lambda=1 {f_mp!r} vs run S's {f_s1!r} (rel {rel!r})")
    if not same:
        fail("phase 14: two multi-process streamed runs are not bitwise")
    if not abs(rel) <= DRIVER_OBJ_RTOL:
        fail("phase 14: the multi-process streamed fit is off run S's objective")
    return dict(train_s=metrics["timers"]["train"], rel=rel)


def p14_game_start(h_dir, shards, tmp, device_args=()):
    """Phase 14: two runs of run H's GAME training driver (its argv but no
    model output, over run H's files as ``fleet_y_files`` kept them) as 2
    processes each, the
    fixed effect over a 1 x 2 (data, model) mesh of the processes
    (``--distributed feature --model-shards 2``), the random effect on
    every rank; -> (the processes, the output dirs)."""
    here = os.path.dirname(os.path.abspath(__file__))
    procs, outs = [], []
    for run in range(2):
        port, out = free_port(), f"{tmp}/p14-game-{run}"
        outs.append(out)
        for rank in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "photon_ml_tpu_torch.cli.game_training_driver",
                 "--train-input-dirs", f"{h_dir}/train",
                 "--validate-input-dirs", f"{h_dir}/validate", "--output-dir", out,
                 "--feature-shard-id-to-feature-section-keys-map", shards,
                 "--fixed-effect-data-configurations", "global:globalShard,1",
                 "--fixed-effect-optimization-configurations",
                 "global:50,1e-7,10,1,LBFGS,L2;50,1e-7,1,1,LBFGS,L2",
                 "--random-effect-data-configurations",
                 "per-user:userId,userShard,1,none,none,none,INDEX_MAP",
                 "--random-effect-optimization-configurations", "per-user:30,1e-5,1,1,LBFGS,L2",
                 "--num-iterations", "2", "--evaluator-types", "AUC",
                 "--compute-variance", "true", "--model-output-mode", "NONE",
                 "--distributed", "feature", "--model-shards", "2",
                 "--coordinator-address", f"127.0.0.1:{port}", "--num-processes", "2",
                 "--process-id", str(rank), *device_args],
                cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
    return procs, outs


def p14_game_finish(procs, outs, h_history, smi):
    """Wait for phase 14's GAME driver processes: the two runs' CD
    objective histories bitwise equal, and within 1e-4 relative of run
    H's single-process history (the mesh sums the fixed effect's partials
    in another order)."""
    for p in procs:
        try:
            log, _ = p.communicate(timeout=P14_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            fail("phase 14: a GAME driver process did not end")
        if p.returncode != 0:
            fail(f"phase 14: a GAME driver process ended with {p.returncode}: {log[-3000:]}")
    runs = []
    for o in outs:
        with open(f"{o}/metrics.json") as f:
            runs.append(json.load(f))
    hist = [r["objective_history"] for r in runs]
    rel = max(abs(a - b) / abs(b) for a, b in zip(hist[0], h_history))
    say(f"phase 14 GAME training driver, 2 processes, FE over a 1 x 2 mesh ({smi}): timers "
        f"{ {k: round(v, 3) for k, v in runs[0]['timers'].items()} }; objective history "
        f"{hist[0]}, the two runs bitwise {hist[0] == hist[1]}; vs run H's single process "
        f"{h_history} (largest relative gap {rel!r})")
    if hist[0] != hist[1]:
        fail("phase 14: two multi-process GAME driver runs are not bitwise")
    if not rel <= 1e-4:
        fail("phase 14: the multi-process GAME driver run is off run H's")
    return dict(timers=runs[0]["timers"], rel=rel)


# -- phase 15: the entity-sharded random effect and the unified mesh -------------

# N entity shards run as N gloo ranks sharing the one card (NCCL refuses
# two ranks on one card): every line of this phase checks the path, the
# layout and the parity, and counts bytes a rank; it measures no scaling
POD_LABEL = "ranks share one card through gloo's host staging: a path check, no scaling"
# what phase 8 and phase 10 leave for this phase: run G's user RE dataset
# and its sweep-1 offsets (plus residual), run T's streamed CD objectives
POD_INPUTS = {}
POD_SHARDS = (2, 4)  # run P's spawned entity meshes, side by side
# run P against the single card's replicated path, of their scale. A
# rank's blocks hold other entity counts than the buckets (a shard's
# entities, padded to the widest shard), and every per-entity product and
# sum of the solvers adds in row_sum's order on the card (K4), which
# depends on the row's length alone: each entity's arithmetic is the same
# in a bucket and in a block, so the rows, variances and scores are held
# to POD_RTOL at every N and the trackers must be equal (the result line
# says whether they were bitwise). The same update in float64 at
# POD_TIGHT_TOL on both paths must agree within POD_RTOL
POD_RTOL = 1e-5
POD_TIGHT_TOL = 1e-12
# run E and the streamed runs: objectives (relative), scores (of scale).
# Run E's N = 2 scores are not bitwise run H's: its fixed effect runs
# data-parallel over the 2 processes (partials summed in rank order, as
# in phase 14). They parted by 3.3e-4 of scale while the random effect's
# blocks also rounded by their shape (held to 2e-3 then), by
# 2.2e-5 since K4 (NVIDIA H100 80GB HBM3, 700 W); N = 1 is bitwise run H's
POD_E_RTOL = 1e-4
POD_TIMEOUT_S = 300
# run E's driver processes: the training driver's entry point, then K1's
# launches in the process on a line of their own
POD_E_MARK = "phase 15 K1 launches: "
POD_E_CHILD = (
    "import sys\n"
    "from photon_ml_tpu_torch.cli import game_training_driver\n"
    "from photon_ml_tpu_torch.ops.kernels import bilinear_pass\n"
    "game_training_driver.main(sys.argv[1:])\n"
    f"print({POD_E_MARK!r} + str(bilinear_pass.launches))\n"
)
# where phase 15 runs: the card (a CPU rehearsal sets "cpu" and
# ["--device", "cpu"]; the spawned ranks take their mesh's device)
POD_DEVICE = "cuda"
POD_DEVICE_ARGS = []
# run U: the JAX package's unified-mesh configuration (bench.py:1537-1660)
UNIFIED_N, UNIFIED_E, UNIFIED_D, UNIFIED_K = 4096, 512, 16, 6
UNIFIED_LAMBDAS = [0.1, 0.5, 1.0, 2.0]
UNIFIED_DUPLICATES = [0.5, 0.5, 2.0, 2.0]
UNIFIED_ITERS = 2
# run U against the per-member pod CD: the objectives relative, the banks
# of their scale. The grid folds its members into the solvers' batch, so a
# lane's Newton products run at another batch size than the member's own
# and round otherwise; at 5 iterations the RE rows are unconverged, and
# parted by 2.8e-4 of their scale in a CPU rehearsal: Queue 3's 5e-4
UNIFIED_OBJ_RTOL = 1e-5
UNIFIED_ROW_RTOL = 5e-4


def pod_problem(tolerance=1e-5):
    """Run G's user random-effect problem (the dense Newton solver on its
    buckets of 25,000)."""
    from photon_ml_tpu_torch.game import RandomEffectOptimizationProblem
    from photon_ml_tpu_torch.ops.losses import LOGISTIC
    from photon_ml_tpu_torch.optim.config import (
        OptimizerConfig,
        OptimizerType,
        RegularizationContext,
        RegularizationType,
    )

    return RandomEffectOptimizationProblem(
        LOGISTIC,
        OptimizerConfig(OptimizerType.LBFGS, max_iter=30, tolerance=tolerance, lbfgs_history=5),
        RegularizationContext(RegularizationType.L2), reg_weight=1.0,
    )


def pod_sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def scale_err(got, want) -> float:
    """max |got - want| over want's max-abs."""
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def pod_run(mesh, red, offsets, save=None, tight=False):
    """Two pod updates with variances and a score of run G's user random
    effect on this rank, each between two synchronizations; -> seconds,
    fetches, transport counts, bytes, a float64 gradient check on sampled
    entities and a digest of the gathered bank (the same on every rank),
    and the gathered bank, variances and scores (with ``tight`` also the
    bank of one more update in float64 at POD_TIGHT_TOL): saved as
    ``.npy`` under the prefix ``save`` by rank 0 (a spawned rank), else
    returned."""
    import dataclasses
    import hashlib

    from photon_ml_tpu_torch.game.pod import PodRandomEffectProblem, per_device_bytes
    from photon_ml_tpu_torch.optim import common
    from photon_ml_tpu_torch.parallel import shuffle

    pod = PodRandomEffectProblem(pod_problem(), mesh)
    pod_sync(mesh.device)
    t0 = time.perf_counter()
    pod.prepare(red)
    view_s = time.perf_counter() - t0
    out = {"update_s": [], "fetches": [], "transport": [], "view_s": view_s}
    banks = []
    for _ in range(2):
        shuffle.reset_stats()
        f0 = common.host_fetches
        pod_sync(mesh.device)
        t0 = time.perf_counter()
        bank, tracker, var = pod.update_bank(pod.init_bank(red), red, offsets, with_variances=True)
        pod_sync(mesh.device)
        out["update_s"].append(time.perf_counter() - t0)
        out["fetches"].append(common.host_fetches - f0)
        out["transport"].append(dict(shuffle.stats))
        banks.append(bank)
    pod_sync(mesh.device)
    t0 = time.perf_counter()
    score = pod.score(banks[1], red)
    pod_sync(mesh.device)
    out["score_s"] = time.perf_counter() - t0
    whole, whole_var = banks[1].to_global(), var.to_global()
    out["repeat_bitwise"] = bool(torch.equal(banks[0].data, banks[1].data))
    out["digest"] = hashlib.sha256(whole.cpu().numpy().tobytes()).hexdigest()
    sample = np.random.default_rng(4).choice(red.num_entities, GAME_RE_SAMPLE, replace=False)
    out["gradient"] = game_re_gradients(None, red, whole, offsets, sample)
    out["finite"] = bool(torch.isfinite(whole).all() and torch.isfinite(score).all())
    spec = banks[1].spec
    out["bytes"] = per_device_bytes(banks[1], var)
    out["share_bytes"] = 2 * spec.rows_per_shard * red.local_dim * 4
    out["tracker"] = tracker_key(tracker)
    arrays = {"bank": whole, "var": whole_var, "score": score}
    if tight:
        pod.base.config = dataclasses.replace(pod.base.config, tolerance=POD_TIGHT_TOL)
        arrays["tight"] = pod.update_bank(
            pod.init_bank(red, dtype=torch.float64), red, offsets.double())[0].to_global()
    if save is None:
        out["arrays"] = arrays
    elif mesh.rank == 0:
        for name, t in arrays.items():
            np.save(f"{save}-{name}.npy", t.cpu().numpy())
    return out


def tracker_key(tracker):
    """A RandomEffectTracker as a comparable tuple."""
    return (tracker.num_entities, tracker.iterations_mean, tracker.iterations_max,
            sorted(tracker.reason_counts.items()))


def pod_rank_p(mesh, path):
    """Run P on one rank of an entity mesh: run G's inputs from the
    phase's file, the pod run on this rank's shard (K1's launches in it
    counted), rank 0's gathered results saved beside the file."""
    import pickle

    from photon_ml_tpu_torch.ops.kernels import bilinear_pass as k1
    from photon_ml_tpu_torch.ops.kernels import entity_products as k4

    with open(path, "rb") as f:
        d = pickle.load(f)
    red = d["red"]
    red.device = mesh.device
    k1.launches = 0
    k4.launches = 0
    out = pod_run(mesh, red, torch.as_tensor(d["offsets"], device=mesh.device),
                  save=f"{path}-n{mesh.size('entity')}", tight=True)
    out["k1"] = k1.launches
    out["k4"] = k4.launches
    out["rank"] = mesh.rank
    return out


def pod_run_p(seed, smi, tmp):
    """Run P: run G's user random effect through PodRandomEffectProblem on
    entity meshes of 1 rank (in process) and of 2 and 4 gloo ranks
    (spawned side by side, the inputs handed over in a file), against the
    single card's replicated update_bank and score_random_effect at the
    same inputs."""
    import pickle

    from photon_ml_tpu_torch.game import score_random_effect
    from photon_ml_tpu_torch.ops.kernels import bilinear_pass as k1
    from photon_ml_tpu_torch.ops.kernels import entity_products as k4
    from photon_ml_tpu_torch.parallel.mesh import ENTITY_AXIS, entity_mesh, spawn_mesh

    red, offsets = POD_INPUTS.pop("red"), POD_INPUTS.pop("offsets")

    def drop_device_copies():
        for b in red.buckets:
            b.__dict__.pop("_device_args", None)
            b.__dict__.pop("_mesh_args", None)
        red.__dict__.pop("_device_rows", None)

    drop_device_copies()
    if POD_DEVICE == "cuda":
        torch.cuda.empty_cache()
    path = f"{tmp}/run_p.pkl"
    t0 = time.perf_counter()
    with open(path, "wb") as f:
        pickle.dump({"red": red, "offsets": offsets}, f, protocol=5)
    say(f"phase 15 run P: inputs written for the ranks in {time.perf_counter() - t0!r} s "
        f"({os.path.getsize(path)} bytes)")
    with ThreadPoolExecutor(len(POD_SHARDS)) as pool:
        futures = {n: pool.submit(spawn_mesh, pod_rank_p, (n,), (ENTITY_AXIS,), device=POD_DEVICE,
                                  args=(path,), timeout_s=POD_TIMEOUT_S) for n in POD_SHARDS}
        off_d = torch.as_tensor(offsets, device=POD_DEVICE)
        problem = pod_problem()
        k1.launches = 0
        k4.launches = 0
        pod_sync(POD_DEVICE)
        t0 = time.perf_counter()
        bank, tracker, var = problem.update_bank(
            torch.zeros(red.num_entities, red.local_dim, device=POD_DEVICE), red, off_d,
            with_variances=True)
        score = score_random_effect(bank, red)
        pod_sync(POD_DEVICE)
        rep_s = time.perf_counter() - t0
        ref = {"bank": bank, "var": var, "score": score}
        zeros = torch.zeros(red.num_entities, red.local_dim, dtype=torch.float64,
                            device=POD_DEVICE)
        ref["tight"] = pod_problem(POD_TIGHT_TOL).update_bank(zeros, red, off_d.double())[0]
        launches = {"replicated": k1.launches}
        k4_launches = {"replicated": k4.launches}
        say(f"phase 15 run P replicated ({smi}): update with variances and score {rep_s!r} s, "
            f"{red.num_entities} entities x D = {red.local_dim}, {len(red.buckets)} buckets, "
            f"iterations mean {tracker.iterations_mean!r} max {tracker.iterations_max}")
        drop_device_copies()
        k1.launches = 0
        k4.launches = 0
        one = pod_run(entity_mesh(1, device=POD_DEVICE), red, off_d)
        one["k1"] = k1.launches
        one["k4"] = k4.launches
        one["rank"] = 0
        results = {1: one.pop("arrays")}
        runs = {1: [one]}
        for n, fut in futures.items():
            try:
                runs[n] = fut.result()
            except (RuntimeError, TimeoutError) as e:
                fail(f"phase 15 run P, {n} ranks: {e}")
            results[n] = {name: torch.as_tensor(np.load(f"{path}-n{n}-{name}.npy"),
                                                device=POD_DEVICE)
                          for name in ("bank", "var", "score", "tight")}
    replicated_bytes = 2 * red.num_entities * red.local_dim * 4
    out = {}
    rep_tracker = tracker_key(tracker)
    for n, ranks in runs.items():
        r0 = ranks[0]
        launches[str(n)] = [r["k1"] for r in ranks]
        k4_launches[str(n)] = [r["k4"] for r in ranks]
        r0["errors"] = {name: scale_err(results[n][name], ref[name])
                        for name in ("bank", "var", "score")}
        bitwise = all(torch.equal(results[n][name], ref[name]) for name in ("bank", "var", "score"))
        upd = [r["update_s"][1] for r in ranks]
        tight = scale_err(results[n]["tight"], ref["tight"]) if n > 1 else None
        say(f"phase 15 run P N={n} ({smi}; {POD_LABEL}): update {r0['update_s']!r} s, score "
            f"{r0['score_s']!r} s, view build {r0['view_s']!r} s, "
            f"{red.num_entities / max(upd)!r} entities/s, host fetches per update "
            f"{[r['fetches'][1] for r in ranks]}, transport {r0['transport'][1]}; errors vs the "
            f"replicated path {r0['errors']} (limit {POD_RTOL}), bitwise {bitwise}; trackers "
            f"equal {r0['tracker'] == rep_tracker} ({r0['tracker']}); "
            f"float64 gradient max-abs over {GAME_RE_SAMPLE} sampled entities "
            f"{max(r['gradient'] for r in ranks)!r} (limit {GAME_RE_GRAD_LIMIT}); bytes a rank "
            f"{[r['bytes'] for r in ranks]} of the "
            f"replicated {replicated_bytes} (share {r0['share_bytes']}); repeat bitwise "
            f"{[r['repeat_bitwise'] for r in ranks]}; ranks' banks bitwise "
            f"{len({r['digest'] for r in ranks}) == 1}; K1 launches a rank {launches[str(n)]}, "
            f"K4 {k4_launches[str(n)]}"
            + (f"; float64 banks at tolerance {POD_TIGHT_TOL} {tight!r} of scale apart "
               f"(limit {POD_RTOL})" if n > 1 else ""))
        if not all(r["repeat_bitwise"] for r in ranks):
            fail(f"phase 15 run P N={n}: two updates are not bitwise")
        if len({r["digest"] for r in ranks}) != 1:
            fail(f"phase 15 run P N={n}: the ranks' gathered banks differ")
        if not all(r["finite"] for r in ranks) or max(r0["errors"].values()) > POD_RTOL:
            fail(f"phase 15 run P N={n}: off the replicated path: {r0['errors']}")
        if r0["tracker"] != rep_tracker:
            fail(f"phase 15 run P N={n}: the tracker {r0['tracker']} is not the replicated "
                 f"path's {rep_tracker}")
        if n == 1 and not bitwise:
            fail("phase 15 run P N=1: the single-shard pod is not bitwise the replicated path")
        if POD_DEVICE == "cuda" and not all(k4_launches[str(n)]):
            fail(f"phase 15 run P N={n}: a rank launched no K4: {k4_launches[str(n)]}")
        if not max(r["gradient"] for r in ranks) <= GAME_RE_GRAD_LIMIT:
            fail(f"phase 15 run P N={n}: a sampled entity's gradient is "
                 f"{max(r['gradient'] for r in ranks)!r}")
        if any(r["bytes"] > r["share_bytes"] for r in ranks) or \
                r0["share_bytes"] > -(-replicated_bytes // n) + 2 * red.local_dim * 4:
            fail(f"phase 15 run P N={n}: a rank holds more than its shard's share")
        if r0["tracker"][0] != red.num_entities:
            fail(f"phase 15 run P N={n}: the tracker counts {r0['tracker'][0]} entities")
        if tight is not None and not tight <= POD_RTOL:
            fail(f"phase 15 run P N={n}: the float64 solves at tolerance {POD_TIGHT_TOL} are "
                 f"{tight!r} of scale apart")
        out[n] = dict(update_s=upd, score_s=r0["score_s"], fetches=r0["fetches"][1],
                      bytes=r0["bytes"], errors=r0["errors"], bitwise=bitwise,
                      gradient=r0["gradient"], tight_bank_err=tight)
    out["replicated_s"] = rep_s
    K4_RESULTS["phase15_launches"] = k4_launches
    del ref, bank, var, score, off_d, red, results, zeros
    if POD_DEVICE == "cuda":
        torch.cuda.empty_cache()
    return out, launches


def pod_e_start(h_dir, shards, tmp):
    """Run E's two runs of run H's training driver as 2 processes each with
    ``--entity-shards 2``, started side by side; -> (processes, outputs)."""
    here = os.path.dirname(os.path.abspath(__file__))
    procs, outs = [], []
    for run in range(2):
        port, out = free_port(), f"{tmp}/pod-e2-{run}"
        outs.append(out)
        for rank in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", POD_E_CHILD,
                 *pod_e_argv(h_dir, shards, out), "--entity-shards", "2", *POD_DEVICE_ARGS,
                 "--coordinator-address", f"127.0.0.1:{port}", "--num-processes", "2",
                 "--process-id", str(rank)],
                cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
    return procs, outs


def pod_e_argv(h_dir, shards, out, output_mode="BEST"):
    """Run H's training argv over its kept files (no registry)."""
    return [
        "--train-input-dirs", f"{h_dir}/train", "--validate-input-dirs", f"{h_dir}/validate",
        "--output-dir", out, "--feature-shard-id-to-feature-section-keys-map", shards,
        "--fixed-effect-data-configurations", "global:globalShard,1",
        "--fixed-effect-optimization-configurations",
        "global:50,1e-7,10,1,LBFGS,L2;50,1e-7,1,1,LBFGS,L2",
        "--random-effect-data-configurations",
        "per-user:userId,userShard,1,none,none,none,INDEX_MAP",
        "--random-effect-optimization-configurations", "per-user:30,1e-5,1,1,LBFGS,L2",
        "--num-iterations", "2", "--evaluator-types", "AUC",
        "--compute-variance", "true", "--model-output-mode", output_mode,
    ]


def pod_e_scores(h_dir, shards, model_dir, out):
    """{uid: score} of ``model_dir`` over run H's validation files, through
    ``game_scoring_driver``."""
    from photon_ml_tpu_torch.cli import game_scoring_driver

    game_scoring_driver.main([
        "--input-data-dirs", f"{h_dir}/validate", "--game-model-input-dir", model_dir,
        "--output-dir", out, "--feature-shard-id-to-feature-section-keys-map", shards,
        *POD_DEVICE_ARGS,
    ])
    return pod_score_file(f"{out}/scores")


def pod_score_file(scores_dir):
    """{uid: predictionScore} of a scoring driver's score files."""
    from photon_ml_tpu_torch.io.avro_codec import read_avro_records

    out = {}
    for name in sorted(os.listdir(scores_dir)):
        if name.endswith(".avro"):
            for r in read_avro_records(f"{scores_dir}/{name}"):
                out[r["uid"]] = r["predictionScore"]
    return out


def same_files(a, b) -> bool:
    """Whether two directory trees hold the same files byte for byte."""
    names = sorted(os.path.relpath(os.path.join(root, f), a)
                   for root, _, files in os.walk(a) for f in files)
    other = sorted(os.path.relpath(os.path.join(root, f), b)
                   for root, _, files in os.walk(b) for f in files)
    if names != other:
        return False
    for n in names:
        with open(f"{a}/{n}", "rb") as fa, open(f"{b}/{n}", "rb") as fb:
            if fa.read() != fb.read():
                return False
    return True


def pod_run_e(h_dir, shards, h_history, k1, smi, tmp, procs, outs):
    """Run E: run H's files through the GAME training driver with
    ``--entity-shards 1`` in this process, while the two 2-process runs
    with ``--entity-shards 2`` go on; the models against run H's (the
    files, and the scores through ``game_scoring_driver``); -> K1's
    launches."""
    from photon_ml_tpu_torch.cli import game_training_driver

    k1.launches = 0
    t0 = time.perf_counter()
    driver = game_training_driver.main(
        pod_e_argv(h_dir, shards, f"{tmp}/pod-e1", "NONE")
        + ["--entity-shards", "1", *POD_DEVICE_ARGS])
    e1_s = time.perf_counter() - t0
    e1_k1 = k1.launches
    e2_k1 = []
    for p in procs:
        try:
            log, _ = p.communicate(timeout=POD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            fail("phase 15 run E: a driver process did not end")
        if p.returncode != 0:
            fail(f"phase 15 run E: a driver process ended with {p.returncode}: {log[-3000:]}")
        counts = [int(line[len(POD_E_MARK):]) for line in log.splitlines()
                  if line.startswith(POD_E_MARK)]
        if len(counts) != 1:
            fail(f"phase 15 run E: a driver process printed no K1 count: {log[-3000:]}")
        e2_k1.append(counts[0])
    hist = {"N=1": driver.best_result[0].objective_history}
    for i, o in enumerate(outs):
        with open(f"{o}/metrics.json") as f:
            hist[f"N=2 run {i}"] = json.load(f)["objective_history"]
    same = same_files(f"{outs[0]}/best-model", f"{outs[1]}/best-model")
    h_scores = pod_score_file(f"{h_dir}/scores/scores")
    got = pod_e_scores(h_dir, shards, f"{outs[0]}/best-model", f"{tmp}/pod-e-scores")
    if sorted(got) != sorted(h_scores):
        fail("phase 15 run E: the scores cover other rows than run H's")
    uids = sorted(h_scores)
    want = torch.tensor([h_scores[u] for u in uids], dtype=torch.float64)
    errs = {"N=2": scale_err(torch.tensor([got[u] for u in uids], dtype=torch.float64), want)}
    gaps = {label: max(abs(a - b) / abs(b) for a, b in zip(h, h_history))
            for label, h in hist.items()}
    say(f"phase 15 run E ({smi}; {POD_LABEL}): --entity-shards 1 in one process {e1_s!r} s "
        f"(timers {driver.timer.durations}), K1 launches {e1_k1}, in each process of the two "
        f"2-process runs {e2_k1}; objective histories {hist} against "
        f"run H's {h_history}: largest relative gaps {gaps} (N = 1 must be 0: run H's fit "
        f"itself); the two 2-process runs' model files bitwise {same}; the N = 2 "
        f"model's scores vs run H's, of their scale: {errs['N=2']!r} (limit {POD_E_RTOL})")
    if hist["N=2 run 0"] != hist["N=2 run 1"] or not same:
        fail("phase 15 run E: the two 2-process runs are not bitwise")
    if max(gaps.values()) > POD_E_RTOL or gaps["N=1"] != 0.0:
        fail("phase 15 run E: an objective history is off run H's")
    if errs["N=2"] > POD_E_RTOL:
        fail("phase 15 run E: a model's scores are off run H's")
    return dict(k1={"1": e1_k1, "2": e2_k1}, seconds=e1_s, gaps=gaps, score_errs=errs)


def pod_t_params(train_dir):
    """Run T's streamed training configuration, as its driver parses it."""
    from photon_ml_tpu_torch.cli import game_training_driver

    return game_training_driver.params_from_args([
        "--train-input-dirs", train_dir, "--output-dir", "unused",
        "--feature-shard-id-to-feature-section-keys-map",
        "globalShard:features|userShard:userFeatures",
        "--fixed-effect-data-configurations", "global:globalShard,1",
        "--fixed-effect-optimization-configurations", "global:50,1e-7,1,1,TRON,L2",
        "--random-effect-data-configurations",
        "per-user:userId,userShard,1,none,none,none,IDENTITY",
        "--random-effect-optimization-configurations", "per-user:30,1e-5,1,1,LBFGS,L2",
        "--num-iterations", "2", "--streaming", "true",
        "--stream-memory-budget", str(STREAM_T_BUDGET),
    ])


def pod_t_rank(mesh, train_dir, spill_root):
    """Run T's streamed GAME through ``train_streaming_game(entity_mesh=)``
    on this rank (its own spill directory); -> the objective history and a
    digest of the model's banks."""
    import hashlib

    from photon_ml_tpu_torch.cli.game_training_driver import expand_config_grid
    from photon_ml_tpu_torch.game.streaming import train_streaming_game
    from photon_ml_tpu_torch.ops.kernels import bilinear_pass as k1

    k1.launches = 0
    p = pod_t_params(train_dir)
    (combo,) = expand_config_grid({**p.fixed_effect_opt_configs, **p.random_effect_opt_configs})
    spill = f"{spill_root}/rank{mesh.rank}"
    os.makedirs(spill, exist_ok=True)
    t0 = time.perf_counter()
    result, _ = train_streaming_game(
        [train_dir], p.feature_shards, p.fixed_effect_data_configs,
        p.random_effect_data_configs, combo, p.task_type, num_iterations=p.num_iterations,
        memory_budget_bytes=p.stream_memory_budget, spill_dir=spill, entity_mesh=mesh,
    )
    seconds = time.perf_counter() - t0
    gm = result.game_model
    digest = hashlib.sha256(
        gm.get_model("per-user").bank.cpu().numpy().tobytes()
        + gm.get_model("global").model.means.cpu().numpy().tobytes()
    ).hexdigest()
    return dict(objective=result.objective_history, digest=digest, seconds=seconds,
                k1=k1.launches)


def pod_run_t(train_dir, futures, smi, tmp):
    """The streamed entity shards: two spawned 2-rank runs (bitwise, and
    within POD_E_RTOL of run T's streamed objective), and run T's driver
    with ``--streaming true --entity-shards 1`` in this process."""
    from photon_ml_tpu_torch.cli import game_training_driver
    from photon_ml_tpu_torch.ops.kernels import bilinear_pass as k1

    t_hist = POD_INPUTS["t_history"]
    k1.launches = 0
    t0 = time.perf_counter()
    argv = [
        "--train-input-dirs", train_dir, "--output-dir", f"{tmp}/pod-t1",
        "--feature-shard-id-to-feature-section-keys-map",
        "globalShard:features|userShard:userFeatures",
        "--fixed-effect-data-configurations", "global:globalShard,1",
        "--fixed-effect-optimization-configurations", "global:50,1e-7,1,1,TRON,L2",
        "--random-effect-data-configurations",
        "per-user:userId,userShard,1,none,none,none,IDENTITY",
        "--random-effect-optimization-configurations", "per-user:30,1e-5,1,1,LBFGS,L2",
        "--num-iterations", "2", "--streaming", "true",
        "--stream-memory-budget", str(STREAM_T_BUDGET), "--entity-shards", "1",
        "--model-output-mode", "NONE", *POD_DEVICE_ARGS,
    ]
    driver = game_training_driver.main(argv)
    one_s = time.perf_counter() - t0
    one_k1 = k1.launches
    one = driver.results[0][1].objective_history
    runs = []
    for fut in futures:
        try:
            runs.append(fut.result())
        except (RuntimeError, TimeoutError) as e:
            fail(f"phase 15 streamed entity shards: {e}")
    flat = [r for ranks in runs for r in ranks]
    gaps = {"N=1 driver": max(abs(a - b) / abs(b) for a, b in zip(one, t_hist)),
            "N=2": max(abs(a - b) / abs(b) for a, b in zip(flat[0]["objective"], t_hist))}
    say(f"phase 15 streamed entity shards ({smi}; {POD_LABEL}): 2 ranks {flat[0]['seconds']!r} s, "
        f"objective {flat[0]['objective']}, the two runs and every rank bitwise "
        f"{len({(str(r['objective']), r['digest']) for r in flat}) == 1}; the driver with "
        f"--streaming --entity-shards 1 {one_s!r} s, objective {one}; against run T's streamed "
        f"{t_hist}: largest relative gaps {gaps}; K1 launches in the driver {one_k1}, a rank "
        f"of the two 2-rank runs {[r['k1'] for r in flat]}")
    if len({(str(r["objective"]), r["digest"]) for r in flat}) != 1:
        fail("phase 15 streamed entity shards: the runs or ranks are not bitwise")
    if max(gaps.values()) > POD_E_RTOL:
        fail("phase 15 streamed entity shards: off run T's objective")
    return dict(gaps=gaps, seconds=flat[0]["seconds"], driver_s=one_s,
                k1={"driver": one_k1, "2": [r["k1"] for r in flat]})


def unified_data(seed, device):
    """Run U's rows (the JAX package's unified-mesh configuration)."""
    from photon_ml_tpu_torch.game import (
        EntityIndex,
        GameDataset,
        ProjectorType,
        RandomEffectDataConfiguration,
        ShardData,
        build_random_effect_dataset,
    )
    from photon_ml_tpu_torch.utils.index_map import IndexMap, feature_key

    rng = np.random.default_rng([seed, 15])
    n, E, d, k = UNIFIED_N, UNIFIED_E, UNIFIED_D, UNIFIED_K
    codes = rng.integers(0, E, size=n).astype(np.int32)
    ix = rng.integers(0, d, size=(n, k)).astype(np.int32)
    v = rng.normal(size=(n, k)).astype(np.float32)
    lab = (rng.uniform(size=n) > 0.5).astype(np.float32)
    off = (rng.normal(size=n) * 0.1).astype(np.float32)
    imap = IndexMap.build((feature_key(f"f{i}", "") for i in range(d)), add_intercept=False)
    ds = GameDataset(
        uids=[str(i) for i in range(n)], labels=lab, offsets=off, weights=np.ones(n, np.float32),
        shards={"s": ShardData(ix, v, imap, None)}, entity_codes={"user": codes},
        entity_indexes={"user": EntityIndex.build("user", [f"e{i:06d}" for i in range(E)])},
        num_real_rows=n, device=torch.device(device),
    )
    red = build_random_effect_dataset(ds, RandomEffectDataConfiguration(
        random_effect_type="user", feature_shard_id="s", projector_type=ProjectorType.IDENTITY))
    return ds, red


def unified_problems(lam=1.0):
    from photon_ml_tpu_torch.game import RandomEffectOptimizationProblem
    from photon_ml_tpu_torch.ops.losses import LOGISTIC
    from photon_ml_tpu_torch.optim.config import (
        OptimizerConfig,
        RegularizationContext,
        RegularizationType,
    )
    from photon_ml_tpu_torch.optim.problem import create_glm_problem
    from photon_ml_tpu_torch.task import TaskType

    fe = create_glm_problem(TaskType.LOGISTIC_REGRESSION, UNIFIED_D, config=OptimizerConfig(max_iter=5))
    re = RandomEffectOptimizationProblem(
        LOGISTIC, OptimizerConfig(max_iter=5), RegularizationContext(RegularizationType.L2),
        reg_weight=lam)
    return fe, re


def unified_rank(mesh, seed):
    """Run U on one of 4 ranks: run_game_grid over the configuration's
    λ-grid on the (grid 2, entity 2) mesh ``resolve_mesh`` lays over them,
    then over a grid with duplicate members, then the per-member pod CD on
    the same ranks (entity meshes of 2)."""
    from photon_ml_tpu_torch.game import CoordinateDescent, FixedEffectCoordinate
    from photon_ml_tpu_torch.game.coordinate import PodRandomEffectCoordinate
    from photon_ml_tpu_torch.game.unified import run_game_grid
    from photon_ml_tpu_torch.ops.kernels import bilinear_pass as k1
    from photon_ml_tpu_torch.parallel.mesh import entity_mesh
    from photon_ml_tpu_torch.parallel.unified_mesh import resolve_mesh
    from photon_ml_tpu_torch.task import TaskType

    k1.launches = 0
    ds, red = unified_data(seed, mesh.device)
    out = {}
    for label, lams in (("grid", UNIFIED_LAMBDAS), ("duplicates", UNIFIED_DUPLICATES)):
        plan = resolve_mesh(grid_size=len(lams), entity_shards=2, device=mesh.device)
        fe, re = unified_problems()
        pod_sync(mesh.device)
        t0 = time.perf_counter()
        res = run_game_grid(plan, ds, red, fe, re, lams, feature_shard_id="s",
                            fe_reg_weight=0.1, num_iterations=UNIFIED_ITERS)
        pod_sync(mesh.device)
        out[label] = dict(
            seconds=time.perf_counter() - t0, objective=res.objective_history,
            readbacks=res.readbacks, bytes=res.re_bank.per_device_bytes(),
            re=[res.re_bank.member_global(g) for g in range(len(lams))],
            fe=res.fe_banks[: len(lams)],
        )
    pod_mesh = entity_mesh(2, device=mesh.device)
    seq = []
    t0 = time.perf_counter()
    for lam in UNIFIED_LAMBDAS:
        fe, re = unified_problems(lam)
        coords = {
            "fixed": FixedEffectCoordinate(name="fixed", dataset=ds, problem=fe,
                                           feature_shard_id="s", reg_weight=0.1),
            "per-user": PodRandomEffectCoordinate(name="per-user", dataset=ds, re_dataset=red,
                                                  problem=re, mesh=pod_mesh),
        }
        r = CoordinateDescent(coords, ds, TaskType.LOGISTIC_REGRESSION).run(UNIFIED_ITERS)
        seq.append(dict(objective=r.objective_history, re=r.model.get_model("per-user").bank,
                        fe=r.model.get_model("fixed").model.means))
    pod_sync(mesh.device)
    seq_s = time.perf_counter() - t0
    grid = out["grid"]
    errs = [dict(
        objective=max(abs(grid["objective"][it][g] - seq[g]["objective"][it])
                      / abs(seq[g]["objective"][it]) for it in range(UNIFIED_ITERS)),
        re=scale_err(grid["re"][g], seq[g]["re"]), fe=scale_err(grid["fe"][g], seq[g]["fe"]),
    ) for g in range(len(UNIFIED_LAMBDAS))]
    dup = out["duplicates"]
    return dict(
        rank=mesh.rank, grid_s=grid["seconds"], dup_s=dup["seconds"], seq_s=seq_s,
        objective=grid["objective"], readbacks=(grid["readbacks"], dup["readbacks"]),
        bytes=grid["bytes"], errors=errs,
        duplicates_bitwise=bool(torch.equal(dup["re"][0], dup["re"][1])
                                and torch.equal(dup["re"][2], dup["re"][3])
                                and torch.equal(dup["fe"][0], dup["fe"][1])
                                and torch.equal(dup["fe"][2], dup["fe"][3])),
        digest=str([float(x.sum()) for x in grid["re"]] + [float(x.sum()) for x in grid["fe"]]),
        finite=all(bool(torch.isfinite(x).all()) for x in grid["re"] + list(grid["fe"])),
        k1=k1.launches,
    )


def pod_run_u(future, smi):
    """Run U's results: run_game_grid against the per-member pod CD,
    duplicate members bitwise, one readback a CD iteration."""
    from photon_ml_tpu_torch.game.pod import EntityShardSpec

    try:
        ranks = future.result()
    except (RuntimeError, TimeoutError) as e:
        fail(f"phase 15 run U: {e}")
    r0 = ranks[0]
    worst = {k: max(e[k] for e in r0["errors"]) for k in ("objective", "re", "fe")}
    share = 2 * EntityShardSpec(2, UNIFIED_E).rows_per_shard * UNIFIED_D * 4
    say(f"phase 15 run U ({smi}; {POD_LABEL}): run_game_grid on a (grid 2, entity 2) mesh of 4 "
        f"ranks, n = {UNIFIED_N}, E = {UNIFIED_E}, d = {UNIFIED_D}, k = {UNIFIED_K}, lambda "
        f"{UNIFIED_LAMBDAS}, {UNIFIED_ITERS} iterations: {r0['grid_s']!r} s (duplicates grid "
        f"{r0['dup_s']!r} s) against the per-member pod CD's {r0['seq_s']!r} s; objectives "
        f"{r0['objective']}; largest gaps to the per-member pod CD {worst}; readbacks "
        f"{r0['readbacks']}; duplicate members bitwise {[r['duplicates_bitwise'] for r in ranks]}; "
        f"RE bank bytes a rank {[r['bytes'] for r in ranks]} (2 members' share {share}); K1 "
        f"launches a rank {[r['k1'] for r in ranks]}")
    if not all(r["finite"] for r in ranks) or len({r["digest"] for r in ranks}) != 1:
        fail("phase 15 run U: non-finite results, or the ranks disagree")
    if worst["objective"] > UNIFIED_OBJ_RTOL or max(worst["re"], worst["fe"]) > UNIFIED_ROW_RTOL:
        fail("phase 15 run U: off the per-member pod CD")
    if not all(r["duplicates_bitwise"] for r in ranks):
        fail("phase 15 run U: duplicate-lambda members are not bitwise identical")
    if any(r["readbacks"] != (UNIFIED_ITERS, UNIFIED_ITERS) for r in ranks):
        fail("phase 15 run U: not one readback a CD iteration")
    if any(r["bytes"] != share for r in ranks):
        fail("phase 15 run U: a rank's bank block is not its share")
    return dict(grid_s=r0["grid_s"], seq_s=r0["seq_s"], errors=worst,
                k1=[r["k1"] for r in ranks])


def pod_phase(seed, smi, k1, h_dir, shards, h_history):
    """Phase 15 over run G's inputs, run H's files and run T's: runs P, E,
    the streamed entity shards and U, the spawns side by side; -> K1's
    launches in each run (in process, a spawned rank, a driver process)
    and the runs' numbers."""
    from photon_ml_tpu_torch.parallel.mesh import ENTITY_AXIS, GRID_AXIS, spawn_mesh

    out = {}
    with tempfile.TemporaryDirectory(prefix="photon_pod_phase_") as tmp:
        t0 = time.perf_counter()
        e_procs, e_outs = pod_e_start(h_dir, shards, tmp)
        t_dir = POD_INPUTS.pop("t_train")
        try:
            with ThreadPoolExecutor(3) as pool:
                u_future = pool.submit(spawn_mesh, unified_rank, (2, 2), (GRID_AXIS, ENTITY_AXIS),
                                       device=POD_DEVICE, args=(seed,), timeout_s=POD_TIMEOUT_S)
                t_futures = [pool.submit(spawn_mesh, pod_t_rank, (2,), (ENTITY_AXIS,),
                                         device=POD_DEVICE, args=(t_dir, f"{tmp}/t-spill-{i}"),
                                         timeout_s=POD_TIMEOUT_S) for i in range(2)]
                out["P"], p_k1 = pod_run_p(seed, smi, tmp)
                out["E"] = pod_run_e(h_dir, shards, h_history, k1, smi, tmp, e_procs, e_outs)
                out["T"] = pod_run_t(t_dir, t_futures, smi, tmp)
                out["U"] = pod_run_u(u_future, smi)
        finally:
            for p in e_procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            shutil.rmtree(os.path.dirname(t_dir), ignore_errors=True)
        out["seconds"] = time.perf_counter() - t0
    say(f"phase 15: {out['seconds']!r} s of host time ({smi})")
    launches = {"P": p_k1, "E": out["E"].pop("k1"), "T": out["T"].pop("k1"), "U": out["U"].pop("k1")}
    say(f"phase 15 K1 launches (each run's counter at 0 just before it, read just after; "
        f"spawned ranks and driver processes count their own): {json.dumps(launches)}")
    return launches, out


# -- phase 11: online serving ---------------------------------------------------
#
# Run V: the JAX package's on-chip serving configuration (bench.py:1971-1976
# _serving_config): a [2^20] fixed effect with 64 features a request and a
# 600,000-user random effect of 1,000 features with 32 a request, both from
# bank_from_arrays, ladder (1, 8, 64, 256), requests with raw entity ids;
# 2,000 requests closed-loop and 20,000 open-loop at concurrency 32
SERVE_FE_DIM, SERVE_FE_K = 1 << 20, 64
SERVE_USERS, SERVE_RE_DIM, SERVE_RE_K = 600_000, 1000, 32
SERVE_LADDER = (1, 8, 64, 256)
SERVE_CLOSED, SERVE_OPEN, SERVE_CONCURRENCY = 2_000, 20_000, 32
SERVE_PROFILED = 4_000  # a separate open loop under torch.profiler
SERVE_SAMPLE = 4_096  # served scores held bitwise against the batch algebra
SERVE_SWAP = 8_000  # the open loop a donated swap lands in the middle of
# Run W: the serving driver over run H's files; the front end over a few
# hundred of run H's validation rows on 4 connections
SERVE_W_CONCURRENCY = 8
# the open run's trace: run H's 8,192 validation rows 4 times (its 16,384
# twice until run H was cut), the swap after the first 4,096. A swap
# stages in ~3.4 s (the model load through the native decoder, an H100
# host) while ~5,300 requests a second are served: the 28,672 after the
# swap point take ~5 s, so generation 2 serves some
SERVE_W_OPEN_REPEATS = 4
SERVE_FRONTEND_REQUESTS, SERVE_FRONTEND_CONNECTIONS = 400, 4
SERVE_FRONTEND_TIMEOUT_S = 300


def serve_requests(rng, n):
    """``n`` requests of run V's shape: random feature ids and values and a
    raw user id each, as production traffic (the dispatch loop pays the
    id -> row resolve)."""
    from photon_ml_tpu_torch.serving import ScoreRequest

    gi = rng.integers(0, SERVE_FE_DIM, size=(n, SERVE_FE_K)).astype(np.int32)
    gv = rng.standard_normal((n, SERVE_FE_K), dtype=np.float32)
    ui = rng.integers(0, SERVE_RE_DIM, size=(n, SERVE_RE_K)).astype(np.int32)
    uv = rng.standard_normal((n, SERVE_RE_K), dtype=np.float32)
    users = rng.integers(0, SERVE_USERS, size=n)
    return [
        ScoreRequest(
            uid=str(i), indices={"g": gi[i], "u": ui[i]},
            values={"g": gv[i], "u": uv[i]},
            entity_ids={"userId": f"user{int(users[i])}"},
        )
        for i in range(n)
    ]


def serve_batch_algebra(bank, reqs):
    """The port's batch scorer's algebra (``LoadedGameModel.score``: the
    row functions of ``data.batch`` over one batch of n rows, coordinate
    after coordinate, then the offsets) over ``reqs``; -> float32 [n] on
    the host."""
    from photon_ml_tpu_torch.data.batch import fe_row_scores, re_row_scores

    dev = bank.device
    col = lambda key, f: torch.as_tensor(np.stack([getattr(r, f)[key] for r in reqs]), device=dev)
    codes = torch.as_tensor(
        bank.entity_rows["userId"].rows_of([r.entity_ids["userId"] for r in reqs]), device=dev
    )
    offsets = torch.as_tensor(np.asarray([r.offset for r in reqs], np.float32), device=dev)
    total = torch.zeros(len(reqs), device=dev)
    total = total + fe_row_scores(bank.arrays["global"], col("g", "indices"), col("g", "values"))
    total = total + re_row_scores(
        bank.arrays["per-user"], codes, col("u", "indices"), col("u", "values"))
    return (total + offsets).cpu().numpy()


def route_flood(score, records, threads, *, at=None, then=None):
    """``records`` through ``score`` from ``threads`` closed-loop
    submitters; ``then()`` runs once when ``at`` requests completed.
    -> (outcome or exception per record, wall s, process CPU s)."""
    import threading

    out = [None] * len(records)
    it = iter(range(len(records)))
    lock = threading.Lock()
    done = [0]
    fired = threading.Lock()

    def worker():
        while True:
            with lock:
                i = next(it, None)
            if i is None:
                return
            try:
                out[i] = score(records[i])
            except Exception as e:  # noqa: BLE001 - a named refusal is an outcome
                out[i] = e
            with lock:
                done[0] += 1
                hit = at is not None and done[0] >= at
            if hit and fired.acquire(blocking=False):
                then()

    ts = [threading.Thread(target=worker) for _ in range(threads)]
    t0, c0 = time.perf_counter(), time.process_time()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return out, time.perf_counter() - t0, time.process_time() - c0


def serve_loop(batcher, reqs, concurrency, *, on_half=None):
    """Closed-loop submitters over one shared iterator (one thread: the
    closed loop); ``on_half`` runs once when half the requests completed.
    -> (outcomes in request order, wall seconds)."""
    out, wall, _ = route_flood(batcher.score, reqs, concurrency,
                               at=len(reqs) // 2 if on_half else None, then=on_half)
    errors = [o for o in out if isinstance(o, BaseException)]
    if errors:
        fail(f"serving loop: {len(errors)} request(s) failed: {errors[0]!r}")
    return out, wall


def serve_snapshot(label, snap, wall, smi, readbacks):
    qps = snap["requests"] / wall
    say(f"serving run V {label} ({smi}): {snap['requests']} requests in {wall!r} s, "
        f"QPS {qps!r}; latency p50 {snap['latency_p50_ms']!r} ms, p99 "
        f"{snap['latency_p99_ms']!r} ms, mean {snap['latency_mean_ms']!r} ms, max "
        f"{snap['latency_max_ms']!r} ms; dispatches {snap['dispatches']}, readbacks {readbacks}, "
        f"shape counts {snap['shape_counts']}, occupancy {snap['batch_occupancy_mean']!r}, "
        f"pad waste {snap['pad_waste_frac']!r}, dispatch s mean {snap['device_s_mean']!r}, "
        f"queue wait s mean {snap['queue_wait_s_mean']!r}")
    if readbacks != snap["dispatches"]:
        fail(f"serving run V {label}: {readbacks} readbacks for {snap['dispatches']} dispatches")
    return dict(p50_ms=snap["latency_p50_ms"], p99_ms=snap["latency_p99_ms"],
                mean_ms=snap["latency_mean_ms"], qps=qps, dispatches=snap["dispatches"],
                shape_counts=snap["shape_counts"], occupancy=snap["batch_occupancy_mean"],
                pad_waste=snap["pad_waste_frac"])


def serve_host_costs(bank, programs, reqs, smi):
    """The request path's host costs per dispatch, apart from the device:
    the id -> row lookup (one ctypes call into the native store), the
    padded numpy batch, and one dispatch end to end (pinned copies,
    replay, readback); and each rung's replay on the card alone."""
    from photon_ml_tpu_torch.parallel import overlap
    from photon_ml_tpu_torch.serving import MicroBatcher
    from photon_ml_tpu_torch.tools.device_timing import device_ms

    index = bank.entity_rows["userId"]
    batcher = MicroBatcher(lambda: bank, programs)
    out = {}
    try:
        for B in SERVE_LADDER:
            take = reqs[:B]
            ids = [r.entity_ids["userId"] for r in take]
            reps = 200
            t0 = time.perf_counter()
            for _ in range(reps):
                index.rows_of(ids)
            lookup_us = (time.perf_counter() - t0) / reps * 1e6
            t0 = time.perf_counter()
            for _ in range(reps):
                batch, _ = batcher._assemble(take, bank, B)
            assemble_us = (time.perf_counter() - t0) / reps * 1e6
            t0 = time.perf_counter()
            for _ in range(reps):
                overlap.device_get(programs.score(bank, batch))
            dispatch_us = (time.perf_counter() - t0) / reps * 1e6
            prog = programs.executable(bank.spec, B, arrays=bank.arrays)
            replay_ms = device_ms(prog.graph.replay) if bank.device.type == "cuda" else None
            out[B] = dict(lookup_us=lookup_us, assemble_us=assemble_us,
                          dispatch_us=dispatch_us, replay_ms=replay_ms)
            say(f"serving run V shape {B} ({smi}): id lookup {lookup_us!r} us, batch "
                f"assembly {assemble_us!r} us, copies + replay + readback {dispatch_us!r} us "
                f"a dispatch (host clock); the graph's replay {replay_ms!r} ms on the card")
    finally:
        batcher.close()
    return out


def serve_run_v(seed, smi, device="cuda"):
    """Run V: the device bank at the JAX package's on-chip serving widths,
    the CUDA-graph ladder, closed and open loops, a profiled open loop, the
    bitwise check against the batch algebra, and a donated swap in the
    middle of an open loop; -> its numbers."""
    from torch.profiler import ProfilerActivity, profile

    from photon_ml_tpu_torch.parallel import overlap
    from photon_ml_tpu_torch.serving import (
        MicroBatcher,
        ServingMetrics,
        ServingModel,
        ServingPrograms,
        bank_from_arrays,
    )

    rng = np.random.default_rng([seed, 11])
    ids = [f"user{i}" for i in range(SERVE_USERS)]

    def generation_arrays():
        w = rng.standard_normal(SERVE_FE_DIM, dtype=np.float32)
        w *= 0.1
        b = rng.standard_normal((SERVE_USERS, SERVE_RE_DIM), dtype=np.float32)
        b *= 0.1
        return w, b

    def make_bank(w, b, device):
        return bank_from_arrays(
            fixed=[("global", "g", w)], random=[("per-user", "userId", "u", b, ids)],
            shard_widths={"g": SERVE_FE_K, "u": SERVE_RE_K}, device=device,
        )

    w1, b1 = generation_arrays()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bank = make_bank(w1, b1, device)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    del w1, b1
    spec = bank.spec
    index = bank.entity_rows["userId"]
    say(f"serving run V bank ({smi}): spec {spec}; {bank.device_bytes()} bytes on the card, "
        f"staged in {stage_s!r} s; entity index {index.backend} over {index.num_entities} ids")
    if index.backend != "native" or spec[1][4] != -(-SERVE_USERS // 256) * 256:
        fail(f"serving run V: entity index {index.backend}, E_pad {spec[1][4]}")
    programs = ServingPrograms(SERVE_LADDER)
    t0 = time.perf_counter()
    captured = programs.ensure_compiled(bank)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    say(f"serving run V warmup ({smi}): {captured} CUDA graphs captured in {warmup_s!r} s; "
        f"programs {programs.stats()}")
    if captured != len(SERVE_LADDER) or programs.stats()["compile_count"] != len(SERVE_LADDER):
        fail(f"serving run V: {captured} captures for a ladder of {len(SERVE_LADDER)}")

    result = dict(stage_s=stage_s, warmup_s=warmup_s, captures=captured,
                  bank_bytes=bank.device_bytes())
    # closed loop: one request in flight, every dispatch shape 1
    reqs = serve_requests(rng, SERVE_CLOSED)
    metrics = ServingMetrics()
    overlap.reset_readback_stats()
    with MicroBatcher(lambda: bank, programs, metrics) as batcher:
        _, wall = serve_loop(batcher, reqs, 1)
    result["closed"] = serve_snapshot("closed loop", metrics.snapshot(), wall, smi,
                                      overlap.readback_stats())
    if result["closed"]["shape_counts"] != {"1": SERVE_CLOSED}:
        fail(f"serving run V closed loop: shapes {result['closed']['shape_counts']}")
    # open loop: concurrent closed-loop submitters, continuous batching
    reqs = serve_requests(rng, SERVE_OPEN)
    metrics = ServingMetrics()
    overlap.reset_readback_stats()
    with MicroBatcher(lambda: bank, programs, metrics) as batcher:
        outs, wall = serve_loop(batcher, reqs, SERVE_CONCURRENCY)
    result["open"] = serve_snapshot("open loop", metrics.snapshot(), wall, smi,
                                    overlap.readback_stats())
    sample = reqs[:SERVE_SAMPLE]
    served = np.asarray(outs[:SERVE_SAMPLE], np.float32)
    algebra = serve_batch_algebra(bank, sample)
    n_diff = int((served != algebra).sum())
    say(f"serving run V bitwise: {SERVE_SAMPLE} served scores of the open loop against the "
        f"batch algebra at n = {SERVE_SAMPLE}: {n_diff} differ; max abs diff "
        f"{float(np.abs(served - algebra).max())!r}; finite {bool(np.isfinite(served).all())}")
    if n_diff or not np.isfinite(served).all():
        fail("serving run V: served scores differ from the batch algebra")
    result["host_costs"] = serve_host_costs(bank, programs, reqs, smi)
    # the open loop under the profiler: the card's busy time and idle share
    reqs = serve_requests(rng, SERVE_PROFILED)
    with MicroBatcher(lambda: bank, programs) as batcher:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, wall = serve_loop(batcher, reqs, SERVE_CONCURRENCY)
            torch.cuda.synchronize()
    events = sorted((e for e in prof.key_averages() if e.device_type.name == "CUDA"),
                    key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in events) / 1e6
    result["profile"] = dict(requests=SERVE_PROFILED, host_s=wall, busy_s=busy,
                             idle_share=1 - busy / wall)
    say(f"serving run V profiled open loop ({smi}): {SERVE_PROFILED} requests in {wall!r} s "
        f"host, {busy!r} s device busy, idle share {1 - busy / wall!r}; top: " + "; ".join(
            f"{e.self_device_time_total / 1e3:.3f} ms in {e.count} x {e.key[:60]}"
            for e in events[:5]))
    if busy <= 0:
        fail("serving run V: the profiler saw no device time")
    # generation 2 from the seed, same spec: a donated swap mid open loop
    w2, b2 = generation_arrays()
    staged = make_bank(w2, b2, False)
    sm = ServingModel(bank, programs)
    reqs = serve_requests(rng, SERVE_SWAP)
    ref1 = serve_batch_algebra(bank, reqs)
    swap = {}

    def flip():
        t0 = time.perf_counter()
        swap["result"] = sm.swap_to_bank(staged)
        swap["s"] = time.perf_counter() - t0

    metrics = ServingMetrics()
    with MicroBatcher(sm.current, sm.programs, metrics) as batcher:
        outs, wall = serve_loop(batcher, reqs, SERVE_CONCURRENCY, on_half=flip)
    res = swap["result"]
    ref2 = serve_batch_algebra(sm.current(), reqs)
    gens = np.asarray([o.generation for o in outs])
    got = np.asarray(outs, np.float32)
    want = np.where(gens == 1, ref1, ref2)
    moved = torch.equal(sm.current().arrays["per-user"][:SERVE_USERS],
                        torch.as_tensor(b2, device=device)) and torch.equal(
        sm.current().arrays["global"], torch.as_tensor(w2, device=device))
    captures_after = programs.stats()["compile_count"] - len(SERVE_LADDER)
    result["swap"] = dict(donated=res.donated, recompiled=res.recompiled_programs,
                          flip_s=swap["s"], gen1=int((gens == 1).sum()), gen2=int((gens == 2).sum()),
                          lost=len(reqs) - len(outs) + sum(o is None for o in outs))
    say(f"serving run V donated swap ({smi}): {res}; flip {swap['s']!r} s under traffic; "
        f"{result['swap']['gen1']} requests served by generation 1 and {result['swap']['gen2']} "
        f"by generation 2, none lost; the bank bitwise generation 2's: {moved}; scores that "
        f"differ from their generation's batch algebra: {int((got != want).sum())}; "
        f"captures after warmup {captures_after}; dispatches {metrics.snapshot()['dispatches']}")
    if not (res.ok and res.donated and res.recompiled_programs == 0 and moved):
        fail(f"serving run V: the swap was not an in-place refresh without captures: {res}")
    if result["swap"]["gen2"] == 0 or (got != want).any() or result["swap"]["lost"]:
        fail("serving run V: scores after the flip are not generation 2's, or a request was lost")
    if captures_after or programs.stats()["cold_dispatch_compiles"]:
        fail(f"serving run V: {captures_after} captures after warmup")
    result["captures_after_warmup"] = captures_after
    result["peak_bytes"] = torch.cuda.max_memory_allocated()
    say(f"serving run V device memory peak {result['peak_bytes']} bytes ({smi})")
    del sm, staged, bank, programs
    torch.cuda.empty_cache()
    return result


def serve_run_w(tmp, shards, smi, device_args=(), device="cuda"):
    """Run W, inside run H's directory: ``serving_driver.main`` closed over
    the first validation part (written scores and AUC against run H's
    ``game_scoring_driver`` on those rows), open at concurrency 8 over all
    validation rows with a hot swap to the same model, then the front end
    in a subprocess over run H's validation rows on 4 connections and a
    SIGTERM drain."""
    from photon_ml_tpu_torch.cli import serving_driver
    from photon_ml_tpu_torch.evaluation.evaluator import Evaluator, EvaluatorType
    from photon_ml_tpu_torch.io.avro_codec import read_avro_records

    batch = {r["uid"]: r for r in read_avro_records(f"{tmp}/scores/scores")}
    part0 = f"{tmp}/validate/part-00000.avro"
    closed_uids = [r["uid"] for r in read_avro_records(part0)]

    def batch_auc(uids):
        """Run H's scores of ``uids`` through the evaluator the serving
        driver uses, in the same order on the same device."""
        col = lambda k: torch.as_tensor(  # noqa: E731
            np.asarray([batch[u][k] for u in uids], np.float32), device=device)
        return float(Evaluator(EvaluatorType.parse("AUC")).evaluate(
            col("predictionScore"), col("label"), col("weight")))

    base = [
        "--game-model-input-dir", f"{tmp}/out/best-model",
        "--request-paths", f"{tmp}/validate",
        "--feature-shard-id-to-feature-section-keys-map", shards,
    ]
    # the open run replays the validation rows SERVE_W_OPEN_REPEATS times
    # and swaps after half of them once, so the requests after the swap
    # point outlast the swap's model load and staging and both generations
    # serve
    trace = ",".join([f"{tmp}/validate"] * SERVE_W_OPEN_REPEATS)
    out = {}

    def run(label, extra, want):
        t0 = time.perf_counter()
        driver = serving_driver.main(
            base + ["--output-dir", f"{tmp}/serve-{label}", *extra, *device_args])
        seconds = time.perf_counter() - t0
        with open(f"{tmp}/serve-{label}/metrics.json") as f:
            m = json.load(f)
        served = {r["uid"]: r for r in read_avro_records(f"{tmp}/serve-{label}/scores")}
        differ = [u for u in served if served[u] != batch.get(u)]
        timers = " ".join(f"{k}={v!r}" for k, v in driver.timer.durations.items())
        s = m["serving"]
        say(f"serving run W {label} ({smi}): {seconds!r} s; stage timers s: {timers}; "
            f"{s['requests']} requests, QPS {s['qps']!r}, p50 {s.get('latency_p50_ms')!r} ms, "
            f"p99 {s.get('latency_p99_ms')!r} ms, dispatches {s['dispatches']}, readbacks "
            f"{m['readbacks']}, shapes {s['shape_counts']}, programs {m['programs']}, swaps "
            f"{m['swap_history']}; {len(served)} score records, {len(differ)} differ from run "
            f"H's scoring driver; AUC {m.get('AUC')!r} against "
            f"{batch_auc(list(served)) if label == 'closed' else None!r}")
        if differ or len(served) != want:
            fail(f"serving run W {label}: written scores are not run H's ({len(differ)} differ)")
        if m["readbacks"] != s["dispatches"] or m["programs"]["cold_dispatch_compiles"]:
            fail(f"serving run W {label}: readbacks or captures off the contract")
        if label == "closed" and m["AUC"] != batch_auc(list(served)):
            fail("serving run W closed: the AUC is not run H's on its rows")
        if label == "open":
            swaps = m["swap_history"]
            if not (len(swaps) == 1 and swaps[0]["ok"] and swaps[0]["donated"]
                    and swaps[0]["recompiled_programs"] == 0
                    and set(s["generation_dispatches"]) == {"1", "2"}):
                fail(f"serving run W open: the hot swap did not land: {swaps}")
        out[label] = dict(seconds=seconds, qps=s["qps"], p50_ms=s.get("latency_p50_ms"),
                          p99_ms=s.get("latency_p99_ms"), dispatches=s["dispatches"],
                          timers=dict(driver.timer.durations))
        return driver.serving_model.current().shard_widths

    # closed: the first validation part (2,048 rows; all of them until
    # phase 12 needed the time)
    widths = run("closed", ["--mode", "closed", "--write-scores", "true",
                            "--evaluator-types", "AUC", "--request-paths", part0],
                 len(closed_uids))
    # the front end's process starts (loads the model, stages its bank)
    # while the open run serves, for the script's time limit
    out["frontend"] = serve_frontend(
        tmp, shards, batch, widths, smi, device_args,
        during=lambda: run("open", [
            "--mode", "open", "--concurrency", str(SERVE_W_CONCURRENCY),
            "--request-paths", trace, "--swap-model-dir", f"{tmp}/out/best-model",
            "--swap-after-requests", str(len(batch) // 2)], len(batch)),
    )
    out["widths"] = widths
    return out


def serve_frontend(tmp, shards, batch, widths, smi, device_args=(), during=None):
    """``python -m photon_ml_tpu_torch.cli.serving_driver --frontend-port 0``
    in a subprocess over prebuilt name-term lists of the rows it is sent
    (``during()`` runs while it starts); 4 connections each send their
    rows as JSON lines, then a status op; SIGTERM drains. Every request
    must resolve to a named outcome, the ok scores bitwise run H's."""
    import socket
    import threading

    from photon_ml_tpu_torch.io.avro_codec import read_avro_records
    from photon_ml_tpu_torch.io.name_term_list import generate_name_and_term_lists

    records = []
    for r in read_avro_records(f"{tmp}/validate/part-00000.avro"):
        records.append(r)
        if len(records) == SERVE_FRONTEND_REQUESTS:
            break
    generate_name_and_term_lists(f"{tmp}/validate/part-00000.avro", ["features", "userFeatures"],
                                 f"{tmp}/name-terms")
    out_dir = f"{tmp}/serve-frontend"
    cmd = [
        sys.executable, "-m", "photon_ml_tpu_torch.cli.serving_driver",
        "--game-model-input-dir", f"{tmp}/out/best-model", "--output-dir", out_dir,
        "--feature-shard-id-to-feature-section-keys-map", shards,
        "--feature-name-and-term-set-path", f"{tmp}/name-terms",
        "--request-nnz-width", "|".join(f"{k}:{v}" for k, v in widths.items()),
        "--frontend-port", "0", "--drain-timeout", "30", *device_args,
    ]
    t0, t0_wall = time.perf_counter(), time.time()
    log_path = f"{tmp}/serve-frontend.log"
    with open(log_path, "w") as log_file:
        proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                                stdout=log_file, stderr=subprocess.STDOUT)

    def log():
        with open(log_path) as f:
            return f.read()[-3000:]

    try:
        if during is not None:
            during()
        while not os.path.isfile(f"{out_dir}/frontend.json"):
            if proc.poll() is not None or time.perf_counter() - t0 > SERVE_FRONTEND_TIMEOUT_S:
                fail(f"serving front end did not start: {log()}")
            time.sleep(0.2)
        start_s = os.path.getmtime(f"{out_dir}/frontend.json") - t0_wall
        with open(f"{out_dir}/frontend.json") as f:
            port = json.load(f)["port"]
        responses, errors = [], []

        def client(rows):
            try:
                with socket.create_connection(("127.0.0.1", port), timeout=60) as sock:
                    sock.sendall("".join(json.dumps(r) + "\n" for r in rows).encode())
                    sock.sendall(b'{"op": "status"}\n')
                    reader = sock.makefile("rb")
                    got = [json.loads(reader.readline()) for _ in range(len(rows) + 1)]
                responses.extend(got)
            except (OSError, ValueError) as e:
                errors.append(e)

        t1 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(records[c::SERVE_FRONTEND_CONNECTIONS],))
                   for c in range(SERVE_FRONTEND_CONNECTIONS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=SERVE_FRONTEND_TIMEOUT_S)
        serve_s = time.perf_counter() - t1
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=SERVE_FRONTEND_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    status = [r for r in responses if "uid" not in r]
    scored = [r for r in responses if "uid" in r]
    outcomes = {}
    for r in scored:
        outcomes[r["status"]] = outcomes.get(r["status"], 0) + 1
    differ = [r["uid"] for r in scored if r["status"] == "ok"
              and np.float32(r["score"]) != np.float32(batch[r["uid"]]["predictionScore"])]
    with open(f"{out_dir}/metrics.json") as f:
        m = json.load(f)
    say(f"serving front end ({smi}): started in {start_s!r} s; {len(scored)} responses to "
        f"{len(records)} requests on {SERVE_FRONTEND_CONNECTIONS} connections in {serve_s!r} s, "
        f"outcomes {outcomes}, {len(differ)} scores differ from run H's; status "
        f"ready={[s.get('ready') for s in status]} alive={[s.get('alive') for s in status]}; "
        f"SIGTERM exit {proc.returncode}, drain {m.get('drain')}, interrupted "
        f"{m.get('interrupted')}, leaked connections {m.get('leaked_connections')}, "
        f"dispatches {m['serving']['dispatches']}, readbacks {m['readbacks']}")
    if errors or len(scored) != len(records) or outcomes != {"ok": len(records)} or differ:
        fail(f"serving front end: errors {errors[:1]}, outcomes {outcomes}, {len(differ)} "
             f"scores differ; log: {log()}")
    if proc.returncode != 0 or not m.get("interrupted") or m.get("leaked_connections"):
        fail(f"serving front end: the SIGTERM drain failed: exit {proc.returncode}; {log()}")
    if not all(s.get("ready") and s.get("alive") for s in status):
        fail(f"serving front end: status ops {status}")
    return dict(start_s=start_s, serve_s=serve_s, requests=len(records), outcomes=outcomes)


# -- phase 12: the serving fleet ----------------------------------------------
#
# Run X: the JAX package's chip-class routing shapes (bench.py:2328-2340):
# 200,000 users x 256, a 2^18 fixed effect, 32 and 16 features a request,
# the shard ladder (1, 8, 64); fleets of N in {1, 2, 4} shard-server child
# processes (this script under ROUTE_CHILD_FLAG), each holding 1/N of the
# random-effect bank; per N an open-loop flood of 4,000 requests (8,000
# until the script reached 867.9 s) from 32
# threads over a zipf(1.3) entity draw with 4 payloads an entity; at N = 4
# a fleet-wide two-step swap under a flood of 2,000 and then a flood of
# 2,000 cache-missing payloads during which one child is SIGKILLed
ROUTE_SHAPES = {"E": 200_000, "d_g": 1 << 18, "d_u": 256, "k_g": 32, "k_u": 16}
ROUTE_LADDER = (1, 8, 64)
ROUTE_FLEETS = (1, 2, 4)
ROUTE_FLOOD, ROUTE_THREADS, ROUTE_SWAP, ROUTE_KILL = 4_000, 32, 2_000, 2_000
ROUTE_ZIPF, ROUTE_POOL, ROUTE_CACHE = 1.3, 4, 8192
ROUTE_CHILD_FLAG = "--shard-routing-child"
ROUTE_BOOT_TIMEOUT_S = 240
# Run Y: the serving driver's fleet modes over run H's model files: two
# --shard-index drivers and a router driver replaying run H's first
# validation part (2,048 rows) closed-loop
FLEET_Y_TIMEOUT_S = 300


def route_ids(shapes):
    return [f"user{i:06d}" for i in range(shapes["E"])]


def route_bank(seed, generation, shapes, entity_shard=None, device="cuda"):
    """Generation ``generation``'s bank from the seed (every process that
    builds it gets the same bits), whole or one entity shard."""
    from photon_ml_tpu_torch.serving import bank_from_arrays
    from photon_ml_tpu_torch.utils.index_map import IndexMap

    rng = np.random.default_rng([seed, 12, generation])
    fe = rng.standard_normal(shapes["d_g"], dtype=np.float32) * np.float32(0.1)
    re = rng.standard_normal((shapes["E"], shapes["d_u"]), dtype=np.float32) * np.float32(0.1)
    return bank_from_arrays(
        generation=generation,
        fixed=[("global", "g", fe)],
        random=[("per-user", "userId", "u", re, route_ids(shapes))],
        shard_widths={"g": shapes["k_g"], "u": shapes["k_u"]},
        index_maps={
            "g": IndexMap({f"g{j}\t": j for j in range(shapes["d_g"])}),
            "u": IndexMap({f"u{j}\t": j for j in range(shapes["d_u"])}),
        },
        entity_shard=entity_shard,
        device=device,
    )


def route_shard_configs():
    from photon_ml_tpu_torch.game.config import FeatureShardConfiguration

    return [FeatureShardConfiguration("g", ["features"]),
            FeatureShardConfiguration("u", ["userFeatures"])]


def route_child(cfg_text):
    """One shard-server child of run X: its 1/N slice of generation 1 on
    the card, partial mode, the router's control plane (stage_swap builds
    generation ``model_dir`` from the seed on the host), its port in
    ``frontend.json``; SIGTERM drains and writes its program cache."""
    import threading

    from photon_ml_tpu_torch.reliability import atomic_write_json
    from photon_ml_tpu_torch.serving import ServingModel, ServingPrograms, ShardServer

    cfg = json.loads(cfg_text)
    s, n, seed, shapes = cfg["shard"], cfg["count"], cfg["seed"], cfg["shapes"]
    sm = ServingModel(route_bank(seed, 1, shapes, (s, n), cfg["device"]),
                      ServingPrograms(ROUTE_LADDER), partial=True, entity_shard=(s, n))
    srv = ShardServer(
        sm, route_shard_configs(), (s, n), has_response=False,
        stager=lambda obj: sm.prepare_swap_bank(
            route_bank(seed, int(obj["model_dir"]), shapes, (s, n), device=False)),
    ).start()
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_a: stop.set())
    atomic_write_json(f"{cfg['out']}/frontend.json", {"port": srv.port, "pid": os.getpid()})
    while not stop.wait(timeout=0.2):
        pass
    report = srv.close(drain_timeout_s=10.0)
    atomic_write_json(f"{cfg['out']}/metrics.json", {
        "programs": sm.programs.stats(), "serving": srv.metrics.snapshot(),
        "drain": report.to_dict(), "generation": sm.generation,
    })
    return 0


def route_record(key, shapes):
    """The request of (entity, payload, variant): the same bits in every
    process (crc32 of the key seeds it)."""
    import zlib

    e, j, variant = key
    prng = np.random.default_rng(zlib.crc32(f"{e}:{j}:{variant}".encode()))
    return {
        "uid": f"q{e}-{j}-{variant}",
        "metadataMap": {"userId": f"user{e:06d}"},
        "features": [{"name": f"g{int(g)}", "term": "", "value": float(prng.standard_normal())}
                     for g in prng.integers(0, shapes["d_g"], size=shapes["k_g"])],
        "userFeatures": [{"name": f"u{int(u)}", "term": "", "value": float(prng.standard_normal())}
                         for u in prng.integers(0, shapes["d_u"], size=shapes["k_u"])],
        "offset": float(prng.standard_normal()) * 0.1,
    }


class RouteOracle:
    """The single in-process server over the whole bank of one generation
    (the ladder of the shards): each record's score, and its FE-only
    score (the entity unknown) plus the offset."""

    def __init__(self, seed, generation, device):
        from photon_ml_tpu_torch.serving import MicroBatcher, ServingModel, ServingPrograms

        self.model = ServingModel(route_bank(seed, generation, ROUTE_SHAPES, device=device),
                                  ServingPrograms(ROUTE_LADDER))
        self.batcher = MicroBatcher(self.model.current, self.model.programs)
        self.shards = route_shard_configs()

    def request(self, record, fe_only=False):
        from photon_ml_tpu_torch.serving import request_from_record

        if fe_only:
            record = dict(record, metadataMap={"userId": "no-such-user"})
        return request_from_record(record, self.model.current(), self.shards, has_response=False)

    def score(self, record):
        return self.batcher.score(self.request(record))

    def scores(self, records, fe_only=False):
        out = []
        for i in range(0, len(records), 1024):  # inside the batcher's queue bound
            futs = [self.batcher.submit(self.request(r, fe_only)) for r in records[i:i + 1024]]
            out.extend(f.result() for f in futs)
        return np.asarray(out, np.float32)

    def close(self):
        self.batcher.close()


def route_spawn(seed, tmp, n_shards, log, device):
    procs = []
    for s in range(n_shards):
        out = f"{tmp}/n{n_shards}-shard{s}"
        os.makedirs(out)
        cfg = json.dumps({"shard": s, "count": n_shards, "seed": seed, "out": out,
                          "shapes": ROUTE_SHAPES, "device": device})
        procs.append((out, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), ROUTE_CHILD_FLAG, cfg],
            stdout=log, stderr=subprocess.STDOUT)))
    return procs


def route_ports(procs, t0):
    ports = []
    for out, p in procs:
        while not os.path.isfile(f"{out}/frontend.json"):
            if p.poll() is not None or time.perf_counter() - t0 > ROUTE_BOOT_TIMEOUT_S:
                fail(f"fleet run X: shard child {out} did not start (exit {p.poll()})")
            time.sleep(0.1)
        with open(f"{out}/frontend.json") as f:
            ports.append(json.load(f)["port"])
    return ports


def route_check(label, records, outs, oracles, fe_oracles, owner_dead=None):
    """Every outcome a routed score bitwise its generation's single-server
    score, or, degraded, its FE-only score plus the offset (only the dead
    shard's entities may degrade); -> (outcome counts, generations)."""
    from photon_ml_tpu_torch import ownership

    counts, gens, bad = {}, {}, []
    for rec, o in zip(records, outs):
        if isinstance(o, BaseException):
            key = f"error:{getattr(o, 'code', type(o).__name__)}"
            counts[key] = counts.get(key, 0) + 1
            continue
        counts["degraded" if o.degraded else "ok"] = counts.get(
            "degraded" if o.degraded else "ok", 0) + 1
        gens[o.generation] = gens.get(o.generation, 0) + 1
        uid = rec["uid"]
        if o.degraded:
            owner = ownership.owner_of(int(rec["metadataMap"]["userId"][4:]), 4)
            if owner != owner_dead or np.float32(o) != fe_oracles[o.generation][uid]:
                bad.append((uid, o.generation, float(o), "degraded"))
        elif np.float32(o) != oracles[o.generation][uid]:
            bad.append((uid, o.generation, float(o), float(oracles[o.generation][uid])))
    if bad or any(k.startswith("error") for k in counts) or sum(counts.values()) != len(records):
        fail(f"fleet run X {label}: {len(bad)} routed scores off their generation's "
             f"single-server score (first {bad[:3]}), outcomes {counts}")
    return counts, gens


def fleet_x_spawn(seed, tmp, device="cuda"):
    """Start every fleet's children of run X at once (they boot while the
    caller works on); -> (children by fleet size, the start time)."""
    t0 = time.perf_counter()
    with open(f"{tmp}/children.log", "w") as log:
        return {n: route_spawn(seed, tmp, n, log, device) for n in ROUTE_FLEETS}, t0


def fleet_stop(fleets):
    """SIGTERM every live child (each drains and writes its program
    cache), then wait; a child that does not exit is killed."""
    children = [p for procs in fleets.values() for _, p in procs]
    for p in children:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    for p in children:
        try:
            p.wait(timeout=60)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def fleet_run_x(seed, smi, fleets, t0, device="cuda"):
    """Run X over the children ``fleet_x_spawn`` started at ``t0``; -> its
    numbers."""
    from photon_ml_tpu_torch.obs.flight_recorder import FlightRecorder
    from photon_ml_tpu_torch.serving import RoutingPolicy, ShardRouter

    shapes = ROUTE_SHAPES
    rng = np.random.default_rng([seed, 13])
    draw = (rng.zipf(ROUTE_ZIPF, size=ROUTE_FLOOD + ROUTE_SWAP + ROUTE_KILL) - 1) % shapes["E"]

    def records(part, variant):
        return [route_record((int(e), int(e + i) % ROUTE_POOL, variant), shapes)
                for i, e in enumerate(part)]

    flood = records(draw[:ROUTE_FLOOD], 0)
    swap_recs = records(draw[ROUTE_FLOOD:ROUTE_FLOOD + ROUTE_SWAP], 0)
    # a disjoint payload universe: every kill-leg record misses the cache
    kill_recs = records(draw[ROUTE_FLOOD + ROUTE_SWAP:], 1)
    result = {}
    try:
        oracle1, oracle2 = RouteOracle(seed, 1, device), RouteOracle(seed, 2, device)
        ports = {n: route_ports(procs, t0) for n, procs in fleets.items()}
        boot_s = time.perf_counter() - t0
        say(f"fleet run X ({smi}): {sum(map(len, fleets.values()))} shard children of "
            f"{shapes['E']} users x {shapes['d_u']}, a fixed effect of {shapes['d_g']}, "
            f"{shapes['k_g']} and {shapes['k_u']} features a request, ladder "
            f"{ROUTE_LADDER}, ready {boot_s!r} s after their start")
        # the single server over the whole bank: the router's own cost
        # (routed N = 1 against it) and every record's oracle score
        _, wall, cpu = route_flood(oracle1.score, flood, ROUTE_THREADS)
        single = dict(qps=len(flood) / wall, wall_s=wall, host_us=cpu / len(flood) * 1e6)
        uids = {r["uid"]: r for r in flood + swap_recs + kill_recs}
        recs = list(uids.values())
        oracles = {g: dict(zip(uids, o.scores(recs))) for g, o in ((1, oracle1), (2, oracle2))}
        fe_oracles = {g: dict(zip(uids, o.scores(recs, fe_only=True)))
                      for g, o in ((1, oracle1), (2, oracle2))}
        differ = sum(oracles[1][u] != oracles[2][u] for u in uids)
        say(f"fleet run X single in-process server ({smi}): {len(flood)} requests from "
            f"{ROUTE_THREADS} threads in {wall!r} s, QPS {single['qps']!r}, host CPU "
            f"{single['host_us']!r} us a request; {len(uids)} distinct records, "
            f"{differ} of whose generation 1 and 2 scores differ")
        if differ < len(uids) // 2:
            fail("fleet run X: the two generations do not tell scores apart")
        result["single"] = single
        for n in ROUTE_FLEETS:
            book = FlightRecorder(capacity=1 << 16)
            router = ShardRouter(
                [("127.0.0.1", pt) for pt in ports[n]],
                entity_ids={"userId": route_ids(shapes)},
                shard_configs=route_shard_configs(),
                policy=RoutingPolicy(subrequest_timeout_s=5.0),
                cache_entries=ROUTE_CACHE, recorder=book)
            try:
                info = router.connect()
                route_flood(router.score_record, flood[:16], 4)  # the connections
                router.metrics = type(router.metrics)()
                router.cache = type(router.cache)(ROUTE_CACHE)
                outs, wall, cpu = route_flood(router.score_record, flood, ROUTE_THREADS)
                counts, gens = route_check(f"N={n}", flood, outs, oracles, fe_oracles)
                snap, cache = router.metrics.snapshot(), router.cache.snapshot()
                fan = np.asarray([o.fanout for o in outs])
                row = dict(
                    qps=len(flood) / wall, wall_s=wall, host_us=cpu / len(flood) * 1e6,
                    p50_ms=snap.get("latency_p50_ms"), p99_ms=snap.get("latency_p99_ms"),
                    fanout_p50=float(np.percentile(fan, 50)),
                    fanout_p99=float(np.percentile(fan, 99)),
                    fanout_mean=float(fan.mean()), subrequests=snap["subrequests"],
                    hedges=snap["hedges"],
                    cache_hit_rate=cache["hits"] / max(cache["hits"] + cache["misses"], 1),
                    outcomes=counts, wire=info["wire"])
                say(f"fleet run X N={n} ({smi}): {len(flood)} requests in {wall!r} s, "
                    f"aggregate QPS {row['qps']!r}; router latency p50 {row['p50_ms']!r} ms "
                    f"p99 {row['p99_ms']!r} ms; fan-out p50 {row['fanout_p50']!r} p99 "
                    f"{row['fanout_p99']!r} mean {row['fanout_mean']!r}; cache hit rate "
                    f"{row['cache_hit_rate']!r}; router host CPU {row['host_us']!r} us a "
                    f"request; outcomes {counts}, every score bitwise the single server's")
                if n == 1:
                    say(f"fleet run X routed N=1 vs the single in-process server ({smi}): "
                        f"QPS {row['qps']!r} vs {single['qps']!r}, host CPU "
                        f"{row['host_us']!r} vs {single['host_us']!r} us a request")
                if n == 4:
                    row.update(fleet_x_swap_and_kill(
                        router, fleets[4], swap_recs, kill_recs, oracles, fe_oracles, smi))
                cons = book.check_conservation()
                say(f"fleet run X N={n} conservation: {cons}")
                if not cons["ok"]:
                    fail(f"fleet run X N={n}: outcomes not conserved: {cons}")
            finally:
                router.close()
            result[n] = row
        oracle1.close()
        oracle2.close()
    finally:
        fleet_stop(fleets)
    for n, procs in fleets.items():
        for out, p in procs:
            if not os.path.isfile(f"{out}/metrics.json"):
                if (n, out) != (4, procs[-1][0]):
                    fail(f"fleet run X: {out} wrote no program cache at its drain")
                continue  # the SIGKILLed child
            with open(f"{out}/metrics.json") as f:
                m = json.load(f)
            after = m["programs"]["compile_count"] - len(ROUTE_LADDER)
            say(f"fleet run X {os.path.basename(out)}: captures after warmup {after}, "
                f"cold dispatch captures {m['programs']['cold_dispatch_compiles']}, "
                f"dispatches {m['serving']['dispatches']}, generation {m['generation']}, "
                f"exit {p.returncode}")
            if after or m["programs"]["cold_dispatch_compiles"] or p.returncode:
                fail(f"fleet run X: {out} captured after warmup or exited {p.returncode}")
    return result


def fleet_x_swap_and_kill(router, procs, swap_recs, kill_recs, oracles, fe_oracles, smi):
    """At N = 4: the two-step flip to generation 2 under floods of
    ``swap_recs`` that go on until it landed and one flood past it, then
    a flood of cache-missing payloads during which child 3 is
    SIGKILLed."""
    import threading

    swap = {}
    landed = threading.Event()

    def flip():
        t0 = time.perf_counter()
        swap["result"] = router.coordinate_swap("2")
        swap["s"] = time.perf_counter() - t0
        landed.set()

    flipper = threading.Thread(target=flip)
    recs, outs = [], []
    t0 = time.perf_counter()
    flipper.start()
    while True:
        after = landed.is_set()
        o, _, _ = route_flood(router.score_record, swap_recs, ROUTE_THREADS)
        recs += swap_recs
        outs += o
        if after:
            break
    wall = time.perf_counter() - t0
    flipper.join()
    counts, gens = route_check("swap", recs, outs, oracles, fe_oracles)
    res = swap["result"]
    say(f"fleet run X N=4 two-step swap under load ({smi}): {res}; {swap['s']!r} s while "
        f"{len(recs)} requests were served in {wall!r} s; served by generation {gens}; every "
        f"score bitwise its own generation's single-server score")
    if not (res["ok"] and res["generation"] == 2 and router.generation == 2
            and gens.get(1) and gens.get(2)):
        fail(f"fleet run X: the fleet-wide swap did not land under load: {res}, {gens}")

    def kill():
        procs[-1][1].send_signal(signal.SIGKILL)

    outs, wall, _ = route_flood(router.score_record, kill_recs, ROUTE_THREADS,
                                at=len(kill_recs) // 4, then=kill)
    procs[-1][1].wait(timeout=60)
    counts, gens = route_check("kill", kill_recs, outs, oracles, fe_oracles, owner_dead=3)
    health = [h.snapshot() for h in router.health]
    say(f"fleet run X N=4 SIGKILL of shard 3 a quarter into {len(kill_recs)} cache-missing "
        f"requests ({smi}): {wall!r} s, outcomes {counts}, generations {gens}; degraded rows "
        f"bitwise their FE-only score plus the offset; shard 3 health {health[3]}")
    if not counts.get("degraded"):
        fail("fleet run X: no request degraded after the kill")
    return dict(swap_s=swap["s"], swap_requests=len(recs), kill_outcomes=counts,
                kill_wall_s=wall)


def fleet_y_files(tmp):
    """Copy what runs Y, Q and phase 15 read out of run H's directory (the model,
    its registry, the training and validation parts, run W's name-term
    lists and closed scores) into a directory that outlives it; -> that
    directory."""
    keep = tempfile.mkdtemp(prefix="photon_fleet_y_")
    for part in ("out/best-model", "name-terms", "serve-closed/scores", "registry", "train",
                 "validate", "scores"):
        shutil.copytree(f"{tmp}/{part}", f"{keep}/{part}")
    return keep


def fleet_run_y(tmp, shards, smi, widths, device_args=()):
    """Run Y, over run H's files as ``fleet_y_files`` kept them: two ``--shard-index``
    serving drivers (shard 0 with ``--obs-dir`` and ``--profile-dir``)
    and a router driver (``--wire binary --fleet-obs-dir --slo default
    --swap-model-dir``) replaying run H's first validation part
    closed-loop in a process that must not create a CUDA context."""
    from photon_ml_tpu_torch.evaluation.metrics import area_under_roc_curve
    from photon_ml_tpu_torch.io.avro_codec import read_avro_records

    model = f"{tmp}/out/best-model"
    common = ["--game-model-input-dir", model,
              "--feature-shard-id-to-feature-section-keys-map", shards]
    shard_args = common + [
        "--feature-name-and-term-set-path", f"{tmp}/name-terms",
        "--request-nnz-width", "|".join(f"{k}:{v}" for k, v in widths.items()),
        # closed-loop traffic dispatches shape 1 only
        "--ladder", "1,8", "--frontend-port", "0", "--shard-count", "2", *device_args]
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = []
    try:
        for s in range(2):
            extra = (["--obs-dir", f"{tmp}/fleet-obs-shard0",
                      "--profile-dir", f"{tmp}/fleet-prof-shard0"] if s == 0 else [])
            with open(f"{tmp}/fleet-shard{s}.log", "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "photon_ml_tpu_torch.cli.serving_driver",
                     *shard_args, "--shard-index", str(s),
                     "--output-dir", f"{tmp}/fleet-shard{s}", *extra],
                    cwd=here, stdout=log, stderr=subprocess.STDOUT,
                    env={**os.environ, "PHOTON_TRACE": "1"}))
        ports = []
        for s, p in enumerate(procs):
            fj = f"{tmp}/fleet-shard{s}/frontend.json"
            while not os.path.isfile(fj):
                if p.poll() is not None or time.perf_counter() - t0 > FLEET_Y_TIMEOUT_S:
                    with open(f"{tmp}/fleet-shard{s}.log") as f:
                        fail(f"fleet run Y: shard driver {s} did not start: {f.read()[-3000:]}")
                time.sleep(0.2)
            with open(fj) as f:
                meta = json.load(f)
            ports.append(meta["port"])
            if meta["shard"]["shard_index"] != s or not meta["shard"]["partial"]:
                fail(f"fleet run Y: shard driver {s} published {meta['shard']}")
        boot_s = time.perf_counter() - t0
        rows = sum(1 for _ in read_avro_records(f"{tmp}/validate/part-00000.avro"))
        code = ("import sys, torch\n"
                "from photon_ml_tpu_torch.cli import serving_driver\n"
                "serving_driver.main(sys.argv[1:])\n"
                "print('cuda_initialized', torch.cuda.is_initialized())\n")
        t1 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-c", code, *common,
             "--output-dir", f"{tmp}/fleet-router",
             "--request-paths", f"{tmp}/validate/part-00000.avro", "--mode", "closed",
             "--shard-servers", ",".join(f"127.0.0.1:{pt}" for pt in ports),
             "--wire", "binary", "--fleet-obs-dir", f"{tmp}/fleet-obs",
             "--obs-dir", f"{tmp}/fleet-obs-router", "--slo", "default",
             "--swap-model-dir", model, "--swap-after-requests", str(rows // 2)],
            cwd=here, capture_output=True, text=True, timeout=FLEET_Y_TIMEOUT_S)
        route_s = time.perf_counter() - t1
        if r.returncode != 0:
            fail(f"fleet run Y: the router driver exited {r.returncode}: {r.stderr[-3000:]}")
        t2 = time.perf_counter()
        for p in procs:
            p.send_signal(signal.SIGTERM)
        codes = [p.wait(timeout=FLEET_Y_TIMEOUT_S) for p in procs]
        drain_s = time.perf_counter() - t2
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    with open(f"{tmp}/fleet-router/metrics.json") as f:
        m = json.load(f)
    routed = {x["uid"]: x for x in read_avro_records(f"{tmp}/fleet-router/scores")}
    single = {x["uid"]: x for x in read_avro_records(f"{tmp}/serve-closed/scores")}
    differ = [u for u in routed if routed[u]["predictionScore"] != single[u]["predictionScore"]]

    def auc(recs):
        s = torch.as_tensor([x["predictionScore"] for x in recs], dtype=torch.float32)
        y = torch.as_tensor([x["label"] for x in recs], dtype=torch.float32)
        w = torch.as_tensor([x["weight"] for x in recs], dtype=torch.float32)
        return float(area_under_roc_curve(s, y, w))

    auc_routed = auc(list(routed.values()))
    auc_single = auc([single[u] for u in routed])
    with open(f"{tmp}/fleet-obs/fleet_trace.json") as f:
        verification = json.load(f)["otherData"]["verification"]
    with open(f"{tmp}/fleet-obs/fleet_conservation.json") as f:
        conservation = json.load(f)
    prof = [n for n in os.listdir(f"{tmp}/fleet-prof-shard0") if n.endswith(".pt.trace.json")]
    with open(f"{tmp}/fleet-prof-shard0/{prof[0]}") as f:
        kernels = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    shard_m = []
    for s in range(2):
        with open(f"{tmp}/fleet-shard{s}/metrics.json") as f:
            shard_m.append(json.load(f))
    cuda_line = r.stdout.strip().splitlines()[-1]
    router_timers = " ".join(r.stderr.rpartition("timers:")[2].split())
    say(f"fleet run Y ({smi}): 2 shard drivers up in {boot_s!r} s; the router driver "
        f"routed {len(routed)} of {rows} rows closed-loop in {route_s!r} s (process "
        f"included), outcomes {m['outcomes']}, wire {m['routing']['wire']}, swap "
        f"{m['swap']}, generation {m['generation']}; {len(differ)} scores differ from run W's "
        f"single server; AUC {auc_routed!r} vs {auc_single!r}; fleet trace verification "
        f"{ {k: v for k, v in verification.items() if k != 'violations'} }; conservation ok "
        f"{conservation['ok']}; slo alerts {m['slo']['alerts_active']}; shard 0's profile: "
        f"{len(kernels)} CUDA kernel events; shard exits {codes}, cold captures "
        f"{[x['programs']['cold_dispatch_compiles'] for x in shard_m]}, SIGTERM to exit "
        f"{drain_s!r} s (shard 0 writes its profile); router {cuda_line}, its stage "
        f"timers: {router_timers}")
    if differ or len(routed) != rows or m["outcomes"] != {"ok": rows}:
        fail(f"fleet run Y: routed scores are not run W's ({len(differ)} differ)")
    if auc_routed != auc_single:
        fail("fleet run Y: the AUC is not run W's")
    if not (m["swap"] and m["swap"]["ok"] and m["generation"] == 2):
        fail(f"fleet run Y: the router's two-step swap did not land: {m['swap']}")
    if not (verification["ok"] and verification["router_subrequests"] and conservation["ok"]):
        fail(f"fleet run Y: the fleet trace or the fleet books do not verify: "
             f"{verification}, {conservation}")
    if not kernels:
        fail("fleet run Y: shard 0's profile holds no CUDA kernel event")
    if codes != [0, 0] or any(x["programs"]["cold_dispatch_compiles"] for x in shard_m):
        fail(f"fleet run Y: shard drivers exited {codes} or captured on the request path")
    if cuda_line != "cuda_initialized False":
        fail(f"fleet run Y: the router process created a CUDA context ({cuda_line})")
    return dict(boot_s=boot_s, route_s=route_s, drain_s=drain_s, rows=rows,
                kernel_events=len(kernels),
                verification={k: v for k, v in verification.items() if k != "violations"})


# -- phase 13: the model registry, the retrain loop and the determinism harness --
#
# Run L: the JAX package's retrain configuration (bench.py:3572-3573): 8
# Avro parts x 4,000 rows from a planted model, d = 2,000, 12 nonzeros a
# row, a validation part of 4,000 rows, L-BFGS at lambda 1 for 30
# iterations; then a 1% append (320 rows) and a label-flipped flood as
# large as the base (8 parts x 4,000 rows). Nothing cut.
RETRAIN_PARTS, RETRAIN_ROWS, RETRAIN_DIM, RETRAIN_NNZ = 8, 4000, 2000, 12
RETRAIN_VAL_ROWS, RETRAIN_ITERS, RETRAIN_APPEND = 4000, 30, 320
RETRAIN_FLOOD_AUC_DROP = 0.02  # the gate run L3 is refused by (test_retrain_drivers.py:151)
# Run Q: run H's files and widths, a new user's part, the watcher's policy
Q_NEW_USER_ROWS = 64
Q_POLICY = ["--registry-poll-s", "0.3", "--rollback-window", "16",
            "--rollback-min-requests", "6", "--rollback-max-unhealthy", "0.5"]
Q_TIMEOUT_S = 180


def retrain_part(args):
    """One Avro part of run L's rows: the planted model of ``bench.py``'s
    retrain configuration, rows from a generator of the part's own;
    ``flip`` draws the labels from the negated model (the poisoned
    flood)."""
    seed, path, part, rows, flip, dim = args
    from photon_ml_tpu_torch.io import schemas
    from photon_ml_tpu_torch.io.avro_codec import write_container

    w_true = np.random.default_rng([seed, 13]).normal(size=dim).astype(np.float32) * 0.3
    rng = np.random.default_rng([seed, 14, part])
    ix = rng.integers(0, dim, size=(rows, RETRAIN_NNZ))
    vs = rng.normal(size=(rows, RETRAIN_NNZ)).astype(np.float32)
    z = (w_true[ix] * vs).sum(axis=1) * (-1.0 if flip else 1.0)
    y = rng.uniform(size=rows) < 1 / (1 + np.exp(-z))
    recs = [{
        "uid": f"{part}-{i}", "label": float(y[i]), "offset": 0.0, "weight": 1.0,
        "features": [{"name": str(j), "term": "", "value": v}
                     for j, v in zip(ix[i].tolist(), vs[i].tolist())],
    } for i in range(rows)]
    write_container(path, schemas.TRAINING_EXAMPLE_AVRO, recs)
    return rows


def retrain_run_l(seed, smi, k1, device_args=()):
    """Run L: the GLM retrain loop (L1 cold, L2 after a 1% append, L3
    after a label-flipped flood) through ``glm_driver.main`` streamed with
    the scan cache, the warm start, the gates and the publish; -> K1's
    launches in each run. The parts are written in this process (0.4 s
    a part: cheaper than spawning workers that import torch)."""
    from photon_ml_tpu_torch.cli import glm_driver
    from photon_ml_tpu_torch.registry import ModelRegistry, align_coefficients

    with tempfile.TemporaryDirectory(prefix="photon_retrain_l_") as tmp:
        t0 = time.perf_counter()
        for d in ("train", "validate", "append", "flood"):
            os.makedirs(f"{tmp}/{d}")
        jobs = [(seed, f"{tmp}/train/part-{p:03d}.avro", p, RETRAIN_ROWS, False, RETRAIN_DIM)
                for p in range(RETRAIN_PARTS)]
        jobs.append((seed, f"{tmp}/validate/part-000.avro", 100, RETRAIN_VAL_ROWS, False,
                     RETRAIN_DIM))
        jobs.append((seed, f"{tmp}/append/part-{RETRAIN_PARTS:03d}.avro", 101, RETRAIN_APPEND,
                     False, RETRAIN_DIM))
        jobs += [(seed, f"{tmp}/flood/part-{RETRAIN_PARTS + 1 + p:03d}.avro", 200 + p,
                  RETRAIN_ROWS, True, RETRAIN_DIM) for p in range(RETRAIN_PARTS)]
        written = [retrain_part(job) for job in jobs]
        say(f"retrain run L data: {sum(written[:RETRAIN_PARTS])} training rows in "
            f"{RETRAIN_PARTS} Avro parts (d = {RETRAIN_DIM}, {RETRAIN_NNZ} nonzeros a row), "
            f"{written[RETRAIN_PARTS]} validation rows, a {RETRAIN_APPEND}-row append and a "
            f"{sum(written[RETRAIN_PARTS + 2:])}-row label-flipped flood, written in "
            f"{time.perf_counter() - t0!r} s")
        reg = f"{tmp}/registry"
        base = [
            "--training-data-directory", f"{tmp}/train",
            "--validating-data-directory", f"{tmp}/validate",
            "--regularization-weights", "1", "--num-iterations", str(RETRAIN_ITERS),
            "--streaming", "true", "--scan-cache-dir", f"{tmp}/scan-cache",
            "--retrain-from", reg, "--publish-registry", reg, *device_args,
        ]
        launches, drivers, metrics = {}, {}, {}
        for label, extra in (("L1", []), ("L2", []),
                             ("L3", ["--gate-max-auc-drop", str(RETRAIN_FLOOD_AUC_DROP)])):
            if label == "L2":
                shutil.move(f"{tmp}/append/part-{RETRAIN_PARTS:03d}.avro", f"{tmp}/train/")
            if label == "L3":
                for name in sorted(os.listdir(f"{tmp}/flood")):
                    shutil.move(f"{tmp}/flood/{name}", f"{tmp}/train/")
            k1.launches = 0
            t0 = time.perf_counter()
            driver = glm_driver.main(base + ["--output-directory", f"{tmp}/out-{label}", *extra])
            seconds = time.perf_counter() - t0
            launches[label] = k1.launches
            with open(f"{tmp}/out-{label}/metrics.json") as f:
                m = json.load(f)
            drivers[label], metrics[label] = driver, m
            r = m["registry"]
            timers = " ".join(f"{k}={v!r}" for k, v in driver.timer.durations.items())
            gates = r["gates"] or {}
            say(f"retrain run {label} ({smi}): {seconds!r} s; stage timers s: {timers}; "
                f"publish-registry stage {m['timers'].get('publish-registry')!r} s; K1 launches "
                f"{launches[label]}; scan cache {m['scan_cache']}; iterations "
                f"{[int(res.iterations) for res in driver.results.values()]}; parent "
                f"{r['parent_generation']}, published {r['published_generation']}; drift "
                f"{ {k: v for k, v in (r['drift'] or {}).items() if k != 'dropped_keys_sample'} }; "
                f"gates {gates.get('verdict')} {gates.get('checks')}")
            if launches[label] == 0:
                fail(f"retrain run {label}: K1 never launched")
        registry = ModelRegistry(reg)
        r1, r2, r3 = (metrics[x]["registry"] for x in ("L1", "L2", "L3"))
        if (r1["published_generation"], r1["parent_generation"]) != (1, None):
            fail(f"retrain run L1 did not publish generation 1 cold: {r1}")
        # the no-drift warm start is bitwise generation 1's coefficients
        from photon_ml_tpu_torch.cli.glm_driver import _glm_artifact_means

        d1, d2 = drivers["L1"], drivers["L2"]
        aligned = align_coefficients(_glm_artifact_means(registry.generation(1).model_dir),
                                     d2._data.index_map)
        g1_means = d1.best_model.means.cpu().numpy()
        same_map = dict(d1._data.index_map.items()) == dict(d2._data.index_map.items())
        bitwise = same_map and np.array_equal(aligned, g1_means)
        sc = metrics["L2"]["scan_cache"]
        say(f"retrain run L2 warm start ({smi}): no drift {r2['drift']['no_drift']}, the aligned "
            f"vector bitwise generation 1's coefficients {bitwise}; partitions scanned "
            f"{sc['scanned']} of {sc['partitions']}; lineage {registry.lineage()}")
        if not (sc["scanned"] == 1 and r2["drift"]["no_drift"] and bitwise):
            fail("retrain run L2: the append was not scanned alone, or the warm start is not "
                 "bitwise generation 1's coefficients")
        if not (r2["gates"]["verdict"] == "PASS" and r2["published_generation"] == 2
                and r2["parent_generation"] == 1 and registry.lineage() == [2, 1]):
            fail(f"retrain run L2: not generation 2 with parent 1 under PASS: {r2}")
        refused = registry.refused_candidates()
        gens = [g.generation for g in registry.list_generations()]
        say(f"retrain run L3 ({smi}): verdict {r3['gates']['verdict']}, generations {gens}, "
            f"refusals {[x['gates']['verdict'] for x in refused]}")
        if not (r3["gates"]["verdict"] == "AUC_REGRESSION" and r3["published_generation"] is None
                and gens == [1, 2] and len(refused) == 1
                and refused[0]["gates"]["verdict"] == "AUC_REGRESSION"):
            fail(f"retrain run L3: the poisoned candidate was not refused: {r3}")
    return launches


def q_new_user_part(path, seed, n_users, dim):
    """Run Q's appended part: rows of run H's shape for a user that
    generation 1 never saw (run H's user 0's model, a new id)."""
    from photon_ml_tpu_torch.io import schemas
    from photon_ml_tpu_torch.io.avro_codec import write_container

    w_global, w_user = game_model(np.random.default_rng([seed, 5]), n_users, dim)
    rng = np.random.default_rng([seed, 15])
    users = np.zeros(Q_NEW_USER_ROWS, np.int64)
    g_idx, g_val, u_idx, u_val, labels, _ = game_rows(rng, users, w_global, w_user)
    icept = dim - 1

    def bag(idx, val):
        return [{"name": str(i), "term": "", "value": v}
                for i, v in zip(idx, val) if v != 0 and i != icept]

    recs = [{
        "uid": f"newuser-{r}", "label": float(labels[r]),
        "features": bag(g_idx[r].tolist(), g_val[r].tolist()),
        "userFeatures": bag(u_idx[r].tolist(), u_val[r].tolist()),
        "metadataMap": {"userId": "user99999"}, "weight": None, "offset": None,
    } for r in range(len(users))]
    schema = dict(schemas.TRAINING_EXAMPLE_AVRO)
    schema["fields"] = list(schema["fields"]) + [GAME_H_SCHEMA_EXTRA]
    write_container(path, schema, recs)


def q_client(port, records, stop, out):
    """Run Q's client thread: one connection, closed loop over ``records``
    round and round until ``stop``; -> (send time, receive time, receive
    wall-clock time, response) into ``out``."""
    import socket

    with socket.create_connection(("127.0.0.1", port), timeout=60) as sock:
        reader = sock.makefile("rb")
        i = 0
        while not stop.is_set():
            rec = records[i % len(records)]
            i += 1
            t0 = time.perf_counter()
            sock.sendall((json.dumps(rec) + "\n").encode())
            resp = json.loads(reader.readline())
            out.append((t0, time.perf_counter(), time.time(), resp))


def q_ask(port, obj):
    """One control op on a fresh connection."""
    import socket

    with socket.create_connection(("127.0.0.1", port), timeout=60) as sock:
        sock.sendall((json.dumps(obj) + "\n").encode())
        return json.loads(sock.makefile("rb").readline())


def registry_q_server(y, shards, widths, device_args=()):
    """Start run Q's ``serving_driver --registry-dir`` process over run H's
    kept files (it boots while run L runs); -> (process, its wall-clock
    start time)."""
    cmd = [sys.executable, "-m", "photon_ml_tpu_torch.cli.serving_driver",
           "--registry-dir", f"{y}/registry", "--output-dir", f"{y}/q-serve",
           "--feature-shard-id-to-feature-section-keys-map", shards,
           "--feature-name-and-term-set-path", f"{y}/name-terms",
           "--request-nnz-width", "|".join(f"{k}:{v}" for k, v in widths.items()),
           "--frontend-port", "0", "--ladder", "1,8", *Q_POLICY, *device_args]
    t0_wall = time.time()
    with open(f"{y}/q-serve.log", "w") as log_file:
        proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                                stdout=log_file, stderr=subprocess.STDOUT)
    return proc, t0_wall


def registry_run_q(y, shards, smi, seed, server, device_args=()):
    """Run Q over run H's files as ``fleet_y_files`` kept them (with the
    registry whose generation 1 run H's training driver published): the
    ``serving_driver --registry-dir`` process ``server`` started, a client
    thread, the GAME retrain publishing generation 2, ``quarantine_re``
    and the watcher's own rollback; -> its numbers. Stops the server."""
    import threading

    from photon_ml_tpu_torch.cli import game_scoring_driver, game_training_driver
    from photon_ml_tpu_torch.io.avro_codec import read_avro_records
    from photon_ml_tpu_torch.registry import ModelRegistry

    proc, t0_wall = server
    registry = ModelRegistry(f"{y}/registry")
    records = list(read_avro_records(f"{y}/validate/part-00000.avro"))
    os.makedirs(f"{y}/q-val0")
    shutil.copy(f"{y}/validate/part-00000.avro", f"{y}/q-val0/")
    batch = {1: {x["uid"]: x["predictionScore"]
                 for x in read_avro_records(f"{y}/serve-closed/scores")}}
    out_dir = f"{y}/q-serve"
    log_path = f"{y}/q-serve.log"

    def log():
        with open(log_path) as f:
            return f.read()[-3000:]

    responses, stop = [], threading.Event()
    client = None
    try:
        if registry.lineage() != [1]:
            fail(f"run Q: run H's registry holds {registry.lineage()}, not generation 1")
        while not os.path.isfile(f"{out_dir}/frontend.json"):
            if proc.poll() is not None or time.time() - t0_wall > Q_TIMEOUT_S:
                fail(f"run Q: the serving driver did not start: {log()}")
            time.sleep(0.2)
        start_s = os.path.getmtime(f"{out_dir}/frontend.json") - t0_wall
        with open(f"{out_dir}/frontend.json") as f:
            meta = json.load(f)
        if meta["registry"] != registry.root:
            fail(f"run Q: frontend.json names registry {meta['registry']}")
        port = meta["port"]
        client = threading.Thread(target=q_client, args=(port, records, stop, responses))
        client.start()

        def wait_for(cond, what):
            t = time.perf_counter()
            while not cond():
                if time.perf_counter() - t > Q_TIMEOUT_S or not client.is_alive():
                    fail(f"run Q: {what} did not happen: {log()}")
                time.sleep(0.05)

        wait_for(lambda: len(responses) >= 200, "generation 1's first 200 responses")
        # Q3: the GAME retrain from generation 1, with a new user appended;
        # its gates hold out the first validation part (2,048 rows; run H
        # validates on 8,192)
        q_new_user_part(f"{y}/train/part-99999.avro", seed, GAME_H_USERS, DIM)
        argv = [
            "--train-input-dirs", f"{y}/train", "--validate-input-dirs", f"{y}/q-val0",
            "--output-dir", f"{y}/q-retrain",
            "--feature-shard-id-to-feature-section-keys-map", shards,
            "--fixed-effect-data-configurations", "global:globalShard,1",
            "--fixed-effect-optimization-configurations", "global:50,1e-7,1,1,LBFGS,L2",
            "--random-effect-data-configurations",
            "per-user:userId,userShard,1,none,none,none,INDEX_MAP",
            "--random-effect-optimization-configurations", "per-user:30,1e-5,1,1,LBFGS,L2",
            "--num-iterations", "2", "--evaluator-types", "AUC",
            "--compute-variance", "true", "--model-output-mode", "BEST",
            "--retrain-from", registry.root, "--publish-registry", registry.root,
            "--gate-max-auc-drop", "0.02", *device_args,
        ]
        t1 = time.perf_counter()
        trainer = game_training_driver.main(argv)
        retrain_s = time.perf_counter() - t1
        with open(f"{y}/q-retrain/metrics.json") as f:
            rq = json.load(f)["registry"]
        info = registry.generation(2)
        publish_wall = os.path.getmtime(os.path.join(info.path, "COMMIT")) if info else time.time()
        timers = " ".join(f"{k}={v!r}" for k, v in trainer.timer.durations.items())
        drift = rq["drift"] or {}
        say(f"registry run Q3 retrain ({smi}): {retrain_s!r} s under the client's traffic; "
            f"stage timers s: {timers}; parent {rq['parent_generation']}, published "
            f"{rq['published_generation']}; drift "
            f"{ {c: {k: v for k, v in r.items() if k != 'dropped_keys_sample'} for c, r in drift.items()} }; "
            f"gates {(rq['gates'] or {}).get('verdict')} {(rq['gates'] or {}).get('checks')}")
        if not (rq["published_generation"] == 2 and rq["gates"]["verdict"] == "PASS"
                and drift.get("per-user", {}).get("churned_entities_prior_init", 0) >= 1):
            fail(f"run Q3: not generation 2 under PASS with the new user at the prior mean: {rq}")
        wait_for(lambda: any(r["generation"] == 2 for *_, r in responses),
                 "the watcher's promote of generation 2")
        promote_s = next(w for _, _, w, r in responses if r["generation"] == 2) - publish_wall
        n_before = len(responses)
        wait_for(lambda: len(responses) >= n_before + 200, "200 responses of generation 2")
        # Q4: degrade generation 2; the watcher rolls back on its own
        q = q_ask(port, {"op": "quarantine_re", "re_type": "userId"})
        if q.get("status") != "ok":
            fail(f"run Q4: quarantine_re answered {q}")
        wait_for(lambda: any(r["generation"] == 3 for *_, r in responses),
                 "the watcher's rollback")
        n_after = len(responses)
        wait_for(lambda: len(responses) >= n_after + 200, "200 responses after the rollback")
        status = q_ask(port, {"op": "status"})
        stop.set()
        client.join(timeout=60)
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=Q_TIMEOUT_S)
    finally:
        stop.set()
        if client is not None:
            client.join(timeout=60)
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    # generation 2's batch scores: the port's scoring driver over the same rows
    game_scoring_driver.main([
        "--input-data-dirs", f"{y}/q-val0", "--game-model-input-dir",
        f"{y}/registry/quarantine/g000002/model", "--output-dir", f"{y}/q-scores2",
        "--feature-shard-id-to-feature-section-keys-map", shards, *device_args,
    ])
    batch[2] = {x["uid"]: x["predictionScore"]
                for x in read_avro_records(f"{y}/q-scores2/scores")}
    by_bank = {1: 1, 2: 2, 3: 1}  # bank generation -> registry generation
    with open(f"{out_dir}/metrics.json") as f:
        m = json.load(f)
    bad = [r for *_, r in responses if r.get("status") != "ok"]
    differ, degraded, counts = [], [], {}
    for *_, r in responses:
        if r.get("status") != "ok":
            continue
        counts[r["generation"]] = counts.get(r["generation"], 0) + 1
        if r["degraded"]:
            degraded.append(r)
        elif np.float32(r["score"]) != np.float32(batch[by_bank[r["generation"]]][r["uid"]]):
            differ.append(r["uid"])
    t_deg = next(t for _, t, _, r in responses if r.get("degraded"))
    t_back = next(t for _, t, _, r in responses if r["generation"] == 3)
    gaps = {}
    for a, b in ((1, 2), (2, 3)):
        last_a = max(t for _, t, _, r in responses if r["generation"] == a)
        first_b = min(t for _, t, _, r in responses if r["generation"] == b)
        gaps[f"{a}->{b}"] = first_b - last_a
    lat = np.array([(t1 - t0) * 1e3 for t0, t1, *_ in responses])
    history = [h["action"] for h in m.get("registry", {}).get("watcher_history", [])]
    quarantined = os.path.isdir(f"{y}/registry/quarantine/g000002")
    out = dict(start_s=start_s, retrain_s=retrain_s, publish_to_gen2_s=promote_s,
               degraded_to_gen1_s=t_back - t_deg, flip_gap_s=gaps, requests=len(responses),
               by_bank_generation=counts, degraded=len(degraded),
               p50_ms=float(np.percentile(lat, 50)), p99_ms=float(np.percentile(lat, 99)),
               watcher_history=history, exit=code,
               leaked_connections=m.get("leaked_connections"))
    say(f"registry run Q ({smi}): server up in {start_s!r} s; {len(responses)} responses, by "
        f"bank generation {counts} (3 = generation 1 reloaded), {len(degraded)} degraded, "
        f"{len(bad)} not ok, {len(differ)} undegraded scores differ from their generation's "
        f"batch score; publish to the first generation-2 response {promote_s!r} s; first "
        f"degraded response to generation 1 {t_back - t_deg!r} s; flip gaps s {gaps}; p50 / p99 "
        f"{out['p50_ms']!r} / {out['p99_ms']!r} ms; status registry {status.get('registry')}; "
        f"watcher history {history}; generation 2 quarantined {quarantined}; SIGTERM exit "
        f"{code}, leaked connections {m.get('leaked_connections')}")
    if bad or differ or not degraded or any(r["generation"] != 2 for r in degraded):
        fail(f"run Q: {len(bad)} responses not ok, {len(differ)} scores differ, or degraded "
             f"responses off generation 2; log: {log()}")
    if history != ["swap", "rollback"] or not quarantined or registry.lineage() != [1]:
        fail(f"run Q: the watcher did not promote then roll back: {history}, lineage "
             f"{registry.lineage()}")
    if code != 0 or m.get("leaked_connections") or set(counts) != {1, 2, 3}:
        fail(f"run Q: exit {code}, leaked {m.get('leaked_connections')}, generations {counts}")
    return out


def determinism_matrix(smi):
    """The twin-run matrix over the port's five artifact classes (each
    child under two PYTHONHASHSEEDs and time zones, on no card) and the
    positive control; -> its numbers."""
    from photon_ml_tpu_torch.testing.determinism import run_matrix, twin_run

    with tempfile.TemporaryDirectory(prefix="photon_determinism_") as tmp:
        report = run_matrix(f"{tmp}/matrix")
        control = twin_run("control_hash_order", base_dir=f"{tmp}/control")
    classes = report["classes"]
    say(f"determinism matrix ({smi}): "
        + ", ".join(f"{n} {'identical' if c['identical'] else 'DIVERGED ' + str(c['divergence'])}"
                    f" {c['runtime_s']!r} s" for n, c in sorted(classes.items()))
        + f"; control diverged {not control.identical} ({control.divergence}); "
        f"{report['runtime_s']!r} s in all")
    if not report["ok"] or len(classes) != 5 or control.identical:
        fail(f"determinism matrix: {report}, control identical {control.identical}")
    return {n: c["runtime_s"] for n, c in classes.items()}


def k4_entries(row_dot_launches, grid_row_dot):
    """The kernels line's K4 entries, one per wrapper: the Gram and the
    matvecs with their launches over run G and their times at its first
    bucket; row_dot (row_norm and row_dots with it) with its launches over
    the sequential path and its times at that path's bank, the batched
    path's launches and bank under ``grid_*``, its run G shapes under
    ``game_calls``."""
    check, game = K4_RESULTS["check"], K4_RESULTS["game_launches"]
    shape = check["gram"]["shape"]

    def entry(name, kernel, replaces, port_only, launches, fields, work, **extra):
        return {
            "name": name, "route": "cuda",
            "source": "photon_ml_tpu_torch/ops/csrc/entity_products.cu", "kernel": kernel,
            "replaces": replaces, "port_only": port_only, "launches": launches,
            **{k: fields[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms", "max_rel_err",
                                      "ordered_bitwise", "calls")},
            "work": work, **extra,
        }

    return [
        entry("entity_products.gram", "gram_kernel", "photon_ml_tpu/game/random_effect.py:271",
              "the JAX package's XLA product X_e @ X_e.T; no Pallas kernel", game["gram"],
              check["gram"], f"one Gram X X^T at run G's first bucket {shape}",
              phase15_launches=K4_RESULTS["phase15_launches"],
              bucket_witness=K4_RESULTS["witness"]),
        entry("entity_products.bmv", "tree_dot_kernel", "photon_ml_tpu/game/random_effect.py:288",
              "the JAX package's XLA matvecs X_e @ c, X_e.T @ r and G @ v (:222-337); no "
              "Pallas kernel", game["bmv"], check["bmv"],
              f"X c, X^T r and G r at run G's first bucket {shape}"),
        entry("entity_products.row_dot", "row_dot_kernel",
              "photon_ml_tpu/game/random_effect.py:274",
              "the JAX package's sums and vdots (the per-entity values at :274, the bank "
              "optimizers' member-wise dots and norms); no Pallas kernel", row_dot_launches,
              K4_RESULTS["row_dot_bank"],
              f"row_dot, row_norm and row_dots over the sequential path's bank [2, {DIM}]",
              grid_launches=grid_row_dot, grid_calls=K4_RESULTS["row_dot_grid_bank"]["calls"],
              game_launches=game["row_dot"], game_calls=check["row_dot"]["calls"],
              game_max_rel_err=check["row_dot"]["max_rel_err"]),
    ]


RE_UPDATE_CHILD_FLAG = "--re-update-child"
RE_UPDATE_REPEATS = 3  # timed calls a checkout, after one warm-up


def re_update_child(checkout, seed) -> int:
    """One checkout's side of ``--time-re-update``: its package (first on
    ``sys.path``) runs what run P times on the replicated path, on run G's
    user random-effect dataset (``game_data``: 100,000 users in buckets of
    25,000, the dense Newton solver) with a residual of normal(0, 0.3)
    noise from the seed as offsets: ``update_bank(..., with_variances=True)``
    from a zero bank, then ``score_random_effect``, on the host clock
    between two ``torch.cuda.synchronize()``; one warm-up, then
    RE_UPDATE_REPEATS timed calls, each with the Newton iterations' mean
    and max and the per-entity products kernel's launches where the
    checkout has it, and then that kernel's checks and times at the first
    bucket and its row dots and norms at the banks of phases 4 and 5 (the
    four-pair ``row_dots`` where the checkout has it). It calls only entry
    points that every checkout since the entity-sharded bank has."""
    sys.path.insert(0, os.path.abspath(checkout))
    import photon_ml_tpu_torch
    from photon_ml_tpu_torch.game import score_random_effect

    try:
        from photon_ml_tpu_torch.ops.kernels import entity_products as k4
    except ImportError:
        k4 = None
    if k4 is not None:
        from photon_ml_tpu_torch.ops.kernels.cuda_build import build_logs

        k4.build_kernel()
        # ptxas -v of each kernel: registers, shared memory, spills
        print(build_logs.get("entity_products.cu", ""), flush=True)
    _, red = game_data(seed, "cuda")
    rng = np.random.default_rng([seed, 16])
    # run G's rows have zero offsets; the residual is the seed's noise
    residual = rng.normal(size=red.row_entity_codes.shape[0]).astype(np.float32) * 0.3
    off = torch.as_tensor(residual, device="cuda")
    problem = pod_problem()
    print(f"re_update: {photon_ml_tpu_torch.__file__}; {red.num_entities} entities x "
          f"D = {red.local_dim} in {len(red.buckets)} buckets of "
          f"{[b.num_entities for b in red.buckets]} x {red.buckets[0].capacity} rows", flush=True)
    for i in range(RE_UPDATE_REPEATS + 1):
        if k4 is not None:
            k4.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bank, tracker, _ = problem.update_bank(
            torch.zeros(red.num_entities, red.local_dim, device="cuda"), red, off,
            with_variances=True)
        score_random_effect(bank, red)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        print(f"re_update {'warm-up' if i == 0 else 'call ' + str(i)}: {sec!r} s, "
              f"iterations mean {tracker.iterations_mean!r} max {tracker.iterations_max}, "
              f"K4 launches {'n/a' if k4 is None else k4.launches}", flush=True)
    if k4 is not None:
        # the kernel's products at the first bucket, beside torch.bmm, and
        # its row dots and norms at the sequential and batched paths' banks
        game_products_check(red, "this card", "cuda")
        k4_checks(f"banks [2, {DIM}] and [{GRID_G}, {DIM}] row_dot", row_dot_calls(
            rng, ((2, DIM), (GRID_G, DIM)), "cuda"), "this card")
    return 0


def time_re_update(checkouts, seed) -> int:
    """``--time-re-update``: run P's replicated random-effect update timed
    in each checkout in turn (``re_update_child``, one process each; give
    parent, change, change, parent to compare two), then the card's name
    and power limit."""
    for checkout in checkouts:
        rc = subprocess.call([sys.executable, os.path.abspath(__file__), RE_UPDATE_CHILD_FLAG,
                              checkout, str(seed)])
        if rc != 0:
            print(f"chip_smoke: the update in {checkout} exited {rc}", file=sys.stderr)
            return rc
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"re_update card: {out.stdout.strip()}")
    return 0


def main() -> int:
    if sys.argv[1:2] == [ROUTE_CHILD_FLAG]:
        return route_child(sys.argv[2])
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--time-re-update", nargs="+", metavar="CHECKOUT",
                    help="only time run P's replicated random-effect update in each "
                         "checkout in turn (e.g. parent, change, change, parent)")
    if sys.argv[1:2] == [RE_UPDATE_CHILD_FLAG]:
        args = None
    else:
        args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA card", file=sys.stderr)
        return 2
    if args is None:
        return re_update_child(sys.argv[2], int(sys.argv[3]))
    if args.time_re_update:
        return time_re_update(args.time_re_update, args.seed)

    from photon_ml_tpu_torch.data.batch import sparse_batch_from_arrays
    from photon_ml_tpu_torch.evaluation.metrics import area_under_roc_curve
    from photon_ml_tpu_torch.io import native_avro
    from photon_ml_tpu_torch.models.glm import compute_margins
    from photon_ml_tpu_torch.ops import losses
    from photon_ml_tpu_torch.ops import tiled_sparse as ts
    from photon_ml_tpu_torch.ops.kernels import bilinear_pass as k1
    from photon_ml_tpu_torch.ops.kernels import entity_products as k4
    from photon_ml_tpu_torch.ops.kernels import grid_bilinear_pass as k2
    from photon_ml_tpu_torch.ops.objective import GLMObjective
    from photon_ml_tpu_torch.optim import common
    from photon_ml_tpu_torch.optim.config import OptimizerType, RegularizationType
    from photon_ml_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, spawn_mesh
    from photon_ml_tpu_torch.task import TaskType
    from photon_ml_tpu_torch.training import (
        train_generalized_linear_model,
        train_grid_batched,
    )
    from photon_ml_tpu_torch.utils.device import gpu_name_and_power_limit

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # -- 1. device and builds --------------------------------------------------
    smi = gpu_name_and_power_limit()
    if smi is None:
        fail("nvidia-smi is not available")
    kind = torch.cuda.get_device_name(0)
    say(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    with ThreadPoolExecutor(5) as pool:  # three nvcc and two g++ side by side
        f_k1 = pool.submit(k1.build_kernel)
        f_k2 = pool.submit(k2.build_kernel)
        f_k4 = pool.submit(k4.build_kernel)
        f_native = pool.submit(ts._tile_lib)
        f_avro = pool.submit(native_avro.available)
        k1_build_s = f_k1.result()
        k2_build_s = f_k2.result()
        k4_build_s = f_k4.result()
        native_ok = bool(f_native.result())
        avro_ok = f_avro.result()
    say(f"build: bilinear_pass.cu {k1_build_s:.2f} s, grid_bilinear_pass.cu "
        f"{k2_build_s:.2f} s, entity_products.cu {k4_build_s:.2f} s (in parallel); "
        f"native schedule builder "
        f"{'ok' if native_ok else 'unavailable (numpy builder)'}; native Avro decoder "
        f"{'ok' if avro_ok else 'unavailable (Python codec)'}")

    rng = np.random.default_rng(args.seed)

    # -- 2a. K1 and K2 against plain at a small shape ---------------------------
    n_s, d_s = 3000, 5000
    rows = rng.integers(0, n_s, 40000)
    feats = rng.integers(0, d_s, 40000)
    feats[:6000] = d_s - 1  # heavy column: long, ragged tiles
    small = ts.build_tiled_batch(
        rows, feats, rng.normal(size=40000).astype(np.float32),
        np.zeros(n_s, np.float32), np.zeros(n_s, np.float32),
        np.ones(n_s, np.float32), d_s,
        params=ts.TileParams(s_hi=8, s_lo=8, chunk=32, spill_cap=8),
        device="cuda",
    )
    n_spill = int(torch.count_nonzero(small.z_sched.spill_vals))
    if n_spill == 0:
        fail("small shape did not spill")
    say(f"small shape: {n_s} x {d_s}, window 64, chunk 32, {n_spill} spills")
    small_err = compare_passes(k1, small, rng, "small")
    k2_errs = [compare_grid_passes(k1, k2, small, rng, "small", G) for G in EDGE_GS]

    # -- 2b. the work plan's edge cases -------------------------------------------
    edge_err = edge_checks(k1, k2, args.seed)
    k2_errs.append(edge_err["k2"])

    # -- main-path data at the ads shape ----------------------------------------
    t0 = time.perf_counter()
    (idx, vals, labels), (h_idx, h_vals, h_labels) = ads_data(args.seed)
    say(f"data: {N_ROWS} x {NNZ_PER_ROW} nnz x {DIM} features "
        f"({N_ROWS * NNZ_PER_ROW} entries), made in "
        f"{time.perf_counter() - t0:.2f} s; positive rate {labels.mean():.4f}")
    ones = np.ones(N_ROWS, np.float32)
    zeros = np.zeros(N_ROWS, np.float32)
    t0 = time.perf_counter()
    tb = ts.build_tiled_batch(
        np.repeat(np.arange(N_ROWS, dtype=np.int64), NNZ_PER_ROW),
        idx.reshape(-1), vals.reshape(-1), labels, zeros, ones, DIM,
        device="cuda",
    )
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    say(f"schedule: built by {tb.builder} in {build_s:.2f} s; window "
        f"{tb.params.window}, chunk {tb.params.chunk}, z steps "
        f"{tb.z_sched.num_steps}, g steps {tb.g_sched.num_steps}, "
        f"{tb.num_row_blocks} row blocks, {tb.num_feat_blocks} feature blocks, "
        f"z spills {int(torch.count_nonzero(tb.z_sched.spill_vals))}")
    train = sparse_batch_from_arrays(idx, vals, labels, zeros, ones, device="cuda")
    held_out = sparse_batch_from_arrays(
        h_idx, h_vals, h_labels, np.zeros(N_HELD_OUT, np.float32),
        np.ones(N_HELD_OUT, np.float32), device="cuda",
    )

    # -- 2c. K1 and K2 against plain at the ads shape ---------------------------
    ads_err = compare_passes(k1, tb, rng, "ads")
    repeat_checks(k1, k2, small, rng, "small")
    repeat_checks(k1, k2, tb, rng, "ads")
    k3_err = tuple(map(max, fold_checks(k1, k2, small, rng, "small"),
                       fold_checks(k1, k2, tb, rng, "ads")))
    k2_errs.append(
        compare_grid_passes(k1, k2, tb, rng, "ads", GRID_G, against_k1=True)
    )
    k2_err = tuple(map(max, *k2_errs))

    # -- 3. times at the ads shape ----------------------------------------------
    win = tb.params.window
    G = GRID_G
    w = torch.as_tensor(rng.normal(size=tb.dim).astype(np.float32), device="cuda")
    c = torch.as_tensor(rng.normal(size=tb.num_rows).astype(np.float32), device="cuda")
    w_bank = torch.as_tensor(rng.normal(size=(G, tb.dim)).astype(np.float32), device="cuda")
    c_bank = torch.as_tensor(rng.normal(size=(G, tb.num_rows)).astype(np.float32), device="cuda")
    z_args = (tb.z_sched, w, tb.num_row_blocks, win)
    g_args = (tb.g_sched, c, tb.num_feat_blocks, win)
    zb_args = (tb.z_sched, w_bank, tb.num_row_blocks, win)
    gb_args = (tb.g_sched, c_bank, tb.num_feat_blocks, win)

    coo = torch.stack([
        torch.arange(N_ROWS, device="cuda").repeat_interleave(NNZ_PER_ROW),
        torch.as_tensor(idx.reshape(-1), device="cuda"),
    ])
    x_vals = torch.as_tensor(vals.reshape(-1), device="cuda")
    x_csr = torch.sparse_coo_tensor(coo, x_vals, (tb.num_rows, tb.dim)).coalesce().to_sparse_csr()
    xt_csr = torch.sparse_coo_tensor(coo.flip(0), x_vals, (tb.dim, tb.num_rows)).coalesce().to_sparse_csr()
    del coo, x_vals
    k1_times, k2_times = {}, {}
    for table, name, fn in (
        (k1_times, "z_ms", lambda: k1.bilinear_pass(*z_args)),
        (k1_times, "g_ms", lambda: k1.bilinear_pass(*g_args)),
        (k1_times, "z_plain_ms", lambda: k1.bilinear_pass_plain(*z_args)),
        (k1_times, "g_plain_ms", lambda: k1.bilinear_pass_plain(*g_args)),
        (k1_times, "z_library_ms", lambda: x_csr @ w[:, None]),
        (k1_times, "g_library_ms", lambda: xt_csr @ c[:, None]),
        (k1_times, "z_ms_again", lambda: k1.bilinear_pass(*z_args)),
        (k1_times, "g_ms_again", lambda: k1.bilinear_pass(*g_args)),
        (k2_times, "z_ms", lambda: k2.grid_bilinear_pass(*zb_args)),
        (k2_times, "g_ms", lambda: k2.grid_bilinear_pass(*gb_args)),
        (k2_times, "z_plain_ms", lambda: k2.grid_bilinear_pass_plain(*zb_args)),
        (k2_times, "g_plain_ms", lambda: k2.grid_bilinear_pass_plain(*gb_args)),
        (k2_times, "z_library_ms", lambda: x_csr @ w_bank.T),
        (k2_times, "g_library_ms", lambda: xt_csr @ c_bank.T),
        (k2_times, "z_k1_x_G_ms", lambda: [
            k1.bilinear_pass(tb.z_sched, w_bank[g], tb.num_row_blocks, win)
            for g in range(G)
        ]),
        (k2_times, "g_k1_x_G_ms", lambda: [
            k1.bilinear_pass(tb.g_sched, c_bank[g], tb.num_feat_blocks, win)
            for g in range(G)
        ]),
        (k2_times, "z_ms_again", lambda: k2.grid_bilinear_pass(*zb_args)),
        (k2_times, "g_ms_again", lambda: k2.grid_bilinear_pass(*gb_args)),
    ):
        table[name] = time_ms(fn)
    del x_csr, xt_csr
    z_bound, z_bytes, z_entries = pass_bound_ms(tb.z_sched, tb.dim, tb.num_rows)
    g_bound, g_bytes, g_entries = pass_bound_ms(tb.g_sched, tb.num_rows, tb.dim)
    say(f"k1_times ({smi}): " + " ".join(f"{k}={v!r}" for k, v in k1_times.items())
        + f" z_bound_ms={z_bound!r} g_bound_ms={g_bound!r} "
        f"z_entries={z_entries} g_entries={g_entries} "
        f"z_bytes={z_bytes} g_bytes={g_bytes}")
    zb_bound, zb_bytes, _ = pass_bound_ms(tb.z_sched, tb.dim, tb.num_rows, G)
    gb_bound, gb_bytes, _ = pass_bound_ms(tb.g_sched, tb.num_rows, tb.dim, G)
    say(f"k2_times G={G} ({smi}): "
        + " ".join(f"{k}={v!r}" for k, v in k2_times.items())
        + f" z_bound_ms={zb_bound!r} g_bound_ms={gb_bound!r} "
        f"z_bytes={zb_bytes} g_bytes={gb_bytes}")
    ads_plans = pass_plans(k1, k2, tb, G)
    for key, bound, ms in (
        ("k1_z", z_bound, k1_times["z_ms"]), ("k1_g", g_bound, k1_times["g_ms"]),
        ("k2_z", zb_bound, k2_times["z_ms"]), ("k2_g", gb_bound, k2_times["g_ms"]),
    ):
        plan_line(f"plan ads {key}", ads_plans[key], bound, ms)

    # K3, the spill remainder, folded into K1 and K2: each pass with and
    # without it, in turns, beside index_add_ of the spilled products (the
    # plain version's call on the card, and the one PyTorch call for the
    # same function, so its time is the library's too)
    spill_w = tb.z_sched.spill_vals * w[tb.z_sched.spill_in]
    spill_c = tb.g_sched.spill_vals * c[tb.g_sched.spill_in]
    z_out = torch.zeros(tb.num_rows, device="cuda")
    g_out = torch.zeros(tb.dim, device="cuda")
    k3_times = {}
    for name, fn in (
        ("z_ms", lambda: k1.bilinear_pass(*z_args)),
        ("z_fused_ms", lambda: k1.bilinear_pass(*z_args, spill=True)),
        ("z_fused_ms_again", lambda: k1.bilinear_pass(*z_args, spill=True)),
        ("z_ms_again", lambda: k1.bilinear_pass(*z_args)),
        ("g_ms", lambda: k1.bilinear_pass(*g_args)),
        ("g_fused_ms", lambda: k1.bilinear_pass(*g_args, spill=True)),
        ("g_fused_ms_again", lambda: k1.bilinear_pass(*g_args, spill=True)),
        ("g_ms_again", lambda: k1.bilinear_pass(*g_args)),
        ("bank_z_ms", lambda: k2.grid_bilinear_pass(*zb_args)),
        ("bank_z_fused_ms", lambda: k2.grid_bilinear_pass(*zb_args, spill=True)),
        ("bank_g_ms", lambda: k2.grid_bilinear_pass(*gb_args)),
        ("bank_g_fused_ms", lambda: k2.grid_bilinear_pass(*gb_args, spill=True)),
        ("z_index_add_ms", lambda: z_out.index_add_(0, tb.z_sched.spill_out, spill_w)),
        ("g_index_add_ms", lambda: g_out.index_add_(0, tb.g_sched.spill_out, spill_c)),
    ):
        k3_times[name] = time_ms(fn)
    k3_added = {p: (k3_times[f"{p}_fused_ms"] + k3_times[f"{p}_fused_ms_again"]
                    - k3_times[f"{p}_ms"] - k3_times[f"{p}_ms_again"]) / 2 for p in ("z", "g")}
    k3_bound, k3_bytes, k3_spills = spill_bound_ms(tb.z_sched)
    k3g_bound, _, k3g_spills = spill_bound_ms(tb.g_sched)
    k3b_bound, k3b_bytes, _ = spill_bound_ms(tb.z_sched, G)
    say(f"k3_times folded into K1/K2 ({smi}): z spills={k3_spills} g spills={k3g_spills} "
        + " ".join(f"{k}={v!r}" for k, v in k3_times.items())
        + f" z_added_ms={k3_added['z']!r} g_added_ms={k3_added['g']!r}"
        f" z_bound_ms={k3_bound!r} g_bound_ms={k3g_bound!r} bank_z_bound_ms={k3b_bound!r}"
        f" z_bytes={k3_bytes} bank_z_bytes={k3b_bytes}")
    del w_bank, c_bank, z_out, g_out, spill_w, spill_c

    def member_checks(label, model, result, variances_expected):
        """Fail unless the objective fell, coefficients, scores and
        variances are finite, variances positive and the AUCs above the
        thresholds for planted data."""
        means = model.coefficients.means
        train_auc = float(area_under_roc_curve(
            compute_margins(means, train), train.labels, train.weights))
        held_margins = compute_margins(means, held_out)
        held_auc = float(area_under_roc_curve(
            held_margins, held_out.labels, held_out.weights))
        f_first, f_last = float(result.tracker.values[0]), float(result.value)
        say(f"fit {label}: iterations={result.iterations} "
            f"reason={result.reason_name} objective {f_first!r} -> {f_last!r} "
            f"train_auc={train_auc!r} held_out_auc={held_auc!r}")
        if not f_last < f_first:
            fail(f"{label}: the objective did not fall")
        if not bool(torch.isfinite(means).all()) or not bool(
            torch.isfinite(held_margins).all()
        ):
            fail(f"{label}: non-finite coefficients or scores")
        if not (train_auc > 0.75 and held_auc > 0.55):
            fail(f"{label}: AUC too low for planted data")
        variances = model.coefficients.variances
        if variances_expected and (
            variances is None
            or not bool(torch.isfinite(variances).all())
            or not bool((variances > 0).all())
        ):
            fail(f"{label}: variances missing, non-finite or not positive")

    # -- 4. sequential path at full width ---------------------------------------
    k1.launches = 0
    k2.launches = 0
    k4.reset_launches()
    k1.spill_launches = k2.spill_launches = 0
    common.host_fetches = 0
    t0 = time.perf_counter()
    models, results = train_generalized_linear_model(
        tb, TaskType.LOGISTIC_REGRESSION, DIM,
        optimizer_type=OptimizerType.LBFGS,
        regularization_type=RegularizationType.L2,
        regularization_weights=[10.0, 1.0], max_iter=10,
        compute_variances=True, kernel="tiled", device="cuda",
    )
    torch.cuda.synchronize()
    lbfgs_s = time.perf_counter() - t0
    lbfgs_launches, lbfgs_fetches = k1.launches, common.host_fetches
    t0 = time.perf_counter()
    tron_models, tron_results = train_generalized_linear_model(
        tb, TaskType.LOGISTIC_REGRESSION, DIM,
        optimizer_type=OptimizerType.TRON,
        regularization_type=RegularizationType.L2,
        regularization_weights=[1.0], max_iter=3, kernel="tiled",
        device="cuda",
    )
    torch.cuda.synchronize()
    tron_s = time.perf_counter() - t0
    launches, fetches, seq_k2 = k1.launches, common.host_fetches, k2.launches
    k4_launches = k4.launches_by["row_dot"]
    k3_launches = k1.spill_launches + k2.spill_launches
    if k4_launches == 0:
        fail("the sequential path never called K4 (the optimizers' member-wise dots)")
    if k3_launches == 0:
        fail("the sequential path carried no spill remainder (K3) in its passes")
    say(f"sequential_path K4 row_dot launches {k4_launches} (all K4 {k4.launches}); passes "
        f"carrying the spill remainder (K3 folded into K1) {k3_launches}")
    # K4's row kernel at the bank's shape: the lambda grid's two members
    # over DIM features
    K4_RESULTS["row_dot_bank"] = k4_checks(
        f"sequential path bank [2, {DIM}] row_dot",
        row_dot_calls(np.random.default_rng([args.seed, 16]), ((2, DIM),), "cuda"), smi)
    say(f"sequential_path: lbfgs grid {lbfgs_s:.3f} s ({lbfgs_launches} K1 "
        f"launches, {lbfgs_fetches} host fetches, iterations "
        f"{[results[lam].iterations for lam in models]}); tron {tron_s:.3f} s "
        f"({launches - lbfgs_launches} K1 launches, "
        f"{fetches - lbfgs_fetches} host fetches, iterations "
        f"{tron_results[1.0].iterations}); K1 launches {launches}, K2 "
        f"launches {seq_k2}, host fetches {fetches}")
    if launches == 0:
        fail("the sequential path never launched K1")
    if seq_k2:
        fail("the sequential path launched K2")
    for lam in models:
        member_checks(f"lbfgs lambda={lam}", models[lam], results[lam], True)
    member_checks("tron lambda=1.0", tron_models[1.0], tron_results[1.0], False)

    # the tiled CUDA objective at the fitted point against the scatter
    # objective (plain PyTorch gather/scatter) on the same rows; at l2 = 0,
    # so the data gradient X^T c is not cancelled by the l2 term
    coef = models[1.0].coefficients.means
    tiled_obj = ts.TiledGLMObjective(losses.LOGISTIC, DIM)
    v_t, g_t = tiled_obj.value_and_gradient(coef, tb, 0.0)
    v_s, g_s = GLMObjective(losses.LOGISTIC, DIM).value_and_gradient(coef, train, 0.0)
    v_err = abs(float(v_t) - float(v_s)) / abs(float(v_s))
    g_err = float((g_t - g_s).abs().max() / g_s.abs().max())
    say(f"objective check: tiled vs scatter value rel err {v_err!r}, "
        f"gradient rel err {g_err!r}")
    if not (v_err < 1e-5 and g_err < RTOL):
        fail("tiled objective disagrees with the scatter objective")

    # -- 5. batched grid path at full width -------------------------------------
    lbfgs_grid = dict(
        optimizer_type=OptimizerType.LBFGS,
        regularization_type=RegularizationType.L2,
        regularization_weights=GRID_LAMBDAS, max_iter=10,
        compute_variances=True, kernel="tiled", device="cuda",
    )

    def counted(fn):
        """Run ``fn`` with every count at 0; -> (its result, host seconds
        to a synchronised end, K1 launches, K2 launches, host fetches); K4's
        row launches and the passes that carried the spill remainder land
        in ``grid_counts``."""
        k1.launches = 0
        k2.launches = 0
        k4.reset_launches()
        k1.spill_launches = k2.spill_launches = 0
        common.host_fetches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        grid_counts.update(row_dot=k4.launches_by["row_dot"],
                           spill=k1.spill_launches + k2.spill_launches)
        return (out, time.perf_counter() - t0, k1.launches, k2.launches,
                common.host_fetches)

    grid_counts = {}

    grid_runs = {}
    for label, kw in (
        ("lbfgs", lbfgs_grid),
        ("tron", dict(
            optimizer_type=OptimizerType.TRON,
            regularization_type=RegularizationType.L2,
            regularization_weights=[10.0, 1.0], max_iter=3,
            kernel="tiled", device="cuda",
        )),
        ("owlqn", dict(
            optimizer_type=OptimizerType.LBFGS,
            regularization_type=RegularizationType.ELASTIC_NET,
            elastic_net_alpha=0.5, regularization_weights=[1.0, 0.1],
            max_iter=5, kernel="tiled", device="cuda",
        )),
    ):
        (g_models, g_results), seconds, n_k1, n_k2, n_fetch = counted(
            lambda: train_grid_batched(tb, TaskType.LOGISTIC_REGRESSION, DIM, **kw)
        )
        run = dict(
            seconds=seconds, k1=n_k1, k2=n_k2, fetches=n_fetch,
            models=g_models, results=g_results, k4_row_dot=grid_counts["row_dot"],
            k3_folded=grid_counts["spill"],
        )
        grid_runs[label] = run
        say(f"grid_path {label}: {seconds:.3f} s, {run['k2']} K2 launches, "
            f"{run['k1']} K1 launches, {run['fetches']} host fetches, K4 row_dot launches "
            f"{run['k4_row_dot']}, passes carrying the spill {run['k3_folded']}; "
            "members " + ", ".join(
                f"lambda={lam}: {r.iterations} it {r.reason_name}"
                for lam, r in g_results.items()
            ))
        if run["k1"]:
            fail(f"grid {label}: K1 launched during a grid fit")
        if run["k2"] == 0:
            fail(f"grid {label}: K2 never launched")
        for lam in g_models:
            member_checks(
                f"grid {label} lambda={lam}", g_models[lam], g_results[lam],
                "compute_variances" in kw,
            )
    grid_row_dot = sum(run["k4_row_dot"] for run in grid_runs.values())
    say(f"grid_path K4 row_dot launches {grid_row_dot} over the three grids")
    # K4's row kernel at the batched grid's bank: four members over DIM
    K4_RESULTS["row_dot_grid_bank"] = k4_checks(
        f"batched path bank [{GRID_G}, {DIM}] row_dot",
        row_dot_calls(np.random.default_rng([args.seed, 17]), ((GRID_G, DIM),), "cuda"), smi)
    owl_means = grid_runs["owlqn"]["models"][1.0].coefficients.means
    owl_zeros = int((owl_means == 0.0).sum())
    say(f"grid owlqn lambda=1.0: {owl_zeros} exact zeros of {DIM}")
    if owl_zeros == 0:
        fail("the OWL-QN member at lambda=1 has no exact zeros")

    # equivalence: the bank objective (K2) and K1's objective agree at
    # every L-BFGS member's final point, at l2 = 0
    lbfgs_models = grid_runs["lbfgs"]["models"]
    bank = torch.stack([lbfgs_models[lam].coefficients.means for lam in GRID_LAMBDAS])
    v_bank, g_bank = tiled_obj.value_and_gradient(
        bank, tb, torch.zeros(len(GRID_LAMBDAS), device="cuda")
    )
    for i, lam in enumerate(GRID_LAMBDAS):
        v_one, g_one = tiled_obj.value_and_gradient(bank[i], tb, 0.0)
        v_rel = abs(float(v_bank[i]) - float(v_one)) / abs(float(v_one))
        say(f"equivalence lambda={lam}: value rel err {v_rel!r}")
        if v_rel > RTOL:
            fail(f"bank objective value disagrees with K1's at lambda={lam}")
        check_close(f"equivalence lambda={lam} gradient", g_bank[i], g_one)

    # information, gated loosely: each L-BFGS member against a cold
    # sequential fit of its lambda (K2 and K1 sum in other orders, which
    # can move line-search branch points, so the two need not agree to
    # rounding)
    grid_results = grid_runs["lbfgs"]["results"]
    cold_s = 0.0
    for lam in GRID_LAMBDAS:
        (_, cold), seconds, _, _, _ = counted(lambda: train_generalized_linear_model(
            tb, TaskType.LOGISTIC_REGRESSION, DIM,
            **{**lbfgs_grid, "regularization_weights": [lam]},
        ))
        cold_s += seconds
        f_grid, f_cold = float(grid_results[lam].value), float(cold[lam].value)
        rel = abs(f_grid - f_cold) / abs(f_cold)
        say(f"grid vs cold sequential lambda={lam}: objective {f_grid!r} vs "
            f"{f_cold!r} (rel {rel!r}), iterations "
            f"{grid_results[lam].iterations} vs {cold[lam].iterations}, "
            f"cold fit {seconds!r} s")
        if rel > 1e-2:
            fail(f"grid member lambda={lam} far from its cold sequential fit")

    # end to end: the batched L-BFGS grid against the warm-started
    # sequential grid (the other path resolve_grid_mode can pick) over the
    # same lambdas and budget, in turns, both after the first fit's warm-up
    for label, trainer in (
        ("batched", train_grid_batched),
        ("sequential", train_generalized_linear_model),
        ("sequential", train_generalized_linear_model),
        ("batched", train_grid_batched),
    ):
        (_, res), seconds, n_k1, n_k2, n_fetch = counted(
            lambda: trainer(tb, TaskType.LOGISTIC_REGRESSION, DIM, **lbfgs_grid)
        )
        say(f"grid_end_to_end {label}: {seconds!r} s over {len(GRID_LAMBDAS)} "
            f"lambdas, iterations {[res[lam].iterations for lam in GRID_LAMBDAS]}, "
            f"{n_k1} K1 launches, {n_k2} K2 launches, {n_fetch} host fetches "
            f"({smi})")
    say(f"grid_end_to_end cold sequential fits: {cold_s!r} s in all")

    # where the two grids' time goes: the device's busy and idle shares
    from photon_ml_tpu_torch.tools.profile_grid import profile_fits

    profile_fits(tb, DIM, lbfgs_grid, say=say)

    # the per-member offsets of run_grid on K2, at the mesh cell's shape
    offsets_bank_k2, offsets_bank_err = offsets_bank_check(idx, vals, labels, k1, k2, rng, smi)

    # -- 6. the mesh path -------------------------------------------------------
    say(f"mesh: {MESH_SHAPE} (data, model) ranks on ONE card ({smi}); they "
        "time-slice its SMs and gloo stages every collective through the "
        "host: this checks the path and counts it, it measures no scaling")
    w_eval = (rng.normal(size=DIM) * 0.05).astype(np.float32)
    v_one, g_one = tiled_obj.value_and_gradient(
        torch.as_tensor(w_eval, device="cuda"), tb, 0.0
    )
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="photon_mesh_cells_") as mesh_cache:
        try:
            ranks = spawn_mesh(
                mesh_rank, MESH_SHAPE, (DATA_AXIS, MODEL_AXIS),
                args=(args.seed, w_eval, mesh_cache), timeout_s=MESH_TIMEOUT_S,
            )
        except (RuntimeError, TimeoutError) as e:
            fail(f"mesh phase: {e}")
    mesh_s = time.perf_counter() - t0
    cell_errs = {"k1": (0.0, 0.0), "k2": (0.0, 0.0)}
    for r in ranks:
        say(f"mesh rank {r['rank']} {r['coords']}: cell " + " ".join(
            f"{k}={v!r}" for k, v in r["cell"].items())
            + f"; K1 and K2, the spill folded in, bitwise on two launches "
            f"({r['repeat_pairs']} pairs)")
        for name, err, scale, over in r["checks"]:
            say(f"mesh_check rank {r['rank']} {name}: max_abs_err={err!r} "
                f"max_rel_err={err / max(scale, 1e-30)!r} scale={scale!r}; outputs over "
                f"1e-6 + {RTOL!r} x their addends' magnitude: {over}")
            if not np.isfinite(err) or over:
                fail(f"mesh rank {r['rank']}: {name} disagrees with its plain version")
            key = name[:2]
            cell_errs[key] = tuple(map(max, cell_errs[key], (err, err / max(scale, 1e-30))))
    cell = ranks[0]["times"]
    say(f"mesh_cell_times rank 0, {cell['entries']} entries ({smi}): " + " ".join(
        f"{k}={v!r}" for k, v in cell.items() if k not in ("entries", "plans")))
    for key in ("k1_z", "k1_g", "k2_z", "k2_g"):
        plan_line(f"plan cell {key} (warm; L2 flushed "
                  f"{cell[key + '_l2_flushed_ms']!r} ms)", cell["plans"][key],
                  cell[key + "_bound_ms"], cell[key + "_ms"])
    v_err = abs(ranks[0]["objective"][0] - float(v_one)) / abs(float(v_one))
    g_mesh = torch.as_tensor(ranks[0]["objective"][1], device="cuda")
    g_err = float((g_mesh - g_one).abs().max() / g_one.abs().max())
    say(f"mesh_collective_us rank 0, {MESH_SHAPE} gloo on one card ({smi}): "
        + " ".join(f"{k}={v!r}" for k, v in ranks[0]["collective_us"].items()))
    say(f"mesh objective vs single card at a random w, l2 = 0: value rel err "
        f"{v_err!r}, gradient err {g_err!r} of its scale")
    if not (v_err < RTOL and g_err < RTOL):
        fail("the mesh objective disagrees with the single-card objective")
    single = {
        "lbfgs": results, "tron": tron_results, "tron_cache_cold": tron_results,
        "tron_cache_warm": tron_results,
        "grid": grid_runs["lbfgs"]["results"], "data_parallel": results,
    }
    kernel_of = {"lbfgs": "k1", "tron": "k1", "tron_cache_cold": "k1",
                 "tron_cache_warm": "k1", "grid": "k2", "data_parallel": "k1"}
    mesh_launches = {"k1": 0, "k2": 0}
    for label, ref in single.items():
        runs = [r[label] for r in ranks]
        for r, run in zip(ranks, runs):
            say(f"mesh_path {label} rank {r['rank']}: {run['seconds']!r} s, "
                f"{run['k1']} K1 launches, {run['k2']} K2 launches, "
                f"{run['fetches']} host fetches, {run['collectives']} collectives")
            other = "k2" if kernel_of[label] == "k1" else "k1"
            if run[kernel_of[label]] == 0 or run[other]:
                fail(f"mesh {label} rank {r['rank']}: launched "
                     f"{run['k1']} K1 and {run['k2']} K2")
            mesh_launches[kernel_of[label]] += run[kernel_of[label]]
        for lam, fit in runs[0]["fits"].items():
            f_one = float(ref[lam].value)
            rel = abs(fit["value"] - f_one) / abs(f_one)
            say(f"mesh_fit {label} lambda={lam}: objective {fit['value']!r} vs "
                f"single card {f_one!r} (rel {rel!r}), iterations "
                f"{fit['iterations']} vs {ref[lam].iterations}, {fit['reason']}")
            if rel > 1e-3 or not fit["finite"]:
                fail(f"mesh {label} lambda={lam}: off the single-card fit, or "
                     "non-finite coefficients or variances")
            if any(run["fits"][lam] != fit for run in runs):
                fail(f"mesh {label} lambda={lam}: the ranks disagree")
            if "tracked" in fit and not (
                fit["tracked"] == fit["iterations"] + 1 and fit["last_is_final"]
            ):
                fail(f"mesh {label} lambda={lam}: {fit['tracked']} per-iteration "
                     f"models for {fit['iterations']} iterations")
    # the schedule cache on the mesh: every rank stores its cell cold and
    # loads it warm, and the warm fit is the cold one
    for r in ranks:
        cold, warm = r["tron_cache_cold"], r["tron_cache_warm"]
        say(f"mesh_cache rank {r['rank']} ({smi}): cold builds={cold['cache_builds']} "
            f"stores={cold['cache_stores']} {cold['seconds']!r} s; warm "
            f"hits={warm['cache_hits']} builds={warm['cache_builds']} "
            f"{warm['seconds']!r} s")
        if cold["cache_stores"] < 2 or warm["cache_hits"] < 2 or warm["cache_builds"]:
            fail(f"mesh rank {r['rank']}: the warm rerun did not load its cell "
                 "from the schedule cache")
        for lam, fit in warm["fits"].items():
            f_cold = cold["fits"][lam]["value"]
            if abs(fit["value"] - f_cold) > 1e-3 * abs(f_cold):
                fail(f"mesh rank {r['rank']}: the cached rerun's fit is off the cold one")
    say(f"mesh phase: {mesh_s!r} s of host time, spawn to the last rank's end")

    # -- 7. the GLM driver end to end -------------------------------------------
    t0 = time.perf_counter()
    driver_launches, run_a = driver_phase(args.seed, smi, k1, k2)
    say(f"driver phase: {time.perf_counter() - t0!r} s of host time ({smi})")
    try:
        # -- 8. GAME, with phase 11's run W and phase 12's run Y over run H's files --
        serving, fleet = {}, {}

        def run_w(tmp, shards, scorer):
            t0 = time.perf_counter()
            serving["W"] = serve_run_w(tmp, shards, smi)
            serving["W_s"] = time.perf_counter() - t0
            say(f"phase 11 run W: {serving['W_s']!r} s of host time ({smi})")
            # phase 12's run Y goes over these files, phase 14's GAME
            # driver too (beside run H's objective history)
            fleet["dir"] = fleet_y_files(tmp)
            fleet["shards"] = shards
            with open(f"{tmp}/out/metrics.json") as f:
                fleet["h_history"] = json.load(f)["objective_history"]

        game_launches, game_k1, game_ds = game_phase(args.seed, smi, k1, then=run_w)

        # -- 9. factored RE, MF, checkpoints and the kill -9 resume --------------
        t0 = time.perf_counter()
        phase9_launches = reliability_phase(args.seed, smi, k1, k2, game_ds, run_a)
        say(f"phase 9: {time.perf_counter() - t0!r} s of host time ({smi})")
        del game_ds
    finally:
        shutil.rmtree(run_a["tmp"], ignore_errors=True)

    # -- 10. out-of-core training, and 14 over run S's files --------------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    phase14 = {}

    def multiprocess_phase(train_dir, tmp, imap, batch, f_s1):
        # -- 14. GAME's fixed effect over meshes, multi-process streaming --
        t1 = time.perf_counter()
        procs, outs = p14_stream_start(train_dir, tmp)
        f_chain, f_runs, f_outs, f_dir, f_cache = p14_feature_start(train_dir, tmp)
        g_procs, g_outs = p14_game_start(fleet["dir"], fleet["shards"], tmp)
        try:
            phase14["meshes"] = p14_meshes(args.seed, smi)
        except BaseException:
            for p in procs + p14_feature_procs_all(f_runs) + g_procs:
                p.kill()
            raise
        phase14["stream"] = p14_stream_finish(procs, outs, imap, batch, f_s1, smi)
        phase14["feature"] = p14_feature_finish(f_chain, f_runs, f_outs, f_dir, f_cache, smi)
        phase14["game"] = p14_game_finish(g_procs, g_outs, fleet["h_history"], smi)
        phase14["seconds"] = time.perf_counter() - t1
        say(f"phase 14: {phase14['seconds']!r} s of host time ({smi})")

    phase10_k1, phase10_k2, stream_chunk = stream_phase(
        args.seed, smi, k1, k2, then=multiprocess_phase)
    say(f"phase 10: {time.perf_counter() - t0 - phase14['seconds']!r} s of host time ({smi}) "
        f"(phase 14's {phase14['seconds']!r} s apart)")
    say("multiprocess: " + json.dumps(phase14))

    # -- 11. online serving (run W ran inside run H's directory) -----------------
    t0 = time.perf_counter()
    serving["V"] = serve_run_v(args.seed, smi)
    say(f"phase 11 run V: {time.perf_counter() - t0!r} s of host time ({smi}); phase 11 "
        f"in all {time.perf_counter() - t0 + serving['W_s']!r} s")
    say("serving: " + json.dumps(serving))

    # -- 12. the serving fleet ----------------------------------------------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    y_dir = fleet.pop("dir")
    shards = fleet.pop("shards")
    try:
        fleet["Y"] = fleet_run_y(y_dir, shards, smi, serving["W"]["widths"])
    except BaseException:
        shutil.rmtree(y_dir, ignore_errors=True)
        raise
    say(f"phase 12 run Y: {time.perf_counter() - t0!r} s of host time ({smi})")
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="photon_fleet_x_") as x_tmp:
        x_fleets, x_t0 = fleet_x_spawn(args.seed, x_tmp)
        try:
            fleet["X"] = fleet_run_x(args.seed, smi, x_fleets, x_t0)
        finally:
            fleet_stop(x_fleets)
    say(f"phase 12 run X: {time.perf_counter() - t1!r} s of host time ({smi})")
    say(f"phase 12: {time.perf_counter() - t0!r} s of host time ({smi})")
    say("fleet: " + json.dumps(fleet))

    # -- 15. the entity-sharded random effect and the unified mesh, over run
    # G's inputs, run T's objectives and run H's files (before run Q adds a
    # part to them) ------------------------------------------------------------
    try:
        torch.cuda.empty_cache()
        phase15_k1, phase15 = pod_phase(args.seed, smi, k1, y_dir, shards, fleet["h_history"])
        say("pod: " + json.dumps(phase15))
    except BaseException:
        shutil.rmtree(y_dir, ignore_errors=True)
        raise

    # -- 13. the model registry, the retrain loop, the determinism harness --------
    t0 = time.perf_counter()
    registry = {}
    try:
        # run Q's server boots while run L runs
        q_server = registry_q_server(y_dir, shards, serving["W"]["widths"])
        try:
            phase13_k1 = retrain_run_l(args.seed, smi, k1)
            registry["L_s"] = time.perf_counter() - t0
            say(f"phase 13 run L: {registry['L_s']!r} s of host time ({smi}), beside run Q's "
                "server start")
            t1 = time.perf_counter()
            registry["Q"] = registry_run_q(y_dir, shards, smi, args.seed, q_server)
            registry["Q_s"] = time.perf_counter() - t1
        finally:
            if q_server[0].poll() is None:
                q_server[0].kill()
                q_server[0].wait()
        say(f"phase 13 run Q: {registry['Q_s']!r} s of host time ({smi})")
    finally:
        shutil.rmtree(y_dir, ignore_errors=True)
    t1 = time.perf_counter()
    registry["determinism"] = determinism_matrix(smi)
    registry["determinism_s"] = time.perf_counter() - t1
    say(f"phase 13: {time.perf_counter() - t0!r} s of host time ({smi})")
    say("registry: " + json.dumps(registry))

    # -- 16. result lines -------------------------------------------------------
    grid_k2 = sum(run["k2"] for run in grid_runs.values())
    kernels = [{
        "name": "bilinear_pass",
        "route": "cuda",
        "source": "photon_ml_tpu_torch/ops/csrc/bilinear_pass.cu",
        "replaces": "photon_ml_tpu/ops/tiled_sparse.py:1294",
        "launches": launches,
        "max_abs_err": max(small_err[0], ads_err[0], edge_err["k1"][0], game_k1["max_abs_err"],
                           stream_chunk["max_abs_err"]),
        "ms": k1_times["z_ms"] + k1_times["g_ms"],
        "plain_ms": k1_times["z_plain_ms"] + k1_times["g_plain_ms"],
        "bound_ms": z_bound + g_bound,
        "bound_by": "bytes",
        "library_ms": k1_times["z_library_ms"] + k1_times["g_library_ms"],
        "work": "one z-pass + one g-pass at the ads shape",
        "z_ms": k1_times["z_ms"], "g_ms": k1_times["g_ms"],
        "z_bound_ms": z_bound, "g_bound_ms": g_bound,
        "max_rel_err": max(small_err[1], ads_err[1], edge_err["k1"][1]),
        **mesh_fields("k1", mesh_launches, cell, cell_errs),
        "driver_launches": {run: n["k1"] for run, n in driver_launches.items()},
        "driver_diagnose_launches": driver_launches["D"]["diagnose_k1"],
        "game_launches": game_launches,
        "game_shape": game_k1,
        "phase9_launches": {run: n["k1"] for run, n in phase9_launches.items()},
        "phase10_launches": phase10_k1,
        "phase13_launches": phase13_k1,
        "phase15_launches": phase15_k1,
        "phase14_surface_launches": {
            k: v["k1"] for k, v in phase14["meshes"]["surface"].items() if "k1" in v
        },
        "stream_chunk": stream_chunk,
    }, {
        "name": "grid_bilinear_pass",
        "route": "cuda",
        "source": "photon_ml_tpu_torch/ops/csrc/grid_bilinear_pass.cu",
        "replaces": "photon_ml_tpu/ops/tiled_sparse.py:1509",
        "launches": grid_k2,
        "G": G,
        "max_abs_err": max(k2_err[0], offsets_bank_err[0]),
        "ms": k2_times["z_ms"] + k2_times["g_ms"],
        "plain_ms": k2_times["z_plain_ms"] + k2_times["g_plain_ms"],
        "bound_ms": zb_bound + gb_bound,
        "bound_by": "bytes",
        "library_ms": k2_times["z_library_ms"] + k2_times["g_library_ms"],
        "k1_x_G_ms": k2_times["z_k1_x_G_ms"] + k2_times["g_k1_x_G_ms"],
        "work": f"one z-pass + one g-pass over a bank of {G} at the ads shape",
        "z_ms": k2_times["z_ms"], "g_ms": k2_times["g_ms"],
        "z_bound_ms": zb_bound, "g_bound_ms": gb_bound,
        "max_rel_err": k2_err[1],
        **mesh_fields("k2", mesh_launches, cell, cell_errs),
        "driver_launches": {run: n["k2"] for run, n in driver_launches.items()},
        "phase9_launches": {run: n["k2"] for run, n in phase9_launches.items()},
        "phase10_launches": phase10_k2,
        "offsets_bank_launches": offsets_bank_k2,
        "offsets_bank_max_abs_err": offsets_bank_err[0],
    }, {
        "name": "apply_spill",
        "route": "cuda",
        "source": "photon_ml_tpu_torch/ops/csrc/bilinear_pass_core.cuh",
        "replaces": "photon_ml_tpu/ops/tiled_sparse.py:148",
        "launches": k3_launches,
        "max_abs_err": k3_err[0],
        "max_rel_err": k3_err[1],
        "ms": k3_added["z"],
        "plain_ms": k3_times["z_index_add_ms"],
        "bound_ms": k3_bound,
        "bound_by": "bytes",
        "library_ms": k3_times["z_index_add_ms"],
        "implementation": "folded into K1/K2: each output's spill slot (the spilled "
                          "entries sorted by output once a schedule, found through the "
                          "plan's slot map) summed in entry order and added where the "
                          "pass writes the element once; no launch of its own (an XLA scatter-add outside the "
                          "Pallas kernel in the reference). launches: the sequential "
                          "path's K1 passes that carried it; ms (g_added_ms): the time "
                          "the fold adds to the ads z-pass (g-pass); z_ms, g_ms: "
                          "the passes without it",
        "work": "the z-pass spill remainder at the ads shape",
        "g_added_ms": k3_added["g"], "g_bound_ms": k3g_bound,
        "g_library_ms": k3_times["g_index_add_ms"], "bank_z_bound_ms": k3b_bound,
        "grid_launches": {label: run["k3_folded"] for label, run in grid_runs.items()},
        **k3_times,
    }] + k4_entries(k4_launches, grid_row_dot)
    say(f"total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(smi)
    say(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind,
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
