#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. the card's name and power limit (``nvidia-smi``), and the build of
   every hand-written kernel from ``src/repro_torch/kernels/csrc`` with
   ``nvcc`` for ``sm_90a`` (all sources started together);
2. the word-pair rate of a bare loop of LOP3 and of the binary
   tensor-core MMA on every SM (the conflict kernels' route rests on
   it); then each conflict kernel against its plain PyTorch version on
   the card, bitwise: the pair kernel at every strip the engines launch
   ((C, 1024) and (1024, C) for each compact rung C of K = 1024, and
   DeSTM's 8 x 8 retry-wave strips), the delta kernel on the full rung
   with about half and a quarter of the rows live; each with its time
   (CUDA events), the plain version's, one library call computing the
   same table (``torch.matmul`` of 0/1 bf16 masks, a yardstick the port
   never calls) and its bound (the larger of bytes over the memory rate
   and word pairs over the binary MMA's measured rate; also at the
   int32 rate), and each pair strip's time device only as well
   (``graph_time_ms``);
2b. the ordered paged-commit kernel against its plain version on the
   card, bitwise, at the serving session's own shape (128 pages of
   16 x 8 float32, 8 slots), at a paged KV cache the size of the
   ``decode_32k`` shape (128 slots x 32,768 positions in pages of 16,
   stablelm's KV width 8 x 160, bf16: 262,144 pages, 10.7 GB) and at
   the session's store at that size (262,144 pages of 16 x 8 float32,
   134 MB, 128 slots); inputs repeat pages and (page, row) pairs, skip
   slots and carry page ids past either end.  Its time at the host's
   rate (CUDA events around a Python loop of 200 calls) and device only
   (200 calls captured in a CUDA graph and replayed between events:
   ``graph_time_ms``), through the wrapper and as a bare launch; an
   empty launch's both ways (the floor); the plain version's, a clone
   of the store, the bound; and at the 134 MB store one serving step's
   commit on the functional route (clone, then commit) against the
   in-place one;
3. the main path: a stream of STAMP vacation-high batches
   (``vacation_like(update_pct=90)``, 1,048,576 objects as in
   ``-r1048576``, K = 1024 transactions, 8 lanes; the first 2 of the 4
   batches phase 3b serves) through
   ``PotSession(..., engine="pcc", device="cuda").run_stream``, with the
   kernels' launch counts from that run alone (each must be > 0), and the
   conflict kernels' by shape;
4. the same stream through the port on the CPU (scatter-min
   formulation): fingerprint, replay log and every trace field must be
   bitwise equal to the card's, and the final store must equal a plain
   numpy serial interpreter's;
5. the host time of each step of one full-rung round (synchronised);
3b. (run after 5) pipelined ingress serving: the stream's 2 batches
   (2,048 transactions, those phase 3 runs; two more were cut for the
   time limit) admitted one
   by one to an ``IngressPool`` (capacity 2,048, each under its
   workload lane, journal on), then served from its arrival journal
   through ``PotSession(..., engine="pcc", pipeline_depth=D,
   device="cuda").serve(pool, budget=1024)`` twice, at D = 0 and D = 2
   (D = 1 at budget 512 was cut to keep the run near 600 s; the CPU
   tests cover other budgets and depths).  One fingerprint, replay log
   and store; the two runs equal in every trace field but ``spec_*``;
   the D = 0 store equal to the numpy oracle in the pool's drain order;
   the pipelined run speculates every row and launches the delta and
   validation kernels (counts reset before each run).  Per
   run: seconds, txns/s, rounds and ``spec_*`` per batch, launches, also
   by shape; then the speculation's own steps at the second batch's
   turn (``spec_execute``, the re-base, a fresh round 0), synchronised;
6. serving at full width and depth: ``Session(get_config("stablelm-12b"),
   ..., n_slots=8, max_seq=256, device="cuda")`` with random bf16
   weights from a seeded generator (all 40 layers, about 24 GB), 32
   greedy steps, then again with the requests' arrivals reversed: tokens
   and ``fingerprint()`` must be bitwise equal, and the commit kernel's
   launches in this phase > 0, and each session's ``page_meta`` and
   ``page_versions`` the same tensors at the same addresses after its
   steps (committed in place; so in phase 16a).  Median ms per step,
   tokens/s, the
   weight-streaming bound and the peak memory allocated;
7. the same configuration cut to 2 layers (widths untouched), its
   weights copied to the CPU: ``decode_step`` teacher-forced on the card
   and on the CPU, in float32 (the weights upcast), must agree within
   the reference tests' rtol = atol = 3e-2; in bf16 the card's logits
   may be no further from the float32 ones than twice the CPU's own
   bf16 logits are; and a CPU ``Session`` fed the card's logits must
   commit bitwise the same ``page_meta``, ``page_versions`` and
   ``fingerprint()``.  The phases print, besides, the serving step's
   device time and busy share from ``torch.profiler``;
2c. (run after 2b) both fused-AdamW kernels against their plain versions on
   the card, bitwise on p, m, v (and abort), at the training slice's
   leaves: the embedding (100,352 x 5,120), an MLP weight (5,120 x
   13,824), a norm (5,120) and, since phase 17 trains it,
   deepseek-moe-16b's (64, 2,048, 1,408) expert weight, with g in
   float32 and in bf16; the
   speculative kernel at the MLP weight's shape with versions that are
   stale, fresh, and 2^24 + 1 against rv = 2^24 (fresh in float32).
   Their times (bare launch into given outputs, also device only by
   ``graph_time_ms``, and through the functional wrapper), the plain version's, one ``torch._fused_adamw_``
   call on the same leaf (a yardstick the port never calls) and the
   bound (bytes over the memory rate); at the w1 and expert leaves with
   g float32 also the bare kernel and ``torch._fused_adamw_`` in turns,
   25 calls each, each call between its own CUDA events (medians);
8. training at full width: stablelm-12b cut to 4 layers (widths
   untouched), float32 master weights from a seeded generator on the
   card, ``make_train_step(mode="pot", n_microbatches=2)`` over
   ``batch_at(DataConfig(vocab, 128, 8), i)`` for 4 steps, twice from the
   same seed: losses and every parameter and moment leaf bitwise equal,
   losses finite, every parameter moved, gv == step == 4, and the AdamW
   kernel launched once per leaf per step.  Median ms per step,
   tokens/s, one optimizer apply's time against its bound, peak memory,
   and a ``torch.profiler`` pass over one more step;
9. training held to account: the smoke configuration trained 3 steps on
   the card and on the CPU from the same weights (losses and moments, and
   after step 1 the parameters, within the tolerances stated in
   ``phase_train_held``); on
   the card 4 steps straight bitwise equal to 2 steps, a checkpoint, a
   restore and 2 more; and ``python -m repro_torch.launch.train --arch
   stablelm-12b --smoke --steps 4`` on the card;
2d. (run after 2c) TL2 read-set validation: the read sets of phase 3's
   first batch (K = 1024, L = 16, packed to W = 32,768 words) against the
   written set of its first 512 transactions in sequence order, through
   the entry point ``ops.validate`` on the card with the validation
   kernel's launch count read around that call alone; then the kernel
   against its plain version bitwise (also at (1000, 32768) and the
   ragged (1000, 32767)), against an independent answer from the pair
   kernel (the OR over the 512 writers' columns of its strip), and the
   entry point on the card against the CPU.  Its time (also device
   only), the plain version's, one ``torch.matmul`` of 0/1 bf16 masks (a yardstick the
   port never calls) and the bound;
2e. (run after 2) the cross-batch validation strip of a pipelined
   drain: the read sets of phase 3's second batch against the dirty
   words of the addresses its first writes (K = 1024, W = 32,768) on
   both routes, the validation kernel and a (1024, 1) strip of the pair
   kernel, bitwise against their plain versions, the CPU's dense version
   gather and the entry point ``ops.spec_read_invalid`` on the card;
   their times, the plain versions', the dense gather's on the card, the
   entry point's (packing included) and the bound (K·W·4 B over the
   memory rate);
10. (run last but one) the four engines on the main path's store, one batch each
   (the first 256 rows of phase 3's first batch, O = 1,048,576, 8
   lanes; the cut is to one batch per engine and, for the time limit,
   to 256 of its 1,024 rows, never O): PCC, PoGL, DeSTM and OCC through
   ``PotSession.submit``, DeSTM's serial token walk and OCC under a
   seeded random arrival through ``destm_execute`` / ``occ_execute``,
   each with the conflict kernels' launches counted around it.  PoGL and
   both DeSTM walks must equal the numpy serial oracle and PCC's
   fingerprint, DeSTM's two walks every trace field but the wave
   counts; OCC's commit order replayed through PCC must give OCC's
   store, and its two arrivals two outcomes (else a small batch shows
   the witness); every run equals the port's CPU run of the same
   engine and arrival in every trace field.  Per engine: ms per batch,
   txns/s, rounds, ``wave_trips``, ``retry_waves``, ``barrier_ops`` and
   the launches, also by shape (OCC's delta and pair, DeSTM's pair must
   be > 0);
11. (run after 3b) the sharded store at full width: phase 3's two
   batches through ``PotSession(..., shards=8, device="cuda")`` (8
   range shards of 131,072 objects, W_s = 4,096 words): fingerprint,
   replay log, store and every trace field bitwise equal to phase 3's
   dense run, every conflict kernel launched, launches by (M, N, W_s),
   seconds a batch against phase 3's; then each kernel at W_s against
   its plain version, per shard, and the OR of the 8 shard outputs
   against the dense kernel at W = 32,768 on the same batch: the pair
   kernel's (256, 1024) and (1024, 256) strips, the delta kernel at the
   median live count of the sharded run's full-rung rounds, the
   validation kernel on (1024, 4,096) (phase 2e's dirty set); one
   shard's time (also device only), the 8 launches', the dense call's, the plain version's
   and the bound; then one pipelined sharded drain (depth 2, budget
   1,024) of two batches of phase 3b's journal, equal to phase 3b's
   depth-0 serve in every trace field but ``spec_*`` and in the replay
   log, with the validation kernel launched per shard;
12. (run after 11) recovery on the card: ``run_replica`` over phase 3b's
   arrival journal (budget 1,024, PCC, a snapshot after every batch)
   killed by ``FaultPlan(kill_batch=1, kill_phase="execute",
   action="raise")`` and resumed (``resume=True``): store, replay log and
   trace digests bitwise equal to phase 3b's depth-0 serve; the ms to
   write and to verify-load one snapshot of the 1,048,576-object store
   and the s to resume and re-drain; phase 11's store snapshotted at 8
   shards and restored at 1 and 4 (one fingerprint); and a replica
   process (``python -m repro_torch.core.checkpoint``) over the journal's
   first 512 arrivals at budget 256, SIGKILLed at batch 1 and restored
   by another process, bitwise equal to the uninterrupted run;
13. (run after 9) the frozen scan oracles (``core/legacy_scan.py``) on
   the card: PCC, OCC (a seeded arrival) and DeSTM over the first 64
   rows of phase 3's first batch (O = 1,048,576; the cut is in K only,
   since the oracle walks one transaction at a time), each bitwise equal
   to the port's vectorized engine on the card in the store and every
   trace field ``tests/test_commit_pipeline.py`` compares; the seconds
   of each;
14. (run after 13) deterministic data-parallel training at full width:
   ``make_pot_dp_step`` at one rank (no process group: the ring of one
   rank is the identity) on phase 8's model, batch and seed, 4 steps
   twice with AdamW and twice with Adafactor, each pair bitwise equal;
   the AdamW run bitwise equal to phase 8's pot step (losses and digest)
   with the fused AdamW kernel launched once per leaf per step; ms per
   step, tokens/s, the Adafactor update's ms against its bytes bound;
   and one Adafactor step of one full-width layer on the card against
   the CPU, within the parity tests' bound;
15. (run after 14) the fixed ring's order and top-k compression on the
   card: 8 ranks' contributions of w1's gradient shape (5,120 x 13,824
   float32) summed in the ring's chunk order in one process
   (``ordered_ring_sum``), bitwise equal to the CPU and within 1e-5 of
   the summed magnitudes of ``torch.sum``; ``topk_compress`` at ratio
   0.01 of that sum bitwise equal to the CPU; the ms of each.  The
   cross-process ring runs in the CPU tests over gloo; NCCL across cards
   waits for a machine with several;
16. (run after 7) the other layer kinds at full width and depth, one
   family at a time, random bf16 weights from SEED, each family's freed
   before the next loads: recurrentgemma-9b (RG-LRU and local attention,
   19.1 GB), mamba2-370m, deepseek-moe-16b (33.8 GB) and
   whisper-medium.  a. a ``Session`` as phase 6 (8 slots, ``max_seq``
   256, 32 greedy steps, two replicas with reversed arrivals: tokens and
   fingerprint bitwise equal, the commit kernel launched), ms per step
   against the weights and cache read once, tokens/s, peak memory and a
   device profile; c. the family cut to one pattern group (widths
   untouched), float32 on the card and on the CPU from the same
   weights: prefill logits, the prefill cache and 4 decode steps'
   logits within rtol = atol = 3e-2; b. ``lm.prefill`` of 4 prompts of
   4,096 tokens (whisper 448, after ``lm.encode`` over 1,504 frames;
   recurrentgemma's local layers take the banded form) and 16
   teacher-forced decode steps from its cache, each timed against its
   bound (FLOPs over a bf16 matmul rate measured in the run; bytes over
   the memory rate), then the cache path held against the parallel
   pass at row 0 in float32 within rtol = atol = 3e-2 (bf16, at full
   depth, rounds about 0.3 from float32 on both paths: the bf16 decode
   is held to twice ``lm.forward``'s own distance, as phase 7 holds
   its decode; a MoE model's check runs under a capacity no expert
   fills, see ``family_prefill``); whisper's encoder computes in bf16
   whatever its weights' dtype (as the reference's), so 16c holds its
   output card against CPU within the same tolerance and feeds the
   card's to both float32 decoders;
17. (run after 15) training through the other layer kinds at full
   width, one family at a time, float32 master weights from SEED on the
   card, ``make_train_step(mode="pot", n_microbatches=2)``:
   recurrentgemma-9b cut to one pattern group and its 2-layer tail
   (3.09e9 parameters, Adafactor, 2 x 4,096 tokens: the banded local
   attention), mamba2-370m whole (AdamW, 8 x 1,024), deepseek-moe-16b
   cut to 2 layers (1.60e9 parameters, AdamW, 8 x 512) and
   whisper-medium whole (AdamW, 8 x 448 tokens over 1,504 seeded stub
   frames).  Each: 3 steps twice from one seed, losses and every state
   leaf bitwise equal, losses finite, the fused AdamW kernel launched
   once per leaf per step (none under Adafactor); ms per step, tokens/s
   and peak memory.  17b (run beside 10 and 10b): one Adafactor step
   of recurrentgemma (its
   phase cut) and of deepseek (2 layers: the (2, 64, 2,048, 1,408)
   expert stacks hold 3.7e8 elements, so they are clipped group by
   group) in float32 (``C`` set to float32 in the port's model
   modules) on the card and on the CPU from the same weights, 2 x 64
   tokens: the loss within rtol 1e-5, the gradients, the statistics
   and the new parameters within 1e-4 in relative L2 per leaf, the
   CPU tests' bound (the parameters of a leaf with a gradient column
   the two give more than 1e-3 apart, a cancellation both optimizers
   normalise to an O(1) update, are held through their gradients and
   statistics; ``tests/test_torch_train_kinds.py``); the card's steps
   run just before phase 10, the CPU's in a thread beside phases 10
   and 10b (which are host-bound on one core and read nothing of the
   model modules, whose ``C`` the thread sets), compared after 10b;
18. (run after 17) the layout and the dry run, about 10 s: a. a
   world-1 NCCL group, ``launch.mesh.make_host_mesh()`` over the card,
   and every leaf of deepseek-moe-16b cut to 2 layers (phase 17's cell,
   full width, bf16) distributed by its spec under a single-pod
   ``Profile`` on a (1, 1) ("data", "model") mesh: each local shard
   bitwise the tensor, ``cons`` the identity there; b. for phase 17's
   deepseek-moe-16b cell (2 layers, 8 x 512) and phase 8's stablelm-12b
   cell (4 layers, 8 x 128), the dry run's counts on the ``meta``
   device against the card: the meta FLOP count equal to
   ``FlopCounterMode``'s count of one real forward and backward on the
   card, exactly; the dry run's predicted per-card peak within [0.67,
   1.5] x the ``torch.cuda.max_memory_allocated()`` of one pot training
   step (2 microbatches, AdamW; above what the phase found allocated);
   and the roofline bound of ``launch/roofline_model.py`` at the H100's
   constants on one card no greater than the measured step time (the
   median of 3 steps after one), printed as the step-to-bound ratio,
   with the fused AdamW kernel's launches of those steps counted;
   c. (run after a, on its group and mesh) the MoE layers' expert
   parallelism (``models/moe.py``, the reference's ``_moe_shardmap``)
   at world 1 on phase 17's deepseek-moe-16b cell (full width, 2
   layers, bf16 weights): layer 0's MoE on 8 x 512 tokens through the
   schedule and through the dense path, the output and, after one
   backward, ``dx``, the router's and the three expert leaves'
   gradients bitwise equal; a ``Session`` with the profile against one
   without (8 slots, a 64-token prompt each through ``prefill``, 16
   greedy steps): tokens and fingerprint bitwise equal; one pot step
   (AdamW, 2 microbatches, phase 17's 8 x 512 batch, float32 masters)
   with the profile against one without: the loss and every new
   parameter and moment leaf bitwise equal, the fused AdamW kernel
   launched once a leaf a step; the medians of 5 after a warm-up of the
   layer's forward and forward plus backward, a decode step and a train
   step, each with and without the profile;
19. (run after 18c, on its world-1 NCCL group) this slice's SPMD paths
   at world 1, each check bitwise against the dense path: a. the store
   one shard per rank (``PotSession(shards=1, mesh=)`` on a 1-D
   ("shard",) mesh of the card: a one-shard store with a mesh takes the
   sharded paths, its loads through the rank exchange): the main path's
   first batch (phase 3's configuration, K = 1,024, O = 1,048,576), its
   every trace field and replay log equal to phase 3's dense session's
   first batch, its store and fingerprint to the numpy serial oracle
   after that batch (the image phase 4 holds the dense session to), the
   pair and delta kernels launched, s per batch beside the dense run's;
   b. tensor and sequence parallelism of the attention and MLP
   sublayers: stablelm-12b at full width cut to 2 layers on phase 18a's
   (1, 1) mesh with ``Profile(mesh=)`` against ``SMOKE``: ``forward``'s
   logits, ``prefill``'s logits and cache on 8 x 128 bf16 tokens and
   one ``decode_step``'s from that cache, a
   ``Session`` (8 slots, 64-token prompts, 16 steps: tokens and
   fingerprint, kv_commit launched once a step) and one pot step (AdamW,
   2 microbatches, float32 masters: loss and every parameter and moment
   leaf, fused_adamw launched once a leaf), bitwise equal; the medians
   of 5 after a warm-up of each, with and without the profile;
   c. tensor parallelism of the other kinds, on the same mesh and with
   the same checks, times and launches as b: mamba2-370m cut to 2
   layers (the SSD mixer's heads), recurrentgemma-9b cut to one pattern
   group (the RG-LRU mixers' width, the local ring) and whisper-medium
   cut to 2 encoder and 2 decoder layers (the encoder on the rank's
   block of its 1,504 stub frames, cross-attention's heads; ``forward``,
   ``prefill`` and the decode step after ``lm.encode`` on the same
   profile: the decode step reads the cross rows the prefill wrote,
   where the ``Session``, which prefills without ``enc``, reads zero
   rows); d. the last of the mesh layout (the embedding and head held
   by vocab block, whole at world 1, run through b and c too): one
   Adafactor pot step (2 microbatches, float32 masters) on the mesh
   against ``SMOKE`` for b's stablelm cell and 18c's deepseek cell
   (loss and every parameter and statistic leaf), then the ``pure_dp``
   profile (``Profile(mesh=, pure_dp=True)``) on stablelm-12b and
   mamba2-370m, each cut to 2 layers, with b's checks, launches and
   times and an Adafactor step, all bitwise equal; and a MoE config
   under ``pure_dp`` refused (its expert specs name the model axis
   twice);
10b. (run last) each engine pipelined: ``run_stream`` at
   ``pipeline_depth=2`` over the first 64 rows of the stream's first
   three batches (256 until the time limit cut them) on the card, equal to the same engine's serial run on the card
   in every trace field but ``spec_*`` and to its pipelined run on the CPU
   in every field; per engine the times of the card's two runs (the
   repeated serial run was cut to keep the run near 600 s), ``spec_*``
   per batch and the launches.

The CPU runs that phases 4, 10 and 10b hold the card to are made from
the seeds alone by the CPU referee, a child process started first that
never sees the card (REFEREE_THREADS torch threads, on cores the
host-bound card phases leave idle); phase 9's launcher is a process
started beside phase 12; phase 17b's CPU steps are a thread beside
phases 10 and 10b.  The third line from the end gives each
phase's wall seconds, the second the kernels' JSON summary and the last
line ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero; without a CUDA device it exits 1 at once and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# cuBLAS is deterministic under torch's deterministic mode only with a
# fixed workspace; it must be set before CUDA initialises
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

N_OBJECTS = 1 << 20     # STAMP vacation -r1048576
K = 1024                # transactions per batch
N_LANES = 8
N_BATCHES = 2           # phase 3b's cut of depth (was 4): the time limit
MAIN_PATH_BATCHES = 2   # phases 3-4's cut; phase 3b serves all N_BATCHES
SEED = 0
VALIDATE_PREFIX = 512   # phase 2d: the writers of the validated set
ENGINES_K = 256         # phase 10: rows of the first batch, card and CPU
ENGINES_CPU_K = 64      # phase 10b: rows of each batch, card and CPU
REFEREE_THREADS = 4     # torch threads of the CPU referee (see main)

SERVE_ARCH = "stablelm-12b"
SERVE_SLOTS = 8
SERVE_MAX_SEQ = 256
SERVE_STEPS = 32
PROFILED_STEPS = 2
HELD_LAYERS = 2         # phase 7's cut of depth
HELD_STEPS = 4
TOL = 3e-2              # rtol = atol of the reference's model tests

TRAIN_ARCH = "stablelm-12b"
TRAIN_LAYERS = 4        # phase 8's cut of depth: 2.14e9 parameters
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO = 128, 8, 2  # the launcher's defaults
TRAIN_STEPS = 4
TRAIN_LR, TRAIN_WD = 3e-4, 0.01
HELD_TRAIN_STEPS = 3
ADAMW_TURNS = 25        # phase 2c: the w1 leaf's kernel and library in turns

SHARDS = 8              # phase 11: the main path's store in 8 range shards
KILL_CUT = 256          # phase 12's SIGKILL run: the budget, 2 batches of it

SCAN_K = 64             # phase 13: the scan oracle walks K one by one
RING_RANKS = 8          # phase 15: contributions of 8 ranks at w1's shape
TOPK_RATIO = 0.01

# phase 16: the other layer kinds, (arch, prompt tokens, layers of the
# card-against-CPU cut: one pattern group)
FAMILIES = (
    ("recurrentgemma-9b", 4096, 3),  # banded prefill: 2 windows of 2,048
    ("mamba2-370m", 4096, 2),        # 16 SSD chunks of 256
    ("deepseek-moe-16b", 4096, 2),   # prefill capacity 1,920 per expert
    ("whisper-medium", 448, 2),      # Whisper's text context, 1,504 frames
)
PREFILL_BATCH = 4
PREFILL_DECODE = 16
FAMILY_HELD_PROMPT = 512
FAMILY_HELD_DECODE = 4
MATMUL_N = 8192         # the bf16 rate prefill bounds are taken against
# phase 17: training through the other kinds, (arch, layers kept (None:
# all), optimizer, tokens a row, rows: 2 microbatches)
TRAIN_FAMILIES = (
    # one pattern group + its 2-layer tail (3.09e9 parameters); with
    # AdamW its 28 B a parameter would need about 86 GB.  4,096 tokens,
    # over the 2,048 window: the banded form
    ("recurrentgemma-9b", 5, "adafactor", 4096, 2),
    ("mamba2-370m", None, "adamw", 1024, 8),      # 4 SSD chunks of 256
    ("deepseek-moe-16b", 2, "adamw", 512, 8),     # 1.60e9 parameters
    ("whisper-medium", None, "adamw", 448, 8),    # over 1,504 stub frames
)
FAMILY_TRAIN_STEPS = 3
FAMILY_HELD_SEQ = 64    # phase 17's Adafactor step on the card and the CPU
# phase 17b: phase 17's Adafactor cells held card against CPU, (arch,
# layers kept): recurrentgemma's phase cut, deepseek's 2 layers
ADAFACTOR_HELD = (("recurrentgemma-9b", 5), ("deepseek-moe-16b", 2))
# phase 18: the dry run held to the card, (arch, layers kept, rows,
# tokens a row): phase 17's deepseek cell and phase 8's stablelm cell
DRYRUN_CELLS = (("deepseek-moe-16b", 2, 8, 512), ("stablelm-12b", 4, 8, 128))
DRYRUN_STEPS = 3        # timed steps after one untimed
PEAK_RANGE = (0.67, 1.5)  # predicted / measured peak per card
# phase 18c: expert parallelism at world 1 on DRYRUN_CELLS[0]
EP_SLOTS, EP_PROMPT, EP_STEPS, EP_MAX_SEQ = 8, 64, 16, 128
EP_TIMED = 5            # medians of 5 after one warm-up
# phase 19b: tensor and sequence parallelism at world 1, stablelm-12b at
# full width cut to 2 layers; its session and prompt as phase 18c's
TP_ARCH, TP_LAYERS, TP_ROWS, TP_SEQ = "stablelm-12b", 2, 8, 128
# phase 19c: the other kinds at full width, (arch, layers kept, encoder
# layers kept); the inputs, session and step as phase 19b's
TP_KINDS = (("mamba2-370m", 2, 0), ("recurrentgemma-9b", 3, 0),
            ("whisper-medium", 2, 2))
# phase 19d: pure_dp at full width, (arch, layers kept); the inputs,
# session and steps as phase 19b's
PURE_DP_CELLS = ((TP_ARCH, TP_LAYERS), ("mamba2-370m", 2))

# Published H100 SXM peaks (NVIDIA data sheet, 700 W): 3.35 TB/s of HBM;
# 67 TFLOP/s fp32 outside the tensor cores = 132 SMs x 128 lanes x 2 x
# 1.98 GHz, and an SM has 64 int32 lanes, so 132 x 64 x 1.98e9 int32
# operations/s.  One LOP3 instruction computes acc | (a & b): one
# operation per word pair.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

SOURCES = {
    "conflict_matrix_bits_pair": "src/repro_torch/kernels/csrc/conflict.cu",
    "conflict_matrix_bits_delta": "src/repro_torch/kernels/csrc/conflict.cu",
    "kv_commit": "src/repro_torch/kernels/csrc/kv_commit.cu",
    "fused_adamw": "src/repro_torch/kernels/csrc/fused_adamw.cu",
    "fused_adamw_speculative": "src/repro_torch/kernels/csrc/fused_adamw.cu",
    "validate_bitsets": "src/repro_torch/kernels/csrc/validate.cu",
}
REPLACES = {
    "conflict_matrix_bits_pair": "src/repro/kernels/conflict.py:132",
    "conflict_matrix_bits_delta": "src/repro/kernels/conflict.py:98",
    "kv_commit": "src/repro/kernels/kv_commit.py:52",
    "fused_adamw": "src/repro/kernels/fused_adamw.py:87",
    "fused_adamw_speculative": "src/repro/kernels/fused_adamw.py:120",
    "validate_bitsets": "src/repro/kernels/validate.py:43",
}


def log(*parts):
    print(*parts, flush=True)


PHASE_SECONDS: dict[str, float] = {}


def clocked(fn):
    """``fn`` that adds its wall seconds to ``PHASE_SECONDS[fn.__name__]``
    (a phase that another calls is counted in its caller as well)."""
    import functools

    @functools.wraps(fn)
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            PHASE_SECONDS[fn.__name__] = PHASE_SECONDS.get(
                fn.__name__, 0.0) + time.perf_counter() - t0
    return run


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(fn, calls: int = 200, replays: int = 5) -> float:
    """The card's own ms for one call of ``fn``: ``calls`` calls captured
    in one CUDA graph, replayed ``replays`` times between CUDA events, so
    the host's rate of enqueueing (the wrapper's Python and the launch
    call) does not enter.  Warmed up on the capture stream, so scratch
    kept per stream exists before the capture."""
    import torch
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(2):
            fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def host_rate_ms(fn, calls: int = 200, rounds: int = 5) -> tuple[float,
                                                                  float]:
    """The best and the worst of ``rounds`` readings of
    :func:`cuda_time_ms` over ``calls`` calls: where the host enqueues
    more slowly than the card runs, that is the host's rate, and it
    varies with what else runs on the machine's CPU."""
    ms = sorted(cuda_time_ms(fn, calls) for _ in range(rounds))
    return ms[0], ms[-1]


def in_turns(fns, calls: int, warmup: int = 2) -> list[list[float]]:
    """Each of ``fns`` called ``calls`` times in turns (a, b, a, b, ...),
    every call between its own pair of CUDA events: the ms of each call,
    one list per function."""
    import torch
    for fn in fns:
        for _ in range(warmup):
            fn()
    events = [[(torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True)) for _ in range(calls)]
              for _ in fns]
    for i in range(calls):
        for fn, ev in zip(fns, events):
            ev[i][0].record()
            fn()
            ev[i][1].record()
    torch.cuda.synchronize()
    return [[a.elapsed_time(b) for a, b in ev] for ev in events]


def bound(ops: float, nbytes: float,
          ops_per_s: float = INT32_OPS_PER_S) -> tuple[float, str]:
    t_ops, t_bytes = ops / ops_per_s, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    procs = {name: _build.start_build(name) for name in _build.SOURCES}
    for name, started in procs.items():
        _build.finish_build(name, started)
        _build.load(name)
    log(f"build: {len(procs)} source(s) in "
        f"{time.perf_counter() - t0:.2f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")


def dense_mask(addrs, n, n_objects):
    """(K, O) bf16 0/1 mask of each row's first n valid addresses."""
    import torch
    k, length = addrs.shape
    valid = torch.arange(length, device=addrs.device)[None, :] < n[:, None]
    tgt = torch.where(valid, addrs.long(), n_objects)
    mask = torch.zeros((k, n_objects + 1), dtype=torch.bfloat16,
                       device=addrs.device)
    mask.scatter_(1, tgt, 1.0)
    return mask[:, :n_objects].contiguous()


def rate_probe() -> dict[str, float]:
    """Word pairs per second of a bare loop of each candidate instruction
    of the conflict kernels on every SM: LOP3 (``acc | (a & b)``, one
    word pair each) and the binary tensor-core MMA (m16n8k256 AND-POPC,
    16 x 8 x 8 word pairs each)."""
    import torch
    from repro_torch.kernels import _build
    blocks, iters = 132 * 8, 4096
    sink = torch.zeros(blocks, dtype=torch.int32, device="cuda")
    rates = {}
    for name, per_trip in (("lop3", 256 * 64), ("bmma", 8 * 4 * 1024)):
        ms = cuda_time_ms(lambda: _build.launch(
            "conflict", f"pot_rate_{name}", sink.device, sink.data_ptr(),
            blocks, iters, 0x2545F491), 5)
        rates[name] = blocks * iters * per_trip / (ms * 1e-3)
    log(f"instruction rates (word pairs/s): LOP3 {rates['lop3']:.4e} "
        f"({rates['lop3'] / INT32_OPS_PER_S:.3f} of the int32 peak), binary "
        f"MMA {rates['bmma']:.4e} ({rates['bmma'] / rates['lop3']:.3f} x "
        f"LOP3)")
    return rates


def phase_kernels(batch):
    """Each kernel vs its plain version at the main path's shapes."""
    import torch
    from repro_torch.core.protocol import compact_ladder
    from repro_torch.core.tstore import make_store
    from repro_torch.core.txn import run_all
    from repro_torch.kernels import conflict, ops, ref

    # the conflict kernels run on the binary MMA, whose rate the data
    # sheet does not give: their bounds take the rate measured here
    mma_rate = rate_probe()["bmma"]
    store = make_store(N_OBJECTS, device="cuda")
    res = run_all(batch, store.values)
    foot, write = ops.packed_footprints(res.raddrs, res.rn, res.waddrs,
                                        res.wn, N_OBJECTS)
    w = foot.shape[1]
    fmask = torch.maximum(dense_mask(res.raddrs, res.rn, N_OBJECTS),
                          dense_mask(res.waddrs, res.wn, N_OBJECTS))
    wmask = dense_mask(res.waddrs, res.wn, N_OBJECTS)
    library_table = (fmask @ wmask.T) > 0.5
    results = {}

    # --- pair: the (C, K) and (K, C) strips of every compact rung, and
    # DeSTM's (lanes x lanes) retry-wave strips; rows from the pending
    # suffix.  The summary line keeps the widest rung's two strips.
    def rows(c):
        return torch.arange(K - c, K, device="cuda")
    strips = []
    for c in compact_ladder(K)[1:]:
        strips += [(rows(c), None), (None, rows(c))]
    strips.append((rows(N_LANES), rows(N_LANES)))
    timed_pair = []
    err = 0
    for ri, ci in strips:
        a, am = (foot, fmask) if ri is None else (foot[ri], fmask[ri])
        b, bm = (write, wmask) if ci is None else (write[ci], wmask[ci])
        out = conflict.conflict_matrix_bits_pair(a, b)
        plain = ref.conflict_matrix_bits_pair_ref(a, b)
        torch.cuda.synchronize()
        err = max(err, int((out.int() - plain.int()).abs().max()))
        assert torch.equal(out, plain), "pair kernel != plain version"
        assert torch.equal(out, (am @ bm.T) > 0.5), "pair != dense matmul"
        ms = cuda_time_ms(lambda: conflict.conflict_matrix_bits_pair(a, b),
                          50)
        dev_ms = graph_time_ms(
            lambda: conflict.conflict_matrix_bits_pair(a, b), 50)
        plain_ms = cuda_time_ms(
            lambda: ref.conflict_matrix_bits_pair_ref(a, b), 2, 1)
        lib_ms = cuda_time_ms(lambda: am @ bm.T, 10)
        m, n = a.shape[0], b.shape[0]
        bnd = bound(m * n * w, (m + n) * w * 4 + m * n, mma_rate)
        int32 = bound(m * n * w, (m + n) * w * 4 + m * n)[0]
        log(f"pair ({m}, {n}) x W={w}: kernel {ms:.4f} ms ({dev_ms:.4f} "
            f"device only), plain "
            f"{plain_ms:.4f} ms, matmul {lib_ms:.4f} ms, bound "
            f"{bnd[0]:.4f} ms ({bnd[1]}; {int32:.4f} at the int32 rate), "
            f"launch plan {plan_line(conflict.launch_plan(m, n, w))}, "
            f"{int(out.sum())} conflicting pairs, bitwise equal")
        timed_pair.append((ms, plain_ms, lib_ms, bnd, dev_ms))
    main = timed_pair[:2]
    results["conflict_matrix_bits_pair"] = dict(
        max_abs_err=err, ms=float(np.mean([t[0] for t in main])),
        plain_ms=float(np.mean([t[1] for t in main])),
        bound_ms=float(np.mean([t[3][0] for t in main])),
        bound_by=main[0][3][1],
        library_ms=float(np.mean([t[2] for t in main])),
        device_ms=float(np.mean([t[4] for t in main])))

    # --- delta: the full rung at about half and a quarter of the rows
    # live; the summary line keeps the first
    rng = np.random.default_rng(SEED)
    old = torch.from_numpy(rng.random((K, K)) < 0.5).cuda()
    err = 0
    for share in (0.5, 0.25):
        live = torch.from_numpy(rng.random(K) < share).cuda()
        out = conflict.conflict_matrix_bits_delta(foot, write, old, live)
        plain = ref.conflict_matrix_bits_delta_ref(foot, write, old, live)
        torch.cuda.synchronize()
        err = max(err, int((out.int() - plain.int()).abs().max()))
        assert torch.equal(out, plain), "delta kernel != plain version"
        refresh = live[:, None] | live[None, :]
        assert torch.equal(out, torch.where(refresh, library_table, old))
        t = cuda_time_ms(lambda: conflict.conflict_matrix_bits_delta(
            foot, write, old, live), 20)
        t_plain = cuda_time_ms(lambda: ref.conflict_matrix_bits_delta_ref(
            foot, write, old, live), 2, 1)
        t_lib = cuda_time_ms(lambda: fmask @ wmask.T, 10)
        n_refresh, n_live = int(refresh.sum()), int(live.sum())
        nbytes = 2 * K * w * 4 + 2 * K * K + K
        b = bound(n_refresh * w, nbytes, mma_rate)
        int32 = bound(n_refresh * w, nbytes)[0]
        slices = conflict.delta_cuts(K, w)[n_live][0]
        log(f"delta K={K} x W={w}, {n_live} live rows, {n_refresh} "
            f"refreshed entries: kernel {t:.4f} ms, plain {t_plain:.4f} ms, "
            f"matmul {t_lib:.4f} ms, bound {b[0]:.4f} ms ({b[1]}; "
            f"{int32:.4f} at the int32 rate), {slices} slices, bitwise "
            f"equal")
        if "conflict_matrix_bits_delta" not in results:
            results["conflict_matrix_bits_delta"] = dict(
                ms=t, plain_ms=t_plain, bound_ms=b[0], bound_by=b[1],
                library_ms=t_lib)
    results["conflict_matrix_bits_delta"]["max_abs_err"] = err
    del fmask, wmask, library_table
    torch.cuda.empty_cache()
    return results


def phase_spec_strip(batch0, batch1):
    """The cross-batch validation strip of a pipelined drain at the main
    path's shape: the read sets of batch 1 run against the empty store
    (its speculation) against the dirty words of every address batch 0
    writes (W = 32,768), on both routes: the validation kernel and a
    (1024, 1) strip of the pair kernel.  Each bitwise against its plain
    version, the CPU's dense version gather and the entry point
    ``ops.spec_read_invalid`` on the card (which takes the validation
    kernel); their times, the plain versions', the dense gather's on the
    card, the whole entry point's (packing included) and the bound."""
    import torch
    from repro_torch.core.tstore import make_store
    from repro_torch.core.txn import run_all
    from repro_torch.kernels import conflict, ops, ref, validate

    store = make_store(N_OBJECTS, device="cuda")
    res0, res1 = run_all(batch0, store.values), run_all(batch1, store.values)
    slots = torch.arange(res0.waddrs.shape[1], device="cuda")
    written = res0.waddrs[slots[None, :] < res0.wn[:, None]].long()
    versions = store.versions.clone()
    versions[written] = 1
    snap = torch.zeros((), dtype=torch.int32, device="cuda")
    read_bits = validate.pack_addr_sets(res1.raddrs, res1.rn, N_OBJECTS)
    dwords = ops.spec_dirty_words(versions, snap, N_OBJECTS)
    k, w = read_bits.shape
    gather = ops.spec_read_invalid(res1.raddrs.cpu(), res1.rn.cpu(),
                                   versions.cpu(), snap.cpu(), N_OBJECTS)
    assert torch.equal(dwords.cpu(), ops.spec_dirty_words(
        versions.cpu(), snap.cpu(), N_OBJECTS)), "dirty words card != CPU"

    def via_validate():
        return validate.validate_bitsets(read_bits, dwords)

    def via_pair():
        return conflict.conflict_matrix_bits_pair(read_bits, dwords[None])

    routes = {
        "validate": (via_validate,
                     lambda: ref.validate_bitsets_ref(read_bits, dwords)),
        "pair": (lambda: via_pair()[:, 0],
                 lambda: ref.conflict_matrix_bits_pair_ref(
                     read_bits, dwords[None])[:, 0]),
    }
    out = {}
    for name, (kernel, plain) in routes.items():
        got = kernel()
        assert torch.equal(got, plain()), f"{name} route != plain version"
        assert torch.equal(got.cpu(), gather), f"{name} route != CPU"
        out[name] = cuda_time_ms(via_validate if name == "validate"
                                 else via_pair, 200)
        out[f"{name}_plain"] = cuda_time_ms(plain, 3, 1)
    validate.reset_launches()
    entry = ops.spec_read_invalid(res1.raddrs, res1.rn, versions, snap,
                                  N_OBJECTS)
    torch.cuda.synchronize()
    assert validate.LAUNCHES["validate_bitsets"] == 1
    assert torch.equal(entry.cpu(), gather), "ops.spec_read_invalid != CPU"
    valid = (torch.arange(res1.raddrs.shape[1], device="cuda")[None, :]
             < res1.rn[:, None])
    out["dense_gather"] = cuda_time_ms(lambda: (valid & (versions > snap)[
        torch.where(valid, res1.raddrs, 0).long()]).any(1), 50)
    out["entry"] = cuda_time_ms(lambda: ops.spec_read_invalid(
        res1.raddrs, res1.rn, versions, snap, N_OBJECTS), 20)
    b = bound(k * w, k * w * 4 + w * 4 + k)
    plan = conflict.launch_plan(k, 1, w)
    log(f"spec_read_invalid K={k} x W={w} against the {written.numel()} "
        f"writes of the batch before ({int(gather.sum())} of {k} rows "
        f"invalid): validation kernel {out['validate']:.4f} ms (plain "
        f"{out['validate_plain']:.4f}), pair strip ({k}, 1) "
        f"{out['pair']:.4f} ms (plain {out['pair_plain']:.4f}; "
        f"{plan_line(plan)}), bound {b[0]:.4f} ms ({b[1]}); dense version "
        f"gather on the card {out['dense_gather']:.4f} ms; the entry point "
        f"(packing the read sets and {N_OBJECTS} versions, then the "
        f"validation kernel) {out['entry']:.4f} ms; both routes bitwise "
        f"equal to their plain versions and the CPU")
    return out


def plan_line(plan) -> str:
    return (f"{plan.bm} x {plan.bn} tiles x {plan.slices} slices of "
            f"{plan.slice_words} words")


def shape_counts() -> str:
    """The conflict kernels' launches since the last reset, by shape."""
    from repro_torch.kernels import conflict
    short = {"conflict_matrix_bits_pair": "pair",
             "conflict_matrix_bits_delta": "delta"}
    return ", ".join(f"{short[name]} ({m}, {n}) x {w}: {c}" for
                     (name, m, n, w), c in sorted(conflict.SHAPES.items()))


def run_stream(wls, device):
    from repro_torch.core.session import PotSession
    s = PotSession(N_OBJECTS, engine="pcc", n_lanes=N_LANES, device=device)
    traces = s.run_stream([w.batch for w in wls], [w.lanes for w in wls])
    return s, traces


def stream_workloads():
    """The main path's N_BATCHES batches and phase 5's extra one, made on
    the CPU from SEED (alike in this process and in the CPU referee)."""
    from repro_torch.core import workloads as W
    return [W.vacation_like(n_txns=K, n_objects=N_OBJECTS, n_lanes=N_LANES,
                            update_pct=90, seed=SEED + b, device="cpu")
            for b in range(N_BATCHES + 1)]


# --- the CPU referee: a child process that makes the CPU runs phases 4,
# 10 and 10b hold the card to, from the seeds alone, on cores the card
# phases leave idle (they are host-bound on one); numpy results only


def referee_init():
    os.environ["CUDA_VISIBLE_DEVICES"] = ""     # it never sees the card
    import torch
    torch.set_num_threads(REFEREE_THREADS)
    torch.use_deterministic_algorithms(True)


def cpu_main_path():
    """Phase 4's CPU run of the main path's stream."""
    from repro_torch import convert
    (s, traces), seconds = timed(lambda: run_stream(
        stream_workloads()[:MAIN_PATH_BATCHES], "cpu"))
    return dict(fingerprint=s.fingerprint(), replay_log=s.replay_log(),
                traces=[convert.trace_to_numpy(t) for t in traces],
                seconds=seconds)


def cpu_engines():
    """Phase 10's CPU runs: every engine on the first batch, name ->
    (fingerprint, trace); and the seconds."""
    from repro_torch import convert
    from repro_torch.core.tstore import fingerprint
    runs, seconds = timed(lambda: engine_runs(
        stream_workloads()[0], "cpu")[0])
    return {name: (fingerprint(r[0]), convert.trace_to_numpy(r[1]))
            for name, r in runs.items()}, seconds


def cpu_engines_pipelined():
    """Phase 10b's CPU runs: each engine's stream at depth 2."""
    batches, lanes = pipelined_stream(stream_workloads())
    return {engine: engine_stream_run(engine, 2, "cpu", batches, lanes)
            for engine in ("pcc", "pogl", "destm", "occ")}


def phase_main_path(wls):
    import torch
    from repro_torch.kernels import conflict
    torch.cuda.synchronize()
    conflict.reset_launches()
    t0 = time.perf_counter()
    session, traces = run_stream(wls, "cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(conflict.LAUNCHES)
    rounds = [int(t.rounds) for t in traces]
    n_txns = sum(w.batch.n_txns for w in wls)
    log(f"main path: {n_txns} txns in {len(wls)} batches of K={K}, "
        f"O={N_OBJECTS}: {seconds:.3f} s, {n_txns / seconds:.1f} txns/s, "
        f"rounds per batch {rounds} ({seconds / sum(rounds) * 1e3:.2f} ms "
        f"per round), launches {launches}")
    log(f"  by shape: {shape_counts()}")
    for name, n in launches.items():
        assert n > 0, f"{name} was never launched on the main path"
    return session, traces, launches, seconds


def phase_held_to_account(wls, gpu_session, gpu_traces, cpu):
    """Phase 4: the card's main path against the CPU referee's run of the
    same stream (``cpu_main_path``) and the numpy serial oracle."""
    from repro_torch import convert
    from repro_torch.core import oracle
    from repro_torch.core.engine import TRACE_FIELDS
    from repro_torch.core.sequencer import RoundRobinSequencer

    fp = gpu_session.fingerprint()
    assert fp == cpu["fingerprint"], "fingerprints differ"
    assert gpu_session.replay_log() == cpu["replay_log"]
    assert len(gpu_traces) == len(cpu["traces"]) == len(wls)
    for i, (g, c) in enumerate(zip(gpu_traces, cpu["traces"])):
        g = convert.trace_to_numpy(g)
        for f in TRACE_FIELDS:
            assert np.array_equal(g[f], c[f]), f"batch {i} trace.{f}"
    t_cpu = cpu["seconds"]

    seqr = RoundRobinSequencer(n_root_lanes=N_LANES)
    values, versions, gv = oracle.serial_execute(
        np.zeros((N_OBJECTS, 1), np.int32), np.zeros(N_OBJECTS, np.int32),
        0, [convert.batch_to_numpy(w.batch) for w in wls],
        [seqr.order_for(w.lanes.tolist()) for w in wls])
    store = convert.store_to_numpy(gpu_session.store)
    assert np.array_equal(store["values"], values), "values != oracle"
    assert np.array_equal(store["versions"], versions), "versions != oracle"
    assert int(store["gv"]) == gv == len(wls) * K
    log(f"held to account: card == CPU run ({t_cpu:.1f} s in the CPU "
        f"referee) on fingerprint "
        f"{fp:#010x}, replay log and all {len(TRACE_FIELDS)} trace fields; "
        f"store == numpy serial oracle (gv {gv})")


def phase_round_breakdown(wl):
    """Host time of each step of one full-rung round at the main path's
    shapes (every row live, as in round 0), each step synchronised."""
    import torch
    from repro_torch.core import protocol
    from repro_torch.core.tstore import make_store
    from repro_torch.core.txn import pad_batch, run_live, run_txn
    from repro_torch.kernels import ops

    batch = pad_batch(wl.batch.to("cuda"), K, 16)
    store = make_store(N_OBJECTS, device="cuda")
    rs = protocol.init_round_state(batch, store.values.clone(),
                                   store.versions.clone())
    live = batch.n_ins > 0
    order = rank = torch.arange(K, device="cuda")
    rs = protocol.refresh_round_state(rs, batch, live)
    res = rs.res
    committing = protocol.prefix_commit(res, rs.conflict, order, rank, 0,
                                        N_OBJECTS, live)
    steps = {
        "read phase (run_live, K x L)": lambda: run_live(
            batch, rs.values, live, res),
        "pack footprints": lambda: ops.update_packed_footprints(
            rs.foot_bits, rs.write_bits, res.raddrs, res.rn, res.waddrs,
            res.wn, live, N_OBJECTS),
        "delta kernel": lambda: ops.conflict_matrix_delta(
            rs.foot_bits, rs.write_bits, rs.conflict, live),
        "prefix decision": lambda: protocol.prefix_commit(
            res, rs.conflict, order, rank, 0, N_OBJECTS, live),
        "fused write-back": lambda: protocol.fused_write_back(
            rs.values.clone(), rs.versions.clone(), res.waddrs, res.wvals,
            res.wn, committing, rank, rank + 1),
        "live promotion (run_txn + apply_writes)": lambda: (
            protocol.apply_writes(rs.values.clone(), rs.versions.clone(),
                                  *run_txn(batch.rows(order[5]), rs.values,
                                           N_OBJECTS)[2:], 6)),
    }
    total = 0.0
    log("round breakdown (full rung, all rows live), host ms per step:")
    for name, fn in steps.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 5 * 1e3
        total += ms
        log(f"  {ms:9.3f} ms  {name}")
    log(f"  {total:9.3f} ms  sum")


def phase_pipelined_serving(wls):
    """Phase 3b: the stream's N_BATCHES * K transactions admitted one by
    one to an ingress pool, then served from its arrival journal twice on
    the card: depth 0 and depth 2 at budget K.
    Held to one another, to the numpy oracle in the pool's drain order,
    and measured: the speculation's own steps timed on a stale store."""
    import torch
    from repro_torch import convert
    from repro_torch.core import oracle, protocol
    from repro_torch.core.engine import TRACE_FIELDS
    from repro_torch.core.checkpoint import trace_digest
    from repro_torch.core.ingress import IngressPool, programs_from_batch
    from repro_torch.core.session import PotSession
    from repro_torch.core.tstore import make_store
    from repro_torch.kernels import conflict, validate

    t0 = time.perf_counter()
    pool = IngressPool(capacity=N_BATCHES * K)
    for w in wls:
        for prog, lane in zip(programs_from_batch(w.batch),
                              w.lanes.tolist()):
            assert pool.admit(prog, lane=int(lane)).admitted
    journal = pool.arrival_journal()
    formed = IngressPool.replay(journal)[0].drain_all(K)
    t_admit = time.perf_counter() - t0
    n_txns = N_BATCHES * K
    assert sum(fb.n_txns for fb in formed) == n_txns

    runs = {}
    for depth, budget in ((0, K), (2, K)):
        s = PotSession(N_OBJECTS, engine="pcc", n_lanes=N_LANES,
                       pipeline_depth=depth, device="cuda")
        served = IngressPool.replay(journal)[0]
        torch.cuda.synchronize()
        conflict.reset_launches()
        validate.reset_launches()
        traces, seconds = timed(lambda: s.serve(served, budget=budget))
        launches = dict(conflict.LAUNCHES, **validate.LAUNCHES)
        runs[depth, budget] = (s, traces, seconds, launches, shape_counts())
        assert served.depth == 0 and s.n_txns == n_txns
        spec = {f: [int(getattr(t, f)) for t in traces]
                for f in ("spec_executed", "spec_invalidated",
                          "spec_rounds")}
        log(f"  depth {depth}, budget {budget}: {len(traces)} batches, "
            f"{seconds:.3f} s, {n_txns / seconds:.1f} txns/s, rounds "
            f"{[int(t.rounds) for t in traces]}, spec_executed "
            f"{spec['spec_executed']}, spec_invalidated "
            f"{spec['spec_invalidated']}, spec_rounds "
            f"{spec['spec_rounds']}; launches {launches}")
        log(f"    by shape: {shape_counts()}")
        if depth:
            assert sum(spec["spec_executed"]) == n_txns
            for name in ("conflict_matrix_bits_delta", "validate_bitsets"):
                assert launches[name] > 0, f"{name} not launched"

    (s0, t0_, *_), (s2, t2, *_) = runs.values()
    fp = s0.fingerprint()
    assert s2.fingerprint() == fp, "served fingerprints differ"
    assert s2.replay_log() == s0.replay_log(), "replay logs differ"
    for f in ("values", "versions", "gv"):
        assert torch.equal(getattr(s2.store, f), getattr(s0.store, f)), f
    for i, (a, b) in enumerate(zip(t0_, t2)):
        a, b = convert.trace_to_numpy(a), convert.trace_to_numpy(b)
        for f in TRACE_FIELDS:
            if not f.startswith("spec_"):
                assert np.array_equal(a[f], b[f]), f"batch {i} trace.{f}"
    values, versions, gv = oracle.serial_execute(
        np.zeros((N_OBJECTS, 1), np.int32), np.zeros(N_OBJECTS, np.int32),
        0, [convert.batch_to_numpy(fb.batch) for fb in formed],
        [fb.seq for fb in formed])
    store = convert.store_to_numpy(s0.store)
    assert np.array_equal(store["values"], values), "values != oracle"
    assert np.array_equal(store["versions"], versions), "versions != oracle"
    assert int(store["gv"]) == gv == n_txns

    # the speculation's own steps at the second batch's turn: its seed
    # against the empty store, re-based onto the store the first batch
    # left (from the oracle), against a fresh round 0 on that store
    b1 = formed[1].batch.to("cuda")
    first = oracle.serial_execute(
        np.zeros((N_OBJECTS, 1), np.int32), np.zeros(N_OBJECTS, np.int32),
        0, [convert.batch_to_numpy(formed[0].batch)], [formed[0].seq])
    after0 = convert.store_from_numpy(
        dict(values=first[0], versions=first[1], gv=first[2]),
        device="cuda")
    seed, t_spec = timed(lambda: protocol.spec_execute(
        make_store(N_OBJECTS, device="cuda"), b1))
    (_, n_inv, _), t_rebase = timed(
        lambda: protocol.seed_round_state(b1, after0, seed))
    _, t_fresh = timed(lambda: protocol.refresh_round_state(
        protocol.init_round_state(b1, after0.values.clone(),
                                  after0.versions.clone()),
        b1, b1.n_ins > 0))
    log(f"pipelined serving: {n_txns} vacation-high txns admitted one by "
        f"one ({t_admit:.1f} s with the drain that checks them), served "
        f"from the arrival journal at K={K} and O={N_OBJECTS}: depth 0 "
        f"{runs[0, K][2]:.3f} s, depth 2 {runs[2, K][2]:.3f} s; one "
        f"fingerprint "
        f"{fp:#010x}, replay log and store; depth 0 == depth 2 in every "
        f"trace field but spec_*; store == numpy oracle in the pool's drain "
        f"order (gv {gv}).  Second batch's turn: spec_execute "
        f"{t_spec * 1e3:.1f} ms, re-base {t_rebase * 1e3:.1f} ms "
        f"({int(n_inv)} rows invalid), a fresh round 0 {t_fresh * 1e3:.1f} ms")
    # the depth-0 serve, which phases 11 and 12 are held to
    served = dict(journal=journal, fingerprint=fp,
                  replay_log=s0.replay_log(), seconds=runs[0, K][2],
                  traces=[convert.trace_to_numpy(t) for t in t0_],
                  digests=[trace_digest(t) for t in t0_], **store)
    return runs[2, K][3], served


def phase_validate(wl):
    """The TL2 validation kernel, driven through its entry point
    ``ops.validate`` (counted), then held against its plain version, the
    pair kernel and the CPU, bitwise: the read sets of ``wl``'s round-0
    execution against the written set of its first VALIDATE_PREFIX
    transactions in sequence order."""
    import torch
    from repro_torch.core.sequencer import RoundRobinSequencer
    from repro_torch.core.tstore import make_store
    from repro_torch.core.txn import run_all
    from repro_torch.kernels import conflict, ops, ref, validate

    batch = wl.batch.to("cuda")
    res = run_all(batch, make_store(N_OBJECTS, device="cuda").values)
    seq = RoundRobinSequencer(n_root_lanes=N_LANES).order_for(
        wl.lanes.tolist())
    first = torch.from_numpy(np.argsort(seq, kind="stable")[
        :VALIDATE_PREFIX]).to("cuda")
    slots = torch.arange(res.waddrs.shape[1], device="cuda")
    wvalid = slots[None, :] < res.wn[first, None]
    written = res.waddrs[first][wvalid]            # (Lw,) flattened
    lw = written.shape[0]

    torch.cuda.synchronize()
    validate.reset_launches()
    out = ops.validate(res.raddrs, res.rn, written, lw, N_OBJECTS)
    torch.cuda.synchronize()
    launches = validate.LAUNCHES["validate_bitsets"]
    assert launches > 0, "validate_bitsets was never launched"

    # check 3: the entry point on the CPU, same addresses
    cpu = ops.validate(res.raddrs.cpu(), res.rn.cpu(), written.cpu(), lw,
                       N_OBJECTS)
    assert torch.equal(out.cpu(), cpu), "ops.validate: card != CPU"
    # check 1: kernel == plain version, main-path and ragged shapes
    read_bits = validate.pack_addr_sets(res.raddrs, res.rn, N_OBJECTS)
    written_bits = validate.pack_addr_sets(
        written[None, :], torch.tensor([lw], device="cuda"), N_OBJECTS)[0]
    k, w = read_bits.shape
    for kk, ww in ((k, w), (1000, w), (1000, w - 1)):
        a, b = read_bits[:kk, :ww], written_bits[:ww]
        got = validate.validate_bitsets(a, b)
        assert torch.equal(got, ref.validate_bitsets_ref(a, b)), \
            f"validate kernel != plain version at ({kk}, {ww})"
    got = validate.validate_bitsets(read_bits, written_bits)
    assert torch.equal(got, out)
    err = int((got.int() - ref.validate_bitsets_ref(
        read_bits, written_bits).int()).abs().max())
    # check 2: against the pair kernel's strip over the writers' bitsets
    write_bits = validate.pack_addr_sets(res.waddrs, res.wn, N_OBJECTS)
    strip = conflict.conflict_matrix_bits_pair(read_bits, write_bits[first])
    assert torch.equal(strip.any(dim=1), out), "validate != pair kernel"

    rmask = dense_mask(res.raddrs, res.rn, N_OBJECTS)
    wmask = dense_mask(written[None, :], torch.tensor([lw], device="cuda"),
                       N_OBJECTS)[0]
    assert torch.equal((rmask @ wmask) > 0.5, out), "validate != matmul"
    t = cuda_time_ms(lambda: validate.validate_bitsets(read_bits,
                                                       written_bits), 200)
    t_dev = graph_time_ms(lambda: validate.validate_bitsets(read_bits,
                                                            written_bits))
    t_plain = cuda_time_ms(lambda: ref.validate_bitsets_ref(
        read_bits, written_bits), 5)
    t_lib = cuda_time_ms(lambda: rmask @ wmask, 20)
    b = bound(k * w, k * w * 4 + w * 4 + k)
    log(f"validate K={k} x W={w} against the writes of the first "
        f"{VALIDATE_PREFIX} txns (Lw={lw}): {int(out.sum())} of {k} rows "
        f"conflict; kernel {t:.4f} ms ({t_dev:.4f} device only), plain "
        f"{t_plain:.4f} ms, matmul "
        f"{t_lib:.4f} ms, bound {b[0]:.4f} ms ({b[1]}); launches in the "
        f"ops.validate drive {launches}; bitwise equal to the plain version "
        f"(also at (1000, {w}) and (1000, {w - 1})), the pair kernel's "
        f"strip and the CPU")
    del rmask, wmask
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=t, plain_ms=t_plain, bound_ms=b[0],
                bound_by=b[1], library_ms=t_lib, device_ms=t_dev), launches


def timed(fn):
    """fn() with the card synchronised on both sides: (result, seconds);
    in the CPU referee, which sees no card, the host's seconds."""
    import torch
    sync = torch.cuda.synchronize if torch.cuda.is_available() \
        else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def engine_runs(wl, device, k=ENGINES_K):
    """Every engine on the first ``k`` rows of ``wl`` from a fresh store
    on ``device``: name -> (store, trace, seconds, conflict launches)."""
    from repro_torch.core.destm import destm_execute
    from repro_torch.core.occ import occ_execute
    from repro_torch.core.sequencer import RoundRobinSequencer
    from repro_torch.core.session import PotSession
    from repro_torch.core.tstore import make_store
    from repro_torch.core.txn import next_pow2, pad_batch
    import torch
    from repro_torch.kernels import conflict

    batch, lanes = wl.batch.rows(torch.arange(k)), wl.lanes[:k]
    seq = RoundRobinSequencer(n_root_lanes=N_LANES).order_for(lanes.tolist())
    as_dev = lambda a: torch_tensor(np.asarray(a, np.int32), device)
    arrival = np.random.default_rng(SEED).permutation(k)

    def session(engine):
        s = PotSession(N_OBJECTS, engine=engine, n_lanes=N_LANES,
                       device=device)
        trace = s.submit(batch, lanes)
        return s.store, trace

    # the shims take the batch at the session's bucket (L to a power of
    # two), so that the walked slots compare with the session's runs
    padded = pad_batch(batch, k, next_pow2(batch.max_ins))

    def shim(fn, *args, **kw):
        return lambda: fn(make_store(N_OBJECTS, device=device),
                          padded.to(device), *args, **kw)

    drives = {
        "pcc": lambda: session("pcc"),
        "pogl": lambda: session("pogl"),
        "destm": lambda: session("destm"),
        "destm serial walk": shim(destm_execute, as_dev(seq),
                                  as_dev(lanes), N_LANES, wave=False),
        "occ": lambda: session("occ"),
        "occ random arrival": shim(occ_execute, as_dev(arrival)),
    }
    out = {}
    for name, drive in drives.items():
        conflict.reset_launches()
        (store, trace), s = timed(drive)
        out[name] = (store, trace, s, dict(conflict.LAUNCHES),
                     shape_counts())
    return out, seq, arrival


def torch_tensor(a, device):
    import torch
    return torch.from_numpy(a).to(device)


def phase_engines(wl, cpu):
    """Every engine on ENGINES_K rows of ``wl`` on the card: PoGL and DeSTM
    (both walks) held to the numpy serial oracle and to PCC, OCC to its
    CPU run per arrival with a nondeterminism witness and a replay
    through PCC, every engine to its CPU run (``cpu_engines``, from the
    CPU referee) in every trace field."""
    import torch
    from repro_torch import convert
    from repro_torch.core import oracle
    from repro_torch.core.engine import TRACE_FIELDS
    from repro_torch.core.pcc import pcc_execute
    from repro_torch.core.sequencer import ReplaySequencer
    from repro_torch.core.tstore import fingerprint, make_store

    k = ENGINES_K
    card, seq, arrival = engine_runs(wl, "cuda")
    batch, lanes = wl.batch.rows(torch.arange(k)), wl.lanes[:k]
    fps = {name: fingerprint(r[0]) for name, r in card.items()}
    values, versions, gv = oracle.serial_execute(
        np.zeros((N_OBJECTS, 1), np.int32), np.zeros(N_OBJECTS, np.int32),
        0, [convert.batch_to_numpy(batch)], [seq])
    for name in ("pcc", "pogl", "destm", "destm serial walk"):
        store = convert.store_to_numpy(card[name][0])
        assert np.array_equal(store["values"], values), f"{name} values"
        assert np.array_equal(store["versions"], versions), \
            f"{name} versions"
        assert int(store["gv"]) == gv == k, f"{name} gv"
        assert fps[name] == fps["pcc"], name
    tw, ts = card["destm"][1], card["destm serial walk"][1]
    for f in TRACE_FIELDS:
        if f not in ("retry_waves", "waves_per_round"):
            assert torch.equal(getattr(tw, f), getattr(ts, f)), \
                f"destm wave != serial walk: {f}"
    assert int(tw.retry_waves) <= int(ts.retry_waves)

    # OCC: the arrival decides the outcome; the commit order replays
    occ, occ_rand = card["occ"], card["occ random arrival"]
    if fps["occ"] == fps["occ random arrival"]:
        log("  occ: both arrivals give one fingerprint on this batch")
        occ_witness()
    order = np.argsort(occ_rand[1].commit_pos.cpu().numpy(), kind="stable")
    rseq = ReplaySequencer(order.tolist()).order_for(lanes.tolist())
    replay, _ = pcc_execute(make_store(N_OBJECTS, device="cuda"),
                            batch.to("cuda"),
                            torch_tensor(np.asarray(rseq, np.int32), "cuda"))
    assert torch.equal(replay.values, occ_rand[0].values), \
        "OCC's commit order replayed through PCC differs"
    launches = {name: r[3] for name, r in card.items()}
    assert launches["occ"]["conflict_matrix_bits_delta"] > 0
    assert launches["occ"]["conflict_matrix_bits_pair"] > 0
    assert launches["destm"]["conflict_matrix_bits_pair"] > 0

    # the card against the CPU, every engine and arrival
    cpu, t_cpu = cpu
    assert sorted(cpu) == sorted(card)
    for name, (fp, ct) in cpu.items():
        g = card[name]
        assert fingerprint(g[0]) == fp, f"{name} card != CPU"
        gt = convert.trace_to_numpy(g[1])
        for f in TRACE_FIELDS:
            assert np.array_equal(gt[f], ct[f]), f"{name} trace.{f}"

    for name, (store, trace, s, _, shapes) in card.items():
        log(f"  {name:20s} {s * 1e3:10.1f} ms/batch {k / s:8.1f} txns/s  "
            f"rounds {int(trace.rounds):5d}  wave_trips "
            f"{int(trace.wave_trips):5d}  retry_waves "
            f"{int(trace.retry_waves):5d}  barrier_ops "
            f"{int(trace.barrier_ops):6d}  launches {launches[name]}  "
            f"fp {fps[name]:#010x}")
        log(f"  {'':20s} by shape: {shapes or 'none'}")
    log(f"engines: K={k}, O={N_OBJECTS}, {N_LANES} lanes, one batch each: "
        f"PoGL, DeSTM (wave) and DeSTM (serial walk) == numpy serial oracle "
        f"== PCC; DeSTM wave == serial walk but for the wave fields "
        f"({int(tw.retry_waves)} <= {int(ts.retry_waves)} waves); OCC "
        f"fingerprints {fps['occ']:#010x} (sequence order) and "
        f"{fps['occ random arrival']:#010x} (random arrival), replayed "
        f"through PCC; every engine == its CPU run at K={k} "
        f"({t_cpu:.1f} s in the CPU referee) in every trace field")
    return launches


def pipelined_stream(wls):
    """Phase 10b's stream: the first ENGINES_CPU_K rows of each of the
    stream's first three batches, (batches, lanes)."""
    import torch
    k = ENGINES_CPU_K
    return ([w.batch.rows(torch.arange(k)) for w in wls[:3]],
            [w.lanes[:k] for w in wls[:3]])


def engine_stream_run(engine, depth, device, batches, lanes):
    """One engine's ``run_stream`` on a fresh session: (fingerprint,
    replay log, traces as numpy, seconds, the kernels' launches)."""
    from repro_torch import convert
    from repro_torch.core.session import PotSession
    from repro_torch.kernels import conflict, validate
    s = PotSession(N_OBJECTS, engine=engine, n_lanes=N_LANES,
                   pipeline_depth=depth, device=device)
    conflict.reset_launches()
    validate.reset_launches()
    traces, seconds = timed(lambda: s.run_stream(batches, lanes))
    return (s.fingerprint(), s.replay_log(),
            [convert.trace_to_numpy(t) for t in traces], seconds,
            dict(conflict.LAUNCHES, **validate.LAUNCHES))


def phase_engines_pipelined(wls, cpu):
    """Phase 10b: each engine's stream of the first ENGINES_CPU_K rows of
    the stream's first three batches through ``run_stream`` at depth
    2 on the card, held to its serial run on the card (every field but
    ``spec_*``) and to the pipelined run on the CPU (every field; from
    the CPU referee, ``cpu_engines_pipelined``); the card's two runs
    timed."""
    from repro_torch.core.engine import TRACE_FIELDS

    k = ENGINES_CPU_K
    batches, lanes = pipelined_stream(wls)
    cpu_seconds = 0.0
    for engine in ("pcc", "pogl", "destm", "occ"):
        # serial and pipelined on the card; pipelined on the CPU
        runs = [engine_stream_run(engine, depth, "cuda", batches, lanes)
                for depth in (0, 2)] + [cpu[engine]]
        cpu_seconds += runs[2][3]
        serial, piped = runs[0][2], runs[1][2]
        for (fp, replay, traces, _, _), device in zip(runs[1:],
                                                      ("cuda", "cpu")):
            assert fp == runs[0][0], f"{engine} fingerprints differ"
            assert replay == runs[0][1], f"{engine} replay logs differ"
            assert len(traces) == len(serial) == 3, engine
            for i, (a, b, c) in enumerate(zip(serial, traces, piped)):
                for f in TRACE_FIELDS:
                    assert np.array_equal(b[f], c[f]), \
                        f"{engine} batch {i} depth 2 on {device}: {f}"
                    if not f.startswith("spec_"):
                        assert np.array_equal(a[f], b[f]), \
                            f"{engine} batch {i} pipelined != serial: {f}"
        launches = runs[1][4]
        assert sum(int(t["spec_executed"]) for t in piped) == 3 * k
        assert launches["validate_bitsets"] > 0, engine
        ms = [r[3] * 1e3 for r in runs[:2]]
        log(f"  {engine:6s} 3 x {k} txns: serial {ms[0]:.1f}, pipelined "
            f"(depth 2) {ms[1]:.1f} ms; "
            f"spec_executed "
            f"{[int(t['spec_executed']) for t in piped]}, spec_invalidated "
            f"{[int(t['spec_invalidated']) for t in piped]}, spec_rounds "
            f"{[int(t['spec_rounds']) for t in piped]}; launches {launches}")
    log(f"engines pipelined: all four at depth 2 == their serial runs on "
        f"the card (every field but spec_*) == their CPU runs (every "
        f"field; {cpu_seconds:.1f} s in the CPU referee), K={k}, 3 batches")


def occ_witness():
    """OCC's nondeterminism on a small contended counters batch: eight
    arrivals on the card, more than one outcome."""
    import torch
    from repro_torch.core import workloads as W
    from repro_torch.core.occ import occ_execute
    from repro_torch.core.tstore import fingerprint, make_store
    wl = W.counters(n_txns=16, n_objects=8, n_reads=2, n_writes=2,
                    n_lanes=4, skew=0.0, seed=12, device="cuda")
    rng = np.random.default_rng(3)
    fps = {fingerprint(occ_execute(
        make_store(8, device="cuda"), wl.batch,
        torch_tensor(rng.permutation(16).astype(np.int32), "cuda"))[0])
        for _ in range(8)}
    assert len(fps) > 1, "OCC gave one outcome for eight arrivals"
    log(f"  occ witness (counters, K=16, 8 objects): {len(fps)} outcomes "
        f"from 8 arrivals")


def max_abs_diff(a, b, rows: int = 1 << 14) -> float:
    """max |a - b| in float32, ``rows`` leading rows at a time (a whole
    float32 copy of the 10 GB decode cache would not fit beside it)."""
    return max((float((x.float() - y.float()).abs().max())
                for x, y in zip(a.split(rows), b.split(rows))), default=0.0)


def kv_commit_inputs(rng, n_pages, page, h, n_slots, dtype):
    """A cache drawn on the card from a seeded generator and slot inputs
    drawn with numpy: pages repeat (a pool of n_slots / 4 pages), so do
    (page, row) pairs; a fifth of the slots skip; two to four carry page
    ids past either end; row ids run past both ends of the page."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(
        int(rng.integers(1 << 30)))
    cache = torch.randn((n_pages, page, h), generator=gen, device="cuda",
                        dtype=dtype)
    versions = torch.zeros((n_pages,), dtype=torch.int32, device="cuda")
    pool = rng.choice(n_pages, max(1, n_slots // 4), replace=False)
    page_idx = rng.choice(pool, n_slots)
    bad = [-1, n_pages, -n_pages - 3, n_pages + 7][:max(2, n_slots // 32)]
    page_idx[rng.choice(n_slots, len(bad), replace=False)] = bad
    meta = [page_idx, rng.integers(-page - 2, page + 2, n_slots),
            rng.permutation(n_slots) + 1, rng.random(n_slots) < 0.8]
    meta = [torch.from_numpy(np.asarray(a, np.int32)).cuda() for a in meta]
    rows = torch.from_numpy(
        rng.normal(size=(n_slots, h)).astype(np.float32)).cuda()
    return cache, versions, rows, meta


def kv_commit_bytes(page_idx, row_idx, commit, n_pages, page, h, elem):
    """Bytes this run's commit must move: the winning rows read (float32)
    and written (cache type), each page's version written once, and the
    16 bytes of metadata of every slot."""
    from repro_torch.kernels.ref import page_row
    rows, pages = set(), set()
    for p, r, c in zip(page_idx.tolist(), row_idx.tolist(), commit.tolist()):
        if c and 0 <= p < n_pages:
            rows.add((p, page_row(r, page)))
            pages.add(p)
    return len(rows) * h * (4 + elem) + 4 * len(pages) + 16 * len(page_idx)


def kv_commit_bare(cache, versions, rows, meta) -> None:
    """A launch of the commit's entry point for ``cache``'s dtype through
    the shared ctypes path, with no wrapper and not counted in
    ``LAUNCHES``: what the wrapper's own host work costs, by difference."""
    import torch
    from repro_torch.kernels import _build
    dtype = "bf16" if cache.dtype == torch.bfloat16 else "f32"
    n_pages, page, h = cache.shape
    _build.launch("kv_commit", "pot_kv_commit_" + dtype, cache.device,
                  cache.data_ptr(), versions.data_ptr(), rows.data_ptr(),
                  *(t.data_ptr() for t in meta), n_pages, page, h,
                  rows.shape[0])


def phase_kv_commit():
    """The ordered paged-commit kernel vs its plain version, bitwise, at
    three shapes; its host-rate and device-only times beside an empty
    launch's, and at the session's store at decode_32k's size the
    functional route (clones, then the commit) against the in-place one."""
    import torch
    from repro_torch.kernels import kv_commit, ops, ref
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.serve.session import META_WIDTH

    cfg = get_config(SERVE_ARCH)
    big = SHAPES["decode_32k"]
    page = 16
    big_pages = big.global_batch * big.seq_len // page
    shapes = {
        "session": (SERVE_SLOTS * SERVE_MAX_SEQ // page, page, META_WIDTH,
                    SERVE_SLOTS, torch.float32),
        "decode_32k": (big_pages, page, cfg.n_kv_heads * cfg.hd,
                       big.global_batch, torch.bfloat16),
        # the serving session's own store at decode_32k's slots and
        # positions: what one step's commit would clone on the
        # functional route
        "store_32k": (big_pages, page, META_WIDTH, big.global_batch,
                      torch.float32),
    }
    rng = np.random.default_rng(SEED)
    empty = lambda: kv_commit.empty_launch("cuda")
    floor, floor_dev = host_rate_ms(empty), graph_time_ms(empty)
    log(f"kv_commit: empty launch {floor[0]:.5f}-{floor[1]:.5f} ms at the "
        f"host's rate (best and worst of 5 rounds of 200 calls), "
        f"{floor_dev:.5f} ms device only (CUDA graph of 200)")
    out = {}
    for label, (n_pages, page, h, n_slots, dtype) in shapes.items():
        cache, versions, rows, meta = kv_commit_inputs(
            rng, n_pages, page, h, n_slots, dtype)
        got_c, got_v = ops.kv_cache_commit(cache, versions, rows, *meta)
        exp_c, exp_v = ref.kv_commit_ref(cache, versions, rows, *meta)
        torch.cuda.synchronize()
        assert torch.equal(got_c.view(torch.uint8), exp_c.view(torch.uint8)
                           ), f"kv_commit != plain ({label})"
        assert torch.equal(got_v, exp_v), f"kv_commit versions ({label})"
        changed = int((got_v != versions).sum())
        assert changed > 0, "no page committed"
        err = max(max_abs_diff(got_c, exp_c), max_abs_diff(got_v, exp_v))
        del exp_c, exp_v
        # committing the same step again leaves the committed state as it
        # is, so every timed call sees the same work
        commit_ = lambda: ops.kv_cache_commit_(got_c, got_v, rows, *meta)
        t, t_dev = host_rate_ms(commit_), graph_time_ms(commit_)
        bare_ = lambda: kv_commit_bare(got_c, got_v, rows, meta)
        bare, bare_dev = host_rate_ms(bare_), graph_time_ms(bare_)
        t_plain = cuda_time_ms(
            lambda: ref.kv_commit_ref_(got_c, got_v, rows, *meta), 5)
        t_clone = cuda_time_ms(lambda: (cache.clone(), versions.clone()),
                               10)
        nbytes = kv_commit_bytes(meta[0].cpu(), meta[1].cpu(), meta[3].cpu(),
                                 n_pages, page, h, cache.element_size())
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"kv_commit {label}: cache ({n_pages}, {page}, {h}) "
            f"{str(dtype).split('.')[-1]} "
            f"({cache.numel() * cache.element_size() / 1e9:.3f} GB), "
            f"S={n_slots}, {changed} pages stamped: kernel in place "
            f"{t[0]:.5f}-{t[1]:.5f} ms at the host's rate, {t_dev:.5f} ms "
            f"device only; bare launch {bare[0]:.5f}-{bare[1]:.5f} / "
            f"{bare_dev:.5f} ms; plain {t_plain:.4f} ms, "
            f"clone of cache+versions {t_clone:.4f} ms, bound "
            f"{bound_ms:.3e} ms ({nbytes} bytes), all bitwise equal")
        if label == "store_32k":
            functional = cuda_time_ms(lambda: ops.kv_cache_commit(
                cache, versions, rows, *meta), 20)
            in_place = cuda_time_ms(commit_, 20)
            log(f"  one serving step's commit at this store: functional "
                f"route (clone, commit) {functional:.4f} ms, in place "
                f"{in_place:.5f} ms (20 calls each at the host's rate)")
        # ms at the host's rate as on every row (the best of the rounds),
        # the card's own time beside it
        out[label] = dict(max_abs_err=err, ms=t[0], plain_ms=t_plain,
                          bound_ms=bound_ms, bound_by="bytes",
                          library_ms=None, device_ms=t_dev,
                          floor_ms=floor[0], floor_device_ms=floor_dev,
                          clone_ms=t_clone)
        del cache, versions, rows, meta, got_c, got_v
        torch.cuda.empty_cache()
    return out["session"]


def weight_bytes(params) -> int:
    """Bytes of the weights one decode step streams: every layer, the
    final norm and the head; the embedding is a gather of B rows."""
    import torch

    def size(t) -> int:
        if torch.is_tensor(t):
            return t.numel() * t.element_size()
        return sum(map(size, t.values() if isinstance(t, dict) else t))

    return size([params["layers"], params["final_norm"], params["head"]])


def serve_replicas(cfg, params):
    """SERVE_SLOTS requests through a ``Session`` for SERVE_STEPS greedy
    steps, twice, the second time with the arrivals reversed: tokens and
    ``fingerprint()`` bitwise equal, every token in the vocabulary and
    the commit kernel launched.  Returns (slot 0's tokens, fingerprint,
    the host seconds of each step of both runs, kv_commit launches)."""
    import torch
    from repro_torch.kernels import kv_commit
    from repro_torch.serve.session import Session

    requests = [(s, 3 + 7 * s) for s in range(SERVE_SLOTS)]
    torch.cuda.synchronize()
    kv_commit.reset_launches()
    runs = []
    for order in (requests, requests[::-1]):
        sess = Session(cfg, params, n_slots=SERVE_SLOTS,
                       max_seq=SERVE_MAX_SEQ, device="cuda")
        for slot, tok in order:
            sess.add_request(slot, tok)
        store = (sess.page_meta, sess.page_versions)
        ptrs = [t.data_ptr() for t in store]
        toks, times = [], []
        for _ in range(SERVE_STEPS):
            t0 = time.perf_counter()
            toks.append(sess.step())   # returns host tokens: synchronised
            times.append(time.perf_counter() - t0)
        assert sess.page_meta is store[0] and \
            sess.page_versions is store[1] and \
            [t.data_ptr() for t in store] == ptrs, \
            f"{cfg.name}: the session's store was not committed in place"
        runs.append((np.stack(toks, axis=1), sess.fingerprint(), times))
        del sess
    torch.cuda.synchronize()
    launches = kv_commit.LAUNCHES["kv_commit"]
    (t1, f1, times1), (t2, f2, times2) = runs
    assert np.array_equal(t1, t2), f"{cfg.name}: replica tokens differ"
    assert f1 == f2, f"{cfg.name}: replica fingerprints differ"
    assert ((t1 >= 0) & (t1 < cfg.padded_vocab)).all()
    assert launches > 0, "kv_commit was never launched on the serving path"
    return t1[0], f1, times1 + times2, launches


def phase_serve():
    """Serving at full width and depth, two replicas."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    cfg = get_config(SERVE_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(
        torch.Generator(device="cuda").manual_seed(SEED), cfg)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    slot0, fp, times, launches = serve_replicas(cfg, params)
    ms = float(np.median(times)) * 1e3
    nbytes = weight_bytes(params)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"serve {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"weights {nbytes / 1e9:.3f} GB bf16 (init {t_init:.2f} s); "
        f"{SERVE_SLOTS} slots x {SERVE_STEPS} steps x 2 replicas: median "
        f"{ms:.3f} ms per step (first {times[0] * 1e3:.1f} ms), "
        f"{SERVE_SLOTS / ms * 1e3:.1f} tokens/s; weight-streaming bound "
        f"{bound:.3f} ms per step; peak allocated {peak:.2f} GB; "
        f"kv_commit launches {launches}; replicas (reversed arrivals) "
        f"bitwise identical, fingerprint {fp:#010x}")
    log(f"  slot 0 tokens: {slot0.tolist()}")
    profile_decode(params, cfg, ms)
    return params, launches


def device_profile(step, n_steps, step_ms, label):
    """Device time and kernel launches of ``n_steps`` calls of ``step``
    (torch.profiler), against the unprofiled step time: the device's
    busy share and the kernels that take it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        log(f"  profile of {label}: the profiler recorded no device time "
            f"(not measured)")
        return
    by_name: dict[str, list] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    device_ms = sum(map(sum, by_name.values())) / 1e3 / n_steps
    log(f"  profile of {n_steps} {label}: "
        f"{len(kernels) / n_steps:.0f} kernels and {device_ms:.3f} "
        f"ms of device time per step; busy "
        f"share {device_ms / step_ms:.3f} of the unprofiled median step")
    gemm = [t for name, times in by_name.items() for t in times
            if any(k in name for k in ("nvjet", "gemm", "cutlass", "xmma"))]
    log(f"    {sum(gemm) / 1e3 / n_steps:8.3f} ms "
        f"{len(gemm) / n_steps:6.0f}x  cuBLAS matrix products (all names)")
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:6]
    for name, times in top:
        log(f"    {sum(times) / 1e3 / n_steps:8.3f} ms "
            f"{len(times) / n_steps:6.0f}x  {name[:70]}")


def profile_decode(params, cfg, step_ms):
    """Device profile of PROFILED_STEPS decode steps of a fresh session."""
    from repro_torch.serve.session import Session

    sess = Session(cfg, params, n_slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ,
                   device="cuda")
    for s in range(SERVE_SLOTS):
        sess.add_request(s, 3 + 7 * s)
    sess.step()
    device_profile(sess.step, PROFILED_STEPS, step_ms, "decode steps")


def teacher_forced(params, cfg, device, dtype):
    """Logits of HELD_STEPS decode steps fed one token stream (from SEED,
    slots at scattered positions), and the final cache, as float32 on
    the CPU."""
    import torch
    from repro_torch.models import lm
    from repro_torch.tree import leaves
    rng = np.random.default_rng(SEED)
    cache = lm.init_cache(cfg, SERVE_SLOTS, SERVE_MAX_SEQ, device, dtype)
    pos = rng.integers(0, SERVE_MAX_SEQ - HELD_STEPS, SERVE_SLOTS)
    logits = []
    for _ in range(HELD_STEPS):
        tok = rng.integers(0, cfg.padded_vocab, (SERVE_SLOTS, 1))
        out, _ = lm.decode_step(
            params, cache, torch.from_numpy(tok).to(device),
            torch.from_numpy(pos.astype(np.int32)).to(device), cfg)
        logits.append(out.float().cpu())
        pos = pos + 1
    return torch.stack(logits), [t.float().cpu() for t in leaves(cache)]


def phase_serve_held(params):
    """Card vs CPU at full width, depth cut to HELD_LAYERS.

    The decode math is held in float32 (the same bf16 weights, upcast,
    on both sides), where the card and the CPU differ only in the order
    of float32 sums, at the reference tests' rtol = atol = 3e-2.  In
    bf16 the two round at other places, and at d_model 5120 that alone
    moves logits by more than 3e-2; there the card's distance from the
    float32 logits is held to at most twice the CPU's own.  The Pot half
    is held bitwise: a CPU session fed the card's logits commits the
    same pages."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve.session import Session

    cfg = dataclasses.replace(get_config(SERVE_ARCH), n_layers=HELD_LAYERS)
    card = dict(params, layers=params["layers"][:HELD_LAYERS])
    t0 = time.perf_counter()
    cpu = lm.params_to(card, "cpu")
    t_copy = time.perf_counter() - t0
    f32, bf16 = torch.float32, torch.bfloat16
    t0 = time.perf_counter()
    runs = {
        "card bf16": teacher_forced(card, cfg, "cuda", bf16),
        "card f32": teacher_forced(lm.params_to(card, "cuda", f32), cfg,
                                   "cuda", f32),
        "cpu bf16": teacher_forced(cpu, cfg, "cpu", bf16),
        "cpu f32": teacher_forced(lm.params_to(cpu, "cpu", f32), cfg, "cpu",
                                  f32),
    }
    t_runs = time.perf_counter() - t0
    torch.cuda.empty_cache()
    dist = lambda a, b: float((runs[a][0] - runs[b][0]).abs().max())
    assert all(torch.isfinite(r[0]).all() for r in runs.values())
    torch.testing.assert_close(runs["card f32"][0], runs["cpu f32"][0],
                               rtol=TOL, atol=TOL)
    for a, b in zip(runs["card f32"][1], runs["cpu f32"][1], strict=True):
        torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)
    card_err, cpu_err = dist("card bf16", "cpu f32"), dist("cpu bf16",
                                                           "cpu f32")
    assert card_err <= 2 * cpu_err, (card_err, cpu_err)
    a, b = runs["card bf16"][0], runs["cpu bf16"][0]
    over = int(((a - b).abs() > TOL + TOL * b.abs()).sum())
    log(f"serve held to account ({HELD_LAYERS} layers, full width; weights "
        f"to CPU in {t_copy:.1f} s; four teacher-forced runs of "
        f"{HELD_STEPS} steps in {t_runs:.1f} s): float32 logits max "
        f"|card - CPU| {dist('card f32', 'cpu f32'):.3e} within rtol = atol "
        f"= {TOL}, caches too; bf16 logits max |card - CPU f32| "
        f"{card_err:.5f} <= 2 x {cpu_err:.5f} (CPU bf16's own); bf16 max "
        f"|card - CPU| {dist('card bf16', 'cpu bf16'):.5f}, {over} of "
        f"{b.numel()} outside rtol = atol = {TOL}; logits std "
        f"{float(runs['cpu f32'][0].std()):.3f}")
    del runs

    # the committed state: a CPU session fed the card's logits
    g = Session(cfg, card, n_slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ,
                device="cuda")
    c = Session(cfg, cpu, n_slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ,
                device="cpu")
    card_decode = g._decode
    fed = []

    def card_recording(*args):
        out = card_decode(*args)
        fed.append(out[0].cpu())
        return out

    g._decode = card_recording
    c._decode = lambda p, cache, t, po: (fed[-1], cache)
    for s in range(SERVE_SLOTS):
        g.add_request(s, 3 + 7 * s)
        c.add_request(s, 3 + 7 * s)
    for _ in range(SERVE_STEPS):
        card_tokens = g.step()          # records the logits c is fed
        assert np.array_equal(card_tokens, c.step()), "tokens differ"
    assert torch.equal(g.page_meta.cpu(), c.page_meta), "page_meta"
    assert torch.equal(g.page_versions.cpu(), c.page_versions), "versions"
    assert g.fingerprint() == c.fingerprint(), "fingerprints differ"
    log(f"  CPU session fed the card's logits for {SERVE_STEPS} steps == "
        f"card session on tokens, page_meta, page_versions and fingerprint "
        f"{g.fingerprint():#010x}")


def bitwise_equal(got, exp) -> bool:
    """Pairwise equal tensors, float32 ones compared as bits (so -0.0 and
    0.0, or two NaN payloads, differ)."""
    import torch
    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
    return all(a.dtype == b.dtype and torch.equal(bits(a), bits(b))
               for a, b in zip(got, exp, strict=True))


def adamw_bare(entry, tensors, *sizes):
    """A launch of an AdamW kernel on ``tensors`` (inputs, then the given
    outputs) through the same ctypes path as its wrapper, not counted in
    ``LAUNCHES``: the kernel's time without the wrapper's allocation of
    fresh outputs, which deterministic mode fills."""
    import torch
    from repro_torch.kernels import _build
    _build.launch("fused_adamw", entry, torch.device("cuda"),
                  *(t.data_ptr() for t in tensors), *sizes)


def phase_adamw():
    """Both AdamW kernels against their plain versions on the card,
    bitwise, at the training slice's leaf shapes."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import fused_adamw, ops, ref

    cfg = get_config(TRAIN_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    hp = fused_adamw.hp_vector(7, lr=TRAIN_LR, b1=0.9, b2=0.999, eps=1e-8,
                               wd=0.1, device="cuda")
    step7 = torch.tensor(7.0, device="cuda")
    moe_cfg = get_config("deepseek-moe-16b")
    shapes = {"embed": (cfg.padded_vocab, cfg.d_model),
              "w1": (cfg.d_model, cfg.d_ff), "norm": (cfg.d_model,),
              # phase 17's largest leaf of a new kind: an (E, D, F)
              # expert weight of deepseek-moe-16b
              "expert": (moe_cfg.n_experts, moe_cfg.d_model, moe_cfg.d_ff)}
    out = {}
    for leaf, shape in shapes.items():
        n = int(np.prod(shape))
        p = torch.randn(shape, generator=gen, device="cuda")
        m = torch.randn(shape, generator=gen, device="cuda") * 0.1
        v = torch.rand(shape, generator=gen, device="cuda") * 0.01
        g32 = torch.randn(shape, generator=gen, device="cuda")
        iters = max(5, min(200, int(2e9 // (n * 28))))
        for g in (g32, g32.bfloat16()):
            got = fused_adamw.fused_adamw(p, m, v, g, hp)
            exp = ref.adamw_ref(p, m, v, g, hp)
            torch.cuda.synchronize()
            assert bitwise_equal(got, exp), f"fused_adamw != plain ({leaf})"
            err = max(float((a - b).abs().max()) for a, b in zip(got, exp))
            del exp
            entry = "pot_adamw_bf16g" if g.dtype == torch.bfloat16 \
                else "pot_adamw_f32g"
            t = cuda_time_ms(
                lambda: adamw_bare(entry, (hp, p, m, v, g, *got), n), iters)
            t_dev = graph_time_ms(
                lambda: adamw_bare(entry, (hp, p, m, v, g, *got), n), iters,
                2)
            t_wrap = cuda_time_ms(
                lambda: fused_adamw.fused_adamw(p, m, v, g, hp), iters)
            t_plain = cuda_time_ms(lambda: ref.adamw_ref(p, m, v, g, hp),
                                   2, 1)
            # the yardstick updates the kernel's outputs in place
            t_lib = cuda_time_ms(lambda: torch._fused_adamw_(
                [got[0]], [g32], [got[1]], [got[2]], [], [step7],
                lr=TRAIN_LR, beta1=0.9, beta2=0.999, weight_decay=0.1,
                eps=1e-8, amsgrad=False, maximize=False), iters)
            nbytes = n * (26 if g.dtype == torch.bfloat16 else 28)
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            gname = str(g.dtype).split(".")[-1]
            log(f"fused_adamw {leaf} {shape} g {gname}: kernel {t:.4f} ms "
                f"({nbytes / t / 1e9:.3f} TB/s; {t_dev:.4f} device only), "
                f"wrapper {t_wrap:.4f} ms, "
                f"plain {t_plain:.4f} ms, torch._fused_adamw_ (f32 g) "
                f"{t_lib:.4f} ms, bound {bound_ms:.4f} ms (bytes), "
                f"bitwise equal")
            out[(leaf, gname)] = dict(
                max_abs_err=err, ms=t, plain_ms=t_plain, bound_ms=bound_ms,
                bound_by="bytes", library_ms=t_lib, wrapper_ms=t_wrap,
                device_ms=t_dev)
            if leaf in ("w1", "expert") and g is g32:
                kernel_ms, lib_ms = in_turns((
                    lambda: adamw_bare(entry, (hp, p, m, v, g, *got), n),
                    lambda: torch._fused_adamw_(
                        [got[0]], [g32], [got[1]], [got[2]], [], [step7],
                        lr=TRAIN_LR, beta1=0.9, beta2=0.999,
                        weight_decay=0.1, eps=1e-8, amsgrad=False,
                        maximize=False)), ADAMW_TURNS)
                log(f"  {leaf} in turns, {ADAMW_TURNS} calls each: kernel "
                    f"median {np.median(kernel_ms):.4f} ms (min "
                    f"{min(kernel_ms):.4f}, max {max(kernel_ms):.4f}), "
                    f"torch._fused_adamw_ median {np.median(lib_ms):.4f} "
                    f"ms (min {min(lib_ms):.4f}, max {max(lib_ms):.4f}); "
                    f"kernel / library "
                    f"{np.median(kernel_ms) / np.median(lib_ms):.3f}")
            del got
        del p, m, v, g32, g
        torch.cuda.empty_cache()

    # --- speculative: the MLP weight's shape, mixed versions ------------
    shape = shapes["w1"]
    rv = 1 << 24
    rng = np.random.default_rng(SEED)
    choices = np.array([0, rv - 5, rv, rv + 1, rv + 3, 1 << 30], np.int64)
    versions_np = rng.choice(choices, (shape[0] // 256, shape[1] // 256))
    versions_np[0, :len(choices)] = choices       # every case at least once
    versions_np = versions_np.astype(np.int32)
    stale_np = versions_np.astype(np.float32) > np.float32(rv)
    assert not stale_np[versions_np == rv + 1].any()   # 2^24 + 1: fresh
    versions = torch.from_numpy(versions_np).cuda()
    p = torch.randn(shape, generator=gen, device="cuda")
    m = torch.randn(shape, generator=gen, device="cuda") * 0.1
    v = torch.rand(shape, generator=gen, device="cuda") * 0.01
    g = torch.randn(shape, generator=gen, device="cuda")
    torch.cuda.synchronize()
    fused_adamw.reset_launches()
    got = ops.adamw_update_speculative(p, m, v, g, versions, rv, step=7,
                                       lr=TRAIN_LR, wd=0.1)
    torch.cuda.synchronize()
    launches = fused_adamw.LAUNCHES["fused_adamw_speculative"]
    assert launches == 1, launches
    hps = fused_adamw.hp_vector(7, lr=TRAIN_LR, b1=0.9, b2=0.999, eps=1e-8,
                                wd=0.1, rv=rv, device="cuda")
    exp = ref.adamw_speculative_ref(p, m, v, g, versions, hps)
    torch.cuda.synchronize()
    assert bitwise_equal(got, exp), "fused_adamw_speculative != plain"
    assert np.array_equal(got[3].cpu().numpy(), stale_np.astype(np.int32))
    spec_err = max(max_abs_diff(a, b) for a, b in zip(got, exp))
    del exp
    t = cuda_time_ms(lambda: adamw_bare(
        "pot_adamw_spec", (hps, versions, p, m, v, g, *got), *shape), 20)
    t_wrap = cuda_time_ms(lambda: fused_adamw.fused_adamw_speculative(
        p, m, v, g, versions, hps), 20)
    t_plain = cuda_time_ms(lambda: ref.adamw_speculative_ref(
        p, m, v, g, versions, hps), 2, 1)
    n_stale = int(stale_np.sum()) * 256 * 256
    n_fresh = p.numel() - n_stale
    nbytes = n_fresh * 28 + n_stale * 24 + 8 * versions.numel()
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"fused_adamw_speculative {shape} g float32, rv = 2^24, "
        f"{int(stale_np.sum())} of {stale_np.size} blocks stale (2^24 + 1 "
        f"fresh in float32): kernel {t:.4f} ms, wrapper {t_wrap:.4f} ms, "
        f"plain {t_plain:.4f} ms, bound {bound_ms:.4f} ms (bytes: 28 per "
        f"fresh element, 24 per stale one), launches in its drive "
        f"{launches}, bitwise equal")
    del p, m, v, g, got
    torch.cuda.empty_cache()
    results = {
        "fused_adamw": out[("embed", "float32")],
        "fused_adamw_speculative": dict(
            max_abs_err=spec_err, ms=t, plain_ms=t_plain, bound_ms=bound_ms,
            bound_by="bytes", library_ms=None, wrapper_ms=t_wrap)}
    return results, launches


def tree_digest(tree) -> list[int]:
    """A 64-bit digest of each leaf's bits: sum of word_i * (2i + 1)
    modulo 2^64, computed on the card (one changed word changes it)."""
    import torch
    from repro_torch.tree import leaves
    mask = (1 << 64) - 1
    out = []
    for t in leaves(tree):
        flat = t.detach().reshape(-1).view(torch.int32)
        acc = torch.zeros((), dtype=torch.int64, device=flat.device)
        for s in range(0, flat.numel(), 1 << 26):
            w = flat[s:s + (1 << 26)].to(torch.int64)
            idx = torch.arange(s, s + w.numel(), dtype=torch.int64,
                               device=w.device)
            acc += (w * (2 * idx + 1)).sum()
        out.append(int(acc) & mask)
    return out


def phase_train():
    """Training at full width, depth cut to TRAIN_LAYERS: two runs of
    TRAIN_STEPS pot steps from one seed, bitwise equal."""
    import torch
    from repro_torch import optim
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.kernels import fused_adamw
    from repro_torch.models import lm
    from repro_torch.train import init_state, make_train_step
    from repro_torch.tree import leaves

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH)
    step_fn = make_train_step(cfg, mode="pot", n_microbatches=TRAIN_MICRO,
                              lr=TRAIN_LR, wd=TRAIN_WD)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_adamw.reset_launches()
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        params = lm.init_params(
            torch.Generator(device="cuda").manual_seed(SEED), cfg,
            dtype=torch.float32)
        before = tree_digest(params)
        state = init_state(params)
        del params
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        losses, times = [], []
        for i in range(TRAIN_STEPS):
            batch = batch_at(dcfg, i, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step_fn(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(loss)
        peak = torch.cuda.max_memory_allocated() / 1e9
        after = tree_digest([state.params, state.opt["m"], state.opt["v"]])
        counters = (int(state.gv), int(state.step), int(state.opt["step"]))
        runs.append(dict(losses=torch.stack(losses).cpu(), times=times,
                         before=before, after=after, counters=counters,
                         peak=peak, t_init=t_init))
        if len(runs) == 1:
            del state
            torch.cuda.empty_cache()
    launches = fused_adamw.LAUNCHES["fused_adamw"]
    a, b = runs
    n_leaves = len(leaves(state.params))
    assert torch.equal(a["losses"], b["losses"]), "losses differ"
    assert a["after"] == b["after"], "parameters or moments differ"
    assert torch.isfinite(a["losses"]).all(), a["losses"]
    assert all(x != y for x, y in zip(a["before"], a["after"])), \
        "a parameter did not move"
    assert a["counters"] == (TRAIN_STEPS,) * 3, a["counters"]
    assert launches == 2 * TRAIN_STEPS * n_leaves, launches

    times = a["times"] + b["times"]
    ms = float(np.median(times)) * 1e3
    # one optimizer apply on its own, the moments standing in for grads
    grads = state.opt["m"]
    t_opt = cuda_time_ms(lambda: optim.adamw_update(
        state.params, grads, state.opt, lr=TRAIN_LR, wd=TRAIN_WD), 3, 1)
    n_params = sum(t.numel() for t in leaves(state.params))
    opt_bound = n_params * 28 / HBM_BYTES_PER_S * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    digest = hashlib.sha256(str(a["after"]).encode()).hexdigest()[:16]
    log(f"train {cfg.name} cut to {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {n_params:,} float32 parameters in {n_leaves} "
        f"leaves (init {a['t_init']:.2f} s); pot, {TRAIN_MICRO} "
        f"microbatches of {TRAIN_BATCH // TRAIN_MICRO} x {TRAIN_SEQ}, "
        f"{TRAIN_STEPS} steps x 2 runs: median {ms:.3f} ms per step (first "
        f"{a['times'][0] * 1e3:.1f} ms), {tokens / ms * 1e3:.1f} tokens/s; "
        f"optimizer apply {t_opt:.3f} ms ({t_opt / ms:.3f} of a step) "
        f"against its bound {opt_bound:.3f} ms (28 bytes per parameter); "
        f"peak allocated {a['peak']:.2f} GB; fused_adamw launches "
        f"{launches}; runs bitwise identical (losses and {3 * n_leaves} "
        f"leaves, digest {digest}), gv = step = {TRAIN_STEPS}")
    log(f"  losses: {a['losses'].tolist()}")
    del grads
    batch = batch_at(dcfg, TRAIN_STEPS, device="cuda")

    def profiled_step():
        nonlocal state
        state, _ = step_fn(state, batch)

    device_profile(profiled_step, 1, ms, "training step")
    del state
    torch.cuda.empty_cache()
    return launches, dict(after=a["after"], losses=a["losses"], ms=ms)


def train_runs(cfg, params, device, steps, dcfg):
    """``steps`` pot steps from ``params`` (copied to ``device``): the
    final state and the losses."""
    from repro_torch.data.pipeline import batch_at
    from repro_torch.models import lm
    from repro_torch.train import init_state, make_train_step
    step_fn = make_train_step(cfg, mode="pot", n_microbatches=TRAIN_MICRO,
                              lr=TRAIN_LR, wd=TRAIN_WD)
    state, losses = init_state(lm.params_to(params, device)), []
    for i in range(steps):
        state, loss = step_fn(state, batch_at(dcfg, i, device=device))
        losses.append(float(loss))
    return state, losses


def start_launcher(ckpt_dir):
    """The training launcher on the card, phase 9's last check, as its own
    process: the smoke configuration (90,368 parameters) for 4 steps, a
    few hundred small kernels.  Started early so that its start-up (an
    interpreter, torch, a CUDA context) runs beside other phases:
    (process, start time)."""
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         TRAIN_ARCH, "--smoke", "--steps", "4", "--ckpt-dir", ckpt_dir],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    ), time.perf_counter()


def phase_train_held(launcher):
    """The smoke configuration trained on the card against the CPU; the
    restart on the card; the launcher on the card (``start_launcher``'s
    process, awaited here).

    Card and CPU compute in bf16 with float32 accumulation and round at
    other places, as the port and the reference do on the CPU, so they
    are held to the tolerances the port's parity test holds the
    reference to (tests/test_torch_train.py): over HELD_TRAIN_STEPS
    steps, losses within rtol 1e-3, each leaf's first moment (the
    gradients' running sum) within 3e-2 in relative L2 norm and the
    second (squared gradients) within 6e-2.  The parameters are held
    after step 1, whose update is lr x (g / |g| + wd p): to rounding
    (rtol 1e-5, atol 1e-6) wherever |m| is clear of bf16 noise (above
    3e-2 of the leaf's largest), and elsewhere, where a near-zero
    gradient may take either sign, within 2 lr (1 + wd |p|).  The
    restart is held bitwise."""
    import torch
    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import lm
    from repro_torch.tree import leaves

    cfg = get_smoke_config(TRAIN_ARCH)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH)
    params = lm.init_params(torch.Generator().manual_seed(SEED), cfg,
                            dtype=torch.float32)
    card, card_losses = train_runs(cfg, params, "cuda", HELD_TRAIN_STEPS,
                                   dcfg)
    cpu, cpu_losses = train_runs(cfg, params, "cpu", HELD_TRAIN_STEPS, dcfg)
    np.testing.assert_allclose(card_losses, cpu_losses, rtol=1e-3)
    rel = lambda a, b: float((a.cpu() - b).norm() / b.norm())
    worst_m = max(rel(a, b) for a, b in zip(leaves(card.opt["m"]),
                                            leaves(cpu.opt["m"])))
    worst_v = max(rel(a, b) for a, b in zip(leaves(card.opt["v"]),
                                            leaves(cpu.opt["v"])))
    assert worst_m <= 3e-2 and worst_v <= 6e-2, (worst_m, worst_v)
    assert int(card.gv) == int(cpu.gv) == HELD_TRAIN_STEPS

    card1, _ = train_runs(cfg, params, "cuda", 1, dcfg)
    cpu1, _ = train_runs(cfg, params, "cpu", 1, dcfg)
    n_clear = n_all = 0
    worst_clear = worst_sign = 0.0
    for a, b, m in zip(leaves(card1.params), leaves(cpu1.params),
                       leaves(cpu1.opt["m"])):
        a = a.cpu()
        clear = m.abs() > 3e-2 * m.abs().max()
        assert clear.any()
        np.testing.assert_allclose(a[clear].numpy(), b[clear].numpy(),
                                   rtol=1e-5, atol=1e-6)
        worst_clear = max(worst_clear, float(
            ((a - b).abs() / (1e-6 + 1e-5 * b.abs()))[clear].max()))
        limit = 2 * TRAIN_LR * (1 + TRAIN_WD * float(b.abs().max())) + 1e-6
        d = float((a - b).abs().max())
        assert d <= limit, (d, limit)
        worst_sign = max(worst_sign, d / limit)
        n_clear += int(clear.sum())
        n_all += clear.numel()
    log(f"train held to account ({cfg.name}, {HELD_TRAIN_STEPS} pot steps, "
        f"card vs CPU): losses {card_losses} vs {cpu_losses}; moments "
        f"relative L2 at most m {worst_m:.3e} (<= 3e-2), v {worst_v:.3e} "
        f"(<= 6e-2); parameters after step 1: {n_clear} of {n_all} clear "
        f"of bf16 noise, at most {worst_clear:.3f} of rounding (rtol 1e-5, "
        f"atol 1e-6), the rest at most {worst_sign:.3f} of 2 lr (1 + wd |p|)")

    # restart on the card: 4 straight == 2 + save + restore + 2
    straight, losses = train_runs(cfg, params, "cuda", 4, dcfg)
    with tempfile.TemporaryDirectory() as d:
        half, _ = train_runs(cfg, params, "cuda", 2, dcfg)
        ck.save(d, 2, half, extra={"data_step": 2})
        fresh, _ = train_runs(cfg, params, "cuda", 0, dcfg)
        resumed, extra = ck.restore(d, 2, fresh)
    from repro_torch.data.pipeline import batch_at
    from repro_torch.train import make_train_step
    step_fn = make_train_step(cfg, mode="pot", n_microbatches=TRAIN_MICRO,
                              lr=TRAIN_LR, wd=TRAIN_WD)
    again = []
    for i in range(extra["data_step"], 4):
        resumed, loss = step_fn(resumed, batch_at(dcfg, i, device="cuda"))
        again.append(float(loss))
    assert again == losses[2:], (again, losses)
    assert bitwise_equal(leaves(straight), leaves(resumed)), \
        "restart differs"
    log(f"  restart on the card: 4 steps straight == 2 + save + restore + "
        f"2, bitwise on all {len(leaves(straight))} leaves and the losses")

    # the launcher, on the card
    proc, t0 = launcher
    stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, stderr[-4000:]
    assert stdout.rstrip().endswith("done"), stdout
    lines = stdout.strip().splitlines()
    log(f"  launcher on the card (started beside phase 12, awaited "
        f"{time.perf_counter() - t0:.1f} s later), exit 0: {lines[0]} | "
        f"{lines[-2]}")


def phase_legacy_scan(wl):
    """Phase 13: the frozen scan oracles on the card, the first SCAN_K
    rows of the main path's first batch, each bitwise equal to the port's
    vectorized engine on the card."""
    import torch
    from repro_torch.core import legacy_scan
    from repro_torch.core.destm import destm_execute
    from repro_torch.core.occ import occ_execute
    from repro_torch.core.pcc import pcc_execute
    from repro_torch.core.sequencer import RoundRobinSequencer
    from repro_torch.core.tstore import make_store

    batch = wl.batch.rows(torch.arange(SCAN_K)).to("cuda")
    lanes_np = np.asarray(wl.lanes[:SCAN_K], np.int32)
    seq = torch_tensor(np.asarray(RoundRobinSequencer(
        n_root_lanes=N_LANES).order_for(lanes_np.tolist()), np.int32), "cuda")
    lanes = torch_tensor(lanes_np, "cuda")
    arrival = torch_tensor(np.random.default_rng(SEED).permutation(
        SCAN_K).astype(np.int32), "cuda")
    store = make_store(N_OBJECTS, device="cuda")
    # the store and the trace fields tests/test_commit_pipeline.py compares
    runs = {
        "pcc": (lambda: legacy_scan.pcc_execute_scan(store, batch, seq),
                lambda: pcc_execute(store, batch, seq),
                ["commit_pos", "mode", "retries", "commit_round",
                 "first_round", "wait_rounds", "rounds", "exec_ops",
                 "validation_words", "promotions"]),
        "occ": (lambda: legacy_scan.occ_execute_scan(store, batch, arrival),
                lambda: occ_execute(store, batch, arrival),
                ["commit_pos", "retries", "commit_round", "rounds",
                 "exec_ops"]),
        "destm": (lambda: legacy_scan.destm_execute_scan(
                      store, batch, seq, lanes, N_LANES),
                  lambda: destm_execute(store, batch, seq, lanes, N_LANES),
                  ["commit_pos", "retries", "commit_round", "first_round",
                   "rounds", "exec_ops", "barrier_ops"]),
    }
    parts = []
    for name, (scan, engine, fields) in runs.items():
        (old, t_old), s_scan = timed(scan)
        (new, t_new), s_engine = timed(engine)
        for f in ("values", "versions", "gv"):
            assert torch.equal(getattr(old, f), getattr(new, f)), \
                f"{name} scan: store.{f} differs from the engine"
        for f in fields:
            assert torch.equal(getattr(t_old, f), getattr(t_new, f)), \
                f"{name} scan: trace.{f} differs from the engine"
        parts.append(f"{name} {s_scan:.3f} s ({int(t_old.rounds)} rounds; "
                     f"engine {s_engine:.3f} s)")
    log(f"scan oracle on the card (the main path's first batch cut to "
        f"K={SCAN_K}, O={N_OBJECTS}; the cut is in K only, since the "
        f"oracle walks one transaction at a time): {', '.join(parts)}; "
        f"each equal to the vectorized engine in the store and every "
        f"compared trace field")


def update_close(got, exp, before=None) -> float:
    """The largest share, over a leaf, of the bound |got - exp| <= 1e-7 +
    1e-5 max(|exp|, |before|) that tests/test_torch_optim.py holds
    Adafactor to."""
    import torch
    got, exp = got.float().cpu(), exp.float().cpu()
    scale = exp.abs() if before is None else torch.maximum(
        exp.abs(), before.float().cpu().abs())
    return float(((got - exp).abs() / (1e-7 + 1e-5 * scale)).max())


def phase_dp_train(trained):
    """Phase 14: ``make_pot_dp_step`` at full width (phase 8's model,
    batch and seed), one rank: two runs per optimizer bitwise equal,
    AdamW's bitwise equal to phase 8's pot step, and one Adafactor step
    of one full-width layer held to the CPU."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.kernels import fused_adamw
    from repro_torch.models import lm
    from repro_torch.optim import adafactor_init, adafactor_update
    from repro_torch.train import init_state, make_pot_dp_step
    from repro_torch.tree import leaves, tree_map

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    for optimizer in ("adamw", "adafactor"):
        # phase 8's pot step recomputes each layer in the backward pass
        step_fn = make_pot_dp_step(cfg, optimizer=optimizer,
                                   n_microbatches=TRAIN_MICRO, lr=TRAIN_LR,
                                   wd=TRAIN_WD, remat=True)
        fused_adamw.reset_launches()
        runs = []
        for _ in range(2):
            state = init_state(lm.init_params(
                torch.Generator(device="cuda").manual_seed(SEED), cfg,
                dtype=torch.float32), optimizer, cfg=cfg)
            losses, times = [], []
            for i in range(TRAIN_STEPS):
                batch = batch_at(dcfg, i, device="cuda")
                (state, loss), t = timed(lambda: step_fn(state, batch))
                losses.append(loss)
                times.append(t)
            opt = [state.opt["m"], state.opt["v"]] \
                if optimizer == "adamw" else [state.opt["stats"]]
            runs.append(dict(losses=torch.stack(losses).cpu(), times=times,
                             after=tree_digest([state.params, *opt]),
                             counters=(int(state.gv), int(state.step))))
            if len(runs) == 1:
                del state
                torch.cuda.empty_cache()
        a, b = runs
        assert torch.equal(a["losses"], b["losses"]), f"{optimizer}: losses"
        assert a["after"] == b["after"], f"{optimizer}: runs differ"
        assert torch.isfinite(a["losses"]).all(), a["losses"]
        assert a["counters"] == (TRAIN_STEPS, TRAIN_STEPS), a["counters"]
        launches = fused_adamw.LAUNCHES["fused_adamw"]
        ms = float(np.median(a["times"] + b["times"])) * 1e3
        digest = hashlib.sha256(str(a["after"]).encode()).hexdigest()[:16]
        line = (f"dp train ({optimizer}) {cfg.name} cut to {cfg.n_layers} "
                f"layers, one rank, {TRAIN_MICRO} microbatches of "
                f"{TRAIN_BATCH // TRAIN_MICRO} x {TRAIN_SEQ}, {TRAIN_STEPS} "
                f"steps x 2 runs: median {ms:.3f} ms per step, "
                f"{tokens / ms * 1e3:.1f} tokens/s; fused_adamw launches "
                f"{launches}; runs bitwise identical (digest {digest})")
        if optimizer == "adamw":
            assert launches == 2 * TRAIN_STEPS * len(leaves(state.params))
            # the ring of one rank is the identity and x / 1 == x, so the
            # DP step computes phase 8's pot step's operations
            same = (a["after"] == trained["after"]
                    and torch.equal(a["losses"], trained["losses"]))
            assert same, "the one-rank DP step differs from phase 8"
            line += (f"; bitwise equal to phase 8's pot step (median "
                     f"{trained['ms']:.3f} ms there)")
        else:
            assert launches == 0, launches
            # one update on its own, the parameters standing in for grads
            n_params = sum(t.numel() for t in leaves(state.params))
            stat_bytes = 8 * sum(t.numel()
                                 for t in leaves(state.opt["stats"]))
            t_upd = cuda_time_ms(lambda: adafactor_update(
                state.params, state.params, state.opt, lr=TRAIN_LR), 3, 1)
            upd_bound = (12 * n_params + stat_bytes) / HBM_BYTES_PER_S * 1e3
            line += (f"; the Adafactor update {t_upd:.3f} ms "
                     f"({t_upd / ms:.3f} of a step) against its bound "
                     f"{upd_bound:.3f} ms (bytes: p and g read, p written, "
                     f"{stat_bytes / 1e6:.1f} MB of factored statistics "
                     f"read and written)")
        log(line)
        log(f"  losses: {a['losses'].tolist()}")
        del state
        torch.cuda.empty_cache()

    # one Adafactor step of one full-width layer, card against CPU
    layer = {"layers": [lm.init_params(
        torch.Generator(device="cuda").manual_seed(SEED + 1),
        dataclasses.replace(cfg, n_layers=1),
        dtype=torch.float32)["layers"][0]]}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=gen,
                                           device="cuda"), layer)
    card_p, card_s = adafactor_update(layer, grads, adafactor_init(layer),
                                      lr=TRAIN_LR)
    cpu = lambda t: tree_map(lambda x: x.cpu(), t)
    cpu_p, cpu_s = adafactor_update(cpu(layer), cpu(grads),
                                    adafactor_init(cpu(layer)), lr=TRAIN_LR)
    worst = max(
        [update_close(a, b, p) for a, b, p in zip(
            leaves(card_p), leaves(cpu_p), leaves(cpu(layer)))]
        + [update_close(a, b) for a, b in zip(leaves(card_s),
                                              leaves(cpu_s))])
    assert worst <= 1.0, worst
    n_layer = sum(t.numel() for t in leaves(layer))
    log(f"  one Adafactor step of one full-width layer ({n_layer:,} "
        f"parameters), card against CPU: within rtol 1e-5, atol 1e-7 of "
        f"the larger of |p| and |p'| (at most {worst:.3f} of that bound)")
    del layer, grads, card_p, card_s
    torch.cuda.empty_cache()


def phase_ring():
    """Phase 15: the fixed ring's order and top-k compression on the card,
    bitwise equal to the CPU.  One card has no second rank, so the ring's
    sum is taken in one process (``ordered_ring_sum``, the ring's chunk
    order); the cross-process ring runs only in the CPU tests over gloo,
    and over NCCL across cards it waits for a machine with several."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.optim import (error_feedback_init, ordered_ring_sum,
                                   topk_compress)

    cfg = get_config(TRAIN_ARCH)
    shape = (cfg.d_model, cfg.d_ff)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    stacked = torch.randn((RING_RANKS,) + shape, generator=gen,
                          device="cuda")
    stacked.mul_(torch.exp2(torch.randint(-8, 9, stacked.shape,
                                          generator=gen, device="cuda")))
    host = stacked.cpu()
    got = ordered_ring_sum(stacked)
    t0 = time.perf_counter()
    exp = ordered_ring_sum(host)
    cpu_s = time.perf_counter() - t0
    assert bitwise_equal([got.cpu()], [exp]), "ring order: card != CPU"
    # within rtol 1e-5 of a plain sum, relative to the summed magnitudes
    # (a sum of signed terms may cancel to near zero)
    plain = stacked.sum(0)
    assert bool(((got - plain).abs()
                 <= 1e-5 * stacked.abs().sum(0)).all()), "ring vs sum"
    t_ring = cuda_time_ms(lambda: ordered_ring_sum(stacked), 5)
    t_sum = cuda_time_ms(lambda: stacked.sum(0), 5)
    ring_bound = stacked.numel() * 4 * (1 + 1 / RING_RANKS) \
        / HBM_BYTES_PER_S * 1e3
    del plain, host

    grads = {"w1": got}
    resid = error_feedback_init(grads)
    (sparse, new_r), t_c = timed(lambda: topk_compress(grads, resid,
                                                       ratio=TOPK_RATIO))
    cpu_grads = {"w1": exp}
    t0 = time.perf_counter()
    cpu_sparse, cpu_r = topk_compress(cpu_grads, error_feedback_init(
        cpu_grads), ratio=TOPK_RATIO)
    cpu_c = time.perf_counter() - t0
    assert bitwise_equal([sparse["w1"].cpu(), new_r["w1"].cpu()],
                         [cpu_sparse["w1"], cpu_r["w1"]]), \
        "topk_compress: card != CPU"
    kept = int((sparse["w1"] != 0).sum())
    t_topk = cuda_time_ms(lambda: topk_compress(grads, resid,
                                                ratio=TOPK_RATIO), 3, 1)
    log(f"ring order on the card: {RING_RANKS} ranks' contributions of w1's "
        f"gradient {shape} float32 summed in the ring's chunk order "
        f"(ordered_ring_sum) {t_ring:.3f} ms (torch.sum over the ranks "
        f"{t_sum:.3f} ms, bound {ring_bound:.3f} ms by bytes; CPU "
        f"{cpu_s * 1e3:.1f} ms), bitwise equal to the CPU and within 1e-5 "
        f"of the summed magnitudes of torch.sum; topk_compress at ratio {TOPK_RATIO} "
        f"{t_topk:.3f} ms (first call {t_c * 1e3:.1f} ms; CPU "
        f"{cpu_c * 1e3:.1f} ms), {kept:,} of {got.numel():,} kept, bitwise "
        f"equal to the CPU.  The cross-process ring (ordered_ring_reduce) "
        f"runs in the CPU tests over gloo; NCCL across cards waits for a "
        f"machine with several")
    del stacked, got, exp, sparse, new_r, resid, grads
    torch.cuda.empty_cache()


def shard_kernel_line(name, m, n, ws, per_ms, loop_ms, dense_ms, plain_ms,
                      bnd, extra=""):
    return (f"  {name} ({m}, {n}) x W_s={ws}: one shard {per_ms[0]:.4f} "
            f"ms ({per_ms[1]:.4f} device only), "
            f"the {SHARDS} shards' launches {loop_ms:.4f} ms, the dense "
            f"call at W={SHARDS * ws} {dense_ms:.4f} ms, plain (one shard) "
            f"{plain_ms:.4f} ms, bound (one shard) {bnd[0]:.4f} ms "
            f"({bnd[1]}){extra}; every shard bitwise equal to its plain "
            f"version, their OR to the dense kernel's")


def phase_shard_kernels(wls, n_live: int):
    """The three kernels of the sharded path at the shard-local width
    W_s = ceil(ceil(O/S)/32): each launch against its plain version,
    the OR of the S shard outputs against the dense kernel's output at
    W = ceil(O/32) on the same batch, and their times and bounds; the
    delta with ``n_live`` rows live."""
    import torch
    from repro_torch.core.sequencer import RoundRobinSequencer
    from repro_torch.core.tstore import StoreLayout, make_store
    from repro_torch.core.txn import run_all
    from repro_torch.kernels import conflict, ops, ref, validate

    mma_rate = rate_probe()["bmma"]
    layout = StoreLayout(N_OBJECTS, SHARDS)
    ws = layout.words_per_shard
    batch0, batch1 = (w.batch.to("cuda") for w in wls[:2])
    store = make_store(N_OBJECTS, device="cuda")
    res = run_all(batch0, store.values)
    foot, write = ops.packed_footprints(res.raddrs, res.rn, res.waddrs,
                                        res.wn, N_OBJECTS)
    sfoot, swrite = ops.packed_footprints_sharded(
        res.raddrs, res.rn, res.waddrs, res.wn, layout)
    assert sfoot.shape == (SHARDS, K, ws)
    # the pending suffix in the sequence order, as the compact rungs
    # and a full-rung round see it
    seq = RoundRobinSequencer(n_root_lanes=N_LANES).order_for(
        wls[0].lanes.tolist())
    rank = torch.from_numpy(np.argsort(np.argsort(seq, kind="stable"),
                                       kind="stable")).to("cuda")

    def check(kernel, plain, shard_args, dense_args):
        outs = []
        for args in shard_args:
            out = kernel(*args)
            assert torch.equal(out, plain(*args)), \
                f"{kernel.__name__} != plain version at W_s = {ws}"
            outs.append(out)
        ored = outs[0].clone()
        for out in outs[1:]:
            ored |= out
        dense = kernel(*dense_args)
        assert torch.equal(ored, dense), \
            f"OR over shards != dense {kernel.__name__}"
        per = cuda_time_ms(lambda: kernel(*shard_args[0]), 50)
        per_dev = graph_time_ms(lambda: kernel(*shard_args[0]), 50)
        loop = cuda_time_ms(lambda: [kernel(*a) for a in shard_args], 20)
        whole = cuda_time_ms(lambda: kernel(*dense_args), 20)
        plain_ms = cuda_time_ms(lambda: plain(*shard_args[0]), 2, 1)
        return (per, per_dev), loop, whole, plain_ms

    out = {}
    suffix = rank >= K - 256
    for name, (ri, ci) in (("pair", (suffix, None)),
                           ("pair", (None, suffix))):
        pick = lambda t, sel: t if sel is None else t[sel]
        shard_args = [(pick(sfoot[s], ri), pick(swrite[s], ci))
                      for s in range(SHARDS)]
        m, n = shard_args[0][0].shape[0], shard_args[0][1].shape[0]
        per, loop, whole, plain_ms = check(
            conflict.conflict_matrix_bits_pair,
            ref.conflict_matrix_bits_pair_ref, shard_args,
            (pick(foot, ri), pick(write, ci)))
        bnd = bound(m * n * ws, (m + n) * ws * 4 + m * n, mma_rate)
        log(shard_kernel_line(name, m, n, ws, per, loop, whole, plain_ms,
                              bnd, f", plan "
                              f"{plan_line(conflict.launch_plan(m, n, ws))}"))
        out[f"pair ({m}, {n})"] = (per, loop, whole, bnd[0])

    # delta: a full-rung round's live rows, the pending suffix
    live = rank >= K - n_live
    rng = np.random.default_rng(SEED)
    old = torch.from_numpy(rng.random((K, K)) < 0.5).cuda()
    shard_args = [(sfoot[s], swrite[s], old, live) for s in range(SHARDS)]
    per, loop, whole, plain_ms = check(
        conflict.conflict_matrix_bits_delta,
        ref.conflict_matrix_bits_delta_ref, shard_args,
        (foot, write, old, live))
    refresh = int((live[:, None] | live[None, :]).sum())
    bnd = bound(refresh * ws, 2 * K * ws * 4 + 2 * K * K + K, mma_rate)
    log(shard_kernel_line("delta", K, K, ws, per, loop, whole, plain_ms,
                          bnd, f", {n_live} live rows, "
                          f"{conflict.delta_cuts(K, ws)[n_live][0]} slices"))
    out["delta"] = (per, loop, whole, bnd[0])

    # validate: batch 1's read sets (its speculation) against the dirty
    # words of every address batch 0 writes
    res1 = run_all(batch1, store.values)
    slots = torch.arange(res.waddrs.shape[1], device="cuda")
    written = res.waddrs[slots[None, :] < res.wn[:, None]].long()
    versions = store.versions.clone()
    versions[written] = 1
    snap = torch.zeros((), dtype=torch.int32, device="cuda")
    valid = slots[None, :] < res1.rn[:, None]
    sread = ops._pack_sharded(res1.raddrs, valid, layout)
    sversions = torch.nn.functional.pad(
        versions, (0, layout.padded_objects - N_OBJECTS)).view(SHARDS, -1)
    sdirty = ops.spec_dirty_words_sharded(sversions, snap, layout)
    read = validate.pack_addr_sets(res1.raddrs, res1.rn, N_OBJECTS)
    dirty = ops.spec_dirty_words(versions, snap, N_OBJECTS)
    per, loop, whole, plain_ms = check(
        validate.validate_bitsets, ref.validate_bitsets_ref,
        [(sread[s], sdirty[s]) for s in range(SHARDS)], (read, dirty))
    assert torch.equal(
        ops.spec_read_invalid_sharded(res1.raddrs, res1.rn, sversions, snap,
                                      layout),
        ops.spec_read_invalid(res1.raddrs, res1.rn, versions, snap,
                              N_OBJECTS)), "spec_read_invalid sharded"
    bnd = bound(K * ws, K * ws * 4 + ws * 4 + K)
    log(shard_kernel_line("validate", K, 1, ws, per, loop, whole, plain_ms,
                          bnd))
    out["validate"] = (per, loop, whole, bnd[0])
    return out


def phase_sharded(wls, dense, served):
    """Phase 11: the main path's store in SHARDS range shards at full
    width, held bitwise to phase 3's dense run; the kernels at the
    shard-local width; one pipelined sharded drain of phase 3b's
    journal, held to phase 3b's depth-0 serve."""
    import torch
    from repro_torch import convert
    from repro_torch.core.engine import TRACE_FIELDS
    from repro_torch.core.ingress import IngressPool
    from repro_torch.core.session import PotSession
    from repro_torch.core.tstore import unshard_store
    from repro_torch.kernels import conflict, validate

    s = PotSession(N_OBJECTS, engine="pcc", n_lanes=N_LANES, shards=SHARDS,
                   device="cuda")
    torch.cuda.synchronize()
    conflict.reset_launches()
    validate.reset_launches()
    traces, seconds = timed(lambda: s.run_stream(
        [w.batch for w in wls], [w.lanes for w in wls]))
    launches = dict(conflict.LAUNCHES)
    shapes = shape_counts()
    for name, n in launches.items():
        assert n > 0, f"{name} was never launched on the sharded path"
    assert s.fingerprint() == dense["fingerprint"], "sharded fingerprint"
    assert s.replay_log() == dense["replay_log"], "sharded replay log"
    for i, (a, b) in enumerate(zip(traces, dense["traces"])):
        a = convert.trace_to_numpy(a)
        for f in TRACE_FIELDS:
            assert np.array_equal(a[f], b[f]), f"sharded batch {i} {f}"
    flat = unshard_store(s.store)
    assert np.array_equal(flat.values.cpu().numpy(), dense["values"])
    assert np.array_equal(flat.versions.cpu().numpy(), dense["versions"])
    n_txns = len(wls) * K
    rounds = [int(t.rounds) for t in traces]
    log(f"sharded store: {n_txns} txns in {len(wls)} batches, O="
        f"{N_OBJECTS} in {SHARDS} shards of {s.store.shard_size} (W_s = "
        f"{s.store.layout.words_per_shard} words): {seconds:.3f} s "
        f"({seconds / len(wls):.3f} s a batch, {n_txns / seconds:.1f} "
        f"txns/s) against the dense run's {dense['seconds']:.3f} s "
        f"({dense['seconds'] / len(wls):.3f} s a batch) earlier in this "
        f"call: {seconds / dense['seconds']:.3f} x; rounds {rounds}; "
        f"fingerprint, replay log, store and every trace field bitwise "
        f"equal to the dense run; launches {launches}")
    log(f"  by shape: {shapes}")
    # the delta's live count: the median of the full-rung rounds' (every
    # round whose pending suffix does not fit the widest compact rung)
    lpr = traces[0].live_counts()
    kernels = phase_shard_kernels(wls, int(np.median(lpr[lpr > K // 4])))
    per_round = {name: v[1] - v[2] for name, v in kernels.items()}
    log(f"  {SHARDS} shard launches minus one dense call, ms: "
        + ", ".join(f"{k} {v:+.4f}" for k, v in per_round.items()))

    # one pipelined sharded drain: two batches of phase 3b's journal at
    # depth 2 (the cross-batch validation per shard on the validation
    # kernel), held to phase 3b's depth-0 serve of the same batches
    pool = IngressPool.replay(served["journal"])[0]
    sp = PotSession(N_OBJECTS, engine="pcc", n_lanes=N_LANES, shards=SHARDS,
                    pipeline_depth=2, device="cuda")
    torch.cuda.synchronize()
    conflict.reset_launches()
    validate.reset_launches()
    ptraces, pseconds = timed(lambda: sp.serve(pool, budget=K,
                                               max_batches=2))
    plaunches = dict(conflict.LAUNCHES, **validate.LAUNCHES)
    assert len(ptraces) == 2 and sp.n_txns == 2 * K
    assert plaunches["validate_bitsets"] >= SHARDS, plaunches
    assert plaunches["conflict_matrix_bits_delta"] > 0, plaunches
    assert sum(int(t.spec_executed) for t in ptraces) == 2 * K
    log_ = sp.replay_log()
    assert log_ == served["replay_log"][:len(log_)] and len(log_) == 2 * K
    for i, (a, b) in enumerate(zip(ptraces, served["traces"])):
        a = convert.trace_to_numpy(a)
        for f in TRACE_FIELDS:
            if not f.startswith("spec_"):
                assert np.array_equal(a[f], b[f]), \
                    f"pipelined sharded batch {i} {f}"
    log(f"  pipelined sharded drain (depth 2, budget {K}, 2 batches of "
        f"phase 3b's journal): {pseconds:.3f} s, spec_invalidated "
        f"{[int(t.spec_invalidated) for t in ptraces]}, launches "
        f"{plaunches}; equal to phase 3b's depth-0 serve in every trace "
        f"field but spec_* and in the replay log")
    log(f"    by shape: {shape_counts()}")
    return s, plaunches


def phase_recovery(served, sharded):
    """Phase 12: a replica of phase 3b's serve killed and resumed on the
    card, a snapshot at S shards restored at 1 and 4, and a SIGKILLed
    replica subprocess restored by another."""
    import torch
    from repro_torch.core.checkpoint import (FaultInjected, FaultPlan,
                                             load_snapshot, run_replica,
                                             snapshot_ids, trace_digest)
    from repro_torch.core.session import PotSession
    from repro_torch.core.tstore import unshard_store

    journal = served["journal"]
    kw = dict(n_objects=N_OBJECTS, engine="pcc", n_lanes=N_LANES,
              budgets=(K,), device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        victim = os.path.join(tmp, "victim")
        plan = FaultPlan(kill_batch=1, kill_phase="execute", action="raise")
        t0 = time.perf_counter()
        try:
            run_replica(journal, directory=victim, snapshot_every=1,
                        fault_plan=plan, **kw)
        except FaultInjected as e:
            t_victim = time.perf_counter() - t0
            log(f"recovery: the victim died as planned ({e}) after "
                f"{t_victim:.1f} s, snapshots {snapshot_ids(victim)}")
        else:
            raise AssertionError("the fault plan never fired")
        rec, t_rec = timed(lambda: run_replica(
            journal, directory=victim, snapshot_every=1, resume=True,
            record_fingerprints=False, **kw))
        s = rec.session
        assert s.restored_from == 0 and s.recovery_batches == N_BATCHES - 1
        assert s.fingerprint() == served["fingerprint"]
        assert s.replay_log() == served["replay_log"]
        for f in ("values", "versions"):
            assert np.array_equal(getattr(s.store, f).cpu().numpy(),
                                  served[f]), f"recovered store {f}"
        digests = [trace_digest(t) for t in s.traces]
        assert digests == served["digests"][-len(digests):]

        # one snapshot of the 1,048,576-object store: write, verify-load
        snaps = os.path.join(tmp, "timed")
        path, t_write = timed(lambda: s.snapshot(snaps, pool=rec.pool))
        _, t_load = timed(lambda: load_snapshot(path))
        nbytes = sum(os.path.getsize(os.path.join(path, f))
                     for f in os.listdir(path))
        log(f"  resumed from snapshot {s.restored_from} and re-drained "
            f"{s.recovery_batches} "
            f"batches in {t_rec:.1f} s; store, replay log and the "
            f"{len(digests)} trace digests bitwise equal to phase 3b's "
            f"depth-0 serve; one snapshot ({nbytes} bytes on disk) written "
            f"in {t_write * 1e3:.1f} ms, verify-loaded in "
            f"{t_load * 1e3:.1f} ms")

        # a snapshot at S shards restores into S' = 1 and S' = 4
        at_s = os.path.join(tmp, "resharded")
        sharded.snapshot(at_s)
        fp = sharded.fingerprint()
        for target in (1, 4):
            r, _ = PotSession.restore(at_s, shards=target, device="cuda")
            assert r.store.layout.shards == target
            assert r.fingerprint() == fp, f"restored at S' = {target}"
            assert torch.equal(unshard_store(r.store).values,
                               unshard_store(sharded.store).values)
        log(f"  a snapshot at S = {SHARDS} restored at S' = 1 and S' = 4: "
            f"fingerprint {fp:#010x} each time")

        # a replica process SIGKILLed at a cut of the journal, restored by
        # another process; both run on the card
        cut = journal_cut(journal, 2 * KILL_CUT)
        ckw = dict(kw, budgets=[KILL_CUT])
        base = run_replica(cut, directory=os.path.join(tmp, "base"),
                           snapshot_every=0, **ckw)
        killed = os.path.join(tmp, "killed")
        cfg = dict(ckw, journal=cut, directory=killed, snapshot_every=1)
        (rc, out), t_kill = timed(lambda: replica_process(
            dict(cfg, fault={"kill_batch": 1, "kill_phase": "execute"}),
            tmp))
        assert rc == -signal.SIGKILL and out is None, rc
        assert snapshot_ids(killed) == [0]
        (rc, out), t_restart = timed(lambda: replica_process(
            dict(cfg, resume=True), tmp))
        assert rc == 0 and out is not None, rc
        assert out["restored_from"] == 0 and out["pool_depth"] == 0
        assert out["fingerprint"] == base.session.fingerprint()
        assert out["replay_log"] == base.session.replay_log()
        bd = [trace_digest(t) for t in base.session.traces]
        assert out["trace_digests"] == bd[-len(out["trace_digests"]):]
        log(f"  SIGKILL: a replica process over the journal's first "
            f"{2 * KILL_CUT} arrivals at budget {KILL_CUT} killed at batch 1 "
            f"(exit {-signal.SIGKILL}, {t_kill:.1f} s), restored by another "
            f"({t_restart:.1f} s): fingerprint, replay log and trace "
            f"digests bitwise equal to the uninterrupted run")
    log(f"recovery: resume and re-drain {t_rec:.1f} s; snapshot write "
        f"{t_write * 1e3:.1f} ms, verify-load {t_load * 1e3:.1f} ms")


def journal_cut(journal, n_arrivals: int) -> list:
    """The arrival journal up to and including its ``n_arrivals``-th
    admission (config and lane events before it kept)."""
    from repro_torch.core.ingress import EV_ADMIT
    seen = 0
    for i, ev in enumerate(journal):
        seen += ev[0] == EV_ADMIT
        if seen == n_arrivals:
            return list(journal[:i + 1])
    raise ValueError(f"the journal holds {seen} arrivals")


def replica_process(cfg, tmp) -> tuple[int, dict | None]:
    """``python -m repro_torch.core.checkpoint`` on ``cfg``: (exit code,
    its summary or None)."""
    from repro_torch.core.checkpoint import _journal_to_json
    cfg_path = os.path.join(tmp, "replica.json")
    out_path = os.path.join(tmp, "replica_out.json")
    if os.path.exists(out_path):
        os.remove(out_path)
    with open(cfg_path, "w") as f:
        json.dump(dict(cfg, journal=_journal_to_json(cfg["journal"])), f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.core.checkpoint",
                        cfg_path, out_path], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    if r.returncode not in (0, -signal.SIGKILL):
        raise RuntimeError(f"replica process exit {r.returncode}: "
                           f"{r.stderr[-2000:]}")
    if not os.path.exists(out_path):
        return r.returncode, None
    with open(out_path) as f:
        return r.returncode, json.load(f)


def bf16_matmul_rate() -> float:
    """FLOP/s of one (MATMUL_N,)^2 x (MATMUL_N,)^2 bf16 ``torch.matmul``,
    measured (the rate the prefill bounds divide by)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    a, b = (torch.randn((MATMUL_N, MATMUL_N), generator=gen, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2))
    ms = cuda_time_ms(lambda: a @ b, 10)
    return 2 * MATMUL_N ** 3 / (ms / 1e3)


def tensor_bytes(tree) -> int:
    from repro_torch.tree import leaves
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def n_params(tree) -> int:
    from repro_torch.tree import leaves
    return sum(t.numel() for t in leaves(tree))


def matmul_params(cfg, params) -> tuple[int, int]:
    """(parameters each token's matmuls multiply, parameters each encoder
    frame's multiply) in the decoder layers: a routed expert's weights
    count top_k of n_experts, a cross-attention layer's K/V projections
    count per frame."""
    per_token = per_frame = 0
    for p in params["layers"]:
        for group, sub in p.items():
            for name, t in (sub.items() if isinstance(sub, dict)
                            else [(group, sub)]):
                n = n_params(t)
                if group == "moe" and name in ("w1", "w2", "w3"):
                    per_token += n * cfg.top_k // cfg.n_experts
                elif group == "xattn" and name in ("wk", "wv"):
                    per_frame += n
                else:
                    per_token += n
    return per_token, per_frame


def family_serve(cfg, params, t_init):
    """Phase 16a: a family served through ``Session`` as phase 6 serves
    stablelm-12b."""
    import torch
    from repro_torch.models import lm

    slot0, fp, times, launches = serve_replicas(cfg, params)
    ms = float(np.median(times)) * 1e3
    nbytes = weight_bytes(params)
    cache = tensor_bytes(lm.init_cache(cfg, SERVE_SLOTS, SERVE_MAX_SEQ,
                                       "cuda"))
    bound = (nbytes + cache) / HBM_BYTES_PER_S * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"  serve: {SERVE_SLOTS} slots x {SERVE_STEPS} steps x 2 replicas "
        f"(init {t_init:.2f} s): median {ms:.3f} ms per step (first "
        f"{times[0] * 1e3:.1f} ms), {SERVE_SLOTS / ms * 1e3:.1f} tokens/s; "
        f"bound {bound:.3f} ms per step (weights {nbytes / 1e9:.3f} GB + "
        f"cache {cache / 1e9:.3f} GB read once); peak allocated "
        f"{peak:.2f} GB; kv_commit launches {launches}; replicas (reversed "
        f"arrivals) bitwise identical, fingerprint {fp:#010x}")
    log(f"    slot 0 tokens: {slot0.tolist()}")
    profile_decode(params, cfg, ms)
    return launches


def family_prefill(cfg, params, prompt: int, rate: float):
    """Phase 16b, in bf16: ``lm.prefill`` of PREFILL_BATCH prompts (after
    the encoder over their frames), then PREFILL_DECODE teacher-forced
    ``decode_step``s from its cache, each timed; and ``lm.forward`` over
    prompt + 1 tokens.  Returns the inputs and row 0's first decode step
    and forward logits at position ``prompt`` (for
    :func:`family_consistency`).

    A MoE model's capacity binds (capacity factor 1.25 and skewed
    routing): ``forward`` drops the latest tokens' assignments to full
    experts, the last token's first, while a decode step of one row
    (capacity 1, a token's top-k experts distinct) drops nothing -- the
    reference's capacity rule (ROADMAP queue 3).  So row 0's check runs
    on a one-row prefill under a capacity factor of (E + 1/2) / k, where
    no expert can fill (capacity >= T), as the reference's own
    consistency test gives deepseek-smoke a factor of 8."""
    import torch
    from repro_torch.models import blocks, lm

    b = PREFILL_BATCH
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (b, prompt + PREFILL_DECODE))).to("cuda")
    frames = enc = None
    t_enc, enc_flops = 0.0, 0
    if cfg.encoder_layers:
        frames = torch.from_numpy(rng.normal(size=(
            b, cfg.n_frames, cfg.d_model)).astype(np.float32)).to("cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = lm.encode(params, frames, cfg)
        torch.cuda.synchronize()
        t_enc = time.perf_counter() - t0
        enc_flops = 2 * b * cfg.n_frames * n_params(params["enc_layers"])
    if "local" in cfg.pattern:
        assert blocks.uses_banded("local", True, prompt, cfg), \
            f"{cfg.name}: a {prompt}-token prompt is not the banded form"
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = lm.prefill(params, tokens[:, :prompt], cfg,
                               max_seq=prompt + PREFILL_DECODE, enc=enc)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    assert logits.shape == (b, 1, cfg.padded_vocab)
    assert torch.isfinite(logits).all()
    cache_bytes = tensor_bytes(cache)
    pos = torch.full((b,), prompt, dtype=torch.int32, device="cuda")
    times = []
    for i in range(PREFILL_DECODE):
        t0 = time.perf_counter()
        out, cache = lm.decode_step(params, cache,
                                    tokens[:, prompt + i:prompt + i + 1],
                                    pos + i, cfg)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        assert torch.isfinite(out).all()
        if i == 0:
            first = out[:1, 0].float()
    del cache
    check = cfg
    if cfg.n_experts:
        check = dataclasses.replace(cfg, capacity_factor=(
            cfg.n_experts + 0.5) / cfg.top_k)
        _, c1 = lm.prefill(params, tokens[:1, :prompt], check,
                           max_seq=prompt + 1)
        first, _ = lm.decode_step(params, c1, tokens[:1, prompt:prompt + 1],
                                  pos[:1], check)
        first = first[:, 0].float()
        del c1
    fwd = lm.forward(params, tokens[:1, :prompt + 1], check,
                     enc=None if enc is None else enc[:1])[:, prompt].float()
    per_token, per_frame = matmul_params(cfg, params)
    flops = (2 * b * prompt * per_token + 2 * b * cfg.n_frames * per_frame
             + 2 * b * n_params(params.get("head", params["embed"])))
    dec_ms = float(np.median(times[1:])) * 1e3
    dec_bound = (weight_bytes(params) + cache_bytes) / HBM_BYTES_PER_S * 1e3
    enc_line = (f"; the encoder over {b} x {cfg.n_frames} frames "
                f"{t_enc * 1e3:.1f} ms against a FLOP bound of "
                f"{enc_flops / rate * 1e3:.4f} ms" if enc is not None else "")
    log(f"  prefill {b} x {prompt} tokens: {t_pre * 1e3:.1f} ms, "
        f"{b * prompt / t_pre:.0f} tokens/s, FLOP bound "
        f"{flops / rate * 1e3:.4f} ms (2 x {per_token:,} active parameters "
        f"a token{f' + {per_frame:,} a frame' if per_frame else ''} + the "
        f"head on the last row); peak allocated {peak:.2f} GB{enc_line}")
    log(f"  decode from the prefill cache: {PREFILL_DECODE} steps, median "
        f"{dec_ms:.3f} ms per step (first {times[0] * 1e3:.1f} ms), bound "
        f"{dec_bound:.4f} ms (weights + cache read once)")
    return dict(tokens=tokens[:1, :prompt + 1],
                frames=None if frames is None else frames[:1],
                first=first, fwd=fwd, cfg=check)


def to_float32(tree) -> None:
    """Every tensor of a parameter tree (dicts and lists) upcast to
    float32 in place, one leaf at a time, so the bf16 and float32 copies
    of the whole tree never coexist."""
    import torch
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in list(items):
        if torch.is_tensor(v):
            tree[k] = v.float()
        else:
            to_float32(v)


def family_consistency(params, prompt: int, run: dict):
    """Phase 16b, held: the cache path against the parallel path, row 0,
    under ``run["cfg"]`` (a MoE model's no-drop capacity).

    In float32 (the family's weights upcast in place, ``params`` then
    float32): prefill of ``prompt`` tokens and one decode step against
    the parallel pass over prompt + 1 (``lm.prefill``'s trunk, the one
    ``lm.forward`` runs, which computes in bf16 whatever it is given)
    within the reference tests' rtol = atol = TOL.  In bf16 at full
    width and depth both paths round far more than TOL (recurrentgemma-
    9b's bf16 forward is 0.31 from float32 on the card); there the bf16
    decode step (``run["first"]``) may be no further from the float32
    logits than twice ``lm.forward``'s own bf16 logits are, as phase 7
    holds the card's bf16 decode -- but for a MoE model, where a router
    near-tie in either bf16 path moves a whole expert's output, so its
    two distances are only printed."""
    import torch
    from repro_torch.models import lm

    cfg = run["cfg"]
    to_float32(params)
    torch.cuda.empty_cache()
    tokens, frames = run["tokens"], run["frames"]
    enc = None if frames is None else lm.encode(params, frames, cfg)
    _, cache = lm.prefill(params, tokens[:, :prompt], cfg,
                          max_seq=prompt + 1, enc=enc)
    dec, _ = lm.decode_step(params, cache, tokens[:, prompt:], torch.full(
        (1,), prompt, dtype=torch.int32, device="cuda"), cfg)
    del cache
    par, _ = lm.prefill(params, tokens, cfg, enc=enc)
    dec, par = dec[:, 0], par[:, 0]
    err32 = float((dec - par).abs().max())
    torch.testing.assert_close(dec, par, rtol=TOL, atol=TOL)
    dec16 = float((run["first"] - par).abs().max())
    fwd16 = float((run["fwd"] - par).abs().max())
    if not cfg.n_experts:
        assert dec16 <= 2 * fwd16, (dec16, fwd16)
    log(f"  decode after prefill against the parallel pass over "
        f"{prompt + 1} tokens, row 0"
        f"{f', capacity factor {cfg.capacity_factor:.4f}' if cfg.n_experts else ''}"
        f": float32 max |diff| {err32:.3e} within rtol = atol = {TOL}; "
        f"bf16 decode {dec16:.5f} from the float32 logits"
        f"{'' if cfg.n_experts else ' <= 2 x'} {fwd16:.5f} (bf16 forward's"
        f" own); logits std {float(par.std()):.3f}")


def family_held(cfg, params, prompt: int, n_layers: int):
    """Phase 16c: the family at full width cut to one pattern group,
    float32 (the same bf16 weights, upcast) on the card and on the CPU:
    prefill logits, the prefill cache and FAMILY_HELD_DECODE decode
    steps' logits within rtol = atol = TOL."""
    import torch
    from repro_torch.models import lm
    from repro_torch.tree import leaves

    cut = dataclasses.replace(cfg, n_layers=n_layers,
                              encoder_layers=min(cfg.encoder_layers,
                                                 n_layers))
    assert lm.layer_kinds(cut) == lm.layer_kinds(cfg)[:n_layers]
    card = dict(params, layers=params["layers"][:n_layers])
    if cfg.encoder_layers:
        card["enc_layers"] = params["enc_layers"][:n_layers]
    rng = np.random.default_rng(SEED + 1)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (1, prompt + FAMILY_HELD_DECODE)))
    frames = (torch.from_numpy(rng.normal(size=(
        1, cfg.n_frames, cfg.d_model)).astype(np.float32))
        if cfg.encoder_layers else None)

    def run(p, device, enc):
        enc = None if enc is None else enc.to(device)
        logits, cache = lm.prefill(p, tokens[:, :prompt].to(device), cut,
                                   max_seq=prompt + FAMILY_HELD_DECODE,
                                   enc=enc)
        outs = [logits.cpu()]
        held = [t.to("cpu", copy=True) for t in leaves(cache)]
        for i in range(FAMILY_HELD_DECODE):
            out, cache = lm.decode_step(
                p, cache, tokens[:, prompt + i:prompt + i + 1].to(device),
                torch.full((1,), prompt + i, dtype=torch.int32,
                           device=device), cut)
            outs.append(out.cpu())
        return torch.cat(outs, 1), held

    # the encoder computes in bf16 whatever its weights' dtype (as the
    # reference's does): its two outputs are held within TOL, and both
    # decoders read the card's
    enc_line, enc = "", None
    if frames is not None:
        enc = lm.encode(card, frames.to("cuda"), cut).cpu()
        enc_cpu = lm.encode(lm.params_to(card, "cpu"), frames, cut)
        torch.testing.assert_close(enc.float(), enc_cpu.float(), rtol=TOL,
                                   atol=TOL)
        diff = float((enc.float() - enc_cpu.float()).abs().max())
        enc_line = f"; the bf16 encoder's output max |card - CPU| {diff:.3e}"
        del enc_cpu
    t0 = time.perf_counter()
    got = run(lm.params_to(card, "cuda", torch.float32), "cuda", enc)
    t_card = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    exp = run(lm.params_to(card, "cpu", torch.float32), "cpu", enc)
    t_cpu = time.perf_counter() - t0
    assert torch.isfinite(exp[0]).all()
    torch.testing.assert_close(got[0], exp[0], rtol=TOL, atol=TOL)
    worst = 0.0
    for a, b in zip(got[1], exp[1], strict=True):
        torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)
        worst = max(worst, float((a - b).abs().max()))
    log(f"  held to account ({n_layers} layers, full width, float32, "
        f"1 x {prompt} tokens + {FAMILY_HELD_DECODE} decode steps; card "
        f"{t_card:.1f} s, CPU {t_cpu:.1f} s): logits max |card - CPU| "
        f"{float((got[0] - exp[0]).abs().max()):.3e}, prefill cache "
        f"({len(exp[1])} tensors) {worst:.3e}, within rtol = atol = {TOL}"
        f"{enc_line}")


def phase_families() -> int:
    """Phase 16: the other layer kinds at full width, one family at a
    time.  Returns the commit kernel's launches of the families'
    serving runs."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    rate = bf16_matmul_rate()
    log(f"families: bf16 matmul rate {rate:.4e} FLOP/s measured "
        f"({MATMUL_N}^3, the prefill bounds' rate)")
    launches = 0
    for arch, prompt, held in FAMILIES:
        cfg = get_config(arch)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = lm.init_params(
            torch.Generator(device="cuda").manual_seed(SEED), cfg)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        kinds = sorted(set(lm.layer_kinds(cfg)))
        log(f"family {cfg.name}: {cfg.n_layers} layers ({', '.join(kinds)}"
            f"{f', {cfg.n_experts} experts top-{cfg.top_k}' if cfg.n_experts else ''}"
            f"{f', encoder {cfg.encoder_layers} layers' if cfg.encoder_layers else ''}"
            f"), d_model {cfg.d_model}, "
            f"{n_params(params):,} bf16 parameters")
        launches += family_serve(cfg, params, t_init)
        family_held(cfg, params, FAMILY_HELD_PROMPT, held)
        run = family_prefill(cfg, params, prompt, rate)
        family_consistency(params, prompt, run)   # params now float32
        del params, run
        torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def port_compute_dtype(dtype):
    """``C`` of the port's model modules set to ``dtype`` within the
    block (they read it at each call): a float32 check of the training
    path free of bf16 rounding."""
    from repro_torch.models import blocks, lm, moe, rglru, ssm
    mods = (blocks, lm, ssm, rglru, moe)
    saved = [m.C for m in mods]
    for m in mods:
        m.C = dtype
    try:
        yield
    finally:
        for m, c in zip(mods, saved):
            m.C = c


def family_batch(cfg, seq, rows, step, device="cuda"):
    """Data step ``step`` of ``rows`` x ``seq`` tokens, and whisper's
    stub frames drawn with numpy from the step (as ``launch/train.py``
    draws them)."""
    import torch
    from repro_torch.data.pipeline import DataConfig, batch_at
    batch = batch_at(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                global_batch=rows), step, device=device)
    if cfg.encoder_layers:
        frames = np.random.default_rng([7, step]).standard_normal(
            (rows, cfg.n_frames, cfg.d_model), np.float32)
        batch["frames"] = torch.from_numpy(frames).to(device)
    return batch


def leaf_distance(got, exp) -> tuple[float, bool]:
    """(||got - exp|| / ||exp||, whether a column (last axis) of the two
    lies more than 1e-3 apart in relative L2: a cancellation), in
    float64 on the card, ``exp`` (a CPU tensor) copied there once."""
    import torch
    b = exp.to("cuda")
    a = got.reshape(-1, got.shape[-1])
    b = b.reshape(-1, b.shape[-1])
    num = den = torch.zeros(a.shape[1], dtype=torch.float64, device="cuda")
    rows = max(1, (1 << 26) // a.shape[1])
    for s in range(0, a.shape[0], rows):
        x, y = a[s:s + rows].double(), b[s:s + rows].double()
        num = num + ((x - y) ** 2).sum(0)
        den = den + (y * y).sum(0)
    total = float(den.sum()) ** 0.5
    col = bool((num.sqrt() > 1e-3 * den.sqrt().clamp(min=1e-30)).any())
    return float(num.sum()) ** 0.5 / (total if total else 1.0), col


def family_train_runs(cfg, optimizer, seq, rows):
    """Phase 17: FAMILY_TRAIN_STEPS pot steps twice from SEED on the
    card.  Returns the fused AdamW kernel's launches."""
    import torch
    from repro_torch.kernels import fused_adamw
    from repro_torch.models import lm
    from repro_torch.train import init_state, make_train_step
    from repro_torch.tree import leaves

    step_fn = make_train_step(cfg, optimizer=optimizer, mode="pot",
                              n_microbatches=2, lr=TRAIN_LR, wd=TRAIN_WD)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fused_adamw.reset_launches()
    runs = []
    for _ in range(2):
        params = lm.init_params(
            torch.Generator(device="cuda").manual_seed(SEED), cfg,
            dtype=torch.float32)
        before = tree_digest(params)
        state = init_state(params, optimizer, cfg=cfg)
        del params
        losses, times = [], []
        for i in range(FAMILY_TRAIN_STEPS):
            batch = family_batch(cfg, seq, rows, i)
            (state, loss), t = timed(lambda: step_fn(state, batch))
            losses.append(loss)
            times.append(t)
        opt = ([state.opt["m"], state.opt["v"]] if optimizer == "adamw"
               else [state.opt["stats"]])
        runs.append(dict(losses=torch.stack(losses).cpu(), times=times,
                         before=before,
                         after=tree_digest([state.params, *opt]),
                         counters=(int(state.gv), int(state.step))))
        n_leaves = len(leaves(state.params))
        n = sum(t.numel() for t in leaves(state.params))
        del state, opt
        torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = fused_adamw.LAUNCHES["fused_adamw"]
    a, b = runs
    assert torch.equal(a["losses"], b["losses"]), "losses differ"
    assert a["after"] == b["after"], "the runs' states differ"
    assert torch.isfinite(a["losses"]).all(), a["losses"]
    assert all(x != y for x, y in zip(a["before"], a["after"])), \
        "a parameter did not move"
    assert a["counters"] == (FAMILY_TRAIN_STEPS,) * 2, a["counters"]
    want = 2 * FAMILY_TRAIN_STEPS * n_leaves if optimizer == "adamw" else 0
    assert launches == want, (launches, want)
    ms = float(np.median(a["times"] + b["times"])) * 1e3
    tokens = rows * seq
    digest = hashlib.sha256(str(a["after"]).encode()).hexdigest()[:16]
    log(f"  train ({optimizer}, {n:,} float32 parameters in {n_leaves} "
        f"leaves; pot, 2 microbatches of {rows // 2} x {seq} tokens"
        f"{f' over {cfg.n_frames} frames' if cfg.encoder_layers else ''},"
        f" {FAMILY_TRAIN_STEPS} steps x 2 runs): median {ms:.3f} ms per "
        f"step (first {a['times'][0] * 1e3:.1f} ms), "
        f"{tokens / ms * 1e3:.1f} tokens/s; peak allocated {peak:.2f} GB; "
        f"fused_adamw launches {launches}; runs bitwise identical "
        f"(digest {digest})")
    log(f"    losses: {a['losses'].tolist()}")
    return launches


def adafactor_step(cfg, params, arrays, device):
    """One Adafactor pot step (its gradients, then the update) of
    ``params`` on ``device`` over FAMILY_HELD_SEQ-token ``arrays``, with
    ``C`` float32 (the caller sets it): (loss, gradient, new parameter
    and statistics leaves, seconds)."""
    import torch
    from functools import partial
    from repro_torch.optim import adafactor_update
    from repro_torch.train import init_state, loss_fn, train_step
    from repro_torch.tree import leaves

    batch = {k: torch.from_numpy(v.astype(np.int32)).to(device)
             for k, v in arrays.items()}
    t0 = time.perf_counter()
    value, grads = train_step._accumulate(
        partial(loss_fn, cfg=cfg, remat=False), params, batch, 2)
    state = init_state(params, "adafactor", cfg=cfg)
    new, opt = adafactor_update(params, grads, state.opt, lr=TRAIN_LR)
    if device == "cuda":
        torch.cuda.synchronize()
    return (float(value), leaves(grads), leaves(new), leaves(opt["stats"]),
            time.perf_counter() - t0)


def adafactor_held_card(cfg) -> dict:
    """Phase 17b's card half for ``cfg``: one Adafactor step in float32
    from SEED + 4's weights, its results kept on the card; the weights'
    host copy and the batch for the CPU half."""
    import torch
    from repro_torch.models import lm
    from repro_torch.optim import adafactor
    from repro_torch.tree import leaves, tree_map

    params = lm.init_params(
        torch.Generator(device="cuda").manual_seed(SEED + 4), cfg,
        dtype=torch.float32)
    # the stacked leaves of the groups' slots the rule clips group by group
    by_group = sum(adafactor._grouped((cfg.n_groups,) + tuple(t.shape))
                   for layer in params["layers"][:len(cfg.pattern)]
                   for t in leaves(layer))
    assert by_group == (3 if cfg.n_experts else 0), by_group
    host = tree_map(lambda t: t.cpu(), params)
    rng = np.random.default_rng(SEED + 4)
    tokens = rng.integers(0, cfg.vocab, (2, FAMILY_HELD_SEQ + 1))
    arrays = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    with port_compute_dtype(torch.float32):
        card = adafactor_step(cfg, params, arrays, "cuda")
    return dict(cfg=cfg, by_group=by_group, host=host, arrays=arrays,
                cuda=card)


def adafactor_held_cpu(runs):
    """Phase 17b's CPU half: each run's step on the CPU from the same
    weights (``C`` float32 meanwhile: the phases it runs beside do not
    read it)."""
    import torch
    with port_compute_dtype(torch.float32):
        for run in runs:
            run["cpu"] = adafactor_step(run["cfg"], run.pop("host"),
                                        run["arrays"], "cpu")


def adafactor_held_compare(run):
    """Phase 17b's check of one run: the loss within rtol 1e-5, the
    gradients, statistics and new parameters within 1e-4 in relative L2
    per leaf."""
    import torch
    (lc, gc, pc, sc, tc), (lh, gh, ph, sh, th) = run["cuda"], run["cpu"]
    np.testing.assert_allclose(lc, lh, rtol=1e-5)
    t0 = time.perf_counter()
    dist_g = [leaf_distance(a, b) for a, b in zip(gc, gh)]
    skip = {i for i, (_, col) in enumerate(dist_g) if col}
    worst_g = max(d for d, _ in dist_g)
    rel_p = [leaf_distance(a, b)[0] for a, b in zip(pc, ph)]
    worst_p = max(r for i, r in enumerate(rel_p) if i not in skip)
    worst_skip = max([rel_p[i] for i in skip], default=0.0)
    worst_s = max(leaf_distance(a, b)[0] for a, b in zip(sc, sh))
    t_cmp = time.perf_counter() - t0
    assert max(worst_g, worst_p, worst_s) <= 1e-4, (worst_g, worst_p,
                                                    worst_s)
    log(f"  {run['cfg'].name} ({run['cfg'].n_layers} layers): one "
        f"Adafactor step in float32, card against CPU (2 x "
        f"{FAMILY_HELD_SEQ} tokens; card {tc:.1f} s, CPU {th:.1f} s beside "
        f"phases 10 and 10b, the comparison {t_cmp:.1f} s): loss "
        f"{lc:.7f} vs {lh:.7f} (|diff| "
        f"{abs(lc - lh):.3e}); relative L2 at most: gradients "
        f"{worst_g:.3e}, statistics {worst_s:.3e}, parameters "
        f"{worst_p:.3e} (<= 1e-4) outside the {len(skip)} of {len(pc)} "
        f"leaves with a gradient column the two give more than 1e-3 "
        f"apart ({worst_skip:.3e} there, held through their gradients); "
        f"{run['by_group']} stacked leaves clipped group by group")
    del run["cuda"], run["cpu"], gc, pc, sc, gh, ph, sh
    torch.cuda.empty_cache()


def phase_adafactor_card():
    """Phase 17b's card half for ADAFACTOR_HELD's configurations; then
    their CPU half started in a thread, which runs beside phases 10 and
    10b (host-bound on one core, and off the model modules).  Returns
    (the runs, the thread's future)."""
    import concurrent.futures
    import torch
    from repro_torch.configs import get_config

    runs = [adafactor_held_card(dataclasses.replace(
        get_config(arch), n_layers=n_layers))
        for arch, n_layers in ADAFACTOR_HELD]
    torch.cuda.empty_cache()
    # two cores left to the card phases' host thread
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, threads - 2))
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(adafactor_held_cpu, runs)
    pool.shutdown(wait=False)
    return runs, future, threads


def phase_adafactor_held(pending):
    """Phase 17b's end: the CPU half awaited, each run compared."""
    import torch
    runs, future, threads = pending
    future.result()
    torch.set_num_threads(threads)
    log("adafactor held to account (phase 17's recurrentgemma and "
        "deepseek cells; the CPU steps ran beside phases 10 and 10b):")
    for run in runs:
        adafactor_held_compare(run)


def phase_train_families() -> int:
    """Phase 17: training through the other layer kinds at full width.
    Returns the fused AdamW kernel's launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    launches = 0
    for arch, n_layers, optimizer, seq, rows in TRAIN_FAMILIES:
        full = get_config(arch)
        cfg = (dataclasses.replace(full, n_layers=n_layers) if n_layers
               else full)
        assert lm.layer_kinds(cfg) == lm.layer_kinds(full)[:cfg.n_layers]
        kinds = sorted(set(lm.layer_kinds(cfg)))
        log(f"train family {cfg.name}: {cfg.n_layers} of {full.n_layers} "
            f"layers ({', '.join(kinds)}"
            f"{f'; tail {len(cfg.tail_pattern)}' if cfg.tail_pattern else ''}"
            f"{f', {cfg.n_experts} experts top-{cfg.top_k}' if cfg.n_experts else ''}"
            f"{f', encoder {cfg.encoder_layers} layers' if cfg.encoder_layers else ''}"
            f"), d_model {cfg.d_model}")
        if "local" in cfg.pattern:
            from repro_torch.models import blocks
            assert blocks.uses_banded("local", True, seq, cfg), seq
        launches += family_train_runs(cfg, optimizer, seq, rows)
        torch.cuda.empty_cache()
    return launches


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase_layout():
    """Phase 18a: a world-1 NCCL group, the host mesh over the card, and
    phase 17's deepseek cell's leaves laid out by their specs.  Returns
    the (1, 1) ("data", "model") mesh; the caller destroys the group."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.runtime.shardings import Profile, cons, to_placements
    from repro_torch.tree import flatten_up_to, leaves

    t0 = time.perf_counter()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    host = make_host_mesh()
    assert host.mesh_dim_names == ("data",) and host.size() == 1
    mesh = init_device_mesh("cuda", (1, 1),
                            mesh_dim_names=("data", "model"))
    arch, n_layers, _, _ = DRYRUN_CELLS[0]
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    params = lm.init_params(
        torch.Generator(device="cuda").manual_seed(SEED), cfg)
    prof = Profile(mesh=mesh)
    specs = flatten_up_to(params, lm.param_specs(cfg, prof))
    n = 0
    for t, spec in zip(leaves(params), specs, strict=True):
        d = distribute_tensor(t, mesh, to_placements(spec, mesh, t.ndim))
        local = d.to_local()
        assert local.shape == t.shape and torch.equal(
            local.view(torch.int16), t.view(torch.int16)), spec
        assert cons(t, spec, prof) is t
        n += t.numel()
    log(f"layout: world-1 NCCL group, host mesh {host.mesh_dim_names} "
        f"of {host.size()} card; {cfg.name} cut to {cfg.n_layers} "
        f"layers, {len(specs)} leaves ({n:,} bf16 parameters) "
        f"distributed by their specs on the (1, 1) (data, model) mesh: "
        f"every local shard bitwise the tensor, cons the identity "
        f"({time.perf_counter() - t0:.1f} s)")
    del params, d, local
    torch.cuda.empty_cache()
    return mesh


def median_ms(fn, n: int = EP_TIMED) -> float:
    """The median of ``n`` timings of one call of ``fn`` (CUDA events)
    after one warm-up call."""
    fn()
    return float(np.median([cuda_time_ms(fn, 1, warmup=0)
                            for _ in range(n)]))


def phase_moe_ep(mesh) -> tuple[int, int]:
    """Phase 18c: the MoE layers' expert-parallel schedule at world 1 on
    phase 18a's mesh, each check bitwise against the dense path.
    Returns the fused AdamW and kv_commit kernels' launches of the
    compared train steps and sessions."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import fused_adamw, kv_commit
    from repro_torch.models import lm, moe
    from repro_torch.runtime.shardings import SMOKE, Profile
    from repro_torch.serve.session import Session
    from repro_torch.train import init_state, make_train_step
    from repro_torch.tree import leaves

    t0 = time.perf_counter()
    prof = Profile(mesh=mesh)
    arch, n_layers, rows, seq = DRYRUN_CELLS[0]
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    gen = lambda seed: torch.Generator(device="cuda").manual_seed(seed)
    bits = lambda t: t.view(torch.int16 if t.element_size() == 2 else
                            torch.int32) if t.is_floating_point() else t
    same = lambda a, b: len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(bits(x), bits(y))
        for x, y in zip(a, b))
    profiles = {"schedule": prof, "dense": SMOKE}
    times = {}

    # a. layer 0's MoE, bf16 weights and tokens
    params = lm.init_params(gen(SEED), cfg)
    local = lm.local_params(params, cfg, prof)
    assert all(a is b for a, b in zip(leaves(local), leaves(params),
                                      strict=True)), "a world-1 shard is cut"
    p = params["layers"][0]["moe"]
    x = torch.randn((rows, seq, cfg.d_model), generator=gen(SEED + 1),
                    device="cuda").to(torch.bfloat16)
    ct = torch.randn((rows, seq, cfg.d_model), generator=gen(SEED + 2),
                     device="cuda").to(torch.bfloat16)
    names = ("router",) + moe.EXPERT_LEAVES

    def forward(pr):
        with torch.no_grad():
            return moe.moe_apply(p, x, cfg, pr)

    def backward(pr):
        leaf = {n: p[n].detach().requires_grad_(True) for n in names}
        xg = x.detach().requires_grad_(True)
        y = moe.moe_apply(dict(p, **leaf), xg, cfg, pr)
        return [y.detach(), *torch.autograd.grad(
            y, [xg, *leaf.values()], ct)]

    got = {k: backward(pr) for k, pr in profiles.items()}
    assert same(*got.values()), "the schedule's layer differs from dense"
    assert same([forward(prof)], [forward(SMOKE)])
    del got
    for k, pr in profiles.items():
        times[f"layer forward {k}"] = median_ms(lambda: forward(pr))
        times[f"layer forward+backward {k}"] = median_ms(
            lambda: backward(pr))

    # b. serving: prefill of a prompt a slot, then greedy steps
    prompts = torch.randint(0, cfg.vocab, (EP_SLOTS, EP_PROMPT),
                            generator=gen(SEED + 3), device="cuda")
    kv_commit.reset_launches()
    served = {}
    for k, pr in profiles.items():
        sess = Session(cfg, params, n_slots=EP_SLOTS, max_seq=EP_MAX_SEQ,
                       device="cuda", prof=pr)
        first = sess.prefill(prompts)
        served[k] = (sess, np.concatenate(
            [first[:, None], sess.generate(EP_STEPS)], axis=1),
            sess.fingerprint())
    kv_launches = kv_commit.LAUNCHES["kv_commit"]
    (_, t1, f1), (_, t2, f2) = served.values()
    assert np.array_equal(t1, t2) and f1 == f2, "sessions differ"
    assert ((t1 >= 0) & (t1 < cfg.padded_vocab)).all()
    assert kv_launches == 2 * EP_STEPS, kv_launches
    for k, (sess, _, _) in served.items():
        times[f"decode step {k}"] = median_ms(sess.step)
    del served, sess, params, local, p, x, ct
    torch.cuda.empty_cache()

    # c. one pot step with float32 masters, phase 17's batch
    state = init_state(lm.init_params(gen(SEED), cfg, dtype=torch.float32))
    batch = family_batch(cfg, seq, rows, 0)
    steps = {k: make_train_step(cfg, prof=pr, mode="pot",
                                n_microbatches=TRAIN_MICRO, lr=TRAIN_LR,
                                wd=TRAIN_WD) for k, pr in profiles.items()}
    fused_adamw.reset_launches()
    trained = {}
    for k, step in steps.items():
        new, loss = step(state, batch)
        trained[k] = (loss.view(torch.int32).item(),
                      tree_digest([new.params, new.opt["m"], new.opt["v"]]))
        del new
    adamw_launches = fused_adamw.LAUNCHES["fused_adamw"]
    n_leaves = len(leaves(state.params))
    assert trained["schedule"] == trained["dense"], "the train steps differ"
    assert adamw_launches == 2 * n_leaves, (adamw_launches, n_leaves)
    assert np.isfinite(np.int32(trained["dense"][0]).view(np.float32))
    for k, step in steps.items():
        times[f"train step {k}"] = median_ms(lambda: step(state, batch))
    del state, steps
    torch.cuda.empty_cache()

    log(f"moe expert parallelism: world-1 NCCL group, (1, 1) (data, "
        f"model) mesh; {cfg.name} cut to {cfg.n_layers} layers "
        f"({cfg.n_experts} experts top-{cfg.top_k}, capacity factor "
        f"{cfg.capacity_factor}): layer 0 on {rows} x {seq} bf16 tokens, "
        f"output and dx, router, w1, w3, w2 gradients bitwise equal to "
        f"the dense path; Session ({EP_SLOTS} slots, {EP_PROMPT}-token "
        f"prompts, {EP_STEPS} steps) tokens and fingerprint {f1:#010x} "
        f"bitwise equal, kv_commit launches {kv_launches}; pot step "
        f"({TRAIN_MICRO} microbatches, {n_leaves} float32 leaves) loss "
        f"and every parameter and moment leaf bitwise equal, fused_adamw "
        f"launches {adamw_launches} ({time.perf_counter() - t0:.1f} s)")
    log(f"  moe expert parallelism ms (median of {EP_TIMED} after one, "
        f"{smi_line()}): " + "; ".join(
            f"{k} {v:.3f}" for k, v in times.items()))
    return adamw_launches, kv_launches


def phase_store_mesh(wls, dense) -> dict[str, int]:
    """Phase 19a: the main path's first batch through a store cut one
    shard per rank over a 1-D mesh of this world-1 group, held to phase
    3's dense session and the numpy serial oracle.  Returns the conflict
    kernels' launches of that run."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import convert
    from repro_torch.core import oracle
    from repro_torch.core.engine import TRACE_FIELDS
    from repro_torch.core.sequencer import RoundRobinSequencer
    from repro_torch.core.session import PotSession
    from repro_torch.core.tstore import (TStore, fingerprint,
                                         unshard_store)
    from repro_torch.kernels import conflict

    wl = wls[0]
    mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("shard",))
    s = PotSession(N_OBJECTS, engine="pcc", n_lanes=N_LANES, shards=1,
                   mesh=mesh, device="cuda")
    assert s.store.layout.sharded and tuple(s.store.values.shape) == (
        1, N_OBJECTS, 1)
    torch.cuda.synchronize()
    conflict.reset_launches()
    traces, seconds = timed(lambda: s.run_stream([wl.batch], [wl.lanes]))
    launches = dict(conflict.LAUNCHES)
    for name, n in launches.items():
        assert n > 0, f"{name} was never launched on the mesh store's path"
    got = convert.trace_to_numpy(traces[0])
    for f in TRACE_FIELDS:
        assert np.array_equal(got[f], dense["traces"][0][f]), f"mesh {f}"
    replay = s.replay_log()
    assert replay == dense["replay_log"][:len(replay)] and len(replay) == K
    values, versions, gv = oracle.serial_execute(
        np.zeros((N_OBJECTS, 1), np.int32), np.zeros(N_OBJECTS, np.int32),
        0, [convert.batch_to_numpy(wl.batch)],
        [RoundRobinSequencer(n_root_lanes=N_LANES).order_for(
            wl.lanes.tolist())])
    flat = unshard_store(s.store)
    assert np.array_equal(flat.values.cpu().numpy(), values)
    assert np.array_equal(flat.versions.cpu().numpy(), versions)
    assert int(flat.gv) == gv == K
    fp = s.fingerprint()
    assert fp == fingerprint(TStore(*(torch.from_numpy(a) for a in (
        values, versions, np.asarray(gv, np.int32))))), "mesh fingerprint"
    per_dense = dense["seconds"] / MAIN_PATH_BATCHES
    log(f"mesh store: {K} txns, O={N_OBJECTS} as 1 shard on a 1-D (shard,) "
        f"mesh of the world-1 NCCL group: {seconds:.3f} s a batch against "
        f"the dense run's {per_dense:.3f} s ({seconds / per_dense:.3f} x); "
        f"rounds {int(traces[0].rounds)}; every trace field and the replay "
        f"log equal to phase 3's first batch, store and fingerprint "
        f"{fp:#010x} equal to the serial oracle's; launches {launches}")
    log(f"  by shape: {shape_counts()}")
    return launches


def tp_against_dense(cfg, prof, label="tensor parallel") -> dict:
    """Phases 19b, 19c and 19d's ``pure_dp`` for ``cfg`` (full width,
    depth cut): on ``prof``'s mesh (``label`` in the times) against
    ``SMOKE``, ``lm.forward``'s logits and
    ``lm.prefill``'s logits and cache on TP_ROWS x TP_SEQ bf16 tokens
    (after ``lm.encode`` of seeded stub frames on the same profile for an
    encoder-decoder), one ``lm.decode_step`` from that cache (its logits
    and cache; cross-attention over the prefill's cross rows), a
    ``Session`` (EP_SLOTS slots, EP_PROMPT-token
    prompts, EP_STEPS steps: tokens and fingerprint) and one pot step
    (AdamW, TRAIN_MICRO microbatches, float32 masters: the loss and every
    parameter and moment leaf), each bitwise equal, the kernels launched
    once a step and once a leaf; then the medians of EP_TIMED after a
    warm-up of each on both.  Returns the times, the fingerprint, the
    leaves and the kv_commit and fused_adamw launches of the compared
    sessions and steps."""
    import torch
    from repro_torch.kernels import fused_adamw, kv_commit
    from repro_torch.models import lm
    from repro_torch.runtime.shardings import SMOKE
    from repro_torch.serve.session import Session
    from repro_torch.train import init_state, make_train_step
    from repro_torch.tree import leaves

    gen = lambda seed: torch.Generator(device="cuda").manual_seed(seed)
    bits = lambda t: t.view(torch.int16 if t.element_size() == 2 else
                            torch.int32) if t.is_floating_point() else t
    same = lambda a, b: len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(bits(x), bits(y)) for x, y in zip(a, b))
    profiles = {label: prof, "dense": SMOKE}
    times = {}

    # a. forward and prefill, bf16 weights
    params = lm.init_params(gen(SEED), cfg)
    local = lm.local_params(params, cfg, prof)
    assert all(a is b for a, b in zip(leaves(local), leaves(params),
                                      strict=True)), "a world-1 shard is cut"
    tokens = torch.randint(0, cfg.vocab, (TP_ROWS, TP_SEQ),
                           generator=gen(SEED + 4), device="cuda")
    frames = (torch.randn((TP_ROWS, cfg.n_frames, cfg.d_model),
                          generator=gen(SEED + 5), device="cuda")
              if cfg.encoder_layers else None)

    def kw(pr):
        return {} if frames is None else {
            "enc": lm.encode(params, frames, cfg, pr)}

    def forward(pr):
        with torch.no_grad():
            return lm.forward(params, tokens, cfg, pr, **kw(pr))

    def prefill(pr):
        with torch.no_grad():
            logits, cache = lm.prefill(params, tokens, cfg, pr,
                                       max_seq=EP_MAX_SEQ + TP_SEQ,
                                       **kw(pr))
        return [logits] + [t for c in cache for t in c.values()]

    def decode(pr):
        """One decode step from the prefill's cache: its logits and
        every cache entry (an encoder-decoder's cross rows filled by
        the prefill from ``lm.encode``)."""
        with torch.no_grad():
            _, cache = lm.prefill(params, tokens, cfg, pr,
                                  max_seq=EP_MAX_SEQ + TP_SEQ, **kw(pr))
            pos = torch.full((TP_ROWS,), TP_SEQ, dtype=torch.int32,
                             device="cuda")
            logits, cache = lm.decode_step(params, cache, tokens[:, :1],
                                           pos, cfg, pr)
        if frames is not None:
            assert all(c["xk"].any() and c["xv"].any() for c in cache
                       if "xk" in c), "the cross rows are empty"
        return [logits] + [t for c in cache for t in c.values()]

    assert same([forward(prof)], [forward(SMOKE)]), "forward differs"
    assert same(prefill(prof), prefill(SMOKE)), "prefill differs"
    assert same(decode(prof), decode(SMOKE)), "decode step differs"
    for k, pr in profiles.items():
        times[f"forward {k}"] = median_ms(lambda: forward(pr))
        times[f"prefill {k}"] = median_ms(lambda: prefill(pr))

    # b. serving: prefill of a prompt a slot, then greedy steps
    prompts = torch.randint(0, cfg.vocab, (EP_SLOTS, EP_PROMPT),
                            generator=gen(SEED + 3), device="cuda")
    kv_commit.reset_launches()
    served = {}
    for k, pr in profiles.items():
        sess = Session(cfg, params, n_slots=EP_SLOTS, max_seq=EP_MAX_SEQ,
                       device="cuda", prof=pr)
        first = sess.prefill(prompts)
        served[k] = (sess, np.concatenate(
            [first[:, None], sess.generate(EP_STEPS)], axis=1),
            sess.fingerprint())
    kv_launches = kv_commit.LAUNCHES["kv_commit"]
    (_, t1, f1), (_, t2, f2) = served.values()
    assert np.array_equal(t1, t2) and f1 == f2, "sessions differ"
    assert ((t1 >= 0) & (t1 < cfg.padded_vocab)).all()
    assert kv_launches == 2 * EP_STEPS, kv_launches
    for k, (sess, _, _) in served.items():
        times[f"decode step {k}"] = median_ms(sess.step)
    del served, sess, params, local, frames
    torch.cuda.empty_cache()

    # c. one pot step with float32 masters
    state = init_state(lm.init_params(gen(SEED), cfg, dtype=torch.float32))
    batch = family_batch(cfg, TP_SEQ, TP_ROWS, 0)
    steps = {k: make_train_step(cfg, prof=pr, mode="pot",
                                n_microbatches=TRAIN_MICRO, lr=TRAIN_LR,
                                wd=TRAIN_WD) for k, pr in profiles.items()}
    fused_adamw.reset_launches()
    trained = {}
    for k, step in steps.items():
        new, loss = step(state, batch)
        trained[k] = (loss.view(torch.int32).item(),
                      tree_digest([new.params, new.opt["m"], new.opt["v"]]))
        del new
    adamw_launches = fused_adamw.LAUNCHES["fused_adamw"]
    n_leaves = len(leaves(state.params))
    assert trained[label] == trained["dense"], "the train steps differ"
    assert adamw_launches == 2 * n_leaves, (adamw_launches, n_leaves)
    assert np.isfinite(np.int32(trained["dense"][0]).view(np.float32))
    for k, step in steps.items():
        times[f"train step {k}"] = median_ms(lambda: step(state, batch))
    del state, steps
    torch.cuda.empty_cache()
    return dict(times=times, fingerprint=f1, n_leaves=n_leaves,
                kv_launches=kv_launches, adamw_launches=adamw_launches)


def smi_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def phase_tp(mesh) -> tuple[int, int]:
    """Phase 19b: the attention and MLP sublayers tensor- and
    sequence-parallel at world 1 on phase 18a's mesh, each check bitwise
    against the dense path (:func:`tp_against_dense`).  Returns the
    fused AdamW and kv_commit kernels' launches of the compared train
    steps and sessions."""
    from repro_torch.configs import get_config
    from repro_torch.runtime.shardings import Profile

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(TP_ARCH), n_layers=TP_LAYERS)
    got = tp_against_dense(cfg, Profile(mesh=mesh))
    log(f"tensor and sequence parallelism: world-1 NCCL group, (1, 1) "
        f"(data, model) mesh; {cfg.name} cut to {cfg.n_layers} layers "
        f"(widths untouched): forward logits, prefill logits and "
        f"cache and a decode step's from that cache on {TP_ROWS} x "
        f"{TP_SEQ} bf16 tokens bitwise equal to the dense path; Session ({EP_SLOTS} slots, {EP_PROMPT}-token "
        f"prompts, {EP_STEPS} steps) tokens and fingerprint "
        f"{got['fingerprint']:#010x} bitwise equal, kv_commit launches "
        f"{got['kv_launches']}; pot step ({TRAIN_MICRO} microbatches, "
        f"{got['n_leaves']} float32 leaves) loss and every parameter and "
        f"moment leaf bitwise equal, fused_adamw launches "
        f"{got['adamw_launches']} ({time.perf_counter() - t0:.1f} s)")
    log(f"  tensor parallelism ms (median of {EP_TIMED} after one, "
        f"{smi_line()}): " + "; ".join(
            f"{k} {v:.3f}" for k, v in got["times"].items()))
    return got["adamw_launches"], got["kv_launches"]


def phase_tp_kinds(mesh) -> tuple[int, int]:
    """Phase 19c: tensor parallelism of the mamba2 and RG-LRU mixers and
    of whisper's encoder and cross-attention at world 1 on phase 18a's
    mesh, one family of TP_KINDS at a time, each check bitwise against
    the dense path (:func:`tp_against_dense`).  Returns the fused AdamW
    and kv_commit kernels' launches of the compared train steps and
    sessions."""
    from repro_torch.configs import get_config
    from repro_torch.runtime.shardings import Profile

    adamw = kv = 0
    for arch, n_layers, n_enc in TP_KINDS:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), n_layers=n_layers,
                                  encoder_layers=n_enc)
        got = tp_against_dense(cfg, Profile(mesh=mesh))
        adamw += got["adamw_launches"]
        kv += got["kv_launches"]
        enc = (f" and {n_enc} encoder layers over {cfg.n_frames} stub "
               f"frames" if n_enc else "")
        log(f"tensor parallelism of {cfg.name} (pattern {cfg.pattern}) cut "
            f"to {cfg.n_layers} layers{enc}, widths untouched, world-1 "
            f"NCCL group, (1, 1) (data, model) mesh: forward, prefill and "
            f"a decode step from its cache on {TP_ROWS} x {TP_SEQ} bf16 "
            f"tokens bitwise equal to the dense path; Session ({EP_SLOTS} slots, {EP_PROMPT}-token "
            f"prompts, {EP_STEPS} steps) tokens and fingerprint "
            f"{got['fingerprint']:#010x} bitwise equal, kv_commit launches "
            f"{got['kv_launches']}; pot step ({TRAIN_MICRO} microbatches, "
            f"{got['n_leaves']} float32 leaves) loss and every parameter "
            f"and moment leaf bitwise equal, fused_adamw launches "
            f"{got['adamw_launches']} ({time.perf_counter() - t0:.1f} s)")
        log(f"  {cfg.name} tensor parallelism ms (median of {EP_TIMED} "
            f"after one, {smi_line()}): " + "; ".join(
                f"{k} {v:.3f}" for k, v in got["times"].items()))
    return adamw, kv


def adafactor_against_dense(cfg, prof, label, rows, seq) -> dict:
    """Phase 19d's Adafactor step for ``cfg``: one pot step
    (TRAIN_MICRO microbatches of ``rows`` x ``seq`` tokens, float32
    masters) on ``prof``'s mesh and on ``SMOKE``, the loss and every
    parameter and statistic leaf bitwise equal; then the medians of
    EP_TIMED steps of each after a warm-up (``label`` and "dense" in the
    times)."""
    import torch
    from repro_torch.models import lm
    from repro_torch.runtime.shardings import SMOKE
    from repro_torch.train import init_state, make_train_step
    from repro_torch.tree import leaves

    params = lm.init_params(torch.Generator(device="cuda").manual_seed(SEED),
                            cfg, dtype=torch.float32)
    local = lm.local_params(params, cfg, prof)
    assert all(a is b for a, b in zip(leaves(local), leaves(params),
                                      strict=True)), "a world-1 shard is cut"
    state = init_state(local, "adafactor", cfg=cfg)
    batch = family_batch(cfg, seq, rows, 0)
    steps = {k: make_train_step(cfg, prof=pr, optimizer="adafactor",
                                mode="pot", n_microbatches=TRAIN_MICRO,
                                lr=TRAIN_LR)
             for k, pr in ((label, prof), ("dense", SMOKE))}
    trained = {}
    for k, step in steps.items():
        new, loss = step(state, batch)
        trained[k] = (loss.view(torch.int32).item(),
                      tree_digest([new.params, new.opt]))
        del new
    assert trained[label] == trained["dense"], "the Adafactor steps differ"
    assert np.isfinite(np.int32(trained["dense"][0]).view(np.float32))
    times = {f"adafactor step {k}": median_ms(lambda: step(state, batch))
             for k, step in steps.items()}
    counts = dict(n_leaves=len(leaves(state.params)),
                  n_stats=len(leaves(state.opt["stats"])))
    del state, steps, params, local
    torch.cuda.empty_cache()
    return dict(times=times, **counts)


def phase_mesh_layout(mesh) -> tuple[int, int]:
    """Phase 19d: the last of the mesh layout at world 1 on phase 18a's
    mesh, each check bitwise against the dense path: an Adafactor pot
    step on a mesh (19b's stablelm cell and 18c's deepseek cell), the
    ``pure_dp`` profile through every entry point (19b's checks,
    :func:`tp_against_dense`, and an Adafactor step) on stablelm-12b
    and mamba2-370m, and the refusal of a MoE config under ``pure_dp``.
    Returns the fused AdamW and kv_commit kernels' launches of the
    compared train steps and sessions."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm, moe
    from repro_torch.runtime.shardings import Profile

    grid = Profile(mesh=mesh)
    pure = Profile(mesh=mesh, pure_dp=True)
    arch, n_layers, rows, seq = DRYRUN_CELLS[0]
    cells = [(TP_ARCH, TP_LAYERS, TP_ROWS, TP_SEQ), (arch, n_layers, rows,
                                                     seq)]
    for arch, n_layers, rows, seq in cells:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
        got = adafactor_against_dense(cfg, grid, "mesh", rows, seq)
        log(f"adafactor on a mesh: world-1 NCCL group, (1, 1) (data, "
            f"model) mesh; {cfg.name} cut to {cfg.n_layers} layers (widths "
            f"untouched), pot step ({TRAIN_MICRO} microbatches of "
            f"{rows // TRAIN_MICRO} x {seq} tokens, {got['n_leaves']} "
            f"float32 leaves, {got['n_stats']} statistic tensors) loss and "
            f"every "
            f"parameter and statistic leaf bitwise equal to the dense path "
            f"({time.perf_counter() - t0:.1f} s)")
        log(f"  {cfg.name} adafactor on a mesh ms (median of {EP_TIMED} "
            f"after one, {smi_line()}): " + "; ".join(
                f"{k} {v:.3f}" for k, v in got["times"].items()))
    adamw = kv = 0
    for arch, n_layers in PURE_DP_CELLS:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
        got = tp_against_dense(cfg, pure, "pure_dp")
        got["times"].update(adafactor_against_dense(
            cfg, pure, "pure_dp", TP_ROWS, TP_SEQ)["times"])
        adamw += got["adamw_launches"]
        kv += got["kv_launches"]
        log(f"pure_dp of {cfg.name} cut to {cfg.n_layers} layers, widths "
            f"untouched, world-1 NCCL group, (1, 1) (data, model) mesh: "
            f"forward, prefill and a decode step from its cache on "
            f"{TP_ROWS} x {TP_SEQ} bf16 tokens bitwise equal to the dense "
            f"path; Session ({EP_SLOTS} slots, {EP_PROMPT}-token prompts, "
            f"{EP_STEPS} steps) tokens and fingerprint "
            f"{got['fingerprint']:#010x} bitwise equal, kv_commit launches "
            f"{got['kv_launches']}; pot steps ({TRAIN_MICRO} microbatches, "
            f"{got['n_leaves']} float32 leaves), AdamW and Adafactor: loss "
            f"and every parameter, moment and statistic leaf bitwise equal, "
            f"fused_adamw launches {got['adamw_launches']} "
            f"({time.perf_counter() - t0:.1f} s)")
        log(f"  {cfg.name} pure_dp ms (median of {EP_TIMED} after one, "
            f"{smi_line()}): " + "; ".join(
                f"{k} {v:.3f}" for k, v in got["times"].items()))
    # a MoE config under pure_dp: its expert specs name the model axis
    # twice, and the reference's shard_map fails on them
    cfg = dataclasses.replace(get_config(DRYRUN_CELLS[0][0]), n_layers=1)
    meta = lm.init_params(None, cfg, device="meta")
    for call in (lambda: lm.local_params(meta, cfg, pure),
                 lambda: moe.moe_apply(
                     meta["layers"][0]["moe"],
                     torch.zeros((TP_ROWS, 8, cfg.d_model), device="cuda"),
                     cfg, pure)):
        try:
            call()
        except ValueError as e:
            assert "twice" in str(e), e
        else:
            raise AssertionError(f"{cfg.name} under pure_dp was not refused")
    log(f"pure_dp of {cfg.name}: lm.local_params and the MoE layer refuse "
        f"it (its expert specs {pure.experts_in()} name the model axis "
        f"twice)")
    return adamw, kv


def phase_dryrun() -> int:
    """Phase 18b: the dry run's meta counts against the card.  Returns
    the fused AdamW kernel's launches of the timed steps."""
    import torch
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.kernels import fused_adamw
    from repro_torch.launch import dryrun, roofline_model
    from repro_torch.models import lm
    from repro_torch.train import init_state, make_train_step
    from repro_torch.tree import leaves

    one_card = roofline_model.Machine(
        peak_flops=roofline_model.H100_BF16_MATMUL,
        hbm_bw=roofline_model.H100_HBM_BW, link_bw=float("inf"), chips=1,
        model=1, data=1)
    sizes = {"data": 1, "model": 1}
    launches = 0
    for arch, n_layers, rows, seq in DRYRUN_CELLS:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
        shape = ShapeSpec(f"{rows}x{seq}", "train", seq, rows)
        meta = lm.init_params(None, cfg, dtype=torch.float32, device="meta")
        counted = dryrun.count_cell(cfg, shape, meta, n_mb=TRAIN_MICRO)
        prof = dryrun.profile_for(sizes, shape)
        predicted = dryrun.memory_per_card(
            cfg, shape, meta, lm.param_specs(cfg, prof), prof, sizes,
            counted, optimizer="adamw", n_mb=TRAIN_MICRO)["peak_bytes"]
        t_meta = time.perf_counter() - t0

        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        params = lm.init_params(
            torch.Generator(device="cuda").manual_seed(SEED), cfg,
            dtype=torch.float32)
        on_card = dryrun.count_cell(cfg, shape, params, n_mb=TRAIN_MICRO)
        assert on_card["flops"] == counted["flops"], (on_card, counted)
        step_fn = make_train_step(cfg, mode="pot",
                                  n_microbatches=TRAIN_MICRO, lr=TRAIN_LR,
                                  wd=TRAIN_WD)
        state = init_state(params)
        del params
        dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=rows)
        batches = [batch_at(dcfg, i, device="cuda")
                   for i in range(DRYRUN_STEPS + 1)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fused_adamw.reset_launches()
        times = []
        for i, batch in enumerate(batches):
            (state, loss), t = timed(lambda: step_fn(state, batch))
            if i:
                times.append(t)
        n_launches = fused_adamw.LAUNCHES["fused_adamw"]
        n_leaves = len(leaves(state.params))
        assert n_launches == len(batches) * n_leaves, n_launches
        assert torch.isfinite(loss), loss
        measured = torch.cuda.max_memory_allocated() - base
        ratio = predicted / measured
        assert PEAK_RANGE[0] <= ratio <= PEAK_RANGE[1], (predicted, measured)
        step_s = float(np.median(times))
        terms = roofline_model.terms(
            cfg, shape, {"flops": counted["flops"], "bytes": counted["bytes"],
                         "collectives": {"total": 0.0}},
            optimizer="adamw", n_mb=TRAIN_MICRO, machine=one_card)
        assert terms["bound_s"] <= step_s, (terms, step_s)
        launches += n_launches
        log(f"dry run {cfg.name} cut to {cfg.n_layers} layers, {rows} x "
            f"{seq} tokens (pot, {TRAIN_MICRO} microbatches, AdamW; meta "
            f"{t_meta:.1f} s): FLOPs meta {counted['flops']:.6e} == card "
            f"{on_card['flops']:.6e}; peak per card predicted "
            f"{predicted / 1e9:.3f} GB, measured {measured / 1e9:.3f} GB "
            f"(ratio {ratio:.3f}, in [{PEAK_RANGE[0]}, {PEAK_RANGE[1]}]); "
            f"step median {step_s * 1e3:.3f} ms of {DRYRUN_STEPS} against "
            f"the roofline bound {terms['bound_s'] * 1e3:.3f} ms "
            f"({terms['bottleneck']}: compute {terms['compute_s'] * 1e3:.3f}"
            f" ms, modeled memory {terms['memory_s'] * 1e3:.3f} ms, "
            f"dispatch bytes {terms['memory_s_hlo_bound'] * 1e3:.3f} ms): "
            f"step-to-bound {step_s / terms['bound_s']:.3f}; fused_adamw "
            f"launches {n_launches} ({time.perf_counter() - t0:.1f} s)")
        del state, batches
        torch.cuda.empty_cache()
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails here outside a checkout)

    log(smi_line())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    torch.use_deterministic_algorithms(True)
    t_start = time.perf_counter()
    for name, fn in list(globals().items()):
        if name.startswith("phase_") and callable(fn):
            globals()[name] = clocked(fn)
    # the CPU referee starts at once: its runs are ready before the
    # phases that read them
    import multiprocessing
    referee = multiprocessing.get_context("spawn").Pool(
        1, initializer=referee_init)
    try:
        cpu = {fn.__name__: referee.apply_async(fn) for fn in (
            cpu_main_path, cpu_engines, cpu_engines_pipelined)}
        return run_phases(cpu, t_start)
    finally:
        referee.terminate()
        referee.join()


def run_phases(cpu, t_start) -> int:
    """Every phase in order; ``cpu`` holds the CPU referee's pending
    results by function name."""
    import torch
    phase_build()

    wls = stream_workloads()
    stream, extra = wls[:N_BATCHES], wls[N_BATCHES]
    kernels = phase_kernels(stream[0].batch.to("cuda"))
    phase_spec_strip(stream[0].batch.to("cuda"), stream[1].batch.to("cuda"))
    kernels["kv_commit"] = phase_kv_commit()
    adamw, spec_launches = phase_adamw()
    kernels.update(adamw)
    kernels["validate_bitsets"], _ = phase_validate(stream[0])
    main_stream = stream[:MAIN_PATH_BATCHES]
    gpu_session, gpu_traces, launches, seconds = phase_main_path(main_stream)
    phase_held_to_account(main_stream, gpu_session, gpu_traces,
                          cpu["cpu_main_path"].get())
    phase_round_breakdown(extra)
    from repro_torch import convert
    dense = dict(fingerprint=gpu_session.fingerprint(),
                 replay_log=gpu_session.replay_log(), seconds=seconds,
                 traces=[convert.trace_to_numpy(t) for t in gpu_traces],
                 **convert.store_to_numpy(gpu_session.store))
    del gpu_session, gpu_traces
    # the validation kernel's launches on this slice's path: the depth-2
    # serving run's (phase 2d drives it once through ops.validate)
    served_launches, served = phase_pipelined_serving(stream)
    launches["validate_bitsets"] = served_launches["validate_bitsets"]
    sharded, _ = phase_sharded(main_stream, dense, served)
    # phase 19a holds the mesh store to the dense run's first batch
    mesh_dense = {k: dense[k] for k in ("traces", "replay_log", "seconds")}
    # phase 9's launcher starts beside phase 12, whose first run (the
    # victim's, which dies) no metric reads
    launch_dir = tempfile.TemporaryDirectory()
    launcher = start_launcher(launch_dir.name)
    try:
        phase_recovery(served, sharded)
        del sharded, served, dense
        params, launches["kv_commit"] = phase_serve()
        phase_serve_held(params)
        del params                # the 24 GB of serving weights
        torch.cuda.empty_cache()
        launches["kv_commit"] += phase_families()
        launches["fused_adamw"], trained = phase_train()
        launches["fused_adamw_speculative"] = spec_launches
        phase_train_held(launcher)
    finally:
        if launcher[0].poll() is None:
            launcher[0].kill()
            launcher[0].wait()
        launch_dir.cleanup()
    phase_legacy_scan(stream[0])
    phase_dp_train(trained)
    phase_ring()
    launches["fused_adamw"] += phase_train_families()
    import torch.distributed as dist
    try:
        mesh = phase_layout()
        adamw_ep, kv_ep = phase_moe_ep(mesh)
        for name, n in phase_store_mesh(main_stream, mesh_dense).items():
            launches[name] += n
        adamw_tp, kv_tp = phase_tp(mesh)
        adamw_kinds, kv_kinds = phase_tp_kinds(mesh)
        adamw_layout, kv_layout = phase_mesh_layout(mesh)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    launches["fused_adamw"] += adamw_ep + adamw_tp + adamw_kinds + \
        adamw_layout
    launches["kv_commit"] += kv_ep + kv_tp + kv_kinds + kv_layout
    launches["fused_adamw"] += phase_dryrun()
    # phase 17b's CPU steps run in a thread beside phases 10 and 10b
    adafactor = phase_adafactor_card()
    phase_engines(stream[0], cpu["cpu_engines"].get())
    phase_engines_pipelined(wls, cpu["cpu_engines_pipelined"].get())
    phase_adafactor_held(adafactor)

    summary = [dict(name=name, route="cuda", source=SOURCES[name],
                    replaces=REPLACES[name], launches=launches[name],
                    **kernels[name]) for name in REPLACES]
    log("phase seconds (wall): " + json.dumps(
        {k[len("phase_"):]: round(v, 1) for k, v in PHASE_SECONDS.items()}
        | {"total": round(time.perf_counter() - t_start, 1)}))
    log(json.dumps({"kernels": summary}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
