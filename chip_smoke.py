#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``nsdp_tpu_torch``) on one NVIDIA card and check it.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases (any failure exits non-zero and prints no result line):

1. setup: TF32 off, the card's name and power limit, the CUDA kernels built
   from ``nsdp_tpu_torch/csrc`` (one ``nvcc`` per source, in parallel) and
   the host library from ``nsdp_tpu_torch/native`` (``c++``); per
   kernel ptxas's registers, shared memory and spills, and the count of
   tensor-core instructions in its SASS: warpgroup ``HGMMA`` (``wgmma``)
   and warp ``HMMA`` (``mma.sync``) -- K2's ``bwd_rows_kernel`` without
   ``HGMMA``, or its ``wgrad_kernel`` or K1's ``attn_mma16_kernel``
   without ``HMMA``, fails;
2. kernels: each hand-written forward kernel held against its plain PyTorch
   version at every shape the main path gives it -- fused kNN attention
   (K1) within rtol 1e-4 / atol 1e-5 and bit for bit against the output
   digests of ``K1_DIGESTS`` (below), furthest-point sampling (K3) index
   for index (also on clouds of 14,497, 50,000 and 40,962 points, above
   the shared-memory variant's size, and 120,000, above the cluster
   variant's; each row names its variant and cluster size), K4 (kNN)
   index for index and distance for distance (each row names its warps a
   query and its passes), the row gather (P1/P2) bit for bit -- and timed
   beside it
   (CUDA events, median; K4 and the gather, whose calls are shorter than
   their host dispatch, by the device time ``torch.profiler`` records);
   the gather also beside ``torch.gather``, one PyTorch call that computes
   it (the port never calls it); K1's device time split by CUDA kernel
   (``torch.profiler``); K1's narrow-operand mode (``compute_dtype``) on
   the same arguments at every site in bfloat16, and at ``decoder_surface``
   and ``set_abstraction_1`` (D = 256, the largest shared memory) in
   float16: its relative L2 gap to its plain version at most
   ``K1_NARROW_SHARE`` (1/4) of the plain version's gap to the plain float32
   version, its device time by CUDA kernel naming the tensor-core kernels
   (``NARROW_KERNELS``) and none of the float32 mode's own
   (``F32_ONLY_KERNELS``), timed beside it with the float32 mode's bound,
   and the wrapper's shared-memory sizing held against the kernel's
   (``nsdp_attention_narrow_smem``); K3's
   latency bound, its dependent steps at the
   measured cost of one step of a 1024-point cloud; K4's latency bound at
   each site, the function's dependent chain: its k warp arg-min rounds
   and a fan-in-32 reduction of the M points spread one a lane over warps
   (ceil(log32 M) - 1 rounds more), at K4's measured cost of one round,
   plus its fixed cost (``knn_round_ms``);
2b. K2, the attention's backward, at every training site (batch 2): each
   gradient's relative L2 error against the plain version run in float64
   on the card at most twice the float32 plain version's (floor 1e-6);
   ``gamma_b1``'s gradient, analytically zero, absolutely (at most 1e-4 of
   the largest ``gamma_w1`` gradient); then K2 and the plain backward timed
   at the training batch, K2's device time split by CUDA kernel (the row
   kernel's beside the 32-row ``mma.sync`` design's, ``K2_ROWS_MS_32``),
   and ``wgrad_cublas_ms``: cuBLAS's time for the four weight-gradient
   products at the same shapes, a yardstick the port never calls; the row
   kernel's shared-memory sizing held against the wrapper's
   (``nsdp_attention_bwd_smem``);
3. serving: the shipped full-width ``configs/deform4d/arbitrary.yaml``
   model with seeded random weights, captured (``DeformationService``'s
   default on the card): ``warmup`` captures every entry at every bucket
   (the wrappers' counters move only there: each program's eager run and
   its capture), then it serves three ``deform`` requests (Q = 3000, 20000
   masked, 65536) and an edit session with two drags, all replays (the
   counters must not move); each replay's kernels, counted from the
   kernel nodes of the graphs it replayed (``graph_kernels``,
   ``LAUNCH_KERNELS``), must be exactly 17 K1 and 4 K3 (and no K2, K4 or
   gather) per full evaluation, 9 + 2 per edit session and 8 + 2 per drag
   (the forward half only); then one evaluation is traced: device time by
   kind, the device's idle share, and any kernel node the trace holds no
   record of (``torch.profiler`` loses records of graph replays);
3b. training: the shipped ``forward`` and ``backward`` (batch 16) and
   ``arbitrary`` (batch 8) models at full width with seeded random weights,
   their steps captured (``make_steps``' default on the card), take their
   eager first step and the capture step (each launching, or recording,
   K1/K2/K3 8/8/2, 8/8/2 and 17/17/4 by the counters) and 4 timed replays
   on seeded batches (N = Q = 5000, a handle mask; the counters must not
   move); every loss finite, the parameters moved; median step time and
   peak device memory; the kernel nodes of the step's graph exactly the
   eager step's launches; one replayed step against two eager twins loaded
   with its state (phase 10c's rule: the loss and every buffer bit for
   bit); one replay traced; a checkpoint saved and resumed gives the same
   next loss;
3c. serving the encoder ablation, configuration A (``ablation_config``:
   ``arbitrary.yaml`` with the ``pointnet++`` encoder, full width, seeded
   random weights) as phase 3 serves the shipped model: 3 K1 / 4 K3 / 4 K4
   / 4 gather launches per full evaluation, 1 / 2 / 2 / 2 per drag,
   2 / 2 / 2 / 2 per edit session; the median evaluation at Q = 65536, the
   drags at Q = 20000 and one traced evaluation;
3d. training the two ablations at full width: A in stage 2 (B = 8, K1/K2/
   K3/K4/gather 3/3/4/4/4 per step) and B (``forward.yaml`` with the
   ``pointnet++`` encoder and the ``interp`` decoder) in stage 1 (B = 16,
   0/0/2/2/2), a warm-up and 4 timed steps each on batches with a handle
   mask (B's queries near its surface, where the interpolation weights do
   not underflow): losses finite, parameters moved, step time and peak
   memory, one step of each traced;
4. reference: the card's canonicalize and deform halves against the plain
   PyTorch path on the CPU, at full width on a small query set (within
   rtol 1e-3 / atol 2e-4 of the float32 path -- or, where the float32 path
   itself errs beyond that against float64, with a largest absolute error
   against float64 at most twice the float32 path's -- and as close to the
   float64 path, by relative L2 error, as the float32 path within a factor
   of 2), and the whole predict at a tiny width;
4b. one full-width stage-2 train step (batch 1, N = 5000, Q = 1024) on the
   card against the CPU plain path in float32 and float64, by halves cut at
   the canonical pose as phase 4 compares (the CPU paths take the card's
   canonicalised points and their gradients, so every selection sees the
   same coordinates): the loss within
   rtol 1e-4, the canonicalised points' gradients, every parameter gradient
   and every BatchNorm running statistic after the step (compound EMA
   included) by the phase-2b rule, widened to 4 times the float32 path's
   error with a floor of 1e-4 (ReLU near-ties: see the phase);
   gradients that vanish analytically (a bias that the slot softmax or a
   train-mode BatchNorm right after it cancels) are held absolutely, as
   ``gamma_b1`` is in phase 2b;
4c. configuration A by phases 4 and 4b's rules: its halves at full width
   on a small query set and a tiny predict, then one full-width stage-2
   step by halves (on a batch seed without near-ties, as phase 4b's);
5. entry points: synthetic fixtures at the shipped sizes in a temporary
   directory (deform4d: 4 frames of a 40,962-vertex mesh, 5000 surface and
   space samples; TOSCA-style meshes of 40,962 and 10,242 vertices) and a
   weight file of seeded weights; ``python -m nsdp_tpu_torch.test`` on the
   shipped ``arbitrary.yaml`` (3 pairs) and ``python -m nsdp_tpu_torch.run``
   on ``configs/tosca/head.yaml`` for each mesh, in process, each
   evaluation through ``make_steps``' captured ``predict`` (a signature's
   first call eager, its second captured): 34 K1 and 8 K3 launches per
   pair (two full evaluations) by the wrappers at the first two pairs of
   ``test`` and at ``run``'s one pair a mesh (whose two signatures stay
   eager), each replay's kernel nodes a full evaluation, the programs
   captured and the signatures left eager reported (``test_programs``);
   then ``test`` and ``run`` (40,962 vertices) anew in turns, captured
   and eager (``graphs=False``), 3 of each, every ``test`` turn's files
   byte for byte the main path's, the wall time per pair of each turn
   (``entry_turns``); 4 of the K3 launches by
   ``fps_cluster_kernel`` on the 40,962-vertex mesh (none on 10,242
   vertices) and none by ``fps_global_kernel``, the written meshes and
   point clouds finite; wall time per pair split into data, test_on_batch,
   metrics (the native float32 KD-tree of ``nsdp_tpu_torch/native``, the
   JAX package's search; the first pair's two searches timed again by it
   and by scipy's ``KDTree`` in turns) and writers; one pair of ``test`` and
   of ``run`` on 10,242
   vertices against the CPU by halves (phase 4's rule); ``test`` once more
   from the same weights written in the JAX package's model file layout
   (flax msgpack, ``write_flax_model_file``): its meshes and point clouds
   byte for byte the first run's; then K1's begin
   blocks and first set abstraction at M = 40,962 and K3 on the mesh and on
   its canonicalised surface (40,962 -> 500) against their plain versions;
6. the training entry point: ``python -m nsdp_tpu_torch.train`` (its
   step captured), in
   process, on a synthetic deform4d fixture at the shipped sample counts
   (4 identities x 2 motions x 9 frames, 5000 surface and space samples)
   with the shipped ``forward``, ``backward`` and ``arbitrary`` configs cut
   only in their data paths, ``interval``, ``num_sampled_pairs``, epochs (2)
   and save and validation frequencies (1): stage 1 twice, stage 2 from
   their last files, each with ``--profile_dir``, then stage 2 resumed to a
   third epoch.  Every train step must launch K1/K2/K3/K4/gather 8/8/2/0/0
   or 17/17/4/0/0 (the counters at the eager first step and the capture,
   nothing at a replay; the kernel nodes of each captured graph) and
   every validation batch the forward half of that; each
   run writes ``params.json``, ``stats.txt``, two model and optimizer files
   and one ``modelbest_*``, finite losses, moved parameters; stage 2's
   branches hold the stage-1 files bit for bit before its first step, the
   resume starts at epoch 2 from ``model_00001``/``opt_00001`` bit for bit;
   then the same three files rewritten in the JAX package's layout (flax
   msgpack, ``write_flax_model_file`` / ``write_flax_opt_file``: Adam's
   state as optax keeps it) in a fresh directory, and stage 2 resumed from
   there: the model (but its BatchNorm counters, which flax does not keep)
   and the optimizer before the first step, K2's inputs at every call and
   the resumed epoch's losses bit for bit those of the resume from the
   torch files (both resumes at ``--num_workers 0``, so both draw the same
   items; the second replays K2's outputs of the first, ``K2Tape``; both
   resumes eager, since a captured step's K2 runs inside its graph);
   every validation batch through its program (a signature's first,
   eager call and its capture counted by the wrappers, each replay's
   kernel nodes the forward half of a step); ``watch_stats`` captured on
   the card (a train step's launches by the wrappers at its first, eager
   call and again at its capture, a train step's in each replay's kernel
   nodes) against the eager ``watch_stats`` (bit
   for bit; gradient norms by phase 10c's rule where K2's float64 atomics
   reorder), leaving the model, its ``.grad`` and the optimizer bit for
   bit as they were, both timed in turns.  Logged per run:
   StepTimer's step intervals, the wall time of the loop's parts
   (``main``'s return), peak memory, the synchronising CUDA calls of a step
   (``torch.cuda.set_sync_debug_mode``), and the traced first epoch's device
   activity and idle share.  Then phase 10's ``train`` in turns: stage 2
   from the stage-1 files, 3 epochs, eager, captured, captured, eager,
   untraced, with each run's data / step / fetch split and its two
   validation passes (captured: the first eager then captured, the second
   replayed);
7. several processes on the one card (``torch.distributed``; each rank a
   ``python3 chip_smoke.py --rank ...`` process started here, the kernels
   built before; a failed rank fails the phase and every rank is killed):
   (a) two gloo ranks through ``make_steps(group=...)`` (a gloo group's
   steps stay eager on the card), two stage-2 steps
   of the shipped model (B = 8, 4 rows a rank, N = Q = 5000, phase 4b's
   seeds, weights with O(1) outputs): K1/K2/K3 17/17/4 per step and rank;
   the ranks' states bit for bit equal after two steps; after one, held by
   halves at the canonical pose (the canonicalised points and their
   gradients too) against one process on the card in float32
   and the plain path in float64 by phase 4b's rule (4 times the float32
   error, floor 1e-4); the same two ranks in float64 (the plain path)
   within 1e-9 of one process; (b) one NCCL rank: eager
   (``graphs=False``), bit for bit the step without a group (K2's
   float64-atomic outputs replayed, its inputs held bit for bit), no
   synchronising call from the end of its first step to the end of its
   second; 20 captures of all-reduces in torch's default global capture
   mode right after unwaited eager all-reduces, none broken
   (``capture_stress``); captured (``make_steps``' default under NCCL,
   the all-reduces inside the graph): from one state a replayed step
   against the eager grouped step and the captured step without a group
   by phase 10c's rule, the graph's kernel nodes K1/K2/K3 17/17/4 with
   NCCL's kernels and every node kind counted beside the ungrouped
   graph's, no synchronising call from the end of one replayed step to
   the end of the next; the four steps (eager and captured, with and
   without the group) timed in turns, and the eager two and the captured
   grouped one traced (the device's idle share, the host's time in each
   all-reduce); (c) ``python -m
   nsdp_tpu_torch.train`` (stage 1, ``forward.yaml`` on phase 6's fixture,
   2 epochs) on two gloo ranks whose group the phase sets up before
   ``main`` runs: the files written once, by rank 0, ``stats.txt`` holding
   rank 0's progress lines, both ranks printing the same losses; each
   rank's step interval and peak memory (two ranks sharing one card: not a
   scaling figure);
8. ``model.compute_dtype: bfloat16`` and ``model.remat``: (a) the shipped
   ``forward`` (B = 16) and ``arbitrary`` (B = 8) configs with
   ``compute_dtype: bfloat16`` trained as phase 3b trains them (its launches,
   finite losses, parameters moved and still float32), step time and peak
   memory beside phase 3b's float32 ones; (b) 40 stage-1 Adam steps at
   B = 8 on one batch from one seeded init in float32 and in bfloat16
   (``scripts/check_precision_convergence.py``'s run), both trajectories
   printed, the bfloat16 one finite and ending below its start; (c) one
   stage-2 step (B = 8) with ``remat: true`` against two without from the
   same state: the loss and every BatchNorm buffer bit for bit, every
   gradient and parameter bit for bit or, where K2's float64 atomics
   reorder, within phase 4b's rule of the first step without remat (4 times
   the two steps' own gap, floor 1e-4); 34 / 17 / 8 K1 / K2 / K3 launches a
   step under remat (each encoder and decoder forward runs again in the
   backward); step time and peak memory of both; (d) one evaluation of the
   shipped model at Q = 65,536 through ``FlowArbitrary.predict(
   compute_dtype=torch.bfloat16)``: 17 K1 launches, all in the narrow mode
   (``fused_vector_attention.narrow_launches``), each held against the plain
   narrow version on the CPU on the arguments it got (phase 2's rule); its
   relative L2 gap to the float32 evaluation printed and taken apart (each
   half on the same inputs, the float32 deform moved by the narrow
   canonical pose, the deforming encoder's FPS picks that differ);
9. the host tools, on the card machine's host (phase 1 also builds
   ``nsdp_tpu_torch/native`` with ``c++``, timed): the native KD-tree's
   ``nearest_neighbor_distances`` on 30,000 x 30,000 points against
   scipy's ``KDTree`` (the same indices; distances within 4 float32 ulps of
   scipy's float64 ones rounded to float32, the share equal printed), both
   timed; ``meshing.marching_cubes`` on a 128^3 sphere SDF (closed,
   welded, every vertex within one voxel of the radius), timed;
   ``python -m nsdp_tpu_torch.preprocess`` as subprocesses on 2
   identities x 7 frames of a 40,962-vertex mesh (``.anime`` files) at the
   default sample counts: ``anime``, ``deform4d --seed 0`` (read back by
   ``Deform4DFlowDataset``), ``nocorr``, and ``deform4d --make_watertight``
   by ``sdf`` and by ``poisson`` on each sequence's first frame (``--interval
   7``: at the default spacing one frame's SDF takes about a minute; each
   watertight frame closed), each command timed;
10. (run after phase 4c, before phase 5: its busy times come from
   ``torch.profiler``, which lost records of graph replays late in an
   earlier run of this script) captured against eager
   (``nsdp_tpu_torch/graphs.py``): (a) for the
   shipped model and A, a captured and an eager service with the same
   weights, each warmed alone (warm-up time, peak and held memory):
   ``deform`` at every bucket, plain and masked, two edit sessions at one
   bucket with their drags interleaved (the first's drag unchanged) and a
   masked one, every output bit for bit (``hold_captured``: where the
   replay's cuBLAS kernels differ from the eager run's, within rtol 1e-3 /
   atol 2e-4 with the kernels named); each program's kernel nodes; for the
   shipped model also two replicas on the card (``devices=``), captured
   against eager bit for bit, the same way, each replayed call launching
   twice one replica's kernels; an evaluation at Q = 65,536 and a drag at 20,000 timed in turns
   (captured, eager, eager, captured) and traced (busy, idle share); (b)
   ``predict`` at Q = 65,536 through a captured program in float32 and
   ``compute_dtype=torch.bfloat16`` against the eager calls, bit for bit
   and in turns; (c) captured train steps -- stage 1, stage 2, bf16 of
   each, remat, ``nan_guard`` with a NaN batch -- against two eager twins loaded
   with the captured run's state at the capture, the NaN step and the
   sixth step (the loss and every buffer bit for bit; gradients and
   parameters bit for bit or, where K2's float64 atomics reorder, by phase
   4b's rule), the step graph's kernel nodes exactly the eager launches,
   and the step timed
   in turns; (d) peak and held memory of three steps, each model alone,
   captured and eager, then with validation and ``watch_stats`` run to
   their replays too (the evaluation programs in the step's pool);
   (e) ``make_steps``' evaluation programs of the
   shipped stage-2 model (``validate_step`` and ``validate_step_masked``
   at ``train``'s validation batch, ``watch_stats``, ``predict`` at
   ``test``'s shapes) against the eager steps: outputs bit for bit (the
   gradient norms by phase 10c's rule where K2's float64 atomics
   reorder), a held ``predict`` output unchanged by the next call, each
   program's kernel nodes its eager launches (``EVAL_LAUNCHES``), timed in
   turns.  Every timing is printed beside the card's name and power
   limit.
11. the benchmark (``python -m nsdp_tpu_torch.bench``): its child mode for
   ``qps``, ``drag_ms`` and ``train_step_ms_stage2_b8``, one measurement
   each (``NSDP_BENCH_REPEATS=1``), each in a process of its own: the
   line parses, its value is finite and positive, and its process launched
   K1 and K3 (and K2 for the step); the phase's seconds are printed.

The second-to-last lines are the card (``nvidia-smi``) and a ``kernels``
JSON object (K1's and K2's entries also carry ``bound_tc_ms``, their bound
were their D x D products all on the tensor cores in 3xTF32; K3's and
K4's ``bound_latency_ms``; K1's ``bf16``, its narrow mode's entry per
evaluation with phase 8d's launches, bounded with its D x D products on the
bf16 tensor cores (``bound_narrow``; ``bound_f32_ops_ms``: the float32
mode's bound; ``bound_share``: the bound over the kernel's time), and
``f16_decoder_surface`` and ``f16_set_abstraction_1``); the
last line is ``{"ok": true, "device": {...}}``.

K1's digests: ``K1_DIGESTS`` holds the SHA-256 of K1's output bytes at each
phase-2 site, recorded from the kernel as it was before the decoder's
broadcast path (``attn_kernel`` at every site) on the phase's own inputs,
so any change to K1 must keep every output bit.  Record them again
(``python3 ab_k1.py .`` on the card prints the table) only after a
deliberate change to K1's arithmetic, or when the card's machine gets a
new CUDA toolkit (``expf`` and the compiler's code may round
differently); the table's comment names the toolkit.
"""

import collections
import contextlib
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
import weakref

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "deform4d", "arbitrary.yaml")
# H100 SXM data sheet: f32 outside the tensor cores, HBM3 rate (700 W part);
# 3xTF32 on the tensor cores: three TF32 products (495 TFLOP/s dense) per one;
# bf16 and f16 operands on the tensor cores, f32 accumulation (dense)
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
PEAK_3XTF32_FLOPS = 495e12 / 3
PEAK_BF16_FLOPS = 989e12
K1_TOL = dict(rtol=1e-4, atol=1e-5)
E2E_TOL = dict(rtol=1e-3, atol=2e-4)
# K1's narrow mode against its plain version: the relative L2 gap at most
# this share of the plain narrow version's gap to the plain float32 one
K1_NARROW_SHARE = 0.25
# the narrow mode's kernels on the tensor cores, and the float32 mode's own,
# which a narrow call must not launch (the selection and the broadcast
# query's global logits, knn_kernel and glob_logits_kernel, are shared)
NARROW_KERNELS = ("attn_mma16_kernel", "weight_frags16_kernel")
F32_ONLY_KERNELS = ("attn_kernel", "attn_bcast_kernel", "weights_in_out_kernel")
# sites of phase 2 where the narrow mode also runs in float16
K1_F16_SITES = ("decoder_surface", "set_abstraction_1")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, reps: int) -> float:
    """Median time of ``fn`` on the card (CUDA events), after one warm call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_events(torch, fn, reps: int):
    """The device activities ``torch.profiler`` records over ``reps`` calls
    of ``fn``, after one warm call (:func:`profiled`)."""
    fn()
    return profiled(torch, lambda: [fn() for _ in range(reps)])[1]


def device_ms(torch, fn, reps: int) -> float:
    """Device time of one call of ``fn``: the summed durations of the
    device activities over ``reps`` calls, over ``reps``.  For calls
    shorter than their host dispatch, where CUDA events (:func:`time_ms`)
    time the host."""
    return sum(e.time_range.elapsed_us() for e in device_events(torch, fn, reps)) / 1e3 / reps


def kernel_name(name: str) -> str:
    """A device activity's kernel name without its return type, namespaces
    and template arguments (``void (anonymous namespace)::attn_kernel<4>(...)``
    -> ``attn_kernel``)."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
    return name.split("::")[-1].replace("void ", "").strip() or "?"


def kernel_split(torch, fn, reps: int) -> dict:
    """Device time of one call of ``fn``, by CUDA kernel name (ms)."""
    split = {}
    for e in device_events(torch, fn, reps):
        key = kernel_name(e.name)
        split[key] = split.get(key, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    return split


def format_split(split: dict) -> str:
    return ", ".join(f"{k} {v:.4f}" for k, v in sorted(split.items(), key=lambda kv: -kv[1]))


def bound(flops: float, nbytes: float):
    """(least time in ms, what bounds it) on the card's published peaks."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bound_tc(row) -> float:
    """Least time in ms of a K1 or K2 site with its D x D products on the
    tensor cores in 3xTF32 (165 TFLOP/s) and the rest of its operations in
    f32 (67 TFLOP/s), or its bytes, whichever is longer."""
    mm = row["mm_flops"]
    t_ops = (mm / PEAK_3XTF32_FLOPS + (row["flops"] - mm) / PEAK_F32_FLOPS) * 1e3
    return max(t_ops, row["bytes"] / PEAK_BYTES * 1e3)


def bound_narrow(row):
    """(least time in ms, what bounds it) of K1's narrow mode at a site:
    its D x D products (``mm_flops``) on the tensor cores with bf16/f16
    operands (989 TFLOP/s), the rest of its operations in f32 (67 TFLOP/s,
    the 3-wide first ``fc_delta`` layer among them); its bytes
    (``k1_narrow_bytes``)."""
    mm = row["mm_flops"]
    t_ops = (mm / PEAK_BF16_FLOPS + (row["flops"] - mm) / PEAK_F32_FLOPS) * 1e3
    t_bytes = row["bytes"] / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def surface(rng, n: int) -> np.ndarray:
    """A closed blobby surface around the origin (every point is an FPS
    candidate: |p|^2 ~ 1)."""
    v = rng.randn(n, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    theta, phi = np.arccos(v[:, 2]), np.arctan2(v[:, 1], v[:, 0])
    r = 1.0 + 0.25 * np.sin(3 * theta) * np.cos(2 * phi)
    return (v * r[:, None] * np.array([1.0, 0.7, 1.3])).astype(np.float32)


def ablation_config(name: str) -> dict:
    """Configuration A (the encoder ablation: ``arbitrary.yaml`` with the
    ``pointnet++`` encoder) or B (the decoder ablation: ``forward.yaml`` with
    the ``pointnet++`` encoder and the ``interp`` decoder), built from the
    shipped config as the JAX package's tests build theirs: the module
    swapped, the shipped widths kept (5000 -> 500 -> 100 points, k = 16,
    d_transformer 256, three group-all blocks; decoder ``dim`` 200,
    ``hidden_dim`` 128)."""
    from nsdp_tpu_torch.utils.config import load_config

    shipped = "arbitrary" if name == "A" else "forward"
    cfg = load_config(os.path.join(REPO, "configs", "deform4d", f"{shipped}.yaml"))
    model = cfg["model"]
    model["encoder"] = "pointnet++"
    for key in ("nneighbor_reduced", "d_reduced", "full_SA"):
        model["encoder_kwargs"].pop(key)
    if name == "B":
        model["decoder"] = "interp"
        model["decoder_kwargs"].pop("nneigh")
    return cfg


# ---------------------------------------------------------------- phase 2


def k1_sites():
    """The attention launches of one full evaluation at Q = 65536, then the
    other shapes the served requests give it (a masked request, the 4096
    bucket), which count 0 launches per evaluation:
    (name, launches per evaluation, Nq, M, k, D, mode, masked)."""
    return [
        ("bwd_encoder_begin", 1, 5000, 5000, 10, 120, "pos_only", False),
        ("fwd_encoder_begin", 1, 5000, 5000, 10, 120, "featured", False),
        ("set_abstraction_0", 4, 500, 5000, 16, 120, "featured", False),
        ("transformer_downs_0", 2, 500, 500, 16, 120, "featured", False),
        ("set_abstraction_1", 4, 100, 500, 16, 256, "featured", False),
        ("transformer_downs_1", 2, 100, 100, 16, 256, "featured", False),
        ("decoder_queries", 2, 65536, 100, 7, 200, "global", False),
        ("decoder_surface", 1, 5000, 100, 7, 200, "global", False),
        ("bwd_encoder_begin_masked", 0, 5000, 5000, 10, 120, "pos_only", True),
        ("fwd_encoder_begin_masked", 0, 5000, 5000, 10, 120, "featured", True),
        ("set_abstraction_0_masked", 0, 500, 5000, 16, 120, "featured", True),
        ("decoder_queries_4096", 0, 4096, 100, 7, 200, "global", False),
    ]


def k1_inputs(torch, rng, surf, fps_500, fps_100, site, B=1):
    """The attention's arguments at ``site``: the clouds of the main path
    (the same cloud in every batch item), random features and weights."""
    name, _, nq, m, k, d, mode, masked = site
    dev = torch.device("cuda")
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    rep = lambda x: np.repeat(np.asarray(x)[None], B, axis=0)
    cloud = {len(surf): surf, 500: surf[fps_500], 100: surf[fps_500][fps_100]}
    kv = cloud[m]
    if name.startswith("set_abstraction"):
        xyz_q = -cloud[nq]  # FPS centres; the set abstraction negates both sets
        kv = -kv
    elif mode == "global":
        xyz_q = rng.uniform(-1.3, 1.3, (nq, 3)) if nq != 5000 else surf
    else:
        xyz_q = kv
    w = [rng.randn(3, d) * 0.5, rng.randn(d) * 0.1, rng.randn(d, d) / np.sqrt(d),
         rng.randn(d) * 0.1, rng.randn(d, d) / np.sqrt(d), rng.randn(d) * 0.1,
         rng.randn(d, d) / np.sqrt(d), rng.randn(d) * 0.1]
    # the weights as the modules pass them: transposed views of nn.Linear's
    # (out, in) weights, read in place by the kernel
    weights = [t(x.T).t() if x.ndim == 2 else t(x) for x in w]
    args = dict(xyz_q=t(rep(xyz_q)), kv_xyz=t(rep(kv)), q_feats=None, K_a=None,
                V_a=None, weights=weights, k=k)
    if mode != "pos_only":
        args["K_a"], args["V_a"] = t(rng.randn(B, m, d)), t(rng.randn(B, m, d))
        if mode == "global":  # the decoder's query is one broadcast row
            args["q_feats"] = t(rng.randn(B, 1, d)).expand(B, nq, d)
            args["k_glob"], args["v_glob"] = t(rng.randn(B, d)), t(rng.randn(B, d))
        else:
            args["q_feats"] = t(rng.randn(B, nq, d))
    if masked:
        mask = np.ones((B, m), np.float32)
        mask[:, -m // 10:] = 0.0
        args["kv_mask"] = t(mask)
    return args


# SHA-256 of K1's output bytes at each phase-2 site (``k1_digest``), recorded
# from ``attn_kernel`` at every site on an NVIDIA H100 80GB HBM3 (700 W),
# nvcc 12.9, PyTorch 2.11.0+cu128 (module docstring, "K1's digests").
K1_DIGESTS = {
    "bwd_encoder_begin":
        "0f813f2e526850b2645e4a4f8b64f53827365780cd70f2a6b678761a47d0906a",
    "fwd_encoder_begin":
        "89c11eeb11c5efaaaa45b84192774019dc24aafac5a60a537ed269111c5c9fb9",
    "set_abstraction_0":
        "429d10a264b95cb5f52a149222302bee4a7e998f3727849d2bd02a27b9ea3422",
    "transformer_downs_0":
        "03f31e72842aeb64e1fae8187710970d622afa2bca4942db9ab4c36d00317ea8",
    "set_abstraction_1":
        "a6c69f49a02b6f4f8f2913235850ee41ff97afc0433c6091733d492762b73aa6",
    "transformer_downs_1":
        "4f09aba4f2c94fea3778bc8e47db535c5348afd84d5787b75e143ea5cca4b65a",
    "decoder_queries":
        "bcc1377df9fa961a90c5ce5a8fc37373de7c117ee3f58f033af6c336da4b047d",
    "decoder_surface":
        "5c9459c58cf0258d554c5f5ee6c0c3505e0bd9111e19cdd18a5bc83a8f0cf399",
    "bwd_encoder_begin_masked":
        "a9a9f25aa2e26c03526915c457edfebb2367e0ba07d36994341b649496e3a6d9",
    "fwd_encoder_begin_masked":
        "19e1a33006b07a85318415d51bfa0f2c04dbbf2368c0704b076849dac1cb6cd7",
    "set_abstraction_0_masked":
        "14f6bd24d40db98eae96a69fa85132afadd66dff2f2dd4603535153f1840fbb5",
    "decoder_queries_4096":
        "c1d591916798fdd2a6db3d87daa3be9a96c28bbeaae8b9ce25f85e9cd23fe26a",
}


def k1_digest(out) -> str:
    """SHA-256 of a K1 output's bytes (float32, C order, on the host)."""
    return hashlib.sha256(out.detach().contiguous().cpu().numpy().tobytes()).hexdigest()


def fps_step_ms(torch, fps) -> float:
    """K3's fixed cost of one dependent step: the time of a 1024-point cloud
    (one point a thread of the block) sampled to 1024 points, over its 1023
    steps.  (npoint - 1) times it is K3's latency bound at a site."""
    cloud = torch.as_tensor(surface(np.random.RandomState(2), 1024)[None], device="cuda")
    step_ms = time_ms(torch, lambda: fps.furthest_point_sample(cloud, 1024), 5) / 1023
    log(f"K3 one step of a 1024-point cloud: {step_ms * 1e3:.3f} us")
    return step_ms


def k1_mm_flops(site):
    """Flops of the attention's D x D products at ``site``: three per
    neighbour slot, and two for the global slot once per batch item (the
    decoder's query is one broadcast row, so its global logits are the same
    for every query)."""
    _, _, nq, m, k, d, mode, masked = site
    return float(nq * k * 6 * d * d + (4 * d * d if mode == "global" else 0))


def k1_work(site):
    """(flops, bytes) the attention at ``site`` must do and move (the
    global slot's logits once per batch item, as in ``k1_mm_flops``)."""
    _, _, nq, m, k, d, mode, masked = site
    glob = mode == "global"
    per_query = 9 * m + k * (6 * d * d + 20 * d) + (8 * d if glob else 0)
    floats = nq * 3 + m * 3 + nq * d  # queries, kv points, output
    floats += 3 * d + 4 * d + 3 * d * d  # fc_delta, fc_gamma
    if mode != "pos_only":
        floats += 2 * m * d + (d if glob else nq * d)  # K, V, q (one row if broadcast)
    floats += 2 * d if glob else 0
    floats += m if masked else 0
    return float(nq * per_query + (4 * d * d + 4 * d if glob else 0)), float(4 * floats)


def k1_narrow_bytes(site):
    """The bytes of ``k1_work`` with the operands the narrow mode rounds
    before the launch read at 2 bytes: the MLP weights (3 x D and three
    D x D) and V."""
    _, _, nq, m, k, d, mode, masked = site
    rounded = 3 * d + 3 * d * d + (m * d if mode != "pos_only" else 0)
    return k1_work(site)[1] - 2.0 * rounded


def check_kernels(torch, rng, surf):
    from nsdp_tpu_torch.ops import fps

    x = torch.as_tensor(surf[None], device="cuda")
    fps_500 = fps.furthest_point_sample(x, 500)[0].cpu().numpy()
    fps_100 = fps.furthest_point_sample(
        torch.as_tensor(surf[fps_500][None], device="cuda"), 100)[0].cpu().numpy()

    rows = {"fps": (fps_500, fps_100), "k1": [], "k1_bf16": [], "k1_f16": []}
    for site in k1_sites():
        a = k1_inputs(torch, rng, surf, fps_500, fps_100, site)
        rows["k1"].append(check_k1_site(torch, a, site))
        # the narrow-operand mode on the same arguments (no draw of its own)
        rows["k1_bf16"].append(check_k1_narrow(torch, a, site, torch.bfloat16))
        if site[0] in K1_F16_SITES:
            rows["k1_f16"].append(check_k1_narrow(torch, a, site, torch.float16))
        del a
    check_narrow_sizing()
    rows["k3"] = check_fps(torch, surf, fps_500)
    return rows


def check_narrow_sizing():
    """The narrow kernel's shared memory against ``ops/attention.py``'s
    mirror of it (which the CPU tests hold under the card's 227 KB), at
    every D of phase 2."""
    from nsdp_tpu_torch.ops import _build, attention

    lib = _build.load("attention", attention._SIGNATURES)
    for d in sorted({site[5] for site in k1_sites()} | {12, 37, 40}):
        got, want = lib.nsdp_attention_narrow_smem(d), attention.narrow_smem_bytes(d)
        if got != want:
            fail(f"narrow K1 at D={d}: the kernel takes {got} bytes of shared memory, the"
                 f" wrapper's mirror says {want}")
    log("narrow K1: the kernel's shared memory equals the wrapper's mirror at every D")


def check_k1_site(torch, a, site, digest=True):
    """K1 at ``site`` on the arguments ``a`` against its plain version
    (``K1_TOL``), and with ``digest`` bit for bit against ``K1_DIGESTS``;
    timed beside it -> the site's row."""
    from nsdp_tpu_torch.ops import attention

    kw = {key: a[key] for key in ("k_glob", "v_glob", "kv_mask") if key in a}
    pos = (a["xyz_q"], a["kv_xyz"], a["q_feats"], a["K_a"], a["V_a"], *a["weights"])
    run = lambda: attention.fused_vector_attention(*pos, k=a["k"], **kw)
    penalty = attention.mask_penalty(a["kv_mask"]) if "kv_mask" in a else None
    run_plain = lambda: attention.fused_vector_attention_plain(
        *pos, a["k"], a.get("k_glob"), a.get("v_glob"), penalty)
    with torch.inference_mode():
        got = run()
        torch.cuda.synchronize()
        sha = k1_digest(got)
        if digest and sha != K1_DIGESTS.get(site[0]):
            fail(f"K1 at {site[0]}: output digest {sha} differs from the recorded"
                 f" {K1_DIGESTS.get(site[0])} (K1_DIGESTS): a bit of the output moved")
        ref = run_plain()
        err = float((got - ref).abs().max())
        if not torch.allclose(got, ref, **K1_TOL):
            fail(f"K1 at {site[0]}: max abs err {err} beyond {K1_TOL}")
        del got, ref
        ms = time_ms(torch, run, 5)
        plain_ms = time_ms(torch, run_plain, 3)
        split = kernel_split(torch, run, 5)
    flops, nbytes = k1_work(site)
    row = dict(site=site[0], per_eval=site[1], Nq=site[2], M=site[3], k=site[4], D=site[5],
               ms=ms, plain_ms=plain_ms, max_abs_err=err, flops=flops, bytes=nbytes,
               split=split, mm_flops=k1_mm_flops(site))
    log(f"K1 {site[0]:<26} Nq={site[2]:<6} M={site[3]:<5} k={site[4]:<3} D={site[5]:<4}"
        f" kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound(flops, nbytes)[0]:.4f} ms"
        f" ({bound(flops, nbytes)[1]}), on the tensor cores {bound_tc(row):.4f} ms"
        f"  max_abs_err {err:.3g}")
    log(f"   device by kernel (ms): {format_split(split)}; output sha256 {sha}"
        f" ({'recorded' if digest else 'not recorded'})")
    return row


def check_k1_narrow(torch, a, site, dtype):
    """K1's narrow-operand mode (``compute_dtype``) at ``site`` on phase 2's
    arguments ``a``: its relative L2 gap to the plain narrow version on the
    card at most ``K1_NARROW_SHARE`` of that version's gap to the plain
    float32 version; timed beside it -> the site's row (the float32 mode's
    operations, bounded by ``bound_narrow``; ``bound_f32_ops_ms``: the float32
    mode's bound on the same work, for reference)."""
    from nsdp_tpu_torch.ops import attention

    kw = {key: a[key] for key in ("k_glob", "v_glob", "kv_mask") if key in a}
    pos = (a["xyz_q"], a["kv_xyz"], a["q_feats"], a["K_a"], a["V_a"], *a["weights"])
    penalty = attention.mask_penalty(a["kv_mask"]) if "kv_mask" in a else None
    run = lambda: attention.fused_vector_attention(*pos, k=a["k"], compute_dtype=dtype, **kw)
    plain = lambda cd: attention.fused_vector_attention_plain(
        *pos, a["k"], a.get("k_glob"), a.get("v_glob"), penalty, compute_dtype=cd)
    with torch.inference_mode():
        before = attention.fused_vector_attention.narrow_launches
        got = run()
        if attention.fused_vector_attention.narrow_launches != before + 1:
            fail(f"K1 {dtype} at {site[0]}: the narrow mode's kernel was not launched")
        ref, ref_f32 = plain(dtype), plain(None)
        gap, err = rel_err(ref, ref_f32), rel_err(got, ref)
        max_err = float((got - ref).abs().max())
        if not (gap > 0 and err <= K1_NARROW_SHARE * gap):
            fail(f"K1 {dtype} at {site[0]}: relative L2 gap {err:.3g} to its plain version,"
                 f" beyond {K1_NARROW_SHARE} x the plain version's gap {gap:.3g} to float32")
        del got, ref, ref_f32
        ms = time_ms(torch, run, 5)
        plain_ms = time_ms(torch, lambda: plain(dtype), 3)
        split = kernel_split(torch, run, 5)
    name = str(dtype).replace("torch.", "")
    if any(k not in split for k in NARROW_KERNELS) or any(k in split for k in F32_ONLY_KERNELS):
        fail(f"K1 {name} at {site[0]}: its device time by kernel ({format_split(split)}) must"
             f" name {', '.join(NARROW_KERNELS)} and none of {', '.join(F32_ONLY_KERNELS)}")
    flops, f32_bytes = k1_work(site)
    row = dict(site=site[0], per_eval=site[1], ms=ms, plain_ms=plain_ms, max_abs_err=max_err,
               rel_l2=err, gap=gap, flops=flops, bytes=k1_narrow_bytes(site),
               mm_flops=k1_mm_flops(site), narrow=True, split=split,
               device_ms=sum(split.values()), bound_f32_ops_ms=bound(flops, f32_bytes)[0])
    log(f"K1 {name} {site[0]:<26} kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound"
        f" {bound_narrow(row)[0]:.4f} ms ({bound_narrow(row)[1]}; float32's"
        f" {row['bound_f32_ops_ms']:.4f} ms); relative L2 gap to its plain version {err:.3g}"
        f" ({err / gap:.3f} of the plain version's {gap:.3g} to float32), max_abs_err"
        f" {max_err:.3g}")
    log(f"   device by kernel (ms): {format_split(split)}")
    return row


def check_fps(torch, surf, fps_500):
    """K3 against its plain version on the card, index for index, timed
    beside it and its latency bound (phase 2) -> rows."""
    from nsdp_tpu_torch.ops import fps

    # the path's clouds, then clouds above the shared-memory variant's size
    # (a mesh's vertices: a surface with 1% of its points at the origin),
    # the last above the cluster variant's, from their own RandomState so
    # K1's and later phases' inputs stay put
    rows = []
    big = np.random.RandomState(1)
    large = [surface(big, n) for n in (14497, 50000, 40962, 120000)]
    for cloud in large:
        cloud[big.choice(len(cloud), len(cloud) // 100, replace=False)] = 0.0
    step_ms = fps_step_ms(torch, fps)
    for per_eval, npoint, cloud in ((2, 500, surf), (2, 100, surf[fps_500]),
                                    *((0, 500, cloud) for cloud in large)):
        rows.append(check_fps_cloud(torch, cloud, npoint, per_eval, step_ms))
    return rows


def check_fps_cloud(torch, cloud, npoint, per_eval, step_ms, what=""):
    """K3 on one (N, 3) cloud against its plain version, index for index,
    timed beside it and its latency bound -> the site's row."""
    from nsdp_tpu_torch.ops import fps

    n = len(cloud)
    xyz = torch.as_tensor(np.asarray(cloud, np.float32)[None], device="cuda")
    got = fps.furthest_point_sample(xyz, npoint)
    torch.cuda.synchronize()
    ref = fps.furthest_point_sample_plain(xyz, npoint)
    if not torch.equal(got, ref):
        fail(f"K3 {n}->{npoint}{what}: indices differ from the plain version")
    ms = time_ms(torch, lambda: fps.furthest_point_sample(xyz, npoint), 5)
    plain_ms = time_ms(torch, lambda: fps.furthest_point_sample_plain(xyz, npoint), 3)
    flops = float((npoint - 1) * n * 9 + n * 5)
    nbytes = float(n * 12 + npoint * 4)
    latency_ms = (npoint - 1) * step_ms
    kind, c = fps.variant(n)
    log(f"K3 fps {n}->{npoint}{what} ({kind}, C={c}): kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
        f"  bound {bound(flops, nbytes)[0]:.6f} ms ({bound(flops, nbytes)[1]}),"
        f" latency bound {latency_ms:.4f} ms  indices equal")
    return dict(site=f"{n}->{npoint}{what}", per_eval=per_eval, ms=ms, plain_ms=plain_ms,
                max_abs_err=0.0, flops=flops, bytes=nbytes, bound_latency_ms=latency_ms)


def clouds(torch, rng, surf, B):
    """(cloud (B, 5000, 3), its 500 FPS centres, their 100 FPS centres) on
    the card: the surface itself at B = 1, jittered copies beyond."""
    from nsdp_tpu_torch.ops import fps, index_points

    pts = np.repeat(surf[None], B, axis=0)
    if B > 1:
        pts = pts + 0.01 * rng.randn(*pts.shape).astype(np.float32)
    x = torch.as_tensor(pts, device="cuda")
    c500 = index_points(x, fps.furthest_point_sample(x, 500))
    return x, c500, index_points(c500, fps.furthest_point_sample(c500, 100))


def knn_sites():
    """K4's shapes: (name, launches per full evaluation of configuration A,
    B, Nq, M, k, kv_mask, return_dist).  The set abstraction's grouping at
    both levels (2 launches each: one per encoder), at serving's B = 1 and
    training's B = 8; the non-fused JAX begin block (5000 x 5000, k = 10,
    B = 8, masked, with distances); a cloud larger than shared memory
    holds (14,496 points)."""
    return [
        ("sa_level0", 2, 1, 500, 5000, 16, False, False),
        ("sa_level1", 2, 1, 100, 500, 16, False, False),
        ("sa_level0_b8", 0, 8, 500, 5000, 16, False, False),
        ("sa_level1_b8", 0, 8, 100, 500, 16, False, False),
        ("begin_block_b8", 0, 8, 5000, 5000, 10, True, True),
        ("large_cloud", 0, 1, 2000, 20000, 16, False, True),
    ]


def knn_work(site):
    """(flops, bytes) of K4 at ``site``: 9 f32 operations per (query,
    point) pair (3 differences, 3 squares, 3 sums with the penalty);
    coordinates, mask and outputs once."""
    _, _, B, nq, m, k, masked, rd = site
    floats = B * (nq * 3 + m * 3 + nq * k * (2 if rd else 1) + (m if masked else 0))
    return float(9 * B * nq * m), float(4 * floats)


def knn_round_ms(torch):
    """(fixed cost, cost of one warp arg-min round) of K4 in ms: the line
    through its device times on one query against 32 points (one a lane: a
    single scan step) at k = 17 and k = 32, both with a 32-entry list."""
    from nsdp_tpu_torch.ops.knn import knn

    kv = torch.as_tensor(surface(np.random.RandomState(3), 32)[None], device="cuda")
    q = kv[:, :1].contiguous()
    t17, t32 = [device_ms(torch, lambda k=k: knn(q, kv, k), 50) for k in (17, 32)]
    round_ms = (t32 - t17) / 15
    fixed_ms = t17 - 17 * round_ms
    log(f"K4 one query of 32 points: k = 17 {t17 * 1e3:.3f} us, k = 32 {t32 * 1e3:.3f} us:"
        f" one arg-min round {round_ms * 1e3:.4f} us, fixed cost {fixed_ms * 1e3:.3f} us")
    if round_ms <= 0.0:
        fail("K4: the device time did not grow with k, no cost of a round to take")
    return fixed_ms, round_ms


def knn_latency_ms(fixed_ms, round_ms, m, k) -> float:
    """K4's latency bound at M points and k: the k dependent arg-min rounds
    that emit the neighbours, behind ceil(log32 M) - 1 rounds that reduce
    the M points, one a lane, across warps (fan-in 32, pipelined with the
    emitting rounds), each at K4's cost of one round, plus its fixed cost
    (the launch, staging and one distance a lane)."""
    levels = max(1, -(-(m - 1).bit_length() // 5))  # ceil(log32 m)
    return fixed_ms + (k + levels - 1) * round_ms


def check_knn(torch, rng, surf):
    """K4 against ``knn_plain`` on the card, index for index and distance
    for distance, timed beside it and its latency bound (phase 2)."""
    from nsdp_tpu_torch.ops.knn import knn, knn_plain, split_warps, two_pass

    rows = []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fixed_ms, round_ms = knn_round_ms(torch)
    for site in knn_sites():
        name, per_eval, B, nq, m, k, masked, rd = site
        if name == "large_cloud":
            kv = torch.as_tensor(surface(rng, m)[None], device="cuda")
            q = kv[:, torch.as_tensor(rng.choice(m, nq, replace=False), device="cuda")]
        else:
            x, c500, c100 = clouds(torch, rng, surf, B)
            q, kv = {(500, 5000): (c500, x), (100, 500): (c100, c500), (5000, 5000): (x, x)}[(nq, m)]
        mask = None
        if masked:
            mask = torch.ones((B, m), device="cuda")
            mask[:, -m // 10:] = 0.0
        run = lambda: knn(q, kv, k, return_dist=rd, kv_mask=mask)
        run_plain = lambda: knn_plain(q, kv, k, return_dist=rd, kv_mask=mask)
        got = run()
        torch.cuda.synchronize()
        ref = run_plain()
        got, ref = (got, ref) if rd else ((got, None), (ref, None))
        if not torch.equal(got[0], ref[0]):
            fail(f"K4 at {name}: indices differ from the plain version")
        if rd and not torch.equal(got[1], ref[1]):
            fail(f"K4 at {name}: distances differ from the plain version")
        ms, plain_ms = device_ms(torch, run, 10), device_ms(torch, run_plain, 3)
        wall_ms = time_ms(torch, run, 5)
        latency_ms = knn_latency_ms(fixed_ms, round_ms, m, k)
        flops, nbytes = knn_work(site)
        rows.append(dict(site=name, per_eval=per_eval, ms=ms, plain_ms=plain_ms, max_abs_err=0.0,
                         flops=flops, bytes=nbytes, bound_latency_ms=latency_ms))
        t_b, by = bound(flops, nbytes)
        w = split_warps(B, nq, m, sms)
        log(f"K4 {name:<15} B={B:<2} Nq={nq:<5} M={m:<6} k={k:<3} mask={masked:d} dist={rd:d}"
            f" W={w} {'two passes' if two_pass(m, w) else 'one pass'}"
            f"  device: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {t_b:.6f} ms ({by}),"
            f" latency bound {latency_ms:.4f} ms; call (events) {wall_ms:.4f} ms;"
            f" indices{' and distances' if rd else ''} equal")
    return rows


def gather_sites():
    """The row gather's shapes: (name, launches per full evaluation of
    configuration A, B, M, W, S, k).  The set abstraction's grouping at
    both levels (B = 1 serving, B = 8 training) with the neighbourhoods K4
    selects there; the TPU probe's shape (``scripts/bench_gather_prefetch.py``:
    40 tiles x 128 queries x 16 slots from a (5120, 256) table, random
    indices)."""
    return [
        ("group_level0", 2, 1, 5000, 256, 500, 16),
        ("group_level1", 2, 1, 500, 256, 100, 16),
        ("group_level0_b8", 0, 8, 5000, 256, 500, 16),
        ("probe", 0, 1, 5120, 256, 40 * 128, 16),
    ]


def check_gather(torch, rng, surf):
    """The row gather against its plain version on the card, bit for bit,
    and timed beside ``torch.gather`` (phase 2)."""
    from nsdp_tpu_torch.ops.gather import gather_rows, gather_rows_plain
    from nsdp_tpu_torch.ops.knn import knn

    rows = []
    for name, per_eval, B, m, w, nq, k in gather_sites():
        table = torch.as_tensor(rng.randn(B, m, w).astype(np.float32), device="cuda")
        if name == "probe":
            idx = torch.as_tensor(rng.randint(0, m, (B, nq, k)).astype(np.int32), device="cuda")
        else:
            x, c500, c100 = clouds(torch, rng, surf, B)
            idx = knn(c500, x, k) if m == 5000 else knn(c100, c500, k)
        flat = idx.reshape(B, -1).long()[..., None].expand(-1, -1, w)
        run = lambda: gather_rows(table, idx)
        run_plain = lambda: gather_rows_plain(table, idx)
        run_library = lambda: torch.gather(table, 1, flat)
        got = run()
        torch.cuda.synchronize()
        if not torch.equal(got, run_plain()) or not torch.equal(got.reshape(B, -1, w), run_library()):
            fail(f"gather at {name}: rows differ from the plain version")
        ms, plain_ms, library_ms = [device_ms(torch, f, 20) for f in (run, run_plain, run_library)]
        wall_ms = time_ms(torch, run, 10)
        nbytes = float(4 * (B * m * w + B * nq * k + B * nq * k * w))
        rows.append(dict(site=name, per_eval=per_eval, ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, max_abs_err=0.0, flops=0.0, bytes=nbytes))
        log(f"gather {name:<16} B={B} table ({m}, {w}) by ({nq}, {k})  device: kernel {ms:.4f} ms"
            f"  plain {plain_ms:.4f} ms  torch.gather {library_ms:.4f} ms"
            f"  bound {bound(0.0, nbytes)[0]:.4f} ms (bytes); call (events) {wall_ms:.4f} ms;"
            f" rows equal")
    return rows


def kernel_entry(name, source, replaces, rows, launches):
    """One kernel's entry of the ``kernels`` line: times and bounds summed
    over the launches of one pass of its path (a full evaluation for K1 and
    K3, a stage-2 train step for K2, a full evaluation of configuration A
    for K4 and the row gather).  K1's narrow-mode rows are bounded by
    ``bound_narrow``, with the float32 mode's bound beside it."""
    per_pass = lambda key: sum(r[key] * r["per_eval"] for r in rows)
    narrow = rows[0].get("narrow", False)
    site_bound = bound_narrow if narrow else lambda r: bound(r["flops"], r["bytes"])
    op_ms = lambda r: (bound_narrow(dict(r, bytes=0.0))[0] if narrow
                       else r["flops"] / PEAK_F32_FLOPS * 1e3)
    t_ops = sum(op_ms(r) * r["per_eval"] for r in rows)
    t_bytes = per_pass("bytes") / PEAK_BYTES * 1e3
    bound_ms = sum(site_bound(r)[0] * r["per_eval"] for r in rows)
    entry = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": per_pass("ms"), "plain_ms": per_pass("plain_ms"), "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": per_pass("library_ms") if "library_ms" in rows[0] else None,
    }
    if narrow:
        entry["bound_f32_ops_ms"] = per_pass("bound_f32_ops_ms")
    elif "mm_flops" in rows[0]:  # K1, K2: the bound with the products on the tensor cores
        entry["bound_tc_ms"] = sum(bound_tc(r) * r["per_eval"] for r in rows)
    if "bound_latency_ms" in rows[0]:  # K3, K4: their dependent steps at their measured cost
        entry["bound_latency_ms"] = per_pass("bound_latency_ms")
    return entry


def check_gradient(what, card, f32, f64, partner_f64=None, factor=2.0, floor=1e-6):
    """Hold one gradient from the card against the plain path's float32 and
    float64 results -> the ratio of the card's relative L2 error to the
    float32 path's, or None for a gradient held absolutely.

    A gradient that vanishes analytically -- a bias cancelled by the slot
    softmax (``gamma_b1``) or by a train-mode BatchNorm right after it -- is
    rounding noise in float32 and ~0 in float64 (at most 1e-9 of its
    weight's gradient, ``partner_f64``): it is held absolutely, at most 1e-4
    of that scale.  Every other gradient's relative L2 error against
    float64 may be at most ``factor`` times the float32 path's, and never
    need be below ``floor``.
    """
    if partner_f64 is not None:
        scale = float(partner_f64.abs().max())
        if float(f64.abs().max()) <= 1e-9 * scale:
            err = float(card.abs().max())
            if err > 1e-4 * scale:
                fail(f"{what}: |gradient| {err:.3g}, analytically zero, beyond 1e-4 x {scale:.3g}")
            return None
    err, err_f32 = rel_err(card, f64), rel_err(f32, f64)
    if err > max(factor * err_f32, floor):
        fail(f"{what}: relative L2 error {err:.3g} against float64, more than {factor:g} times"
             f" the float32 plain path's {err_f32:.3g} and above {floor:g}")
    return err / max(err_f32, 1e-6)


# ---------------------------------------------------------------- phase 2b


def k2_sites():
    """The attention's backward at the training sites: (name, launches per
    stage-2 step, batch it is timed at, Nq, M, k, D, mode, masked).  The
    stage-1 nets run the same sites at batch 16 (one launch of each per
    net); the begin block is also timed there."""
    return [
        ("bwd_encoder_begin", 1, 8, 5000, 5000, 10, 120, "pos_only", False),
        ("fwd_encoder_begin", 1, 8, 5000, 5000, 10, 120, "featured", False),
        ("set_abstraction_0", 4, 8, 500, 5000, 16, 120, "featured", False),
        ("transformer_downs_0", 2, 8, 500, 500, 16, 120, "featured", False),
        ("set_abstraction_1", 4, 8, 100, 500, 16, 256, "featured", False),
        ("transformer_downs_1", 2, 8, 100, 100, 16, 256, "featured", False),
        ("decoder", 3, 8, 5000, 100, 7, 200, "global", False),
        ("bwd_encoder_begin_masked", 0, 8, 5000, 5000, 10, 120, "pos_only", True),
        ("fwd_encoder_begin_masked", 0, 8, 5000, 5000, 10, 120, "featured", True),
        ("fwd_encoder_begin_stage1", 0, 16, 5000, 5000, 10, 120, "featured", False),
    ]


K2_GRADS = ("xyz_q", "kv_xyz", "q_feats", "K_a", "V_a", "delta_w0", "delta_b0", "delta_w1",
            "delta_b1", "gamma_w0", "gamma_b0", "gamma_w1", "gamma_b1", "k_glob", "v_glob")


def k2_work(site, B):
    """(flops, bytes) the backward at ``site`` must do and move: per
    neighbour row the three D x D products recomputed, three input-gradient
    and three weight-gradient products (18 D^2) plus O(D) elementwise work;
    a global-slot row needs no fc_delta (12 D^2)."""
    _, _, _, nq, m, k, d, mode, masked = site
    glob = mode == "global"
    flops = B * nq * (k * (18 * d * d + 40 * d) + (12 * d * d + 30 * d if glob else 0))
    floats = B * (2 * nq * 3 + 2 * m * 3 + nq * k + nq * d)  # coords and their grads, idx, g
    if mode != "pos_only":
        floats += B * (4 * m * d + (2 * d if glob else 2 * nq * d))  # K, V, q and their grads
    floats += B * 4 * d if glob else 0
    floats += B * m if masked else 0
    floats += 2 * (3 * d * d + 7 * d)  # weights and their gradients
    return float(flops), float(4 * floats)


def k2_mm_flops(site, B):
    """Flops of the backward's D x D products at ``site``: per neighbour
    row three recomputed, three input-gradient and three weight-gradient
    products (18 D^2), per global-slot row 12 D^2."""
    _, _, _, nq, m, k, d, mode, masked = site
    return float(B * nq * (k * 18 * d * d + (12 * d * d if mode == "global" else 0)))


def k2_operands(torch, a):
    from nsdp_tpu_torch.ops import attention

    ops = (a["xyz_q"], a["kv_xyz"], a["q_feats"], a["K_a"], a["V_a"], *a["weights"],
           a.get("k_glob"), a.get("v_glob"))
    penalty = attention.mask_penalty(a["kv_mask"]) if "kv_mask" in a else None
    idx = attention._launch(*ops[:13], a["k"], ops[13], ops[14], penalty)[1]
    return ops, idx


def check_backward(torch, rng, surf, fps_500, fps_100):
    """K2 against its plain version on the card (phase 2b)."""
    from nsdp_tpu_torch.ops import attention

    rows = []
    for site in k2_sites():
        k1_site = (site[0],) + site[1:2] + site[3:]
        a = k1_inputs(torch, rng, surf, fps_500, fps_100, k1_site, B=2)
        ops, idx = k2_operands(torch, a)
        g = torch.as_tensor(rng.randn(2, site[3], site[6]).astype(np.float32), device="cuda")
        got = attention.fused_vector_attention_backward(*ops, idx, g)
        torch.cuda.synchronize()
        f32 = attention.fused_vector_attention_bwd_plain(*ops, idx, g)
        f64 = attention.fused_vector_attention_bwd_plain(
            *[None if t is None else t.double() for t in ops], idx, g.double())
        worst, worst_abs = (0.0, ""), 0.0
        for name, x, y, z in zip(K2_GRADS, got, f32, f64):
            if x is None:
                continue
            partner = f64[K2_GRADS.index("gamma_w1")] if name == "gamma_b1" else None
            ratio = check_gradient(f"K2 at {site[0]}, d {name}", x, y, z, partner)
            worst = max(worst, (ratio or 0.0, name))
            worst_abs = max(worst_abs, float((x - y).abs().max()))
        del got, f32, f64
        B = site[2]
        a = k1_inputs(torch, rng, surf, fps_500, fps_100, k1_site, B=B)
        ops, idx = k2_operands(torch, a)
        g = torch.as_tensor(rng.randn(B, site[3], site[6]).astype(np.float32), device="cuda")
        run = lambda: attention.fused_vector_attention_backward(*ops, idx, g)
        ms = time_ms(torch, run, 3)
        plain_ms = time_ms(torch, lambda: attention.fused_vector_attention_bwd_plain(*ops, idx, g), 2)
        split = kernel_split(torch, run, 3)
        n_rows = B * site[3] * (site[5] + (site[7] == "global"))
        cublas_ms = wgrad_cublas_ms(torch, n_rows, site[6])
        flops, nbytes = k2_work(site, B)
        ws_gb = 4 * attention.backward_workspace_floats(
            B, site[3], site[5], site[6], site[7] == "global") / 1e9
        rows.append(dict(site=site[0], per_eval=site[1], B=B, Nq=site[3], M=site[4], k=site[5],
                         D=site[6], ms=ms, plain_ms=plain_ms, max_abs_err=worst_abs,
                         flops=flops, bytes=nbytes, workspace_gb=ws_gb, split=split,
                         wgrad_cublas_ms=cublas_ms, mm_flops=k2_mm_flops(site, B)))
        t_b, by = bound(flops, nbytes)
        log(f"K2 {site[0]:<26} B={B:<3} Nq={site[3]:<5} M={site[4]:<5} k={site[5]:<3} D={site[6]:<4}"
            f" kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {t_b:.4f} ms ({by}), on the"
            f" tensor cores {bound_tc(rows[-1]):.4f} ms  workspace {ws_gb:.3f} GB  largest error ratio to float32 plain {worst[0]:.3g}"
            f" (d {worst[1]})"
            f"  max_abs_err vs float32 plain {worst_abs:.3g}")
        log(f"   device by kernel (ms): {format_split(split)}; wgrad_cublas_ms {cublas_ms:.4f}")
        before = K2_ROWS_MS_32.get(site[0])
        log(f"   bwd_rows_kernel {split.get('bwd_rows_kernel', 0.0):.4f} ms (64-row wgmma tiles);"
            f" the 32-row mma.sync kernel: {'not read' if before is None else f'{before:.2f} ms'}")
        del ops, idx, g, a
    check_backward_sizing()
    return rows


# bwd_rows_kernel's device time per call at phase 2b's sites and batches on
# the 32-row mma.sync design it replaced (PERF.md, §6)
K2_ROWS_MS_32 = {"bwd_encoder_begin": 3.93, "fwd_encoder_begin": 5.66, "set_abstraction_0": 0.93,
                 "transformer_downs_0": 0.78, "set_abstraction_1": 0.86, "decoder": 8.90,
                 "fwd_encoder_begin_stage1": 11.22}


def check_backward_sizing():
    """K2's row kernel's shared memory against ``ops/attention.py``'s mirror
    of it (which the CPU tests hold under the card's 227 KB), at every D of
    phase 2b and at each warpgroup width's edges."""
    from nsdp_tpu_torch.ops import _build, attention

    lib = _build.load("attention_bwd", attention._SIGNATURES_BWD)
    for d in sorted({site[6] for site in k2_sites()} | {1, 8, 36, 64, 128, 130, 208}):
        got, want = lib.nsdp_attention_bwd_smem(d), attention.backward_smem_bytes(d)
        if got != want:
            fail(f"K2 at D={d}: the row kernel takes {got} bytes of shared memory, the"
                 f" wrapper's mirror says {want}")
    log("K2: the row kernel's shared memory equals the wrapper's mirror at every D")


def wgrad_cublas_ms(torch, n_rows: int, D: int) -> float:
    """A yardstick for K2's weight-gradient reduction: ``torch.matmul(X.T,
    Y)`` over the four ``[X | 1]^T Y`` products at the workspace's shapes
    (X of 3 + 1 and D + 1 columns, Y of D, ``n_rows`` rows each).  It is not
    K2's ``library_ms`` (it computes only this part of K2), and the port
    never calls it."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    Y = torch.randn(n_rows, D, device="cuda", generator=gen)
    X = [torch.randn(n_rows, dx + 1, device="cuda", generator=gen) for dx in (3, D, D, D)]
    ms = time_ms(torch, lambda: [torch.matmul(x.T, Y) for x in X], 3)
    del X, Y
    return ms


# ---------------------------------------------------------------- phase 3


def counts():
    """Launches so far of (K1, K2, K3, K4, the row gather)."""
    from nsdp_tpu_torch.ops import attention, fps, gather, knn

    return (attention.fused_vector_attention.launches,
            attention.fused_vector_attention_backward.launches,
            fps.furthest_point_sample.launches, knn.knn.launches, gather.gather_rows.launches)


def reset_counts():
    from nsdp_tpu_torch.ops import attention, fps, gather, knn

    attention.fused_vector_attention.launches = 0
    attention.fused_vector_attention.narrow_launches = 0
    attention.fused_vector_attention_backward.launches = 0
    fps.furthest_point_sample.launches = 0
    fps.furthest_point_sample.cluster_launches = 0
    fps.furthest_point_sample.global_launches = 0
    knn.knn.launches = 0
    gather.gather_rows.launches = 0


def expect_launches(before, want, what):
    got = tuple(a - b for a, b in zip(counts(), before))
    if got != want:
        fail(f"{what}: {' / '.join(map(str, got))} K1 / K2 / K3 / K4 / gather launches,"
             f" expected {' / '.join(map(str, want))}")


def check_output(out, shape, what):
    if out.shape != shape or not np.isfinite(out).all():
        fail(f"{what}: output {out.shape} (finite: {np.isfinite(out).all()}), expected {shape}")


# launches (K1, K2, K3, K4, gather) per full evaluation, edit session and drag
SERVE_LAUNCHES = {
    "shipped": {"deform": (17, 0, 4, 0, 0), "session": (9, 0, 2, 0, 0), "drag": (8, 0, 2, 0, 0)},
    # two pointnet++ encoders (FPS + K4 + gather at each of 2 levels) and
    # three crossatten decodes; a session canonicalises, a drag deforms
    "A": {"deform": (3, 0, 4, 4, 4), "session": (2, 0, 2, 2, 2), "drag": (1, 0, 2, 2, 2)},
}


def serve(torch, rng, surf, config, label):
    """Serve ``config`` with seeded random weights, captured (the service's
    default on the card): a warm-up that captures every entry at every
    bucket, three requests, an edit session with two drags (the main path),
    then timings and a traced evaluation.  The wrappers' counters move only
    at a capture (each program's throw-away eager run and its capture, twice
    ``SERVE_LAUNCHES[label]`` per bucket and mask) and not at all while the
    programs replay; each replay's kernels, counted from the kernel nodes
    of the graphs it replayed (:func:`replays`), must be
    ``SERVE_LAUNCHES[label]``.  -> (service, the main path's device
    launches (K1, K2, K3, K4, gather) by those nodes)."""
    from nsdp_tpu_torch.serving import DeformationService

    want = SERVE_LAUNCHES[label]
    svc = DeformationService(config, device="cuda", seed=0)
    n = surf.shape[0]
    handle = (surf[:, 2] > 0.8).astype(np.float32)[:, None]
    tgt = (surf + np.array([0.25, 0.0, 0.1], np.float32)) * handle
    inputs = np.concatenate([surf, tgt, handle], -1)
    pm = np.ones(n, np.float32)
    pm[-500:] = 0.0  # a padded-partial cloud: padded rows at the origin
    requests = [(3000, None), (20000, pm), (65536, None)]
    queries = {q: rng.uniform(-1.3, 1.3, (q, 3)).astype(np.float32) for q, _ in requests}

    reset_counts()  # ---- the main path: the captures, requests, a session, two drags
    t0 = time.perf_counter()
    svc.warmup(n)  # every entry at every bucket, captured
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    programs = svc.graphs[0].programs
    per_entry = tuple(d + s + g for d, s, g in zip(want["deform"], want["session"], want["drag"]))
    expect_launches((0,) * 5, tuple(2 * 2 * len(svc.buckets) * x for x in per_entry),
                    f"{label} warmup (each program's eager run and capture)")
    log(f"serving {label}: warmup captured {len(programs)} programs (3 buckets x deform,"
        f" canonicalize, drag x plain, masked) in {warm_s:.2f} s, the wrappers called at each"
        f" program's eager run and capture only")
    device = np.zeros(5, int)

    def replayed(fn, expected, what):
        before = counts()
        out, names = replays(svc.graphs, fn)
        expect_launches(before, (0,) * 5, f"{what}: the wrappers under replay")
        expect_replay(launch_counts(names), expected, what)
        device[:] += launch_counts(names)
        return out

    for q, mask in requests:
        inp = inputs if mask is None else inputs * mask[:, None]
        out = replayed(lambda: svc.deform(queries[q], inp, point_mask=mask), want["deform"],
                       f"{label} deform Q={q}")
        check_output(out, (q, 3), f"{label} deform Q={q}")
    pts = queries[20000]
    session = replayed(lambda: svc.edit_session(pts, surf), want["session"],
                       f"{label} edit_session")
    for scale in (1.0, 0.5):
        dragged = replayed(lambda: session.drag(tgt * scale, handle), want["drag"],
                           f"{label} drag (forward half only)")
        check_output(dragged, (20000, 3), f"{label} drag")
    launches = tuple(int(x) for x in device)  # ---- end of the main path
    full = svc.deform(pts, np.concatenate([surf, tgt * 0.5, handle], -1))
    if not np.allclose(dragged, full, rtol=1e-5, atol=1e-5):
        fail(f"{label}: drag differs from the full deform with the same conditioning")

    stats = {}
    for q, mask in requests:
        inp = inputs if mask is None else inputs * mask[:, None]
        t0 = time.perf_counter()
        svc.deform(queries[q], inp, point_mask=mask)
        stats[f"deform_ms_q{q}"] = (time.perf_counter() - t0) * 1e3
    eval_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        svc.deform(queries[65536], inputs)
        eval_ms.append((time.perf_counter() - t0) * 1e3)
    stats["eval_ms_q65536"] = float(np.median(eval_ms))
    stats["qps_q65536"] = 65536 / (stats["eval_ms_q65536"] / 1e3)
    drag_ms = []
    for scale in (1.0, 0.9, 0.8, 0.7, 0.6, 0.5, 0.4):
        t0 = time.perf_counter()
        session.drag(tgt * scale, handle)
        drag_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"serving {label} (captured): deform "
        f"{', '.join(f'Q={q}: {stats[f'deform_ms_q{q}']:.2f} ms' for q, _ in requests)}; main path"
        f" {' / '.join(map(str, want['deform']))} K1 / K2 / K3 / K4 / gather kernels a replay of"
        f" deform, {' / '.join(map(str, want['session']))} of a session,"
        f" {' / '.join(map(str, want['drag']))} of a drag (the graphs' kernel nodes)")
    log(f"serving {label}: full evaluation at Q=65536 {stats['eval_ms_q65536']:.2f} ms (median of 5,"
        f" {min(eval_ms):.2f}-{max(eval_ms):.2f}), {stats['qps_q65536']:.4g} query points/s")
    log(f"serving {label}: drag at Q=20000 {float(np.median(drag_ms)):.2f} ms (median of 7,"
        f" {min(drag_ms):.2f}-{max(drag_ms):.2f})")
    trace(torch, lambda: svc.deform(queries[65536], inputs), stats["eval_ms_q65536"],
          f"one {label} evaluation at Q=65536 (captured)", svc.graphs)
    return svc, launches


# the CUDA kernels of one K1 call (csrc/attention.cu); K3's variants (csrc/fps.cu)
K1_KERNELS = ("knn_kernel", "attn_kernel", "attn_bcast_kernel", "glob_logits_kernel",
              "weights_in_out_kernel")
K3_KERNELS = ("fps_kernel", "fps_cluster_kernel", "fps_global_kernel")


def busy_us(spans) -> float:
    """Length of the union of (start, end) intervals: the device's busy time."""
    spans = sorted(spans)
    total, (s0, e0) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > e0:
            total += e0 - s0
            s0, e0 = s, e
        else:
            e0 = max(e0, e)
    return total + e0 - s0


# the CUDA kernel that marks one launch of each wrapper (K1: its selection,
# in every mode; K2: its row kernel; K3: any variant; K4; the row gather)
LAUNCH_KERNELS = (("knn_kernel",), ("bwd_rows_kernel",), K3_KERNELS, ("knn_split_kernel",),
                  ("gather_rows_kernel",))


def launch_counts(names):
    """(K1, K2, K3, K4, gather) launches among kernel names (``LAUNCH_KERNELS``)."""
    return tuple(sum(n in kinds for n in names) for kinds in LAUNCH_KERNELS)


GRAPH_NODES = weakref.WeakKeyDictionary()  # program -> its graph's nodes


def graph_nodes(program):
    """The nodes of a captured program's CUDA graph as (kind, name) pairs:
    ``KERNEL`` with the kernel's name, or another kind (``MEMCPY``,
    ``MEMSET``, ...) with None.  Read from the graph's node list, which
    ``graphs.KEEP_GRAPHS`` keeps and ``CUDAGraph.debug_dump`` writes out
    (as Graphviz DOT, each kernel node with its mangled name); read once
    per program."""
    nodes = GRAPH_NODES.get(program)
    if nodes is not None:
        return nodes
    with tempfile.TemporaryDirectory() as d, warnings.catch_warnings():
        warnings.simplefilter("ignore")  # torch announces each dump
        path = os.path.join(d, "graph.dot")
        program.graph.debug_dump(path)
        with open(path) as f:
            text = f.read()
    nodes = []
    for node in re.split(r'^\s*"graph_\d+_node_\d+"\s*\[', text, flags=re.M)[1:]:
        if "KERNEL" in node:
            m = re.search(r"_Z\w+", node)
            c_name = re.search(r"\bnccl\w*", node)  # a kernel of C linkage
            nodes.append(("KERNEL", mangled_kernel(m.group()) if m
                          else c_name.group() if c_name else "?"))
        else:
            m = re.search(r"\b(MEMCPY|MEMSET|EVENT_RECORD|WAIT_EVENT|HOST|EMPTY|GRAPH|MEM_ALLOC"
                          r"|MEM_FREE|CONDITIONAL)\b", node)
            nodes.append((m.group(1) if m else "?", None))
    if not any(kind == "KERNEL" for kind, _ in nodes):
        fail(f"no kernel node in the dump of a captured graph: {text[:600]!r}")
    GRAPH_NODES[program] = nodes
    return nodes


def graph_kernels(program):
    """The kernel names of a captured program's CUDA graph, one per kernel
    node (:func:`graph_nodes`): exactly what each replay launches (the
    wrappers' counters do not move under replay)."""
    return [name for kind, name in graph_nodes(program) if kind == "KERNEL"]


def mangled_kernel(mangled: str) -> str:
    """The first ``*_kernel`` name (or NCCL's ``nccl*`` kernel name) of a
    mangled kernel name (its length prefix read: ``10knn_kernel`` ->
    ``knn_kernel``), or ``?``."""
    for m in re.finditer(r"\d+", mangled):
        name = mangled[m.end():m.end() + int(m.group())]
        if ((name.endswith("_kernel") or name.lower().startswith("nccl"))
                and re.fullmatch(r"[A-Za-z_]\w*", name)):
            return name
    return "?"


def step_programs(graphs):
    """The train step's programs in ``make_steps``' ``Graphs``, which also
    holds its evaluation programs."""
    return [p for (name, _), p in graphs.programs.items() if name == "train_step"]


def replay_launches(graphs, program):
    """(K1, K2, K3, K4, gather) launches of one replay of a captured
    program of ``graphs`` (:func:`graph_kernels`)."""
    if program.graph is None:
        fail(f"a program on {graphs.device} was never captured")
    return launch_counts(graph_kernels(program))


def replays(graphs_list, fn):
    """-> (``fn()``, the kernel names its replays launched): the kernel
    nodes (:func:`graph_kernels`) of each program of ``graphs_list`` whose
    calls moved, once per call.  A call that captured or ran eagerly
    instead, or that made a new program, fails."""
    before = [(p, p.calls, p.graph is not None) for g in graphs_list
              for p in g.programs.values()]
    out = fn()
    if len(before) != sum(len(g.programs) for g in graphs_list):
        fail("a call expected to replay made a new program")
    names = []
    for p, calls, captured in before:
        if p.calls != calls:
            if not captured:
                fail("a call expected to replay ran eagerly or captured")
            names += (p.calls - calls) * graph_kernels(p)
    return out, names


def expect_replay(got, want, what):
    """A replay's launches (``got``, its graphs' kernel nodes) against the
    eager launches (``want``): equal."""
    if got != want:
        fail(f"{what}: {' / '.join(map(str, got))} K1 / K2 / K3 / K4 / gather kernels a replay"
             f" (the graph's kernel nodes), expected {' / '.join(map(str, want))}")


def profiled(torch, fn):
    """-> (``fn()``, the device activities ``torch.profiler`` recorded
    over it).  A session now and then delivers no device activity; ``fn``
    then runs again, three times at most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if events:
            return out, events
    fail("the profiler recorded no device activity")


def trace(torch, run, wall_ms, what, graphs_list=None):
    """Device time of one call of ``run`` by kind, from ``torch.profiler``'s
    CUDA activity: the port's kernels (K1 = selection + attention, K2 = the
    attention's backward with its weight-gradient reductions, "frags" = K2's
    weights laid out in fragment order, K3, K4, the row gather), cuBLAS products,
    copies, other PyTorch kernels.  The union of the intervals is
    the device's busy time; against the untraced time ``wall_ms`` it gives
    the device's idle share.  Where ``run`` replays programs of
    ``graphs_list``, the kernel nodes of what it replayed that the trace
    holds no record of are logged by name (the profiler's lost records;
    the launch checks count the nodes, :func:`replays`).  -> busy ms."""
    if graphs_list is None:
        _, events = profiled(torch, run)
    else:
        (_, nodes), events = profiled(torch, lambda: replays(graphs_list, run))
        lost = collections.Counter(nodes) - collections.Counter(kernel_name(e.name)
                                                                 for e in events)
        lost.pop("?", None)
        if lost:
            log(f"profiler: {what}: no record of {sum(lost.values())} of the {len(nodes)} kernel"
                f" nodes replayed ({', '.join(f'{k} x{v}' for k, v in sorted(lost.items()))})")
    kinds = {"K1": 0.0, "K2": 0.0, "frags": 0.0, "K3": 0.0, "K4": 0.0, "gather": 0.0,
             "cuBLAS": 0.0, "copies": 0.0, "other": 0.0}
    for e in events:
        kind = ("K4" if "knn_split_kernel" in e.name
                else "gather" if "gather_rows_kernel" in e.name
                else "frags" if "weight_frags_kernel" in e.name
                else "K1" if any(s in e.name for s in K1_KERNELS)
                else "K2" if "bwd_rows_kernel" in e.name or "wgrad" in e.name
                else "K3" if any(s in e.name for s in K3_KERNELS)
                else "cuBLAS" if "gemm" in e.name
                else "copies" if "Memcpy" in e.name or "Memset" in e.name
                else "other")
        kinds[kind] += e.time_range.elapsed_us() / 1e3
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in events]) / 1e3
    log(f"trace: {what}, {len(events)} device activities, busy {busy:.2f} ms"
        f" ({', '.join(f'{k} {v:.2f}' for k, v in kinds.items())} ms); against the"
        f" {wall_ms:.2f} ms untraced the device idles {100 * (1 - busy / wall_ms):.1f}%")
    return busy


# ---------------------------------------------------------------- phase 3b

TRAIN_STEPS = 4
# per train step: (K1, K2, K3, K4, gather) launches.  A shipped net runs its
# begin block, 2 set abstraction rounds x 2 levels, 2 transformer_downs and
# its decoder; a pointnet++ net FPS + K4 + gather at 2 levels and (crossatten)
# its decoder.  Runs: (label, model type, configuration (None: shipped)).
TRAIN_LAUNCHES = {"forward": (8, 8, 2, 0, 0), "backward": (8, 8, 2, 0, 0),
                  "arbitrary": (17, 17, 4, 0, 0), "A": (3, 3, 4, 4, 4), "B": (0, 0, 2, 2, 2)}
SHIPPED_RUNS = [("forward", "forward", None), ("backward", "backward", None),
                ("arbitrary", "arbitrary", None)]
ABLATION_RUNS = [("A", "arbitrary", "A"), ("B", "forward", "B")]


def train_batch(rng, B, N, Q, near_surface=False):
    """A batch shaped like ``__graft_entry__._example_batch``: source and
    target surfaces, a handle mask, space samples and their targets.
    ``near_surface`` draws the space samples within ~0.1 of source surface
    points instead of anywhere (the interpolation decoder's weights
    underflow beyond ~2 from every anchor)."""
    surf_src = rng.randn(B, N, 3).astype(np.float32)
    surf_tgt = rng.randn(B, N, 3).astype(np.float32)
    mask = (rng.rand(B, N, 1) > 0.5).astype(np.float32)
    if near_surface:
        pick = rng.randint(0, N, (B, Q))
        space = surf_src[np.arange(B)[:, None], pick] + 0.1 * rng.randn(B, Q, 3)
    else:
        space = rng.randn(B, Q, 3)
    return {
        "surface_samples_inputs": np.concatenate([surf_src, surf_tgt * mask, mask], -1),
        "space_samples_src": space.astype(np.float32),
        "space_samples_tgt": rng.randn(B, Q, 3).astype(np.float32),
    }


def train_setup(torch, model_type, seed, device="cuda", cfg=None, group=None, out_scale=1.0,
                dtype=None, graphs=None, nan_guard=False):
    """(config, model, schedule, optimizer, steps) of a shipped config or of
    ``cfg``, with seeded random weights (``init_random``'s ``out_scale``;
    the model in ``dtype``; steps over ``group``'s ranks; ``make_steps``'
    ``graphs`` and ``nan_guard``)."""
    from nsdp_tpu_torch.models import build_model, init_random
    from nsdp_tpu_torch.training import make_steps, optimizer_factory
    from nsdp_tpu_torch.utils.config import load_config

    if cfg is None:
        cfg = load_config(os.path.join(REPO, "configs", "deform4d", f"{model_type}.yaml"))
    model = init_random(build_model(cfg, device=device), seed, out_scale=out_scale)
    if dtype is not None:
        model = model.to(dtype)
    schedule, opt = optimizer_factory(cfg["training"], model.parameters())
    steps = make_steps(model, model_type, opt, device=device, group=group, graphs=graphs,
                       nan_guard=nan_guard)
    return cfg, model, schedule, opt, steps


def check_resume(torch, rng, model, opt, steps, B, lr, cfg):
    """A checkpoint saved and loaded into a fresh model gives the same
    next loss."""
    import tempfile

    from nsdp_tpu_torch.training import load_checkpoints, save_checkpoints

    with tempfile.TemporaryDirectory() as d:
        save_checkpoints(TRAIN_STEPS, model, opt, d)
        _, model2, _, opt2, steps2 = train_setup(torch, "arbitrary", seed=1, cfg=cfg)
        if load_checkpoints(model2, opt2, d) != TRAIN_STEPS + 1:
            fail("resume did not find the saved epoch")
    for (k, v), v2 in zip(model.state_dict().items(), model2.state_dict().values()):
        if not torch.equal(v, v2):
            fail(f"resume: {k} differs from the saved model")
    nxt = train_batch(rng, B, 5000, 5000)
    l1, l2 = steps["train_step"](nxt, lr), steps2["train_step"](nxt, lr)
    if abs(l1 - l2) > 1e-6 * abs(l1):
        fail(f"resume: the next step's loss {l2} differs from {l1}")
    log(f"train: checkpoint saved and resumed; next stage-2 loss {l1:.6g} (a replay) and"
        f" {l2:.6g} (the resumed model's first, eager step)")


def train(torch, rng, runs):
    """Full-width training steps on the card (phases 3b, 3d and 8a),
    captured (``make_steps``' default on the card) -> per-run stats and the
    device launches of the phase's replays.  A run is (label, model type,
    configuration: None for the shipped one, an ablation's name or a config
    dict); its launches are those of the label's first word.  Each run: the
    eager first step (the wrappers count its launches), the capture step
    (they count the launches it records, and it replays once), 4 timed
    replays (the wrappers count nothing); the kernel nodes of its graph must be the eager step's launches, and a
    replayed step holds against two eager twins from its state
    (:func:`hold_replayed_step`); one replay traced.  The shipped stage-2
    run is resumed from a checkpoint."""
    stats = {}
    device = np.zeros(5, int)
    reset_counts()  # ---- the main path of training
    for label, model_type, ablation in runs:
        want = TRAIN_LAUNCHES[label.split()[0]]
        cfg = ablation_config(ablation) if isinstance(ablation, str) else ablation
        cfg, model, schedule, opt, steps = train_setup(torch, model_type, seed=0, cfg=cfg)
        B = cfg["training"]["batch_size"]
        lr = schedule.get_learning_rate(0)
        near = cfg["model"]["decoder"] == "interp"
        batches = [train_batch(rng, B, 5000, 5000, near) for _ in range(TRAIN_STEPS + 2)]
        before_params = [p.detach().clone() for p in model.parameters()]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        before = counts()
        steps["train_step"](batches[0], lr)  # the eager first step: cuBLAS, allocator, kernels
        torch.cuda.synchronize()
        warm_ms = (time.perf_counter() - t0) * 1e3
        expect_launches(before, want, f"{label} first (eager) train step")
        before = counts()
        t0 = time.perf_counter()
        steps["train_step"](batches[-1], lr)  # the capture, replayed once
        torch.cuda.synchronize()
        capture_ms = (time.perf_counter() - t0) * 1e3
        expect_launches(before, want, f"{label} capture step (the launches it records)")
        step_ms, losses = [], []
        before = counts()
        for batch in batches[1:TRAIN_STEPS + 1]:
            t0 = time.perf_counter()
            losses.append(steps["train_step"](batch, lr))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        expect_launches(before, (0,) * 5, f"{label} replayed train steps (the wrappers)")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if not np.isfinite(losses).all():
            fail(f"{label}: non-finite training loss {losses}")
        moved = max(float((p.detach() - q).abs().max())
                    for p, q in zip(model.parameters(), before_params))
        if not moved > 0:
            fail(f"{label}: the parameters did not move")
        if any(p.dtype != torch.float32 for p in model.parameters()):
            fail(f"{label}: a parameter is no longer float32")
        med = float(np.median(step_ms))
        stats[label] = dict(B=B, step_ms=med, peak_gb=peak_gb, losses=losses)
        log(f"train {label:<9} B={B:<3} step {med:.2f} ms (captured, median of {TRAIN_STEPS},"
            f" {min(step_ms):.2f}-{max(step_ms):.2f}; eager first step {warm_ms:.1f}, capture"
            f" step {capture_ms:.1f}), peak memory {peak_gb:.2f} GB, losses"
            f" {', '.join(f'{x:.4g}' for x in losses)}, largest parameter move {moved:.3g}")
        graphs = steps["train_step"].graphs
        (program,) = step_programs(graphs)
        got = replay_launches(graphs, program)
        expect_replay(got, want, f"{label} replayed train step")
        device += got
        twins = [train_setup(torch, model_type, 0, cfg=cfg, graphs=False) for _ in range(2)]
        (reordered, worst), _ = hold_replayed_step(
            torch, f"{label} replayed train step", model, opt, steps["train_step"], twins,
            batches[1], lr)
        log(f"train {label}: a replayed step against two eager twins loaded with its state:"
            f" the loss and every BatchNorm buffer bit for bit, {reordered} gradients and"
            f" parameters not bit for bit (K2's float64 atomics) within phase 4b's rule, largest"
            f" ratio {worst:.3g}")
        del twins
        trace(torch, lambda: steps["train_step"](batches[-1], lr), med,
              f"one {label} train step (B={B}, captured)", [graphs])
        if label == "arbitrary":
            check_resume(torch, rng, model, opt, steps, B, lr, cfg)
        del model, opt, steps, before_params
        torch.cuda.empty_cache()
    if counts() == (0,) * 5:
        fail("training: no wrapper was called")
    launches = tuple(int(x) for x in device)  # ---- end of the main path of training
    return stats, launches


# ---------------------------------------------------------------- phase 4


def rel_err(a, ref) -> float:
    """Relative L2 error ``||a - ref|| / ||ref||``, in float64."""
    a, ref = a.double(), ref.double()
    return float((a - ref).norm() / ref.norm())


def tiny_config(encoder):
    """An 'arbitrary' model at a tiny width, with either encoder."""
    if encoder == "pointransformer":
        enc = dict(npoints_per_layer=[32, 16, 8], nneighbor=6, nneighbor_reduced=4,
                   nfinal_transformers=1, d_transformer=16, d_reduced=12, full_SA=True)
    else:
        enc = dict(npoints_per_layer=[32, 16, 8], nneighbor=6, nfinal_transformers=1,
                   d_transformer=16)
    return {"model": {
        "type": "arbitrary", "use_normals": False, "encoder": encoder, "encoder_kwargs": enc,
        "decoder": "crossatten",
        "decoder_kwargs": dict(dim_inp=16, dim=10, nneigh=5, hidden_dim=8, out_dim=3),
    }}


def hold_against_cpu(torch, what, card, f32, f64):
    """Serving's rule (``PERF.md`` section 2) for one output of the card
    against the plain path on the CPU in float32 and float64, all on the
    host: within ``E2E_TOL`` of float32 or, where the float32 path itself
    errs beyond that against float64, a largest absolute error against
    float64 at most twice float32's; and a relative L2 error against
    float64 at most twice float32's."""
    err, floor = rel_err(card, f64), rel_err(f32, f64)
    worst, worst_f32 = [float((x.double() - f64).abs().max()) for x in (card, f32)]
    log(f"reference {what}: max |output| {float(f64.abs().max()):.4g};"
        f" card vs CPU float32 max abs err {float((card - f32).abs().max()):.3g};"
        f" max abs err against float64: card {worst:.3g}, CPU float32 {worst_f32:.3g};"
        f" relative L2 error against float64: card {err:.3g}, CPU float32 {floor:.3g}")
    # where the float32 path itself errs beyond E2E_TOL against float64
    # (random weights amplify rounding by the output's scale), the card may
    # instead err at most twice as much
    if not torch.allclose(card, f32, **E2E_TOL) and worst > 2 * worst_f32:
        fail(f"{what}: card vs CPU max abs err {float((card - f32).abs().max())}, against"
             f" float64 {worst:.3g}, more than twice the CPU float32 path's {worst_f32:.3g}")
    if err > max(2 * floor, 1e-6):
        fail(f"{what}: the card's relative error {err:.3g} against float64 is more than twice"
             f" the CPU float32 path's {floor:.3g}")


def check_reference(torch, svc, rng, surf, label):
    """The card against the plain path on the CPU (same weights).  Halves
    are compared on identical inputs, so every FPS and kNN selection sees
    the same coordinates on both sides.

    With random weights the BatchNorm statistics do not match the
    activations, and the outputs are O(100): the elementwise tolerance
    then admits errors of ~0.1.  So each half is also held, by relative L2
    error, against the plain path in float64: the card must come as close
    to it as the CPU's own float32 path does, within a factor of 2."""
    from nsdp_tpu_torch.models import build_model, init_random

    state = {k: v.cpu() for k, v in svc.model.state_dict().items()}
    cpu = build_model(svc.config, device="cpu")
    cpu.load_state_dict(state)
    cpu64 = build_model(svc.config, device="cpu").double()
    cpu64.load_state_dict(state)
    pts = rng.uniform(-1.3, 1.3, (1, 1024, 3)).astype(np.float32)
    handle = (surf[:, 2] > 0.8).astype(np.float32)[None, :, None]
    tgt = (surf[None] + 0.2) * handle
    g = lambda a: torch.as_tensor(a, device="cuda")
    c = lambda a: torch.as_tensor(a)
    c64 = lambda a: torch.as_tensor(a).double()
    with torch.inference_mode():
        sc_g, su_g = svc.model.canonicalize(g(pts), g(surf[None]))
        sc_c, su_c = cpu.canonicalize(c(pts), c(surf[None]))
        sc_d, su_d = cpu64.canonicalize(c64(pts), c64(surf[None]))
        sc, su = sc_g.cpu(), su_g.cpu()
        out_g = svc.model.deform(sc_g, su_g, g(tgt), g(handle)).cpu()
        out_c = cpu.deform(sc, su, c(tgt), c(handle))
        out_d = cpu64.deform(sc.double(), su.double(), c64(tgt), c64(handle))
        for what, card, f32, f64 in (("space_cano", sc, sc_c, sc_d),
                                     ("surf_cano", su, su_c, su_d),
                                     ("deform", out_g, out_c, out_d)):
            hold_against_cpu(torch, f"{label}: full width {what}", card, f32, f64)

        tiny = tiny_config(svc.config["model"]["encoder"])
        small_g = init_random(build_model(tiny, device="cuda"), 1)
        small_c = init_random(build_model(tiny, device="cpu"), 1)
        inp = np.concatenate([surface(rng, 32), rng.randn(32, 4)], -1).astype(np.float32)[None]
        q = rng.randn(1, 50, 3).astype(np.float32)
        a, b = small_g.predict(g(q), g(inp)).cpu(), small_c.predict(c(q), c(inp))
        if not torch.allclose(a, b, **E2E_TOL):
            fail(f"{label} tiny predict: card vs CPU max abs err {float((a - b).abs().max())}")
    log(f"reference {label}: tiny predict: max |output| {float(b.abs().max()):.4g}; card vs CPU"
        f" max abs err {float((a - b).abs().max()):.3g}, relative L2 error {rel_err(a, b):.3g}")


# ---------------------------------------------------------------- phase 4b


def stage2_step_by_halves(torch, model, batch, device, dtype, cano=None, cot=None):
    """One stage-2 train step's gradients and running statistics, computed
    as the train step does but cut at the canonical pose
    (``FlowArbitrary.canonicalize`` / ``deform``): the deform half runs on
    the canonicalised points ``cano`` and the canonicalize half's backward
    is seeded with the cotangents ``cot`` -- both the card's, given to the
    CPU paths, so every FPS and kNN selection sees the same coordinates on
    every path.  -> (loss, its own canonicalised points, the gradients at
    the canonicalised points the deform half took)."""
    from nsdp_tpu_torch.training.steps import (
        _batch_norms, _double_bn_update, _snapshot, compute_l2_error)

    t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    inputs = t(batch["surface_samples_inputs"])
    model.train()
    model.zero_grad(set_to_none=True)
    bns = _batch_norms(model.model_canonicalize.encoder)
    saved = _snapshot(bns)
    space_cano, surf_cano = model.canonicalize(t(batch["space_samples_src"]), inputs[..., 0:3])
    own = (space_cano.detach(), surf_cano.detach())
    sc, su = [t(c).detach().requires_grad_() for c in (cano or own)]
    pred = model.deform(sc, su, inputs[..., 3:6], inputs[..., 6:7])
    loss = compute_l2_error(pred, t(batch["space_samples_tgt"]))
    loss.backward()
    grads = (sc.grad, su.grad)
    torch.autograd.backward([space_cano, surf_cano], [t(c) for c in (cot or grads)])
    _double_bn_update(bns, saved)  # the compound EMA of the stage-2 step
    return float(loss.detach()), own, grads


def check_training_reference(torch, label, cfg=None, batch_seed=7):
    """One full-width stage-2 train step of the shipped model (or of
    ``cfg``) on the card against the CPU plain path in float32 and float64,
    from the same weights on the same batch, by halves
    (:func:`stage2_step_by_halves`): the loss, the gradients of the
    canonicalised points (what carries the loss into
    ``model_canonicalize``), every parameter's gradient and every running
    statistic after the step."""
    from nsdp_tpu_torch.models import build_model

    cfg, card, _, _, _ = train_setup(torch, "arbitrary", seed=2, cfg=cfg)
    state = {k: v.cpu() for k, v in card.state_dict().items()}
    models = {"card": card}
    for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        models[name] = build_model(cfg, device="cpu").to(dtype)
        models[name].load_state_dict(state)
    # A float32 gradient is discontinuous where a ReLU input or a max-pool
    # candidate sits within rounding of a tie: there the card, the CPU and
    # float64 may each land on another side, and the rule below fails for
    # that reason alone.  The batch seeds given (7 for the shipped model, 19
    # for configuration A) meet no such near-tie on any path; at other seeds
    # single gradients of A err by ~1e-3 (PERF.md, section 6).
    batch = train_batch(np.random.RandomState(batch_seed), 1, 5000, 1024)
    loss, cano, cot = stage2_step_by_halves(torch, card, batch, "cuda", torch.float32)
    cano, cot = [c.cpu() for c in cano], [c.cpu() for c in cot]
    losses, grads = {"card": loss}, {"card": cot}
    for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        losses[name], _, grads[name] = stage2_step_by_halves(
            torch, models[name], batch, "cpu", dtype, cano, cot)
    if abs(losses["card"] - losses["f32"]) > 1e-4 * abs(losses["f32"]):
        fail(f"{label} stage-2 step: card loss {losses['card']} vs CPU float32 {losses['f32']}")
    # Every layer of the step rounds differently on the card (K1, K2,
    # cuBLAS) and on the CPU, so the ratio of two float32 errors spreads
    # wider than at one kernel's inputs (phase 2b), and the ~10^7 ReLU inputs
    # of a step hold a few within rounding of zero, where the gradient jumps:
    # one path may land on the other side (5e-5 relative on a single
    # gradient in this script's runs).  A wrong gradient errs by 1e-2 or more.
    rule = dict(factor=4.0, floor=1e-4)
    for i, what in enumerate(("space_cano", "surf_cano")):
        check_gradient(f"{label} stage-2 step, d {what}", grads["card"][i], grads["f32"][i],
                       grads["f64"][i], **rule)
    params = {name: dict(m.named_parameters()) for name, m in models.items()}
    buffers = {name: dict(m.named_buffers()) for name, m in models.items()}
    worst, n_zero = (0.0, ""), 0
    for key, p in params["card"].items():
        weight = params["f64"].get(key[:-4] + "weight") if key.endswith(".bias") else None
        ratio = check_gradient(f"{label} stage-2 step, d {key}", p.grad.cpu(),
                               params["f32"][key].grad,
                               params["f64"][key].grad, None if weight is None else weight.grad,
                               **rule)
        n_zero += ratio is None
        worst = max(worst, (ratio or 0.0, key))
    n_stats = 0
    for key, b in buffers["card"].items():
        if key.endswith(("running_mean", "running_var")):
            n_stats += 1
            check_gradient(f"{label} stage-2 step, {key}", b.cpu(), buffers["f32"][key],
                           buffers["f64"][key], **rule)
    log(f"reference {label}: full-width stage-2 step (B=1, N=5000, Q=1024): loss card"
        f" {losses['card']:.7g},"
        f" CPU float32 {losses['f32']:.7g}, float64 {losses['f64']:.7g}; d space_cano and"
        f" d surf_cano, {len(params['card'])} parameter gradients ({n_zero} analytically zero,"
        f" held absolutely) and {n_stats} running statistics within the rule; largest ratio of"
        f" the card's error to the CPU float32 path's {worst[0]:.3g} ({worst[1]})")


# ---------------------------------------------------------------- phase 5

# launches (K1, K2, K3, K4, gather) per pair of the test and run entry points:
# two full evaluations (the surface samples, then the padded vertices)
PAIR_LAUNCHES = (34, 0, 8, 0, 0)
MESHES = {40962: 6, 10242: 5}  # vertices of an icosphere -> its subdivisions
REFERENCE_ROWS = 2048  # query rows of each set held against the CPU


def large_k1_sites():
    """K1 as an encoder conditioned on every vertex of a 40,962-vertex mesh
    runs it (``run`` on a user-handle config): the begin blocks at N = M,
    pos-only and featured, and the first set abstraction from 500 FPS
    centres.  Off phase 3's path, so 0 launches per evaluation there."""
    n = 40962
    return [
        (f"bwd_encoder_begin_{n}", 0, n, n, 10, 120, "pos_only", False),
        (f"fwd_encoder_begin_{n}", 0, n, n, 10, 120, "featured", False),
        (f"set_abstraction_0_{n}", 0, 500, n, 16, 120, "featured", False),
    ]


def write_config(cfg, path):
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def seeded_weight_file(torch, cfg, directory):
    """A model file of ``training/checkpoints.py`` with seeded weights whose
    deformed positions are O(1) (``init_random``'s ``out_scale``, as a
    trained model's: the metrics' KD-tree search slows ~40-fold on O(100)
    predictions) -> (its path, the model on the card)."""
    from nsdp_tpu_torch.models import build_model, init_random
    from nsdp_tpu_torch.training import optimizer_factory, save_checkpoints

    model = init_random(build_model(cfg, device="cuda"), 0, out_scale=0.01)
    _, opt = optimizer_factory(cfg["training"], model.parameters())
    save_checkpoints(0, model, opt, directory)
    return os.path.join(directory, "model_00000"), model


def msgpack_bytes(obj) -> bytes:
    """msgpack of maps with string keys, lists, ints, bytes and numpy
    arrays, these as flax's ndarray extension (type 1: the msgpack of
    ``(shape, dtype name, C-order bytes)``) -- the layout of the JAX
    package's model files, written here without ``msgpack`` or ``flax``."""
    import struct

    if isinstance(obj, dict):
        head = b"\xdf" + struct.pack(">I", len(obj))
        return head + b"".join(msgpack_bytes(k) + msgpack_bytes(v) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return b"\xdd" + struct.pack(">I", len(obj)) + b"".join(map(msgpack_bytes, obj))
    if isinstance(obj, str):
        return b"\xdb" + struct.pack(">I", len(obj.encode())) + obj.encode()
    if isinstance(obj, int):
        return b"\xd3" + struct.pack(">q", obj)
    if isinstance(obj, bytes):
        return b"\xc6" + struct.pack(">I", len(obj)) + obj
    payload = msgpack_bytes([list(obj.shape), obj.dtype.name, np.ascontiguousarray(obj).tobytes()])
    return b"\xc9" + struct.pack(">Ib", len(payload), 1) + payload


def flax_variables(state, bns=None):
    """A ``state_dict`` (or a map of parameter names to tensors, then with
    ``bns``, the names of its BatchNorm modules) as the JAX package's
    variables, ``{"params", "batch_stats"}`` of numpy arrays under the JAX
    module names -- the inverse of ``utils/convert.py::from_jax_variables``'
    key rules."""
    from nsdp_tpu_torch.utils.convert import _MODULE_LISTS, _SEQ_INDEX, _SEQ_MLPS

    seq = {v: k for k, v in _SEQ_INDEX.items()}
    if bns is None:
        bns = {k.rsplit(".", 1)[0] for k in state if k.endswith(".running_mean")}
    leaves = {"weight": "scale", "bias": "bias", "running_mean": "mean", "running_var": "var"}
    tree = {"params": {}, "batch_stats": {}}
    for key, value in state.items():
        *mods, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        names = []
        for i, tok in enumerate(mods):
            if tok.isdigit() and mods[i - 1] in _MODULE_LISTS:
                names[-1] = f"{names[-1]}_{tok}"
            elif tok in seq and mods[i - 1] in _SEQ_MLPS:
                names.append(seq[tok])
            else:
                names.append(tok)
        value = value.detach().cpu().numpy()
        if ".".join(mods) in bns:
            col = "batch_stats" if leaf.startswith("running") else "params"
            names += ["bn", leaves[leaf]]
        else:
            col = "params"
            names.append("kernel" if leaf == "weight" else "bias")
            value = value.T if leaf == "weight" else value
        node = tree[col]
        for tok in names[:-1]:
            node = node.setdefault(tok, {})
        node[names[-1]] = value
    return tree


def write_flax_model_file(state, path):
    """A model's ``state_dict`` as the JAX package's model file: flax
    msgpack of ``{"params", "batch_stats"}`` (:func:`flax_variables`)."""
    with open(path, "wb") as f:
        f.write(msgpack_bytes(flax_variables(state)))
    return path


def write_flax_opt_file(opt_state, names, bns, training, path):
    """A torch Adam ``state_dict`` as the JAX package's optimizer file: flax
    msgpack of ``{"opt_state", "step"}`` with the optax chain of
    ``nsdp_tpu/training/optim.py::optimizer_factory`` for ``training`` (an
    empty map for a ``clip`` and an ``add_decayed_weights`` stage, then
    ``{"count", "mu", "nu"}`` on the params tree).  ``names`` are the
    parameter names in the optimizer's order, ``bns`` the BatchNorm
    modules."""
    state = opt_state["state"]
    steps = {float(s["step"]) for s in state.values()}
    if len(steps) != 1 or len(state) != len(names):
        fail(f"the optimizer state holds {len(state)} of {len(names)} parameters, steps {steps}")
    count = np.asarray(int(steps.pop()), np.int32)
    moments = {key: flax_variables({n: state[i][field] for i, n in enumerate(names)},
                                   bns)["params"]
               for key, field in (("mu", "exp_avg"), ("nu", "exp_avg_sq"))}
    stages = [{} for key in ("clip_grad", "weight_decay") if training.get(key)]
    stages.append({"count": count, **moments})
    tree = {"opt_state": {str(i): st for i, st in enumerate(stages)}, "step": count}
    with open(path, "wb") as f:
        f.write(msgpack_bytes(tree))
    return path


def first_pair(cfg):
    """The first pair of ``cfg``'s test split as a batch of 1, the global
    ``np.random`` seeded."""
    from nsdp_tpu_torch.data import dataset_dict

    np.random.seed(0)
    t = cfg["test"]
    ds = dataset_dict[cfg["data"]["type"]](cfg, t["iden_split"], t["motion_split"],
                                           load_mesh=True, num_sampled_pairs=t["num_sampled_pairs"])
    return ds.collate_fn([ds[0]])


def check_pair_reference(torch, model, cfg, batch, label):
    """One pair's predictions as ``test_on_batch`` makes them on the card
    (the surface samples; the vertices padded to the 4096 bucket) against
    the plain path on the CPU in float32 and float64, by
    :func:`hold_against_cpu`.  Cut at the canonical pose as phase 4 cuts:
    the card's halves must give test_on_batch's bits, and the CPU's deform
    half takes the card's canonicalised points, so every selection sees
    the same coordinates.  Queries are independent of each other, so each
    set is held on every k-th row (``REFERENCE_ROWS`` at most)."""
    from nsdp_tpu_torch.models import build_model
    from nsdp_tpu_torch.training import optimizer_factory
    from nsdp_tpu_torch.training.steps import make_steps, test_on_batch
    from nsdp_tpu_torch.utils.padding import pad_queries

    inputs = batch["surface_samples_inputs"]
    sets = {"surface_samples_tgt_pred": inputs[..., 0:3], "verts_tgt_pred": batch["verts_src"]}
    _, opt = optimizer_factory({}, model.parameters())
    _, pred = test_on_batch(make_steps(model, "arbitrary", opt, device="cuda"), dict(batch),
                            compute_loss=False)
    g = lambda a: torch.as_tensor(np.asarray(a, np.float32), device="cuda")
    card, picks = [], []
    with torch.inference_mode():
        t_in = g(inputs)  # sliced as FlowArbitrary.predict slices it
        for key, pts in sets.items():
            q = pts.shape[1]
            sc, su = model.canonicalize(g(pad_queries(pts, 4096)[0] if key == "verts_tgt_pred"
                                          else pts), t_in[..., 0:3])
            out = model.deform(sc, su, t_in[..., 3:6], t_in[..., 6:7])
            if not np.array_equal(out[:, :q].cpu().numpy(), pred[key]):
                fail(f"{label}: the card's halves differ from test_on_batch's {key}")
            rows = np.arange(0, q, -(-q // REFERENCE_ROWS))
            picks.append(pts[:, rows])
            card.append((sc[:, rows].cpu(), su.cpu(), out[:, rows].cpu()))
    if not torch.equal(card[0][1], card[1][1]):
        fail(f"{label}: the canonicalised surface differs between the two evaluations")
    card = [torch.cat([card[0][0], card[1][0]], 1), card[0][1],
            torch.cat([card[0][2], card[1][2]], 1)]
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    queries = np.concatenate(picks, axis=1)
    cpu = {}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.float64):
            m = build_model(cfg, device="cpu").to(dtype)
            m.load_state_dict(state)
            c = lambda a: torch.as_tensor(np.asarray(a)).to(dtype)
            sc, su = m.canonicalize(c(queries), c(inputs[..., 0:3]))
            out = m.deform(card[0].to(dtype), card[1].to(dtype), c(inputs[..., 3:6]),
                           c(inputs[..., 6:7]))
            cpu[dtype] = (sc, su, out)
    log(f"reference {label}: {picks[0].shape[1]} of {inputs.shape[1]} surface-sample and"
        f" {picks[1].shape[1]} of {batch['verts_src'].shape[1]} vertex predictions, conditioned on"
        f" {inputs.shape[1]} points; the card's halves give test_on_batch's bits")
    for i, what in enumerate(("space_cano", "surf_cano", "deform")):
        hold_against_cpu(torch, f"{label}: {what}", card[i], cpu[torch.float32][i],
                         cpu[torch.float64][i])


def read_outputs(directory, shape, count, what):
    """The ``count`` deformed meshes or point clouds an entry point wrote
    under ``directory``: finite, of ``shape``."""
    from nsdp_tpu_torch.utils import meshio

    names = sorted(os.listdir(os.path.join(directory, "deformed")))
    if len(names) != count:
        fail(f"{what}: {len(names)} deformed files in {directory}, expected {count}")
    for name in names:
        check_output(meshio.load_mesh(os.path.join(directory, "deformed", name))[0], shape,
                     f"{what} {name}")


def report_entry(what, times, wall, card):
    n = len(times["writers"])
    split = ", ".join(f"{k} {sum(v) / n:.3f} s" for k, v in times.items())
    by_batch = ", ".join(f"{t * 1e3:.1f}" for t in times["test_on_batch"])
    log(f"entry points: {what}: {n} pair(s) in {wall:.2f} s; per pair {split}; test_on_batch"
        f" by batch {by_batch} ms ({card})")


def jax_file_test(torch, port_test, cfg, model, root, argv, data_stream, out):
    """``test`` once more, on the same weights in the JAX package's model
    file layout (``write_flax_model_file``), from the same data stream: its
    meshes and point clouds byte for byte those of the torch-format run
    written to ``out``."""
    from nsdp_tpu_torch.training import read_state_dict

    jax_file = write_flax_model_file(model.state_dict(), os.path.join(root, "jax_model_00000"))
    read = read_state_dict(jax_file)
    for key, value in model.state_dict().items():
        if not torch.equal(read[key], value.cpu()):
            fail(f"the JAX-layout model file reads {key} back otherwise")
    cfg = dict(cfg, test=dict(cfg["test"], weight_file=jax_file),
               experiment=dict(cfg["experiment"], out_dir=os.path.join(root, "test_jax_file")))
    np.random.set_state(data_stream)
    port_test.main([write_config(cfg, os.path.join(root, "test_jax_file.yaml")), *argv])
    other = os.path.join(cfg["experiment"]["out_dir"], cfg["experiment"]["name"],
                         cfg["test"]["motion_split"])
    compared = same_files(out, other, "test from the JAX-layout model file")
    log(f"entry points: test from the same weights in the JAX package's model file layout wrote"
        f" its {compared} meshes and point clouds byte for byte")


def test_programs(steps, pairs, what) -> str:
    """The evaluation programs of ``test`` / ``run`` after ``pairs`` pairs
    of one shape: predict's two signatures a pair, each eager at its first
    pair, captured at its second (each replay launching a full evaluation,
    ``EVAL_LAUNCHES``) -> their description."""
    graphs = steps["predict"].graphs
    if graphs is None:
        fail(f"{what}: predict is not captured on the card")
    got = graphs.summary()
    want = {"captured": 2 if pairs > 1 else 0, "eager": 0 if pairs > 1 else 2,
            "replays": 2 * (pairs - 1)}
    if got != want:
        fail(f"{what}: predict's programs {got}, expected {want}")
    for program in graphs.programs.values():
        if program.graph is not None:
            expect_replay(replay_launches(graphs, program), EVAL_LAUNCHES["predict"],
                          f"{what}: a replayed evaluation")
    return graphs.describe()


ENTRY_TURNS = ("eager", "captured", "captured", "eager", "eager", "captured")


def entry_turns(torch, port_test, port_run, make_steps, cfg, uh, root, argv, data_stream, out,
                card):
    """``test`` (its pairs from the same data stream) and ``run`` (on the
    40,962-vertex mesh), each run anew in turns with its evaluations
    captured (``make_steps``' default) and eager (``graphs=False``),
    :data:`ENTRY_TURNS`, 3 of each: every ``test`` turn's meshes and point
    clouds byte for byte the main path's run's written to ``out``; the
    wall time per pair of each turn, each mode's median, and each stage's
    mean per pair by mode."""
    walls = {"test": collections.defaultdict(list), "run": collections.defaultdict(list)}
    stages = {"test": collections.defaultdict(list), "run": collections.defaultdict(list)}
    compared = 0
    try:
        for i, mode in enumerate(ENTRY_TURNS):
            graphs = None if mode == "captured" else False
            port_test.make_steps = lambda *a, **k: make_steps(*a, **k, graphs=graphs)
            turn_cfg = dict(cfg, experiment=dict(cfg["experiment"],
                                                 out_dir=os.path.join(root, f"test_turn{i}")))
            np.random.set_state(data_stream)
            times = port_test.main([write_config(turn_cfg, os.path.join(root, f"test_turn{i}.yaml")),
                                    *argv])
            other = os.path.join(turn_cfg["experiment"]["out_dir"], cfg["experiment"]["name"],
                                 cfg["test"]["motion_split"])
            compared = same_files(out, other, f"test, turn {i} ({mode})")
            uh_turn = dict(uh, experiment=dict(uh["experiment"],
                                               out_dir=os.path.join(root, f"run_turn{i}")))
            times_run = port_run.main([write_config(uh_turn, os.path.join(root, f"run_turn{i}.yaml")),
                                       *argv])
            for what, t in (("test", times), ("run", times_run)):
                pairs = len(t["writers"])
                walls[what][mode].append(sum(map(sum, t.values())) / pairs)
                for k, v in t.items():
                    stages[what][mode].append((k, sum(v) / pairs))
    finally:
        port_test.make_steps = make_steps
    rows = []
    for what in ("test", "run"):
        by_stage = {}
        for mode in ("captured", "eager"):
            for k, v in stages[what][mode]:
                by_stage.setdefault(k, {}).setdefault(mode, []).append(v)
        split = ", ".join(f"{k} {np.mean(v['captured']):.3f} / {np.mean(v['eager']):.3f}"
                          for k, v in by_stage.items())
        turns_s = ", ".join(f"{mode} {walls[what][mode][ENTRY_TURNS[:i + 1].count(mode) - 1]:.3f}"
                            for i, mode in enumerate(ENTRY_TURNS))
        med = {m: float(np.median(walls[what][m])) for m in ("captured", "eager")}
        rows.append(f"{what}: a pair in turns {turns_s} s; medians captured {med['captured']:.3f}"
                    f" / eager {med['eager']:.3f} s ({100 * (med['captured'] / med['eager'] - 1):+.1f}%);"
                    f" by stage, mean per pair captured / eager: {split} s")
    log(f"entry points: test (its {compared} meshes and point clouds byte for byte the main"
        f" path's at every turn) and run on 40962 vertices, captured and eager in turns:"
        f" {'; '.join(rows)} ({card})")


def same_files(out, other, what) -> int:
    """The meshes and point clouds under ``out`` and ``other`` byte for byte
    equal -> how many were compared."""
    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, names in os.walk(root) for f in names)

    compared = 0
    for folder in ("meshes", "pointclouds"):
        names = files(os.path.join(out, folder))
        if not names or names != files(os.path.join(other, folder)):
            fail(f"{what} wrote other {folder}")
        for name in names:
            with open(os.path.join(out, folder, name), "rb") as a, \
                    open(os.path.join(other, folder, name), "rb") as b:
                if a.read() != b.read():
                    fail(f"{what}: {folder}/{name} differs")
            compared += 1
    return compared


def compare_nn_searches(searches, card):
    """The first ``test`` pair's two Chamfer searches (predicted samples
    against ground-truth ones and back), as ``utils/metrics.py`` made them,
    timed again by the native KD-tree and by scipy's, in turns (median of
    3), with the clouds' extents: where a search's time goes."""
    from scipy.spatial import KDTree

    from nsdp_tpu_torch.native import nearest_neighbor_distances

    if len(searches) != 2:
        fail(f"test's metrics made {len(searches)} nearest-neighbour searches, expected 2")
    rows = []
    for query, points in searches:
        native_s, scipy_s = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            nearest_neighbor_distances(query, points)
            native_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            KDTree(points).query(query)
            scipy_s.append(time.perf_counter() - t0)
        extent = lambda a: float(np.ptp(a, axis=0).max())
        rows.append(f"{len(query)} queries to {len(points)} points (extents {extent(query):.3g}"
                    f" and {extent(points):.3g}): native {1e3 * float(np.median(native_s)):.1f} ms,"
                    f" scipy {1e3 * float(np.median(scipy_s)):.1f} ms")
    log(f"entry points: the first pair's two Chamfer searches timed again in turns (medians of"
        f" 3): {'; '.join(rows)} ({card})")


def entry_points(torch, rows, card):
    """Phase 5: the test and run entry points on the card at full width
    (the launches of their main path checked), the card against the CPU on
    a pair of each, then K1 and K3 at M = 40,962 against their plain
    versions (their rows appended to ``rows``)."""
    import tempfile

    from nsdp_tpu_torch import native
    from nsdp_tpu_torch import run as port_run
    from nsdp_tpu_torch import test as port_test
    from nsdp_tpu_torch.utils import metrics as port_metrics
    from nsdp_tpu_torch.data.synthetic import (
        generate_synthetic_dataset,
        generate_userhandle_dataset,
    )
    from nsdp_tpu_torch.ops import fps
    from nsdp_tpu_torch.utils import meshio
    from nsdp_tpu_torch.utils.config import load_config
    from nsdp_tpu_torch.utils.generation import define_userhandle_folder_name

    t_phase = time.perf_counter()
    argv = ["--matmul_precision", "highest", "--num_threads", str(os.cpu_count())]
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        fx = generate_synthetic_dataset(
            os.path.join(root, "deform4d"), n_identities=1, n_motions_per_identity=1, n_frames=4,
            n_surface=5000, n_space=5000, subdivisions=6)
        meshes = {n: generate_userhandle_dataset(os.path.join(root, f"mesh{n}"), subdivisions=s)
                  for n, s in MESHES.items()}
        cfg = load_config(CONFIG)
        weight_file, model = seeded_weight_file(torch, cfg, root)
        log(f"entry points: fixtures (deform4d: 4 frames of a 40962-vertex mesh, 5000 surface and"
            f" space samples; TOSCA-style meshes of 40962 and 10242 vertices) and the weight file"
            f" written in {time.perf_counter() - t0:.1f} s")

        cfg["experiment"]["out_dir"] = os.path.join(root, "test")
        cfg["data"].update(dataset_dir=fx["dataset_dir"], split_dir=fx["split_dir"], interval=1)
        cfg["test"]["weight_file"] = weight_file
        path = write_config(cfg, os.path.join(root, "test.yaml"))
        data_stream = np.random.get_state()  # the datasets draw from np.random
        searches = []  # the first pair's two Chamfer searches, kept to time below
        real_nn = port_metrics._nn_dists

        def recording_nn(query, points):
            if len(searches) < 2:
                searches.append((np.array(query), np.array(points)))
            return real_nn(query, points)

        port_metrics._nn_dists = recording_nn
        made, real_make = [], port_test.make_steps
        port_test.make_steps = lambda *a, **k: made.append(real_make(*a, **k)) or made[-1]
        reset_counts()  # ---- the main path: test, then run on each mesh
        t0 = time.perf_counter()
        try:
            times = port_test.main([path, *argv])
        finally:
            port_metrics._nn_dists = real_nn
        wall = time.perf_counter() - t0
        pairs = len(times["writers"])
        # predict's two signatures a pair (the surface samples, the padded
        # vertices): the first pair eager, the second's capture counted by
        # the wrappers, each replay in its graph's kernel nodes
        expect_launches((0,) * 5, tuple(min(pairs, 2) * x for x in PAIR_LAUNCHES),
                        f"test, {pairs} pairs")
        programs = test_programs(made[-1], pairs, "test")
        out = os.path.join(cfg["experiment"]["out_dir"], cfg["experiment"]["name"],
                           cfg["test"]["motion_split"])
        read_outputs(os.path.join(out, "meshes"), (40962, 3), pairs, "test mesh")
        read_outputs(os.path.join(out, "pointclouds"), (5000, 3), pairs, "test point cloud")
        with open(out + ".txt") as f:
            if sum("loss:" in line for line in f) != pairs:
                fail(f"test: {out}.txt lacks its {pairs} progress lines")
        report_entry(f"test, deform4d arbitrary.yaml ({programs})", times, wall, card)
        log(f"entry points: test's metrics stage (l2 / fnc / cd; cd through the native float32"
            f" KD-tree, {native.library_path().name}) by pair"
            f" {', '.join(f'{t:.3f}' for t in times['metrics'])} s ({card})")
        compare_nn_searches(searches, card)

        uh = load_config(os.path.join(REPO, "configs", "tosca", "head.yaml"))
        uh["test"]["weight_file"] = weight_file
        for n in MESHES:
            uh["experiment"]["out_dir"] = os.path.join(root, f"run{n}")
            uh["data"].update(dataset_dir=meshes[n]["dataset_dir"], split_dir=meshes[n]["split_dir"])
            path = write_config(uh, os.path.join(root, f"run{n}.yaml"))
            f = fps.furthest_point_sample
            before, variants_before = counts(), (f.cluster_launches, f.global_launches)
            t0 = time.perf_counter()
            times = port_run.main([path, *argv])
            wall = time.perf_counter() - t0
            expect_launches(before, PAIR_LAUNCHES, f"run on {n} vertices")
            programs = test_programs(made[-1], 1, f"run on {n} vertices")
            n_cluster, n_global = (f.cluster_launches - variants_before[0],
                                   f.global_launches - variants_before[1])
            want = (4 if n > fps.SMEM_POINTS else 0, 0)  # 2 encoders x 2 evaluations
            if (n_cluster, n_global) != want:
                fail(f"run on {n} vertices: {n_cluster} launches of fps_cluster_kernel and"
                     f" {n_global} of fps_global_kernel, expected {want[0]} and {want[1]}")
            read_outputs(os.path.join(uh["experiment"]["out_dir"], uh["experiment"]["name"],
                                      define_userhandle_folder_name(uh), "meshes"),
                         (n, 3), 1, f"run mesh ({n} vertices)")
            kind, c = fps.variant(n)
            report_entry(f"run, tosca head.yaml on {n} vertices ({n_cluster} of the 8 FPS launches"
                         f" by fps_cluster_kernel; FPS variant {kind}, C={c}; {programs})", times,
                         wall, card)
        # ---- end of the main path (its launches checked run by run)
        port_test.make_steps = real_make
        uh["data"].update(dataset_dir=meshes[40962]["dataset_dir"],
                          split_dir=meshes[40962]["split_dir"])
        entry_turns(torch, port_test, port_run, real_make, cfg, uh, root, argv, data_stream,
                    out, card)

        jax_file_test(torch, port_test, cfg, model, root, argv, data_stream, out)
        check_pair_reference(torch, model, cfg, first_pair(cfg), "test pair (40962 vertices)")
        check_pair_reference(torch, model, uh, first_pair(uh), "run pair (10242 vertices)")

        verts = meshio.load_mesh(os.path.join(meshes[40962]["dataset_dir"], "cat0", "0000",
                                              "model_normalized.obj"))[0]
    x = torch.as_tensor(verts[None], device="cuda")
    fps_500 = fps.furthest_point_sample(x, 500)[0].cpu().numpy()
    fps_100 = fps.furthest_point_sample(
        torch.as_tensor(verts[fps_500][None], device="cuda"), 100)[0].cpu().numpy()
    rng = np.random.RandomState(5)
    for site in large_k1_sites():
        a = k1_inputs(torch, rng, verts, fps_500, fps_100, site)
        rows["k1"].append(check_k1_site(torch, a, site, digest=False))
        del a
        torch.cuda.empty_cache()
    with torch.inference_mode():
        surf_cano = model.canonicalize(x, x)[1][0].cpu().numpy()  # the forward encoder's cloud
    step_ms = fps_step_ms(torch, fps)
    rows["k3"] += [check_fps_cloud(torch, verts, 500, 0, step_ms, " (mesh vertices)"),
                   check_fps_cloud(torch, surf_cano, 500, 0, step_ms, " (canonicalised)")]
    log(f"entry points: phase 5 took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------- phase 6

# the training entry point's fixture: 4 identities x 2 motions x 9 frames at
# the shipped sample counts (72 stage-1 pairs, 648 stage-2 training pairs);
# num_sampled_pairs (training, validation) cut so an epoch takes 4 batches of
# 16 in stage 1 and 5 of 8 in stage 2, and a validation 2 batches, the
# second padded
CLI_FIXTURE = dict(n_identities=4, n_motions_per_identity=2, n_frames=9, n_surface=5000,
                   n_space=5000, subdivisions=3)
CLI_PAIRS = {"forward": (64, 20), "backward": (64, 20), "arbitrary": (40, 12)}
CLI_EPOCHS = 2
# launches (K1, K2, K3, K4, gather) per validation batch: a train step's forward
VAL_LAUNCHES = {"forward": (8, 0, 2, 0, 0), "backward": (8, 0, 2, 0, 0),
                "arbitrary": (17, 0, 4, 0, 0)}


def cli_config(label, fx, root, epochs=CLI_EPOCHS, weights=None):
    """The shipped ``configs/deform4d/<label>.yaml`` with only the data
    paths, ``interval``, ``num_sampled_pairs``, the epochs and the save and
    validation frequencies changed (and, in stage 2, the stage-1 files) ->
    the path of the config written."""
    from nsdp_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(REPO, "configs", "deform4d", f"{label}.yaml"))
    cfg["experiment"]["out_dir"] = os.path.join(root, "out")
    cfg["data"].update(dataset_dir=fx["dataset_dir"], split_dir=fx["split_dir"], interval=1)
    cfg["training"].update(num_sampled_pairs=CLI_PAIRS[label][0], epochs=epochs,
                           save_frequency=1)
    cfg["validation"].update(num_sampled_pairs=CLI_PAIRS[label][1], frequency=1)
    if weights is not None:
        cfg["training"].update(weight_forward_file=weights[0], weight_backward_file=weights[1])
    return write_config(cfg, os.path.join(root, f"{label}_{epochs}.yaml")), cfg


def recording_steps(torch, make_steps, record, label, graphs=None):
    """``make_steps`` (with ``graphs``, where given) whose train and
    validation steps check their launches (``TRAIN_LAUNCHES`` /
    ``VAL_LAUNCHES``; a captured step's wrappers count only at its first,
    eager step and at its capture, and nothing while it replays) and feed
    ``record``: the model, the optimizer and the real step functions,
    whether the step is captured, their state before the first step (host
    copies), each step's loss, the last batch, and the synchronising CUDA
    calls (``torch.cuda.set_sync_debug_mode``) over one whole step after
    the first (eager) or after the capture (captured): from the end of that
    step to the end of the next -- the loader, the batch's upload and a
    whole step, before its late loss read.  A captured run's window also
    holds the late read of the capture step's loss (``float(loss)`` in
    ``train.py``'s ``report``), the loop's one sanctioned synchronisation:
    that one is left out."""
    import linecache
    import warnings

    def late_read(w):
        return (w.filename.endswith(os.path.join("nsdp_tpu_torch", "train.py"))
                and "float(loss)" in linecache.getline(w.filename, w.lineno))

    from nsdp_tpu_torch.training.async_ckpt import host_copy

    def make(model, model_type, optimizer, **kwargs):
        if graphs is not None:
            kwargs["graphs"] = graphs
        steps = make_steps(model, model_type, optimizer, **kwargs)
        train, validate = steps["train_step"], steps["validate_step_masked"]
        captured = train.graphs is not None
        watched = 1 if captured else 0  # the sync window opens after this step
        record.update(model=model, optimizer=optimizer, steps=dict(steps), losses=[], val=0,
                      val_counted=0, syncs=[], captured=captured)

        def train_step(batch, lr, fetch=True):
            n = len(record["losses"])
            if n == 0:
                record["first"] = host_copy(model.state_dict())
                record["first_opt"] = host_copy(optimizer.state_dict())
            before = counts()
            loss = train(batch, lr, fetch)
            if n == watched + 1:
                torch.cuda.set_sync_debug_mode("default")
                record["syncs"] = [f"{w.filename}:{w.lineno}: {w.message}"
                                   for w in record.pop("caught")
                                   if "called a synchronizing" in str(w.message)
                                   and not late_read(w)]
                record.pop("catcher").__exit__(None, None, None)
            want = (0,) * 5 if captured and n >= 2 else TRAIN_LAUNCHES[label]
            expect_launches(before, want, f"{label} train step {n} through the CLI")
            record["losses"].append(loss)
            record["batch"] = batch
            if n == watched:
                record["catcher"] = warnings.catch_warnings(record=True)
                record["caught"] = record["catcher"].__enter__()
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
            return loss

        def validate_step_masked(batch, mask):
            before, programs = counts(), evaluation_calls(validate.graphs)
            loss = validate(batch, mask)
            record["val"] += 1
            if validate.graphs is None:
                expect_launches(before, VAL_LAUNCHES[label], f"{label} validation batch")
                record["val_counted"] += 1
                return loss
            # captured: a signature's first call (eager) and its second
            # (the capture) count on the wrappers, a replay only in its
            # graph's kernel nodes
            (program,) = [p for key, p in validate.graphs.programs.items()
                          if p.calls != programs.get(key, 0)]
            counted = program.calls <= 2
            expect_launches(before, tuple(int(counted) * v for v in VAL_LAUNCHES[label]),
                            f"{label} captured validation batch")
            if program.graph is not None:
                expect_replay(replay_launches(validate.graphs, program), VAL_LAUNCHES[label],
                              f"{label} validation batch replayed")
            record["val_counted"] += int(counted)
            return loss

        train_step.graphs, validate_step_masked.graphs = train.graphs, validate.graphs
        steps.update(train_step=train_step, validate_step_masked=validate_step_masked)
        return steps

    return make


def evaluation_calls(graphs):
    """Each evaluation program's calls so far, by key (none without
    ``graphs``)."""
    return {} if graphs is None else {k: p.calls for k, p in graphs.programs.items()}


def trace_idle(directory):
    """(device activities, busy ms, window ms, idle share) of the one
    Chrome trace ``trace_steps`` wrote into ``directory``: the window spans
    every recorded event, host and device."""
    names = [f for f in os.listdir(directory) if f.endswith(".json")]
    if len(names) != 1:
        fail(f"{directory} holds {len(names)} traces, expected 1")
    with open(os.path.join(directory, names[0])) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    device = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not device:
        fail(f"the trace in {directory} holds no device activity")
    window = (max(e["ts"] + e.get("dur", 0) for e in events)
              - min(e["ts"] for e in events)) / 1e3
    busy = busy_us(device) / 1e3
    return len(device), busy, window, 1 - busy / window


def trace_has_device(directory) -> bool:
    name = [f for f in os.listdir(directory) if f.endswith(".json")][0]
    with open(os.path.join(directory, name)) as f:
        return any(e.get("cat") == "kernel" for e in json.load(f)["traceEvents"])


COLLECTIVE_SPAN = re.compile(r"allreduce|all_reduce|record_param_comms", re.IGNORECASE)


def trace_host(directory):
    """The host side of the one Chrome trace in ``directory``: the
    all-reduces' count and time (the dispatcher's ``c10d::allreduce_``, one
    span per call), and the host's self time (a span's length less that of
    the spans nested in it on its thread), summed over every thread, in
    the collectives' spans (``COLLECTIVE_SPAN``, their autograd wrappers
    included) and in every other operation; and the NCCL kernels' device
    time -> a dict of ms."""
    name = [f for f in os.listdir(directory) if f.endswith(".json")][0]
    with open(os.path.join(directory, name)) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    device = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") == "kernel" and "nccl" in e["name"].lower()]
    host = sorted((e for e in events if e.get("cat") in ("cpu_op", "user_annotation")),
                  key=lambda e: (e["tid"], e["ts"], -e["dur"]))
    self_ms = {"collective": 0.0, "other": 0.0}
    stack = []  # (end, event, children's time) of the open spans of one thread
    for e in host + [None]:
        while stack and (e is None or e["tid"] != stack[-1][1]["tid"] or e["ts"] >= stack[-1][0]):
            _, done, nested = stack.pop()
            kind = "collective" if COLLECTIVE_SPAN.search(done["name"]) else "other"
            self_ms[kind] += (done["dur"] - nested) / 1e3
            if stack:
                stack[-1][2] += done["dur"]
        if e is not None:
            stack.append([e["ts"] + e["dur"], e, 0.0])
    calls = [e["dur"] for e in host if e["name"] == "c10d::allreduce_"]
    return dict(all_reduces=len(calls), all_reduce_ms=sum(calls) / 1e3,
                collective_self_ms=self_ms["collective"], other_self_ms=self_ms["other"],
                nccl_device_ms=busy_us(device) / 1e3 if device else 0.0)


def check_cli_files(directory, label):
    want = ["model_00000", "model_00001", "opt_00000", "opt_00001", "params.json", "stats.txt"]
    names = sorted(os.listdir(directory))
    best = [n for n in names if n.startswith("modelbest_")]
    if [n for n in names if not n.startswith("modelbest_")] != want or len(best) != 1:
        fail(f"{label}: the CLI wrote {names}, expected {want} and one modelbest_*")
    return best[0]


def cli_losses(path):
    """(epoch, loss) of every progress line of a ``stats.txt``."""
    with open(path) as f:
        return [(int(m.group(1)), float(m.group(2))) for m in
                re.finditer(r"epoch: (-?\d+) - batch: \d+ - loss: (\S+)", f.read())]


def same_state(torch, got, want, what):
    """Two host state dicts (nested for an optimizer's) equal bit for bit."""
    if isinstance(want, dict):
        if sorted(map(str, got)) != sorted(map(str, want)):
            fail(f"{what}: keys differ")
        for k in want:
            same_state(torch, got[k], want[k], f"{what}/{k}")
    elif isinstance(want, (list, tuple)):
        for i, (a, b) in enumerate(zip(got, want)):
            same_state(torch, a, b, f"{what}/{i}")
    elif isinstance(want, torch.Tensor):
        if not torch.equal(got, want):
            fail(f"{what} differs")
    elif got != want:
        fail(f"{what}: {got} != {want}")


def check_watch(torch, record, card):
    """``watch_stats`` on the card on the run's last batch: its first call
    (eager) and its second (the capture) each launching a train step's
    kernels, the next replays launching them in the graph's kernel nodes
    and none by the wrappers; the norms against the eager ``watch_stats``
    on the same model (bit for bit, or the gradient norms by phase 10c's
    rule where K2's float64 atomics reorder); the model, its ``.grad`` and
    the optimizer left bit for bit as they were; captured and eager timed
    in turns."""
    from nsdp_tpu_torch.training import make_steps
    from nsdp_tpu_torch.training.async_ckpt import host_copy

    model, opt, batch = record["model"], record["optimizer"], record["batch"]
    watch = record["steps"]["watch_stats"]
    eager = make_steps(model, "forward", opt, graphs=False)["watch_stats"]
    state = host_copy(model.state_dict())
    grads = [None if p.grad is None else p.grad.clone() for p in model.parameters()]
    opt_state = host_copy(opt.state_dict())
    want = TRAIN_LAUNCHES["forward"]
    for what in ("its first call (eager)", "its capture"):
        before = counts()
        watch(batch)
        expect_launches(before, want, f"watch_stats, {what}")
    before = counts()
    (p_top, p_leaves), (g_top, g_leaves) = replays([watch.graphs], lambda: watch(batch))[0]
    expect_launches(before, (0,) * 5, "watch_stats replayed, the wrappers")
    (program,) = [p for (name, _), p in watch.graphs.programs.items() if name == "watch_stats"]
    expect_replay(replay_launches(watch.graphs, program), want, "watch_stats replayed")
    (_, ep_leaves), (_, eg_leaves) = eager(batch)
    rule = "bit for bit"
    if not np.array_equal(p_leaves, ep_leaves):
        fail("watch_stats: a parameter norm differs from the eager one")
    if not np.array_equal(g_leaves, eg_leaves):
        again = torch.as_tensor(eager(batch)[1][1])
        err = rel_err(torch.as_tensor(g_leaves), torch.as_tensor(eg_leaves))
        noise = rel_err(again, torch.as_tensor(eg_leaves))
        if err > max(REMAT_RULE["factor"] * noise, REMAT_RULE["floor"]):
            fail(f"watch_stats: gradient norms {err:.3g} from the eager ones (eager twice"
                 f" {noise:.3g})")
        rule = f"gradient norms within phase 4b's rule ({err:.3g}; eager twice {noise:.3g})"
    same_state(torch, host_copy(model.state_dict()), state, "watch_stats: the model")
    same_state(torch, host_copy(opt.state_dict()), opt_state, "watch_stats: the optimizer")
    for p, g in zip(model.parameters(), grads):
        if not ((p.grad is None and g is None) or torch.equal(p.grad, g)):
            fail("watch_stats changed a .grad")
    ms = turns(torch, {"captured": lambda: watch(batch), "eager": lambda: eager(batch)},
               ("captured", "eager", "eager", "captured"), 3)
    norms = ", ".join(f"{k} {v:.4g} / {g_top[k]:.4g}" for k, v in p_top.items())
    log(f"train CLI: watch_stats captured on the card (B={len(batch['space_samples_src'])}):"
        f" {' / '.join(map(str, want))} K1 / K2 / K3 / K4 / gather kernel nodes a replay, as"
        f" many by the wrappers at its first (eager) call and at its capture; against the eager watch_stats"
        f" {rule}; the model, its .grad and the optimizer unchanged bit for bit; in turns"
        f" (medians of 6) {ms['captured']:.1f} ms captured, {ms['eager']:.1f} ms eager; parameter"
        f" / gradient norms {norms} ({card})")


def cli_run(torch, label, path, cfg, record, ticks, argv, card):
    """One run of ``python -m nsdp_tpu_torch.train`` in process, its
    launches checked step by step -> (experiment directory, the last
    epoch's wall time a step in ms, steps an epoch, the last epoch's mean
    data / step / fetch ms a step, median step interval, its wall time a
    step and the run's peak memory)."""
    from nsdp_tpu_torch import train as port_train
    from nsdp_tpu_torch.training import read_state_dict

    reset_counts()  # ---- the main path: one run of the training entry point
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ticks.clear()
    t0 = time.perf_counter()
    times = port_train.main([path, *argv])
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = counts()  # ---- end of the main path
    directory = os.path.join(cfg["experiment"]["out_dir"], cfg["experiment"]["name"])
    n_steps = len(times["step"])
    # a captured step's wrappers count at its eager first step and its capture
    counted = min(n_steps, 2) if record["captured"] else n_steps
    # and a captured validation's at each signature's first (eager) call and capture
    want = tuple(counted * t + record["val_counted"] * v
                 for t, v in zip(TRAIN_LAUNCHES[label], VAL_LAUNCHES[label]))
    if launches != want or n_steps != len(record["losses"]) or record["val"] == 0:
        fail(f"{label}: {launches} launches for {n_steps} steps and {record['val']} validation"
             f" batches, expected {want}")
    evaluation = record["steps"]["validate_step_masked"].graphs
    if record["captured"] != (evaluation is not None):
        fail(f"{label}: the train step is {'' if record['captured'] else 'not '}captured, the"
             f" validation {'is' if evaluation is not None else 'is not'}")
    lines = cli_losses(os.path.join(directory, "stats.txt"))
    losses = [float(x) for x in record["losses"]] + [x for _, x in lines]
    if not np.isfinite(losses).all():
        fail(f"{label}: non-finite loss in {losses}")
    names = dict(record["model"].named_parameters())
    final = read_state_dict(os.path.join(directory, f"model_{cfg['training']['epochs'] - 1:05d}"))
    moved = max(float((final[k] - v).abs().max()) for k, v in record["first"].items() if k in names)
    if not moved > 0:
        fail(f"{label}: the parameters did not move")
    if record["syncs"]:
        fail(f"{label}: a step through the CLI synchronised with the card: {record['syncs'][:3]}")
    # StepTimer ticks once a step, after queueing it and before the late read
    # of the previous step's loss; inside an epoch's loop the ticks are a
    # step apart (the epoch's last tick, after the loop, queues nothing)
    per_epoch = n_steps // len({e for e, _ in lines if e > 0})
    epochs = [ticks[i:i + per_epoch] for i in range(0, len(ticks), per_epoch)]
    intervals = [[(b - a) * 1e3 for a, b in zip(e[:-2], e[1:-1])] for e in epochs]
    last = {k: [x * 1e3 for x in times[k][-per_epoch:]] for k in ("data", "step", "fetch")}
    epoch_ms = sum(map(sum, last.values())) / per_epoch
    rest = ", ".join(f"{k} {sum(times[k]) * 1e3:.1f} ms ({len(times[k])}x)"
                     for k in ("watch", "validation", "checkpoint"))
    mode = "captured" if record["captured"] else "eager"
    programs = "" if evaluation is None else f" (the step's and validation's: {evaluation.describe()})"
    log(f"train CLI {label} ({mode}): {n_steps} steps (B={cfg['training']['batch_size']}) and"
        f" {record['val']} validation batches{programs} in {wall:.2f} s; step interval (StepTimer's ticks"
        f" inside the loop) by epoch {'; '.join(', '.join(f'{x:.1f}' for x in e) for e in intervals)}"
        f" ms, the last epoch's median {float(np.median(intervals[-1])):.1f} ms; the last epoch"
        f" {epoch_ms:.1f} ms a step, per step data"
        f" {', '.join(f'{x:.1f}' for x in last['data'])}, step"
        f" {', '.join(f'{x:.1f}' for x in last['step'])}, fetch"
        f" {', '.join(f'{x:.1f}' for x in last['fetch'])} ms; {rest}; peak memory"
        f" {peak_gb:.2f} GB; largest parameter move {moved:.3g}; no synchronising call over the"
        f" {'first replayed' if record['captured'] else 'second'} step ({card})")
    split = {k: float(np.mean(v)) for k, v in last.items()}
    return directory, epoch_ms, per_epoch, dict(split, interval_ms=float(np.median(intervals[-1])),
                                                epoch_ms=epoch_ms, peak_gb=peak_gb,
                                                validation_ms=[x * 1e3 for x in times["validation"]])


def jax_layout_copy(torch, cfg, model_file, names, root):
    """Stage 2's ``model_00001`` / ``opt_00001`` / ``modelbest_*`` rewritten
    in the JAX package's layout (:func:`write_flax_model_file`,
    :func:`write_flax_opt_file`, no flax) into a fresh experiment directory
    under ``root`` -> (the path of ``cfg`` pointed there, that config)."""
    import copy

    cfg = copy.deepcopy(cfg)
    cfg["experiment"]["out_dir"] = os.path.join(root, "out")
    directory = os.path.join(cfg["experiment"]["out_dir"], cfg["experiment"]["name"])
    os.makedirs(directory)
    source = os.path.dirname(model_file)
    state = torch.load(model_file, map_location="cpu", weights_only=True)["model_state_dict"]
    bns = {k.rsplit(".", 1)[0] for k in state if k.endswith(".running_mean")}
    for name in os.listdir(source):
        if name == "model_00001" or name.startswith("modelbest_"):
            weights = torch.load(os.path.join(source, name), map_location="cpu",
                                 weights_only=True)["model_state_dict"]
            write_flax_model_file(weights, os.path.join(directory, name))
    opt = torch.load(model_file.replace("model_", "opt_"), map_location="cpu",
                     weights_only=True)["optimizer_state_dict"]
    write_flax_opt_file(opt, names, bns, cfg["training"], os.path.join(directory, "opt_00001"))
    return write_config(cfg, os.path.join(root, "arbitrary_3.yaml")), cfg


def check_jax_layout_resume(torch, record, want, tape, directory, jax_dir, card):
    """The resume from the JAX-layout files against the resume from the
    torch files: the model before its first step bit for bit (but the
    BatchNorm counters, which flax does not keep), the optimizer's whole
    state, K2's inputs at every call, and every loss of the resumed epoch."""
    from nsdp_tpu_torch.utils.msgpack_reader import is_msgpack_map

    for name in ("model_00001", "opt_00001"):
        with open(os.path.join(jax_dir, name), "rb") as f:
            if not is_msgpack_map(f.read(1)):
                fail(f"JAX-layout resume: {name} is not a msgpack map")
    counters = [k for k in want["first"] if k.endswith("num_batches_tracked")]
    same_state(torch, {k: v for k, v in record["first"].items() if k not in counters},
               {k: v for k, v in want["first"].items() if k not in counters},
               "JAX-layout resume: the model before its first step")
    same_state(torch, record["first_opt"], want["first_opt"],
               "JAX-layout resume: the optimizer before its first step")
    parted = tape.check(torch, "JAX-layout resume")
    losses = [float(x) for x in record["losses"]]
    if losses != want["losses"]:
        fail(f"JAX-layout resume: losses {losses} against {want['losses']}")
    printed = [cli_losses(os.path.join(d, "stats.txt")) for d in (jax_dir, directory)]
    if printed[0] != printed[1] or not printed[0]:
        fail(f"JAX-layout resume: printed losses {printed[0]} against {printed[1]}")
    if "model_00002" not in os.listdir(jax_dir):
        fail("JAX-layout resume: no model_00002")
    n_opt = sum(len(s) for s in want["first_opt"]["state"].values())
    log(f"train CLI: stage 2 resumed at epoch 2 from the same files in the JAX package's layout"
        f" (flax msgpack; Adam's mu / nu / count as optax keeps them): the model bit for bit but"
        f" its {len(counters)} BatchNorm counters (not in a flax file), the optimizer's"
        f" {len(want['first_opt']['state'])} parameter states ({n_opt} tensors) bit for bit, K2's"
        f" inputs bit for bit at every call ({parted} output elements of K2's float64 atomics"
        f" parted between the runs, replayed), the {len(losses)} losses of epoch 3 and"
        f" {len(printed[0])} printed lines bit for bit (last loss {losses[-1]!r}); {card}")


def cli_turns(torch, fx, root, weights, record, ticks, make_steps, argv, card):
    """Phase 10's `train` in turns: stage 2 through ``python -m
    nsdp_tpu_torch.train`` from the stage-1 files, 3 epochs, untraced,
    eager (``graphs=False``), captured, captured, eager, each in a fresh
    directory: the last epoch's data / step / fetch split a step, the
    median step interval, peak memory and both validation passes of each
    (captured: the first runs its first batch eagerly and captures at the
    second, the second pass replays)."""
    from nsdp_tpu_torch import train as port_train

    rows = []
    for i, graphs in enumerate((False, None, None, False)):
        turn = os.path.join(root, f"turn{i}")
        os.makedirs(turn)
        path, cfg = cli_config("arbitrary", fx, turn, epochs=3, weights=weights)
        port_train.make_steps = recording_steps(torch, make_steps, record, "arbitrary",
                                                graphs=graphs)
        *_, stats = cli_run(torch, "arbitrary", path, cfg, record, ticks, argv, card)
        rows.append(("captured" if record["captured"] else "eager", stats))
        record.clear()
        torch.cuda.empty_cache()
    log("graphs: train CLI stage 2 (B=8) in turns, the last epoch a step: " + "; ".join(
        f"{mode} interval {r['interval_ms']:.1f} ms, data {r['data']:.1f} / step {r['step']:.1f}"
        f" / fetch {r['fetch']:.1f} ms, wall {r['epoch_ms']:.1f} ms, peak {r['peak_gb']:.2f} GB,"
        f" validation passes (2 batches of 8) {', '.join(f'{x:.1f}' for x in r['validation_ms'])} ms"
        for mode, r in rows) + f" ({card})")


def train_cli(torch, card):
    """Phase 6: ``python -m nsdp_tpu_torch.train`` at full width, in
    process: stage 1 (forward, backward), stage 2 from their last files,
    then a resume of stage 2."""
    import tempfile

    from nsdp_tpu_torch import train as port_train
    from nsdp_tpu_torch.data.synthetic import generate_synthetic_dataset
    from nsdp_tpu_torch.training import read_state_dict
    from nsdp_tpu_torch.utils.profiling import StepTimer

    t_phase = time.perf_counter()
    make_steps, timer = port_train.make_steps, port_train.StepTimer
    record, ticks = {}, []  # what the recording steps and timer see of a run

    class RecordingTimer(StepTimer):
        def tick(self):
            super().tick()
            ticks.append(time.perf_counter())

    port_train.StepTimer = RecordingTimer
    argv = ["--seed", "0", "--num_workers", "4", "--matmul_precision", "highest"]
    try:
        with tempfile.TemporaryDirectory() as root:
            t0 = time.perf_counter()
            fx = generate_synthetic_dataset(os.path.join(root, "data"), **CLI_FIXTURE)
            log(f"train CLI: fixture (4 identities x 2 motions x 9 frames of a 642-vertex mesh,"
                f" 5000 surface and space samples) in {time.perf_counter() - t0:.1f} s; the shipped"
                f" configs cut to: data paths, interval 1, num_sampled_pairs (training,"
                f" validation) {CLI_PAIRS}, epochs {CLI_EPOCHS} (then 3 to resume stage 2),"
                f" save_frequency 1, validation.frequency 1; widths, depth, batches and"
                f" optimizer as shipped")
            last = {}
            for label in ("forward", "backward", "arbitrary"):
                weights = None if label != "arbitrary" else (last["forward"], last["backward"])
                path, cfg = cli_config(label, fx, root, weights=weights)
                trace_dir = os.path.join(root, "trace", label)
                port_train.make_steps = recording_steps(torch, make_steps, record, label)
                directory, epoch_ms, per_epoch, _ = cli_run(
                    torch, label, path, cfg, record, ticks, [*argv, "--profile_dir", trace_dir],
                    card)
                best = check_cli_files(directory, label)
                last[label] = os.path.join(directory, "model_00001")
                if weights is not None:
                    for branch, wfile in zip(("model_deform", "model_canonicalize"), weights):
                        sub = {k[len(branch) + 1:]: v for k, v in record["first"].items()
                               if k.startswith(branch + ".")}
                        same_state(torch, sub, read_state_dict(wfile),
                                   f"stage 2: {branch} before the first step")
                n_dev, busy, window, idle = trace_idle(trace_dir)
                graphs = record["steps"]["train_step"].graphs
                for program in step_programs(graphs):  # the last batch's size has its own
                    expect_replay(replay_launches(graphs, program), TRAIN_LAUNCHES[label],
                                  f"{label}'s captured step through the CLI")
                per_step = busy / per_epoch
                log(f"train CLI {label}: traced first epoch {window:.1f} ms, {n_dev} device"
                    f" activities, busy {busy:.1f} ms: the device idles {100 * idle:.1f}%"
                    f" (its first step's warm-up and the loader's start included); {per_step:.1f}"
                    f" ms busy a step against the untraced last epoch's {epoch_ms:.1f} ms a step:"
                    f" {100 * (1 - per_step / epoch_ms):.1f}% idle; its kernels"
                    f" {' / '.join(map(str, TRAIN_LAUNCHES[label]))} K1 / K2 / K3 / K4 / gather"
                    f" a step (the eager first step's and the capture's counters, the graph's"
                    f" kernel nodes at every replay);"
                    f" {best}; {card}")
                if label == "forward":
                    check_watch(torch, record, card)
                names = [n for n, _ in record["model"].named_parameters()]
                record.clear()
                torch.cuda.empty_cache()

            cli_turns(torch, fx, root, (last["forward"], last["backward"]), record, ticks,
                      make_steps, argv, card)
            path, cfg = cli_config("arbitrary", fx, root, epochs=3,
                                   weights=(last["forward"], last["backward"]))
            # the same stage-2 files in the JAX package's layout, in a
            # directory of their own, before the resume below writes on
            jax_path, jax_cfg = jax_layout_copy(torch, cfg, last["arbitrary"], names,
                                                os.path.join(root, "jax_layout"))
            # both resumes draw their items in order (no loader threads
            # sharing np.random), and the second replays K2's outputs of the
            # first (its float64 atomics sum in no fixed order): both eager,
            # since a captured step's K2 runs inside its graph
            resume_argv = [*argv[:argv.index("--num_workers")], "--num_workers", "0",
                           *argv[argv.index("--num_workers") + 2:]]
            tape = K2Tape()
            port_train.make_steps = recording_steps(torch, make_steps, record, "arbitrary",
                                                    graphs=False)
            with tape.run(replay=False):
                directory, _, _, _ = cli_run(torch, "arbitrary", path, cfg, record, ticks,
                                             resume_argv, card)
            same_state(torch, record["first"], read_state_dict(last["arbitrary"]),
                       "resume: the model before its first step")
            opt = torch.load(last["arbitrary"].replace("model_", "opt_"), map_location="cpu",
                             weights_only=True)["optimizer_state_dict"]
            same_state(torch, record["first_opt"], opt, "resume: the optimizer before its first step")
            epochs = {e for e, _ in cli_losses(os.path.join(directory, "stats.txt")) if e > 0}
            if epochs != {3} or "model_00002" not in os.listdir(directory):
                fail(f"resume: trained epochs {epochs}, expected {{3}} and model_00002")
            log("train CLI: stage 2 resumed at epoch 2 from model_00001 / opt_00001, loaded bit"
                " for bit; stage 1's last files grafted bit for bit into stage 2's branches")
            torch_resume = {k: record[k] for k in ("first", "first_opt")}
            torch_resume["losses"] = [float(x) for x in record["losses"]]
            record.clear()
            port_train.make_steps = recording_steps(torch, make_steps, record, "arbitrary",
                                                    graphs=False)
            with tape.run(replay=True):
                jax_dir, _, _, _ = cli_run(torch, "arbitrary", jax_path, jax_cfg, record, ticks,
                                           resume_argv, card)
            check_jax_layout_resume(torch, record, torch_resume, tape, directory, jax_dir, card)
            record.clear()
    finally:
        port_train.make_steps, port_train.StepTimer = make_steps, timer
    torch.cuda.empty_cache()
    log(f"train CLI: phase 6 took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------- phase 8

# scripts/check_precision_convergence.py's defaults: Adam at 5e-4, 40 steps,
# batch 8, one batch, stage 1 (forward.yaml), the loss every 5 steps
CONVERGENCE = dict(steps=40, B=8, lr=5e-4, every=5)
# launches (K1, K2, K3, K4, gather) of a stage-2 step under remat: every
# encoder and decoder forward runs again in the backward (its K1s and FPS)
REMAT_LAUNCHES = (34, 17, 8, 0, 0)
REMAT_RULE = dict(factor=4.0, floor=1e-4)  # phase 4b's


def shipped_config(model_type, **model):
    """A shipped ``configs/deform4d`` config with ``model`` keys set."""
    from nsdp_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(REPO, "configs", "deform4d", f"{model_type}.yaml"))
    cfg["model"].update(model)
    return cfg


def narrow_training(torch, rng, f32_stats):
    """Phase 8a: the shipped stage-1 ``forward`` (B = 16) and stage-2
    ``arbitrary`` (B = 8) models with ``compute_dtype: bfloat16``, trained
    as phase 3b trains them (its launches, finite losses, parameters moved
    and float32), beside phase 3b's float32 numbers."""
    runs = [(f"{t} bf16", t, shipped_config(t, compute_dtype="bfloat16"))
            for t in ("forward", "arbitrary")]
    stats, _ = train(torch, rng, runs)
    for label, s in stats.items():
        f32 = f32_stats[label.split()[0]]
        log(f"bf16 train {label:<15} step {s['step_ms']:.2f} ms against float32's"
            f" {f32['step_ms']:.2f} ms ({s['step_ms'] / f32['step_ms']:.3f}x), peak memory"
            f" {s['peak_gb']:.2f} GB against {f32['peak_gb']:.2f} GB")


def convergence(torch):
    """Phase 8b: the card's counterpart of ``scripts/check_precision_convergence.py
    --compute-dtype bfloat16``: 40 stage-1 steps at B = 8 on one batch from
    one seeded init, in float32 and in bfloat16; every loss finite and the
    bfloat16 trajectory ending below its start."""
    from nsdp_tpu_torch.models import build_model, init_random
    from nsdp_tpu_torch.training import make_steps, optimizer_factory

    c = CONVERGENCE
    batch = train_batch(np.random.RandomState(3), c["B"], 5000, 5000)
    for dtype in ("float32", "bfloat16"):
        model = init_random(build_model(shipped_config("forward", compute_dtype=dtype)), 0,
                            out_scale=0.01)
        _, opt = optimizer_factory({"optimizer": "Adam", "lr": c["lr"]}, model.parameters())
        steps = make_steps(model, "forward", opt)
        t0 = time.perf_counter()
        losses = [steps["train_step"](batch, c["lr"]) for _ in range(c["steps"])]
        wall = time.perf_counter() - t0
        if not np.isfinite(losses).all():
            fail(f"convergence {dtype}: non-finite loss in {losses}")
        shown = [(i, round(x, 6)) for i, x in enumerate(losses)
                 if i % c["every"] == 0 or i == c["steps"] - 1]
        log(f"convergence {dtype}: {json.dumps(shown)} ({c['steps']} steps in {wall:.1f} s)")
        if dtype == "bfloat16" and not losses[-1] < losses[0]:
            fail(f"convergence bfloat16: the loss ends at {losses[-1]:.6g}, not below its start"
                 f" {losses[0]:.6g}")
        del model, opt, steps
        torch.cuda.empty_cache()


def remat_step(torch):
    """Phase 8c: one stage-2 step (B = 8) with ``remat: true`` against two
    without, from the same state on one batch.  The loss and every
    BatchNorm buffer bit for bit; every gradient and parameter after the
    step bit for bit, or, where K2's float64 atomics reorder (the two steps
    without remat differ there too), within phase 4b's rule: its relative L2
    gap to the first step without remat at most 4 times the second's, floor
    1e-4.  Then 3 more steps of each, timed, with their peak memory.  All
    eager: phase 10 holds the captured remat step against the eager one."""
    batch = train_batch(np.random.RandomState(11), 8, 5000, 5000)
    runs = {}
    for name, remat in (("plain", False), ("again", False), ("remat", True)):
        _, model, schedule, opt, steps = train_setup(
            torch, "arbitrary", seed=0, cfg=shipped_config("arbitrary", remat=remat), graphs=False)
        lr = schedule.get_learning_rate(0)
        before = counts()
        loss = steps["train_step"](batch, lr)
        torch.cuda.synchronize()
        launches = tuple(a - b for a, b in zip(counts(), before))
        want = REMAT_LAUNCHES if remat else TRAIN_LAUNCHES["arbitrary"]
        if launches != want:
            fail(f"stage-2 step, remat {remat}: {launches} K1 / K2 / K3 / K4 / gather launches,"
                 f" expected {want}")
        state = dict(loss=loss, buffers=[b.clone() for b in model.buffers()],
                     grads=[p.grad.clone() for p in model.parameters()],
                     params=[p.detach().clone() for p in model.parameters()])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            steps["train_step"](batch, lr)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        state.update(step_ms=float(np.median(step_ms)),
                     peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        runs[name] = state
        del model, opt, steps
        torch.cuda.empty_cache()
    plain, again, remat = runs["plain"], runs["again"], runs["remat"]
    if remat["loss"] != plain["loss"]:
        fail(f"remat: loss {remat['loss']!r} differs from {plain['loss']!r}")
    if not all(torch.equal(a, b) for a, b in zip(remat["buffers"], plain["buffers"])):
        fail("remat: a BatchNorm buffer differs from the step without remat")
    worst, reordered = 0.0, 0
    for what in ("grads", "params"):
        for i, (r, p, q) in enumerate(zip(remat[what], plain[what], again[what])):
            if torch.equal(r, p):
                continue
            reordered += 1
            err, noise = rel_err(r, p), rel_err(q, p)
            limit = max(REMAT_RULE["factor"] * noise, REMAT_RULE["floor"])
            worst = max(worst, err / limit)
            if err > limit:
                fail(f"remat: {what} {i}: relative L2 gap {err:.3g} beyond {limit:.3g}"
                     f" (the steps without remat differ by {noise:.3g})")
    n = len(plain["grads"])
    log(f"remat: stage-2 step (B=8) loss {remat['loss']:.6g} and every BatchNorm buffer bit for"
        f" bit; {2 * n - reordered} of {2 * n} gradients and parameters bit for bit, the other"
        f" {reordered} (K2's float64 atomics) within phase 4b's rule, largest ratio {worst:.3g};"
        f" launches per step {' / '.join(map(str, REMAT_LAUNCHES))}")
    log(f"remat: step {remat['step_ms']:.2f} ms against {plain['step_ms']:.2f} ms without"
        f" (medians of 3), peak memory {remat['peak_gb']:.2f} GB against {plain['peak_gb']:.2f} GB"
        f" ({plain['peak_gb'] - remat['peak_gb']:.2f} GB saved)")


def record_attention(torch, calls):
    """A context in which every attention call of the model's blocks is
    also appended to ``calls`` as (positional arguments, keyword arguments,
    the call's narrow dtype, its output); the launches are the model's."""
    import nsdp_tpu_torch.nn.blocks as blocks
    from nsdp_tpu_torch.ops import attention

    real = blocks.fused_vector_attention

    def recording(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append((args, kwargs, attention.context_dtype(), out))
        return out

    @contextlib.contextmanager
    def patched():
        blocks.fused_vector_attention = recording
        try:
            yield
        finally:
            blocks.fused_vector_attention = real

    return patched()


def hold_narrow_calls(torch, calls):
    """Each recorded attention call of a narrow evaluation against the plain
    narrow version on the CPU, on the call's own arguments (its
    projection-mode keywords included): a relative L2 gap at most
    ``K1_NARROW_SHARE`` of the plain narrow version's gap to the plain
    float32 one, phase 2's rule -> the largest share."""
    from nsdp_tpu_torch.ops import attention

    cpu = lambda t: t.cpu() if isinstance(t, torch.Tensor) else t
    worst = 0.0
    for i, (args, kwargs, dtype, out) in enumerate(calls):
        if dtype is None:
            fail(f"bf16 evaluation: attention call {i} ran outside the narrow mode")
        args, kwargs = [cpu(a) for a in args], {key: cpu(v) for key, v in kwargs.items()}
        ref = attention.fused_vector_attention(*args, **kwargs, compute_dtype=dtype)
        gap = rel_err(ref, attention.fused_vector_attention(*args, **kwargs))
        err = rel_err(out.cpu(), ref)
        if not (gap > 0 and err <= K1_NARROW_SHARE * gap):
            fail(f"bf16 evaluation: attention call {i} (Nq={args[0].shape[1]},"
                 f" M={args[1].shape[1]}, D={out.shape[-1]}, projection mode"
                 f" {'kv_feats' in kwargs}): relative L2 gap {err:.3g} to its plain narrow"
                 f" version, beyond {K1_NARROW_SHARE} x that version's gap {gap:.3g} to float32")
        worst = max(worst, err / gap)
    return worst


def narrow_evaluation(torch, rng, surf):
    """Phase 8d: one evaluation of the shipped model at Q = 65,536 through
    ``FlowArbitrary.predict(compute_dtype=torch.bfloat16)``: 17 K1
    launches, every one in the narrow mode, and 4 K3.  Each of its 17
    attention calls is held against the plain narrow version on the CPU on
    the arguments it got (``hold_narrow_calls``), so every site of the
    composed evaluation, the projection-mode switch of ``keys_values``
    included, is checked on the card; the modules around them are the CPU
    path's, which the tests hold against the JAX package's
    ``make_fast_predict(compute_dtype=)``.  Its relative L2 gap to the
    float32 evaluation is taken apart: the gap of each half on the same
    inputs (canonicalize; deform from the float32 canonical pose), the
    float32 deform's gap from the narrow canonical pose to the float32 one,
    and how many of the deforming encoder's first FPS picks differ between
    the two poses.  Both evaluations timed -> its K1 launches."""
    from nsdp_tpu_torch.models import build_model, init_random
    from nsdp_tpu_torch.ops import attention, fps

    cfg = shipped_config("arbitrary")
    model = init_random(build_model(cfg), 0)
    handle = (surf[:, 2] > 0.8).astype(np.float32)[:, None]
    inputs = np.concatenate([surf, (surf + np.float32(0.25)) * handle, handle], -1)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32)[None], device="cuda")
    pts, inp = t(rng.uniform(-1.3, 1.3, (65536, 3))), t(inputs)
    narrow = lambda: attention.attention_dtype(torch.bfloat16)
    calls = []
    with torch.inference_mode():
        ref = model.predict(pts, inp)
        reset_counts()  # ---- the main path of the narrow mode
        with record_attention(torch, calls):
            out = model.predict(pts, inp, compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        launches, n_narrow = counts(), attention.fused_vector_attention.narrow_launches
        # ---- end of the main path of the narrow mode
        expect_launches((0,) * 5, SERVE_LAUNCHES["shipped"]["deform"], "bf16 evaluation")
        if n_narrow != launches[0] or len(calls) != launches[0]:
            fail(f"bf16 evaluation: {n_narrow} of {launches[0]} K1 launches in the narrow mode,"
                 f" {len(calls)} attention calls recorded")
        check_output(out[0].cpu().numpy(), (65536, 3), "bf16 evaluation")
        gap = rel_err(out, ref)
        t0 = time.perf_counter()
        worst = hold_narrow_calls(torch, calls)
        hold_s = time.perf_counter() - t0
        del calls

        src, tgt, mask = inp[:, :, 0:3], inp[:, :, 3:6], inp[:, :, 6:7]
        cano = model.canonicalize(pts, src)
        with narrow():
            cano_n = model.canonicalize(pts, src)
            deform_n = model.deform(*cano, tgt, mask)
        deform_f = model.deform(*cano, tgt, mask)
        moved = model.deform(*cano_n, tgt, mask)
        npoint = cfg["model"]["encoder_kwargs"]["npoints_per_layer"][1]
        picks = [fps.furthest_point_sample(c[1], npoint)[0] for c in (cano, cano_n)]
        first = torch.nonzero(picks[0] != picks[1])
        split = dict(space_cano=rel_err(cano_n[0], cano[0]), surf_cano=rel_err(cano_n[1], cano[1]),
                     deform=rel_err(deform_n, deform_f), moved=rel_err(moved, deform_f),
                     end_to_end=rel_err(deform_f, ref))
        picks_differ = int((picks[0] != picks[1]).sum())
        ms = time_ms(torch, lambda: model.predict(pts, inp, compute_dtype=torch.bfloat16), 5)
        ms_f32 = time_ms(torch, lambda: model.predict(pts, inp), 5)
    log(f"bf16 evaluation at Q=65536: {n_narrow} K1 launches in the narrow mode, each within"
        f" {worst:.3f} of its plain narrow version's gap to float32 on its own arguments"
        f" (largest; limit {K1_NARROW_SHARE}; held on the CPU in {hold_s:.1f} s); relative L2"
        f" gap to the float32 evaluation {gap:.3g}; {ms:.2f} ms against float32's"
        f" {ms_f32:.2f} ms (CUDA events, medians of 5)")
    log(f"bf16 evaluation, its gap taken apart: canonicalize {split['space_cano']:.3g} (space),"
        f" {split['surf_cano']:.3g} (surface); deform from the float32 canonical pose"
        f" {split['deform']:.3g}; the float32 deform from the bf16 canonical pose against the"
        f" float32 one {split['moved']:.3g}; the deforming encoder's first FPS ({npoint} picks)"
        f" differs in {picks_differ} picks, the first at pick"
        f" {int(first[0, 0]) if len(first) else -1}; canonicalize then deform against"
        f" predict, both float32: {split['end_to_end']:.3g}")
    return n_narrow


def narrow_and_remat(torch, rng, surf, f32_stats):
    """Phase 8 -> the narrow mode's K1 launches on its main path (8d)."""
    t_phase = time.perf_counter()
    narrow_training(torch, rng, f32_stats)
    convergence(torch)
    remat_step(torch)
    narrow = narrow_evaluation(torch, rng, surf)
    log(f"bf16 and remat: phase 8 took {time.perf_counter() - t_phase:.1f} s")
    return narrow


# ---------------------------------------------------------------- phase 7

MP_BATCH_SEED = 7  # phase 4b's
MP_WEIGHT_SEED = 2  # phase 4b's
# phase 7a's weights have outputs of O(1), as a trained model's (phase 5's
# choice): with init_random's O(100) outputs the float32 gradients of the
# canonicalising decoder are so ill-conditioned that two float32 paths that
# sum in another order part by far more than either errs against float64
# (PERF.md, section 6), while in float64 the ranks equal one process exactly
MP_OUT_SCALE = 0.01
RANK_TIMEOUT = 300  # seconds for one launch of the ranks
SHARED_CARD = "2 ranks sharing one card (not a scaling figure)"


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_ranks(role, world, args, what):
    """``world`` processes of ``python3 chip_smoke.py --rank ROLE RANK WORLD
    PORT ARGS...`` to completion -> their standard outputs.  The pipes are
    drained together; a rank that fails or outlasts ``RANK_TIMEOUT`` fails
    the phase, and every process is killed with it."""
    import threading

    port = str(free_port())
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", role, str(r),
                               str(world), port, *args], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = [""] * world

    def drain(r):
        outs[r] = procs[r].stdout.read()
        procs[r].wait()

    threads = [threading.Thread(target=drain, args=(r,), daemon=True) for r in range(world)]
    try:
        for t in threads:
            t.start()
        deadline = time.perf_counter() + RANK_TIMEOUT
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.perf_counter()))
        for r, p in enumerate(procs):
            if threads[r].is_alive() or p.returncode != 0:
                for p2 in procs:
                    if p2.poll() is None:
                        p2.kill()
                fail(f"{what}: rank {r} of {world} failed (rc={p.poll()}):\n{outs[r][-6000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def rank_summary(out, what):
    """The JSON object a rank prints on its last ``rank:`` line."""
    lines = [ln for ln in out.splitlines() if ln.startswith("rank: ")]
    if not lines:
        fail(f"{what}: a rank printed no summary:\n{out[-3000:]}")
    return json.loads(lines[-1][len("rank: "):])


def join_group(torch, backend, rank, world, port):
    """This process's rank of a group set up here, on ``cuda:0``."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank)
    return dist.group.WORLD


def mp_setup(torch, group=None, dtype=None):
    """(config, model, schedule, optimizer, steps) of phase 7a's stage-2 model."""
    return train_setup(torch, "arbitrary", seed=MP_WEIGHT_SEED, group=group,
                       out_scale=MP_OUT_SCALE, dtype=dtype)


def mp_batches():
    """The two stage-2 batches of phase 7 (B = 8, N = Q = 5000)."""
    rs = np.random.RandomState(MP_BATCH_SEED)
    return [train_batch(rs, 8, 5000, 5000) for _ in range(2)]


def model_state(torch, model, opt, grads=True):
    """Host copies of the parameters, their gradients, the buffers and the
    optimizer's state."""
    from nsdp_tpu_torch.training.async_ckpt import host_copy

    state = {"params": host_copy(dict(model.named_parameters())),
             "buffers": host_copy(dict(model.named_buffers())),
             "opt": host_copy(opt.state_dict())}
    if grads:
        state["grads"] = {k: p.grad.detach().cpu().clone() for k, p in model.named_parameters()}
    return state


def rank_step(torch, rank, world, port, outdir, dtype):
    """Phase 7a, one of two gloo ranks on the card: two stage-2 steps of
    the shipped model through ``make_steps(group=...)`` on this rank's 4
    rows, in ``dtype``: float32 launching K1/K2/K3 as a stage-2 step does,
    float64 through the plain path (:class:`plain_on_card`).  The states
    after each step are written for the parent, and of the first step also
    the canonicalised points and their gradients
    (``FlowArbitrary.canonicalize``'s outputs; the parent's single process
    takes them, as phase 4b's CPU paths take the card's)."""
    from nsdp_tpu_torch.parallel import local_slice

    group = join_group(torch, "gloo", rank, world, port)
    dtype = getattr(torch, dtype)
    _, model, schedule, opt, steps = mp_setup(torch, group, dtype)
    lr = schedule.get_learning_rate(0)
    want = TRAIN_LAUNCHES["arbitrary"] if dtype == torch.float32 else (0, 0, 0, 0, 0)
    record = {"cot": [None, None]}
    canonicalize = model.canonicalize

    def recording(*args, **kwargs):
        out = canonicalize(*args, **kwargs)
        record["cano"] = [t.detach().cpu() for t in out]
        for i, t in enumerate(out):
            t.register_hook(lambda g, i=i: record["cot"].__setitem__(i, g.detach().cpu()))
        return out

    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    with plain_on_card() if dtype == torch.float64 else contextlib.nullcontext():
        for i, batch in enumerate(mp_batches()):
            model.canonicalize = recording if i == 0 else canonicalize
            before = counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = steps["train_step"](local_slice(batch, 8), lr)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            expect_launches(before, want, f"rank {rank}: stage-2 step on 4 rows")
            state = dict(loss=loss, **model_state(torch, model, opt))
            if i == 0:
                state.update(cano=record["cano"], cot=record["cot"])
            torch.save(state, os.path.join(outdir, f"step{i + 1}_rank{rank}.pt"))
    print("rank: " + json.dumps({"rank": rank, "step_ms": step_ms,
                                 "peak_gb": torch.cuda.max_memory_allocated() / 1e9}), flush=True)


class K2Tape:
    """K2's outputs of one run of a step, handed back in order to a second
    run of it.  K2 scatters its key, value, global-slot and position
    gradients by float64 atomics in no fixed order, so two runs of one step
    may part in a last bit of those outputs; a run replayed from the tape
    can be held bit for bit against the recorded one.  :meth:`check` then
    holds K2's inputs of the two runs bit for bit and counts the output
    elements in which K2's own second results parted from the first."""

    def __init__(self):
        self.recorded, self.replayed = [], []

    @contextlib.contextmanager
    def run(self, replay):
        from nsdp_tpu_torch.ops import attention

        real = attention.fused_vector_attention_backward

        def taped(*args):
            out = real(*args)
            if not replay:
                self.recorded.append((args, out))
                return out
            self.replayed.append((args, out))
            return self.recorded[len(self.replayed) - 1][1]

        taped.launches = real.launches  # the wrapper counts on its module name
        attention.fused_vector_attention_backward = taped
        try:
            yield
        finally:
            attention.fused_vector_attention_backward = real
            real.launches = taped.launches

    def check(self, torch, what) -> int:
        if len(self.recorded) != len(self.replayed):
            fail(f"{what}: K2 ran {len(self.recorded)} and {len(self.replayed)} times")
        same = lambda x, y: torch.equal(x, y) if isinstance(x, torch.Tensor) else x is y or x == y
        parted = 0
        for (args0, out0), (args1, out1) in zip(self.recorded, self.replayed):
            if not all(same(x, y) for x, y in zip(args0, args1)):
                fail(f"{what}: K2's inputs differ from the recorded run's")
            parted += sum(int((x != y).sum()) for x, y in zip(out0, out1) if x is not None)
        self.recorded, self.replayed = [], []
        return parted


def no_syncs(torch, fn, what):
    """``fn()`` with ``torch.cuda.set_sync_debug_mode("warn")``: a call that
    synchronises with the card fails."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [f"{w.filename}:{w.lineno}: {w.message}" for w in caught
             if "called a synchronizing" in str(w.message)]
    if syncs:
        fail(f"{what}: synchronised with the card {len(syncs)} times: {sorted(set(syncs))}")
    return out


def node_kinds(program):
    """Counts of a captured graph's nodes: each non-kernel kind, NCCL's
    kernels by name, and the other kernels in one count."""
    kinds = collections.Counter()
    for kind, name in graph_nodes(program):
        kinds[name if kind == "KERNEL" and name.lower().startswith("nccl")
              else "other kernels" if kind == "KERNEL" else kind] += 1
    return dict(kinds)


def capture_stress(torch, group, n=20):
    """``n`` captures, each of a program with all-reduces that stays open
    ~30 ms, each begun right after 50 eager all-reduces that nothing waits
    for, landing at several phases of ProcessGroupNCCL's watchdog loop, in
    ``torch.cuda.graph``'s default ``"global"`` capture mode (in which a
    CUDA call of another thread that is unsafe during a capture breaks
    it): each replay against the eager run -> (captures, failures)."""
    from nsdp_tpu_torch.graphs import Graphs

    x = torch.randn(256, 256, device="cuda")

    def program(x):
        y = x
        for i in range(600):
            y = torch.tanh(y * 1.0001)
            if i % 50 == 0:
                v = y.sum(0)
                torch.distributed.all_reduce(v, group=group)
                y = y + v * 1e-6
        return y

    graphs, failures = Graphs("cuda"), 0
    for i in range(n):
        for _ in range(50):
            torch.distributed.all_reduce(torch.ones(1000, device="cuda"), group=group)
        try:
            out = graphs(f"stress {i}", program, x).clone()
        except RuntimeError as e:
            log(f"7b: capture {i} failed: {e}")
            failures += 1
            break
        if not torch.equal(out, program(x)):
            fail(f"7b: capture {i} replays other values than the eager run")
        time.sleep(0.05 * (i % 4))
    return n, failures


def rank_nccl(torch, rank, world, port, outdir):
    """Phase 7b, one NCCL rank.  Eager: the stage-2 step through
    ``make_steps(group=..., graphs=False)`` against the step without a
    group from the same weights on the same batches, bit for bit after
    each step (K2's outputs of the step without a group replayed into the
    grouped one, :class:`K2Tape`); no synchronising call from the end of
    the first grouped step to the end of the second.  Captured (the
    default under NCCL, the all-reduces inside the graph): its eager first
    step and its capture, then from its state one replayed step against
    the eager grouped step and the captured step without a group
    (:func:`hold_step`, phase 10c's rule), the graph's kernel nodes (K1 /
    K2 / K3 as the eager step launches them, and NCCL's by name) against
    the graph without a group's, and no synchronising call from the end
    of one replayed step to the end of the next.  Then the four steps
    timed in turns and three traced."""
    import copy

    from nsdp_tpu_torch.utils.profiling import trace_steps

    group = join_group(torch, "nccl", rank, world, port)
    # phase 3b's weights: their canonicalised clouds lie far from the
    # origin, where FPS takes points for padding, so FPS picks distinct
    # points and the gathers' backward (an atomic scatter-add where indices
    # repeat) adds in a fixed order; the eager steps for K2Tape, which
    # replays K2's outputs in Python (a replayed graph runs no Python)
    runs = {key: train_setup(torch, "arbitrary", seed=MP_WEIGHT_SEED,
                             group=group if grouped else None, graphs=graphs)
            for key, grouped, graphs in (("eager grouped", True, False),
                                         ("eager", False, False),
                                         ("captured grouped", True, None),
                                         ("captured", False, None))}
    (_, model_g, schedule, opt_g, steps_g), (_, model_n, _, opt_n, steps_n) = (
        runs["eager grouped"], runs["eager"])
    lr = schedule.get_learning_rate(0)
    # the batches go up first, as the training entry point uploads them
    # before the step (a copy from pageable memory waits for the card)
    b1, b2 = [{k: torch.as_tensor(v, device="cuda") for k, v in b.items()} for b in mp_batches()]
    tape, losses, parted = K2Tape(), [], []
    for i, batch in enumerate((b1, b2)):
        with tape.run(replay=False):
            losses.append(steps_n["train_step"](batch, lr, fetch=False))
        with tape.run(replay=True):
            step = lambda: losses.append(steps_g["train_step"](batch, lr, fetch=False))
            # from the end of the first grouped step to the end of the second
            no_syncs(torch, step, "one NCCL rank, the eager grouped step") if i else step()
        parted.append(tape.check(torch, f"one NCCL rank, step {i + 1}"))
        same_state(torch, model_state(torch, model_g, opt_g), model_state(torch, model_n, opt_n),
                   f"one NCCL rank against no group, step {i + 1}")
        if not torch.equal(losses[-2], losses[-1]):
            fail(f"one NCCL rank: loss {losses[-1]} differs from the step without a group's")

    stress = capture_stress(torch, group)
    # the captured steps: the eager first step, the capture
    steps_c, steps_u = runs["captured grouped"][4], runs["captured"][4]
    model_c, opt_c = runs["captured grouped"][1], runs["captured grouped"][3]
    for steps in (steps_c, steps_u):
        if steps["train_step"].graphs is None:
            fail("one NCCL rank: make_steps left a step eager on the card")
        for batch in (b1, b2):
            before = counts()
            steps["train_step"](batch, lr, fetch=False)
            expect_launches(before, TRAIN_LAUNCHES["arbitrary"], "7b, the eager step or capture")
    state = {n: t.clone() for n, t in model_c.state_dict().items()}
    opt_state = copy.deepcopy(opt_c.state_dict())
    held = {}
    for key, (_, model, _, opt, steps) in runs.items():
        if key != "captured grouped":
            model.load_state_dict(state)
            opt.load_state_dict(copy.deepcopy(opt_state))
        before = counts()
        held[key] = step_state(model, steps["train_step"](b1, lr))
        if key.startswith("captured"):
            expect_launches(before, (0,) * 5, f"7b, a replayed {key} step")
    rules = {}
    for other, again in (("eager grouped", "eager"), ("captured", "eager")):
        rules[other] = hold_step(torch, f"one NCCL rank, captured grouped against {other}",
                                 held["captured grouped"], held[other], held[again])
    graphs = {key: runs[key][4]["train_step"].graphs for key in ("captured grouped", "captured")}
    (program,) = step_programs(graphs["captured grouped"])
    (ungrouped,) = step_programs(graphs["captured"])
    names = graph_kernels(program)
    expect_replay(launch_counts(names), TRAIN_LAUNCHES["arbitrary"],
                  "one NCCL rank, the captured grouped step")
    nodes = {"grouped": node_kinds(program), "ungrouped": node_kinds(ungrouped)}
    # from the end of one replayed step to the end of the next
    no_syncs(torch, lambda: steps_c["train_step"](b2, lr, fetch=False),
             "one NCCL rank, a replayed captured grouped step")

    fns = {key: (lambda steps=run[4]: steps["train_step"](b2, lr)) for key, run in runs.items()}
    order = list(fns) + list(fns)[::-1]
    times = turns(torch, fns, order, 2)
    # the collectives of an eager grouped step, and the cost of one alone
    all_reduce, calls = torch.distributed.all_reduce, []
    torch.distributed.all_reduce = lambda *a, **k: calls.append(1) or all_reduce(*a, **k)
    steps_g["train_step"](b2, lr)
    torch.distributed.all_reduce = all_reduce
    x = torch.zeros(256, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(1000):
        all_reduce(x, group=group)
    torch.cuda.synchronize()
    all_reduce_us = (time.perf_counter() - t0) * 1e3
    # one step of each traced: window, device busy and idle share, and the
    # all-reduces' host and device time (the profiler's own cost included)
    traced = {}
    for key in ("eager grouped", "eager", "captured grouped"):
        for attempt in range(3):  # a profiling session may deliver no device activity
            directory = os.path.join(outdir, f"trace_{key.replace(' ', '_')}_{attempt}")
            with trace_steps(directory):
                runs[key][4]["train_step"](b2, lr)
            if trace_has_device(directory):
                break
        _, busy, window, idle = trace_idle(directory)
        traced[key] = dict(window_ms=window, busy_ms=busy, idle=idle, **trace_host(directory))
    print("rank: " + json.dumps({
        "rank": rank, "k2_parted": parted, "all_reduces": len(calls), "traced": traced,
        "times": times, "all_reduce_us": all_reduce_us, "rules": rules, "nodes": nodes,
        "kernel_nodes": len(names), "stress": stress}),
        flush=True)


def rank_cli(torch, rank, world, port, outdir, path):
    """Phase 7c, one of two gloo ranks on the card: ``python -m
    nsdp_tpu_torch.train`` in this process, on the group set up here,
    ``--device cuda:0``; its step interval, peak memory and the calls that
    write the run's files."""
    import nsdp_tpu_torch.train as port_train
    from nsdp_tpu_torch.training.async_ckpt import AsyncCheckpointer
    from nsdp_tpu_torch.utils.profiling import StepTimer

    join_group(torch, "gloo", rank, world, port)
    ticks, writes = [], {"params": 0, "save": 0, "save_best": 0}

    class RecordingTimer(StepTimer):
        def tick(self):
            super().tick()
            ticks.append(time.perf_counter())

    def counted(what, fn):
        def call(*args, **kwargs):
            writes[what] += 1
            return fn(*args, **kwargs)
        return call

    port_train.StepTimer = RecordingTimer
    port_train.save_experiment_params = counted("params", port_train.save_experiment_params)
    AsyncCheckpointer.save = counted("save", AsyncCheckpointer.save)
    AsyncCheckpointer.save_best = counted("save_best", AsyncCheckpointer.save_best)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    times = port_train.main([path, "--seed", "0", "--num_workers", "4", "--matmul_precision",
                             "highest", "--device", "cuda:0"])
    wall = time.perf_counter() - t0
    per_epoch = len(times["step"]) // CLI_EPOCHS
    last = ticks[-per_epoch:]  # the last epoch's ticks: after each step but its first, and after
    print("rank: " + json.dumps({
        "rank": rank, "wall_s": wall, "steps": len(times["step"]), "writes": writes,
        "interval_ms": [(b - a) * 1e3 for a, b in zip(last[:-2], last[1:-1])],
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}), flush=True)


class plain_on_card:
    """Within this context the model's attention and FPS take their plain
    PyTorch versions on CUDA tensors too, so that a model in float64 runs
    on the card: the float64 reference of phase 7a.  The neighbours are
    selected in float32 from the float32 coordinates (the inputs and the
    given canonicalised points), as K1 selects them, and FPS picks in
    float32 as K3 does, so every selection is the card's."""

    def __enter__(self):
        from nsdp_tpu_torch.nn import blocks
        from nsdp_tpu_torch.ops import attention, fps
        from nsdp_tpu_torch.ops.knn import mask_penalty, select

        def attend(xyz_q, kv_xyz, q_feats, K_a, V_a, *weights, k, k_glob=None, v_glob=None,
                   kv_mask=None):
            k = min(k, kv_xyz.shape[1])
            penalty = None if kv_mask is None else mask_penalty(kv_mask.float())
            idx = select(xyz_q.float(), kv_xyz.float(), k, penalty)[0]
            return attention.fused_vector_attention_plain(
                xyz_q, kv_xyz, q_feats, K_a, V_a, *weights, k, k_glob, v_glob, idx=idx)

        self.saved = blocks.fused_vector_attention, blocks.furthest_point_sample
        blocks.fused_vector_attention = attend
        blocks.furthest_point_sample = fps.furthest_point_sample_plain
        return self

    def __exit__(self, *exc):
        from nsdp_tpu_torch.nn import blocks

        blocks.fused_vector_attention, blocks.furthest_point_sample = self.saved


def single_process_step(torch, cano, cot, dtype):
    """The single-process step of phase 7a's first batch on the card from
    the same weights, by halves (:func:`stage2_step_by_halves`) on the
    given canonicalised points and their gradients, in ``dtype`` (float64:
    the plain path, :class:`plain_on_card`) -> its loss, gradients,
    statistics, its own canonicalised points and its gradients at the
    given ones (host copies)."""
    _, model, _, opt, _ = mp_setup(torch, dtype=dtype)
    with plain_on_card() if dtype == torch.float64 else contextlib.nullcontext():
        loss, own, grads = stage2_step_by_halves(torch, model, mp_batches()[0], "cuda", dtype,
                                                 cano, cot)
    out = dict(loss=loss, cano=[c.cpu() for c in own], cot=[g.cpu() for g in grads],
               **model_state(torch, model, opt))
    del model, opt
    torch.cuda.empty_cache()
    return out


def two_rank_step(torch, root, dtype, what):
    """Two gloo ranks of :func:`rank_step` -> (the ranks' summaries, rank
    0's state after the first step, the canonicalised points and their
    gradients of the whole batch), the ranks' states after two steps
    checked bit for bit equal."""
    outs = run_ranks("step", 2, [root, dtype], what)
    after = [torch.load(os.path.join(root, f"step2_rank{r}.pt"), weights_only=False)
             for r in range(2)]
    same_state(torch, after[1], after[0], f"{what}: rank 1's loss, parameters, gradients, Adam"
               " state and running statistics after two steps, against rank 0's")
    got = [torch.load(os.path.join(root, f"step1_rank{r}.pt"), weights_only=False)
           for r in range(2)]
    # the ranks' canonicalised points make the whole batch's; a rank's
    # gradient there is that of the ranks' summed loss, the single
    # process's that of their mean
    cano = [torch.cat([g["cano"][i] for g in got]) for i in (0, 1)]
    cot = [torch.cat([g["cot"][i] for g in got]) / len(got) for i in (0, 1)]
    return [rank_summary(o, what) for o in outs], got[0], cano, cot


def mp_steps(torch, root, card):
    """Phase 7a: two gloo ranks sharing the card against one process, in
    float32 through the kernels and in float64 through the plain path.

    A whole step is not comparable by float32 rounding's rule: the ranks
    sum the batch statistics in another order and run products of fewer
    rows, the canonicalised points move by rounding, and FPS and kNN
    near-ties on them may pick other points.  So each step is held by
    halves cut at the canonical pose, as phase 4b holds the card against
    the CPU: the single process takes the ranks' canonicalised points and
    their gradients."""
    summaries, got, cano, cot = two_rank_step(torch, root, "float32", "7a, two gloo ranks")
    f32, f64 = [single_process_step(torch, cano, cot, dtype)
                for dtype in (torch.float32, torch.float64)]
    if abs(got["loss"] - f32["loss"]) > 1e-4 * abs(f32["loss"]):
        fail(f"7a: by halves, the two ranks' loss {got['loss']} vs one process's {f32['loss']}")
    rule = dict(factor=4.0, floor=1e-4)
    # the seam: the ranks' canonicalised points against the single
    # process's own, and the ranks' gradients there against its gradients
    # at the same points
    for i, what in enumerate(("space_cano", "surf_cano")):
        check_gradient(f"7a, two ranks, {what}", cano[i], f32["cano"][i], f64["cano"][i], **rule)
        check_gradient(f"7a, two ranks, d {what}", cot[i], f32["cot"][i], f64["cot"][i], **rule)
    worst, n_zero = (0.0, ""), 0
    for key, g in got["grads"].items():
        weight = f64["grads"].get(key[:-4] + "weight") if key.endswith(".bias") else None
        ratio = check_gradient(f"7a, two ranks, d {key}", g, f32["grads"][key], f64["grads"][key],
                               weight, **rule)
        n_zero += ratio is None
        worst = max(worst, (ratio or 0.0, key))
    stats = [k for k in got["buffers"] if k.endswith(("running_mean", "running_var"))]
    for key in stats:
        ratio = check_gradient(f"7a, two ranks, {key}", got["buffers"][key], f32["buffers"][key],
                               f64["buffers"][key], **rule)
        worst = max(worst, (ratio, key))
    for s in summaries:
        log(f"multi-process 7a, rank {s['rank']} (gloo, {SHARED_CARD}): stage-2 steps on 4 rows"
            f" (B = 8, N = Q = 5000) {', '.join(f'{x:.1f}' for x in s['step_ms'])} ms, 17/17/4"
            f" K1/K2/K3 launches each; peak memory {s['peak_gb']:.2f} GB")
    log(f"multi-process 7a: loss, parameters, gradients, Adam state and running statistics bit"
        f" for bit equal across the ranks after two steps; by halves against one process on the"
        f" card in float32 and the plain path in float64 (losses {got['loss']:.7g},"
        f" {f32['loss']:.7g}, {f64['loss']:.7g}): the canonicalised points and their gradients,"
        f" {len(got['grads'])} gradients ({n_zero}"
        f" analytically zero, held absolutely) and {len(stats)} running statistics within phase"
        f" 4b's rule (4 times the float32 error, floor 1e-4); largest ratio of the ranks' error to"
        f" the single process's {worst[0]:.3g} ({worst[1]}); {card}")

    # float64: the two ranks equal one process but for float64 rounding
    _, got, cano, cot = two_rank_step(torch, root, "float64", "7a, two gloo ranks in float64")
    one = single_process_step(torch, cano, cot, torch.float64)
    worst = (0.0, "")
    for i, what in enumerate(("space_cano", "surf_cano")):
        for name, g, want in ((what, cano[i], one["cano"][i]), (f"d {what}", cot[i], one["cot"][i])):
            err = float((g - want).abs().max()) / max(float(want.abs().max()), 1e-30)
            if err > 1e-9:
                fail(f"7a in float64: {name}: two ranks against one process, largest error"
                     f" {err:.3g} of its scale, beyond 1e-9")
            worst = max(worst, (err, name))
    for part in ("grads", "buffers"):
        for key, g in got[part].items():
            if part == "buffers" and not key.endswith(("running_mean", "running_var")):
                continue
            scale = float(one[part][key].abs().max())
            if part == "grads" and key.endswith(".bias") and key[:-4] + "weight" in one[part]:
                scale = max(scale, float(one[part][key[:-4] + "weight"].abs().max()))
            err = float((g - one[part][key]).abs().max()) / max(scale, 1e-30)
            if err > 1e-9:
                fail(f"7a in float64: {part} {key}: two ranks against one process, largest error"
                     f" {err:.3g} of its scale, beyond 1e-9")
            worst = max(worst, (err, key))
    log(f"multi-process 7a in float64 (the plain path on the card): the canonicalised points,"
        f" their gradients, every gradient and running statistic of the two ranks within 1e-9"
        f" of its scale of one process's; largest"
        f" {worst[0]:.3g} ({worst[1]}); loss {got['loss']:.15g} against {one['loss']:.15g}")


def mp_nccl(torch, root, card):
    """Phase 7b: one NCCL rank, eager and captured, against the step without
    a group."""
    s = rank_summary(run_ranks("nccl", 1, [root], "7b, one NCCL rank")[0], "7b")
    t = s["times"]
    log(f"multi-process 7b: one NCCL rank through make_steps(group=..., graphs=False) bit for bit"
        f" the step without a group (two steps: parameters, gradients, Adam state, statistics,"
        f" losses; K2's inputs bit for bit, its outputs replayed from the step without a group,"
        f" its own parting from them in {' and '.join(map(str, s['k2_parted']))} elements:"
        f" float64 atomics); no synchronising call from the end of its first step to the end of"
        f" its second; {s['all_reduces']} all-reduces an eager grouped step, one of 256 floats"
        f" {s['all_reduce_us']:.1f} us (1000 in a row); {card}")
    (r_e, w_e), (r_u, w_u) = s["rules"]["eager grouped"], s["rules"]["captured"]
    log(f"multi-process 7b: one NCCL rank captured (make_steps' default under NCCL, the"
        f" all-reduces inside the graph): a replayed step from one state against the eager"
        f" grouped step and against the captured step without a group, the loss and every"
        f" BatchNorm buffer bit for bit, {r_e} and {r_u} gradients and parameters not bit for bit"
        f" (K2's float64 atomics; within phase 4b's rule, largest ratios {w_e:.3g} and"
        f" {w_u:.3g}); the graph's {s['kernel_nodes']} kernel nodes"
        f" {' / '.join(map(str, TRAIN_LAUNCHES['arbitrary']))} K1 / K2 / K3 / K4 / gather as the"
        f" eager step launches; nodes by kind (NCCL's kernels by name) grouped"
        f" {s['nodes']['grouped']} against {s['nodes']['ungrouped']} without a group; no"
        f" synchronising call from the end of one replayed step to the end of the next;"
        f" {s['stress'][0]} captures of all-reduces in the default global mode right after"
        f" unwaited eager all-reduces (the watchdog's work pending), {s['stress'][1]} broken")
    if s["stress"][1]:
        fail("7b: a capture broke while eager collectives were pending")
    log(f"multi-process 7b in turns (each key twice a turn, the turns in order and reversed;"
        f" medians of 4): stage-2 step (B = 8) " + ", ".join(f"{k} {v:.2f} ms" for k, v in t.items())
        + f"; captured grouped against captured {100 * (t['captured grouped'] / t['captured'] - 1):+.1f}%,"
        f" eager grouped against eager {100 * (t['eager grouped'] / t['eager'] - 1):+.1f}%; {card}")
    rows = []
    for key, g in s["traced"].items():
        rows.append(f"{key}: window {g['window_ms']:.2f} ms, device busy {g['busy_ms']:.2f} ms,"
                    f" idle share {g['idle']:.3f}, {g['all_reduces']} all-reduce calls on the host"
                    f" ({g['all_reduce_ms']:.2f} ms), NCCL kernels {g['nccl_device_ms']:.3f} ms on"
                    f" the device, host self time in the collectives' spans"
                    f" {g['collective_self_ms']:.2f} ms and in every other operation"
                    f" {g['other_self_ms']:.2f} ms")
    log(f"multi-process 7b traced (torch.profiler, one step each, its own cost included): "
        + "; ".join(rows) + f"; {card}")


def mp_cli(torch, root, card):
    """Phase 7c: the training entry point on two gloo ranks sharing the card."""
    from nsdp_tpu_torch.data.synthetic import generate_synthetic_dataset

    fx = generate_synthetic_dataset(os.path.join(root, "data"), **CLI_FIXTURE)
    path, cfg = cli_config("forward", fx, root)
    outs = run_ranks("cli", 2, [root, path], "7c, the training entry point on two gloo ranks")
    summaries = [rank_summary(o, "7c") for o in outs]
    printed = [[ln for ln in o.splitlines() if re.match(r"epoch: -?\d+ - batch", ln)]
               for o in outs]
    losses = [[float(re.search(r"loss: (\S+)", ln).group(1)) for ln in p] for p in printed]
    if not losses[0] or losses[0] != losses[1]:
        fail(f"7c: the ranks printed other losses: {losses}")
    directory = os.path.join(cfg["experiment"]["out_dir"], cfg["experiment"]["name"])
    best = check_cli_files(directory, "7c")
    with open(os.path.join(directory, "stats.txt")) as f:
        written = [ln.strip() for ln in f if ln.startswith("epoch")]
    if written != printed[0]:
        fail("7c: stats.txt does not hold rank 0's progress lines, each once")
    writes = [s["writes"] for s in summaries]
    if writes[1] != {"params": 0, "save": 0, "save_best": 0} or writes[0]["params"] != 1 \
            or writes[0]["save"] != CLI_EPOCHS or writes[0]["save_best"] < 1:
        fail(f"7c: rank 0 and rank 1 wrote {writes}")
    for s in summaries:
        log(f"multi-process 7c, rank {s['rank']} (gloo, {SHARED_CARD}): {s['steps']} steps of"
            f" 8 rows (B = 16) in {s['wall_s']:.2f} s; step interval (the last epoch, inside the"
            f" loop) {', '.join(f'{x:.1f}' for x in s['interval_ms'])} ms; peak memory"
            f" {s['peak_gb']:.2f} GB")
    log(f"multi-process 7c: losses printed equal on both ranks ({len(losses[0])} lines, the last"
        f" {losses[0][-1]:.5g}); the files written once, by rank 0 ({best}); {card}")


def multi_process(torch, card):
    """Phase 7: (a) two gloo ranks on the card against one process, (b) one
    NCCL rank against no group, (c) the training entry point on two gloo
    ranks."""
    import tempfile

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    for part in (mp_steps, mp_nccl, mp_cli):
        with tempfile.TemporaryDirectory() as root:
            part(torch, root, card)
    log(f"multi-process: phase 7 took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------- phase 9

# the preprocessing fixture: 2 identities x 1 motion x 7 frames of a
# 40,962-vertex icosphere posed by deform_frame, as .anime files
PRE_FRAMES, PRE_SUBDIVISIONS = 7, 6
NN_POINTS = 30000  # the Chamfer metric's sample count (utils/metrics.py)
MC_GRID, MC_RADIUS = 128, 40.0


def build_native():
    """Phase 1: the host library (``nsdp_tpu_torch/native``) built by
    ``c++`` -> a line on its build (or its reuse) and time."""
    from nsdp_tpu_torch import native

    cached = native.library_path().exists()
    t0 = time.perf_counter()
    native.load()
    what = (f"native library {'reused from an earlier build' if cached else 'built'} in"
            f" {time.perf_counter() - t0:.1f} s ({native.CXX} {' '.join(native.CXXFLAGS)})")
    log(what)
    return what


def check_nn_query(card):
    """The native KD-tree against scipy's on 30,000 x 30,000 points: the
    same indices, and distances within 4 float32 ulps of scipy's float64
    ones rounded to float32 (the native search sums in float32); both
    timed (median of 3)."""
    from scipy.spatial import KDTree

    from nsdp_tpu_torch.native import nearest_neighbor_distances

    rng = np.random.RandomState(9)
    points, queries = (surface(rng, NN_POINTS) for _ in range(2))
    native_s, scipy_s = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        dist, idx = nearest_neighbor_distances(queries, points, return_index=True)
        native_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        want, want_idx = KDTree(points).query(queries)
        scipy_s.append(time.perf_counter() - t0)
    if not np.array_equal(idx, want_idx):
        fail(f"native NN: {int((idx != want_idx).sum())} indices differ from scipy's")
    want = want.astype(np.float32)
    ulps = np.abs(dist.view(np.int32).astype(np.int64) - want.view(np.int32))
    if ulps.max() > 4:
        fail(f"native NN: a distance {int(ulps.max())} float32 ulps from scipy's")
    log(f"host tools: nearest_neighbor_distances on {NN_POINTS} x {NN_POINTS} points"
        f" {1e3 * float(np.median(native_s)):.2f} ms (native, float32) against scipy KDTree"
        f" {1e3 * float(np.median(scipy_s)):.2f} ms (build and query, float64); indices"
        f" equal, distances equal to scipy's rounded to float32 at"
        f" {100 * float((ulps == 0).mean()):.2f}%, at most {int(ulps.max())} ulps; {card}")


def check_mesher(card):
    """``meshing.marching_cubes`` on a 128^3 sphere SDF: a closed mesh (every
    edge in two faces), welded (no vertex twice), every vertex within one
    voxel of the radius; timed (median of 3)."""
    from nsdp_tpu_torch import meshing

    c = (MC_GRID - 1) / 2.0
    x = np.arange(MC_GRID, dtype=np.float32) - c
    sdf = np.sqrt(x[:, None, None] ** 2 + x[None, :, None] ** 2 + x[None, None, :] ** 2) \
        - MC_RADIUS
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        verts, faces = meshing.marching_cubes(sdf, 0.0)
        times.append(time.perf_counter() - t0)
    edges = np.sort(np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]), 1)
    _, per_edge = np.unique(edges, axis=0, return_counts=True)
    if len(faces) == 0 or not (per_edge == 2).all():
        fail(f"marching_cubes: {int((per_edge != 2).sum())} edges not in exactly two faces")
    if len(np.unique(verts, axis=0)) != len(verts):
        fail("marching_cubes: a vertex appears twice (not welded)")
    radii = np.linalg.norm(verts - c, axis=1)
    off = float(np.abs(radii - MC_RADIUS).max())
    if off >= 1.0:
        fail(f"marching_cubes: a vertex {off:.3f} voxels off the radius")
    log(f"host tools: meshing.marching_cubes on a {MC_GRID}^3 sphere SDF (r = {MC_RADIUS:g})"
        f" {1e3 * float(np.median(times)):.1f} ms: {len(verts)} vertices, {len(faces)} faces,"
        f" closed and welded, mean radius {radii.mean():.4f}, every vertex within {off:.4f} of r;"
        f" {card}")


def preprocess_cli(root, command, *args):
    """``python -m nsdp_tpu_torch.preprocess COMMAND ARGS`` as a subprocess
    of its own -> its wall time in s."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "nsdp_tpu_torch.preprocess", command, *args],
                          cwd=REPO, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"preprocess {command} exited {proc.returncode}:\n{proc.stdout}\n{proc.stderr}")
    log(f"host tools: preprocess {command} {' '.join(args).replace(root, '$TMP')}"
        f" in {seconds:.1f} s: {proc.stdout.strip().splitlines()[-1]}")
    return seconds


def check_preprocess(root, card):
    """The preprocessing entry point, each command a subprocess, on 2
    identities x 7 frames of a 40,962-vertex mesh at the default sample
    counts: ``anime``, ``deform4d --seed 0`` (read back by
    ``Deform4DFlowDataset``), ``nocorr``, and ``deform4d --make_watertight``
    by ``sdf`` and by ``poisson`` on each sequence's first frame, each
    watertight frame a closed mesh."""
    from nsdp_tpu_torch.data.datasets import Deform4DFlowDataset
    from nsdp_tpu_torch.data.synthetic import deform_frame, icosphere, synthetic_config
    from nsdp_tpu_torch.preprocess.anime import anime_write
    from nsdp_tpu_torch.utils import meshio

    verts, faces = icosphere(PRE_SUBDIVISIONS)
    seqs = []
    for ident in range(2):
        frames = [deform_frame(verts, t / (PRE_FRAMES - 1), ident) for t in range(PRE_FRAMES)]
        os.makedirs(os.path.join(root, "raw", f"id{ident}"))
        anime_write(os.path.join(root, "raw", f"id{ident}", f"id{ident}_walk.anime"), frames[0],
                    faces, np.stack([f - frames[0] for f in frames[1:]]))
        seqs.append(f"id{ident}_walk")
    with open(os.path.join(root, "templates.lst"), "w") as f:
        f.write("\n".join(seqs) + "\n")
    p = lambda *parts: os.path.join(root, *parts)
    times = {"anime": preprocess_cli(root, "anime", "--in_folder", p("raw"), "--mesh_folder",
                                     p("meshes"))}
    deform4d = ["--input_mesh_dir", p("meshes"), "--temp_lst", p("templates.lst"), "--seed", "0"]
    times["deform4d"] = preprocess_cli(root, "deform4d", *deform4d, "--output_data_dir",
                                       p("deform4d"))
    times["nocorr"] = preprocess_cli(root, "nocorr", "--input_mesh_dir", p("meshes"),
                                     "--output_data_dir", p("nocorr"), "--mesh_format", "obj")
    for method in ("sdf", "poisson"):
        # the first frame of each sequence only (depth cut): at the default
        # --watertight_spacing 0.02 one frame's SDF takes about a minute
        times[f"watertight {method}"] = preprocess_cli(
            root, "deform4d", *deform4d, "--output_data_dir", p(f"watertight_{method}"),
            "--make_watertight", "--watertight_method", method, "--interval", str(PRE_FRAMES))
        n_frames = 0
        for seq in seqs:
            for frame in sorted(os.listdir(p(f"watertight_{method}", seq))):
                w_faces = meshio.load_mesh(p(f"watertight_{method}", seq, frame,
                                             "model_watertight.ply"))[1]
                edges = np.sort(np.concatenate([w_faces[:, [0, 1]], w_faces[:, [1, 2]],
                                                w_faces[:, [2, 0]]]), 1)
                _, per_edge = np.unique(edges, axis=0, return_counts=True)
                if len(w_faces) == 0 or not (per_edge == 2).all():
                    fail(f"watertight {method}: {seq}/{frame} is not closed")
                n_frames += 1
        if n_frames != len(seqs):
            fail(f"watertight {method}: {n_frames} frames written, expected {len(seqs)}")
        log(f"host tools: watertight {method}: {n_frames} frames, each closed")

    split_dir = p("splits", "deform4d")
    os.makedirs(split_dir)
    for split in ("identity_seen", "train_seen", "test_unseen_motions"):
        with open(os.path.join(split_dir, f"{split}.lst"), "w") as f:
            f.write("\n".join(seqs) + "\n")
    cfg = synthetic_config({"dataset_dir": p("deform4d"), "split_dir": p("splits")},
                           n_surface=5000, n_space=5000)
    ds = Deform4DFlowDataset(cfg, "identity_seen", "test_unseen_motions", load_mesh=True,
                             rng=np.random.RandomState(0))
    n_per_seq = -(-PRE_FRAMES // 3)  # deform4d's default interval 3
    if len(ds) != 2 * n_per_seq:
        fail(f"Deform4DFlowDataset read {len(ds)} pairs, expected {2 * n_per_seq}")
    item = ds[len(ds) - 1]
    check_output(item["surface_samples_inputs"], (5000, 7), "preprocessed surface samples")
    check_output(item["space_samples_src"], (5000, 3), "preprocessed space samples")
    check_output(item["verts_src"], (len(verts), 3), "preprocessed mesh")
    log(f"host tools: Deform4DFlowDataset read the deform4d output: {len(ds)} pairs, finite,"
        f" of the expected shapes; commands {', '.join(f'{k} {v:.1f} s' for k, v in times.items())}"
        f" ({os.cpu_count()} CPUs, the default --max_threads / --n_proc -1: spawn pools); {card}")


def host_tools(card, native_build):
    """Phase 9: the host tools on the card's machine -- the native build
    (phase 1's time), its NN query against scipy, the mesher, and the
    preprocessing entry point as subprocesses."""
    import tempfile

    t_phase = time.perf_counter()
    log(f"host tools: {native_build} (phase 1); {card}")
    check_nn_query(card)
    check_mesher(card)
    with tempfile.TemporaryDirectory() as root:
        check_preprocess(root, card)
    log(f"host tools: phase 9 took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------- phase 10

# (label, model type, model keys, nan_guard) of the train steps held
# captured against eager; all but nan_guard's also timed in turns
GRAPH_STEP_RUNS = [("forward", "forward", {}, False), ("arbitrary", "arbitrary", {}, False),
                   ("forward bf16", "forward", {"compute_dtype": "bfloat16"}, False),
                   ("arbitrary bf16", "arbitrary", {"compute_dtype": "bfloat16"}, False),
                   ("arbitrary remat", "arbitrary", {"remat": True}, False),
                   ("forward nan_guard", "forward", {}, True)]
GRAPH_CHECK_STEPS = 5  # replayed steps of each run; held at the first and the last


def turns(torch, fns, order, reps):
    """Host-clock ms of ``reps`` synchronised calls of ``fns[key]`` per
    entry of ``order`` (keys in turns, e.g. captured, eager, eager,
    captured) -> each key's median over its turns."""
    times = {k: [] for k in fns}
    for key in order:
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[key]()
            torch.cuda.synchronize()
            times[key].append((time.perf_counter() - t0) * 1e3)
    return {k: float(np.median(v)) for k, v in times.items()}


def hold_captured(torch, what, got, want, replay, eager):
    """A captured output against the eager one on the same inputs: bit for
    bit -- or, where the replay's cuBLAS kernels differ from the eager
    run's (another algorithm under capture), within serving's rule against
    float32 (``E2E_TOL``), with the kernels named.  -> None (bit for bit)
    or the differing kernels."""
    import collections

    if np.array_equal(got, want):
        return None
    kernels = []
    for fn in (replay, eager):
        _, events = profiled(torch, fn)
        kernels.append(collections.Counter(kernel_name(e.name) for e in events))
    differ = sorted(((kernels[0] - kernels[1]) + (kernels[1] - kernels[0])).keys())
    if not differ or not all("gemm" in k for k in differ):
        fail(f"{what}: the captured output differs from the eager one (max abs"
             f" {float(np.abs(got - want).max()):.3g}) with the same kernels but {differ}")
    if not np.allclose(got, want, **E2E_TOL):
        fail(f"{what}: captured against eager max abs {float(np.abs(got - want).max()):.3g}"
             f" beyond rtol 1e-3 / atol 2e-4 (cuBLAS under capture: {differ})")
    log(f"graphs: {what}: not bit for bit; cuBLAS picks other kernels under capture ({differ});"
        f" within rtol 1e-3 / atol 2e-4 (max abs {float(np.abs(got - want).max()):.3g})")
    return differ


def warmed_service(torch, config, n, graphs, state_dict=None):
    """A service warmed at ``n`` surface points -> (service, warm-up s,
    peak MB above the memory held before it, MB it holds after)."""
    import gc

    from nsdp_tpu_torch.serving import DeformationService

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    svc = DeformationService(config, device="cuda", seed=0, graphs=graphs, state_dict=state_dict)
    t0 = time.perf_counter()
    svc.warmup(n)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    return (svc, warm_s, (torch.cuda.max_memory_allocated() - base) / 1e6,
            (torch.cuda.memory_allocated() - base) / 1e6)


def serving_against_eager(torch, rng, surf, config, label, card):
    """Phase 10a: a captured service against an eager one with the same
    weights, each warmed alone (capture time, memory): ``deform`` at every
    bucket, plain and masked, bit for bit; two edit sessions at one bucket
    with their drags interleaved (the first's drags unchanged bit for bit)
    and a masked one; each program's kernels in one replay; then an
    evaluation at Q = 65,536 and a drag at 20,000 in turns, and one of
    each traced.  -> the captured service's model."""
    n = surf.shape[0]
    handle = (surf[:, 2] > 0.8).astype(np.float32)[:, None]
    tgt = (surf + np.array([0.25, 0.0, 0.1], np.float32)) * handle
    inputs = np.concatenate([surf, tgt, handle], -1)
    pm = np.ones(n, np.float32)
    pm[-500:] = 0.0
    eager, warm_e, peak_e, held_e = warmed_service(torch, config, n, False)
    cap, warm_c, peak_c, held_c = warmed_service(torch, config, n, None,
                                                 eager.model.state_dict())
    programs = cap.graphs[0].programs
    log(f"graphs: serving {label}: warmup {warm_c:.2f} s captured ({len(programs)} programs)"
        f" against {warm_e:.2f} s eager; peak memory above the model {peak_c:.1f} MB against"
        f" {peak_e:.1f} MB, held after it {held_c:.1f} MB against {held_e:.1f} MB ({card})")
    fallbacks = []
    for b in cap.buckets:
        pts = rng.uniform(-1.3, 1.3, (b - 100, 3)).astype(np.float32)
        for mask in (None, pm):
            inp = inputs if mask is None else inputs * mask[:, None]
            run = lambda s: s.deform(pts, inp, point_mask=mask)
            fallbacks.append(hold_captured(torch, f"{label} deform Q={b - 100}"
                                           f"{' masked' if mask is not None else ''}",
                                           run(cap), run(eager), lambda: run(cap),
                                           lambda: run(eager)))
    pts, pts2 = (rng.uniform(-1.3, 1.3, (20000, 3)).astype(np.float32) for _ in range(2))
    surf2 = surf * np.float32(0.9) + np.float32(0.05)
    s1, e1 = cap.edit_session(pts, surf), eager.edit_session(pts, surf)
    first = s1.drag(tgt, handle)
    fallbacks.append(hold_captured(torch, f"{label} session 1 drag", first, e1.drag(tgt, handle),
                                   lambda: s1.drag(tgt, handle), lambda: e1.drag(tgt, handle)))
    s2, e2 = cap.edit_session(pts2, surf2), eager.edit_session(pts2, surf2)
    fallbacks.append(hold_captured(torch, f"{label} session 2 drag", s2.drag(tgt * 0.5, handle),
                                   e2.drag(tgt * 0.5, handle), lambda: s2.drag(tgt * 0.5, handle),
                                   lambda: e2.drag(tgt * 0.5, handle)))
    if not np.array_equal(s1.drag(tgt, handle), first):
        fail(f"{label}: a second session at the same bucket changed the first one's drag")
    fallbacks.append(hold_captured(torch, f"{label} session 1 second drag",
                                   s1.drag(tgt * 0.5, handle), e1.drag(tgt * 0.5, handle),
                                   lambda: s1.drag(tgt * 0.5, handle),
                                   lambda: e1.drag(tgt * 0.5, handle)))
    masked = surf * pm[:, None]
    s3, e3 = cap.edit_session(pts, masked, pm), eager.edit_session(pts, masked, pm)
    fallbacks.append(hold_captured(torch, f"{label} masked session drag", s3.drag(tgt, handle),
                                   e3.drag(tgt, handle), lambda: s3.drag(tgt, handle),
                                   lambda: e3.drag(tgt, handle)))
    same = sum(f is None for f in fallbacks)
    log(f"graphs: serving {label}: captured against eager, {same} of {len(fallbacks)} outputs bit"
        f" for bit (every bucket, plain and masked; sessions and drags), the first session's drag"
        f" unchanged bit for bit after a second session at its bucket")
    rows = []
    for (name, sig), program in sorted(programs.items(), key=lambda kv: (kv[0][0],
                                                                       kv[0][1][0][0][1])):
        got = replay_launches(cap.graphs[0], program)
        rows.append(f"{name} {sig[0][0][1]}{' masked' if sig[-1] is not None else ''}:"
                    f" {'/'.join(map(str, got))} of {len(graph_kernels(program))}")
    log(f"graphs: serving {label}: per replay of each program, K1/K2/K3/K4/gather launches of"
        f" all its graph's kernel nodes: {'; '.join(rows)}")
    q65 = rng.uniform(-1.3, 1.3, (65536, 3)).astype(np.float32)
    svc = {"captured": cap, "eager": eager}
    order = ("captured", "eager", "eager", "captured")
    evals = turns(torch, {k: (lambda s=s: s.deform(q65, inputs)) for k, s in svc.items()},
                  order, 5)
    sessions = {"captured": s1, "eager": e1}
    drags = turns(torch, {k: (lambda s=s: s.drag(tgt * 0.7, handle))
                          for k, s in sessions.items()}, order, 5)
    busy = {k: trace(torch, lambda s=s: s.deform(q65, inputs), evals[k],
                     f"graphs: one {label} evaluation at Q=65536 ({k})", s.graphs)
            for k, s in svc.items()}
    drag_busy = {k: trace(torch, lambda s=s: s.drag(tgt * 0.7, handle), drags[k],
                          f"graphs: one {label} drag at Q=20000 ({k})", svc[k].graphs)
                 for k, s in sessions.items()}
    log(f"graphs: serving {label} in turns (captured, eager, eager, captured; medians of 10):"
        f" evaluation at Q=65536 {evals['captured']:.2f} ms captured against"
        f" {evals['eager']:.2f} ms eager (device busy {busy['captured']:.2f} / {busy['eager']:.2f}"
        f" ms, idle {100 * (1 - busy['captured'] / evals['captured']):.1f}% /"
        f" {100 * (1 - busy['eager'] / evals['eager']):.1f}%); drag at Q=20000"
        f" {drags['captured']:.2f} ms against {drags['eager']:.2f} ms (busy"
        f" {drag_busy['captured']:.2f} / {drag_busy['eager']:.2f} ms) ({card})")
    model = cap.model
    del eager, cap, svc, s1, s2, s3, e1, e2, e3, sessions
    torch.cuda.empty_cache()
    return model


def replicas_against_eager(torch, rng, surf, config, label):
    """Phase 10a, ``devices=``: two replicas on the one card
    (``devices=("cuda:0", "cuda:0")``, each with its own programs and
    memory pool), captured, against the same two replicas eager with the
    same weights: ``deform`` at every bucket, plain and masked, and two
    edit sessions at one bucket with their drags interleaved, bit for bit;
    every replayed call launches twice ``SERVE_LAUNCHES[label]`` (each
    replica encodes the surface and decodes its half of the queries)."""
    from nsdp_tpu_torch.serving import DeformationService

    devices = ("cuda:0", "cuda:0")
    cap = DeformationService(config, devices=devices, seed=0)
    eager = DeformationService(config, devices=devices, state_dict=cap.model.state_dict(),
                               graphs=False)
    n = surf.shape[0]
    cap.warmup(n)
    handle = (surf[:, 2] > 0.8).astype(np.float32)[:, None]
    tgt = (surf + np.array([0.25, 0.0, 0.1], np.float32)) * handle
    inputs = np.concatenate([surf, tgt, handle], -1)
    pm = np.ones(n, np.float32)
    pm[-500:] = 0.0
    want = {k: tuple(2 * x for x in v) for k, v in SERVE_LAUNCHES[label].items()}

    def same(what, fn, entry):
        before = counts()
        got, names = replays(cap.graphs, lambda: fn(cap))
        expect_launches(before, (0,) * 5, f"{what}: the wrappers under replay")
        expect_replay(launch_counts(names), want[entry], what)
        if not np.array_equal(got, fn(eager)):
            fail(f"{what}: the captured output differs from the eager one")
        return got

    for b in cap.buckets:
        pts = rng.uniform(-1.3, 1.3, (b - 100, 3)).astype(np.float32)
        for mask in (None, pm):
            inp = inputs if mask is None else inputs * mask[:, None]
            same(f"{label} on two replicas: deform Q={b - 100}",
                 lambda s: s.deform(pts, inp, point_mask=mask), "deform")
    pts, pts2 = (rng.uniform(-1.3, 1.3, (20000, 3)).astype(np.float32) for _ in range(2))
    s1 = replays(cap.graphs, lambda: cap.edit_session(pts, surf))[0]
    e1 = eager.edit_session(pts, surf)
    first = same(f"{label} on two replicas: session 1 drag",
                 lambda s: (s1 if s is cap else e1).drag(tgt, handle), "drag")
    s2, e2 = cap.edit_session(pts2, surf * np.float32(0.9)), eager.edit_session(
        pts2, surf * np.float32(0.9))
    same(f"{label} on two replicas: session 2 drag",
         lambda s: (s2 if s is cap else e2).drag(tgt * 0.5, handle), "drag")
    if not np.array_equal(s1.drag(tgt, handle), first):
        fail(f"{label} on two replicas: a second session at the same bucket changed the first"
             f" one's drag")
    log(f"graphs: serving {label} on two replicas of one card (devices=): captured against eager,"
        f" deform at every bucket plain and masked and two interleaved sessions' drags bit for"
        f" bit, the first session's drag unchanged after the second; each replayed call"
        f" {' / '.join(map(str, want['deform']))} (deform) and"
        f" {' / '.join(map(str, want['drag']))} (drag) K1 / K2 / K3 / K4 / gather kernel nodes,"
        f" twice one replica's")
    del cap, eager, s1, s2, e1, e2
    torch.cuda.empty_cache()


def predict_against_eager(torch, model, rng, surf, card):
    """Phase 10b: ``predict`` of the shipped model at Q = 65,536 through a
    captured program (``graphs.Graphs``), float32 and
    ``compute_dtype=torch.bfloat16``, against the eager calls: bit for
    bit, then timed in turns and one of each captured traced."""
    from nsdp_tpu_torch.graphs import Graphs

    graphs = Graphs("cuda")
    handle = (surf[:, 2] > 0.8).astype(np.float32)[:, None]
    inputs = np.concatenate([surf, (surf + np.float32(0.25)) * handle, handle], -1)
    pts = torch.from_numpy(rng.uniform(-1.3, 1.3, (1, 65536, 3)).astype(np.float32))
    inp = torch.from_numpy(inputs[None])
    bf16 = lambda a, b: model.predict(a, b, compute_dtype=torch.bfloat16)
    fns = {"captured f32": lambda: graphs("f32", model.predict, pts, inp).cpu(),
           "captured bf16": lambda: graphs("bf16", bf16, pts, inp).cpu(),
           "eager bf16": lambda: bf16(pts.cuda(), inp.cuda()).cpu(),
           "eager f32": lambda: model.predict(pts.cuda(), inp.cuda()).cpu()}
    with torch.inference_mode():
        outs = {k: f().numpy() for k, f in fns.items()}
        for dtype in ("f32", "bf16"):
            hold_captured(torch, f"predict {dtype}", outs[f"captured {dtype}"],
                          outs[f"eager {dtype}"], fns[f"captured {dtype}"], fns[f"eager {dtype}"])
        order = list(fns) + list(fns)[::-1]
        ms = turns(torch, fns, order, 5)
        busy = {k: trace(torch, fns[k], ms[k], f"graphs: predict at Q=65536, {k}", [graphs])
                for k in ("captured f32", "captured bf16")}
    log(f"graphs: predict at Q=65536 in turns (medians of 10): "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in ms.items())
        + f"; captured bf16 against captured f32 {ms['captured bf16'] - ms['captured f32']:+.2f} ms"
        f" (device busy {busy['captured bf16']:.2f} against {busy['captured f32']:.2f} ms);"
        f" captured outputs bit for bit the eager ones ({card})")


def bitwise(torch, a, b) -> bool:
    """Equal bit for bit, NaNs at the same places counting as equal (and
    two Nones)."""
    if a is None or b is None:
        return a is b
    nan = a.isnan()
    return torch.equal(nan, b.isnan()) and torch.equal(a[~nan], b[~nan])


def step_state(model, loss):
    """A step's loss and copies of the model's buffers, gradients (None
    after a ``nan_guard`` skip) and parameters."""
    return dict(loss=loss, buffers=[b.clone() for b in model.buffers()],
                grads=[None if p.grad is None else p.grad.clone() for p in model.parameters()],
                params=[p.detach().clone() for p in model.parameters()])


def hold_step(torch, what, cap, eager, again):
    """A replayed step against an eager one from the same state: the loss
    and every buffer bit for bit; each gradient and parameter bit for bit
    or, where K2's float64 atomics reorder, within phase 4b's rule against
    a second eager step's own gap -> (tensors not bit for bit, largest
    ratio)."""
    if not (cap["loss"] == eager["loss"] or (np.isnan(cap["loss"]) and np.isnan(eager["loss"]))):
        fail(f"{what}: loss {cap['loss']!r} captured against {eager['loss']!r} eager")
    if not all(bitwise(torch, a, b) for a, b in zip(cap["buffers"], eager["buffers"])):
        fail(f"{what}: a BatchNorm buffer differs from the eager step's")
    reordered, worst = 0, 0.0
    for key in ("grads", "params"):
        for i, (c, e, q) in enumerate(zip(cap[key], eager[key], again[key])):
            if bitwise(torch, c, e):
                continue
            reordered += 1
            err, noise = rel_err(c, e), rel_err(q, e)
            limit = max(REMAT_RULE["factor"] * noise, REMAT_RULE["floor"])
            worst = max(worst, err / limit)
            if not err <= limit:
                fail(f"{what}: {key} {i}: relative L2 gap {err:.3g} beyond {limit:.3g} (two eager"
                     f" steps differ by {noise:.3g})")
    return reordered, worst


def hold_replayed_step(torch, what, model, opt, step, twins, batch, lr):
    """A captured ``step`` on ``batch`` against the eager steps of two
    ``twins`` (``train_setup``'s tuples) loaded with its model's and
    optimizer's state before it: :func:`hold_step` -> (its result, the
    captured step's loss)."""
    import copy

    state = {n: t.clone() for n, t in model.state_dict().items()}
    opt_state = copy.deepcopy(opt.state_dict())
    loss = step(batch, lr)
    got = step_state(model, loss)
    held = []
    for _, m, _, o, st in twins:
        m.load_state_dict(state)
        o.load_state_dict(copy.deepcopy(opt_state))
        held.append(step_state(m, st["train_step"](batch, lr)))
    return hold_step(torch, what, got, *held), loss


def steps_against_eager(torch, card):
    """Phase 10c: per run of ``GRAPH_STEP_RUNS`` (stage 1 and 2, bf16,
    remat, ``nan_guard`` with a NaN target in the third replayed batch), a
    captured step sequence -- its eager first step, the capture, 4 more
    replays -- and at the capture, at the NaN step and at the last step two
    eager twins loaded with the captured run's state (model and optimizer)
    take the same batch: ``hold_step``.  Then the captured and the eager
    step timed in turns, phase 3b's way."""
    rs = np.random.RandomState(23)
    for label, model_type, model_kw, nan_guard in GRAPH_STEP_RUNS:
        want = REMAT_LAUNCHES if model_kw.get("remat") else TRAIN_LAUNCHES[model_type]
        cfg = shipped_config(model_type, **model_kw)
        B = cfg["training"]["batch_size"]
        _, model, schedule, opt, steps = train_setup(torch, model_type, 0, cfg=cfg,
                                                     nan_guard=nan_guard)
        twins = [train_setup(torch, model_type, 0, cfg=cfg, nan_guard=nan_guard, graphs=False)
                 for _ in range(2)]
        lr = schedule.get_learning_rate(0)
        batches = [train_batch(rs, B, 5000, 5000) for _ in range(GRAPH_CHECK_STEPS + 1)]
        checks = {1, GRAPH_CHECK_STEPS}
        if nan_guard:
            batches[3]["space_samples_tgt"][0, 0, 0] = np.nan
            checks.add(3)
        steps["train_step"](batches[0], lr)  # the eager first step
        reordered, worst = 0, 0.0
        for k in range(1, GRAPH_CHECK_STEPS + 1):
            if k not in checks:
                steps["train_step"](batches[k], lr)
                continue
            (r, w), loss = hold_replayed_step(torch, f"graphs: {label} step {k + 1}", model, opt,
                                              steps["train_step"], twins, batches[k], lr)
            reordered, worst = reordered + r, max(worst, w)
            if nan_guard and k == 3 and not np.isnan(loss):
                fail(f"{label}: the NaN batch's loss is {loss}")
        n = 2 * len(list(model.parameters())) * len(checks)
        line = (f"graphs: {label} (B={B}) train steps captured against eager from the same state"
                f" at steps {sorted(k + 1 for k in checks)}: losses and every BatchNorm buffer bit"
                f" for bit, {n - reordered} of {n} gradients and parameters bit for bit, the other"
                f" {reordered} (K2's float64 atomics) within phase 4b's rule, largest ratio"
                f" {worst:.3g}")
        graphs = steps["train_step"].graphs
        (program,) = step_programs(graphs)
        got = replay_launches(graphs, program)
        expect_replay(got, want, f"graphs: {label} step")
        line += (f"; a replay of the step's graph: {'/'.join(map(str, got))} K1/K2/K3/K4/gather"
                 f" of its {len(graph_kernels(program))} kernel nodes")
        if not nan_guard:
            fns = {"captured": lambda: steps["train_step"](batches[1], lr),
                   "eager": lambda: twins[0][4]["train_step"](batches[1], lr)}
            ms = turns(torch, fns, ("captured", "eager", "eager", "captured"), TRAIN_STEPS)
            line += (f"; in turns (captured, eager, eager, captured; medians of"
                     f" {2 * TRAIN_STEPS}) {ms['captured']:.2f} ms captured against"
                     f" {ms['eager']:.2f} ms eager")
        log(line + f" ({card})")
        del model, opt, steps, twins
        torch.cuda.empty_cache()


def train_memory(torch, card):
    """Phase 10d: peak memory of three steps (eager first, capture, replay)
    of the stage-1 ``forward`` (B = 16) and stage-2 ``arbitrary`` (B = 8)
    steps, each model alone, captured and eager, and what stays held; then
    of the same run after three calls each of ``validate_step_masked`` (at
    the validation batch) and ``watch_stats`` (at the train batch): their
    first call eager, the second captured, the third replayed, into the
    step's pool, as in a run of ``train``.  "Held" is the live tensors (``memory_allocated``); a
    graph's pool keeps its intermediates' blocks reserved for its replays
    beyond them, so each row also gives what stays reserved after
    ``empty_cache`` (the pools and the held tensors) and the peak
    reserved."""
    import gc

    rs = np.random.RandomState(29)
    rows = []
    for model_type in ("forward", "arbitrary"):
        for graphs in (False, None):
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base, base_reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
            cfg, model, schedule, opt, steps = train_setup(torch, model_type, 0, graphs=graphs)
            B, B_val = cfg["training"]["batch_size"], cfg["validation"]["batch_size"]
            torch.cuda.reset_peak_memory_stats()
            for _ in range(3):
                steps["train_step"](train_batch(rs, B, 5000, 5000), schedule.get_learning_rate(0))
            torch.cuda.synchronize()
            gb = lambda x, b=base: f"{(x - b) / 1e9:.2f} GB"

            def memory():
                peak, held = torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated()
                peak_reserved = torch.cuda.max_memory_reserved()
                torch.cuda.empty_cache()
                return (f"peak {gb(peak)}, held {gb(held)}, reserved"
                        f" {gb(torch.cuda.memory_reserved(), base_reserved)} (peak"
                        f" {gb(peak_reserved, base_reserved)})")

            row = f"{model_type} (B={B}) {'captured' if graphs is None else 'eager'}: steps {memory()}"
            val, watch = train_batch(rs, B_val, 5000, 5000), train_batch(rs, B, 5000, 5000)
            mask = np.ones(B_val, np.float32)
            mask[-1] = 0.0
            for _ in range(3):
                steps["validate_step_masked"](val, mask)
                steps["watch_stats"](watch)
            torch.cuda.synchronize()
            evaluation = steps["validate_step_masked"].graphs
            programs = "" if evaluation is None else f" (all: {evaluation.describe()})"
            rows.append(f"{row}; with validation (B={B_val}) and watch_stats{programs} {memory()}")
            del model, opt, steps, evaluation
    torch.cuda.empty_cache()
    log(f"graphs: training memory, each model alone: {'; '.join(rows)} ({card})")


# (K1, K2, K3, K4, gather) launches of one call of each evaluation program
# of the shipped stage-2 model: a full evaluation; watch_stats a train
# step's forward and backward
EVAL_LAUNCHES = {"validate_step": (17, 0, 4, 0, 0), "validate_step_masked": (17, 0, 4, 0, 0),
                 "watch_stats": (17, 17, 4, 0, 0), "predict": (17, 0, 4, 0, 0)}


def evaluation_against_eager(torch, card):
    """Phase 10e: ``make_steps``' evaluation programs of the shipped
    stage-2 model (weights with O(1) outputs, as phase 5's) against the
    eager steps on the same weights, at ``train``'s validation batch (B =
    8, N = Q = 5000; masked with a padded last row) and ``test``'s shapes
    (``predict`` on a pair's 5000 surface samples and on its 40,962
    vertices padded to 45,056): every output bit for bit (``watch_stats``'
    gradient norms by phase 10c's rule where K2's float64 atomics reorder),
    a held ``predict`` output unchanged by the next call, the model
    unchanged; each program's kernel nodes exactly its eager launches, the
    counters still under replay; each program timed in turns against the
    eager call."""
    from nsdp_tpu_torch.utils.padding import next_bucket

    cfg, model, _, opt, steps = train_setup(torch, "arbitrary", 0, out_scale=MP_OUT_SCALE)
    eager = train_setup(torch, "arbitrary", 0, out_scale=MP_OUT_SCALE, graphs=False)[4]
    rs = np.random.RandomState(37)
    B = cfg["validation"]["batch_size"]
    batch = train_batch(rs, B, 5000, 5000)
    sample_mask = np.ones(B, np.float32)
    sample_mask[-1] = 0.0
    surface = train_batch(rs, 1, 5000, 16)["surface_samples_inputs"]
    verts = rs.uniform(-1, 1, (1, next_bucket(40962), 3)).astype(np.float32)
    norms = lambda out: np.concatenate([out[0][1], out[1][1]])
    calls = {
        "validate_step": lambda s: s["validate_step"](batch),
        "validate_step_masked": lambda s: s["validate_step_masked"](batch, sample_mask),
        "watch_stats": lambda s: norms(s["watch_stats"](batch)),
        "predict surface": lambda s: s["predict"](surface[..., 0:3], surface).cpu().numpy(),
        "predict vertices": lambda s: s["predict"](verts, surface).cpu().numpy(),
    }
    state = {k: v.clone() for k, v in model.state_dict().items()}
    graphs = steps["predict"].graphs
    for call in calls.values():  # an eager call, then the capture
        for _ in range(2):
            call(steps)
    held = steps["predict"](surface[..., 0:3], surface)
    first = held.clone()
    steps["predict"](verts, surface)
    if not torch.equal(held, first):
        fail("10e: a held predict output changed under the next call")
    rows, reordered = [], []
    for name, call in calls.items():
        before = counts()
        got, nodes = replays([graphs], lambda: call(steps))
        expect_launches(before, (0,) * 5, f"10e: {name} replayed, the wrappers")
        expect_replay(launch_counts(nodes), EVAL_LAUNCHES[name.split()[0]], f"10e: {name}")
        want = call(eager)
        if not np.array_equal(got, want):
            again = call(eager)
            err, noise = rel_err(torch.as_tensor(got), torch.as_tensor(want)), rel_err(
                torch.as_tensor(again), torch.as_tensor(want))
            if name != "watch_stats" or err > max(REMAT_RULE["factor"] * noise, REMAT_RULE["floor"]):
                fail(f"10e: {name}: captured against eager relative L2 {err:.3g} (two eager"
                     f" calls {noise:.3g})")
            reordered.append(f"{name} within phase 4b's rule ({err:.3g}; eager twice {noise:.3g})")
        rows.append(f"{name} {'/'.join(map(str, launch_counts(nodes)))} of {len(nodes)}")
    for k, v in model.state_dict().items():
        if not torch.equal(v, state[k]):
            fail(f"10e: the evaluation programs changed {k}")
    ms = {}
    for name, call in calls.items():
        t = turns(torch, {"captured": lambda: call(steps), "eager": lambda: call(eager)},
                  ("captured", "eager", "eager", "captured"), 3)
        ms[name] = f"{name} {t['captured']:.2f} / {t['eager']:.2f} ms"
    log(f"graphs: evaluation programs (shipped stage-2 model, validation B={B} at N = Q = 5000,"
        f" test's predict at 5000 surface points and {verts.shape[1]} padded vertices):"
        f" {graphs.describe()}; every output bit for bit the eager one"
        f"{' but ' + '; '.join(reordered) if reordered else ''}, a held predict output unchanged"
        f" by the next call, the model unchanged; K1/K2/K3/K4/gather of each replay's kernel nodes:"
        f" {'; '.join(rows)}; captured / eager in turns (medians of 6): {'; '.join(ms.values())}"
        f" ({card})")
    del model, opt, steps, eager
    torch.cuda.empty_cache()


def graphs_phase(torch, card):
    """Phase 10: every captured program against its eager run on the card,
    and timed against it in turns."""
    from nsdp_tpu_torch.utils.config import load_config

    t_phase = time.perf_counter()
    rng = np.random.RandomState(31)
    surf = surface(rng, 5000)
    for label, config in (("shipped", load_config(CONFIG)), ("A", ablation_config("A"))):
        model = serving_against_eager(torch, rng, surf, config, label, card)
        if label == "shipped":
            replicas_against_eager(torch, rng, surf, config, label)
            predict_against_eager(torch, model, rng, surf, card)
        del model
    steps_against_eager(torch, card)
    evaluation_against_eager(torch, card)
    train_memory(torch, card)
    log(f"graphs: phase 10 took {time.perf_counter() - t_phase:.1f} s")


# phase 11: the bench's metrics run (child mode), each with the kernels its
# process must have launched (eager runs and captures; replays do not count)
BENCH_METRICS = (("qps", "query points/s", ("K1", "K3")), ("drag_ms", "ms", ("K1", "K3")),
                 ("train_step_ms_stage2_b8", "ms", ("K1", "K2", "K3")))
BENCH_TIMEOUT = 300  # seconds for one metric's process


def bench_phase(card):
    """Phase 11: ``python -m nsdp_tpu_torch.bench --metric NAME`` (one
    measurement, ``NSDP_BENCH_REPEATS=1``) for the headline, the drag and
    the stage-2 step, each in a process of its own as the bench runs it: its
    line parses, its value is finite and positive, and its process launched
    the kernels of its path."""
    t_phase = time.perf_counter()
    env = dict(os.environ, NSDP_BENCH_REPEATS="1")
    for name, unit, kernels in BENCH_METRICS:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "nsdp_tpu_torch.bench", "--metric", name],
                              cwd=REPO, env=env, capture_output=True, text=True,
                              timeout=BENCH_TIMEOUT)
        if proc.returncode != 0:
            fail(f"bench --metric {name}: exit {proc.returncode}: {proc.stderr.strip()[-2000:]}")
        try:
            line = json.loads(proc.stdout.strip().splitlines()[-1])
        except (IndexError, json.JSONDecodeError):
            fail(f"bench --metric {name}: no JSON line in {proc.stdout[-500:]!r}")
        value = line.get("value")
        if (line.get("metric") != name or not isinstance(value, float) or not np.isfinite(value)
                or value <= 0):
            fail(f"bench --metric {name}: bad line {line}")
        idle = [k for k in kernels if not line.get("launches", {}).get(k)]
        if idle:
            fail(f"bench --metric {name}: {', '.join(idle)} never launched ({line.get('launches')})")
        log(f"bench: {name} {value!r} {unit} (one measurement), launches {line['launches']},"
            f" {time.perf_counter() - t0:.1f} s of process ({card})")
    log(f"bench: phase 11 took {time.perf_counter() - t_phase:.1f} s")


def rank_main(argv) -> None:
    """A rank of phase 7: ``--rank ROLE RANK WORLD PORT ARGS...``."""
    import torch

    sys.path.insert(0, REPO)
    from nsdp_tpu_torch import graphs

    graphs.KEEP_GRAPHS = True  # the launch checks read each graph's kernel nodes
    role, rank, world, port, *args = argv
    run = {"step": rank_step, "nccl": rank_nccl, "cli": rank_cli}[role]
    run(torch, int(rank), int(world), port, *args)
    torch.distributed.destroy_process_group()


def short_name(mangled: str) -> str:
    """``attn_mma16_kernel<8, 1>`` from a mangled kernel name: its
    length-prefixed names read in turn up to the one ending in
    ``_kernel``, then that name's integer template arguments."""
    i = 3 if mangled.startswith("_ZN") else 2 if mangled.startswith("_Z") else 0
    while True:
        m = re.match(r"\d+", mangled[i:])
        if m is None:
            return mangled
        i += m.end()
        name, i = mangled[i:i + int(m.group())], i + int(m.group())
        if name.endswith("_kernel"):
            args = re.match(r"I((?:Li-?\d+E)+)E", mangled[i:])
            return name + (f"<{', '.join(re.findall(r'Li(-?\d+)E', args.group(1)))}>"
                           if args else "")


# kernels whose products run on the tensor cores, by the instruction they
# must use: K2's row kernel on wgmma (HGMMA), K2's weight gradients and K1's
# narrow mode on mma.sync (HMMA)
TENSOR_CORE_KERNELS = {"bwd_rows_kernel": "HGMMA", "wgrad_kernel": "HMMA",
                       "attn_mma16_kernel": "HMMA"}


def report_build(build) -> None:
    """Phase 1's build lines: per kernel, ptxas's registers, shared memory
    and spills, and the count of tensor-core instructions in the library's
    SASS (``cuobjdump --dump-sass``), HGMMA and HMMA apart; fails if a
    kernel of ``TENSOR_CORE_KERNELS`` has none of its instruction."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name in build.SOURCES:
        fn = "?"
        for line in build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                fn = short_name(line.split("'")[1])
            elif "Used" in line or "spill" in line:
                log(f"  {name}: {fn}: {line.strip()}")
        sass = subprocess.run([cuobjdump, "--dump-sass", str(build.library_path(name))],
                              capture_output=True, text=True, timeout=300, check=True).stdout
        tc, fn = {}, None
        for line in sass.splitlines():
            if "Function : " in line:
                fn = short_name(line.split("Function : ")[1].strip())
                tc[fn] = {"HGMMA": 0, "HMMA": 0}
            elif fn is not None:
                for op in ("HGMMA", "HMMA"):
                    if op in line:
                        tc[fn][op] += 1
        log(f"  {name}: HGMMA / HMMA instructions by kernel: "
            + ", ".join(f"{k} {v['HGMMA']} / {v['HMMA']}" for k, v in sorted(tc.items())))
        for fn, n in tc.items():
            op = TENSOR_CORE_KERNELS.get(fn.split("<")[0])
            if op is not None and n[op] == 0:
                fail(f"{fn} has no {op} instruction")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    if not os.path.isdir(os.path.join(REPO, "nsdp_tpu_torch")) or not os.path.exists(CONFIG):
        fail("run from a checkout of the repository: nsdp_tpu_torch/ and configs/ are missing")
    sys.path.insert(0, REPO)
    from nsdp_tpu_torch import graphs
    from nsdp_tpu_torch.ops import _build
    from nsdp_tpu_torch.utils.config import load_config

    graphs.KEEP_GRAPHS = True  # the launch checks read each graph's kernel nodes

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    t0 = time.perf_counter()
    _build.build()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")
    report_build(_build)
    native_build = build_native()

    rng = np.random.RandomState(0)
    surf = surface(rng, 5000)
    rows = check_kernels(torch, rng, surf)
    rows["k4"] = check_knn(torch, rng, surf)
    rows["gather"] = check_gather(torch, rng, surf)
    rows["k2"] = check_backward(torch, rng, surf, *rows.pop("fps"))
    svc, launches = serve(torch, rng, surf, load_config(CONFIG), "shipped")
    check_reference(torch, svc, rng, surf, "shipped")
    del svc
    torch.cuda.empty_cache()
    f32_stats, train_launches = train(torch, rng, SHIPPED_RUNS)
    check_training_reference(torch, "shipped")
    svc, ablation_launches = serve(torch, rng, surf, ablation_config("A"), "A")
    check_reference(torch, svc, rng, surf, "A")
    del svc
    torch.cuda.empty_cache()
    train(torch, rng, ABLATION_RUNS)
    check_training_reference(torch, "A", ablation_config("A"), batch_seed=19)
    torch.cuda.empty_cache()
    # phase 10 before the later phases' profiling sessions: its busy times
    # come from torch.profiler, which lost records of graph replays late in
    # an earlier run of this script (PERF.md)
    graphs_phase(torch, card)
    entry_points(torch, rows, card)
    train_cli(torch, card)
    multi_process(torch, card)
    narrow_launches = narrow_and_remat(torch, rng, surf, f32_stats)
    host_tools(card, native_build)
    torch.cuda.empty_cache()
    bench_phase(card)

    k1 = kernel_entry("fused_knn_vector_attention", "nsdp_tpu_torch/csrc/attention.cu",
                      "nsdp_tpu/ops/attention_pallas.py:134", rows["k1"], launches[0])
    # the narrow-operand mode (compute_dtype), per evaluation of phase 8d
    k1["bf16"] = kernel_entry("fused_knn_vector_attention, compute_dtype=bfloat16",
                              "nsdp_tpu_torch/csrc/attention.cu",
                              "nsdp_tpu/ops/attention_pallas.py:134 (compute_dtype)",
                              rows["k1_bf16"], narrow_launches)
    k1["bf16"]["max_rel_l2_share"] = max(r["rel_l2"] / r["gap"] for r in rows["k1_bf16"])
    k1["bf16"]["bound_share"] = k1["bf16"]["bound_ms"] / k1["bf16"]["ms"]
    # the device's own time of those calls (the kernel split's sum; ms is the
    # call's, host dispatch included where it is longer)
    k1["bf16"]["device_ms"] = sum(r["device_ms"] * r["per_eval"] for r in rows["k1_bf16"])
    for r in rows["k1_f16"]:
        k1[f"f16_{r['site']}"] = {key: r[key] for key in
                                  ("ms", "device_ms", "plain_ms", "max_abs_err", "rel_l2", "gap")}
    if narrow_launches == 0:
        fail("the narrow mode of K1 was never launched on its main path")
    kernels = [
        k1,
        kernel_entry("fused_knn_vector_attention_backward", "nsdp_tpu_torch/csrc/attention_bwd.cu",
                     "nsdp_tpu/ops/attention_pallas.py:292", rows["k2"], train_launches[1]),
        kernel_entry("furthest_point_sample", "nsdp_tpu_torch/csrc/fps.cu",
                     "nsdp_tpu/ops/fps_pallas.py:32", rows["k3"], launches[2]),
        kernel_entry("knn", "nsdp_tpu_torch/csrc/knn.cu",
                     "nsdp_tpu/ops/knn_pallas.py:30", rows["k4"], ablation_launches[3]),
        kernel_entry("row_gather", "nsdp_tpu_torch/csrc/gather.cu",
                     "scripts/bench_gather_prefetch.py:42 and scripts/bench_gather_prefetch.py:83",
                     rows["gather"], ablation_launches[4]),
    ]
    for k in kernels:
        if k["launches"] == 0:
            fail(f"{k['name']} was never launched on the main path")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(sys.argv[2:])
    else:
        main()
