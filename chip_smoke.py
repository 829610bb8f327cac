#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

Run from the repository root: ``python3 chip_smoke.py``.  It needs one CUDA
card, builds the bitonic kernels from ``src/repro_torch/kernels/bitonic_sort/
csrc`` with nvcc (into ``build/``), and prints one JSON line per phase:

  build    the nvcc build of the kernels
  device   the card, its count, its name and power limit from nvidia-smi
  parity   every kernel against its plain torch version on the card, at
           8 rows x 2^21 keys, block_n 1024, MAX_BLOCK_N and 2 * MAX_BLOCK_N
           (A, B and their kv twins composed from launches at the cap), for
           float32, int32, float16 and bfloat16: compared bit for bit (B and
           B-kv at stages k = 2 * block_n, 4 * block_n and 2^21; C and C-kv
           at one substage and at a fused span of GLOBAL_SPAN substages)
  merge_runs  kernel M, one round of model B's merge tree, on 8 x 2^21 keys
           (rows of one pair at width 2^20, then the flat 2^24 at widths
           2^21, 2^22 and 2^23, each run sorted on its sort image), for the
           four key dtypes: bit for bit against its plain version and
           against rank_merge_pairs (the rounds it replaces); float32 ms per
           launch beside the 0.040 ms byte bound, its share, the plain
           version's ms and rank_merge_pairs' ms
  sort     repro_torch.sort of 10,000,000 float32 keys (model B, 8 tiles,
           local_impl="kernel"), both directions, against the plain bitonic
           network (bits) and torch.sort (values); kernel M merges all three
           rounds of the tree
  argsort  argsort / sort_kv of 10,000,000 duplicate-heavy int32 keys
           against torch.sort(stable=True), with an (n, 4) float32 payload
  topk     top-50 of (8, 151936) float32 logits with ties put in on purpose,
           impl="kernel" (kernel T, two launches) against impl="xla"
  topk_select  kernel T at the decode cell's shape, (128, 256000) float32
           logits rounded to bfloat16, k = 50, both directions: bit for bit
           against its plain version and impl="xla", two launches a call;
           ms per call over a pool of 4 batches (no call finds its logits in
           L2) beside the 0.039 ms byte bound, each launch's device ms, the
           plain version's ms, torch.topk's (library_ms, never called by the
           port), the whole engine.topk call's, the kv network it replaced,
           host ms a call and the call's peak memory
  cluster  model D (cluster_sort, local_impl="kernel", block_n 1024) on a
           one-rank NCCL group: 10,000,000 float32 keys in modes splitters,
           sample and radix, and 10,000,000 int32 keys in [0, 10^7) in the
           paper's decimal mode (digits 7, ten buckets); valid keys against
           the plain bitonic network (bits) and torch.sort (values), counts
           summing to n, retries and peak from the telemetry callback, time
           per call beside repro_torch.sort (model B) and torch.sort, launches
           per call, device time and idle share from torch.profiler
  cluster_kv  cluster_sort_kv, argsort(mesh=) and sort_kv(mesh=) with an
           (n, 4) float32 payload, of 10,000,000 duplicate-heavy int32 keys on
           the same group, against torch.argsort(stable=True)
  cluster_ranks  four ranks on the one card (spawned processes, a gloo group
           meeting through a FileStore under build/), 2,500,000 keys each:
           model D (splitters, sample, decimal) and model C with the kernels,
           and cluster_sort_kv, every rank's block checked against torch.sort /
           torch.argsort(stable=True) of the whole input; its times are those
           of gloo's host-staged wire, not of the exchange on NCCL.  Each rank
           also calls repro_torch.sort(x, mesh=group) five times on
           zipf-skewed keys (mode radix) through the default planner, whose
           plan file (REPRO_SORT_PLANS) the ranks share under build/, and
           runs one rank-coordinated Planner.autotune over two model-D
           candidates: every rank must hold the same plan and rank 0 alone
           writes the file
  block_n_sweep  the three paths' times at tile widths 1024, 4096, 16384
  paths    each path's time beside its library yardstick, and its device
           kernel time and idle share from torch.profiler; torch.sort of
           the 10M keys stable against unstable
  launch_host_us  host microseconds per wrapper call, back to back at a
           tiny shape (1 x 4096), where the device work is a few microseconds:
           the cost that bounds top-k
  tile_variants  kernels A, A-kv, B and B-kv at the main path's shapes
           under other launch geometries than _tile_geometry's (two tiles a
           block, the next E), each bit-equal to the default
  autotune a fresh Planner backed by build/serve/plans.json sweeps the full
           one-device grid (xla, bitonic, merge, kernel at block_n 256, 512
           and 1024) for int32 and float32 at buckets 4096, 2^20 and 2^24,
           reps 3: every candidate's microseconds and each cell's winner; a
           second Planner reloads the file and must hold the same plans
  serve    a SortService whose planner pins every cell to the reference's
           'pallas' plan mapped to the port's kernel plan (block_n 1024): a
           seeded ragged batch of 64 requests of 2^8 .. 2^22 int32 / float32
           keys (sort, argsort, sort_kv with an (n, 4) float32 payload,
           descending argsort), then one request of 10,000,000 keys, each
           result against np.sort / np.argsort(kind="stable"); the same
           traffic again builds no new cell and loads no library; requests/s,
           keys/s, cells built and hit, launches, device time and idle share
  queue    8 producer threads x 32 requests of 4096 int32 keys through an
           AsyncSortService (max_batch 16): every future right; fill ratio,
           queue-latency p50/p90/p99
  frontend a SortFrontend with tenants web (priority 0, weight 3) and batch
           (priority 1, weight 1), warmed over its batch ladder for the
           trace's buckets, replays make_trace(duration_s=5, rates web 200 /
           batch 50 a second, the reference's size mix 256 .. 4096, zipf_a
           1.2, seed 11) in real time, then the same trace at 20x the rates:
           every completed ticket against np.sort; p50/p95/p99 latency,
           SLO-met share, goodput, sheds by reason, the first request's
           latency beside the median
  nan_merge  repro_torch.sort (local_impl xla, merge, kernel) and
           engine.argsort (xla, kernel; both directions) of 1,000,003
           float32 keys a quarter of which are NaN of either sign, +-inf or
           +-0.0: no call raises or trips a device assert, xla / merge give
           the CPU path's bits, the kernel argsort xla's permutation; a
           top-50 of (8, 151936) such logits through the kernel: in-range
           indices, xla's indices and values; its time beside that of the
           float image (core.merge.sort_image) it ranks on, and the kernel
           argsort of those logits with and without the image, in 12
           alternating pairs (mean difference and its standard error)
  lm_serve the slice's main path: repro_torch.launch.serve.main decoding
           qwen3-0.6b at full size (28 layers, bf16, random weights from
           seed 0) for batch 8, prompt 128, 16 greedy tokens, on the direct
           route, --topk-queue and --tenants web:3:0,batch:1:1 --slo-ms 40
           --warmup, the service routes pinned to the reference's 'pallas'
           plan (the port's kernel plan, block_n 1024) for the vocabulary's
           cell by a plan file under build/ named in $REPRO_SORT_PLANS.
           serve.sample_next is wrapped to read each step's logits, time
           (host clock, ending in a synchronize), launches and batches.
           Checks: the same tokens on every route; each batch the service
           runs (and each cell it builds) launches A-kv 1, B-kv 8, C-kv 12;
           each step's top-16 from the kernel route equals numpy's stable
           argsort of -logits; prefill's and every decode step's logits
           against one forward over the same tokens (bf16: relative L2 at
           most 5 %, max abs at most 10 % of the largest logit); torch.profiler
           over one prefill, one decode step and one top-k step
  lm_moe   granite-moe-3b-a800m at full size (32 layers, 40 experts top-8,
           bf16) through prefill_step and 7 serve_decode_steps, batch 8,
           prompt 128, greedy, at loss-free capacity; logits against
           forward (as above); moe_aux finite, moe_overflow at the config's
           capacity factor 2.0 reported
  moe_serve serve.main --moe (the first step retries, none after); then
           moe_apply_adaptive at granite's MoE width (d_model 1536, d_ff
           512, 40 experts, top-8, float32, 4,096 tokens, collapsed router)
           through a plan file: call 1 retries, calls 2-5 and a reloaded
           planner's first call do not, every output within 1e-4 of a dense
           evaluation of the same top-k experts; moe_apply_local_adaptive on
           a one-rank NCCL group, plain and with the int8 wire (held against
           the dense evaluation of the dequantized rows); the exchange's
           token-row gathers at 6 KB rows, timed
  lm_train the training path: repro_torch.launch.train.main on qwen3-0.6b
           at full size (28 layers, bf16, f32 AdamW, random weights from
           seed 0), batch 8, seq 512, 8 steps at lr 1e-3, train_step
           wrapped to time each step (host clock, ending in a
           synchronize): loss and grad norm finite every step, the last
           loss below the first; tokens/s, peak memory, torch.profiler
           over one more step.  One float32 train_step of a two-layer
           full-width qwen3 on the card against the CPU's (TF32 off; loss
           and grad norm within 1e-4, the update per leaf within 1e-3
           relative L2).  The two-layer model in bf16 with checkpoints
           every 2 steps under build/lm_train/, clean and with a
           TrainingAnomaly injected at step 5: the replay's losses and
           final checkpoint equal the clean run's bit for bit.  granite's
           MoE width (4 of 32 layers, bf16, --moe-skew 6, --lr 0, which
           keeps the collapsed router collapsed) with --plans: drops on
           the first step only, the capacity rises once and holds; a
           float32 step of the same model, then serve --moe on the plan
           file starts at the learned factor (no retry on its first
           call).  The phase launches no sort kernel (checked)
  lm_mesh  train --mesh.  (a) One NCCL rank: lm_train's qwen3-0.6b run
           (full size, bf16, batch 8, seq 512, lr 1e-3, seed 0) on a
           (data=1, model=1) mesh for 6 steps: finite losses, step 1's
           within 1e-2 relative of lm_train's step 1 (same params and
           batch), ms a step beside lm_train's.  (b) Four spawned ranks
           share the card over gloo (host-staged; FileStore under
           build/lm_mesh/), (data=2, model=2): granite-moe-3b-a800m at full
           width (d_model 1536, 40 experts top-8, vocabulary 49155), 4
           layers, bf16, batch 8 x seq 512 (4,096 tokens), 3 steps: the
           same finite losses on every rank, each rank's param and moment
           bytes against the whole's, peak memory, MoE capacity / drops /
           peak a step; a float32 check at 2 layers (loss without the aux
           term and the global gradient norm at loss-free capacity, TF32
           off) within 1e-5 relative of one rank's on the card, no drops;
           a greedy decode of 4 tokens from a 64-token prompt on the mesh
           equal to one rank's.  Launches no sort kernel (checked)
  lm_tp    tensor parallelism over "model": four gloo ranks on the card,
           (data=1, model=4), qwen3-0.6b at full size: (a) train --mesh, 2
           steps, step 1 against lm_train's; (b) prefill 128 and 16 greedy
           tokens, the decode cache split over the ranks, against one card;
           (c) float32 at 2 layers against one rank; (d) each rank's card
           peak and counted collectives over a train and a decode step
           against the dry-run of the same steps (fake CUDA tensors)
  lm_ssm_tp  lm_tp's checks for Mamba-2 split over "model": mamba2-1.3b at
           full width (64 SSM heads, 16 a rank), 4 of 48 layers; step 1
           against one NCCL rank's (data=1, model=1) step; each rank's SSM
           state 1/4 of one card's, its conv window 1/4 of the x channels
           and all of B / C
  dryrun   repro_torch.launch.dryrun over every pod cell on fake CUDA
           tensors: every cell OK, no Mamba cell with whole blocks; peaks a
           rank, the Mamba cells' apart
  multihost  the port's multihost tier (tests/_torch_multihost.py, loaded
           by path) on the card: gloo ranks in fresh processes sharing it,
           bodies of tests/_torch_multihost_bodies.py with device "cuda".
           cluster_sort and cluster_sort_kv (local_impl "kernel") of 2^22
           keys in all on 2 and 4 ranks, each rank's result equal to one
           rank's (run_single) bit for bit and, in the body, to torch.sort /
           torch.argsort(stable=True) of the whole input; the
           rank-coordinated autotune with rank 1 killed at candidate 1 (the
           run ends by the grace period, not the timeout; the plan file is
           absent or loads), then a clean rerun (every rank and the file
           hold one plan); the autotune with rank 1 hung at candidate 1 and
           gloo's timeout at 10 s (contained: every rank fails, the run ends
           before its timeout).  Wall times of every run, and the
           gloo_timing body's model B and model D microseconds on 1 and 2
           ranks (what the host-staged wire costs)

The mesh phases' lines carry the card's name and power limit as nvidia-smi
gives them.  Then the kernels line (launches on every path, time per
launch (C and C-kv at one substage and at a fused span, whose launches are
counted on the one-substage wrapper), bound (the larger of the bytes' and the compare-exchanges' least
time), its share, plain and library times; the library time of A, B and
their kv twins is torch.sort over the same tiles, which the port never
calls) and, last, the ok line.  Any failed check raises, so the script exits
nonzero and prints no ok line.  Times come from CUDA events after warm-up,
averaged over the repetitions the lines name; the mesh phases' calls read
results on the host, so they are timed by the host clock, each call ending
in a synchronize.
"""
import contextlib
import datetime
import io
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores (same sheet)
SORT_N = 10_000_000  # the largest size of the repo's paper figures (benchmarks/run.py)
VOCAB = 151_936  # qwen3-0.6b's vocabulary (src/repro/configs/qwen3_0_6b.py)
SOURCE = "src/repro_torch/kernels/bitonic_sort/csrc/bitonic_sort.cu"
RANKS = 4  # cluster_ranks: ranks on the one card
DECIMAL_DIGITS = 7  # the paper's decimal scheme over keys in [0, 10^7)
LEARNING_CALLS = 5  # cluster_ranks: mesh sorts through the default planner
AUTOTUNE_BUCKETS = (4096, 1 << 20, 1 << 24)
SERVE_REQUESTS = 64
SERVE_LENGTHS = (1 << 8, 1 << 22)  # log-uniform request lengths
QUEUE_THREADS, QUEUE_REQUESTS, QUEUE_N = 8, 32, 4096
# the frontend's tenants: an interactive class and a batch class, with the
# SLOs of the reference's multi-tenant frontend bench
# (benchmarks/engine_bench.py: web 40 ms, batch 200 ms)
TENANTS = (("web", 3.0, 0, 40.0), ("batch", 1.0, 1, 200.0))  # name, weight, priority, slo_ms
TRACE = dict(duration_s=5.0, rates={"web": 200.0, "batch": 50.0}, zipf_a=1.2, seed=11)
OVERLOAD = 20  # the second replay's rate multiple
NAN_N = 1_000_003  # nan_merge: keys holding NaN, +-inf and +-0.0
# topk_select: the decode cell's shape (sortbench/configs/topk_cmdr256k.json)
TOPK_ROWS, TOPK_VOCAB, TOPK_K, TOPK_POOL = 128, 256_000, 50, 4
IMAGE_PAIRS = 12  # nan_merge: alternating timings of the kernel argsort with / without the image
# lm_serve: the slice's main path, qwen3-0.6b at full size, decoding
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN, LM_TOPK = "qwen3-0.6b", 8, 128, 16, 16
# lm_moe: granite's MoE stack at full width and depth, greedy decode
MOE_ARCH, MOE_GEN = "granite-moe-3b-a800m", 8
MOE_TOKENS = 4096  # moe_serve: tokens a moe_apply_adaptive call at granite's width
MOE_WIDTH = dict(d_model=1536, d_ff=512, n_experts=40, top_k=8)  # granite's MoE layer
MOE_ATOL = 1e-4  # the reference MoE tests' atol = rtol (tests/test_moe.py)
# bf16 logits of the serving path against forward's over the same tokens.
# The reference's serving-test tolerances (atol 2e-3 / 5e-3, rtol 1e-3) are
# for float32 configs; in bf16 the two paths round activations at different
# points (and may flip a near-tied expert), which moves logits by a few
# per cent of their scale, where a wrong computation on random weights is
# uncorrelated with forward's (relative L2 ~ 1.4).
LOGIT_REL_L2 = 0.05
LOGIT_MAX_ABS_SHARE = 0.1
LOGIT_TOLERANCE = {"rel_l2": LOGIT_REL_L2, "max_abs_share_of_max_logit": LOGIT_MAX_ABS_SHARE,
                   "dtype": "bfloat16"}
# lm_train: qwen3-0.6b at full size through the training driver
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 8, 512, 8, "1e-3"
# the card's train_step against the CPU's: a float32 qwen3 at full width, two
# layers; loss and grad_norm within 1e-4 relative, the update per leaf within
# 1e-3 relative L2 (the CPU tests' tolerances against the reference)
CHECK_LAYERS, CHECK_BATCH, CHECK_SEQ = 2, 2, 64
CHECK_RTOL, CHECK_UPDATE_RL2 = 1e-4, 1e-3
# recovery: the two-layer full-width qwen3 in bf16, checkpoints every 2
# steps, a TrainingAnomaly injected at step 5
RECOVERY_BATCH, RECOVERY_SEQ, RECOVERY_STEPS, RECOVERY_EVERY, RECOVERY_FAIL = 8, 128, 6, 2, 5
# MoE: granite's width, 4 of its 32 layers, bf16, a collapsed router
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS, MOE_TRAIN_SKEW = 4, 4, "6.0"
# lm_mesh: train --mesh.  (a) One NCCL rank, (data=1, model=1), qwen3-0.6b at
# full size (lm_train's model, batch, seq and lr): its step-1 loss against
# lm_train's, which starts from the same params and batch, within a bf16
# bound (the one-rank mesh runs the same ops; a wrong mesh path on random
# weights moves the loss by whole units).  (b) Four ranks on the one card over
# gloo (host-staged), (data=2, model=2): granite's full width (d_model 1536,
# 40 experts top-8, vocabulary 49155), bf16, 4 layers, batch 8 x seq 512
# (4,096 tokens a step); a float32 check at 2 layers against one rank on the
# card (loss without the aux term, whose mean over senders one rank does not
# repeat, and the global gradient norm within 1e-5 relative, at loss-free
# capacity, TF32 off); a greedy decode of 4 tokens against one rank's
MESH_ONE_STEPS, MESH_LOSS_RTOL = 6, 1e-2
MESH_RANKS, MESH_SPEC, MESH_LAYERS, MESH_STEPS = 4, "data=2,model=2", 4, 3
MESH_CHECK_LAYERS, MESH_CHECK_RTOL, MESH_PROMPT, MESH_DECODE = 2, 1e-5, 64, 4
# lm_tp: tensor parallelism over "model" and the split-K decode cache, four
# gloo ranks on the one card, (data=1, model=4), qwen3-0.6b at full size.
# (a) train --mesh at lm_train's batch, seq, lr and seed, 2 steps: step 1's
# loss within 2e-2 relative of lm_train's (the same params and batch; bf16
# partial sums combined over four ranks round differently, where a wrong
# split moves the loss by whole units).  (b) prefill 128 tokens and 16
# greedy decode steps at batch 8, the cache split over the ranks, against
# one card's decode (the same tokens fed, lm_serve's bf16 bounds).  (c)
# float32 at 2 layers, TF32 off: loss and gradient norm within 1e-6
# relative of one rank's, decode logits within 1e-5 of the largest logit,
# greedy tokens equal.  (d) each rank's card peak over a train step and a
# decode step within 10 % of the dry-run's peak_bytes_per_device for the
# same mesh, shape and rank (fake CUDA tensors).
TP_RANKS, TP_SPEC, TP_STEPS, TP_LOSS_RTOL = 4, "data=1,model=4", 2, 2e-2
TP_CHECK_LAYERS, TP_CHECK_RTOL, TP_CHECK_LOGITS = 2, 1e-6, 1e-5
TP_MEMORY_SHARE = 0.10
# lm_ssm_tp: Mamba-2 over "model" on the same four gloo ranks at (data=1,
# model=4): mamba2-1.3b at full width (src/repro/configs/mamba2_1_3b.py:
# d_model 2048, 64 SSM heads of 64, state 128, vocabulary 50,280, bf16,
# random weights from seed 0), 4 of its 48 layers.  (a) train --mesh at
# lm_train's batch, seq, lr and seed, 2 steps: step 1's loss within
# TP_LOSS_RTOL of one NCCL rank's (data=1, model=1) step 1 on the same
# params and batch.  (b) lm_tp's decode: each rank's SSM state exactly 1/4
# of one card's, its conv window 1/4 of the x channels plus all of B / C.
# (c) float32 at TP_CHECK_LAYERS layers, (d) card peaks and collectives
# against the dry-run: lm_tp's bounds.
SSM_ARCH, SSM_LAYERS = "mamba2-1.3b", 4
DRYRUN_JOBS = 8  # dryrun: the pod sweep's cells traced at once
# multihost: the port's multihost tier on the card, gloo ranks sharing it
MULTIHOST_N, MULTIHOST_RANKS = 1 << 22, (2, 4)  # keys in all; ranks a run
MULTIHOST_AUTOTUNE_N = 1 << 20  # the fault runs' autotune bucket
MULTIHOST_GLOO_TIMEOUT_S, MULTIHOST_TIMEOUT_S = 10, 120
PALLAS = "src/repro/kernels/bitonic_sort/bitonic_sort.py"
REPLACES = {
    "block_sort": f"{PALLAS}:88",
    "block_merge": f"{PALLAS}:124",
    "global_stage": f"{PALLAS}:188",
    "block_sort_kv": f"{PALLAS}:105",
    "block_merge_kv": f"{PALLAS}:143",
    "global_stage_kv": f"{PALLAS}:244",
}
# kernel C's fused launch over GLOBAL_SPAN substages, counted on the wrapper named
FUSED = {"global_stages": "global_stage", "global_stages_kv": "global_stage_kv"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"chip_smoke check failed: {what}")


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    view = torch.int16 if a.element_size() == 2 else torch.int32
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(view), b.view(view))


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bytes_bound_ms(n: int, itemsize: int, ranks: bool) -> float:
    """Each input read once, each output written once."""
    nbytes = 2 * n * itemsize + (2 * n * 4 if ranks else 0)
    return nbytes / HBM_BYTES_PER_S * 1e3


def ops_bound_ms(n: int, substages: int, ranks: bool) -> float:
    """n/2 compare-exchanges a substage, each a compare and two selects (three
    compares and four selects with ranks), at the float32 rate: the data
    sheet gives none for int32."""
    return n // 2 * substages * (7 if ranks else 3) / F32_OPS_PER_S * 1e3


def make_keys(dtype, shape, gen, device) -> torch.Tensor:
    if dtype == torch.int32:
        return torch.randint(0, 1 << 20, shape, generator=gen, device=device, dtype=torch.int32)
    return (torch.randn(shape, generator=gen, device=device) * 100).to(dtype)


def phase_parity(kernels, device) -> dict:
    """Every kernel against its plain version on the same card tensors."""
    rows, n = 8, 1 << 21
    gen = torch.Generator(device=device).manual_seed(0)
    worst = {name: 0.0 for name in (*REPLACES, *FUSED)}
    cases = 0
    for dtype in (torch.float32, torch.int32, torch.float16, torch.bfloat16):
        x = make_keys(dtype, (rows, n), gen, device)
        r = torch.arange(n, dtype=torch.int32, device=device).expand(rows, n).contiguous()
        for block_n in (1024, kernels.MAX_BLOCK_N, 2 * kernels.MAX_BLOCK_N):
            runs = {
                "block_sort": (lambda: (kernels.block_sort(x, block_n), None),
                               lambda: kernels.plain_block_sort(x, None, block_n)),
                "block_sort_kv": (lambda: kernels.block_sort_kv(x, r, block_n),
                                  lambda: kernels.plain_block_sort(x, r, block_n)),
            }
            for k in (2 * block_n, 4 * block_n, n):  # tiles alternating, in fours, all up
                runs[f"block_merge@{k}"] = (
                    lambda k=k: (kernels.block_merge(x, block_n, k), None),
                    lambda k=k: kernels.plain_block_merge(x, None, block_n, k))
                runs[f"block_merge_kv@{k}"] = (
                    lambda k=k: kernels.block_merge_kv(x, r, block_n, k),
                    lambda k=k: kernels.plain_block_merge(x, r, block_n, k))
            for j, kk in ((block_n, 4 * block_n), (n // 2, n)) if block_n <= kernels.MAX_BLOCK_N else ():
                runs[f"global_stage@{j},{kk}"] = (
                    lambda j=j, kk=kk: (kernels.global_stage(x, j, kk), None),
                    lambda j=j, kk=kk: kernels.plain_global_stage(x, None, j, kk))
                runs[f"global_stage_kv@{j},{kk}"] = (
                    lambda j=j, kk=kk: kernels.global_stage_kv(x, r, j, kk),
                    lambda j=j, kk=kk: kernels.plain_global_stage(x, r, j, kk))
            span = kernels.GLOBAL_SPAN - 1  # the widest fused launch: j_lo = j_hi >> span
            for j, kk in ((block_n << span, block_n << (span + 1)), (n // 2, n)) \
                    if block_n <= kernels.MAX_BLOCK_N else ():
                runs[f"global_stages@{j},{kk}"] = (
                    lambda j=j, kk=kk: (kernels.global_stages(x, j, j >> span, kk), None),
                    lambda j=j, kk=kk: kernels.plain_global_stages(x, None, j, j >> span, kk))
                runs[f"global_stages_kv@{j},{kk}"] = (
                    lambda j=j, kk=kk: kernels.global_stages_kv(x, r, j, j >> span, kk),
                    lambda j=j, kk=kk: kernels.plain_global_stages(x, r, j, j >> span, kk))
            for label, (kernel_fn, plain_fn) in runs.items():
                got, got_r = kernel_fn()
                want, want_r = plain_fn()
                torch.cuda.synchronize()
                what = f"{label} {dtype} block_n={block_n}"
                check(same_bits(got, want), f"{what}: keys differ from the plain version")
                if want_r is not None:
                    check(torch.equal(got_r, want_r), f"{what}: ranks differ from the plain version")
                name = label.split("@")[0]
                worst[name] = max(worst[name], max_abs_err(got, want))
                cases += 1
    return {"rows": rows, "n": n, "block_n": [1024, kernels.MAX_BLOCK_N, 2 * kernels.MAX_BLOCK_N],
            "merge_k": ["2*block_n", "4*block_n", n], "cases": cases,
            "bitwise_equal": True, "max_abs_err": worst}


def phase_merge_runs(kernels, device, rows: int = 8, n: int = 1 << 21) -> dict:
    """Kernel M against its plain version and the rank merge on the same
    card tensors, and its time a launch at model B's widths."""
    from repro_torch.core.merge import gather_bits, rank_merge_pairs, sort_image

    gen = torch.Generator(device=device).manual_seed(2)
    cases, times = 0, {}
    for dtype in (torch.float32, torch.int32, torch.float16, torch.bfloat16):
        keys = make_keys(dtype, (rows * n,), gen, device)
        for shape, width in (((rows, n), n // 2), ((rows * n,), n), ((rows * n,), 2 * n),
                             ((rows * n,), 4 * n)):
            runs = keys.view(-1, width)
            order = torch.sort(sort_image(runs), dim=-1, stable=True).indices
            x = gather_bits(runs, order).view(shape)
            got = kernels.merge_runs(x, width)
            rank = rank_merge_pairs(x.view(*shape[:-1], -1, 2, width)).view(shape)
            torch.cuda.synchronize()
            what = f"merge_runs {dtype} shape={list(shape)} width={width}"
            check(same_bits(got, kernels.plain_merge_runs(x, width)), f"{what}: differs from the plain version")
            check(same_bits(got, rank), f"{what}: differs from rank_merge_pairs")
            cases += 1
            if dtype == torch.float32:
                ms = time_ms(lambda: kernels.merge_runs(x, width), reps=20)
                bound = bytes_bound_ms(rows * n, 4, False)
                times[width] = {
                    "shape": list(shape), "ms": ms, "bound_ms": bound, "share": bound / ms,
                    "plain_ms": time_ms(lambda: kernels.plain_merge_runs(x, width), reps=3, warmup=1),
                    "rank_merge_pairs_ms": time_ms(
                        lambda: rank_merge_pairs(x.view(*shape[:-1], -1, 2, width)), reps=5),
                    "reps": 20}
    return {"rows": rows, "n": n, "tile": kernels.MERGE_TILE, "cases": cases,
            "bitwise_equal_plain": True, "bitwise_equal_rank_merge_pairs": True,
            "float32_times": times}


def expected_launches(n: int, block_n: int, kv: bool) -> dict:
    """Launches of one sort of rows of length n: A once, then per stage above
    the tile one B and the C launches of its substages at distance >= block_n
    (``global_spans``: up to GLOBAL_SPAN substages a launch)."""
    from repro_torch.kernels.bitonic_sort.bitonic_sort import global_spans

    stages = [1 << s for s in range(block_n.bit_length(), (n - 1).bit_length() + 1)]
    suffix = "_kv" if kv else ""
    counts = {f"block_sort{suffix}": 1,
              f"global_stage{suffix}": sum(len(global_spans(k // 2, block_n)) for k in stages),
              f"block_merge{suffix}": len(stages)}
    return {k: v for k, v in counts.items() if v}


def device_profile(fn) -> dict:
    """One call of ``fn`` under torch.profiler, after one unprofiled call:
    device kernel time (ms), total and the largest six by kernel name, and
    the call's host-clock ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue  # an aten op's device time is its kernels', counted there
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            by_kernel[ev.key[:120]] = by_kernel.get(ev.key[:120], 0.0) + us / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    return {"device_ms": sum(by_kernel.values()), "top": top, "wall_ms": wall_ms}


def counted(kernels, fn):
    """Run ``fn`` with every launch count at 0 before; return (result, counts)."""
    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in kernels.launch_counts().items() if v}


def launch_host_us(kernels, device, calls: int = 200) -> dict:
    """Host microseconds per wrapper call, back to back, ending in a
    synchronize, at a shape whose device work is a few microseconds."""
    n, bn = 4096, 1024
    x = torch.randn(1, n, device=device)
    r = torch.arange(n, dtype=torch.int32, device=device).view(1, n)
    runs = {
        "block_sort": lambda: kernels.block_sort(x, bn),
        "block_merge": lambda: kernels.block_merge(x, bn, n),
        "global_stage": lambda: kernels.global_stage(x, n // 2, n),
        "block_sort_kv": lambda: kernels.block_sort_kv(x, r, bn),
        "block_merge_kv": lambda: kernels.block_merge_kv(x, r, bn, n),
        "global_stage_kv": lambda: kernels.global_stage_kv(x, r, n // 2, n),
        "topk_select": lambda: kernels.topk_select(x, 50),
    }
    out = {}
    for name, fn in runs.items():
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / calls * 1e6
    return out


def tile_variants(kernels, xs, kv_keys, kv_r, bn: int) -> dict:
    """Kernels A, A-kv, B and B-kv at the main path's shapes under launch
    geometries other than ``_tile_geometry``'s, each bit-equal to it: the
    two tiles a block and the next E (16 for A, whose E is 32 already).  These launches go through the C entry
    point directly and count nowhere.  ``default`` is timed first and last,
    to show the spread."""
    out = {}
    for label, x, r, sort in (("block_sort", xs, None, True), ("block_sort_kv", kv_keys, kv_r, True),
                              ("block_merge", xs, None, False), ("block_merge_kv", kv_keys, kv_r, False)):
        k = x.shape[-1]
        stages = (2, bn, bn) if sort else (k, k, 0)  # (k_first, k_last, parity mask)
        item = x.element_size() + (0 if r is None else 4)
        base = kernels._tile_geometry(bn, x.element_size(), r is not None, sort)

        def geometry(e, per_block):
            return kernels.TileGeometry(bn // e, e, per_block,
                                        per_block * bn * item + kernels._TILE_BARRIER_BYTES)

        _, e, per_block, _ = base
        next_e = 16 if e == 32 else 2 * e
        variants = {
            "default": base,
            "two_tiles_a_block": geometry(e, 2 * per_block),
            f"{next_e}_keys_a_thread": geometry(next_e, max(1, 128 // (bn // next_e))),
            "default_again": base,
        }
        want = None
        times = {}
        for name, g in variants.items():
            ox, orank = torch.empty_like(x), None if r is None else torch.empty_like(r)

            def run(g=g, ox=ox, orank=orank):
                kernels._launch("bitonic_tile_network", kernels._DTYPE_CODE[x.dtype], x.data_ptr(),
                                None if r is None else r.data_ptr(), ox.data_ptr(),
                                None if orank is None else orank.data_ptr(), x.numel() // k, k, bn,
                                *stages, *g, torch.cuda.current_stream().cuda_stream)

            run()
            torch.cuda.synchronize()
            if want is None:
                want, want_r = ox, orank
            check(same_bits(ox, want) and (r is None or torch.equal(orank, want_r)),
                  f"{label} variant {name}: differs from the default geometry")
            times[name] = {"geometry": list(g), "ms": time_ms(run, reps=20)}
        out[label] = times
    return out


def ms_per_call(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` by the host clock, each call ending in a
    synchronize: for calls that read results on the host (the retry loop)
    and for ranks whose wire is staged through host memory."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def phase_cluster(kernels, group, device, gen, add) -> dict:
    """Model D on a one-rank NCCL group, with the kernels."""
    import repro_torch
    from repro_torch.core.cluster_sort import cluster_sort

    x = torch.randn(SORT_N, generator=gen, device=device) * 1000
    dec = torch.randint(0, 10 ** DECIMAL_DIGITS, (SORT_N,), generator=gen, device=device,
                        dtype=torch.int32)
    sorted_x = torch.sort(x).values
    out = {}
    for mode, keys in (("splitters", x), ("sample", x), ("radix", x), ("decimal", dec)):
        seen = []
        kw = dict(mode=mode, digits=DECIMAL_DIGITS, telemetry=lambda **t: seen.append(t))

        def call(kw=kw, keys=keys):
            return cluster_sort(keys, group, local_impl="kernel", block_n=1024, **kw)

        (slab, valid), counts = counted(kernels, call)
        add(counts)
        check(counts == expected_launches(slab.shape[0], 1024, kv=False),
              f"cluster {mode}: launches {counts} for a slab of {slab.shape[0]}")
        plain_slab, plain_valid = cluster_sort(keys, group, local_impl="bitonic", **kw)
        check(torch.equal(valid, plain_valid), f"cluster {mode}: valid differs from the plain path")
        got = slab[valid]
        check(same_bits(got, plain_slab[plain_valid]),
              f"cluster {mode}: keys differ from the plain bitonic network")
        check(torch.equal(got, sorted_x if keys is x else torch.sort(dec).values),
              f"cluster {mode}: values differ from torch.sort")
        check(int(valid.sum()) == SORT_N and bool(torch.isfinite(got.float()).all()),
              f"cluster {mode}: counts or finiteness")
        tel = seen[0]
        ms = ms_per_call(call, reps=3)
        prof = device_profile(call)
        out[mode] = {"dtype": str(keys.dtype).replace("torch.", ""), "slab": slab.shape[0],
                     "capacity": tel["capacity"], "retries": tel["retries"], "peak": tel["peak"],
                     "overflowed": tel["overflowed"], "launches_per_call": counts, "ms": ms,
                     "reps": 3, "device_ms": prof["device_ms"],
                     "device_idle_share": 1.0 - prof["device_ms"] / ms if prof["device_ms"] else None,
                     "top_device_kernels_ms": prof["top"],
                     "bitwise_equal_plain_bitonic": True, "equal_torch_sort": True}
    return {"n": SORT_N, "ranks": group.size, "backend": "nccl", "block_n": 1024,
            "modes": out,
            "model_b_ms": time_ms(lambda: repro_torch.sort(x, strategy="shared", local_impl="kernel",
                                                           n_threads=8), reps=3),
            "torch_sort_ms": time_ms(lambda: torch.sort(x), reps=5),
            "torch_sort_decimal_keys_ms": time_ms(lambda: torch.sort(dec), reps=5)}


def phase_cluster_kv(group, device, gen) -> dict:
    """Model D with a payload and the mesh kv front doors on the same group."""
    from repro_torch import engine

    keys = torch.randint(0, 1000, (SORT_N,), generator=gen, device=device, dtype=torch.int32)
    iota = torch.arange(SORT_N, dtype=torch.int32, device=device)
    payload = torch.randn(SORT_N, 4, generator=gen, device=device)
    want = torch.argsort(keys, stable=True)
    slab_k, slab_v, valid = engine.cluster_sort_kv(keys, {"i": iota}, group)
    check(torch.equal(slab_v["i"][valid].long(), want) and torch.equal(slab_k[valid], keys[want]),
          "cluster_sort_kv: differs from torch.argsort(stable=True)")
    idx = engine.argsort(keys, mesh=group)
    check(idx.dtype == torch.int32 and torch.equal(idx.long(), want),
          "argsort(mesh=): differs from torch.argsort(stable=True)")
    k, v = engine.sort_kv(keys, {"p": payload}, mesh=group)
    check(torch.equal(k, keys[want]) and torch.equal(v["p"], payload[want]),
          "sort_kv(mesh=): differs from the stable sort")
    prof = {name: device_profile(fn)
            for name, fn in (("argsort_mesh", lambda: engine.argsort(keys, mesh=group)),
                             ("sort_kv_mesh", lambda: engine.sort_kv(keys, {"p": payload}, mesh=group)))}
    return {"n": SORT_N, "ranks": group.size, "backend": "nccl", "key_range": [0, 1000],
            "payload": [SORT_N, 4], "equal_torch_argsort_stable": True, "reps": 3,
            "device_profile": prof,
            "ms": {"cluster_sort_kv": ms_per_call(lambda: engine.cluster_sort_kv(keys, {"i": iota}, group), 3),
                   "argsort_mesh": ms_per_call(lambda: engine.argsort(keys, mesh=group), 3),
                   "sort_kv_mesh": ms_per_call(lambda: engine.sort_kv(keys, {"p": payload}, mesh=group), 3),
                   "torch_argsort_stable": time_ms(lambda: torch.argsort(keys, stable=True), reps=3)}}


def cluster_rank(rank: int, world: int, store: str, result: str, plans: str, tuned: str) -> None:
    """One rank of phase cluster_ranks (a spawned process): its block of each
    mesh sort, checked against the library sort of the whole input; the
    capacity-learning loop through the default planner (backed by
    ``plans``, shared by the ranks); a rank-coordinated autotune into
    ``tuned``."""
    os.environ["REPRO_SORT_PLANS"] = plans  # before the default planner exists
    import repro_torch
    from repro_torch.core import cluster_sort, distributed_merge_sort
    from repro_torch.engine import cluster_sort_kv
    from repro_torch.engine.planner import Planner, SortPlan, default_planner, plan_key
    from repro_torch.exchange import AxisGroup
    from repro_torch.kernels.bitonic_sort import bitonic_sort as kernels

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        group = AxisGroup()
        gen = torch.Generator(device="cuda").manual_seed(7)  # the same whole input on every rank
        x = torch.randn(SORT_N, generator=gen, device="cuda") * 1000
        dec = torch.randint(0, 10 ** DECIMAL_DIGITS, (SORT_N,), generator=gen, device="cuda",
                            dtype=torch.int32)
        dup = torch.randint(0, 1000, (SORT_N,), generator=gen, device="cuda", dtype=torch.int32)
        m = SORT_N // world
        mine = slice(rank * m, (rank + 1) * m)

        def block_check(got, want, what):
            counts = group.all_gather(torch.tensor([got.shape[0]], device="cuda")).view(-1)
            start = int(counts[:rank].sum())
            check(int(counts.sum()) == SORT_N, f"{what}: counts sum to {int(counts.sum())}")
            check(torch.equal(got, want[start:start + got.shape[0]]), f"{what}: rank {rank} differs")

        report = {"launches": {}, "ms": {}}
        for mode, keys in (("splitters", x), ("sample", x), ("decimal", dec)):
            def call(mode=mode, keys=keys):
                return cluster_sort(keys[mine], group, mode=mode, digits=DECIMAL_DIGITS,
                                    local_impl="kernel", block_n=1024)
            (slab, valid), counts = counted(kernels, call)
            report["launches"][f"cluster_{mode}"] = counts
            block_check(slab[valid], torch.sort(keys).values, f"cluster_ranks {mode}")
            report["ms"][f"cluster_{mode}"] = ms_per_call(call, reps=2)
        call = lambda: distributed_merge_sort(x[mine], group, local_impl="kernel", block_n=1024)
        buf, counts = counted(kernels, call)
        report["launches"]["merge_tree"] = counts
        if rank == 0:
            check(torch.equal(buf, torch.sort(x).values), "cluster_ranks model C: rank 0 differs")
        report["ms"]["merge_tree"] = ms_per_call(call, reps=2)
        iota = torch.arange(SORT_N, dtype=torch.int32, device="cuda")
        call = lambda: cluster_sort_kv(dup[mine], {"i": iota[mine]}, group)
        slab_k, slab_v, valid = call()
        block_check(slab_v["i"][valid].long(), torch.argsort(dup, stable=True), "cluster_ranks kv")
        report["ms"]["cluster_sort_kv"] = ms_per_call(call, reps=2)

        # the capacity-learning loop: mesh sorts of skewed keys through the
        # default planner, keyed by the global length
        skewed = torch.from_numpy(
            (np.random.default_rng(11).zipf(1.5, SORT_N) % 10_000).astype(np.int32)).cuda()
        planner = default_planner()
        key = plan_key(SORT_N, torch.int32, group)
        report["learning"] = {"key": key, "calls": []}
        for i in range(LEARNING_CALLS):
            call = lambda: repro_torch.sort(skewed[mine], mesh=group, mode="radix",
                                            local_impl="kernel", block_n=1024)
            (slab, valid), counts = counted(kernels, call)
            report["launches"][f"learning_{i}"] = counts
            block_check(slab[valid], torch.sort(skewed).values, f"cluster_ranks learning call {i}")
            obs = planner.telemetry.last(key)
            check(obs is not None, "the mesh sort reported no telemetry to the default planner")
            report["learning"]["calls"].append({
                "retries": obs.retries, "capacity": obs.capacity, "peak": obs.peak,
                "peak_mean_ratio": obs.peak_mean_ratio(),
                "learned_factor": planner.capacity_factor_for(key),
                "promotion": list(planner.promotion_state(key))})

        # one rank-coordinated autotune over two model-D candidates
        tuner = Planner(tuned, device="cuda")
        t0 = time.perf_counter()
        best = tuner.autotune(SORT_N, torch.float32, mesh=group, reps=1,
                              candidates=[SortPlan("cluster", mode="splitters"),
                                          SortPlan("cluster", mode="sample")])
        report["autotune"] = {"best": best.to_dict(), "wrote": tuner.last_autotune_wrote,
                              "key": plan_key(SORT_N, torch.float32, group),
                              "seconds": time.perf_counter() - t0}
        with open(f"{result}.{rank}.json", "w") as f:
            json.dump(report, f)
    finally:
        dist.destroy_process_group()


def phase_cluster_ranks(add) -> dict:
    """Four spawned ranks on the one card over gloo (NCCL takes one rank a
    card); any rank's failure fails the phase."""
    import torch.multiprocessing as mp

    work = os.path.join(ROOT, "build", "cluster_ranks")
    os.makedirs(work, exist_ok=True)
    store, result = os.path.join(work, f"store.{os.getpid()}"), os.path.join(work, "result")
    plans, tuned = os.path.join(work, "plans.json"), os.path.join(work, "tuned.json")
    for path in [store, plans, tuned] + [f"{result}.{r}.json" for r in range(RANKS)]:
        if os.path.exists(path):
            os.remove(path)
    t0 = time.perf_counter()
    mp.start_processes(cluster_rank, args=(RANKS, store, result, plans, tuned), nprocs=RANKS,
                       join=True, start_method="spawn")
    reports = []
    for r in range(RANKS):
        with open(f"{result}.{r}.json") as f:
            reports.append(json.load(f))
    for rep in reports:
        for counts in rep["launches"].values():
            add(counts)
    # every rank learned the same table and holds rank 0's tuned plan, which
    # rank 0 alone wrote
    check(all(rep["learning"] == reports[0]["learning"] for rep in reports),
          "cluster_ranks: the ranks learned different capacity tables")
    check(all(rep["autotune"]["best"] == reports[0]["autotune"]["best"] for rep in reports),
          "cluster_ranks: the ranks hold different tuned plans")
    check([rep["autotune"]["wrote"] for rep in reports] == [True] + [False] * (RANKS - 1),
          "cluster_ranks: a rank other than 0 wrote the plan file")
    with open(tuned) as f:
        doc = json.load(f)
    auto = reports[0]["autotune"]
    check(doc["plans"] == {auto["key"]: auto["best"]}, "cluster_ranks: the tuned plan file")
    with open(plans) as f:
        learned = json.load(f)["learned"]
    learning = reports[0]["learning"]
    check(learning["key"] in learned and learning["key"].startswith(f"{1 << 24}|int32|"),
          "cluster_ranks: the learned entry is not under the global length's bucket")
    return {"ranks": RANKS, "backend": "gloo (host-staged CUDA tensors)", "n": SORT_N,
            "keys_a_rank": SORT_N // RANKS, "seconds": time.perf_counter() - t0,
            "launches_rank0": reports[0]["launches"],
            "host_staged_ms_rank0": reports[0]["ms"], "reps": 2,
            "learning": learning, "learned_on_disk": learned[learning["key"]],
            "autotune": auto,
            "checked": ["cluster splitters", "cluster sample", "cluster decimal", "model C",
                        "cluster_sort_kv", "capacity learning", "coordinated autotune"]}


def kernel_planner(device, buckets=tuple(1 << b for b in range(3, 25)),
                   dtypes=(torch.int32, torch.float32)):
    """A planner that pins every cell in ``buckets`` x ``dtypes`` to the
    reference's 'pallas' plan, mapped by ``carry`` to the port's kernel plan
    (``SortPlan("shared", local_impl="kernel", block_n=1024)``).  Warmup
    warms every cell a plan table names, so the frontend's table names only
    its trace's."""
    from repro_torch import carry
    from repro_torch.engine.planner import plan_key

    plan = {"strategy": "shared", "local_impl": "pallas", "block_n": 1024}
    plans = {plan_key(b, d, device=device): plan for b in buckets for d in dtypes}
    planner = carry.planner_from_reference({"version": 3, "plans": plans}, device=device)
    check(all(p.local_impl == "kernel" for p in planner.plans.values()), "kernel_planner: mapping")
    return planner


def phase_autotune(kernels, device, add, buckets=AUTOTUNE_BUCKETS, reps: int = 3) -> dict:
    """The full one-device grid at each bucket for int32 and float32, into a
    fresh plan file; every candidate's microseconds (the planner's own
    timings) and each cell's winner."""
    from repro_torch.engine.planner import Planner, plan_key

    path = os.path.join(ROOT, "build", "serve", "plans.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        os.remove(path)
    label = lambda p: p.local_impl + (f"@{p.block_n}" if p.block_n else "")
    cells = {}
    planner = Planner(path, device=device)
    for dtype in (torch.int32, torch.float32):
        for nb in buckets:
            best, counts = counted(kernels, lambda: planner.autotune(nb, dtype, reps=reps))
            add(counts)
            cells[plan_key(nb, dtype, device=device)] = {
                "us": {label(p): p.us_per_call for p in planner.last_autotune_candidates},
                "winner": label(best), "winner_us": best.us_per_call, "launches": counts}
    reloaded = Planner(path, device=device)
    check(reloaded.plans == planner.plans and len(reloaded.plans) == 2 * len(buckets),
          "autotune: the reloaded plan file differs from the planner's plans")
    for key, cell in cells.items():
        check(len(cell["us"]) == 6, f"autotune {key}: {len(cell['us'])} candidates timed, not 6")
    return {"plan_file": os.path.relpath(path, ROOT), "reps": reps, "cells": cells,
            "reloaded_equal": True}


def _serve_requests(rng, count, lengths):
    lo, hi = np.log(lengths[0]), np.log(lengths[1])
    out = []
    for i in range(count):
        n = int(np.exp(rng.uniform(lo, hi)))
        keys = rng.integers(0, 1 << 16, n)  # ties on purpose: stability shows
        out.append(keys.astype(np.int32 if i % 2 == 0 else np.float32))
    return out


def phase_serve(kernels, device, add, count=SERVE_REQUESTS, lengths=SERVE_LENGTHS,
                big=SORT_N) -> dict:
    """A seeded ragged batch of every kind and one 10M-key request through a
    SortService on kernel plans; every result against numpy; the same
    traffic again builds no cell and loads no library."""
    from repro_torch.engine import SortService

    svc = SortService(planner=kernel_planner(device), device=device)
    rng = np.random.default_rng(21)
    reqs = _serve_requests(rng, count, lengths)
    kinds = [("sort", True), ("argsort", True), ("sort_kv", True), ("argsort", False)]
    groups = {k: [r for i, r in enumerate(reqs) if i % len(kinds) == j] for j, k in enumerate(kinds)}
    payloads = [rng.standard_normal((len(r), 4)).astype(np.float32) for r in groups[("sort_kv", True)]]
    large = (rng.standard_normal(big) * 1000).astype(np.float32)

    def traffic():
        out = {k: svc.submit(rs, kind=k[0], ascending=k[1],
                             values=payloads if k[0] == "sort_kv" else None)
               for k, rs in groups.items()}
        out["large"] = svc.submit([large])
        return out

    def verify(out):
        for (kind, asc), rs in groups.items():
            for i, (got, r) in enumerate(zip(out[(kind, asc)], rs)):
                order = np.argsort(r if asc else -r.astype(np.float64), kind="stable")
                if kind == "sort":
                    check(np.array_equal(got, np.sort(r)), f"serve sort {i}: differs from np.sort")
                elif kind == "argsort":
                    check(got.dtype == np.int32 and np.array_equal(got, order),
                          f"serve argsort {i} ascending={asc}: differs from np.argsort(stable)")
                else:
                    check(np.array_equal(got[0], r[order]) and np.array_equal(got[1], payloads[i][order]),
                          f"serve sort_kv {i}: differs from the stable sort")
        check(np.array_equal(out["large"][0], np.sort(large)), "serve 10M: differs from np.sort")

    t0 = time.perf_counter()
    out, cold_counts = counted(kernels, traffic)
    cold_s = time.perf_counter() - t0
    add(cold_counts)
    verify(out)
    for name in REPLACES:
        check(cold_counts.get(name, 0) > 0, f"serve: kernel {name} was not launched")
    misses, hits, loads = svc.cache.misses, svc.cache.hits, kernels._lib.cache_info().misses
    t0 = time.perf_counter()
    out, warm_counts = counted(kernels, traffic)
    warm_s = time.perf_counter() - t0
    add(warm_counts)
    verify(out)
    check(svc.cache.misses == misses and kernels._lib.cache_info().misses == loads,
          "serve: repeated traffic built a new cell or loaded the library again")
    kernels.reset_launch_counts()
    prof = device_profile(traffic)
    add(kernels.launch_counts())
    n_req = count + 1
    keys = sum(len(r) for r in reqs) + big
    return {"requests": n_req, "keys": keys, "lengths": list(lengths), "block_n": 1024,
            "cold_s": cold_s, "warm_s": warm_s, "requests_per_s": n_req / warm_s,
            "keys_per_s": keys / warm_s, "cells_built": misses,
            "cell_hits": svc.cache.hits - hits, "second_pass_new_cells": 0,
            "library_loads": kernels._lib.cache_info().misses,
            "launches_per_pass": warm_counts, "device_ms": prof["device_ms"],
            "profiled_pass_ms": prof["wall_ms"],
            "device_idle_share": 1.0 - prof["device_ms"] / prof["wall_ms"],
            "top_device_kernels_ms": prof["top"],
            "stats": {k: v for k, v in vars(svc.stats).items() if not k.startswith("_")}}


def phase_queue(kernels, device, add, threads=QUEUE_THREADS, per_thread=QUEUE_REQUESTS,
                n=QUEUE_N) -> dict:
    """Producer threads through an AsyncSortService on kernel plans."""
    from repro_torch.engine import AsyncSortService, SortService

    svc = AsyncSortService(SortService(planner=kernel_planner(device), device=device),
                           max_batch=16)
    reqs = [[np.random.default_rng([t, j]).integers(0, 1 << 20, n).astype(np.int32)
             for j in range(per_thread)] for t in range(threads)]
    futs = [[None] * per_thread for _ in range(threads)]

    def produce(t):
        for j, r in enumerate(reqs[t]):
            futs[t][j] = svc.submit_async(r)

    def run():
        workers = [threading.Thread(target=produce, args=(t,)) for t in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=300)
            check(not w.is_alive(), "queue: a producer thread hung")
        return [[f.result(timeout=300) for f in row] for row in futs]

    t0 = time.perf_counter()
    out, counts = counted(kernels, run)
    seconds = time.perf_counter() - t0
    svc.close()
    add(counts)
    for t in range(threads):
        for j in range(per_thread):
            check(np.array_equal(out[t][j], np.sort(reqs[t][j])), f"queue: thread {t} request {j}")
    st = svc.stats
    pct = st.latency_percentiles((50, 90, 99))
    return {"threads": threads, "requests": threads * per_thread, "n": n, "max_batch": 16,
            "seconds": seconds, "batches": st.coalesced_batches, "fill_ratio": st.fill_ratio(),
            "queue_latency_ms": {f"p{p}": v * 1e3 for p, v in pct.items()}, "launches": counts}


def _replay(fe, trace):
    """``replay_wallclock`` with every admitted request's keys kept, so each
    completed ticket can be checked against numpy.  Every ticket must end
    with a result or a shed, and every offered request is either completed
    or shed: a failed execution fails the phase."""
    from repro_torch.engine.frontend import ShedError, replay_wallclock

    sent = []
    submit = fe.submit

    def recording(tenant, keys, **kw):
        ticket = submit(tenant, keys, **kw)
        sent.append((ticket, keys))
        return ticket

    fe.submit = recording
    try:
        rep = replay_wallclock(fe, trace)
    finally:
        fe.submit = submit
    done = 0
    for ticket, keys in sent:
        exc = ticket.future.exception(timeout=0)  # replay_wallclock waited for each
        if exc is None:
            check(np.array_equal(ticket.result(), np.sort(keys)), "frontend: a ticket's result")
            done += 1
        elif not isinstance(exc, ShedError):
            raise exc
    shed = sum(rep.shed_counts().values())
    check(done + shed == rep.offered,
          f"frontend: {done} completed + {shed} shed != {rep.offered} offered")
    return rep, done


def _load_summary(rep, done):
    pct = rep.latency_percentiles((50, 95, 99))
    met = sum(1 for t in rep.tickets if t.slo_met)
    return {"offered": rep.offered, "completed": done, "elapsed_s": rep.elapsed_s,
            "latency_ms": {f"p{p}": v * 1e3 for p, v in pct.items()},
            "slo_met_share_of_completed": met / done if done else None,
            "goodput": rep.goodput(), "goodput_by_tenant": {t: rep.goodput(t) for t, *_ in TENANTS},
            "sheds": rep.shed_counts(),
            "sheds_by_tenant": {t: rep.shed_counts(t) for t, *_ in TENANTS}}


def phase_frontend(kernels, device, add, trace_kw=TRACE, overload=OVERLOAD) -> dict:
    """The SLO frontend on kernel plans, warmed, replaying a seeded trace in
    real time, then the same trace at ``overload`` times the rates."""
    from repro_torch.engine import SortService
    from repro_torch.engine.frontend import SortFrontend, Tenant, make_trace
    from repro_torch.engine.frontend.loadgen import DEFAULT_SIZES

    svc = SortService(planner=kernel_planner(device, DEFAULT_SIZES, (torch.int32,)), device=device)
    fe = SortFrontend(svc, tenants=[Tenant(name, weight=w, priority=p, slo_ms=slo)
                                    for name, w, p, slo in TENANTS], max_batch=16)
    kernels.reset_launch_counts()
    warm = fe.warmup(kinds=("sort",))  # the plan table's cells: the trace's buckets
    misses = svc.cache.misses
    fe.start()
    trace = make_trace(sizes=DEFAULT_SIZES, **trace_kw)
    rep, done = _replay(fe, trace)
    first = next(t for t in rep.tickets if t.latency_s is not None and not t.future.exception())
    steady = rep.latency_percentiles((50,))[50]
    hot = dict(trace_kw, rates={t: r * overload for t, r in trace_kw["rates"].items()})
    rep_hot, done_hot = _replay(fe, make_trace(sizes=DEFAULT_SIZES, **hot))
    fe.close()
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    add(counts)
    check(svc.cache.misses == misses, "frontend: traffic built a cell the warmup missed")
    check(set(rep_hot.shed_counts()) <= {"tenant_backlog", "global_backlog", "deadline"},
          "frontend: a shed without a known reason")
    return {"tenants": [dict(zip(("name", "weight", "priority", "slo_ms"), t)) for t in TENANTS],
            "max_batch": 16, "sizes": list(DEFAULT_SIZES), "trace": trace_kw,
            "warmup": {"cells": len(warm.cells), "built": warm.compiled, "seconds": warm.elapsed_s},
            "base": _load_summary(rep, done),
            "first_request_ms": first.latency_s * 1e3, "median_ms": steady * 1e3,
            f"x{overload}": _load_summary(rep_hot, done_hot), "launches": counts}


def _fresh_default_planner(plans_path):
    """Point $REPRO_SORT_PLANS at ``plans_path`` (unset it for None) and drop
    the process-wide planner, so the next ``default_planner()`` is built
    from that file, as a new serving process's would be.  Returns the
    previous state for ``_restore_default_planner``."""
    import repro_torch.engine.planner as planner_mod

    saved = (os.environ.get("REPRO_SORT_PLANS"), planner_mod._DEFAULT)
    if plans_path is None:
        os.environ.pop("REPRO_SORT_PLANS", None)
    else:
        os.environ["REPRO_SORT_PLANS"] = plans_path
    planner_mod._DEFAULT = None
    return saved


def _restore_default_planner(saved) -> None:
    import repro_torch.engine.planner as planner_mod

    env, planner = saved
    if env is None:
        os.environ.pop("REPRO_SORT_PLANS", None)
    else:
        os.environ["REPRO_SORT_PLANS"] = env
    planner_mod._DEFAULT = planner


def nan_keys(n: int, gen, device) -> torch.Tensor:
    """float32 keys with NaN of both signs, +-inf and +-0.0 in a quarter of
    the slots, ties among the rest."""
    x = torch.round(torch.randn(n, generator=gen, device=device) * 4)
    special = torch.tensor([float("nan"), -float("nan"), float("inf"), -float("inf"), 0.0, -0.0],
                           device=device)
    at = torch.rand(n, generator=gen, device=device) < 0.25
    pick = torch.randint(0, 6, (n,), generator=gen, device=device)
    return torch.where(at, special[pick], x)


def phase_nan_merge(kernels, device, add, n=NAN_N) -> dict:
    """Model B, the stable argsort and the top-k over NaN-holding keys on
    the card: no call raises or trips a device assert; 'xla' and 'merge'
    give the CPU path's bits (the values the CPU parity test holds against
    the reference); the kernel argsort and top-k give 'xla''s indices."""
    import repro_torch
    from repro_torch import engine

    gen = torch.Generator(device=device).manual_seed(5)
    x = nan_keys(n, gen, device)
    x_cpu = x.cpu()
    out = {}
    for impl in ("xla", "merge", "kernel"):
        got, counts = counted(kernels, lambda: repro_torch.sort(x, strategy="shared",
                                                                local_impl=impl, n_threads=8))
        add(counts)
        check(got.shape == x.shape, f"nan_merge sort {impl}: shape")
        entry = {"launches": counts}
        if impl != "kernel":
            want = repro_torch.sort(x_cpu, strategy="shared", local_impl=impl, n_threads=8)
            check(same_bits(got.cpu(), want), f"nan_merge sort {impl}: differs from the CPU path")
            entry["bitwise_equal_cpu"] = True
        entry["nan_out"] = int(torch.isnan(got).sum())
        out[f"sort_{impl}"] = entry
    for asc in (True, False):
        xla = None
        for impl in ("xla", "kernel"):
            idx, counts = counted(kernels, lambda: engine.argsort(x, ascending=asc, impl=impl))
            add(counts)
            check(idx.shape == x.shape and idx.dtype == torch.int32, f"nan_merge argsort {impl}")
            if impl == "xla":
                want = engine.argsort(x_cpu, ascending=asc, impl="xla")
                check(torch.equal(idx.cpu(), want), "nan_merge argsort xla: differs from the CPU path")
                xla = idx
            else:  # ranked on sort_image: NaN lets no pad rank in
                check(torch.equal(idx, xla), "nan_merge argsort kernel: differs from impl='xla'")
            out[f"argsort_{impl}_{'asc' if asc else 'desc'}"] = {"launches": counts}
    # a top-k over NaN-holding logits of the vocabulary's width (padded rows)
    logits = nan_keys(8 * VOCAB, gen, device).view(8, VOCAB)
    (vals, idx), counts = counted(kernels, lambda: engine.topk(logits, 50, impl="kernel"))
    add(counts)
    want_vals, want_idx = engine.topk(logits, 50, impl="xla")
    check(0 <= int(idx.min()) and int(idx.max()) < VOCAB, "nan_merge topk kernel: index out of range")
    check(torch.equal(idx, want_idx) and same_bits(vals, want_vals),
          "nan_merge topk kernel: differs from impl='xla'")
    # what the float image adds to the kernel top-k: its own time beside the call's
    from repro_torch.core.merge import sort_image

    # the same kernel argsort with and without the image, in turns: what
    # the image adds to the network's launches at the vocabulary's width
    from repro_torch.kernels.bitonic_sort import ops

    def no_image():
        block_n, rows = ops._padded_rows(logits, ops.DEFAULT_BLOCK_N)
        return kernels.sort_rows(rows, block_n, ranked=True)

    def with_image():
        return ops.kernel_argsort(logits)

    # IMAGE_PAIRS pairs, the order flipped every pair; the cost counts as
    # measured where the mean difference is over twice its standard error
    without, with_ = [], []
    for i in range(IMAGE_PAIRS):
        first, second = (no_image, with_image) if i % 2 == 0 else (with_image, no_image)
        t1, t2 = time_ms(first, reps=20), time_ms(second, reps=20)
        without.append(t1 if i % 2 == 0 else t2)
        with_.append(t2 if i % 2 == 0 else t1)
    diff = [w - o for w, o in zip(with_, without)]
    mean = sum(diff) / len(diff)
    se = (sum((d - mean) ** 2 for d in diff) / (len(diff) - 1) / len(diff)) ** 0.5
    out["topk_kernel"] = {"shape": [8, VOCAB], "k": 50, "launches": counts, "equal_impl_xla": True,
                          "ms": time_ms(lambda: engine.topk(logits, 50, impl="kernel"), reps=20),
                          "sort_image_ms": time_ms(lambda: sort_image(logits), reps=20),
                          "argsort_without_image_ms": without, "argsort_with_image_ms": with_,
                          "image_cost_ms": mean, "image_cost_se_ms": se,
                          "image_cost": "measured" if abs(mean) > 2 * se else "unresolved",
                          "reps": 20}
    return {"n": n, "dtype": "float32", "nan_in": int(torch.isnan(x).sum()), "results": out,
            "no_device_assert": True, "argsort_kernel_equal_xla": True}


def phase_topk_select(kernels, device, gen) -> dict:
    """Kernel T at the decode cell's shape (see the module docstring)."""
    from repro_torch import engine
    from repro_torch.engine.kv import _order_keys

    pool = [(torch.randn(TOPK_ROWS, TOPK_VOCAB, generator=gen, device=device) * 3.0)
            .to(torch.bfloat16).float() for _ in range(TOPK_POOL)]
    x = pool[0]
    for largest in (True, False):
        (vals, idx), counts = counted(kernels, lambda: engine.topk(x, TOPK_K, largest=largest,
                                                                   impl="kernel"))
        check(counts == {"topk_select": 2}, f"topk_select launches {counts}")
        check(torch.equal(idx, kernels.plain_topk_select(x, TOPK_K, largest)),
              f"topk_select largest={largest}: differs from its plain version")
        want_vals, want_idx = engine.topk(x, TOPK_K, largest=largest, impl="xla")
        check(torch.equal(idx, want_idx) and same_bits(vals, want_vals),
              f"topk_select largest={largest}: differs from impl='xla'")
    turn = iter(range(1 << 62))

    def over_pool(fn):
        return lambda: fn(pool[next(turn) % TOPK_POOL])

    # the logits read once, k int32 indices a row written once
    bound_ms = (x.numel() * 4 + TOPK_ROWS * TOPK_K * 4) / HBM_BYTES_PER_S * 1e3
    ms = time_ms(over_pool(lambda b: kernels.topk_select(b, TOPK_K)), reps=100)
    launches = device_profile(over_pool(lambda b: kernels.topk_select(b, TOPK_K)))
    host = []
    for i in range(200):  # the card idle at each call's start
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.topk(pool[i % TOPK_POOL], TOPK_K, impl="kernel")
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    engine.topk(x, TOPK_K, impl="kernel")
    torch.cuda.synchronize()
    call_peak = torch.cuda.max_memory_allocated() - before
    return {"shape": [TOPK_ROWS, TOPK_VOCAB], "k": TOPK_K, "pool": TOPK_POOL, "launches": counts,
            "equal_plain": True, "equal_impl_xla": True,
            "geometry": kernels.select_geometry(TOPK_ROWS, TOPK_VOCAB, TOPK_K),
            "ms": ms, "bound_ms": bound_ms, "share": bound_ms / ms, "reps": 100,
            "launch_device_ms": launches["top"], "device_ms": launches["device_ms"],
            "plain_ms": time_ms(lambda: kernels.plain_topk_select(x, TOPK_K, True), reps=1, warmup=1),
            "library_ms": time_ms(over_pool(lambda b: torch.topk(b, TOPK_K)), reps=20),
            "call_ms": time_ms(over_pool(lambda b: engine.topk(b, TOPK_K, impl="kernel")), reps=100),
            "kv_network_ms": time_ms(over_pool(lambda b: _order_keys(b, ascending=False,
                                                                     impl="kernel")), reps=5),
            "host_ms_per_call": {"median": float(np.median(host)), "min": min(host),
                                 "max": max(host), "calls": len(host)},
            "call_peak_bytes": call_peak}


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want.double()).norm() / want.double().norm())


def _logits_check(label, got, want) -> dict:
    """bf16 logits of the serving path against ``forward``'s (module doc)."""
    rel = _rel_l2(got, want)
    err = max_abs_err(got, want)
    bound = LOGIT_MAX_ABS_SHARE * float(want.abs().max())
    check(rel <= LOGIT_REL_L2 and err <= bound,
          f"{label}: logits off forward's (rel L2 {rel:.4g}, max abs {err:.4g} > {bound:.4g}?)")
    return {"rel_l2": rel, "max_abs_err": err, "max_abs_bound": bound,
            "argmax_agreement": float((got.argmax(-1) == want.argmax(-1)).float().mean())}


def _parse_driver(out: str) -> dict:
    import re

    m = re.search(r"prefill ([\d.]+) ms; decode ([\d.]+) ms/tok", out)
    return {"prefill_ms": float(m.group(1)), "decode_ms_per_token": float(m.group(2))}


def _traced_sample_next(real, steps: list, kernels):
    """``serve.sample_next`` that records each step's logits, token ids,
    host-clock milliseconds (ending in a synchronize), kernel launches, the
    service's batches, and on a service route the kernel argsort's order."""

    def traced(logits, gen, **kw):
        target = kw.get("frontend") or kw.get("queue")
        futs = []
        if target is not None:
            name = "submit" if kw.get("frontend") is not None else "submit_async"
            submit = getattr(target, name)

            def recording(*a, **k):
                fut = submit(*a, **k)
                futs.append(fut)
                return fut

            setattr(target, name, recording)
            batches0, built0 = target.stats.batches, target.stats.compiles
        torch.cuda.synchronize()
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        try:
            tok = real(logits, gen, **kw)
            torch.cuda.synchronize()
        finally:
            if target is not None:
                delattr(target, name)
        ms = (time.perf_counter() - t0) * 1e3
        after = kernels.launch_counts()
        steps.append({
            "logits": logits.float().clone(), "tokens": tok.clone(), "ms": ms,
            "launches": {k: after[k] - before.get(k, 0) for k in after if after[k] - before.get(k, 0)},
            "batches": None if target is None else target.stats.batches - batches0,
            # a cell's first use runs it once on zeros before the batch
            "cells_built": None if target is None else target.stats.compiles - built0,
            "orders": None if target is None else [np.asarray(f.result()) for f in futs],
        })
        return tok

    return traced


def _lm_profiles(params, cfg, prompts, gen_ids, logits, sample_next, device) -> dict:
    """torch.profiler over one prefill, one decode step and one top-k step
    through an AsyncSortService on the default planner's plans: device
    time, the call's host-clock time, the idle share between them."""
    from repro_torch.engine import AsyncSortService
    from repro_torch.train.steps import prefill_step, serve_decode_step

    prompts_t = torch.from_numpy(prompts.astype(np.int32)).to(device)
    with torch.no_grad():
        _, cache = prefill_step(params, cfg, prompts_t, cache_len=LM_PROMPT + LM_GEN)
        nxt = torch.from_numpy(gen_ids[:, :1]).to(device)
        profs = {"prefill": device_profile(
                     lambda: prefill_step(params, cfg, prompts_t, cache_len=LM_PROMPT + LM_GEN)),
                 "decode_step": device_profile(lambda: serve_decode_step(params, cfg, nxt, cache))}
    queue = AsyncSortService(max_batch=LM_BATCH, max_delay_ms=2.0, device=device)
    try:
        gen = torch.Generator(device=device).manual_seed(0)
        profs["topk_step_queue"] = device_profile(
            lambda: sample_next(logits, gen, temperature=0, top_k=LM_TOPK, queue=queue))
    finally:
        queue.close()
    for prof in profs.values():
        prof["device_idle_share"] = 1.0 - prof["device_ms"] / prof["wall_ms"]
    return profs


def phase_lm_serve(kernels, device, add) -> dict:
    """serve.main on qwen3-0.6b at full size on the three top-k routes; the
    service routes on kernel plans through $REPRO_SORT_PLANS."""
    import contextlib
    import io

    from repro_torch.configs.base import ARCHS
    from repro_torch.engine.planner import plan_key
    from repro_torch.launch import serve
    from repro_torch.models.transformer import forward, model_init

    cfg = ARCHS[LM_ARCH]
    path = os.path.join(ROOT, "build", "lm_serve", "plans.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    bucket = 1 << (cfg.vocab_size - 1).bit_length()
    with open(path, "w") as f:  # the reference's 'pallas' plan for the vocab cell
        json.dump({"version": 3, "plans": {plan_key(bucket, torch.float32, device=device): {
            "strategy": "shared", "local_impl": "pallas", "block_n": 1024}}}, f)
    per_batch = expected_launches(cfg.vocab_size, 1024, kv=True)
    flags = ["--arch", LM_ARCH, "--batch", str(LM_BATCH), "--prompt-len", str(LM_PROMPT),
             "--gen", str(LM_GEN), "--temperature", "0"]
    routes = {"direct": [], "queue": ["--topk-queue", "--stats"],
              "tenants": ["--tenants", "web:3:0,batch:1:1", "--slo-ms", "40", "--warmup",
                          "--stats"]}
    saved = _fresh_default_planner(path)
    real = serve.sample_next
    torch.cuda.reset_peak_memory_stats()
    report, tokens, first_steps = {}, {}, None
    try:
        for route, extra in routes.items():
            steps = []
            serve.sample_next = _traced_sample_next(real, steps, kernels)
            buf = io.StringIO()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                gen_ids = serve.main(flags + extra)
            seconds = time.perf_counter() - t0
            counts = {k: v for k, v in kernels.launch_counts().items() if v}
            add(counts)
            serve.sample_next = real
            out = buf.getvalue()
            print(out, file=sys.stderr, flush=True)
            check(gen_ids.shape == (LM_BATCH, LM_GEN) and gen_ids.max() < cfg.vocab_size
                  and gen_ids.min() >= 0, f"lm_serve {route}: token ids")
            tokens[route] = gen_ids
            entry = {"seconds": seconds, **_parse_driver(out), "driver_output": out.splitlines(),
                     "topk_ms_per_step": [s["ms"] for s in steps], "launches": counts}
            if route != "direct":
                for i, s in enumerate(steps):
                    calls = s["batches"] + s["cells_built"]
                    check(s["batches"] >= 1 and s["launches"] == {
                        k: v * calls for k, v in per_batch.items()},
                        f"lm_serve {route} step {i}: {s['launches']} for {s['batches']} batches "
                        f"and {s['cells_built']} cells built")
                    for row, order in zip(s["logits"].cpu().numpy(), s["orders"]):
                        want = np.argsort(-row, kind="stable")[:LM_TOPK]
                        check(np.array_equal(order[:LM_TOPK], want),
                              f"lm_serve {route} step {i}: top-{LM_TOPK} differs from numpy")
                entry["batches_per_step"] = [s["batches"] for s in steps]
                entry["cells_built_per_step"] = [s["cells_built"] for s in steps]
                entry["launches_per_step"] = [s["launches"] for s in steps]
                check(all(counts.get(k, 0) > 0 for k in per_batch),
                      f"lm_serve {route}: a kv kernel was not launched")
            else:
                first_steps = steps
            report[route] = entry
        for route in ("queue", "tenants"):
            check(np.array_equal(tokens[route], tokens["direct"]),
                  f"lm_serve: greedy tokens of {route} differ from direct")
        # prefill's and every decode step's logits against one forward over
        # the prompt and the tokens the steps fed back
        params = model_init(torch.Generator(device=device).manual_seed(0), cfg, device=device)
        prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(LM_BATCH, LM_PROMPT))
        seq = np.concatenate([prompts, tokens["direct"][:, :-1]], axis=1).astype(np.int32)
        with torch.no_grad():
            full, _ = forward(params, cfg, torch.from_numpy(seq).to(device))
        checks = [_logits_check(f"lm_serve step {i}", s["logits"], full[:, LM_PROMPT - 1 + i])
                  for i, s in enumerate(first_steps)]
        del full
        profiles = _lm_profiles(params, cfg, prompts, tokens["direct"], first_steps[-1]["logits"],
                                real, device)
        del params
    finally:
        serve.sample_next = real
        _restore_default_planner(saved)
    torch.cuda.empty_cache()
    return {"arch": LM_ARCH, "params": cfg.param_count(), "dtype": "bfloat16",
            "batch": LM_BATCH, "prompt_len": LM_PROMPT, "gen": LM_GEN, "top_k": LM_TOPK,
            "plan_file": os.path.relpath(path, ROOT), "expected_launches_per_batch": per_batch,
            "routes": report, "greedy_tokens_equal": True, "topk_equal_numpy": True,
            "logits_vs_forward": {"tolerance": LOGIT_TOLERANCE, "steps": checks},
            "profiles": profiles,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "first_row_tokens": tokens["direct"][0].tolist()}


def phase_lm_moe(device) -> dict:
    """granite-moe-3b-a800m through prefill_step and serve_decode_step,
    greedy, every layer's FFN through moe_apply_ep_replicated; logits
    against forward."""
    from dataclasses import replace

    from repro_torch.configs.base import ARCHS
    from repro_torch.models.transformer import forward, model_init
    from repro_torch.train.steps import prefill_step, serve_decode_step

    base = ARCHS[MOE_ARCH]
    # loss-free capacity (T * top_k slots) so an 8-token decode batch drops
    # nothing and its logits are comparable with forward's
    cfg = replace(base, capacity_factor=float(base.n_experts))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model_init(torch.Generator(device=device).manual_seed(0), cfg, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT)).astype(np.int32)).to(device)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill_step(params, cfg, prompts, cache_len=LM_PROMPT + MOE_GEN)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        step_logits, toks = [logits], [logits.argmax(-1).to(torch.int32)]
        t0 = time.perf_counter()
        for _ in range(MOE_GEN - 1):
            lg, cache = serve_decode_step(params, cfg, toks[-1][:, None], cache)
            step_logits.append(lg[:, 0])
            toks.append(lg[:, 0].argmax(-1).to(torch.int32))
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / max(MOE_GEN - 1, 1)
        seq = torch.cat([prompts, torch.stack(toks[:-1], 1)], dim=1)
        decode_prof = device_profile(lambda: serve_decode_step(params, cfg, toks[-1][:, None], cache))
        decode_prof["device_idle_share"] = 1.0 - decode_prof["device_ms"] / decode_prof["wall_ms"]
        full, stats = forward(params, cfg, seq)
        _, stats_cf2 = forward(params, base, seq)  # the config's own capacity factor
    checks = [_logits_check(f"lm_moe step {i}", lg, full[:, LM_PROMPT - 1 + i])
              for i, lg in enumerate(step_logits)]
    for name, st in (("loss-free", stats), ("cf 2.0", stats_cf2)):
        check(bool(torch.isfinite(st["moe_aux"])), f"lm_moe: moe_aux not finite ({name})")
    ids = torch.stack(toks, 1)
    check(int(ids.max()) < cfg.vocab_size and int(ids.min()) >= 0, "lm_moe: token ids")
    out = {"arch": MOE_ARCH, "n_layers": cfg.n_layers, "depth_cut": None,
           "params": cfg.param_count(), "dtype": "bfloat16", "batch": LM_BATCH,
           "prompt_len": LM_PROMPT, "decode_steps": MOE_GEN - 1,
           "capacity_factor": cfg.capacity_factor, "init_s": init_s, "prefill_ms": prefill_ms,
           "decode_ms_per_token": decode_ms, "decode_step_profile": decode_prof,
           "logits_vs_forward": {"tolerance": LOGIT_TOLERANCE, "steps": checks},
           "moe_aux": float(stats["moe_aux"]), "moe_overflow": bool(stats["moe_overflow"]),
           "moe_aux_cf2": float(stats_cf2["moe_aux"]),
           "moe_overflow_cf2": bool(stats_cf2["moe_overflow"]),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    del params, cache, full
    torch.cuda.empty_cache()
    return out


def _dense_moe(p, cfg, x, x_ffn=None):
    """Every token through each of its top-k experts, gate-weighted: the
    plain evaluation the dispatch must equal.  ``x_ffn`` feeds the FFNs
    (the int8 wire's dequantized rows) where routing reads ``x``."""
    import torch.nn.functional as F

    from repro_torch.models.moe import router_probs

    _, idx, gate, _ = router_probs(p, cfg, x)
    h_in = x if x_ffn is None else x_ffn
    h = torch.einsum("td,edf->etf", h_in, p["w_in"])
    h = F.silu(torch.einsum("td,edf->etf", h_in, p["w_gate"])) * h
    y = torch.einsum("etf,efd->etd", h, p["w_out"])  # (E, T, D)
    picked = y[idx.long(), torch.arange(x.shape[0], device=x.device)[:, None]]  # (T, k, D)
    return torch.einsum("tkd,tk->td", picked, gate), idx


def phase_moe_serve(device) -> dict:
    """The --moe route of serve.main, then the capacity loop at granite's
    MoE width on one device and on one NCCL rank."""
    import contextlib
    import io
    import re

    from repro_torch.engine.planner import Planner
    from repro_torch.exchange import AxisGroup
    from repro_torch.exchange.collective import _dequantize_rows, _quantize_rows
    from repro_torch.launch import serve
    from repro_torch.models.moe import (
        MoEConfig,
        collapse_router,
        moe_apply_adaptive,
        moe_apply_local_adaptive,
        moe_init,
        moe_plan_key,
    )

    # (a) the driver's --moe route, as the reference runs it
    saved = _fresh_default_planner(None)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            serve.main(["--moe", "--batch", "8", "--prompt-len", "64", "--gen", "8",
                        "--experts", "8", "--moe-skew", "6.0", "--stats"])
    finally:
        _restore_default_planner(saved)
    text = buf.getvalue()
    stats = dict(kv.split("=") for kv in re.search(r"moe-stats: (.*)", text).group(1).split())
    first = int(re.search(r"\(retries=(\d+)\)", text).group(1))
    check(first >= 1 and int(stats["retries"]) == first,
          f"moe_serve --moe: retries {stats['retries']}, first step {first}")

    # (b) moe_apply_adaptive at granite's MoE width, through a plan file
    cfg = MoEConfig(**MOE_WIDTH)
    gen = torch.Generator(device=device).manual_seed(3)
    p = collapse_router(moe_init(gen, cfg, torch.float32, ep_shards=1, device=device))
    x = torch.randn(MOE_TOKENS, cfg.d_model, generator=gen, device=device)
    want, _ = _dense_moe(p, cfg, x)
    path = os.path.join(ROOT, "build", "moe_serve", "plans.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        os.remove(path)
    key = moe_plan_key(MOE_TOKENS, cfg, torch.float32, device=device)
    planner = Planner(path, device=device)
    calls = []
    for call in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, _, counts = moe_apply_adaptive(p, cfg, x, planner=planner)
        torch.cuda.synchronize()
        obs = planner.telemetry.last(key)
        calls.append({"ms": (time.perf_counter() - t0) * 1e3, "retries": obs.retries,
                      "capacity": obs.capacity, "peak": obs.peak, "dropped": obs.dropped,
                      "dropped_averted": obs.dropped_averted, "max_abs_err": max_abs_err(y, want)})
        check(torch.allclose(y, want, atol=MOE_ATOL, rtol=MOE_ATOL),
              f"moe_serve adaptive call {call}: off the dense evaluation")
    check(calls[0]["retries"] >= 1 and all(c["retries"] == 0 for c in calls[1:]),
          f"moe_serve adaptive: retries {[c['retries'] for c in calls]}")
    learned = planner.capacity_factor_for(key, default=cfg.capacity_factor)
    reloaded = Planner(path, device=device)
    y, _, _ = moe_apply_adaptive(p, cfg, x, planner=reloaded)
    check(reloaded.telemetry.last(key).retries == 0, "moe_serve: the reloaded planner retried")
    check(torch.allclose(y, want, atol=MOE_ATOL, rtol=MOE_ATOL), "moe_serve reloaded: output")

    # the exchange's token-row gathers at this width: dispatch (x repeated
    # k times, in bucket order) and combine (slab rows back per assignment)
    m = MOE_TOKENS * cfg.top_k
    order = torch.randperm(m, generator=gen, device=device)
    vals = torch.repeat_interleave(x, cfg.top_k, dim=0)
    slab = torch.randn(cfg.n_experts * calls[-1]["capacity"], cfg.d_model, generator=gen,
                       device=device)
    back = torch.randint(0, slab.shape[0], (m,), generator=gen, device=device)
    row_bytes = cfg.d_model * 4
    gather = {}
    for label, fn in (("dispatch_rows", lambda: vals[order]), ("combine_rows", lambda: slab[back])):
        ms = time_ms(fn, reps=20)
        gather[label] = {"rows": m, "row_bytes": row_bytes, "ms": ms,
                         "gb_per_s": 2 * m * row_bytes / ms / 1e6,
                         "bytes_bound_ms": 2 * m * row_bytes / HBM_BYTES_PER_S * 1e3}

    # (c) moe_apply_local_adaptive on the one NCCL rank, plain and int8 wire
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    local = {}
    try:
        group = AxisGroup()
        for compress in (False, True):
            ccfg = cfg._replace(compress_dispatch=compress)
            lplanner = Planner(device=device)
            lkey = moe_plan_key(MOE_TOKENS, ccfg, torch.float32, group, device=device)
            retries = []
            for _ in range(3):
                y, _, counts = moe_apply_local_adaptive(p, ccfg, x, group, planner=lplanner)
                retries.append(lplanner.telemetry.last(lkey).retries)
            if compress:
                q, s = _quantize_rows(x)
                ref_y, _ = _dense_moe(p, ccfg, x, _dequantize_rows(q, s, x.dtype))
            else:
                ref_y = want
            err = max_abs_err(y, ref_y)
            check(torch.allclose(y, ref_y, atol=MOE_ATOL, rtol=MOE_ATOL),
                  f"moe_serve local compress={compress}: off the dense evaluation ({err})")
            check(retries[0] >= 1 and retries[1:] == [0, 0], f"moe_serve local retries {retries}")
            check(int(counts.sum()) == m, "moe_serve local: counts")
            local["int8_wire" if compress else "plain_wire"] = {"retries": retries,
                                                                "max_abs_err": err}
    finally:
        dist.destroy_process_group()
    del p, x, want, vals, slab
    torch.cuda.empty_cache()
    return {"driver_moe": {"flags": "--moe --batch 8 --prompt-len 64 --gen 8 --experts 8 "
                           "--moe-skew 6.0 --stats", "stats": stats, "first_step_retries": first,
                           "output": text.splitlines()},
            "adaptive": {"d_model": cfg.d_model, "d_ff": cfg.d_ff, "experts": cfg.n_experts,
                         "top_k": cfg.top_k, "tokens": MOE_TOKENS, "dtype": "float32",
                         "router": "collapse_router", "tolerance": {"atol": MOE_ATOL, "rtol": MOE_ATOL},
                         "calls": calls, "learned_factor": learned,
                         "reloaded_first_call_retries": 0},
            "local_one_nccl_rank": local, "token_row_gather": gather}


def _timed_train_step(real, log: list, last: dict):
    """``train.train_step`` that records each step's host-clock ms (ending in
    a synchronize), loss and grad_norm, and keeps the last step's outputs
    and arguments for a profile."""

    def timed(params, opt, batch, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new_params, new_opt, m = real(params, opt, batch, **kw)
        torch.cuda.synchronize()
        log.append({"ms": (time.perf_counter() - t0) * 1e3, "loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"])})
        last.update(params=new_params, opt=new_opt, batch=batch, kw=kw)
        return new_params, new_opt, m

    return timed


def _run_train(train, flags: list, wrap=None):
    """``train.main(flags)`` with stdout captured and ``train.train_step``
    wrapped by ``wrap``; returns (losses, output)."""
    real = train.train_step
    buf = io.StringIO()
    try:
        if wrap is not None:
            train.train_step = wrap(real)
        with contextlib.redirect_stdout(buf):
            losses = train.main(flags)
    finally:
        train.train_step = real
    print(buf.getvalue(), file=sys.stderr, flush=True)
    return losses, buf.getvalue()


def _train_step_against_cpu(device) -> dict:
    """One train_step of a float32 full-width two-layer qwen3 on the card
    and on the CPU, from the same params and batch, TF32 off."""
    from dataclasses import replace

    from repro_torch.configs.base import ARCHS
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.transformer import model_init
    from repro_torch.optim.adamw import OptConfig, init_opt_state
    from repro_torch.train.steps import train_step
    from repro_torch.tree import at_path, map_leaves, paths

    cfg = replace(ARCHS[LM_ARCH], name=f"{LM_ARCH}-{CHECK_LAYERS}l-f32", n_layers=CHECK_LAYERS,
                  param_dtype=torch.float32, compute_dtype=torch.float32)
    ocfg = OptConfig(peak_lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
    params = model_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    b = SyntheticLM(cfg.vocab_size, CHECK_BATCH, CHECK_SEQ, seed=0)._batch_at(0)
    kw = dict(cfg=cfg, opt_cfg=ocfg, loss_chunk=min(64, CHECK_SEQ))
    out = []
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev in (torch.device("cpu"), device):
            p = map_leaves(lambda t: t.to(dev), params)
            batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
            t0 = time.perf_counter()
            new, _, m = train_step(p, init_opt_state(p, ocfg), batch, **kw)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            out.append((map_leaves(lambda t: t.cpu(), new), {k: float(v) for k, v in m.items()},
                        (time.perf_counter() - t0) * 1e3))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (cpu_new, cpu_m, cpu_ms), (gpu_new, gpu_m, gpu_ms) = out
    rel = {k: abs(gpu_m[k] - cpu_m[k]) / abs(cpu_m[k]) for k in ("loss", "grad_norm", "lr")}
    check(all(r <= CHECK_RTOL for r in rel.values()), f"lm_train card vs CPU: metrics {rel}")
    worst = max(_rel_l2(at_path(gpu_new, path).double() - old.double(),
                        at_path(cpu_new, path).double() - old.double())
                for path, old in paths(params))
    check(worst <= CHECK_UPDATE_RL2, f"lm_train card vs CPU: update rel L2 {worst}")
    return {"arch": cfg.name, "dtype": "float32", "d_model": cfg.d_model, "vocab": cfg.vocab_size,
            "n_layers": CHECK_LAYERS, "batch": CHECK_BATCH, "seq": CHECK_SEQ, "tf32": False,
            "tolerance": {"metrics_rel": CHECK_RTOL, "update_rel_l2": CHECK_UPDATE_RL2},
            "metrics_rel_err": rel, "update_rel_l2_worst": worst, "loss": gpu_m["loss"],
            "card_ms": gpu_ms, "cpu_ms": cpu_ms}


def _recovery(train, arch: str, root: str) -> dict:
    """The driver with checkpoints every RECOVERY_EVERY steps, clean and with
    a TrainingAnomaly injected at step RECOVERY_FAIL: the replayed losses
    and the final checkpoint equal the clean run's bit for bit."""
    from repro_torch.configs.base import ARCHS
    from repro_torch.distributed.fault_tolerance import TrainingAnomaly

    flags = ["--arch", arch, "--batch", str(RECOVERY_BATCH), "--seq", str(RECOVERY_SEQ),
             "--steps", str(RECOVERY_STEPS), "--lr", TRAIN_LR, "--ckpt-every",
             str(RECOVERY_EVERY), "--log-every", "1"]
    runs = {}
    for label in ("clean", "replayed"):
        calls = []

        def failing_once(real):
            def step(*a, **k):
                calls.append(len(calls))
                if label == "replayed" and len(calls) == RECOVERY_FAIL + 1:
                    raise TrainingAnomaly("injected by chip_smoke")
                return real(*a, **k)
            return step

        ckpt = os.path.join(root, f"recovery_{label}")
        shutil.rmtree(ckpt, ignore_errors=True)
        t0 = time.perf_counter()
        losses, out = _run_train(train, flags + ["--ckpt-dir", ckpt], failing_once)
        runs[label] = {"losses": losses, "seconds": time.perf_counter() - t0,
                       "restarts": int(re.search(r"\((\d+) restarts\)", out).group(1)),
                       "calls": len(calls)}
    clean, replayed = runs["clean"]["losses"], runs["replayed"]["losses"]
    want = clean[:RECOVERY_FAIL] + clean[RECOVERY_FAIL - RECOVERY_FAIL % RECOVERY_EVERY:]
    check(runs["replayed"]["restarts"] == 1, "lm_train recovery: restarts")
    check(replayed == want, f"lm_train recovery: losses {replayed} against {want}")
    final = f"step_{RECOVERY_STEPS:08d}"
    ends = [np.load(os.path.join(root, f"recovery_{label}", final, "leaves.npz"))
            for label in ("clean", "replayed")]
    check(ends[0].files == ends[1].files, "lm_train recovery: leaf counts")
    for k in ends[0].files:
        a, b = ends[0][k], ends[1][k]
        check(a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(),
              f"lm_train recovery: leaf {k} differs")
    for label in runs:
        shutil.rmtree(os.path.join(root, f"recovery_{label}"), ignore_errors=True)
    return {"arch": arch, "dtype": str(ARCHS[arch].param_dtype).removeprefix("torch."),
            "batch": RECOVERY_BATCH, "seq": RECOVERY_SEQ,
            "steps": RECOVERY_STEPS, "ckpt_every": RECOVERY_EVERY, "fail_at_step": RECOVERY_FAIL,
            "restored_step": RECOVERY_FAIL - RECOVERY_FAIL % RECOVERY_EVERY,
            "losses_clean": clean, "losses_replayed": replayed, "bitwise_equal": True,
            "leaves": len(ends[0].files), "seconds": {k: v["seconds"] for k, v in runs.items()}}


def _moe_train(train, serve, arch: str, arch_f32: str, root: str) -> dict:
    """granite's MoE width through the driver with a collapsed router and
    --lr 0 (which keeps the router collapsed): drops on the first step
    only, the capacity rises once and holds; then serve --moe on the same
    plan file starts at the learned factor (no retry on its first call)."""
    from repro_torch.configs.base import ARCHS

    plans = os.path.join(root, "plans.json")
    if os.path.exists(plans):
        os.remove(plans)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flags = ["--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--lr", "0",
             "--moe-skew", MOE_TRAIN_SKEW, "--log-every", "1", "--plans", plans]
    log, last = [], {}
    torch.cuda.reset_peak_memory_stats()
    losses, out = _run_train(train, ["--arch", arch, "--steps", str(MOE_TRAIN_STEPS)] + flags,
                             lambda real: _timed_train_step(real, log, last))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    last.clear()
    steps = [tuple(map(int, m)) for m in
             re.findall(r"moe\[cap (\d+) drop (\d+) peak (\d+)\]", out)]
    caps, drops = [c for c, _, _ in steps], [d for _, d, _ in steps]
    check(len(steps) == MOE_TRAIN_STEPS and drops[0] > 0 and not any(drops[1:]),
          f"lm_train moe: drops {drops}")
    check(caps[0] < caps[1] and len(set(caps[1:])) == 1, f"lm_train moe: capacities {caps}")
    check(all(np.isfinite(losses)), "lm_train moe: loss not finite")
    bf16_cell = re.search(r"cell=(\S+)", out).group(1)
    # the plan cell names the compute dtype and serve --moe's is float32, so
    # the learned factor serving reads comes from a float32 step of the model
    _, out32 = _run_train(train, ["--arch", arch_f32, "--steps", "1"] + flags)
    f32_cell = re.search(r"cell=(\S+)", out32).group(1)
    saved = _fresh_default_planner(plans)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            serve.main(["--moe", "--batch", str(TRAIN_BATCH), "--prompt-len", str(TRAIN_SEQ),
                        "--gen", "2", "--experts", str(MOE_WIDTH["n_experts"]), "--moe-top-k",
                        str(MOE_WIDTH["top_k"]), "--moe-skew", MOE_TRAIN_SKEW, "--stats"])
    finally:
        _restore_default_planner(saved)
    served = buf.getvalue()
    first = int(re.search(r"\(retries=(\d+)\)", served).group(1))
    check(first == 0, f"lm_train moe: serve --moe retried {first} times on its first call")
    ms = [s["ms"] for s in log]
    return {"arch": arch, "n_layers": MOE_TRAIN_LAYERS,
            "dtype": str(ARCHS[arch].param_dtype).removeprefix("torch."), "batch": TRAIN_BATCH,
            "seq": TRAIN_SEQ, "tokens_per_step": tokens, "lr": 0.0, "moe_skew": float(MOE_TRAIN_SKEW),
            "capacity_per_step": caps, "dropped_per_step": drops,
            "peak_per_step": [p for _, _, p in steps], "cell": bf16_cell, "f32_cell": f32_cell,
            "ms_per_step": ms, "steady_ms_per_step": float(np.mean(ms[1:])),
            "peak_memory_gb": peak_gb, "serve_first_call_retries": first,
            "serve_output": served.splitlines(), "plan_file": os.path.relpath(plans, ROOT)}


def phase_lm_train(kernels, device) -> dict:
    """The training path on the card: qwen3-0.6b at full size through
    repro_torch.launch.train.main, one train_step against the CPU's, a
    restart replayed bit for bit, and the MoE capacity loop at granite's
    width warming serve --moe."""
    from dataclasses import replace

    from repro_torch.configs.base import ARCHS
    from repro_torch.launch import serve, train

    root = os.path.join(ROOT, "build", "lm_train")
    os.makedirs(root, exist_ok=True)
    extra = {
        f"{LM_ARCH}-{CHECK_LAYERS}l": replace(ARCHS[LM_ARCH], name=f"{LM_ARCH}-{CHECK_LAYERS}l",
                                              n_layers=CHECK_LAYERS),
        f"{MOE_ARCH}-{MOE_TRAIN_LAYERS}l": replace(ARCHS[MOE_ARCH],
                                                   name=f"{MOE_ARCH}-{MOE_TRAIN_LAYERS}l",
                                                   n_layers=MOE_TRAIN_LAYERS),
    }
    extra[f"{MOE_ARCH}-{MOE_TRAIN_LAYERS}l-f32"] = replace(
        extra[f"{MOE_ARCH}-{MOE_TRAIN_LAYERS}l"], name=f"{MOE_ARCH}-{MOE_TRAIN_LAYERS}l-f32",
        param_dtype=torch.float32, compute_dtype=torch.float32)
    ARCHS.update(extra)
    kernels.reset_launch_counts()
    try:
        # (a) full size: qwen3-0.6b, 28 layers, bf16, f32 AdamW state
        log, last = [], {}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses, out = _run_train(
            train, ["--arch", LM_ARCH, "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                    "--steps", str(TRAIN_STEPS), "--lr", TRAIN_LR, "--log-every", "1"],
            lambda real: _timed_train_step(real, log, last))
        seconds = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(len(log) == TRAIN_STEPS and all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"])
                                              for s in log), "lm_train: loss or grad_norm not finite")
        check(losses[-1] < losses[0], f"lm_train: loss at step {TRAIN_STEPS} {losses[-1]} "
                                      f"not below step 1's {losses[0]}")
        ms = [s["ms"] for s in log]
        steady = float(np.mean(ms[1:]))
        prof = device_profile(lambda: train.train_step(last["params"], last["opt"], last["batch"],
                                                       **last["kw"]))
        prof["device_idle_share"] = 1.0 - prof["device_ms"] / prof["wall_ms"]
        last.clear()
        torch.cuda.empty_cache()
        full = {"arch": LM_ARCH, "params": ARCHS[LM_ARCH].param_count(),
                "dtype": str(ARCHS[LM_ARCH].param_dtype).removeprefix("torch."),
                "opt_state": "f32", "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
                "lr": float(TRAIN_LR), "losses": losses, "grad_norms": [s["grad_norm"] for s in log],
                "ms_per_step": ms, "steady_ms_per_step": steady,
                "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / steady * 1e3,
                "peak_memory_gb": peak_gb, "seconds": seconds, "step_profile": prof}

        # (b) one step on the card against the same step on the CPU
        against_cpu = _train_step_against_cpu(device)
        torch.cuda.empty_cache()
        # (c) a restart replayed bit for bit
        recovery = _recovery(train, f"{LM_ARCH}-{CHECK_LAYERS}l", root)
        torch.cuda.empty_cache()
        # (d) the MoE capacity loop at granite's width, warming serve --moe
        moe = _moe_train(train, serve, f"{MOE_ARCH}-{MOE_TRAIN_LAYERS}l",
                         f"{MOE_ARCH}-{MOE_TRAIN_LAYERS}l-f32", root)
        torch.cuda.empty_cache()
    finally:
        for name in extra:
            ARCHS.pop(name, None)
    launches = {k: v for k, v in kernels.launch_counts().items() if v}
    check(not launches, f"lm_train: the training path launched sort kernels {launches}")
    return {"full_size": full, "card_vs_cpu": against_cpu, "recovery": recovery, "moe": moe,
            "kernel_launches": launches}


def _mesh_archs():
    """granite at MESH_LAYERS layers in bf16 and at MESH_CHECK_LAYERS in
    float32, registered in ARCHS (each spawned rank registers its own)."""
    from dataclasses import replace

    from repro_torch.configs.base import ARCHS

    bf16 = f"{MOE_ARCH}-{MESH_LAYERS}l"
    f32 = f"{MOE_ARCH}-{MESH_CHECK_LAYERS}l-f32"
    ARCHS[bf16] = replace(ARCHS[MOE_ARCH], name=bf16, n_layers=MESH_LAYERS)
    ARCHS[f32] = replace(ARCHS[MOE_ARCH], name=f32, n_layers=MESH_CHECK_LAYERS,
                         param_dtype=torch.float32, compute_dtype=torch.float32)
    return bf16, f32


def _nbytes(*trees) -> int:
    from repro_torch.tree import paths

    return sum(t.numel() * t.element_size() for tree in trees for _, t in paths(tree))


def _mesh_check(f32: str, batch_size: int, seq: int, device) -> dict:
    """The float32 check on the (data=2, model=2) mesh and, on rank 0, on
    one rank: loss without the aux term and the global gradient norm at
    loss-free capacity, MoE drops; then a greedy decode of MESH_DECODE
    tokens from a MESH_PROMPT-token prompt."""
    from repro_torch.configs.base import ARCHS
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed.sharding import (batch_specs, compute_specs, fit_tree,
                                                  param_specs, shard_tree)
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.transformer import ShardCtx, model_init
    from repro_torch.optim.adamw import global_norm
    from repro_torch.train.steps import loss_fn, prefill_step, serve_decode_step
    from repro_torch.tree import from_paths, paths

    cfg = ARCHS[f32]
    mesh = Mesh((2, 2), ("data", "model"))
    full = model_init(torch.Generator(device=device).manual_seed(0), cfg, ep_shards=2,
                      device=device)
    b = SyntheticLM(cfg.vocab_size, batch_size, seq, seed=0)._batch_at(0)
    whole = {k: torch.from_numpy(v).to(device) for k, v in b.items()}

    def loss_and_norm(params, batch, ctx, specs, cap):
        pairs = list(paths(params))
        leaves = [t.detach().requires_grad_(True) for _, t in pairs]
        loss, stats = loss_fn(from_paths((p, t) for (p, _), t in zip(pairs, leaves)), cfg, batch,
                              ctx=ctx, aux_weight=0.0, loss_chunk=64, moe_capacity=cap,
                              specs=specs)
        grads = from_paths((p, g) for (p, _), g in
                           zip(pairs, torch.autograd.grad(loss, leaves)))
        gnorm = global_norm(grads, specs, ctx.mesh)
        return {"loss": float(loss.detach()), "grad_norm": float(gnorm),
                "moe_dropped": int(stats["moe_dropped"]), "moe_peak": int(stats["moe_peak"])}

    def greedy(params, prompt, ctx):
        with torch.no_grad():
            last, cache = prefill_step(params, cfg, prompt, ctx=ctx,
                                       cache_len=MESH_PROMPT + MESH_DECODE)
            nxt, toks = torch.argmax(last, -1), []
            for _ in range(MESH_DECODE):
                toks.append(nxt)
                logits, cache = serve_decode_step(params, cfg, nxt[:, None].int(), cache, ctx=ctx)
                nxt = torch.argmax(logits[:, 0], -1)
        return torch.stack(toks, 1).tolist()

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ctx = ShardCtx(mesh=mesh, axes=mesh.axis_names)
        specs = fit_tree(param_specs(full), full, mesh)
        # a sender's tokens fill at most that many slots of one expert: loss-free
        report = {"mesh": loss_and_norm(shard_tree(full, specs, mesh),
                                        shard_tree(whole, batch_specs(whole), mesh), ctx, specs,
                                        batch_size * seq // mesh.size)}
        compute = shard_tree(full, compute_specs(param_specs(full), cfg, 2), mesh)
        rows = shard_tree(whole, batch_specs(whole), mesh)["tokens"][:, :MESH_PROMPT]
        report["mesh_greedy"] = greedy(compute, rows.contiguous(), ctx)
        del compute
        if mesh.rank == 0:  # one rank: the same model, batch and prompt, no mesh
            report["one_rank"] = loss_and_norm(full, whole, ShardCtx(), None, batch_size * seq)
            report["one_rank_greedy"] = greedy(full, whole["tokens"][:, :MESH_PROMPT].contiguous(),
                                               ShardCtx())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    report["coords"] = mesh.coords
    return report


def mesh_rank(rank: int, world: int, store: str, result: str, device_type: str = "cuda") -> None:
    """One rank of phase lm_mesh's (data=2, model=2) run (a spawned process
    on the one card, gloo): the driver at granite's width, then the float32
    check and the greedy decode."""
    from repro_torch.kernels.bitonic_sort import bitonic_sort as kernels
    from repro_torch.launch import train

    if device_type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        bf16, f32 = _mesh_archs()
        kernels.reset_launch_counts()
        log, last = [], {}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses, out = _run_train(
            train, ["--arch", bf16, "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                    "--steps", str(MESH_STEPS), "--lr", TRAIN_LR, "--log-every", "1",
                    "--mesh", MESH_SPEC, "--dist-backend", "gloo", "--device", device_type],
            lambda real: _timed_train_step(real, log, last))
        report = {"rank": rank, "losses": losses, "seconds": time.perf_counter() - t0,
                  "ms_per_step": [s["ms"] for s in log], "grad_norms": [s["grad_norm"] for s in log],
                  "param_bytes": _nbytes(last["params"]),
                  "moment_bytes": _nbytes(last["opt"]["m"], last["opt"]["v"]),
                  "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                  "moe": [tuple(map(int, m)) for m in
                          re.findall(r"moe\[cap (\d+) drop (\d+) peak (\d+)\]", out)],
                  "params_m": float(re.search(r"params=([\d.]+)M", out).group(1))
                  if rank == 0 else None}
        last.clear()
        torch.cuda.empty_cache()
        report["check"] = _mesh_check(f32, TRAIN_BATCH, TRAIN_SEQ, torch.device(device_type))
        report["kernel_launches"] = {k: v for k, v in kernels.launch_counts().items() if v}
        with open(f"{result}.{rank}.json", "w") as f:
            json.dump(report, f)
    finally:
        dist.destroy_process_group()


def _spawn(fn, args, nprocs: int) -> None:
    import torch.multiprocessing as mp

    mp.start_processes(fn, args=args, nprocs=nprocs, join=True, start_method="spawn")


def phase_lm_mesh(kernels, device, lm_train: dict) -> dict:
    """train --mesh: one NCCL rank at qwen3-0.6b's full size, then four gloo
    ranks sharing the card at granite's full width."""
    from repro_torch.launch import train

    kernels.reset_launch_counts()
    # (a) one NCCL rank: lm_train's run on a (data=1, model=1) mesh
    log, last = [], {}
    torch.cuda.reset_peak_memory_stats()
    losses, out = _run_train(
        train, ["--arch", LM_ARCH, "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                "--steps", str(MESH_ONE_STEPS), "--lr", TRAIN_LR, "--log-every", "1",
                "--mesh", "data=1,model=1", "--dist-backend", "nccl"],
        lambda real: _timed_train_step(real, log, last))
    last.clear()
    check(not dist.is_initialized(), "lm_mesh: the driver left its NCCL group up")
    check(all(np.isfinite(losses)), f"lm_mesh one rank: losses {losses}")
    want = lm_train["full_size"]["losses"][0]
    rel = abs(losses[0] - want) / abs(want)
    check(rel <= MESH_LOSS_RTOL, f"lm_mesh one rank: step-1 loss {losses[0]} against lm_train's {want}")
    ms = [s["ms"] for s in log]
    one = {"arch": LM_ARCH, "mesh": "data=1,model=1", "backend": "nccl", "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "steps": MESH_ONE_STEPS, "losses": losses,
           "step1_loss_rel_to_lm_train": rel, "tolerance": MESH_LOSS_RTOL, "ms_per_step": ms,
           "steady_ms_per_step": float(np.mean(ms[1:])),
           "lm_train_steady_ms_per_step": lm_train["full_size"]["steady_ms_per_step"],
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    launches = {k: v for k, v in kernels.launch_counts().items() if v}
    torch.cuda.empty_cache()

    # (b) four ranks on the one card over gloo, (data=2, model=2)
    work = os.path.join(ROOT, "build", "lm_mesh")
    os.makedirs(work, exist_ok=True)
    store, result = os.path.join(work, f"store.{os.getpid()}"), os.path.join(work, "result")
    for path in [store] + [f"{result}.{r}.json" for r in range(MESH_RANKS)]:
        if os.path.exists(path):
            os.remove(path)
    t0 = time.perf_counter()
    _spawn(mesh_rank, (MESH_RANKS, store, result), MESH_RANKS)
    seconds = time.perf_counter() - t0
    reports = []
    for r in range(MESH_RANKS):
        with open(f"{result}.{r}.json") as f:
            reports.append(json.load(f))
    r0 = reports[0]
    check(all(rep["losses"] == r0["losses"] for rep in reports), "lm_mesh: the ranks' losses differ")
    check(len(r0["losses"]) == MESH_STEPS and all(np.isfinite(r0["losses"] + r0["grad_norms"])),
          f"lm_mesh: losses {r0['losses']}")
    for rep in reports:
        for k, v in rep["kernel_launches"].items():
            launches[k] = launches.get(k, 0) + v
    check(not launches, f"lm_mesh: the mesh training path launched sort kernels {launches}")
    # the float32 check: every rank's mesh numbers equal, and within
    # MESH_CHECK_RTOL of one rank's
    mesh_m, one_m = r0["check"]["mesh"], r0["check"]["one_rank"]
    check(all(rep["check"]["mesh"] == mesh_m for rep in reports),
          "lm_mesh check: the ranks' numbers differ")
    rel_check = {k: abs(mesh_m[k] - one_m[k]) / abs(one_m[k]) for k in ("loss", "grad_norm")}
    check(all(v <= MESH_CHECK_RTOL for v in rel_check.values()),
          f"lm_mesh check: mesh {mesh_m} against one rank {one_m}")
    check(mesh_m["moe_dropped"] == one_m["moe_dropped"] == 0, "lm_mesh check: tokens dropped")
    greedy = [None] * 2
    for rep in reports:  # the rows of each data coordinate, equal over its model group
        d = rep["check"]["coords"]["data"]
        check(greedy[d] in (None, rep["check"]["mesh_greedy"]),
              "lm_mesh decode: a model group's ranks disagree")
        greedy[d] = rep["check"]["mesh_greedy"]
    check(greedy[0] + greedy[1] == r0["check"]["one_rank_greedy"],
          f"lm_mesh decode: mesh {greedy} against one rank {r0['check']['one_rank_greedy']}")
    n_params = r0["params_m"] * 1e6
    whole_bytes = {"params": n_params * 2, "moments": n_params * 8}  # bf16 params, f32 m and v
    return {
        "one_nccl_rank": one,
        "four_gloo_ranks": {
            "arch": f"{MOE_ARCH} ({MESH_LAYERS} of 32 layers)", "mesh": MESH_SPEC,
            "backend": "gloo (host-staged CUDA tensors; step times are not NCCL's)",
            "dtype": "bfloat16", "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "tokens_per_step": TRAIN_BATCH * TRAIN_SEQ, "steps": MESH_STEPS, "lr": float(TRAIN_LR),
            "losses": r0["losses"], "grad_norms": r0["grad_norms"],
            "ms_per_step_rank0": r0["ms_per_step"], "seconds": seconds,
            "params": n_params, "whole_bytes": whole_bytes,
            "rank_bytes": [{"params": rep["param_bytes"], "moments": rep["moment_bytes"],
                            "share_of_whole": (rep["param_bytes"] + rep["moment_bytes"])
                            / (whole_bytes["params"] + whole_bytes["moments"])}
                           for rep in reports],
            "peak_memory_gb": [rep["peak_memory_gb"] for rep in reports],
            "moe_cap_drop_peak_per_step": r0["moe"]},
        "float32_check": {"layers": MESH_CHECK_LAYERS, "aux_weight": 0.0, "tf32": False,
                          "capacity": "loss-free", "mesh": mesh_m, "one_rank": one_m,
                          "rel": rel_check, "tolerance": MESH_CHECK_RTOL},
        "greedy_decode": {"prompt": MESH_PROMPT, "tokens": MESH_DECODE, "mesh": greedy,
                          "equal_one_rank": True},
        "kernel_launches": launches}


def _measured_train_step(real, log: list, last: dict, records: list):
    """``_timed_train_step`` that also reads the card's peak over the step
    (less what the process holds besides the step's arguments, so it reads
    what the dry-run traces) and counts the step's collectives."""
    from repro_torch.exchange.group import CollectiveCounter
    from repro_torch.launch.dryrun import storage_bytes

    timed = _timed_train_step(real, log, last)

    def measured(params, opt, batch, **kw):
        torch.cuda.synchronize()
        other = torch.cuda.memory_allocated() - storage_bytes(params, opt, batch)
        torch.cuda.reset_peak_memory_stats()
        with CollectiveCounter() as coll:
            out = timed(params, opt, batch, **kw)
        records.append({"card_peak_bytes": torch.cuda.max_memory_allocated() - other,
                        "other_bytes": other, "collectives": coll.record(),
                        "loss_chunk": kw["loss_chunk"], "n_microbatch": kw["n_microbatch"],
                        "state_dtype": kw["opt_cfg"].state_dtype,
                        "batch": {k: list(v.shape) for k, v in batch.items()}})
        return out

    return measured


def _ssm_arch() -> str:
    """mamba2-1.3b at SSM_LAYERS layers, registered in ARCHS (each spawned
    process registers its own)."""
    from dataclasses import replace

    from repro_torch.configs.base import ARCHS

    name = f"{SSM_ARCH}-{SSM_LAYERS}l"
    ARCHS[name] = replace(ARCHS[SSM_ARCH], name=name, n_layers=SSM_LAYERS)
    return name


def _cache_bytes(cache) -> tuple:
    """(the bytes of a decode cache's attention K / V and Mamba SSM states,
    those of its Mamba conv windows)."""
    state = sum(c.ssm.nbytes if hasattr(c, "ssm") else c.k.nbytes + c.v.nbytes
                for c in cache.values())
    return state, sum(c.conv.nbytes for c in cache.values() if hasattr(c, "conv"))


def _tp_decode(cfg, mesh, device, prompt_len: int, gen: int, measure: bool) -> dict:
    """Prefill ``prompt_len`` tokens and ``gen`` greedy steps of ``cfg``
    (random weights from seed 0) at batch LM_BATCH: one card's decode, then
    the mesh's with the cache split over "model" and one card's tokens fed
    (each step's logits compared on the same inputs).  With ``measure``
    the mesh's first decode step reads the card's peak (as
    ``_measured_train_step``) and counts its collectives."""
    from repro_torch.distributed.sharding import compute_specs, param_specs, shard_tree
    from repro_torch.exchange.group import CollectiveCounter
    from repro_torch.launch.dryrun import storage_bytes
    from repro_torch.models.transformer import ShardCtx, model_init
    from repro_torch.train.steps import prefill_step, serve_decode_step

    model = mesh.shape["model"]
    full = model_init(torch.Generator(device=device).manual_seed(0), cfg, ep_shards=model,
                      device=device)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(LM_BATCH, prompt_len))).to(device=device, dtype=torch.int32)
    cache_len = prompt_len + gen
    out = {"one": {"logits": []}, "mesh": {"logits": [], "tokens": [], "ms": []}}
    with torch.no_grad():
        last, cache = prefill_step(full, cfg, prompts, cache_len=cache_len)
        one_bytes = _cache_bytes(cache)
        nxt, tokens = torch.argmax(last, -1), []
        out["one"]["logits"].append(last.float())
        for _ in range(gen):
            tokens.append(nxt)
            lg, cache = serve_decode_step(full, cfg, nxt[:, None].int(), cache)
            out["one"]["logits"].append(lg[:, 0].float())
            nxt = torch.argmax(lg[:, 0], -1)
        del cache
        ctx = ShardCtx(mesh=mesh, axes=mesh.axis_names)
        params = shard_tree(full, compute_specs(param_specs(full), cfg, model), mesh)
        del full
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, cache = prefill_step(params, cfg, prompts, ctx=ctx, cache_len=cache_len)
        torch.cuda.synchronize()
        out["mesh"]["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        out["mesh"]["cache_bytes"], out["mesh"]["conv_bytes"] = _cache_bytes(cache)
        out["one"]["cache_bytes"], out["one"]["conv_bytes"] = one_bytes
        out["mesh"]["logits"].append(last.float())
        for i, tok in enumerate(tokens):
            other = None
            if measure and i == 0:
                torch.cuda.synchronize()
                other = torch.cuda.memory_allocated() - storage_bytes(params, tok, cache)
                torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with CollectiveCounter() as coll:
                lg, cache = serve_decode_step(params, cfg, tok[:, None].int(), cache, ctx=ctx)
            torch.cuda.synchronize()
            out["mesh"]["ms"].append((time.perf_counter() - t0) * 1e3)
            if other is not None:
                out["mesh"]["card_peak_bytes"] = torch.cuda.max_memory_allocated() - other
                out["mesh"]["other_bytes"] = other
                out["mesh"]["collectives"] = coll.record()
            out["mesh"]["logits"].append(lg[:, 0].float())
            out["mesh"]["tokens"].append(torch.argmax(lg[:, 0], -1))
        out["one"]["tokens"] = tokens[1:] + [nxt]
    return out


def _tp_compare(label: str, got: dict, bf16: bool) -> dict:
    """The mesh's decode against one card's: every step's logits (bf16:
    lm_serve's bounds; float32: TP_CHECK_LOGITS of the largest logit) and
    the greedy tokens."""
    steps = []
    for i, (a, b) in enumerate(zip(got["mesh"]["logits"], got["one"]["logits"])):
        if bf16:
            steps.append(_logits_check(f"{label} step {i}", a, b))
        else:
            err, bound = max_abs_err(a, b), TP_CHECK_LOGITS * float(b.abs().max())
            check(err <= bound, f"{label} step {i}: logits off one card's ({err:.3g} > {bound:.3g})")
            steps.append({"rel_l2": _rel_l2(a, b), "max_abs_err": err, "bound": bound})
    same = all(torch.equal(a, b) for a, b in zip(got["mesh"]["tokens"], got["one"]["tokens"]))
    check(same, f"{label}: greedy tokens differ from one card's")
    return {"steps": len(steps), "worst_rel_l2": max(s["rel_l2"] for s in steps),
            "worst_max_abs_err": max(s["max_abs_err"] for s in steps),
            "greedy_tokens_equal": same}


def tp_rank(rank: int, world: int, store: str, result: str, device_type: str = "cuda",
            arch: str = LM_ARCH) -> None:
    """One rank of phase lm_tp (``arch`` qwen3-0.6b at full size) or
    lm_ssm_tp (``_ssm_arch()``): train --mesh data=1,model=4, then the bf16
    decode and the float32 check at TP_CHECK_LAYERS layers, each against
    one card's."""
    from dataclasses import replace

    from repro_torch.configs.base import ARCHS
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed.sharding import fit_tree, param_specs, shard_tree, batch_specs
    from repro_torch.kernels.bitonic_sort import bitonic_sort as kernels
    from repro_torch.launch import train
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.transformer import ShardCtx, model_init
    from repro_torch.optim.adamw import global_norm
    from repro_torch.train.steps import loss_fn
    from repro_torch.tree import from_paths, paths

    _ssm_arch()
    label = "lm_tp" if arch == LM_ARCH else "lm_ssm_tp"
    device = torch.device(device_type)
    if device_type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        kernels.reset_launch_counts()
        log, last, steps = [], {}, []
        t0 = time.perf_counter()
        losses, out = _run_train(
            train, ["--arch", arch, "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                    "--steps", str(TP_STEPS), "--lr", TRAIN_LR, "--log-every", "1",
                    "--mesh", TP_SPEC, "--dist-backend", "gloo", "--device", device_type],
            lambda real: _measured_train_step(real, log, last, steps))
        report = {"rank": rank, "losses": losses, "seconds": time.perf_counter() - t0,
                  "ms_per_step": [s["ms"] for s in log], "grad_norms": [s["grad_norm"] for s in log],
                  "param_bytes": _nbytes(last["params"]),
                  "moment_bytes": _nbytes(last["opt"]["m"], last["opt"]["v"]), "train": steps}
        last.clear()
        torch.cuda.empty_cache()
        mesh = Mesh((1, TP_RANKS), ("data", "model"))
        report["coords"] = mesh.coords
        cfg = ARCHS[arch]
        dec = _tp_decode(cfg, mesh, device, LM_PROMPT, LM_GEN, measure=True)
        report["decode"] = {"compare": _tp_compare(f"{label} decode", dec, bf16=True),
                            **{k: v for k, v in dec["mesh"].items() if k not in ("logits", "tokens")},
                            "one_card_cache_bytes": dec["one"]["cache_bytes"],
                            "one_card_conv_bytes": dec["one"]["conv_bytes"]}
        del dec
        torch.cuda.empty_cache()
        # (c) float32 at TP_CHECK_LAYERS layers, TF32 off
        f32 = replace(cfg, name=f"{arch}-{TP_CHECK_LAYERS}l-f32", n_layers=TP_CHECK_LAYERS,
                      param_dtype=torch.float32, compute_dtype=torch.float32)
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            full = model_init(torch.Generator(device=device).manual_seed(0), f32,
                              ep_shards=TP_RANKS, device=device)
            b = SyntheticLM(f32.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0)._batch_at(0)
            whole = {k: torch.from_numpy(v).to(device) for k, v in b.items()}

            def loss_and_norm(params, batch, ctx, specs):
                pairs = list(paths(params))
                leaves = [t.detach().requires_grad_(True) for _, t in pairs]
                loss, _ = loss_fn(from_paths((p, t) for (p, _), t in zip(pairs, leaves)), f32,
                                  batch, ctx=ctx, loss_chunk=64, specs=specs)
                grads = from_paths((p, g) for (p, _), g in
                                   zip(pairs, torch.autograd.grad(loss, leaves)))
                return {"loss": float(loss.detach()),
                        "grad_norm": float(global_norm(grads, specs, ctx.mesh))}

            ctx = ShardCtx(mesh=mesh, axes=mesh.axis_names)
            specs = fit_tree(param_specs(full), full, mesh)
            check_report = {"mesh": loss_and_norm(shard_tree(full, specs, mesh),
                                                  shard_tree(whole, batch_specs(whole), mesh), ctx,
                                                  specs),
                            "one_rank": loss_and_norm(full, whole, ShardCtx(), None)}
            del full, whole
            dec = _tp_decode(f32, mesh, device, 64, 8, measure=False)
            check_report["decode"] = _tp_compare(f"{label} float32 decode", dec, bf16=False)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        report["check"] = check_report
        report["kernel_launches"] = {k: v for k, v in kernels.launch_counts().items() if v}
        with open(f"{result}.{rank}.json", "w") as f:
            json.dump(report, f)
    finally:
        dist.destroy_process_group()


def tp_dryrun(rank: int, device_type: str, train_kw: dict, arch: str = LM_ARCH) -> dict:
    """The dry-run of lm_tp's (``arch``) train step and first decode step as
    ``rank`` of a fake (data=1, model=4) world, on fake tensors of
    ``device_type``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs.base import ARCHS
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    from repro_torch.optim.adamw import OptConfig

    _ssm_arch()
    cfg = ARCHS[arch]
    device = torch.device(device_type)
    out = {}
    with dryrun.fake_world(TP_RANKS, rank):
        mesh = Mesh((1, TP_RANKS), ("data", "model"))
        for kind in ("train", "decode"):
            mode = FakeTensorMode()
            if kind == "train":
                inputs = {k: torch.empty(shape, dtype=torch.int32, device="meta")
                          for k, shape in train_kw["batch"].items()}
                cell = dryrun.build_cell(cfg, "train", inputs, mesh, device, mode,
                                         n_microbatch=train_kw["n_microbatch"],
                                         loss_chunk=train_kw["loss_chunk"],
                                         opt_cfg=OptConfig(state_dtype=train_kw["state_dtype"]))
            else:
                inputs = {"tokens": torch.empty((LM_BATCH, 1), dtype=torch.int32, device="meta")}
                cell = dryrun.build_cell(cfg, "decode", inputs, mesh, device, mode,
                                         cache_len=LM_PROMPT + LM_GEN)
            rec = dryrun.trace(*cell[:2], mode)
            out[kind] = {"memory": rec["memory"], "collectives": rec["collectives"],
                         "flops": rec["cost"]["flops"], "trace_s": rec["trace_s"]}
    return out


def phase_lm_tp(kernels, device, lm_train: dict) -> dict:
    """Four gloo ranks on the card train, prefill and decode qwen3-0.6b with
    its heads, FFN and decode cache split over "model"; then the dry-run of
    the same steps, each rank against its card readings."""
    return _tp_phase(device, LM_ARCH, "lm_tp", lm_train["full_size"]["losses"][0], "lm_train's")


def phase_lm_ssm_tp(kernels, device) -> dict:
    """lm_tp's checks on mamba2-1.3b at full width (SSM_LAYERS layers), its
    SSM heads, conv channels and state split over "model": first one NCCL
    rank's (data=1, model=1) step, the train reference."""
    from repro_torch.configs.base import ARCHS
    from repro_torch.launch import train

    arch = _ssm_arch()
    try:  # registered for this phase only: the dry-run sweep reads ARCHS
        kernels.reset_launch_counts()
        losses, _ = _run_train(
            train, ["--arch", arch, "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                    "--steps", "1", "--lr", TRAIN_LR, "--log-every", "1",
                    "--mesh", "data=1,model=1", "--dist-backend", "nccl"])
        check(not dist.is_initialized(), "lm_ssm_tp: the driver left its NCCL group up")
        launches = {k: v for k, v in kernels.launch_counts().items() if v}
        check(not launches, f"lm_ssm_tp: one rank's step launched sort kernels {launches}")
        torch.cuda.empty_cache()
        return {"one_rank_step1_loss": losses[0],
                **_tp_phase(device, arch, "lm_ssm_tp", losses[0], "one rank's (1, 1) step 1")}
    finally:
        ARCHS.pop(arch, None)


def _tp_phase(device, arch: str, label: str, want: float, what: str) -> dict:
    """Four gloo ranks (``tp_rank``) and the dry-run of their steps
    (``tp_dryrun``) for ``arch``; step 1's loss against ``want`` (``what``)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.configs.base import ARCHS

    work = os.path.join(ROOT, "build", label)
    os.makedirs(work, exist_ok=True)
    store, result = os.path.join(work, f"store.{os.getpid()}"), os.path.join(work, "result")
    for path in [store] + [f"{result}.{r}.json" for r in range(TP_RANKS)]:
        if os.path.exists(path):
            os.remove(path)
    t0 = time.perf_counter()
    _spawn(tp_rank, (TP_RANKS, store, result, device.type, arch), TP_RANKS)
    seconds = time.perf_counter() - t0
    reports = []
    for r in range(TP_RANKS):
        with open(f"{result}.{r}.json") as f:
            reports.append(json.load(f))
    r0 = reports[0]
    # (a) train --mesh
    check(all(rep["losses"] == r0["losses"] for rep in reports), f"{label}: the ranks' losses differ")
    check(len(r0["losses"]) == TP_STEPS and all(np.isfinite(r0["losses"] + r0["grad_norms"])),
          f"{label}: losses {r0['losses']}")
    rel = abs(r0["losses"][0] - want) / abs(want)
    check(rel <= TP_LOSS_RTOL, f"{label}: step-1 loss {r0['losses'][0]} against {what} {want}")
    launches = {}
    for rep in reports:
        for k, v in rep["kernel_launches"].items():
            launches[k] = launches.get(k, 0) + v
    check(not launches, f"{label}: the TP path launched sort kernels {launches}")
    # (b) the split cache holds a quarter of one card's (attention K / V, SSM
    # state); a conv window a quarter of the x channels and all of B / C
    mc = ARCHS[arch].mamba_cfg()
    bc = 2 * mc.n_groups * mc.d_state
    for rep in reports:
        d = rep["decode"]
        check(d["cache_bytes"] * TP_RANKS == d["one_card_cache_bytes"],
              f"{label} rank {rep['rank']}: cache {d['cache_bytes']} of {d['one_card_cache_bytes']}")
        conv = d["one_card_conv_bytes"] // mc.conv_dim * (mc.d_inner // TP_RANKS + bc)
        check(d["conv_bytes"] == conv,
              f"{label} rank {rep['rank']}: conv windows {d['conv_bytes']}, want {conv}")
    # (c) float32 against one rank
    mesh_m, one_m = r0["check"]["mesh"], r0["check"]["one_rank"]
    check(all(rep["check"]["mesh"] == mesh_m for rep in reports),
          f"{label} check: the ranks' numbers differ")
    rel_check = {k: abs(mesh_m[k] - one_m[k]) / abs(one_m[k]) for k in ("loss", "grad_norm")}
    check(all(v <= TP_CHECK_RTOL for v in rel_check.values()),
          f"{label} check: mesh {mesh_m} against one rank {one_m}")
    # (d) the dry-run of the same steps, one process a rank
    t1 = time.perf_counter()
    with ProcessPoolExecutor(TP_RANKS, mp_context=multiprocessing.get_context("spawn")) as pool:
        traced = list(pool.map(tp_dryrun, range(TP_RANKS), [device.type] * TP_RANKS,
                               [rep["train"][0] for rep in reports], [arch] * TP_RANKS))
    dryrun_seconds = time.perf_counter() - t1
    memory = []
    for rep, tr in zip(reports, traced):
        row = {"rank": rep["rank"]}
        for kind, card in (("train", rep["train"][-1]), ("decode", rep["decode"])):
            want_b = tr[kind]["memory"]["peak_bytes_per_device"]
            got_b = card["card_peak_bytes"]
            share = abs(got_b - want_b) / want_b
            check(share <= TP_MEMORY_SHARE,
                  f"{label} rank {rep['rank']} {kind}: card peak {got_b} against the dry-run's {want_b}")
            check(card["collectives"] == tr[kind]["collectives"],
                  f"{label} rank {rep['rank']} {kind}: counted collectives differ from the dry-run's")
            row[kind] = {"card_peak_bytes": got_b, "dryrun_peak_bytes": want_b,
                         "off_by_share": (got_b - want_b) / want_b, "other_bytes": card["other_bytes"],
                         "collective_bytes": card["collectives"]["total_bytes"],
                         "collective_counts": card["collectives"]["counts"],
                         "dryrun_flops": tr[kind]["flops"], "trace_s": tr[kind]["trace_s"]}
        memory.append(row)
    return {
        "arch": arch, "mesh": TP_SPEC, "ranks": TP_RANKS,
        "backend": "gloo (host-staged CUDA tensors; times are not TP over NCCL)",
        "train": {"batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TP_STEPS, "losses": r0["losses"],
                  "grad_norms": r0["grad_norms"], "step1_loss_rel": rel, "step1_reference": what,
                  "tolerance": TP_LOSS_RTOL, "ms_per_step_rank0": r0["ms_per_step"],
                  "rank_bytes": [{"params": rep["param_bytes"], "moments": rep["moment_bytes"]}
                                 for rep in reports]},
        "decode": {"batch": LM_BATCH, "prompt": LM_PROMPT, "tokens": LM_GEN,
                   "prefill_ms_rank0": r0["decode"]["prefill_ms"],
                   "ms_per_token_rank0": r0["decode"]["ms"],
                   "cache_bytes_rank": r0["decode"]["cache_bytes"],
                   "cache_bytes_one_card": r0["decode"]["one_card_cache_bytes"],
                   "conv_bytes_rank": r0["decode"]["conv_bytes"],
                   "conv_bytes_one_card": r0["decode"]["one_card_conv_bytes"],
                   "compare": r0["decode"]["compare"], "tolerance": LOGIT_TOLERANCE},
        "float32_check": {"layers": TP_CHECK_LAYERS, "tf32": False, "mesh": mesh_m,
                          "one_rank": one_m, "rel": rel_check, "tolerance": TP_CHECK_RTOL,
                          "decode": r0["check"]["decode"], "logits_tolerance": TP_CHECK_LOGITS},
        "memory_vs_dryrun": memory, "memory_tolerance": TP_MEMORY_SHARE,
        "dryrun_seconds": dryrun_seconds, "ranks_seconds": seconds,
        "kernel_launches": launches}


def phase_dryrun() -> dict:
    """``python -m repro_torch.launch.dryrun --all --mesh pod`` (fake CUDA
    tensors) in a subprocess: every applicable cell must print OK."""
    out_dir = os.path.join(ROOT, "build", "dryrun_torch")
    shutil.rmtree(out_dir, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--all", "--mesh",
                           "pod", "--out", out_dir, "--jobs", str(DRYRUN_JOBS)],
                          env=env, capture_output=True, text=True, timeout=900, cwd=ROOT)
    seconds = time.perf_counter() - t0
    print(proc.stdout + proc.stderr[-4000:], file=sys.stderr, flush=True)
    lines = [ln for ln in proc.stdout.splitlines() if ln[:4] in ("OK  ", "SKIP", "FAIL")]
    check(proc.returncode == 0 and not any(ln.startswith("FAIL") for ln in lines),
          f"dryrun: exit {proc.returncode}: {[ln for ln in lines if ln.startswith('FAIL')]}")
    from repro_torch.configs.base import all_cells

    cells = {}
    for arch, shape in all_cells():
        with open(os.path.join(out_dir, f"{arch}__{shape}__pod.json")) as f:
            rec = json.load(f)
        cells[f"{arch} {shape}"] = {
            "peak_gib": rec["memory"]["peak_bytes_per_device"] / 2**30,
            "argument_gib": rec["memory"]["argument_bytes_per_device"] / 2**30,
            "tflops": rec["cost"]["flops"] / 1e12,
            "collective_gib": rec["collectives"]["total_bytes"] / 2**30,
            "trace_s": rec["lower_s"], "notes": rec["notes"]}
    over = sorted(k for k, v in cells.items() if v["peak_gib"] * 2**30 > 80e9)
    from repro_torch.configs.base import ARCHS

    mamba = {k: v["peak_gib"] for k, v in cells.items() if "mamba" in ARCHS[k.split()[0]].pattern}
    check(not any(cells[k]["notes"] for k in mamba),
          f"dryrun: Mamba cells with whole blocks {[k for k in mamba if cells[k]['notes']]}")
    return {"mesh": "pod (data=16, model=16), rank 0", "device": "fake cuda", "jobs": DRYRUN_JOBS,
            "seconds": seconds, "mamba_peak_gib": mamba, "cells": cells, "lines": len(lines),
            "over_80gb": over, "skipped": [ln for ln in lines if ln.startswith("SKIP")]}


def _multihost_harness():
    """``tests/_torch_multihost.py``, loaded by path (the tests directory is
    not a package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_torch_multihost", os.path.join(ROOT, "tests", "_torch_multihost.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclasses resolve their module
    spec.loader.exec_module(mod)
    return mod


def phase_multihost(add, smi: str) -> dict:
    """The port's multihost tier on the card (see the module docstring);
    any failed check raises."""
    from repro_torch.engine.planner import Planner

    harness = _multihost_harness()
    bodies = "_torch_multihost_bodies.py"
    work = os.path.join(ROOT, "build", "multihost")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    out = {"nvidia_smi": smi, "n": MULTIHOST_N, "ranks": list(MULTIHOST_RANKS), "runs": {}}

    def record(label, run):
        out["runs"][label] = {"wall_s": run.wall_s, "ok": run.ok, "timed_out": run.timed_out,
                              "first_failure_s": run.first_failure_s,
                              "returncodes": [r.returncode for r in run.reports]}

    def autotune(name, fault=None, **extra):
        args = {"plans_path": os.path.join(work, f"{name}.json"), "n": MULTIHOST_AUTOTUNE_N,
                "reps": 2, "device": "cuda", **extra}
        if fault is not None:
            args["fault"] = {"rank": 1, "point": "candidate:1", "kind": fault}
        return lambda: harness.run_multihost(f"{bodies}:autotune_body", 2, args=args,
                                             timeout=MULTIHOST_TIMEOUT_S)

    # model D and its kv twin with the kernels at every rank count, and the
    # coordinated autotune with rank 1 killed and with rank 1 hung, all at
    # once: a run's wall time is mostly its processes' start
    sorts = {"cluster_sort": ("cluster_sort_body", ("sorted_sha",)),
             "cluster_sort_kv": ("cluster_sort_kv_body", ("sorted_keys_sha", "idx_sha", "w_sha"))}
    calls = {"killed": autotune("killed", "crash"),
             "hung": autotune("hung", "hang", gloo_timeout_s=MULTIHOST_GLOO_TIMEOUT_S)}
    for label, (body, _) in sorts.items():
        args = {"n": MULTIHOST_N, "seed": 3, "local_impl": "kernel", "device": "cuda"}
        calls[(label, 1)] = lambda body=body, args=args: harness.run_single(
            f"{bodies}:{body}", args=args, timeout=MULTIHOST_TIMEOUT_S)
        for ranks in MULTIHOST_RANKS:
            calls[(label, ranks)] = lambda body=body, args=args, ranks=ranks: harness.run_multihost(
                f"{bodies}:{body}", ranks, args=args, timeout=MULTIHOST_TIMEOUT_S)
    t0 = time.perf_counter()
    runs = harness.run_together(calls, max_workers=len(calls))
    out["first_runs_seconds"] = time.perf_counter() - t0
    out["launches"] = {}
    for key, run in runs.items():
        if key in ("killed", "hung"):
            record(f"autotune_{key}", run)
            continue
        label, ranks = key
        record(f"{label}/{ranks}", run)
        check(run.ok, f"multihost {label} on {ranks} rank(s):\n{run.describe()}")
    for label, (_, fields) in sorts.items():
        want = {f: runs[(label, 1)].result()[f] for f in fields}
        for ranks in MULTIHOST_RANKS:
            results = runs[(label, ranks)].results()
            for rank, r in enumerate(results):
                check({f: r[f] for f in fields} == want,
                      f"multihost {label}: rank {rank} of {ranks} differs from one rank")
                add(r["launches"])
            out["launches"][f"{label}/{ranks}"] = [
                {k: v for k, v in r["launches"].items() if v} for r in results]
            out["runs"][f"{label}/{ranks}"]["body_seconds"] = [r["seconds"] for r in results]
        kinds = ("block_sort", "block_merge") if label == "cluster_sort" else (
            "block_sort_kv", "block_merge_kv")
        for k in kinds:
            check(all(r["launches"][k] > 0 for r in runs[(label, 2)].results()),
                  f"multihost {label}: kernel {k} was not launched")

    killed, hung = runs["killed"], runs["hung"]
    # both faults fired where they were armed, after both ranks joined
    for label, run in (("killed", killed), ("hung", hung)):
        check(run.fault_reached(1) == "candidate:1" and run.reports[0].joined,
              f"multihost: the {label} autotune failed before its fault:\n{run.describe()}")
    check(not killed.ok and not killed.timed_out and killed.reports[1].returncode == 13,
          f"multihost: the killed autotune was not contained:\n{killed.describe()}")
    check(killed.wall_s - killed.first_failure_s < harness.GRACE_AFTER_FAILURE_S + 5,
          "multihost: the killed autotune outlived the grace period")
    killed_path = os.path.join(work, "killed.json")
    if os.path.exists(killed_path):
        Planner(device="cuda").load(killed_path, strict=True)
    out["killed_plan_file"] = "loads" if os.path.exists(killed_path) else "absent"
    check(not hung.ok and all(not r.ok for r in hung.reports)
          and hung.wall_s < MULTIHOST_TIMEOUT_S,
          f"multihost: the hung autotune was not contained:\n{hung.describe()}")
    # where gloo's timeout ended it, rank 0 timed out inside the autotune
    check(hung.timed_out or ("Timed out" in hung.reports[0].error
                             and "in autotune" in hung.reports[0].traceback),
          f"multihost: rank 0 of the hung autotune failed elsewhere:\n{hung.describe()}")
    out["hung_ended_by"] = "harness timeout" if hung.timed_out else "gloo timeout"

    # a clean rerun on the killed run's file; beside it, what gloo's
    # host-staged wire costs: model B and model D timed by the planner's
    # helpers (median of 3 reps, max over ranks) on 1 and 2 ranks
    timing_args = {"n": MULTIHOST_N, "reps": 3, "device": "cuda"}
    calls = {"clean": autotune("killed")}  # the same file, no fault
    for ranks in (1, 2):
        calls[ranks] = lambda ranks=ranks: harness.run_multihost(
            f"{bodies}:gloo_timing_body", ranks, args=timing_args, timeout=MULTIHOST_TIMEOUT_S)
    runs = harness.run_together(calls)
    out["gloo_timing_us"] = {}
    for ranks in (1, 2):
        record(f"gloo_timing/{ranks}", runs[ranks])
        check(runs[ranks].ok, f"multihost gloo_timing on {ranks} rank(s):\n{runs[ranks].describe()}")
        out["gloo_timing_us"][ranks] = runs[ranks].result()
    clean = runs["clean"].require_success()
    record("autotune_clean", clean)
    results = clean.results()
    check(all(r["best"] == results[0]["best"] and r["plans"] == results[0]["plans"]
              for r in results), "multihost: the clean autotune's ranks hold different plans")
    on_disk = Planner(device="cuda").load(killed_path, strict=True).plans
    check(on_disk[results[0]["plan_key"]].to_dict() == results[0]["best"],
          "multihost: the plan file differs from the ranks' plan")
    check([r["wrote"] for r in results] == [True, False], "multihost: rank 0 is not the writer")
    out["autotune"] = {"key": results[0]["plan_key"], "best": results[0]["best"]}
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available; this script needs one card")
    import repro_torch
    from repro_torch import engine
    from repro_torch.kernels.bitonic_sort import bitonic_sort as kernels

    t0 = time.perf_counter()
    lib, log = kernels.build()
    emit({"phase": "build", "library": os.path.relpath(lib, ROOT),
          "seconds": time.perf_counter() - t0, "nvcc_flags": " ".join(kernels.NVCC_FLAGS)})
    print(log, file=sys.stderr, flush=True)

    device = torch.device("cuda")
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "name": name, "count": count, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # -- kernel parity at real widths (these launches are not the main path's)
    parity = phase_parity(kernels, device)
    emit({"phase": "parity", **parity})
    merge_runs = phase_merge_runs(kernels, device)
    emit({"phase": "merge_runs", **merge_runs})

    launches = {k: 0 for k in kernels.launch_counts()}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    # -- main path: model B sort of 10M float32 keys
    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.randn(SORT_N, generator=gen, device=device) * 1000
    sort_kw = dict(strategy="shared", local_impl="kernel", n_threads=8)
    got, counts = counted(kernels, lambda: repro_torch.sort(x, **sort_kw))
    add(counts)
    tile = (1 << (SORT_N - 1).bit_length()) // 8
    check(counts == {**expected_launches(tile, 1024, kv=False), "merge_runs": 3}, f"sort launches {counts}")
    check(kernels.merge_round_counts() == {"merge_runs": 3, "rank_merge_pairs": 0},
          f"sort: merge rounds {kernels.merge_round_counts()}")
    plain = repro_torch.sort(x, strategy="shared", local_impl="bitonic", n_threads=8)
    check(same_bits(got, plain), "sort: kernel path differs from the plain bitonic path")
    check(torch.equal(got, torch.sort(x).values), "sort: values differ from torch.sort")
    got_desc, counts_desc = counted(kernels, lambda: repro_torch.sort(x, ascending=False, **sort_kw))
    add(counts_desc)
    plain_desc = repro_torch.sort(x, strategy="shared", local_impl="bitonic", n_threads=8,
                                  ascending=False)
    check(same_bits(got_desc, plain_desc), "sort descending: differs from the plain bitonic path")
    check(torch.equal(got_desc, torch.sort(x, descending=True).values),
          "sort descending: values differ from torch.sort")
    check(bool(torch.isfinite(got).all()) and got.shape == x.shape, "sort: shape or finiteness")
    emit({"phase": "sort", "n": SORT_N, "dtype": "float32", "padded": 1 << 24, **sort_kw,
          "launches": counts, "launches_descending": counts_desc,
          "substages": kernels.substage_counts(),
          "bitwise_equal_plain_bitonic": True, "equal_torch_sort": True})

    # -- main path: stable argsort and sort_kv of 10M duplicate-heavy int32 keys
    keys = torch.randint(0, 1000, (SORT_N,), generator=gen, device=device, dtype=torch.int32)
    idx, counts = counted(kernels, lambda: engine.argsort(keys, impl="kernel"))
    add(counts)
    check(counts == expected_launches(SORT_N, 1024, kv=True), f"argsort launches {counts}")
    argsort_substages = kernels.substage_counts()
    want_idx = torch.argsort(keys, stable=True)
    check(torch.equal(idx.long(), want_idx), "argsort: differs from torch.argsort(stable=True)")
    payload = torch.randn(SORT_N, 4, generator=gen, device=device)
    (sk, sv), counts_kv = counted(kernels, lambda: engine.sort_kv(keys, {"p": payload}, impl="kernel"))
    add(counts_kv)
    check(torch.equal(sk, keys[want_idx]), "sort_kv: keys differ")
    check(torch.equal(sv["p"], payload[want_idx]), "sort_kv: payload differs")
    emit({"phase": "argsort", "n": SORT_N, "dtype": "int32", "key_range": [0, 1000],
          "launches_argsort": counts, "launches_sort_kv": counts_kv,
          "substages_argsort": argsort_substages,
          "equal_torch_argsort_stable": True, "payload": [SORT_N, 4]})

    # -- main path: decode top-k over a real vocabulary, with ties on purpose
    logits = torch.randn(8, VOCAB, generator=gen, device=device)
    top = logits.max(dim=-1, keepdim=True).values
    logits[:, 1000:1004] = top  # four-way tie at the top
    logits[:, [7, 70_000, 151_000]] = logits[:, [5]]  # ties among ordinary logits
    logits[:, 12] = 50.0
    logits[:, 151_935] = 50.0  # a tie at the top, far apart
    (vals, tidx), counts = counted(kernels, lambda: engine.topk(logits, 50, impl="kernel"))
    add(counts)
    check(counts == {"topk_select": 2}, f"topk launches {counts}")
    want_vals, want_tidx = engine.topk(logits, 50, impl="xla")
    check(torch.equal(vals, want_vals), "topk: values differ from impl='xla'")
    check(tidx.dtype == want_tidx.dtype == torch.int32 and torch.equal(tidx, want_tidx),
          "topk: int32 indices differ from impl='xla'")
    check(torch.equal(vals, torch.topk(logits, 50).values), "topk: values differ from torch.topk")
    check(tidx[0, 0].item() == 12 and tidx[0, 1].item() == 151_935, "topk: lowest index wins a tie")
    emit({"phase": "topk", "shape": [8, VOCAB], "k": 50, "launches": counts,
          "equal_impl_xla": True})
    topk_select = phase_topk_select(kernels, device, gen)
    emit({"phase": "topk_select", **topk_select})
    for k, v in launches.items():
        check(v > 0, f"kernel {k} was not launched on the main path")

    # -- the mesh paths: model D and its kv twin on a one-rank NCCL group,
    # then models C and D on four gloo ranks sharing the card
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        from repro_torch.exchange import AxisGroup

        group = AxisGroup()
        mesh_counts = {k: 0 for k in kernels.launch_counts()}

        def add_mesh(counts):
            add(counts)
            for k, v in counts.items():
                mesh_counts[k] += v

        print(smi, flush=True)
        emit({"phase": "cluster", "nvidia_smi": smi, **phase_cluster(kernels, group, device, gen, add_mesh)})
        print(smi, flush=True)
        emit({"phase": "cluster_kv", "nvidia_smi": smi, **phase_cluster_kv(group, device, gen)})
    finally:
        dist.destroy_process_group()
    print(smi, flush=True)
    emit({"phase": "cluster_ranks", "nvidia_smi": smi, **phase_cluster_ranks(add_mesh)})
    for k in ("block_sort", "block_merge", "global_stage"):
        check(mesh_counts[k] > 0, f"kernel {k} was not launched on the model-D path")

    # -- the engine: autotune, the batch service, the async queue, the frontend
    for label, phase in (("autotune", phase_autotune), ("serve", phase_serve),
                         ("queue", phase_queue), ("frontend", phase_frontend)):
        print(smi, flush=True)
        t0 = time.perf_counter()
        emit({"phase": label, "nvidia_smi": smi, **phase(kernels, device, add),
              "phase_seconds": time.perf_counter() - t0})

    # -- NaN keys through model B and the argsort; then the LM serving path:
    # qwen3-0.6b decoding with the kernel top-k, granite's MoE stack, the
    # MoE capacity loop at width; then the training path
    results = {}
    for label, phase in (("nan_merge", lambda: phase_nan_merge(kernels, device, add)),
                         ("lm_serve", lambda: phase_lm_serve(kernels, device, add)),
                         ("lm_moe", lambda: phase_lm_moe(device)),
                         ("moe_serve", lambda: phase_moe_serve(device)),
                         ("lm_train", lambda: phase_lm_train(kernels, device)),
                         ("lm_mesh", lambda: phase_lm_mesh(kernels, device, results["lm_train"])),
                         ("lm_tp", lambda: phase_lm_tp(kernels, device, results["lm_train"])),
                         ("lm_ssm_tp", lambda: phase_lm_ssm_tp(kernels, device)),
                         ("dryrun", phase_dryrun),
                         ("multihost", lambda: phase_multihost(add, smi))):
        print(smi, flush=True)
        t0 = time.perf_counter()
        results[label] = phase()
        emit({"phase": label, "nvidia_smi": smi, **results[label],
              "phase_seconds": time.perf_counter() - t0})

    # -- path times beside their library yardsticks
    paths = {
        "sort": (lambda: repro_torch.sort(x, **sort_kw), lambda: torch.sort(x)),
        "argsort": (lambda: engine.argsort(keys, impl="kernel"),
                    lambda: torch.argsort(keys, stable=True)),
        "topk": (lambda: engine.topk(logits, 50, impl="kernel"), lambda: torch.topk(logits, 50)),
    }
    path_ms = {}
    # the library sort the port's impl='xla' calls is the stable one
    torch_sort_10m = {"unstable_ms": time_ms(lambda: torch.sort(x), reps=5),
                      "stable_ms": time_ms(lambda: torch.sort(x, stable=True), reps=5), "reps": 5}
    for label, (ours, library) in paths.items():
        ms = time_ms(ours, reps=5)
        prof = device_profile(ours)
        path_ms[label] = {"ms": ms, "library_ms": time_ms(library, reps=5), "reps": 5,
                          "device_ms": prof["device_ms"],
                          "device_idle_share": 1.0 - prof["device_ms"] / ms if prof["device_ms"] else None,
                          "top_device_kernels_ms": prof["top"]}
    # the tile width trades C launches (up to GLOBAL_SPAN substages above the tile each) for
    # longer shared-memory networks in A and B
    sweep = {}
    for bn in (1024, 4096, kernels.MAX_BLOCK_N):
        sweep[bn] = {
            "sort_ms": time_ms(lambda: repro_torch.sort(x, block_n=bn, **sort_kw), reps=3),
            "argsort_ms": time_ms(lambda: engine.argsort(keys, impl="kernel", block_n=bn), reps=3),
            "topk_ms": time_ms(lambda: engine.topk(logits, 50, impl="kernel", block_n=bn), reps=3),
        }
    emit({"phase": "block_n_sweep", "reps": 3, "times": sweep})
    emit({"phase": "paths", "library": {"sort": "torch.sort", "argsort": "torch.argsort(stable=True)",
                                        "topk": "torch.topk"}, "times": path_ms,
          "torch_sort_10m": torch_sort_10m})

    # -- per-launch times at the main path's shapes
    rows, n, bn = 8, 1 << 21, 1024  # model B's tiles of the 10M sort
    xs = make_keys(torch.float32, (rows, n), gen, device)
    kv_keys = make_keys(torch.int32, (1, 1 << 24), gen, device)  # the 10M argsort row
    kv_r = torch.arange(1 << 24, dtype=torch.int32, device=device).expand(1, 1 << 24).contiguous()

    # library yardstick of the tile kernels: torch.sort over the same tiles
    # (every tile ascending; the kv rows stable, with int64 local indices)
    def tile_sort():
        return torch.sort(xs.view(-1, bn), dim=-1)

    def tile_sort_kv():
        return torch.sort(kv_keys.view(-1, bn), dim=-1, stable=True)

    log_bn = bn.bit_length() - 1
    sort_substages = log_bn * (log_bn + 1) // 2  # kernel A's stages 2 .. bn
    span = kernels.GLOBAL_SPAN  # substages of C's widest fused launch
    timed = {
        "block_sort": ((lambda: kernels.block_sort(xs, bn)),
                       (lambda: kernels.plain_block_sort(xs, None, bn)), tile_sort,
                       rows * n, 4, False, sort_substages),
        "block_merge": ((lambda: kernels.block_merge(xs, bn, n)),
                        (lambda: kernels.plain_block_merge(xs, None, bn, n)), tile_sort,
                        rows * n, 4, False, log_bn),
        "global_stage": ((lambda: kernels.global_stage(xs, n // 2, n)),
                         (lambda: kernels.plain_global_stage(xs, None, n // 2, n)), None,
                         rows * n, 4, False, 1),
        "block_sort_kv": ((lambda: kernels.block_sort_kv(kv_keys, kv_r, bn)),
                          (lambda: kernels.plain_block_sort(kv_keys, kv_r, bn)), tile_sort_kv,
                          1 << 24, 4, True, sort_substages),
        "block_merge_kv": ((lambda: kernels.block_merge_kv(kv_keys, kv_r, bn, 1 << 24)),
                           (lambda: kernels.plain_block_merge(kv_keys, kv_r, bn, 1 << 24)),
                           tile_sort_kv, 1 << 24, 4, True, log_bn),
        "global_stage_kv": ((lambda: kernels.global_stage_kv(kv_keys, kv_r, 1 << 23, 1 << 24)),
                            (lambda: kernels.plain_global_stage(kv_keys, kv_r, 1 << 23, 1 << 24)),
                            None, 1 << 24, 4, True, 1),
        "global_stages": ((lambda: kernels.global_stages(xs, n // 2, n >> span, n)),
                          (lambda: kernels.plain_global_stages(xs, None, n // 2, n >> span, n)),
                          None, rows * n, 4, False, span),
        "global_stages_kv": (
            (lambda: kernels.global_stages_kv(kv_keys, kv_r, 1 << 23, 1 << (24 - span), 1 << 24)),
            (lambda: kernels.plain_global_stages(kv_keys, kv_r, 1 << 23, 1 << (24 - span), 1 << 24)),
            None, 1 << 24, 4, True, span),
    }
    entries = []
    for kname, (kernel_fn, plain_fn, library_fn, elems, itemsize, ranks, substages) in timed.items():
        ms = time_ms(kernel_fn, reps=20)
        by_bytes, by_ops = bytes_bound_ms(elems, itemsize, ranks), ops_bound_ms(elems, substages, ranks)
        bound = max(by_bytes, by_ops)
        entries.append({
            "name": kname,
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES[FUSED.get(kname, kname)],
            "launches": launches[kname] if kname in launches else f"counted on {FUSED[kname]}",
            "substages": substages,
            "max_abs_err": parity["max_abs_err"][kname],
            "ms": ms,
            "plain_ms": time_ms(plain_fn, reps=3, warmup=1),
            "bound_ms": bound,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes_bound_ms": by_bytes,
            "ops_bound_ms": by_ops,
            "share": bound / ms,
            "library_ms": None if library_fn is None else time_ms(library_fn, reps=20),
            "shape": [rows, n] if not ranks else [1, 1 << 24],
            "dtype": "float32" if not ranks else "int32+int32 ranks",
            "block_n": bn,
            "reps": 20,
            "plain_reps": 3,
        })
    widest = merge_runs["float32_times"][1 << 23]
    entries.append({
        "name": "merge_runs", "route": "cuda", "source": SOURCE,
        "replaces": "none: the reference merges in jnp (src/repro/core/merge.py rank_merge_pairs)",
        "launches": launches["merge_runs"], "max_abs_err": 0.0, "ms": widest["ms"],
        "plain_ms": widest["plain_ms"], "bound_ms": widest["bound_ms"], "bound_by": "bytes",
        "share": widest["share"], "library_ms": None,
        "rank_merge_pairs_ms": widest["rank_merge_pairs_ms"], "shape": widest["shape"],
        "width": 1 << 23, "dtype": "float32", "reps": 20, "plain_reps": 3,
    })
    entries.append({
        "name": "topk_select", "route": "cuda", "source": SOURCE,
        "replaces": "none: the reference sorts each row whole (src/repro/engine/kv.py topk)",
        "launches": launches["topk_select"], "max_abs_err": 0.0, "ms": topk_select["ms"],
        "plain_ms": topk_select["plain_ms"], "bound_ms": topk_select["bound_ms"],
        "bound_by": "bytes", "share": topk_select["share"], "library_ms": topk_select["library_ms"],
        "shape": topk_select["shape"], "k": TOPK_K, "dtype": "float32", "reps": 100, "plain_reps": 1,
    })
    # the top-k row shape, for the kv kernels' second main-path use
    tk_keys = make_keys(torch.float32, (8, 1 << 18), gen, device)
    tk_r = torch.arange(1 << 18, dtype=torch.int32, device=device).expand(8, 1 << 18).contiguous()
    emit({"phase": "topk_shape_times", "shape": [8, 1 << 18], "block_n": bn, "reps": 20,
          "bound_ms": bytes_bound_ms(8 << 18, 4, True),
          "ms": {"block_sort_kv": time_ms(lambda: kernels.block_sort_kv(tk_keys, tk_r, bn), reps=20),
                 "block_merge_kv": time_ms(lambda: kernels.block_merge_kv(tk_keys, tk_r, bn, 1 << 18),
                                           reps=20),
                 "global_stage_kv": time_ms(
                     lambda: kernels.global_stage_kv(tk_keys, tk_r, 1 << 17, 1 << 18), reps=20),
                 "global_stages_kv": time_ms(
                     lambda: kernels.global_stages_kv(tk_keys, tk_r, 1 << 17, 1 << 14, 1 << 18),
                     reps=20)}})
    emit({"phase": "launch_host_us", "shape": [1, 4096], "block_n": 1024, "calls": 200,
          "us": launch_host_us(kernels, device)})
    emit({"phase": "tile_variants", "block_n": bn, "reps": 20,
          **tile_variants(kernels, xs, kv_keys, kv_r, bn)})
    print(smi, flush=True)
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}})


if __name__ == "__main__":
    main()
