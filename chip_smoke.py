#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json] [--phases 3,12]

Run from the repository root (it imports ``src/repro_torch`` and nothing of
JAX).  In order it:

1. prints the card (``nvidia-smi`` name and power limit) and turns TF32 off
   for float32 matrix products and convolutions;
2. builds the hand-written CUDA kernels from ``src/repro_torch/kernels/
   csrc/`` (one ``nvcc`` per source, in parallel), prints the seconds and,
   for the two attention kernels and the bf16 tensor-core kernels of the
   grouped MLP (both forms of the forward, dgrad and wgrad), each
   instantiation's registers, shared memory and spills as ``ptxas -v``
   reports them;
3. holds each kernel against its plain PyTorch version on the card at
   gpt-moe-s shapes (stated tolerances): the serving kernels at serving
   shapes (the grouped-MLP inference form at the decode tick's, 256 and
   the 512 bucket's rows; its bf16 call also under
   ``torch.cuda.set_sync_debug_mode("error")``: it reads nothing back),
   the grouped-MLP training forward, dgrad and wgrad at training shapes
   (64 slots × 16,384 rows, 32,768 valid), in bf16 and f32, the bf16
   dgrad's dx also against its step-wise plain version (dx from dh1 split
   into bf16 hi + lo) and the bf16 wgrad bitwise equal over two calls; and
   times kernel, plain version and, where one exists, the PyTorch library
   call computing the same function (CUDA events, median, L2 flushed
   before each launch), with the grouped-MLP kernels' TFLOP/s and share
   of their bound: flash attention at each of the four prompt buckets,
   paged decode attention at the served tick and near 512 tokens, both
   also checked bitwise equal over two identical calls; then the same at
   the shapes of phase 10's configurations: B1's inference form (decode
   and 512-bucket prefill, GELU or GLU with SiLU, top-2 or top-8, D up to
   2,048), B4 and B5 at their heads (16 of 96, 16 of 128, 24 of 64 over 8
   KV heads) and B1-train, B2 and B3 at each training path's layout (bf16;
   f32 on 8 slots of it); then at phase 11's new shapes: B5 at Gemma-2's
   decode (16 of 256 over 8 KV heads, window 4,096, softcap 50), B4 at
   Jamba's exact prompt lengths (32 of 128 over 8 KV heads, causal and
   windowed) and B1 (both forms), B2 and B3 at Jamba's experts (D 4,096,
   F 14,336, SiLU GLU, weights at the model's fan-in scale);
4. serves gpt-moe-s at full width (12 layers, bf16 compute, f32 master
   weights from a seed) through the continuous-batching scheduler: four
   byte-encoded prompts of mixed lengths, 16 greedy tokens each; it counts
   the kernel launches of that run (flash attention per prompt bucket too),
   compares one prefill and one decode tick with the plain versions on the
   same tensors, checks that two identical prefills and two identical
   decode ticks give the same bits, profiles one decode tick and one
   prefill at the 512 bucket (device time, and the grouped-MLP and
   attention kernels' shares of it), and serves the smoke config in f32
   with the kernels and with the plain versions, which must give the same
   tokens;
5. trains gpt-moe-s at full width (12 layers, bf16 compute, f32 master
   weights and AdamW moments from a seed) through the Hecate loop
   (``train.trainer.train_loop``, ``ep`` plan), batch 8 × seq 2,048 of
   the bytes stream: two identical steps must give bitwise-equal parameters,
   then 12 steps with the launch counters reset just before: a finite
   loss, 12 dgrad and 12 wgrad launches per step and no flash-attention
   launch; one step under the profiler (its top kernels by device time);
   12 steps of the same loop at full width cut to 4 layers, whose loss
   must fall (at full depth 12 steps from the seeded init do not train:
   see ``TRAIN_LEARN_LAYERS``); and one step of full width cut to 2 layers
   in f32 whose every gradient must match the plain versions';
6. drives the dense ``Engine.generate`` path at full width and depth
   (bf16, 4 prompts of 32 tokens loop-prefilled, 16 greedy tokens: B1's
   inference form the only kernel, per-step times, bitwise-equal repeat,
   one profiled step), holds it to the continuous-batching scheduler at 2
   layers in f32 (same tokens, first-step logits within 1e-3), trains at
   full width and depth (batch 4 x 2,048, 4 steps) publishing into a live
   engine every 2 steps while it generates after each step (publish,
   staged build and promotion times, peak memory; the engine must serve
   the last published snapshot), and broadcasts one publication to two
   replicas at 4 layers through a ``PublicationBus``;
7. trains gpt-moe-s at full width and depth through the FSSDP layer
   across ranks at world size 1 over a real NCCL process group (bf16,
   batch 8 × 2,048, the ring plan of Algorithm 1 at ep = 1 with
   ``auto_capacity``, so tokens may drop): two identical steps bitwise
   equal, 4 steps of the Hecate loop with the launch and collective counts
   reset just before (B1-train, B2 and B3 over the uncompacted
   ``row_valid`` layout; dropped and padding fractions), one profiled step
   (device, NCCL and idle time, memory peak, the memory held before the
   loop once the garbage collector ran) beside phase 5's step median,
   and the three training kernels against their plain versions on that
   layout and on an 8-source one.  Two ranks cannot share the card: NCCL
   refuses two ranks of one communicator on one device, and gloo refuses
   the ring's ``batch_isend_irecv`` on CUDA tensors
   (``tools/gloo_cuda_probe.py``);
8. trains the same model, bf16, batch 8 × 2,048, at world size 1 over
   NCCL in each remat mode of the grid path (``save``: the one-layer-ahead
   SparseAllGather with the slots kept; ``gather``: no slots kept, the
   backward re-gathers one layer ahead; ``block``: the superblock
   checkpoint): two identical steps bitwise equal, one loop step that
   warms the allocator, then 5 steps of the Hecate loop (plan-ahead and
   calibration on) with the launch counts, the collective record and the
   event log reset just before: ring hops
   per step against each mode's law, one forward gather per layer and
   step, B1-train, B2 and B3 launches, step median and memory peak; one
   profiled save step (NCCL kernel ms and the ms it ran beside compute);
   a hoisted step of two microbatches (one gather per layer); a forced
   row-permuting reshard (``apply_reshard`` on the card) that leaves the
   loss unchanged; no plan-ahead fallback; before each measured loop of
   phases 7 and 8 the memory held is read with no collection first, and
   the phase fails if the garbage collector then frees more than 0.05 GB
   (a dropped state must be freed at once: ROADMAP C15);
9. checkpoints, resumes and rolls back full-width gpt-moe-s cut to 2
   layers (bf16, batch 8 × 2,048) through phase 7's path with one forced
   reshard before the first checkpoint, all bitwise against an
   uninterrupted 6-step run: 4 steps checkpointing every 2 (save s and
   GB/s), the state dropped with the collector off (the memory must fall
   back), a restore whose every array's CRC32 equals the saved one
   (restore s and GB/s), an auto-resume to step 6, a bit-flipped step 4
   skipped for step 2, ``train.nan_grads`` until the loop rolls back to
   step 2 (the rollback's peak below what was held plus one state), and
   ``launch/serve.py``'s restore serving 4 greedy requests at the
   checkpoint's version with the tokens of an engine built from the live
   parameters (B1, B4 and B5 launched, no training kernel);
10. runs the other MoE configurations at full width (``SLICE10``:
   gpt-moe-l, bert-moe, bert-moe-deep, olmoe-1b-7b, granite-moe-3b-a800m),
   one at a time, each freed before the next: serving at full depth (bf16,
   f32 master weights from seed 0, phase 4's prompts with 8 greedy tokens
   each: B1, B4 per bucket and B5 launched and no training kernel, two
   identical prefills and ticks bitwise equal, one prefill and one tick
   at full width cut to 1 layer in f32 against the plain versions, prefill
   and tick ms, peak), then training at full width at the deepest cut one
   card holds (gpt-moe-l and olmoe through phase 7's grid path at world
   size 1 in their configured ``gather`` mode, bert-moe and granite
   through phase 5's loop; two identical steps bitwise equal, 3 counted
   steps: finite loss, B1-train, B2 and B3 launches per MoE layer, no B4,
   step ms, tokens/s, peak; bert-moe also one ``causal=False`` step), and
   one f32 step of gpt-moe-l at full width cut to 1 layer whose every
   gradient must match the plain versions';
11. runs the decoder-only families at full width (``SLICE11``: smollm,
   mamba2, minitron, gemma2, qwen1.5, qwen2-vl, jamba), one at a time:
   serving as phase 10 serves, at full depth or at the deepest cut in
   whole superblocks that one card holds (a model with mamba layers
   prefills at exact length; exactly the kernels its layers route to
   launch), its f32 cut against the plain versions, for mamba2 and jamba
   also decode after prefill against the full forward, for qwen2-vl a
   forward of stand-in embeddings at distinct M-RoPE streams; then
   training through phase 5's loop at batch 8 x 2,048 at its depth cut
   (qwen1.5, qwen2-vl and jamba: one superblock does not fit; CPU tests
   only);
12. serves and publishes gpt-moe-s on the process grid at full width and
   depth, world size 1 over NCCL: ``train_loop`` through phase 7's grid
   path (ring plan, K = 68, bf16, batch 8 x 2,048, 6 steps) publishing
   every 2 steps into a ``PublicationBus`` of two grid engines with one
   host tag (one stacked build per publication, shared: ``dedup_hits``
   equal to the publications), a forced row-permuting reshard at step 2
   whose next publication alone carries the plan, and after each
   publication the bus flushed and phase 4's four prompts served through
   the scheduler on the grid engine (8 greedy tokens each; no
   SparseAllGather in any decode tick); B1 in both forms, B2, B3, B4 and
   B5 launched; the memory held before the loop read as in phase 7; after
   the last promotion the replica serves a fresh engine's tokens at the
   trainer's (params, pa, version); step, tick, build and
   publish-to-promotion ms and the peak;
13. serves and trains whisper-medium, the encoder-decoder, at full width
   and depth (24 encoder and 24 decoder layers, bf16 compute, f32 master
   weights from seed 0, seeded stand-in frames for the stub frontend): B4
   at the decoder's self-attention shapes (1, S, 16, 64) at phase 4's
   prompt lengths against its plain version and timed; phase 4's prompts
   one-shot prefilled with their frames (B4 in every decoder layer,
   nothing else of the repo) and decoded 16 greedy tokens each through
   the dense cache (nothing of the repo launched), two identical prefills
   and decode steps bitwise equal, ``Engine.generate(encoder_input=)`` on
   four equal prompts, one profiled prefill, the f32 kernel-against-plain
   distance at full depth (recorded) and at 2 + 2 layers (checked, with
   the one-shot prefill's greedy tokens against generate's loop
   prefill's); then ``train_loop`` at batch 8 x 448 decoder tokens and
   1,500 frames: two identical steps bitwise equal, every encoder
   parameter's gradient finite and nonzero and none for the frames, 3
   counted steps (finite loss, no kernel launched; at full depth the
   seeded init's f32 gradient norm overflows and the step guard skips
   each step, as the JAX package's would), one profiled step, and the same
   loop at 4 + 4 layers, which must take every step;
14. runs the dry run (``launch/dryrun.py``, which never touches the card):
   ``python -m repro_torch.launch.dryrun --arch NAME --shape train_4k
   --mesh single`` for every config but ``DRYRUN_CPU_ONLY`` under the
   reference's ``tp`` layout, the default (one process each, in parallel
   on the spare cores, while
   the rest of the phase runs), beside ``prefill_32k`` and ``decode_32k``
   of gpt-moe-s and qwen1.5-110b and three train_4k records under
   ``zero`` (``DRYRUN_SERVE``, ``DRYRUN_ZERO``), each of which must exit
   0 with an ``ok`` record, a train_4k one with a peak under 80 GB,
   printed as one line a record; one rank of the 16 x 16 ``tp``
   deployment on real tensors on the card (``_one_rank_on_the_card``:
   qwen1.5-110b's prefill_32k, which launches B4, and olmoe-1b-7b's
   train_4k, B1-B3, the fake group standing in for the other 255 ranks,
   so nothing is held numerically), its peak against the dry run's; in
   this process
   phase 7's step (gpt-moe-s, batch 8 x 2,048, ring plan, FSSDP layer at
   world size 1) dry-run on a fake 1 x 1 grid, which must allocate no
   device memory and launch no kernel, and whose argument bytes must
   equal those of the real state, batch and plan tables the same step
   then takes on the card over NCCL (3 steps: the real peak against the
   dry run's, and model FLOPs over step time x 989 TFLOP/s);
15. prints the kernel table as one JSON line (each kernel at gpt-moe-s's
   shapes with its launches in phases 4/5, 7, 8, 9 and 12, then at each
   phase-10 configuration's, then the serving kernels at phase 11's new
   shapes, then B4 at Whisper's prompt lengths with its phase-13
   launches), then
   ``{"ok": true, "device": {...}}`` as the last line.

Any failed check exits non-zero before the last line is printed.  Without
a CUDA device, or without the repository around it, it fails.
``--phases`` runs a subset of phases 3-14 after the build (phase 7 reads
phase 5's step median where phase 5 ran); a subset prints no kernel table
and no result line.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM data sheet
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
PROMPT_LENS = (17, 90, 200, 300)
PROMPT_BUCKETS = (32, 128, 256, 512)      # the scheduler's power-of-two pads
PAGED_NEAR_MAX = [511, 510, 508, 505]     # positions near the longest
NEW_TOKENS = 16
MAX_LEN = 512
PAGE_SIZE = 8
MAX_SLOTS = 4
TOL = {"bfloat16": (2e-2, 2e-2), "float32": (2e-5, 2e-4)}
PAGED_TOL = {"bfloat16": (2e-2, 2e-2), "float32": (1e-5, 1e-5)}
# bf16 flash attention against its step-wise plain version, which rounds
# where the kernel rounds: two f32 sums in different orders can still land
# an output, or rarely one probability, on neighbouring bf16 values: one
# output ulp (2^-7 of |x|) plus one probability ulp (2^-8 · |v| / l,
# < 4e-3 for these inputs); as in tests/test_torch_kernels_gpu.py
TILED_TOL = (4e-3, 2 ** -7)
# training: batch 8 × the paper's seq 2,048, so the MoE layer sees 16,384
# tokens, 32,768 (token, expert) assignments, in 64 slots of capacity 16,384
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 2048, 12
# at seq 2,048 the loss of random-init gpt-moe-s rose over 12 steps at lr
# 3e-3 (see PERF.md); 1e-3 is the rate that trains it here
TRAIN_LR, TRAIN_WARMUP = 1e-3, 3
# Whether the loop trains is checked at full width cut to 4 layers.  At
# full depth, 12 steps from the seeded init do not lower the loss: the
# gradient norm there is ~1.4e7 (4 layers: ~600), every AdamW step moves
# the model along chaotic directions, and the loss of a fixed batch moves
# by up to ~0.06 either way over the run, as a 1e-4 perturbation of the
# initial weights decides, with the first port's FMA kernels as with the
# tensor-core ones.  At 4 layers it falls by ~4 in 12 steps
# (tools/train_probe.py; PERF.md).
TRAIN_LEARN_LAYERS = 4
# phase 6: the dense Engine.generate path (4 prompts of 32 tokens, 16
# greedy tokens; its loop prefill runs one decode step per prompt token),
# publication under training at batch 4 x 2,048 (a live and a staged
# snapshot and their slots come on top of the training state: batch 8
# would need ~70 GB), and a two-replica fleet at 4 layers
DENSE_BATCH, DENSE_PROMPT, DENSE_NEW = 4, 32, 16
PUBLISH_BATCH, PUBLISH_STEPS, PUBLISH_EVERY = 4, 4, 2
PUBLISH_PROMPT, PUBLISH_NEW = 8, 2
FLEET_LAYERS = 4
# phase 7: the distributed layer's training loop at world size 1 over NCCL
FSSDP_STEPS = 4
# phase 8: counted steps per remat mode, and each mode's ring hops per step
# in units of m·L (the reference's laws)
OVERLAP_STEPS = 5
REMAT_LAW = {"save": 2, "gather": 3, "block": 3}
# what the cyclic garbage collector may free before a measured run: a
# dropped state is freed at once, so anything more is a reference cycle
GC_FREED_LIMIT_GB = 0.05
# phase 12: serving and publication on the process grid at world size 1 over
# NCCL: counted training steps (batch 8 x 2,048), publication every 2 of
# them into a two-replica bus, the forced reshard's step, and the greedy
# tokens of each of phase 4's prompts served after each publication
GRID_SERVE_STEPS, GRID_PUBLISH_EVERY, GRID_RESHARD_AT = 6, 2, 2
GRID_SERVE_NEW = 8
# phase 9: checkpoint, resume, rollback and restored serving at full width
# cut to 2 layers, batch 8 x 2,048, 6 steps, checkpoints every 2 (keep 2)
CKPT_LAYERS, CKPT_STEPS, CKPT_EVERY = 2, 6, 2
GRAD_TOL = 1e-3     # 2-layer f32 gradients, relative to each tensor's max
# phase 10: the other MoE configurations at full width, one at a time:
# (name, training path, layers trained, batch, seq).  "grid" is phase 7's
# FSSDP layer at world size 1 over NCCL in the config's remat mode,
# "loop" phase 5's train_loop path; the depth is the deepest cut whose
# peak one card holds (PERF.md §4).  bert-moe-deep has bert-moe's widths:
# it serves here, and trains in the CPU tests against the JAX package.
SLICE10 = (("gpt-moe-l", "grid", 4, 8, 2048),
           ("bert-moe", "loop", 10, 32, 512),
           ("bert-moe-deep", None, 0, 0, 0),
           ("olmoe-1b-7b", "grid", 6, 8, 2048),
           ("granite-moe-3b-a800m", "loop", 28, 8, 2048))
SLICE10_NEW = 8        # greedy tokens per served request
SLICE10_STEPS = 3      # counted training steps
# phase 13: whisper-medium at full width and depth: greedy tokens after
# each one-shot prefill, the dense cache's rows (the decoder's cap), the
# prompt length of generate's loop prefill (4 equal prompts), the training
# batch (rows of 448 decoder tokens and 1,500 frames) and counted steps
WHISPER_NEW = 16
WHISPER_MAX_LEN = 448
WHISPER_GEN_LEN = 32
WHISPER_BATCH, WHISPER_STEPS = 8, 3
# the seeded init's gradient norm grows with depth in both packages (at the
# smoke widths from 1.3e2 at 2 + 2 layers to ~3e15 at 24 + 24:
# tools/whisper_grad_depth.py); at this cut, in layers of each stack, the
# loop must take every step
WHISPER_TRAIN_CUT = 4
# phase 11: the decoder-only families at full width, one at a time:
# (name, layers served (None: all), layers trained (0: not on the card),
# batch, seq), each trained through phase 5's train_loop path.  A cut is
# whole superblocks, the deepest whose peak one card holds
# (tools/train_depth_probe.py for training; PERF.md §4).  Three do not
# train at batch 8 x 2,048 on one card even at one superblock: qwen1.5
# and qwen2-vl ran out of memory at one layer, and Jamba's superblock
# holds 12.3B parameters, ~197 GB of training state; they train in the
# CPU tests against the JAX package only.
SLICE11 = (("smollm-360m", None, 32, 8, 2048),
           ("mamba2-1.3b", None, 48, 8, 2048),
           ("minitron-8b", None, 6, 8, 2048),
           ("gemma2-9b", None, 10, 8, 2048),
           ("qwen1.5-110b", 11, 0, 8, 2048),
           ("qwen2-vl-72b", 18, 0, 8, 2048),
           ("jamba-v0.1-52b", 8, 0, 8, 2048))
# tokens of the step whose ep layout phase 3 checks Jamba's expert kernels
# at (16 slots of this many rows, two assignments a token)
JAMBA_KERNEL_TOKENS = 4096
# bf16 dgrad dx against its step-wise plain version (dx from hi + lo): the
# same products summed in f32 in other orders land on neighbouring bf16
# values at most: one ulp, 2^-7 of |dx|; as in tests/test_torch_kernels_gpu.py
SPLIT_DX_TOL = (1e-5, 2 ** -7)
# ptxas -v lines printed for the grouped-MLP sources: the bf16 tensor-core
# products gm_tc_kernel<EPI, GATE, ACT, VEC> (EPI 0 h1 = x@wi, 1 y = h@wo,
# 2 dh = g@woᵀ, 3 dx = (hi + lo)@wiᵀ, 4 h = act(x@wi) of the inference
# form; the main path's are GATE = false, ACT = 0 gelu, VEC = true), the
# zero-row pass, the inference form's tile list and wgrad's products
# gm_wgrad_tc_kernel<VEC>; and the f32 FMA kernels of the forward and
# dgrad, whose one instantiation per (GATE, ACT) takes every D since the
# split over D (tools/ptxas_compare.py holds them to another tree's)
PTXAS_KERNELS = ("gm_tc_kernel", "gm_zero_invalid_rows",
                 "gm_tile_list_kernel", "gm_wgrad_tc_kernel",
                 "grouped_mlp_fwd_kernel", "grouped_mlp_dgrad_kernel")
# the serving path's grouped-MLP kernels as the profiler names them: the
# bf16 tile list and tensor-core products, and the f32 FMA kernel with its
# plane sum
B1_SERVE_KERNELS = ("gm_tile_list_kernel", "gm_tc_kernel",
                    "grouped_mlp_fwd_kernel", "grouped_mlp_reduce_kernel")
SERVE_KERNELS = ("grouped_mlp_fwd", "flash_attention_fwd",
                 "paged_decode_attention")
TRAIN_KERNELS = ("grouped_mlp_fwd_train", "grouped_mlp_dgrad",
                 "grouped_mlp_wgrad")


class CheckFailed(RuntimeError):
    pass


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------
def time_ms(torch, fn, flush, reps: int = 15, warmup: int = 3) -> float:
    """Median device time of one ``fn()`` call (CUDA events), with the L2
    cache flushed before each timed call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return statistics.median(ts)


def _device_ms(dev_ev, *names):
    """Device ms of the profiled kernels whose name holds one of
    ``names``."""
    return sum(e.self_device_time_total for e in dev_ev
               if any(n in e.key for n in names)) / 1e3


def compare(torch, label, got, want, atol, rtol) -> float:
    """Kernel result against plain result; raises past the tolerance."""
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    err = (g - w).abs()
    bad = err > atol + rtol * w.abs()
    mx = float(err.max())
    ok = bool(torch.isfinite(g).all()) and not bool(bad.any())
    print(f"  {label}: max|kernel - plain| = {mx:.3e} "
          f"(atol {atol:g}, rtol {rtol:g}) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise CheckFailed(f"{label}: kernel disagrees with plain version")
    return mx


def bound(nbytes: float, ops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_stats(log: str):
    """(kernel, "N registers, smem, spills") per entry function of an
    ``nvcc -Xptxas -v`` log, names demangled where c++filt is present."""
    import re
    out, name, spill = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name, spill = m.group(1), ""
        elif "spill stores" in ln:
            spill = ln.split(":", 1)[-1].strip()
        elif "Used" in ln and "registers" in ln and name:
            out.append((name, ln.split(":", 1)[-1].strip() + "; " + spill))
            name = None
    try:
        names = subprocess.run(["c++filt"], input="\n".join(n for n, _ in out),
                               capture_output=True, text=True, timeout=30)
        pretty = names.stdout.splitlines()
        if names.returncode == 0 and len(pretty) == len(out):
            out = [(p.split("(")[0], i) for p, (_, i) in zip(pretty, out)]
    except OSError:
        pass
    return out


# ---------------------------------------------------------------------------
# phase 3: every kernel against its plain version
# ---------------------------------------------------------------------------
def _gm_weights(torch, g, dev, K, D, Fd, glu, dt, fan_in=False):
    """(wi, wg, wo) of K slots, wg None without a gate; entries of 0.05,
    or with ``fan_in`` of the model's init (1/sqrt of each matrix's fan-in:
    at D 4,096 and F 14,336 entries of 0.05 give outputs of ~18, whose f32
    sums no model's weights produce)."""
    def rnd(shp):
        sc = shp[1] ** -0.5 if fan_in else 0.05
        return torch.randn(shp, generator=g, device=dev).mul_(sc).to(dt)
    return rnd((K, D, Fd)), rnd((K, D, Fd)) if glu else None, \
        rnd((K, Fd, D))


def check_grouped_mlp(torch, ops, dev, flush, K=64, D=768, Fd=1536,
                      act="gelu", topk=2, ts=(4, 256, 512), seed=1,
                      fan_in=False):
    """B1's inference form against its plain version at serving shapes
    (K slots of T rows, group sizes with empty and full slots, then a
    row_valid mask), both dtypes, and timed in bf16 at the decode tick's
    shape (``MAX_SLOTS`` tokens, ``topk`` of them to a slot each) and at a
    512-bucket prefill (512·``topk`` assignments over the slots)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    glu = act.endswith("_glu")
    errs = []

    def inputs(T, dt):
        x = torch.randn((K, T, D), generator=g, device=dev).mul_(0.3).to(dt)
        return (x, *_gm_weights(torch, g, dev, K, D, Fd, glu, dt, fan_in))

    for dname, dt in (("bfloat16", torch.bfloat16),
                      ("float32", torch.float32)):
        atol, rtol = TOL[dname]
        for T in ts:
            x, wi, wg, wo = inputs(T, dt)
            gs = torch.randint(0, T + 1, (K,), generator=g, device=dev,
                               dtype=torch.int32)
            gs[::5] = 0                           # zero groups
            gs[1] = T
            got = ops.grouped_mlp(x, wi, wg, wo, gs, act=act)
            with ops.reference_mode():
                want = ops.grouped_mlp(x, wi, wg, wo, gs, act=act)
            errs.append(compare(torch, f"grouped_mlp_fwd K={K} T={T} D={D} "
                                f"F={Fd} {act} {dname} group_sizes", got,
                                want, atol, rtol))
        rv = torch.rand((K, T), generator=g, device=dev) < 0.3
        rv[3] = False
        got = ops.grouped_mlp(x, wi, wg, wo, None, rv, act=act)
        with ops.reference_mode():
            want = ops.grouped_mlp(x, wi, wg, wo, None, rv, act=act)
        errs.append(compare(torch, f"grouped_mlp_fwd K={K} T={T} D={D} "
                            f"{act} {dname} row_valid", got, want, atol,
                            rtol))

    # timing at the decode tick's shape: MAX_SLOTS tokens, top-k -> as
    # many slots hold one token each (the other slots are empty, skipped)
    x, wi, wg, wo = inputs(MAX_SLOTS, torch.bfloat16)
    gs = torch.zeros(K, dtype=torch.int32, device=dev)
    gs[torch.randperm(K, generator=g, device=dev)[:topk * MAX_SLOTS]] = 1
    # the bf16 wrapper reads nothing back to the host (the tick is host
    # bound): any synchronising call in it raises here
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ops.grouped_mlp(x, wi, wg, wo, gs, act=act)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print("  grouped_mlp_fwd bfloat16 decode call under "
          "set_sync_debug_mode('error'): no host sync")
    res = _time_grouped_mlp(torch, ops, x, wi, wg, wo, gs, act, flush)
    # and at a prefill of the 300-token prompt (bucket 512): 512 · top-k
    # assignments spread over the slots
    xp, wip, wgp, wop = inputs(512, torch.bfloat16)
    cnt = torch.bincount(torch.randint(0, K, (512 * topk,), generator=g,
                                       device=dev), minlength=K)
    gsp = cnt.clamp(max=512).to(torch.int32)
    got = ops.grouped_mlp(xp, wip, wgp, wop, gsp, act=act)
    with ops.reference_mode():
        want = ops.grouped_mlp(xp, wip, wgp, wop, gsp, act=act)
    errs.append(compare(torch, f"grouped_mlp_fwd K={K} T=512 D={D} F={Fd} "
                        f"{act} bfloat16 timed prefill inputs", got, want,
                        *TOL["bfloat16"]))
    if not torch.equal(got, ops.grouped_mlp(xp, wip, wgp, wop, gsp,
                                            act=act)):
        raise CheckFailed("two identical grouped_mlp_fwd calls differ")
    res["prefill"] = _time_grouped_mlp(torch, ops, xp, wip, wgp, wop, gsp,
                                       act, flush)
    res["max_abs_err"] = max(errs)
    return res


def _time_grouped_mlp(torch, ops, x, wi, wg, wo, gs, act, flush):
    import torch.nn.functional as F
    K, T, D = x.shape
    Fd = wi.shape[-1]
    es = x.element_size()
    nw = 2 if wg is None else 3                  # weight matrices a slot
    run = lambda: ops.grouped_mlp(x, wi, wg, wo, gs, act=act)  # noqa
    ms = time_ms(torch, run, flush)
    with ops.reference_mode():
        plain = time_ms(torch, run, flush)
    groups = [(k, int(n)) for k, n in enumerate(gs.tolist()) if n > 0]

    def library():           # per-group products: the library's way
        for k, n in groups:
            if wg is None:
                h = F.gelu(x[k, :n] @ wi[k], approximate="tanh")
            else:
                h = F.silu(x[k, :n] @ wi[k]) * (x[k, :n] @ wg[k])
            h @ wo[k]
    lib = time_ms(torch, library, flush)
    rows = sum(n for _, n in groups)
    nbytes = (rows * D * es + K * T * D * es + K * T * 4
              + len(groups) * nw * D * Fd * es)
    ops2 = 2 * rows * D * Fd * nw          # the products over valid rows
    b_ms, b_by = bound(nbytes, ops2, "bfloat16")
    return dict(shape=f"K={K} T={T} D={D} F={Fd} {act} bf16, {rows} valid "
                f"rows in {len(groups)} slots", ms=ms, plain_ms=plain,
                library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                tflops=ops2 / ms / 1e9, bound_share=b_ms / ms)


def check_grouped_mlp_train(torch, ops, dev, flush, K=64,
                            T=TRAIN_BATCH * TRAIN_SEQ, D=768, Fd=1536,
                            act="gelu", rows=2 * TRAIN_BATCH * TRAIN_SEQ,
                            experts=64, f32_slots=None, f32_rows=None,
                            plain_slots=None, seed=4, fan_in=False):
    """The three training stages at a training path's shapes: K slots of
    capacity T, ``rows`` valid (token, expert) assignments spread over the
    first ``experts`` slots as the dispatch lays them out (a prefix per
    slot, at most T), D, F, ``act``; by default gpt-moe-s's (64 slots of
    16,384, 32,768 valid rows, D 768, F 1,536, GELU).  Each kernel wrapper
    against its plain version on the same inputs, in bf16 and f32 (each
    stage takes the kernel outputs of the stage before it); f32 on the
    first ``f32_slots`` slots cut to ``f32_rows`` rows where given (the
    wider configs' f32 tensors would not fit); timed in bf16.  The plain
    versions are compared a few slots at a time, which gives the same
    values in a fraction of the memory, and timed over ``plain_slots``
    slots a call where given (all at once by default: at bert-moe's
    shapes the plain dgrad's f32 temporaries over all 64 slots do not
    fit beside its inputs)."""
    import torch.nn.functional as F
    from repro_torch.kernels import grouped_mlp as gm
    from repro_torch.kernels import ref
    glu = act.endswith("_glu")
    g = torch.Generator(device=dev).manual_seed(seed)
    cnt = torch.zeros(K, dtype=torch.int64, device=dev)
    cnt[:experts] = torch.bincount(torch.randint(
        0, experts, (rows,), generator=g, device=dev), minlength=experts)
    cnt.clamp_(max=T)
    rows = int(cnt.sum())
    mask = (torch.arange(T, device=dev)[None, :] < cnt[:, None]) \
        .to(torch.int32)
    errs = {n: [] for n in TRAIN_KERNELS}
    shape = f"K={K} T={T} D={D} F={Fd} {act}, {rows} valid rows"

    def inputs(dt, k_=K, t_=T):
        def rnd(shp, sc):
            return torch.randn(shp, generator=g, device=dev).mul_(sc).to(dt)
        return (rnd((k_, t_, D), 0.3),
                *_gm_weights(torch, g, dev, k_, D, Fd, glu, dt, fan_in),
                rnd((k_, t_, D), 0.1))

    def held(name, labels, got, plain, residuals=(), tol=None):
        """Kernel outputs ``got`` against ``plain(slots)`` over slot
        chunks; the outputs named in ``residuals`` (h1, h2) only at valid
        rows, where the next stage reads them.  Returns the largest error
        of each output."""
        atol, rtol = tol or TOL[dname]
        worst, bad = {}, set()
        for k0 in range(0, got[0].shape[0], 8):
            sl = slice(k0, k0 + 8)
            for a, b, what in zip(got, plain(sl), labels.split(",")):
                if b is None:
                    continue
                a = a[sl]
                if what in residuals:
                    a, b = a[vm[sl]], b[vm[sl]]
                err = (a.float() - b.float()).abs()
                if not bool(torch.isfinite(a).all()) or bool(
                        (err > atol + rtol * b.float().abs()).any()):
                    bad.add(what)
                mx = float(err.max()) if err.numel() else 0.0
                worst[what] = max(worst.get(what, 0.0), mx)
        for what, mx in worst.items():
            ok = what not in bad
            print(f"  {name} {what} {cut} {dname}: max|kernel - plain| = "
                  f"{mx:.3e} (atol {atol:g}, rtol {rtol:g}) "
                  f"{'ok' if ok else 'FAILED'}")
            if not ok:
                raise CheckFailed(f"{name} {what}: kernel disagrees with "
                                  f"plain version")
        return worst

    def gsl(t, s):                          # a gate's slots, or None
        return None if t is None else t[s]

    split_err = None
    for dname, dt in (("bfloat16", torch.bfloat16),
                      ("float32", torch.float32)):
        ks, tr = (min(f32_slots, K), f32_rows) if dname == "float32" \
            and f32_slots else (K, T)
        m = mask[:ks, :tr].contiguous()
        vm = m.bool()
        cut = shape if (ks, tr) == (K, T) else \
            f"{shape}, first {ks} slots cut to {tr} rows"
        x, wi, wg, wo, dy = inputs(dt, ks, tr)
        fwd = gm.grouped_mlp_fwd_train(x, wi, wg, wo, m, act=act)
        stages = [("grouped_mlp_fwd_train", held(
            "grouped_mlp_fwd_train", "y,h1,h2", fwd,
            lambda s: ref.grouped_mlp_fwd_train_ref(
                x[s], wi[s], None if wg is None else wg[s], wo[s], m[s],
                act=act),
            residuals=("h1", "h2")))]
        h1, h2 = fwd[1], fwd[2]
        del fwd

        dg = gm.grouped_mlp_dgrad(dy, m, h1, h2, wi, wg, wo, act=act)
        stages.append(("grouped_mlp_dgrad", held(
            "grouped_mlp_dgrad", "dx,dh1,dh2,h", dg,
            lambda s: ref.grouped_mlp_dgrad_ref(
                dy[s], m[s], h1[s], gsl(h2, s), wi[s], gsl(wg, s), wo[s],
                act=act))))
        if dname == "bfloat16":     # the tensor-core kernel's own rounding
            split_err = held(
                "grouped_mlp_dgrad vs step-wise", "dx", dg[:1],
                lambda s: ref.grouped_mlp_dgrad_split_ref(
                    dy[s], m[s], h1[s], gsl(h2, s), wi[s], gsl(wg, s), wo[s],
                    act=act)[:1], tol=SPLIT_DX_TOL)["dx"]
        dh1, dh2, h = dg[1], dg[2], dg[3]
        del dg
        wg1 = gm.grouped_mlp_wgrad(x, dy, m, dh1, dh2, h)
        stages.append(("grouped_mlp_wgrad", held(
            "grouped_mlp_wgrad", "dwi,dwg,dwo", wg1,
            lambda s: ref.grouped_mlp_wgrad_ref(x[s], dy[s], m[s], dh1[s],
                                                gsl(dh2, s), h[s]))))
        if dname == "bfloat16":     # no atomics, no split: the same bits
            wg2 = gm.grouped_mlp_wgrad(x, dy, m, dh1, dh2, h)
            if not all(a is None or torch.equal(a, b)
                       for a, b in zip(wg1, wg2)):
                raise CheckFailed("two identical grouped_mlp_wgrad calls "
                                  "differ")
            print(f"  grouped_mlp_wgrad {shape} bfloat16: two calls "
                  f"bitwise equal")
            del wg2
        del wg1
        for name, worst in stages:
            errs[name].extend(worst.values())
        del x, wi, wg, wo, dy, h1, h2, dh1, dh2, h
        torch.cuda.empty_cache()
    # time in bf16
    x, wi, wg, wo, dy = inputs(torch.bfloat16)
    # the main path builds the bf16 kernels' tile list once per forward
    # (GroupedMLPFunction) and hands it to B1-train, B2 and B3: the three
    # are timed with it given, and the list on its own (it reads its
    # length back to the host)
    tiles = gm.tile_list(mask)
    tile_ms = time_ms(torch, lambda: gm.tile_list(mask), flush)
    _, h1, h2 = gm.grouped_mlp_fwd_train(x, wi, wg, wo, mask, act=act)
    _, dh1, dh2, h = gm.grouped_mlp_dgrad(dy, mask, h1, h2, wi, wg, wo,
                                          act=act)
    groups = [(k, int(n)) for k, n in enumerate(cnt.tolist()) if n > 0]
    es = x.element_size()
    nw = 3 if glu else 2                   # weight matrices of a slot
    wbytes = len(groups) * nw * D * Fd * es
    ops2 = nw * 2 * rows * D * Fd          # nw products of 2·rows·D·F
    act_bwd = (torch.ops.aten.silu_backward if glu else
               lambda d, v: torch.ops.aten.gelu_backward(
                   d, v, approximate="tanh"))

    def lib_fwd():
        for k, n in groups:
            a = x[k, :n] @ wi[k]
            hh = F.silu(a) * (x[k, :n] @ wg[k]) if glu else \
                F.gelu(a, approximate="tanh")
            hh @ wo[k]

    def lib_dgrad():
        for k, n in groups:
            dh = (dy[k, :n] @ wo[k].t()).float()
            if glu:
                a = F.silu(h1[k, :n].float())
                d1 = act_bwd(dh * h2[k, :n].float(), h1[k, :n].float())
                (d1.to(x.dtype) @ wi[k].t()
                 + (dh * a).to(x.dtype) @ wg[k].t())
            else:
                d1 = act_bwd(dh, h1[k, :n].float())
                F.gelu(h1[k, :n], approximate="tanh")
                d1.to(x.dtype) @ wi[k].t()

    def lib_wgrad():
        for k, n in groups:
            x[k, :n].t() @ dh1[k, :n]
            if glu:
                x[k, :n].t() @ dh2[k, :n]
            h[k, :n].t() @ dy[k, :n]

    nf = 2 if glu else 1                   # h1 [h2]; dh1 [dh2]
    cases = {
        "grouped_mlp_fwd_train": (
            lambda: gm.grouped_mlp_fwd_train(x, wi, wg, wo, mask, act=act,
                                             tiles=tiles),
            lambda s: ref.grouped_mlp_fwd_train_ref(
                x[s], wi[s], gsl(wg, s), wo[s], mask[s], act=act),
            lib_fwd,
            # x's valid rows, mask, the used slots' weights in; y written
            # whole (the Pallas kernel writes all of it), h1 [h2] at valid
            # rows (their only reader, dgrad, reads those)
            rows * (D + nf * Fd) * es + K * T * 4 + wbytes
            + K * T * D * es),
        "grouped_mlp_dgrad": (
            lambda: gm.grouped_mlp_dgrad(dy, mask, h1, h2, wi, wg, wo,
                                         act=act, tiles=tiles),
            lambda s: ref.grouped_mlp_dgrad_ref(
                dy[s], mask[s], h1[s], gsl(h2, s), wi[s], gsl(wg, s), wo[s],
                act=act),
            lib_dgrad,
            # dy's and h1's [h2's] valid rows, mask, weights in; dx, dh1,
            # [dh2,] h out, whole
            rows * (D + nf * Fd) * es + K * T * 4 + wbytes
            + K * T * (D + (nf + 1) * Fd) * es),
        "grouped_mlp_wgrad": (
            lambda: gm.grouped_mlp_wgrad(x, dy, mask, dh1, dh2, h,
                                         tiles=tiles),
            lambda s: ref.grouped_mlp_wgrad_ref(x[s], dy[s], mask[s], dh1[s],
                                                gsl(dh2, s), h[s]),
            lib_wgrad,
            # x, dy, dh1 [dh2], h valid rows and mask in; the weight
            # gradients written
            rows * (2 * D + (nf + 1) * Fd) * es + K * T * 4
            + K * nw * D * Fd * es),
    }
    res = {}
    step = plain_slots or K
    for name, (kern, plain, lib, nbytes) in cases.items():
        b_ms, b_by = bound(nbytes, ops2, "bfloat16")
        ms = time_ms(torch, kern, flush)
        res[name] = dict(
            shape=shape + " bf16", ms=ms,
            plain_ms=time_ms(torch, lambda: [
                plain(slice(k0, k0 + step)) for k0 in range(0, K, step)],
                flush, reps=5, warmup=1),
            library_ms=time_ms(torch, lib, flush, reps=5, warmup=1),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=max(errs[name]),
            # the function's products over the valid rows
            tflops=ops2 / ms / 1e9, bound_share=b_ms / ms)
    res["grouped_mlp_dgrad"]["split_dx_err"] = split_err
    res["grouped_mlp_fwd_train"]["tile_list_ms"] = tile_ms
    del x, wi, wg, wo, dy, h1, h2, dh1, dh2, h
    torch.cuda.empty_cache()
    return res


def check_flash_attention(torch, ops, dev, flush):
    g = torch.Generator(device=dev).manual_seed(2)
    errs = []

    def qkv(B, S, N, H, dt):
        return [torch.randn((B, S, N, H), generator=g, device=dev)
                .mul_(0.5).to(dt) for _ in range(3)]

    for dname, dt in (("bfloat16", torch.bfloat16),
                      ("float32", torch.float32)):
        atol, rtol = TOL[dname]
        for (B, S, N, H), causal, window in (((1, 512, 12, 64), True, 0),
                                             ((1, 512, 12, 64), True, 128),
                                             ((2, 64, 12, 64), True, 0),
                                             ((1, 32, 12, 64), True, 0),
                                             ((1, 256, 12, 64), True, 96),
                                             ((1, 128, 12, 64), False, 0)):
            q, k, v = qkv(B, S, N, H, dt)
            got = ops.flash_attention(q, k, v, causal=causal, window=window)
            with ops.reference_mode():
                want = ops.flash_attention(q, k, v, causal=causal,
                                           window=window)
            errs.append(compare(torch, f"flash_attention_fwd "
                                f"({B},{S},{N},{H}) causal={causal} "
                                f"window={window} {dname}", got, want, atol,
                                rtol))
            if dname == "bfloat16" and not torch.equal(
                    got, ops.flash_attention(q, k, v, causal=causal,
                                             window=window)):
                raise CheckFailed("two identical flash_attention calls "
                                  "gave different bits")
    # at each prompt bucket of the served run (batch 1, causal, bf16): held
    # to the plain version and to the step-wise one, then timed
    from repro_torch.kernels import ref
    buckets = {}
    for S in PROMPT_BUCKETS:
        q, k, v = qkv(1, S, 12, 64, torch.bfloat16)
        got = ops.flash_attention(q, k, v, causal=True)
        label = f"flash_attention_fwd (1,{S},12,64) causal=True bfloat16"
        errs.append(compare(torch, label, got, ref.flash_attention_ref(
            q, k, v, causal=True), *TOL["bfloat16"]))
        errs.append(compare(torch, f"{label} vs step-wise", got,
                            ref.flash_attention_tiled_ref(q, k, v,
                                                          causal=True),
                            *TILED_TOL))
        buckets[S] = _time_flash(torch, flush, q, k, v)
    res = dict(buckets[max(PROMPT_BUCKETS)], max_abs_err=max(errs),
               buckets=buckets)
    return res


def _time_flash(torch, flush, q, k, v):
    """The kernel through its wrapper, the plain version called directly
    (neither through the dispatcher), and SDPA on the same inputs."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    B, S, N, H = q.shape
    ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, causal=True),
                 flush)
    plain = time_ms(torch, lambda: ref.flash_attention_ref(q, k, v,
                                                           causal=True),
                    flush)
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), flush)
    es = q.element_size()
    b_ms, b_by = bound(4 * q.numel() * es,
                       4 * B * N * H * S * (S + 1) / 2, "bfloat16")
    return dict(shape=f"(B,S,N,H)=({B},{S},{N},{H}) causal bf16", ms=ms,
                plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                bound_by=b_by)


def _paged_inputs(torch, dev, g, positions, nkv, group, dt, hd=64,
                  max_kv=MAX_LEN, ps=PAGE_SIZE):
    from repro_torch.serve.kv_pool import PageTable
    B = len(positions)
    n_blk = max_kv // ps
    num_pages = B * n_blk + 1
    q = torch.randn((B, nkv * group, hd), generator=g, device=dev) \
        .mul_(0.5).to(dt)
    k = torch.randn((num_pages * ps, nkv, hd), generator=g, device=dev) \
        .mul_(0.5).to(dt)
    v = torch.randn((num_pages * ps, nkv, hd), generator=g, device=dev) \
        .to(dt)
    perm = (torch.randperm(num_pages - 1, generator=g, device=dev) + 1) \
        .tolist()
    rows = []
    for pos in positions:
        n = 0 if pos < 0 else pos // ps + 1
        rows.append(PageTable(ps, max_kv, [perm.pop() for _ in range(n)])
                    .row_idx())
    import numpy as np
    ri = torch.as_tensor(np.stack(rows), device=dev)
    pos_t = torch.tensor([max(p, 0) for p in positions], dtype=torch.int32,
                         device=dev)
    return q, k, v, ri, pos_t


def check_paged_attention(torch, ops, dev, flush):
    g = torch.Generator(device=dev).manual_seed(3)
    errs = []
    for dname, dt in (("bfloat16", torch.bfloat16),
                      ("float32", torch.float32)):
        atol, rtol = PAGED_TOL[dname]
        for label, positions, nkv, group, window, softcap in (
                ("ragged + parked slot", [33, 106, 216, -1], 12, 1, 0, 0.0),
                ("GQA nq/nkv=4", [7, 64, 300, 511], 3, 4, 0, 0.0),
                ("window + softcap", [5, 100, 257, 480], 12, 1, 60, 30.0)):
            q, k, v, ri, pos = _paged_inputs(torch, dev, g, positions, nkv,
                                             group, dt)
            kw = dict(page_size=PAGE_SIZE, window=window, softcap=softcap)
            got = ops.paged_decode_attention(q, k, v, ri, pos, **kw)
            with ops.reference_mode():
                want = ops.paged_decode_attention(q, k, v, ri, pos, **kw)
            errs.append(compare(torch, f"paged_decode_attention B=4 "
                                f"{nkv * group}/{nkv} heads {label} {dname}",
                                got, want, atol, rtol))
    # timing at a decode tick of the served run: the four sequences after
    # their prompts (17, 90, 200, 300 tokens) and half their new tokens;
    # then four sequences near the longest, 512 tokens
    positions = [n + NEW_TOKENS // 2 for n in PROMPT_LENS]
    res = _time_paged(torch, flush, *_paged_inputs(
        torch, dev, g, positions, 12, 1, torch.bfloat16), positions)
    res["near_max"] = _time_paged(torch, flush, *_paged_inputs(
        torch, dev, g, PAGED_NEAR_MAX, 12, 1, torch.bfloat16),
        PAGED_NEAR_MAX)
    res["max_abs_err"] = max(errs)
    return res


def _time_paged(torch, flush, q, k, v, ri, pos, positions, window=0,
                softcap=0.0):
    """The kernel through its wrapper, on the page table the dispatcher
    derives from ``ri`` (made once, outside the timing), the plain version
    called directly on ``ri`` (its own input; neither through the
    dispatcher), and SDPA on gathered K/V (windowed with ``window``; it
    has no logit softcap, which the other two apply)."""
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    tbl = (ri[:, ::PAGE_SIZE] // PAGE_SIZE).to(torch.int32).contiguous()
    run = lambda: pa.paged_decode_attention(  # noqa: E731
        q, k, v, tbl, pos, page_size=PAGE_SIZE, window=window,
        softcap=softcap)
    first = run()
    if not torch.equal(first, run()):
        raise CheckFailed("two identical paged_decode_attention calls gave "
                          "different bits")
    ms = time_ms(torch, run, flush)
    plain = time_ms(torch, lambda: ref.paged_decode_attention_ref(
        q, k, v, ri, pos, window=window, softcap=softcap), flush)
    B, nq, hd = q.shape
    nkv = k.shape[1]
    kg = k[ri.long()].permute(0, 2, 1, 3).contiguous()   # (B, nkv, kv, hd)
    vg = v[ri.long()].permute(0, 2, 1, 3).contiguous()
    kpos = torch.arange(ri.shape[1], device=q.device)[None, :]
    mask = kpos <= pos[:, None].long()
    if window > 0:
        mask &= kpos > pos[:, None].long() - window
    mask = mask[:, None, None, :]
    qs = q[:, :, None]
    lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, kg, vg, attn_mask=mask, enable_gqa=True), flush)
    es = q.element_size()
    toks = sum(min(p + 1, window) if window > 0 else p + 1
               for p in positions)
    nbytes = 2 * q.numel() * es + toks * nkv * hd * es * 2 + ri.numel() // \
        PAGE_SIZE * 4 + B * 4
    b_ms, b_by = bound(nbytes, 4 * toks * nq * hd, "bfloat16")
    extra = (f" window {window}" if window else "") + \
        (f" softcap {softcap:g} (SDPA without it)" if softcap else "")
    return dict(shape=f"B={B} {nq}/{nkv} heads hd={hd} page {PAGE_SIZE} "
                f"positions {positions}{extra} bf16", ms=ms, plain_ms=plain,
                library_ms=lib, bound_ms=b_ms, bound_by=b_by)


def check_attention_heads(torch, ops, dev, flush, N, H, nkv, seed):
    """B4 and B5 at a configuration's heads: flash attention (N heads of
    H after the K/V expansion) at each prompt bucket in bf16 against the
    plain and the step-wise version, in f32 at 512 and 32, two calls
    bitwise equal, timed at 512; paged decode (N query heads over nkv)
    at the served tick's positions and with a parked slot, both dtypes,
    timed at the tick."""
    from repro_torch.kernels import ref
    g = torch.Generator(device=dev).manual_seed(seed)
    errs = []

    def qkv(S, dt):
        return [torch.randn((1, S, N, H), generator=g, device=dev)
                .mul_(0.5).to(dt) for _ in range(3)]

    for dname, dt, buckets in (("bfloat16", torch.bfloat16, PROMPT_BUCKETS),
                               ("float32", torch.float32, (32, 512))):
        for S in buckets:
            q, k, v = qkv(S, dt)
            got = ops.flash_attention(q, k, v, causal=True)
            label = f"flash_attention_fwd (1,{S},{N},{H}) causal {dname}"
            errs.append(compare(torch, label, got, ref.flash_attention_ref(
                q, k, v, causal=True), *TOL[dname]))
            if dname == "bfloat16":
                errs.append(compare(torch, f"{label} vs step-wise", got,
                                    ref.flash_attention_tiled_ref(
                                        q, k, v, causal=True), *TILED_TOL))
                if not torch.equal(got, ops.flash_attention(q, k, v,
                                                            causal=True)):
                    raise CheckFailed("two identical flash_attention calls "
                                      "gave different bits")
    flash = dict(_time_flash(torch, flush, *qkv(max(PROMPT_BUCKETS),
                                                torch.bfloat16)),
                 max_abs_err=max(errs))
    errs = []
    positions = [n + SLICE10_NEW // 2 for n in PROMPT_LENS]
    for dname, dt in (("bfloat16", torch.bfloat16),
                      ("float32", torch.float32)):
        for pos in (positions, positions[:3] + [-1]):
            q, k, v, ri, p = _paged_inputs(torch, dev, g, pos, nkv,
                                           N // nkv, dt, hd=H)
            kw = dict(page_size=PAGE_SIZE)
            got = ops.paged_decode_attention(q, k, v, ri, p, **kw)
            with ops.reference_mode():
                want = ops.paged_decode_attention(q, k, v, ri, p, **kw)
            errs.append(compare(torch, f"paged_decode_attention B=4 {N}/{nkv}"
                                f" heads hd={H} positions {pos} {dname}",
                                got, want, *PAGED_TOL[dname]))
    paged = dict(_time_paged(torch, flush, *_paged_inputs(
        torch, dev, g, positions, nkv, N // nkv, torch.bfloat16, hd=H),
        positions), max_abs_err=max(errs))
    return {"flash_attention_fwd": flash, "paged_decode_attention": paged}


def _train_layout(cfg, path, batch, seq):
    """(K, T, experts) of the grouped FFN on a phase-10 training path:
    the grid's ring plan at ep = 1 (the experts' slots and m extra ones,
    each of ``auto_capacity`` rows), or the ``ep`` plan's E slots of
    every token of the step."""
    from repro_torch.core import moe
    from repro_torch.train.trainer import HecateScheduler
    E, tokens = cfg.moe.num_experts, batch * seq
    if path == "grid":
        K = HecateScheduler(cfg, ep=1, impl="ring", device="cpu") \
            .plan().k_total
        return K, moe.auto_capacity(cfg, tokens, 1, K), E
    return E, tokens, E


def check_slice10_kernels(torch, ops, dev, flush):
    """Phase 3 at phase 10's shapes, one configuration at a time (bert-moe-
    deep has bert-moe's): B1's inference form at its serving shapes, B4 and
    B5 at its heads and, for a trained configuration, B1-train, B2 and B3
    at its training path's layout in bf16 (f32 on 8 slots of it)."""
    import repro_torch.configs as configs
    res = {}
    for i, (name, path, _, batch, seq) in enumerate(SLICE10):
        if name == "bert-moe-deep":
            continue
        cfg = configs.get(name)
        m, E, k = cfg.moe, cfg.moe.num_experts, cfg.moe.experts_per_token
        print(f"  -- {name}: d_model {cfg.d_model}, {E} experts top-{k}, "
              f"expert d_ff {m.d_ff}, {cfg.act}; {cfg.num_heads}/"
              f"{cfg.num_kv_heads} heads of {cfg.head_dim}")
        r = {"grouped_mlp_fwd": check_grouped_mlp(
            torch, ops, dev, flush, K=E, D=cfg.d_model, Fd=m.d_ff,
            act=cfg.act, topk=k, ts=(4, 512), seed=20 + i)}
        r.update(check_attention_heads(torch, ops, dev, flush,
                                       cfg.num_heads, cfg.head_dim,
                                       cfg.num_kv_heads, seed=30 + i))
        if path:
            K, T, experts = _train_layout(cfg, path, batch, seq)
            r.update(check_grouped_mlp_train(
                torch, ops, dev, flush, K=K, T=T, D=cfg.d_model, Fd=m.d_ff,
                act=cfg.act, rows=k * batch * seq, experts=experts,
                f32_slots=8, f32_rows=min(T, 2048), plain_slots=8,
                seed=40 + i))
        res[name] = r
    return res


def check_flash_exact_length(torch, ops, dev, flush, N, H, nkv, seed):
    """B4 at the prompts' exact lengths (``PROMPT_LENS``: a model with
    mamba layers prefills without padding), N query heads of H over nkv
    (expanded by the dispatcher), causal and windowed: against the plain
    version in both dtypes, in bf16 also against the step-wise version and
    bitwise over two calls; timed in bf16 at the longest prompt."""
    from repro_torch.kernels import ref
    g = torch.Generator(device=dev).manual_seed(seed)
    errs = []

    def qkv(S, dt):
        return [torch.randn((1, S, n, H), generator=g, device=dev)
                .mul_(0.5).to(dt) for n in (N, nkv, nkv)]

    for dname, dt in (("bfloat16", torch.bfloat16),
                      ("float32", torch.float32)):
        for S in PROMPT_LENS:
            for window in (0, 64):
                q, k, v = qkv(S, dt)
                kw = dict(causal=True, window=window)
                got = ops.flash_attention(q, k, v, **kw)
                with ops.reference_mode():
                    want = ops.flash_attention(q, k, v, **kw)
                label = (f"flash_attention_fwd (1,{S},{N},{H}) over {nkv} "
                         f"KV heads causal window={window} {dname}")
                errs.append(compare(torch, label, got, want, *TOL[dname]))
                if dname == "bfloat16":
                    kx, vx = (torch.repeat_interleave(a, N // nkv, dim=2)
                              for a in (k, v))
                    errs.append(compare(
                        torch, f"{label} vs step-wise", got,
                        ref.flash_attention_tiled_ref(q, kx, vx, **kw),
                        *TILED_TOL))
                    if not torch.equal(got, ops.flash_attention(q, k, v,
                                                                **kw)):
                        raise CheckFailed("two identical flash_attention "
                                          "calls gave different bits")
    q, k, v = qkv(max(PROMPT_LENS), torch.bfloat16)
    k, v = (torch.repeat_interleave(a, N // nkv, dim=2).contiguous()
            for a in (k, v))
    return dict(_time_flash(torch, flush, q, k, v), max_abs_err=max(errs))


def check_paged_model(torch, ops, dev, flush, N, H, nkv, window, softcap,
                      seed):
    """B5 at a model's decode heads (N query heads of H over nkv) with its
    window and logit softcap, at the served tick's positions and with a
    parked slot, also with a window that cuts into the pages (60): against
    the plain version in both dtypes; timed in bf16 at the tick with the
    model's window and softcap."""
    g = torch.Generator(device=dev).manual_seed(seed)
    errs = []
    positions = [n + SLICE10_NEW // 2 for n in PROMPT_LENS]
    for dname, dt in (("bfloat16", torch.bfloat16),
                      ("float32", torch.float32)):
        for pos in (positions, positions[:3] + [-1]):
            for w in (window, 60):
                q, k, v, ri, p = _paged_inputs(torch, dev, g, pos, nkv,
                                               N // nkv, dt, hd=H)
                kw = dict(page_size=PAGE_SIZE, window=w, softcap=softcap)
                got = ops.paged_decode_attention(q, k, v, ri, p, **kw)
                with ops.reference_mode():
                    want = ops.paged_decode_attention(q, k, v, ri, p, **kw)
                errs.append(compare(
                    torch, f"paged_decode_attention B=4 {N}/{nkv} heads "
                    f"hd={H} window {w} softcap {softcap:g} positions {pos} "
                    f"{dname}", got, want, *PAGED_TOL[dname]))
    return dict(_time_paged(torch, flush, *_paged_inputs(
        torch, dev, g, positions, nkv, N // nkv, torch.bfloat16, hd=H),
        positions, window=window, softcap=softcap), max_abs_err=max(errs))


def check_slice11_kernels(torch, ops, dev, flush):
    """Phase 3 at phase 11's new kernel shapes: B5 at Gemma-2's decode
    (16 of 256 over 8 KV heads, window 4,096, softcap 50), B4 at Jamba's
    exact-length prefill (32 of 128 over 8 KV heads), and B1's inference
    form, B1-train, B2 and B3 at Jamba's experts (16, top-2, D 4,096, F
    14,336, SiLU GLU; weights at the model's fan-in scale) on its ``ep``
    layout of a 4,096-token step (bf16; f32 on 4 slots cut to 1,024
    rows).  Jamba trains on the CPU only (phase 11), so its training
    kernels run here alone."""
    import repro_torch.configs as configs
    gem, jam = configs.get("gemma2-9b"), configs.get("jamba-v0.1-52b")
    res = {"gemma2-9b": {"paged_decode_attention": check_paged_model(
        torch, ops, dev, flush, gem.num_heads, gem.head_dim,
        gem.num_kv_heads, gem.sliding_window, gem.attn_logit_softcap, 60)}}
    m = jam.moe
    r = {"flash_attention_fwd": check_flash_exact_length(
        torch, ops, dev, flush, jam.num_heads, jam.head_dim,
        jam.num_kv_heads, 61)}
    r["grouped_mlp_fwd"] = check_grouped_mlp(
        torch, ops, dev, flush, K=m.num_experts, D=jam.d_model, Fd=m.d_ff,
        act=jam.act, topk=m.experts_per_token, ts=(4, 512), seed=62,
        fan_in=True)
    tokens = JAMBA_KERNEL_TOKENS
    r.update(check_grouped_mlp_train(
        torch, ops, dev, flush, K=m.num_experts, T=tokens, D=jam.d_model,
        Fd=m.d_ff, act=jam.act, rows=m.experts_per_token * tokens,
        experts=m.num_experts, f32_slots=4, f32_rows=min(tokens, 1024),
        plain_slots=2, seed=63, fan_in=True))
    res["jamba-v0.1-52b"] = r
    return res


# ---------------------------------------------------------------------------
# phase 4: serving
# ---------------------------------------------------------------------------
def _prompts(vocab: int):
    import numpy as np
    text = ("Hecate serves a sparse mixture of experts: every token picks "
            "two of sixty-four experts, and the scheduler batches requests "
            "of any length through one paged key-value pool. ") * 8
    return [np.frombuffer(text[:n].encode(), np.uint8).astype(np.int32)
            % vocab for n in PROMPT_LENS]


def _plan(torch, cfg, dev):
    from repro_torch.core import moe
    from repro_torch.core.placement import (ep_materialization,
                                            homogeneous_sharding)
    sh = homogeneous_sharding(moe.num_moe_layers(cfg), cfg.moe.num_experts,
                              1)
    return moe.plan_to_arrays(ep_materialization(sh), dev)


def _cut_depth(cfg, params, n: int):
    """gpt-moe-s with its first ``n`` layers: the same widths and the same
    weights of those layers, f32 compute."""
    def cut(t):
        return {k: cut(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[:n]
    p = dict(params, blocks=cut(params["blocks"]),
             router=params["router"][:n],
             moe_buffer=params["moe_buffer"][:n * cfg.moe.num_experts])
    return cfg.replace(num_layers=n, dtype="float32"), p


def _timed(torch, fn, sink, per_bucket=None):
    """``fn`` timed into ``sink``; with ``per_bucket``, a prefill also adds
    its flash-attention launches to ``per_bucket[padded length]``."""
    from repro_torch.kernels import ops

    def call(*a, **kw):
        torch.cuda.synchronize()
        n0 = ops.launch_counts()["flash_attention_fwd"]
        t = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        sink.append((time.perf_counter() - t) * 1e3)
        if per_bucket is not None:
            s = a[1]["tokens"].shape[1]
            per_bucket[s] = per_bucket.get(s, 0) + \
                ops.launch_counts()["flash_attention_fwd"] - n0
        if not bool(torch.isfinite(out[0]).all()):
            raise CheckFailed("non-finite logits on the main path")
        return out
    return call


def serve_full_width(torch, ops, dev, card):
    import repro_torch.configs as configs
    from repro_torch.models import model as mdl
    from repro_torch.serve.engine import Engine, build_prefill_step
    from repro_torch.serve.kv_pool import PageTable
    from repro_torch.serve.scheduler import DONE, RequestScheduler

    cfg = configs.get("gpt-moe-s")
    t = time.perf_counter()
    params = mdl.init_params(cfg, 0, dev)
    torch.cuda.synchronize()
    print(f"  gpt-moe-s: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.moe.num_experts} experts top-{cfg.moe.experts_per_token}, "
          f"{cfg.dtype} compute, {cfg.param_dtype} master; seeded init "
          f"{time.perf_counter() - t:.2f} s")
    pa = _plan(torch, cfg, dev)
    eng = Engine(cfg, mdl.Runtime(), params, max_len=MAX_LEN, pa=pa)
    t = time.perf_counter()
    eng._snapshot()
    torch.cuda.synchronize()
    slot_ms = (time.perf_counter() - t) * 1e3
    pages = -(-MAX_LEN // PAGE_SIZE) * MAX_SLOTS + 1
    rs = RequestScheduler(eng, max_slots=MAX_SLOTS, num_pages=pages,
                          page_size=PAGE_SIZE, max_kv=MAX_LEN,
                          default_ttl_s=3600.0)
    prefill_ms, tick_ms, flash_per_bucket = [], [], {}
    prefill_fn, step_fn = rs._prefill_fn, rs._step_fn
    rs._prefill_fn = _timed(torch, prefill_fn, prefill_ms, flash_per_bucket)
    rs._step_fn = _timed(torch, step_fn, tick_ms)
    prompts = _prompts(cfg.vocab_size)
    # warm-up outside the counted run: library loads, first-call set-up
    warm = rs.submit(prompts[0], max_new_tokens=2)
    rs.run(max_ticks=10)
    if warm.state != DONE:
        raise CheckFailed(f"warm-up request ended {warm.state}")
    prefill_ms.clear()
    tick_ms.clear()
    flash_per_bucket.clear()
    ticks0 = rs.decode_ticks
    reqs = [rs.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    ops.reset_launch_counts()               # the main path's run starts
    t = time.perf_counter()
    rs.run(max_ticks=10 * NEW_TOKENS)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    launches = ops.launch_counts()          # ... and ends
    rs._prefill_fn, rs._step_fn = prefill_fn, step_fn
    bad = [(r.state, r.finish_reason) for r in reqs if r.state != DONE]
    if bad:
        raise CheckFailed(f"requests did not finish: {bad}")
    if any(len(r.generated) != NEW_TOKENS for r in reqs):
        raise CheckFailed("a request produced the wrong number of tokens")
    print(f"  served {len(reqs)} requests (prompts {list(PROMPT_LENS)}, "
          f"{NEW_TOKENS} new tokens each): all DONE, logits finite")
    ticks = rs.decode_ticks - ticks0
    print(f"  [{card}] decode ticks: {ticks}")
    print(f"  [{card}] prefill ms per request: "
          f"{[round(x, 3) for x in prefill_ms]}")
    print(f"  [{card}] median decode-tick ms: "
          f"{statistics.median(tick_ms):.3f}")
    print(f"  [{card}] slot-cache build ms: {slot_ms:.3f}; run wall s: "
          f"{wall_s:.3f}")
    print(f"  launches on the main path: {launches}")
    print(f"  flash_attention_fwd launches per prompt bucket: "
          f"{dict(sorted(flash_per_bucket.items()))}")
    if min(launches[k] for k in SERVE_KERNELS) <= 0 or any(
            launches[k] for k in TRAIN_KERNELS):
        raise CheckFailed(f"a serving kernel never launched, or a training "
                          f"kernel did: {launches}")

    # one prefill and one decode tick through the plain versions on the
    # same CUDA tensors (explicit opt-in; after the counted run)
    params, pa, premat = eng._snapshot()
    p = prompts[1]
    toks = torch.zeros((1, rs._bucket(p.size)), dtype=torch.int32,
                       device=dev)
    toks[0, :p.size] = torch.as_tensor(p, device=dev)
    batch = {"tokens": toks,
             "last_pos": torch.tensor([p.size - 1], device=dev)}
    lk, ck = prefill_fn(params, batch, pa, premat)
    with ops.reference_mode():
        lr, _ = prefill_fn(params, batch, pa, premat)
    d_pre = float((lk - lr).abs().max())
    cache = mdl.init_paged_cache(cfg, MAX_SLOTS, pages * PAGE_SIZE, dev)
    table = PageTable(PAGE_SIZE, MAX_LEN,
                      list(range(1, p.size // PAGE_SIZE + 2)))
    rows = torch.as_tensor(table.row_idx()[:p.size], device=dev).long()
    for n in cache:
        for kv in ("k", "v"):
            cache[n][kv][:, rows] = ck[n][kv][:, 0, :p.size]
    ri = torch.zeros((MAX_SLOTS, MAX_LEN), dtype=torch.int32, device=dev)
    ri[0] = torch.as_tensor(table.row_idx(), device=dev)
    pos = torch.tensor([p.size, 0, 0, 0], dtype=torch.int32, device=dev)
    tk = torch.zeros((MAX_SLOTS, 1), dtype=torch.int32, device=dev)
    tk[0, 0] = int(lk[0, -1].argmax())
    cache_r = {n: {kv: t.clone() for kv, t in c.items()}
               for n, c in cache.items()}
    cache_2 = {n: {kv: t.clone() for kv, t in c.items()}
               for n, c in cache.items()}
    dk, _ = step_fn(params, cache, tk, pos, ri, pa, premat)
    dk2, _ = step_fn(params, cache_2, tk, pos, ri, pa, premat)
    with ops.reference_mode():
        dr, _ = step_fn(params, cache_r, tk, pos, ri, pa, premat)
    d_dec = float((dk - dr).abs().max())
    scale = max(float(lr.abs().max()), float(dr.abs().max()))
    print(f"  max |dlogit| kernels vs plain versions, bf16, 12 layers: "
          f"prefill {d_pre:.4e}, decode tick {d_dec:.4e} (max |logit| "
          f"{scale:.3f}; not bounded, see below)")

    # the kernels' results do not change from run to run
    lk2, _ = prefill_fn(params, batch, pa, premat)
    if not torch.equal(lk, lk2):
        raise CheckFailed("two identical prefills gave different logits")
    print("  two identical prefills through the kernels: bitwise equal")
    if not torch.equal(dk, dk2):
        raise CheckFailed("two identical decode ticks gave different logits")
    print("  two identical decode ticks through the kernels: bitwise equal")
    prof = _profile_tick(torch, rs, prompts, card)
    prof_prefill = _profile_prefill(torch, prefill_fn, params, pa, premat,
                                    prompts[-1], rs._bucket(prompts[-1].size),
                                    dev, card)
    rs.close()
    eng.close()
    del premat, ck, cache, cache_r, cache_2

    # Random-init gpt-moe-s is chaotic: a 1e-7 difference (another sum
    # order) grows with depth until near-tied top-2 routes flip, which
    # happens by layer 12 even in f32.  So full width is held to the plain
    # path at a cut depth, in f32, where no route flips: two layers.  The
    # other cuts are printed to show the growth.
    d32 = {}
    for n in [n for n in (1, 2, 4, 12) if n <= cfg.num_layers]:
        cfg_n, params_n = _cut_depth(cfg, params, n)
        pa_n = _plan(torch, cfg_n, dev)
        with Engine(cfg_n, mdl.Runtime(), params_n, max_len=MAX_LEN,
                    pa=pa_n) as eng_n:
            p_n, pa_n, premat_n = eng_n._snapshot()
            run_n = build_prefill_step(cfg_n, mdl.Runtime())
            lk_n, _ = run_n(p_n, batch, pa_n, premat_n)
            with ops.reference_mode():
                lr_n, _ = run_n(p_n, batch, pa_n, premat_n)
        d32[n] = float((lk_n - lr_n).abs().max())
        s32 = float(lr_n.abs().max())
        print(f"  full width cut to {n} layer(s), f32: max |dlogit| kernels "
              f"vs plain versions over a {p.size}-token prefill "
              f"{d32[n]:.4e} (max |logit| {s32:.3f})")
        if n == 2 and not d32[n] <= 1e-3 * s32:
            raise CheckFailed("full-width f32 logits at 2 layers disagree "
                              "with the plain path (tolerance 1e-3 x max "
                              "|logit|)")
        del premat_n, eng_n
    return dict(decode_ticks=ticks, prefill_ms=prefill_ms,
                median_decode_tick_ms=statistics.median(tick_ms),
                decode_tick_ms=tick_ms, slot_cache_build_ms=slot_ms,
                run_wall_s=wall_s, launches=launches,
                max_dlogit_prefill=d_pre, max_dlogit_decode=d_dec,
                max_logit=scale, max_dlogit_prefill_f32_by_depth=d32,
                profiled_tick=prof, profiled_prefill=prof_prefill,
                flash_launches_per_bucket=flash_per_bucket)


def _profile_tick(torch, rs, prompts, card):
    """One decode tick of four fresh sequences under torch.profiler: kernel
    launches, device-busy time and the host's share of the tick."""
    from torch.profiler import ProfilerActivity, profile
    for p in prompts:
        rs.submit(p, max_new_tokens=8)
    rs.step()                               # admit, prefill, first tick
    for _ in range(2):                      # the first pass sets CUPTI up
        torch.cuda.synchronize()
        t = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            rs.step()
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    ev = prof.key_averages()
    launches = sum(e.count for e in ev if e.key in (
        "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    dev_ev = [e for e in ev
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev_ev) / 1e3
    paged = _device_ms(dev_ev, "paged_decode")
    b1 = _device_ms(dev_ev, *B1_SERVE_KERNELS)
    rs.run(max_ticks=10)
    print(f"  [{card}] one decode tick under the profiler: {launches} "
          f"kernel launches, device busy {busy:.3f} ms of {wall:.3f} ms "
          f"wall (device idle share {1 - busy / wall:.3f}), "
          f"paged_decode_attention {paged:.3f} ms and grouped_mlp_fwd "
          f"{b1:.3f} ms of it")
    return dict(launches=launches, device_busy_ms=busy, wall_ms=wall,
                paged_ms=paged, grouped_mlp_ms=b1)



def _profile_prefill(torch, prefill_fn, params, pa, premat, prompt, bucket,
                     dev, card):
    """One prefill of ``prompt`` (padded to ``bucket``) under torch.profiler:
    device-busy time, and the flash-attention kernel's share of it."""
    from torch.profiler import ProfilerActivity, profile
    toks = torch.zeros((1, bucket), dtype=torch.int32, device=dev)
    toks[0, :prompt.size] = torch.as_tensor(prompt, device=dev)
    batch = {"tokens": toks,
             "last_pos": torch.tensor([prompt.size - 1], device=dev)}
    for _ in range(2):                      # the first pass sets CUPTI up
        torch.cuda.synchronize()
        t = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            prefill_fn(params, batch, pa, premat)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    dev_ev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev_ev) / 1e3
    flash = _device_ms(dev_ev, "flash_fwd")
    b1 = _device_ms(dev_ev, *B1_SERVE_KERNELS)
    print(f"  [{card}] one prefill of the {prompt.size}-token prompt (bucket "
          f"{bucket}) under the profiler: device busy {busy:.3f} ms of "
          f"{wall:.3f} ms wall, flash_attention_fwd {flash:.3f} ms and "
          f"grouped_mlp_fwd {b1:.3f} ms of it")
    return dict(bucket=bucket, device_busy_ms=busy, wall_ms=wall,
                flash_ms=flash, grouped_mlp_ms=b1)


def serve_small_f32(torch, ops, dev):
    """The smoke config in f32: the kernel path and the plain path serve the
    same prompts to the same tokens, with logits within 1e-3."""
    import repro_torch.configs as configs
    from repro_torch.models import model as mdl
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.scheduler import RequestScheduler

    cfg = configs.get_smoke("gpt-moe-s")
    params = mdl.init_params(cfg, 0, dev)
    pa = _plan(torch, cfg, dev)
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10, 11, 12], [13, 14]]

    def serve():
        logs = []
        with Engine(cfg, mdl.Runtime(), params, max_len=64, pa=pa) as eng:
            with RequestScheduler(eng, max_slots=2, num_pages=12,
                                  page_size=PAGE_SIZE, max_kv=64) as rs:
                step = rs._step_fn

                def logged(*a, **kw):
                    out = step(*a, **kw)
                    logs.append(out[0])
                    return out
                rs._step_fn = logged
                reqs = [rs.submit(p, max_new_tokens=10) for p in prompts]
                rs.run(max_ticks=200)
                return [r.output().tolist() for r in reqs], logs

    out_k, lk = serve()
    with ops.reference_mode():
        out_r, lr = serve()
    d = max(float((a - b).abs().max()) for a, b in zip(lk, lr))
    print(f"  smoke config f32: kernel and plain traces "
          f"{'equal' if out_k == out_r else 'DIFFER'}, max |dlogit| over "
          f"{len(lk)} decode ticks {d:.3e} (tolerance 1e-3)")
    if out_k != out_r or not d <= 1e-3:
        raise CheckFailed("small f32 serving disagrees with the plain path")


# ---------------------------------------------------------------------------
# phase 5: training
# ---------------------------------------------------------------------------
def _train_setup(torch, dev, cfg):
    from repro_torch.common.config import TrainConfig
    from repro_torch.core.moe import MoERuntime
    from repro_torch.data.pipeline import make_stream
    from repro_torch.models import model as mdl
    # attention runs its plain version (the flash kernel has no backward,
    # and the JAX package trains with XLA attention); the experts run the
    # grouped-MLP kernels
    rt = mdl.Runtime(use_pallas=False, moe=MoERuntime(use_pallas=True))
    tc = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                     total_steps=TRAIN_STEPS)
    stream = make_stream(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                         kind="bytes", seed=0)
    return rt, tc, stream


def train_full_width(torch, ops, dev, card):
    import repro_torch.configs as configs
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_lib
    from repro_torch.train.trainer import HecateScheduler, train_loop

    cfg = configs.get("gpt-moe-s")
    rt, tc, stream = _train_setup(torch, dev, cfg)
    pa = _plan(torch, cfg, dev)
    print(f"  gpt-moe-s: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.moe.num_experts} experts top-{cfg.moe.experts_per_token}, "
          f"vocab {cfg.vocab_size}, {cfg.dtype} compute, f32 master weights "
          f"and AdamW moments from seed 0, remat={cfg.remat}; batch "
          f"{TRAIN_BATCH} x seq {TRAIN_SEQ} of the bytes stream, lr "
          f"{TRAIN_LR} (warm-up {TRAIN_WARMUP})")

    # two identical steps from the seeded state on one batch: the
    # parameters must agree bit for bit (no atomics on the path)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in stream.next_batch().items()}
    step_fn = step_lib.build_train_step(cfg, rt, tc)
    first = None
    for _ in range(2):
        state = step_lib.init_state(cfg, 0, device=dev)
        state, m = step_fn(state, batch, pa)
        leaves = adamw.leaves(state.params)
        if first is None:
            first = ([t.detach().clone() for t in leaves], float(m["loss"]))
        else:
            same = all(torch.equal(a, b) for a, b in zip(first[0], leaves))
            print(f"  two identical steps: loss {first[1]:.6f} / "
                  f"{float(m['loss']):.6f}, parameters "
                  f"{'bitwise equal' if same else 'DIFFER'}")
            if not same:
                raise CheckFailed("two identical train steps gave different "
                                  "parameters")
        del state, m, leaves
    del first, batch
    torch.cuda.empty_cache()

    # the main path: the Hecate loop from the seeded state
    state = step_lib.init_state(cfg, 0, device=dev)
    sched = HecateScheduler(cfg, ep=1, impl="ep", device=str(dev))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()               # the main path's run starts
    t = time.perf_counter()
    state, hist = train_loop(cfg, rt, tc, stream, scheduler=sched,
                             state=state, num_steps=TRAIN_STEPS, log_every=0,
                             device=dev)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    launches = ops.launch_counts()          # ... and ends
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [h["loss"] for h in hist]
    step_ms = [h["time_s"] * 1e3 for h in hist]
    med = statistics.median(step_ms)
    print(f"  losses: {[round(x, 4) for x in losses]}")
    print(f"  [{card}] step ms: {[round(x, 1) for x in step_ms]}; median "
          f"{med:.1f} ms, {TRAIN_BATCH * TRAIN_SEQ / med * 1e3:.0f} tokens/s; "
          f"run wall {wall_s:.2f} s; device memory peak {peak_gb:.2f} GB")
    print(f"  launches over {TRAIN_STEPS} steps: {launches}")
    if not all(map(math.isfinite, losses)):
        raise CheckFailed(f"training loss not finite: {losses}")
    if any(h["step_ok"] != 1.0 for h in hist):
        raise CheckFailed("the step guard skipped a step")
    n_moe = cfg.num_layers * TRAIN_STEPS
    want = {"grouped_mlp_dgrad": n_moe, "grouped_mlp_wgrad": n_moe,
            # remat re-runs each superblock's forward in the backward
            "grouped_mlp_fwd_train": (2 if cfg.remat else 1) * n_moe,
            "grouped_mlp_fwd": 0, "flash_attention_fwd": 0,
            "paged_decode_attention": 0}
    if launches != want:
        raise CheckFailed(f"training launches {launches}, expected {want}")
    prof = _profile_train_step(torch, cfg, rt, tc, stream, state, pa, dev,
                               card)
    del state
    torch.cuda.empty_cache()
    return dict(losses=losses, step_ms=step_ms, median_step_ms=med,
                tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / med * 1e3,
                run_wall_s=wall_s, peak_memory_gb=peak_gb,
                launches=launches, profiled_step=prof,
                dropped_frac=[h.get("dropped_frac") for h in hist],
                pad_frac=[h.get("pad_frac") for h in hist])


def train_cut_depth_learns(torch, ops, dev):
    """The training loop at full width cut to ``TRAIN_LEARN_LAYERS``, bf16,
    from the seeded state, with the main run's data and optimizer: the
    loss must be finite and fall over the 12 steps, through the kernels."""
    import repro_torch.configs as configs
    from repro_torch.train import step as step_lib
    from repro_torch.train.trainer import HecateScheduler, train_loop
    cfg = configs.get("gpt-moe-s").replace(num_layers=TRAIN_LEARN_LAYERS)
    rt, tc, stream = _train_setup(torch, dev, cfg)
    state = step_lib.init_state(cfg, 0, device=dev)
    sched = HecateScheduler(cfg, ep=1, impl="ep", device=str(dev))
    ops.reset_launch_counts()
    state, hist = train_loop(cfg, rt, tc, stream, scheduler=sched,
                             state=state, num_steps=TRAIN_STEPS, log_every=0,
                             device=dev)
    launched = ops.launch_counts()
    losses = [h["loss"] for h in hist]
    print(f"  full width cut to {cfg.num_layers} layers, {TRAIN_STEPS} "
          f"steps: losses {[round(x, 4) for x in losses]}; launches "
          f"{launched}")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise CheckFailed(f"{cfg.num_layers}-layer training loss not finite "
                          f"and falling: {losses}")
    if launched["grouped_mlp_dgrad"] != cfg.num_layers * TRAIN_STEPS:
        raise CheckFailed(f"the {cfg.num_layers}-layer run launched "
                          f"{launched}")
    del state
    torch.cuda.empty_cache()
    return dict(layers=cfg.num_layers, losses=losses, launches=launched)


def _profile_train_step(torch, cfg, rt, tc, stream, state, pa, dev,
                        card):
    """One more train step under torch.profiler: device-busy time, kernel
    launches and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train import step as step_lib
    step_fn = step_lib.build_train_step(cfg, rt, tc)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in stream.next_batch().items()}
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step_fn(state, batch, pa)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    ev = prof.key_averages()
    dev_ev = [e for e in ev
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(getattr(e, "self_device_time_total", 0.0)
               for e in dev_ev) / 1e3
    launches = sum(e.count for e in ev if e.key in (
        "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    top = sorted(dev_ev, key=lambda e: -e.self_device_time_total)[:10]
    top = [(e.key[:60], e.count, e.self_device_time_total / 1e3)
           for e in top]
    print(f"  [{card}] one train step under the profiler: {launches} kernel "
          f"launches, device busy {busy:.1f} ms of {wall:.1f} ms wall "
          f"(device idle share {1 - busy / wall:.3f})")
    for name, n, ms in top:
        print(f"    {ms:9.2f} ms  x{n:<5d} {name}")
    return dict(launches=launches, device_busy_ms=busy, wall_ms=wall,
                top_kernels=top)


def train_grads_cut_depth(torch, ops, dev, name="gpt-moe-s", layers=2,
                          batch=TRAIN_BATCH):
    """Full width cut to ``layers`` (2), f32, ``batch`` x ``TRAIN_SEQ`` of
    the bytes stream: one step's loss and the gradient of every parameter
    through the kernels against the plain versions on the same tensors (no
    route flips at this depth)."""
    import repro_torch.configs as configs
    from repro_torch.common.params import _leaves
    from repro_torch.data.pipeline import make_stream
    from repro_torch.models import model as mdl
    from repro_torch.train import step as step_lib
    cfg = configs.get(name).replace(num_layers=layers, dtype="float32")
    rt = _train_setup(torch, dev, cfg)[0]
    stream = make_stream(cfg.vocab_size, TRAIN_SEQ, batch, kind="bytes",
                         seed=0)
    params = mdl.init_params(cfg, 0, dev)
    pa = _plan(torch, cfg, dev)
    data = {k: torch.as_tensor(v, device=dev)
            for k, v in stream.next_batch().items()}
    ops.reset_launch_counts()
    mk, gk = step_lib.loss_and_grads(cfg, rt, params, data, pa)
    launched = ops.launch_counts()
    with ops.reference_mode():
        mr, gr = step_lib.loss_and_grads(cfg, rt, params, data, pa)
    what = f"{name} at full width cut to {layers} layer(s), f32"
    if launched["grouped_mlp_dgrad"] != layers or \
            launched["grouped_mlp_wgrad"] != layers:
        raise CheckFailed(f"{what}: the kernel step launched {launched}")
    if not torch.equal(mk["expert_counts"], mr["expert_counts"]):
        raise CheckFailed(f"{what}: routing differs between the kernels "
                          "and the plain versions")
    dl = abs(float(mk["loss"]) - float(mr["loss"]))
    worst = {}
    for (path, a), (_, b) in zip(_leaves(gk), _leaves(gr)):
        scale = float(b.abs().max())
        worst["/".join(path)] = float((a - b).abs().max()) / max(scale,
                                                                 1e-30)
    param = max(worst, key=worst.get)
    print(f"  {what}, batch {batch} x {TRAIN_SEQ}, one step: loss "
          f"{float(mr['loss']):.6f}, |dloss| kernels vs plain {dl:.3e}; "
          f"max |dgrad| / max |grad| over {len(worst)} parameters "
          f"{worst[param]:.3e} ({param}; tolerance {GRAD_TOL:g})")
    if not dl <= 1e-5 * abs(float(mr["loss"])) or worst[param] > GRAD_TOL:
        raise CheckFailed(f"{what}: gradients disagree with the plain path")
    del params, gk, gr
    torch.cuda.empty_cache()
    return dict(dloss=dl, max_rel_grad_err=worst[param], worst_param=param,
                rel_grad_err=worst)


# ---------------------------------------------------------------------------
# phase 6: dense generate, publication under training, a two-replica fleet
# ---------------------------------------------------------------------------
def _dense_prompts(vocab: int, n: int, length: int):
    """(n, length) int32: consecutive slices of the longest served prompt."""
    import numpy as np
    text = _prompts(vocab)[-1]
    return np.stack([text[i * length:(i + 1) * length] for i in range(n)])


def _only_launched(launches, *names):
    """Whether exactly the named kernels launched."""
    return all((n > 0) == (k in names) for k, n in launches.items())


def dense_generate_full_width(torch, ops, dev, card):
    """``Engine.generate`` of gpt-moe-s at full width and depth, bf16:
    loop prefill of 4 prompts of 32 tokens, then 16 greedy tokens.  Every
    decode step is timed (synchronised on both sides) and its logits must
    be finite; B1's inference form is the only kernel of the run; a second
    identical call gives the same tokens; one decode step is profiled."""
    import repro_torch.configs as configs
    from repro_torch.models import model as mdl
    from repro_torch.serve.engine import Engine

    cfg = configs.get("gpt-moe-s")
    params = mdl.init_params(cfg, 0, dev)
    pa = _plan(torch, cfg, dev)
    prompts = _dense_prompts(cfg.vocab_size, DENSE_BATCH, DENSE_PROMPT)
    eng = Engine(cfg, mdl.Runtime(), params,
                 max_len=DENSE_PROMPT + DENSE_NEW, pa=pa)
    step = eng.step_fn
    times = {"prefill": [], "generate": []}

    def timed(params_, cache, tokens, pos, pa_, premat):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step(params_, cache, tokens, pos, pa_, premat)
        torch.cuda.synchronize()
        times["prefill" if pos < DENSE_PROMPT else "generate"].append(
            (time.perf_counter() - t) * 1e3)
        if not bool(torch.isfinite(out[0]).all()):
            raise CheckFailed("non-finite logits in the dense generate")
        return out
    eng.step_fn = timed
    eng.generate(prompts[:, :4], steps=2)   # warm-up, outside the count
    for v in times.values():
        v.clear()
    ops.reset_launch_counts()               # the main path's run starts
    t = time.perf_counter()
    out = eng.generate(prompts, steps=DENSE_NEW)
    wall_s = time.perf_counter() - t
    launches = ops.launch_counts()          # ... and ends
    n_steps = DENSE_PROMPT + DENSE_NEW
    pre = statistics.median(times["prefill"])
    gen = statistics.median(times["generate"])
    print(f"  gpt-moe-s, {cfg.num_layers} layers, {cfg.dtype}: "
          f"{DENSE_BATCH} prompts of {DENSE_PROMPT} tokens, loop prefill "
          f"then {DENSE_NEW} greedy tokens; launches {launches}")
    print(f"  [{card}] median ms per decode step: loop prefill {pre:.3f} "
          f"({len(times['prefill'])} steps), generation {gen:.3f} "
          f"({len(times['generate'])} steps); run wall {wall_s:.3f} s")
    want = cfg.num_layers * n_steps
    if not _only_launched(launches, "grouped_mlp_fwd") or \
            launches["grouped_mlp_fwd"] != want:
        raise CheckFailed(f"the dense generate launched {launches}; "
                          f"expected grouped_mlp_fwd x {want} only")
    out2 = eng.generate(prompts, steps=DENSE_NEW)
    if not (out == out2).all():
        raise CheckFailed("two identical dense generates gave different "
                          "tokens")
    print("  two identical dense generates: bitwise-equal tokens")
    tokens = torch.as_tensor(prompts[:, :1], device=dev)
    prof = _profile_dense_step(torch, step, eng, tokens, card)
    prof["idle_share_of_median_step"] = 1 - prof["device_busy_ms"] / gen
    print(f"  its device busy time against the median generation step: "
          f"idle share {prof['idle_share_of_median_step']:.3f}")
    eng.close()
    return dict(prefill_step_ms=times["prefill"][:DENSE_PROMPT],
                generate_step_ms=times["generate"][:DENSE_NEW],
                median_prefill_step_ms=pre, median_generate_step_ms=gen,
                run_wall_s=wall_s, launches=launches, profiled_step=prof)


def _profile_call(torch, fn):
    """``fn()`` under torch.profiler, the second of two passes (the first
    sets CUPTI up): ``(device events, its kernel launches, device-busy ms,
    wall ms)``."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    ev = prof.key_averages()
    launches = sum(e.count for e in ev if e.key in (
        "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    dev_ev = [e for e in ev
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev_ev) / 1e3
    return dev_ev, launches, busy, wall


def _profile_dense_step(torch, step, eng, tokens, card):
    """One dense decode step under torch.profiler: launches, device-busy
    time, its idle share and B1's part."""
    from repro_torch.models import model as mdl
    params, pa, premat = eng._snapshot()
    cache = mdl.init_cache(eng.cfg, tokens.shape[0], eng.max_len,
                           tokens.device)
    dev_ev, launches, busy, wall = _profile_call(
        torch, lambda: step(params, cache, tokens, DENSE_PROMPT, pa, premat))
    b1 = _device_ms(dev_ev, *B1_SERVE_KERNELS)
    print(f"  [{card}] one dense decode step under the profiler: {launches} "
          f"kernel launches, device busy {busy:.3f} ms of {wall:.3f} ms "
          f"wall (device idle share {1 - busy / wall:.3f}), grouped_mlp_fwd "
          f"{b1:.3f} ms of it")
    return dict(launches=launches, device_busy_ms=busy, wall_ms=wall,
                grouped_mlp_ms=b1)


def dense_against_paged(torch, ops, dev):
    """Full width cut to 2 layers, f32: ``Engine.generate`` and the
    continuous-batching scheduler serve the same 4 prompts to the same 16
    greedy tokens, and their first-step logits (the loop prefill's last
    step against the one-shot prefill) agree within 1e-3 of the largest
    |logit|."""
    import numpy as np

    import repro_torch.configs as configs
    from repro_torch.common.params import snapshot
    from repro_torch.models import model as mdl
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.scheduler import DONE, RequestScheduler

    full = configs.get("gpt-moe-s")
    cfg, params = _cut_depth(full, mdl.init_params(full, 0, dev), 2)
    params = snapshot(params)               # frees the other 10 layers
    pa = _plan(torch, cfg, dev)
    prompts = _dense_prompts(cfg.vocab_size, DENSE_BATCH, DENSE_PROMPT)
    max_len = DENSE_PROMPT + DENSE_NEW
    first = {"dense": [], "paged": []}
    with Engine(cfg, mdl.Runtime(), params, max_len=max_len, pa=pa) as eng:
        step = eng.step_fn

        def rec_step(params_, cache, tokens, pos, pa_, premat):
            out = step(params_, cache, tokens, pos, pa_, premat)
            if pos == DENSE_PROMPT - 1:
                first["dense"].append(out[0][:, -1].clone())
            return out
        eng.step_fn = rec_step
        ops.reset_launch_counts()
        dense = eng.generate(prompts, steps=DENSE_NEW)
        l_dense = ops.launch_counts()
        with RequestScheduler(eng, max_slots=DENSE_BATCH,
                              num_pages=-(-max_len // PAGE_SIZE)
                              * DENSE_BATCH + 1,
                              page_size=PAGE_SIZE, max_kv=max_len,
                              default_ttl_s=3600.0) as rs:
            prefill = rs._prefill_fn

            def rec_prefill(params_, batch, pa_, premat=None):
                out = prefill(params_, batch, pa_, premat)
                first["paged"].append(out[0][:, -1].clone())
                return out
            rs._prefill_fn = rec_prefill
            ops.reset_launch_counts()
            reqs = [rs.submit(p, max_new_tokens=DENSE_NEW) for p in prompts]
            rs.run(max_ticks=10 * DENSE_NEW)
            l_paged = ops.launch_counts()
        if any(r.state != DONE for r in reqs):
            raise CheckFailed("a scheduled request did not finish")
        paged = np.stack([r.output() for r in reqs])
    ld, lp = first["dense"][0], torch.cat(first["paged"])
    d = float((ld - lp).abs().max())
    scale = float(lp.abs().max())
    same = bool((dense == paged).all())
    print(f"  full width cut to 2 layers, f32: Engine.generate and the "
          f"scheduler's tokens {'equal' if same else 'DIFFER'} over "
          f"{DENSE_NEW} greedy steps; first-step max |dlogit| {d:.3e} (max "
          f"|logit| {scale:.3f}, tolerance 1e-3 of it); launches dense "
          f"{l_dense}, paged {l_paged}")
    if not _only_launched(l_dense, "grouped_mlp_fwd") or not \
            _only_launched(l_paged, *SERVE_KERNELS):
        raise CheckFailed("the dense or the paged run launched another "
                          "kernel set than its path's")
    if not same or not d <= 1e-3 * scale:
        raise CheckFailed("the dense and the paged paths disagree")
    return dict(tokens_equal=same, first_step_max_dlogit=d, max_logit=scale,
                launches_dense=l_dense, launches_paged=l_paged)


def publish_under_training(torch, ops, dev, card):
    """``train_loop(publish_engine=eng, publish_every=2)`` of gpt-moe-s at
    full width and depth, batch 4 x 2,048, 4 steps, with one
    ``eng.generate(..., steps=2)`` after each step, so promotions happen
    at decode boundaries while training runs.  After ``flush`` the engine
    is at the last published step and serves what a fresh engine on a copy
    of the final params serves; one more training step, unpublished,
    leaves its tokens as they were (the published tree is a snapshot)."""
    import threading

    import numpy as np

    import repro_torch.configs as configs
    from repro_torch.common.config import TrainConfig
    from repro_torch.common.params import snapshot
    from repro_torch.data.pipeline import make_stream
    from repro_torch.models import model as mdl
    from repro_torch.serve.engine import Engine
    from repro_torch.train import step as step_lib
    from repro_torch.train.trainer import HecateScheduler, train_loop

    cfg = configs.get("gpt-moe-s")
    rt, _, _ = _train_setup(torch, dev, cfg)
    tc = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                     total_steps=PUBLISH_STEPS + 1)
    stream = make_stream(cfg.vocab_size, TRAIN_SEQ, PUBLISH_BATCH,
                         kind="bytes", seed=0)
    pa = _plan(torch, cfg, dev)
    prompts = _dense_prompts(cfg.vocab_size, DENSE_BATCH, PUBLISH_PROMPT)
    max_len = PUBLISH_PROMPT + 8
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = step_lib.init_state(cfg, 0, device=dev)
    sched = HecateScheduler(cfg, ep=1, impl="ep", device=str(dev))
    eng = Engine(cfg, mdl.Runtime(), snapshot(state.params), max_len=max_len,
                 pa=pa)
    eng.generate(prompts, steps=1)          # the live slots, warm
    pub_ms, promote_ms, builds, served = [], [], [], []
    publish, build, promote = (eng.publish_params, eng._build_slots,
                               eng._promote)

    def timed_publish(params, version=None, **kw):
        t = time.perf_counter()
        v = publish(params, version=version, **kw)
        pub_ms.append((time.perf_counter() - t) * 1e3)
        return v

    def timed_build(pa_, buf):
        if not threading.current_thread().name.startswith("engine-build"):
            return build(pa_, buf)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()                          # on the builder's stream
        out = build(pa_, buf)
        b.record()
        builds.append((a, b))
        return out

    def timed_promote(st):
        t = time.perf_counter()
        promote(st)
        promote_ms.append((time.perf_counter() - t) * 1e3)
    eng.publish_params, eng._build_slots, eng._promote = (
        timed_publish, timed_build, timed_promote)

    def after_step(i, s, m):
        served.append(eng.generate(prompts, steps=PUBLISH_NEW))
    ops.reset_launch_counts()               # the main path's run starts
    t = time.perf_counter()
    state, hist = train_loop(cfg, rt, tc, stream, scheduler=sched,
                             state=state, num_steps=PUBLISH_STEPS,
                             log_every=0, device=dev, callback=after_step,
                             publish_engine=eng,
                             publish_every=PUBLISH_EVERY)
    promoted_in_run = eng.promotions
    eng.flush()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    launches = ops.launch_counts()          # ... and ends
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    build_ms = [a.elapsed_time(b) for a, b in builds]
    # the same build with nothing else on the card: the final params once
    # more (the builds above overlap the training steps on the card)
    publish(snapshot(state.params), version=PUBLISH_STEPS, wait=True)
    torch.cuda.synchronize()
    idle_build_ms = builds[-1][0].elapsed_time(builds[-1][1])
    eng.flush()
    losses = [h["loss"] for h in hist]
    print(f"  full width, {cfg.num_layers} layers: batch {PUBLISH_BATCH} x "
          f"seq {TRAIN_SEQ}, {PUBLISH_STEPS} steps publishing every "
          f"{PUBLISH_EVERY}, eng.generate(steps={PUBLISH_NEW}) of "
          f"{DENSE_BATCH} x {PUBLISH_PROMPT} tokens after each step; losses "
          f"{[round(x, 4) for x in losses]}; launches {launches}")
    print(f"  [{card}] publish_params host ms {[round(x, 3) for x in pub_ms]}"
          f"; staged build device ms {[round(x, 3) for x in build_ms]} "
          f"(overlapping training), {idle_build_ms:.3f} (card otherwise "
          f"idle); "
          f"promotion host ms {[round(x, 3) for x in promote_ms]}; "
          f"promotions during training {promoted_in_run}, deferred "
          f"boundaries {eng.deferred_boundaries}; run wall {wall_s:.2f} s; "
          f"device memory peak {peak_gb:.2f} GB")
    last = PUBLISH_STEPS - PUBLISH_STEPS % PUBLISH_EVERY
    if (eng.version, eng.publications, eng.publish_drops) != (
            last, PUBLISH_STEPS // PUBLISH_EVERY + 1, 0) \
            or hist[-1]["publish_drops"] or not all(map(math.isfinite,
                                                        losses)):
        raise CheckFailed(f"publication under training: version "
                          f"{eng.version}, {eng.publications} publications, "
                          f"{eng.publish_drops} drops, losses {losses}")
    if not _only_launched(launches, "grouped_mlp_fwd", *TRAIN_KERNELS):
        raise CheckFailed(f"publication under training launched {launches}")
    out = eng.generate(prompts, steps=4)
    with Engine(cfg, mdl.Runtime(), snapshot(state.params), max_len=max_len,
                pa=pa, version=eng.version) as fresh:
        same_fresh = bool((out == fresh.generate(prompts, steps=4)).all())
    live = state.params["moe_buffer"]
    before = live[:64].clone()
    state, _ = train_loop(cfg, rt, tc, stream, scheduler=sched, state=state,
                          num_steps=1, log_every=0, device=dev)
    moved = not torch.equal(live[:64], before)
    same_after = bool((out == eng.generate(prompts, steps=4)).all())
    print(f"  after flush: version {eng.version}; tokens equal a fresh engine "
          f"on a copy of the final params: {same_fresh}; after one more "
          f"in-place step (params moved: {moved}), unchanged: {same_after}")
    if not (same_fresh and moved and same_after):
        raise CheckFailed("the published engine does not serve the "
                          "published snapshot")
    eng.close()
    # the timed wrappers reach the engine through its bound methods: left
    # on it, they would keep it and its parameters in a reference cycle
    del eng.publish_params, eng._build_slots, eng._promote
    del state, eng
    torch.cuda.empty_cache()
    return dict(losses=losses, publish_params_host_ms=pub_ms,
                staged_build_device_ms=build_ms,
                staged_build_idle_device_ms=idle_build_ms,
                promotion_host_ms=promote_ms, peak_memory_gb=peak_gb,
                promotions_during_training=promoted_in_run,
                launches=launches, run_wall_s=wall_s,
                served_tokens=[np.asarray(x).tolist() for x in served])


def fleet_two_replicas(torch, ops, dev, card):
    """A ``PublicationBus`` with two engines of gpt-moe-s at full width cut
    to 4 layers: one broadcast promotes both, both serve the same tokens
    as a fresh engine on the published params, and ``route()`` returns
    both."""
    import repro_torch.configs as configs
    from repro_torch.models import model as mdl
    from repro_torch.serve.bus import HEALTHY, PublicationBus
    from repro_torch.serve.engine import Engine

    cfg = configs.get("gpt-moe-s").replace(num_layers=FLEET_LAYERS)
    p0, p1 = mdl.init_params(cfg, 0, dev), mdl.init_params(cfg, 1, dev)
    pa = _plan(torch, cfg, dev)
    prompts = _dense_prompts(cfg.vocab_size, DENSE_BATCH, PUBLISH_PROMPT)
    max_len = PUBLISH_PROMPT + 8
    engines = [Engine(cfg, mdl.Runtime(), p0, max_len=max_len, pa=pa,
                      name=f"replica-{i}") for i in range(2)]
    bus = PublicationBus([(e.name, e) for e in engines])
    try:
        for e in engines:
            e.generate(prompts, steps=1)    # live slots before publishing
        ops.reset_launch_counts()
        t = time.perf_counter()
        bus.publish_params(p1, version=1, wait=True)
        torch.cuda.synchronize()
        bcast_ms = (time.perf_counter() - t) * 1e3
        states = {n: (h.state, h.version) for n, h in bus.poll().items()}
        routed = bus.route()
        outs = [e.generate(prompts, steps=PUBLISH_NEW + 6) for e in routed]
        launches = ops.launch_counts()
        with Engine(cfg, mdl.Runtime(), p1, max_len=max_len, pa=pa,
                    version=1) as fresh:
            ref = fresh.generate(prompts, steps=PUBLISH_NEW + 6)
    finally:
        bus.close()
        for e in engines:
            e.close()
    same = len(outs) == 2 and all((o == ref).all() for o in outs)
    print(f"  [{card}] two replicas, full width cut to {FLEET_LAYERS} "
          f"layers: broadcast and promotion {bcast_ms:.3f} ms; states "
          f"{states}; route() returns {len(routed)}; tokens equal across "
          f"the replicas and a fresh engine: {same}; launches {launches}")
    if (len(routed) != 2 or not same
            or any(s != (HEALTHY, 1) for s in states.values())
            or not _only_launched(launches, "grouped_mlp_fwd")):
        raise CheckFailed("the two-replica fleet did not serve the "
                          "broadcast publication")
    return dict(broadcast_ms=bcast_ms, states=states, launches=launches)


# ---------------------------------------------------------------------------
# phase 7: the FSSDP layer across ranks
# ---------------------------------------------------------------------------
def _nccl_world():
    """A real NCCL process group of this one process (world size 1, a
    ``FileStore`` rendezvous in a temporary directory) and its 1 x 1 grid."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_grid
    workdir = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(workdir, "store"), 1), rank=0, world_size=1)
    return make_grid(1, 1)


def _nccl_ms(ev):
    """Device ms of the profiled NCCL kernels."""
    return sum(getattr(e, "self_device_time_total", 0.0) for e in ev
               if "nccl" in e.key.lower()) / 1e3


def check_row_valid_layout(torch, dev, K, M, C, counts, label):
    """B1-train, B2 and B3 over the distributed layer's uncompacted
    (K, M·C, D) layout, where each source's kept tokens fill a prefix of
    its C-row stripe (``counts`` (M, K)), against their plain versions on
    the same inputs, bf16 at D 768, F 1,536, GELU.  Their tile list comes
    from ``tile_list`` as on the main path; ``tile_starts`` walks it on the
    device."""
    from repro_torch.kernels import grouped_mlp as gm
    from repro_torch.kernels import ref
    D, Fd, dt = 768, 1536, torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(7)
    r = torch.arange(M * C, device=dev)
    mask = ((r % C)[None, :] < counts.T[:, r // C]).to(torch.int32)
    valid = mask.bool()

    def rnd(shp, sc):
        return torch.randn(shp, generator=g, device=dev).mul_(sc).to(dt)
    x, wi, wo, dy = (rnd((K, M * C, D), 0.3), rnd((K, D, Fd), 0.05),
                     rnd((K, Fd, D), 0.05), rnd((K, M * C, D), 0.1))
    x = x * valid[..., None].to(dt)
    tiles = gm.tile_list(mask)
    starts = gm.tile_starts(tiles, K, M * C)
    atol, rtol = TOL["bfloat16"]
    worst = {}

    def held(what, a, b, rows=None):
        if rows is not None:
            a, b = a[rows], b[rows]
        err = (a.float() - b.float()).abs()
        worst[what] = float(err.max()) if err.numel() else 0.0
        if not bool(torch.isfinite(a).all()) or bool(
                (err > atol + rtol * b.float().abs()).any()):
            raise CheckFailed(f"{label}: {what} disagrees with its plain "
                              f"version on the row_valid layout")

    y, h1, _ = gm.grouped_mlp_fwd_train(x, wi, None, wo, mask, act="gelu",
                                        tiles=tiles)
    ry, rh1, _ = ref.grouped_mlp_fwd_train_ref(x, wi, None, wo, mask,
                                               act="gelu")
    held("B1-train y", y, ry)
    held("B1-train h1", h1, rh1, valid)
    dx, dh1, _, h = gm.grouped_mlp_dgrad(dy, mask, h1, None, wi, None, wo,
                                         act="gelu", tiles=tiles)
    rdx, rdh1, _, _ = ref.grouped_mlp_dgrad_ref(dy, mask, h1, None, wi,
                                                None, wo, act="gelu")
    held("B2 dx", dx, rdx)
    held("B2 dh1", dh1, rdh1, valid)
    dwi, _, dwo = gm.grouped_mlp_wgrad(x, dy, mask, dh1, None, h,
                                       tiles=tiles)
    rdwi, _, rdwo = ref.grouped_mlp_wgrad_ref(x, dy, mask, dh1, None, h)
    held("B3 dwi", dwi, rdwi)
    held("B3 dwo", dwo, rdwo)
    n_valid = int(valid.sum())
    print(f"  {label}: K={K} slots x (M={M} sources x C={C}) rows, "
          f"{n_valid} valid, {tiles.numel()} of {K * -(-M * C // 64)} "
          f"64-row tiles listed, tile_starts {starts[:4].tolist()}...; "
          f"max|kernel - plain| " + ", ".join(
              f"{k} {v:.3e}" for k, v in worst.items())
          + f" (atol {atol:g}, rtol {rtol:g}) ok")
    return dict(K=K, M=M, C=C, valid_rows=n_valid, tiles=tiles.numel(),
                max_abs_err=worst)


def _held_gb(torch):
    """(GB held just before a measured run, read with no collection first;
    GB the cyclic garbage collector then freed).  A state an earlier check
    dropped must be freed at once, as in JAX: if the collector frees more
    than ``GC_FREED_LIMIT_GB``, something kept a dropped state in a
    reference cycle, and the phase fails."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.synchronize()
    freed = held - torch.cuda.memory_allocated()
    if freed > GC_FREED_LIMIT_GB * 1e9:
        raise CheckFailed(f"the garbage collector freed {freed / 1e9:.2f} GB "
                          f"of device memory: a dropped state sat in a "
                          f"reference cycle")
    return held / 1e9, freed / 1e9


def fssdp_world_one(torch, ops, dev, card, slice2_median_ms):
    """Phase 7(a): full-width, full-depth gpt-moe-s, bf16, batch 8 x 2,048,
    through the distributed layer at world size 1 over a real NCCL group:
    the ring plan of Algorithm 1 at ep = 1 (its extra slots have no
    expert to fetch), ``auto_capacity`` from the config's capacity factor,
    so tokens may drop."""
    import torch.distributed as dist

    import repro_torch.configs as configs
    from repro_torch.core import moe
    from repro_torch.core.moe import MoERuntime
    from repro_torch.models import model as mdl
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_lib
    from repro_torch.train.trainer import HecateScheduler, train_loop

    grid = _nccl_world()
    try:
        cfg = configs.get("gpt-moe-s")
        _, tc, stream = _train_setup(torch, dev, cfg)
        rt = mdl.Runtime(use_pallas=False, moe=MoERuntime(
            use_pallas=True, grid=grid, impl="ring"))
        sched = HecateScheduler(cfg, ep=1, impl="ring", device=str(dev))
        plan = sched.plan()
        K = plan.k_total
        cap = moe.auto_capacity(cfg, TRAIN_BATCH * TRAIN_SEQ, 1, K)
        print(f"  {dist.get_backend()} world of {dist.get_world_size()}; "
              f"ring plan of Algorithm 1 at ep=1: m={plan.m}, K={K} slots, "
              f"auto_capacity {cap} rows per cell (capacity factor "
              f"{cfg.moe.capacity_factor})")
        # two identical steps from the seeded state on one batch
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in stream.next_batch().items()}
        step_fn = step_lib.build_train_step(cfg, rt, tc)
        pa = sched.plan_arrays()
        first = None
        for _ in range(2):
            state = step_lib.init_state(cfg, 0, 1, dev, grid)
            state, m = step_fn(state, batch, pa)
            leaves = adamw.leaves(state.params)
            if first is None:
                first = ([t.detach().clone() for t in leaves],
                         float(m["loss"]))
            elif not all(torch.equal(a, b)
                         for a, b in zip(first[0], leaves)):
                raise CheckFailed("two identical FSSDP steps gave different "
                                  "parameters")
            del state, m, leaves
        print(f"  two identical steps: loss {first[1]:.6f}, parameters "
              f"bitwise equal")
        del first, batch
        torch.cuda.empty_cache()

        # the main path: the Hecate loop over the grid
        state = step_lib.init_state(cfg, 0, 1, dev, grid)
        sched = HecateScheduler(cfg, ep=1, impl="ring", device=str(dev))
        held_gb, freed_gb = _held_gb(torch)
        torch.cuda.reset_peak_memory_stats()
        moe.reset_collective_counts()
        ops.reset_launch_counts()            # the main path's run starts
        state, hist = train_loop(cfg, rt, tc, stream, scheduler=sched,
                                 state=state, num_steps=FSSDP_STEPS,
                                 log_every=0, device=dev)
        torch.cuda.synchronize()
        launches = ops.launch_counts()       # ... and ends
        coll = moe.collective_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        losses = [h["loss"] for h in hist]
        step_ms = [h["time_s"] * 1e3 for h in hist]
        med = statistics.median(step_ms)
        dropped = [h["dropped_frac"] for h in hist]
        pad = [h["pad_frac"] for h in hist]
        print(f"  losses: {[round(x, 4) for x in losses]}; dropped_frac "
              f"{[round(x, 6) for x in dropped]}; pad_frac "
              f"{[round(x, 4) for x in pad]}")
        print(f"  [{card}] step ms: {[round(x, 1) for x in step_ms]}; median "
              f"{med:.1f} ms (slice 2's world-size-1 path in this run: "
              f"{slice2_median_ms:.1f} ms); device memory peak "
              f"{peak_gb:.2f} GB, {held_gb:.2f} GB of it held before the "
              f"loop, read before any collection (the garbage collector "
              f"then freed {freed_gb:.2f} GB)")
        print(f"  launches over {FSSDP_STEPS} steps: {launches}")
        print(f"  collectives over {FSSDP_STEPS} steps: "
              + ", ".join(f"{k} {v['calls']}x" for k, v in
                          sorted(coll.items())))
        if not all(map(math.isfinite, losses)):
            raise CheckFailed(f"FSSDP training loss not finite: {losses}")
        n_moe = cfg.num_layers * FSSDP_STEPS
        fwd_runs = 2 if cfg.remat else 1    # remat re-runs the forward
        want = {"grouped_mlp_dgrad": n_moe, "grouped_mlp_wgrad": n_moe,
                "grouped_mlp_fwd_train": fwd_runs * n_moe,
                "grouped_mlp_fwd": 0, "flash_attention_fwd": 0,
                "paged_decode_attention": 0}
        if launches != want:
            raise CheckFailed(f"FSSDP launches {launches}, expected {want}")
        # the default save mode keeps each layer's slots for the backward:
        # one gather and one SparseReduceScatter per layer and step
        if coll["spag_ring"]["calls"] != n_moe * plan.m or \
                coll["sprs_ring"]["calls"] != n_moe * plan.m:
            raise CheckFailed(f"ring hops {coll}")

        # one step under the profiler
        from torch.profiler import ProfilerActivity, profile
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in stream.next_batch().items()}
        pa = sched.plan_arrays()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step_fn(state, batch, pa)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        ev = prof.key_averages()
        dev_ev = [e for e in ev
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(getattr(e, "self_device_time_total", 0.0)
                   for e in dev_ev) / 1e3
        nccl = _nccl_ms(dev_ev)
        top = sorted(dev_ev, key=lambda e: -e.self_device_time_total)[:8]
        print(f"  [{card}] one FSSDP step under the profiler: device busy "
              f"{busy:.1f} ms of {wall:.1f} ms wall (idle share "
              f"{1 - busy / wall:.3f}), NCCL kernels {nccl:.2f} ms")
        for e in top:
            print(f"    {e.self_device_time_total / 1e3:9.2f} ms  "
                  f"x{e.count:<5d} {e.key[:60]}")
        del state, batch
        torch.cuda.empty_cache()
        # the three training kernels on the row_valid layout: the main
        # path's shape (one source, a C-row prefix per slot, the 64
        # experts' slots filled to their mean load, the extra slots
        # empty) and an 8-rank grid's (8 sources of 2,048 tokens each,
        # k_local 8 + m 4 slots, random kept counts per source)
        per_slot = torch.zeros((1, K), dtype=torch.int64, device=dev)
        per_slot[0, :cfg.moe.num_experts] = min(
            cap, 2 * TRAIN_BATCH * TRAIN_SEQ // cfg.moe.num_experts)
        layouts = [check_row_valid_layout(torch, dev, K, 1, cap, per_slot,
                                          "main path's layout")]
        g = torch.Generator(device=dev).manual_seed(8)
        c8 = moe.auto_capacity(cfg, TRAIN_BATCH * TRAIN_SEQ // 8, 8, 12)
        cnt8 = torch.randint(0, c8 + 1, (8, 12), generator=g, device=dev)
        layouts.append(check_row_valid_layout(torch, dev, 12, 8, c8, cnt8,
                                              "8-source layout"))
        return dict(losses=losses, step_ms=step_ms, median_step_ms=med,
                    slice2_median_step_ms=slice2_median_ms,
                    peak_memory_gb=peak_gb, held_before_gb=held_gb,
                    freed_by_gc_gb=freed_gb,
                    dropped_frac=dropped,
                    pad_frac=pad, launches=launches, collectives=coll,
                    capacity=cap, K=K, m=plan.m,
                    profiled_step=dict(device_busy_ms=busy, wall_ms=wall,
                                       nccl_ms=nccl),
                    row_valid_layouts=layouts)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# phase 8: overlap and re-materialization on the process grid
# ---------------------------------------------------------------------------
class _PermuteRows:
    """A resharding policy that permutes the chunk buffer's rows once, at
    step ``at``: at EP size 1 no expert changes owner, but the rows of the
    parameters and of both AdamW moments move (``apply_reshard``)."""

    def __init__(self, at: int):
        self.at = at

    def maybe_reshard(self, step, current, predictor):
        import dataclasses

        import numpy as np
        if step != self.at:
            return current, False
        perm = np.random.default_rng(0).permutation(
            current.rows_per_device).astype(np.int32)
        return dataclasses.replace(current,
                                   owner_row=perm[current.owner_row]), True


def _union(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap_ms(torch, prof):
    """(NCCL kernel ms, ms in which an NCCL kernel and a compute kernel ran
    at once, {NCCL kernel: [count, ms]}) of a profiled window, from the
    kernels' device intervals."""
    nccl, comp, names = [], [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name.lower()
        if "memcpy" in name or "memset" in name:
            continue
        iv = (e.time_range.start, e.time_range.end)
        if "nccl" in name:
            nccl.append(iv)
            c = names.setdefault(e.name[:48], [0, 0.0])
            c[0] += 1
            c[1] += (iv[1] - iv[0]) / 1e3
        else:
            comp.append(iv)
    a, b = _union(nccl), _union(comp)
    both, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        both += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return sum(y - x for x, y in a) / 1e3, both / 1e3, names


def overlap_world_one(torch, ops, dev, card):
    """Phase 8: full-width, full-depth gpt-moe-s, bf16, batch 8 x 2,048,
    through the FSSDP layer at world size 1 over NCCL (ring plan at ep =
    1) in each remat mode, the hoisted two-microbatch step, one profiled
    save step, and a forced row-permuting reshard; the scheduler plans
    ahead and calibrates throughout."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist

    import repro_torch.configs as configs
    from repro_torch.core import moe
    from repro_torch.core.moe import MoERuntime
    from repro_torch.data.pipeline import make_stream
    from repro_torch.models import model as mdl
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_lib
    from repro_torch.train.trainer import (HecateScheduler, apply_reshard,
                                           train_loop)

    grid = _nccl_world()
    try:
        base = configs.get("gpt-moe-s")
        _, tc, stream = _train_setup(torch, dev, base)
        rt = mdl.Runtime(use_pallas=False, moe=MoERuntime(
            use_pallas=True, grid=grid, impl="ring"))
        L = moe.num_moe_layers(base)
        scheds = []

        def sched(**kw):
            scheds.append(HecateScheduler(base, ep=1, impl="ring",
                                          device=str(dev), **kw))
            return scheds[-1]

        def with_mode(mode):
            return base.replace(moe=dataclasses.replace(
                base.moe, rematerialize=mode))

        def batch_of(st):
            return {k: torch.as_tensor(v, device=dev)
                    for k, v in st.next_batch().items()}

        def counted(fn):
            """Run ``fn`` with the launch counts, the collective record
            and the event log reset just before and read just after."""
            held["gb"], held["freed"] = _held_gb(torch)
            torch.cuda.reset_peak_memory_stats()
            moe.reset_collective_counts()
            moe.enable_event_log()
            ops.reset_launch_counts()
            try:
                out = fn()
                torch.cuda.synchronize()
                return out, ops.launch_counts(), moe.collective_counts(), \
                    moe.event_log(), torch.cuda.max_memory_allocated() / 1e9
            finally:
                moe.enable_event_log(False)

        def hops(coll):
            return sum(coll.get(k, {"calls": 0})["calls"]
                       for k in ("spag_ring", "sprs_ring"))

        held = {}
        res = {"modes": {}}
        m = None
        for mode in ("save", "gather", "block"):
            cfg = with_mode(mode)
            step_fn = step_lib.build_train_step(cfg, rt, tc)
            s = sched()
            pa = s.plan_arrays()
            m = int(pa.extra_experts.shape[-1])
            batch = batch_of(stream)
            # two identical steps from the seeded state
            first = None
            for rep in range(2):
                state = step_lib.init_state(cfg, 0, 1, dev, grid)
                state, met = step_fn(state, batch, pa)
                leaves = adamw.leaves(state.params)
                if rep == 0:
                    first = [t.detach().clone() for t in leaves]
                    del state, met, leaves
                    torch.cuda.empty_cache()
                elif not all(torch.equal(a, b)
                             for a, b in zip(first, leaves)):
                    raise CheckFailed(f"{mode}: two identical steps gave "
                                      f"different parameters")
            del first, leaves, met, batch
            torch.cuda.empty_cache()
            # one loop step on the counted scheduler warms the allocator
            # after the cache was emptied; it is not counted
            state, _ = train_loop(cfg, rt, tc, stream, scheduler=s,
                                  state=state, num_steps=1, log_every=0,
                                  device=dev)
            (state, hist), launches, coll, ev, peak = counted(
                lambda: train_loop(cfg, rt, tc, stream, scheduler=s,
                                   state=state, num_steps=OVERLAP_STEPS,
                                   log_every=0, device=dev))
            step_ms = [h["time_s"] * 1e3 for h in hist]
            per_step = hops(coll) / OVERLAP_STEPS
            fwd_gathers = sum(e[0] == "spag" and e[2] == "fwd"
                              for e in ev) / OVERLAP_STEPS
            n = L * OVERLAP_STEPS
            want = {"grouped_mlp_fwd_train": 2 * n, "grouped_mlp_dgrad": n,
                    "grouped_mlp_wgrad": n, "grouped_mlp_fwd": 0,
                    "flash_attention_fwd": 0, "paged_decode_attention": 0}
            losses = [h["loss"] for h in hist]
            res["modes"][mode] = dict(
                losses=losses, step_ms=step_ms,
                median_step_ms=statistics.median(step_ms),
                peak_memory_gb=peak, held_before_gb=held["gb"],
                freed_by_gc_gb=held["freed"],
                ring_hops_per_step=per_step,
                forward_gathers_per_step=fwd_gathers, launches=launches)
            print(f"  {mode}: losses {[round(x, 4) for x in losses]}; ring "
                  f"hops per step {per_step:g} (law {REMAT_LAW[mode]}·m·L = "
                  f"{REMAT_LAW[mode] * m * L}); forward gathers per step "
                  f"{fwd_gathers:g}")
            print(f"  [{card}] {mode}: step ms "
                  f"{[round(x, 1) for x in step_ms]}, median "
                  f"{statistics.median(step_ms):.1f} ms; device memory peak "
                  f"{peak:.2f} GB ({held['gb']:.2f} GB held before the "
                  f"loop before any collection, {held['freed']:.2f} GB "
                  f"then freed by the garbage collector); launches "
                  f"{launches}")
            if not all(map(math.isfinite, losses)):
                raise CheckFailed(f"{mode}: loss not finite: {losses}")
            if per_step != REMAT_LAW[mode] * m * L or fwd_gathers != L:
                raise CheckFailed(f"{mode}: {per_step} ring hops and "
                                  f"{fwd_gathers} forward gathers per step")
            if launches != want:
                raise CheckFailed(f"{mode}: launches {launches}, expected "
                                  f"{want}")
            if mode == "save":
                # one step under the profiler: the NCCL kernels and their
                # overlap with compute (at world size 1 NCCL copies only)
                from torch.profiler import ProfilerActivity, profile
                batch, pa = batch_of(stream), s.plan_arrays()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    step_fn(state, batch, pa)
                    torch.cuda.synchronize()
                nccl_ms, both_ms, names = _overlap_ms(torch, prof)
                res["profiled_save_step"] = dict(nccl_ms=nccl_ms,
                                                 overlapped_nccl_ms=both_ms,
                                                 nccl_kernels=names)
                print(f"  [{card}] one profiled save step: NCCL kernels "
                      f"{nccl_ms:.3f} ms, of which {both_ms:.3f} ms ran "
                      f"beside a compute kernel; " + ", ".join(
                          f"{k} x{c} {t:.3f} ms" for k, (c, t) in
                          sorted(names.items(), key=lambda kv: -kv[1][1])))
                del batch, prof
            del state
            torch.cuda.empty_cache()

        # the hoisted step: two microbatches, every layer's slots built
        # once at the head of the step
        cfg = with_mode("save")
        tc2 = dataclasses.replace(tc, microbatch=2)
        s = sched()
        state = step_lib.init_state(cfg, 0, 1, dev, grid)
        state, _ = train_loop(cfg, rt, tc2, stream, scheduler=s, state=state,
                              num_steps=1, log_every=0, device=dev)
        (state, hist), launches, coll, ev, peak = counted(
            lambda: train_loop(cfg, rt, tc2, stream, scheduler=s,
                               state=state, num_steps=1, log_every=0,
                               device=dev))
        fwd_gathers = sum(e[0] == "spag" and e[2] == "fwd" for e in ev)
        res["hoisted"] = dict(loss=hist[0]["loss"],
                              step_ms=hist[0]["time_s"] * 1e3,
                              peak_memory_gb=peak, ring_hops=hops(coll),
                              forward_gathers=fwd_gathers, launches=launches)
        print(f"  [{card}] hoisted save step, 2 microbatches of "
              f"{TRAIN_BATCH // 2} x {TRAIN_SEQ:,}: "
              f"loss {hist[0]['loss']:.4f}, {hist[0]['time_s'] * 1e3:.1f} "
              f"ms, {fwd_gathers} forward gathers, {hops(coll)} ring hops, "
              f"device memory peak {peak:.2f} GB")
        if fwd_gathers != L or hops(coll) != 2 * m * L:
            raise CheckFailed(f"hoisted step: {fwd_gathers} gathers, "
                              f"{hops(coll)} ring hops")
        del state
        torch.cuda.empty_cache()

        # a forced row-permuting reshard before the second step
        losses = {}
        for tag, policy in (("plain", None), ("permuted", _PermuteRows(1))):
            s = sched(resharding=policy)
            state = step_lib.init_state(cfg, 0, 1, dev, grid)
            state, hist = train_loop(
                cfg, rt, tc, make_stream(cfg.vocab_size, TRAIN_SEQ,
                                         TRAIN_BATCH, kind="bytes", seed=1),
                scheduler=s, state=state, num_steps=2, log_every=0,
                device=dev)
            losses[tag] = [h["loss"] for h in hist]
            if tag == "permuted":
                # apply_reshard on the card moves the rows of the
                # parameters and both moments (a column slice checked)
                ts = (state.params["moe_buffer"], state.opt.mu["moe_buffer"],
                      state.opt.nu["moe_buffer"])
                before = [t[:, :4096].clone() for t in ts]
                perm = np.random.default_rng(1).permutation(
                    ts[0].shape[0]).astype(np.int32)
                apply_reshard(state, perm, grid)
                idx = torch.as_tensor(perm, device=dev).long()
                if not all(torch.equal(t[:, :4096], b[idx])
                           for t, b in zip(ts, before)) or not bool(
                               (before[1] != 0).any()):
                    raise CheckFailed("apply_reshard moved the wrong rows")
                del before, ts
            del state
            torch.cuda.empty_cache()
        res["reshard"] = losses
        print(f"  forced row-permuting reshard before step 2: losses "
              f"{losses['permuted']} against unpermuted {losses['plain']}; "
              f"apply_reshard moved the parameters and both moments")
        if losses["permuted"][0] != losses["plain"][0] or abs(
                losses["permuted"][1] - losses["plain"][1]) \
                > 1e-5 * abs(losses["plain"][1]):
            raise CheckFailed(f"reshard changed the loss: {losses}")

        hits = sum(x.plan_ahead_hits for x in scheds)
        calib = sum(x.calibration_events for x in scheds)
        fallbacks = sum(x.plan_fallbacks for x in scheds)
        res["scheduler"] = dict(plan_ahead_hits=hits,
                                calibration_events=calib,
                                plan_fallbacks=fallbacks)
        print(f"  scheduler over phase 8: plan_ahead_hits {hits}, "
              f"calibration_events {calib}, plan_fallbacks {fallbacks}")
        if fallbacks or not hits:
            raise CheckFailed(f"plan-ahead: {hits} hits, {fallbacks} "
                              f"fallbacks")
        return res
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# phase 10: the other MoE configurations at full width
# ---------------------------------------------------------------------------
def _prefill_tick(torch, cfg, dev, prefill_fn, step_fn, snap, prompt,
                  bucket):
    """One prefill of ``prompt`` (padded to ``bucket``) and one decode tick
    of its greedy next token in slot 0 of a fresh paged cache, through the
    scheduler's step functions: (prefill logits, tick logits)."""
    from repro_torch.models import model as mdl
    from repro_torch.serve.kv_pool import PageTable
    params, pa, premat = snap
    n = prompt.size
    toks = torch.zeros((1, bucket), dtype=torch.int32, device=dev)
    toks[0, :n] = torch.as_tensor(prompt, device=dev)
    batch = {"tokens": toks, "last_pos": torch.tensor([n - 1], device=dev)}
    lk, ck = prefill_fn(params, batch, pa, premat)
    cache, ri = _paged_cache_of(torch, cfg, dev, ck, n)
    pos = torch.tensor([n, 0, 0, 0], dtype=torch.int32, device=dev)
    tk = torch.zeros((MAX_SLOTS, 1), dtype=torch.int32, device=dev)
    tk[0, 0] = int(lk[0, -1].argmax())
    dk, _ = step_fn(params, cache, tk, pos, ri, pa, premat)
    return lk, dk[:1]


def _paged_cache_of(torch, cfg, dev, ck, n):
    """A fresh paged cache with a prefill's cache ``ck`` of ``n`` tokens in
    slot 0, as the scheduler writes it (K/V rows into its pages, a mamba
    layer's state into the slot's dense state); (cache, row_idx)."""
    from repro_torch.models import model as mdl
    from repro_torch.serve.kv_pool import PageTable
    pages = -(-MAX_LEN // PAGE_SIZE) * MAX_SLOTS + 1
    cache = mdl.init_paged_cache(cfg, MAX_SLOTS, pages * PAGE_SIZE, dev)
    table = PageTable(PAGE_SIZE, MAX_LEN, list(range(1, n // PAGE_SIZE + 2)))
    rows = torch.as_tensor(table.row_idx()[:n], device=dev).long()
    for j, kind in enumerate(cfg.layer_pattern):
        dst, src = cache[f"l{j}"], ck[f"l{j}"]
        for k in dst:
            if kind == "mamba":
                dst[k][:, 0] = src[k][:, 0]
            else:
                dst[k][:, rows] = src[k][:, 0, :n]
    ri = torch.zeros((MAX_SLOTS, MAX_LEN), dtype=torch.int32, device=dev)
    ri[0] = torch.as_tensor(table.row_idx(), device=dev)
    return cache, ri


def _serve_kernels(cfg):
    """The kernels a config's serving path launches, as the reference
    routes: B1 for MoE layers, B5 for attention layers' decode, B4 for
    their prefill where there is no logit softcap."""
    attn_layers = any(k != "mamba" for k in cfg.layer_pattern)
    return tuple(k for k, on in (
        ("grouped_mlp_fwd", cfg.moe.enabled),
        ("flash_attention_fwd", attn_layers
         and cfg.attn_logit_softcap == 0.0),
        ("paged_decode_attention", attn_layers)) if on)


def _f32_cut(cfg):
    """Full width cut to its shortest whole model in f32, where no route
    flips (C7): one superblock of the layer pattern; for a hybrid, the
    pattern's prefix through its first attention layer (Jamba: 4 mamba
    layers, 2 of them MoE, and the attention layer: its superblock of 8
    would not fit in f32 beside its expert slots)."""
    pat = cfg.layer_pattern
    if "mamba" in pat and "attn" in pat:
        pat = pat[:pat.index("attn") + 1]
    return cfg.replace(num_layers=len(pat), layer_pattern=pat,
                       dtype="float32")


def serve_config(torch, ops, dev, card, name, layers=None):
    """Phases 10 and 11, serving: ``name`` at full width and depth, or cut
    to ``layers`` (bf16 compute, f32 master weights from seed 0) through
    the continuous-batching scheduler, phase 4's prompts with
    ``SLICE10_NEW`` greedy tokens each: exactly the kernels of
    ``_serve_kernels`` launched; two identical prefills and ticks bitwise
    equal; then full width cut in f32 (``_f32_cut``), one prefill and one
    tick through the kernels against the plain versions."""
    import repro_torch.configs as configs
    from repro_torch.models import model as mdl
    from repro_torch.serve.engine import (Engine, build_paged_serve_step,
                                          build_prefill_step)
    from repro_torch.serve.scheduler import DONE, RequestScheduler

    cfg = configs.get(name)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    held_gb, freed_gb = _held_gb(torch)
    torch.cuda.reset_peak_memory_stats()
    params = mdl.init_params(cfg, 0, dev)
    pa = _plan(torch, cfg, dev) if cfg.moe.enabled else None
    eng = Engine(cfg, mdl.Runtime(), params, max_len=MAX_LEN, pa=pa)
    t = time.perf_counter()
    eng._snapshot()
    torch.cuda.synchronize()
    slot_ms = (time.perf_counter() - t) * 1e3
    pages = -(-MAX_LEN // PAGE_SIZE) * MAX_SLOTS + 1
    rs = RequestScheduler(eng, max_slots=MAX_SLOTS, num_pages=pages,
                          page_size=PAGE_SIZE, max_kv=MAX_LEN,
                          default_ttl_s=3600.0)
    prefill_ms, tick_ms, per_bucket = [], [], {}
    prefill_fn, step_fn = rs._prefill_fn, rs._step_fn
    rs._prefill_fn = _timed(torch, prefill_fn, prefill_ms, per_bucket)
    rs._step_fn = _timed(torch, step_fn, tick_ms)
    prompts = _prompts(cfg.vocab_size)
    warm = rs.submit(prompts[0], max_new_tokens=2)
    rs.run(max_ticks=10)
    if warm.state != DONE:
        raise CheckFailed(f"{name}: warm-up request ended {warm.state}")
    prefill_ms.clear()
    tick_ms.clear()
    per_bucket.clear()
    reqs = [rs.submit(p, max_new_tokens=SLICE10_NEW) for p in prompts]
    ops.reset_launch_counts()               # the main path's run starts
    rs.run(max_ticks=10 * SLICE10_NEW)
    torch.cuda.synchronize()
    launches = ops.launch_counts()          # ... and ends
    # the timing wrappers reach the engine: dropped with it (C15)
    rs._prefill_fn, rs._step_fn = prefill_fn, step_fn
    if [r.state for r in reqs] != [DONE] * len(reqs) or any(
            len(r.generated) != SLICE10_NEW for r in reqs):
        raise CheckFailed(f"{name}: requests did not finish with "
                          f"{SLICE10_NEW} tokens each")
    want = set(_serve_kernels(cfg))
    if {k for k, n in launches.items() if n} != want:
        raise CheckFailed(f"{name}: launched {launches}, expected exactly "
                          f"{sorted(want)}")
    snap = eng._snapshot()
    p = prompts[1]
    bucket = rs._bucket(p.size)
    a = _prefill_tick(torch, cfg, dev, prefill_fn, step_fn, snap, p, bucket)
    b = _prefill_tick(torch, cfg, dev, prefill_fn, step_fn, snap, p, bucket)
    if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
        raise CheckFailed(f"{name}: two identical prefills or decode ticks "
                          f"gave different logits")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rs.close()
    eng.close()
    del eng, rs, snap, a, b, params
    med = statistics.median(tick_ms)
    print(f"  {name} serving: {cfg.num_layers} of "
          f"{configs.get(name).num_layers} layers, {len(reqs)} requests "
          f"DONE ({SLICE10_NEW} tokens each), logits finite; launches "
          f"{launches}; flash_attention_fwd per bucket "
          f"{dict(sorted(per_bucket.items()))}; two identical prefills "
          f"and ticks bitwise equal")
    print(f"  [{card}] {name} serving: prefill ms "
          f"{[round(x, 3) for x in prefill_ms]}; median decode-tick ms "
          f"{med:.3f}; slot-cache build ms {slot_ms:.1f}; device memory "
          f"peak {peak_gb:.2f} GB ({held_gb:.3f} GB held before, "
          f"{freed_gb:.3f} GB then freed by the garbage collector)")

    # full width cut in f32: no route flips (C7)
    cfg1 = _f32_cut(cfg)
    p1 = mdl.init_params(cfg1, 0, dev)
    pa1 = _plan(torch, cfg1, dev) if cfg1.moe.enabled else None
    run_p = build_prefill_step(cfg1, mdl.Runtime())
    run_s = build_paged_serve_step(cfg1, mdl.Runtime(), PAGE_SIZE)
    with Engine(cfg1, mdl.Runtime(), p1, max_len=MAX_LEN, pa=pa1) as e1:
        snap1 = e1._snapshot()
        k1 = _prefill_tick(torch, cfg1, dev, run_p, run_s, snap1, p,
                           bucket)
        with ops.reference_mode():
            r1 = _prefill_tick(torch, cfg1, dev, run_p, run_s, snap1, p,
                               bucket)
        extra = {}
        if "mamba" in cfg.layer_pattern:
            extra["decode_after_prefill_max_dlogit"] = \
                _decode_after_prefill(torch, cfg1, dev, run_p, run_s, snap1,
                                      p, name)
        if cfg.mrope:
            extra["embeds_prefill_max_dlogit"] = _embeds_prefill(
                torch, ops, cfg1, dev, snap1, p.size, name)
    del snap1, p1
    d1 = [float((x - y).abs().max()) for x, y in zip(k1, r1)]
    s1 = max(float(y.abs().max()) for y in r1)
    print(f"  {name} cut to {cfg1.num_layers} layers, f32: max |dlogit| "
          f"kernels vs plain versions: prefill {d1[0]:.3e}, decode tick "
          f"{d1[1]:.3e} (max |logit| {s1:.3f}; tolerance 1e-3 x max "
          f"|logit|)")
    if max(d1) > 1e-3 * s1:
        raise CheckFailed(f"{name}: f32 logits at the cut disagree with the "
                          f"plain path")
    torch.cuda.empty_cache()
    return dict(layers=cfg.num_layers, launches=launches,
                f32_cut_layers=cfg1.num_layers, **extra,
                flash_launches_per_bucket=per_bucket, prefill_ms=prefill_ms,
                decode_tick_ms=tick_ms, median_decode_tick_ms=med,
                slot_cache_build_ms=slot_ms, peak_memory_gb=peak_gb,
                held_before_gb=held_gb, freed_by_gc_gb=freed_gb,
                max_dlogit_1_layer_f32=d1, max_logit_1_layer_f32=s1)


def _decode_after_prefill(torch, cfg, dev, run_p, run_s, snap, prompt,
                          name):
    """A model with mamba layers, at its f32 cut: the prompt but its last 4
    tokens prefilled at exact length and handed to a paged cache (the SSM
    state into slot 0's dense state), then those 4 tokens decoded one by
    one: each step's logits against the full forward's at that position
    (1e-3 of its largest logit).  Returns the largest difference."""
    from repro_torch.models import model as mdl
    params, pa, premat = snap
    n = prompt.size
    k0 = n - 4
    toks = torch.as_tensor(prompt, device=dev).to(torch.int32)[None]
    with torch.inference_mode():
        full, _ = mdl.forward(cfg, mdl.Runtime(), params, toks, pa=pa,
                              premat=premat)
    _, ck = run_p(params, {"tokens": toks[:, :k0]}, pa, premat)
    cache, ri = _paged_cache_of(torch, cfg, dev, ck, k0)
    errs = []
    for i in range(k0, n):
        tk = torch.zeros((MAX_SLOTS, 1), dtype=torch.int32, device=dev)
        tk[0, 0] = toks[0, i]
        pos = torch.tensor([i, 0, 0, 0], dtype=torch.int32, device=dev)
        lg, cache = run_s(params, cache, tk, pos, ri, pa, premat)
        errs.append(float((lg[0, 0] - full[0, i]).abs().max()))
    scale = float(full.abs().max())
    print(f"  {name} cut to {cfg.num_layers} layers, f32: {n - k0} decode "
          f"steps after a prefill of {k0} tokens against the full forward: "
          f"max |dlogit| {max(errs):.3e} (max |logit| {scale:.3f}; "
          f"tolerance 1e-3 x max |logit|)")
    if max(errs) > 1e-3 * scale:
        _diagnose_decode_after_prefill(torch, cfg, dev, run_p, run_s, snap,
                                       toks, k0, errs, scale, name)
        raise CheckFailed(f"{name}: decode after prefill disagrees with "
                          f"the full forward")
    return max(errs)


@contextlib.contextmanager
def _recorded(module, attr, log, keep):
    """``module.attr`` wrapped for the block: each call appends
    ``keep(args, result)`` to ``log``."""
    fn = getattr(module, attr)

    def wrapper(*a, **kw):
        out = fn(*a, **kw)
        log.append(keep(a, out))
        return out
    setattr(module, attr, wrapper)
    try:
        yield
    finally:
        setattr(module, attr, fn)


def _diagnose_decode_after_prefill(torch, cfg, dev, run_p, run_s, snap,
                                   toks, k0, errs, scale, name):
    """C18's diagnosis, printed when the check fails: each decode step's
    |dlogit|; at the worst step, the first norm whose input (the residual
    stream entering a sublayer) parts from the full forward's at that
    position by more than 1e-3 of its largest entry; and each MoE layer's
    top-2 routes of that token and its dropped count in both runs."""
    from repro_torch.core import moe as moe_core
    from repro_torch.models import layers as ly
    from repro_torch.models import model as mdl
    params, pa, premat = snap
    n = toks.shape[1]
    worst = k0 + max(range(len(errs)), key=errs.__getitem__)
    print(f"  C18 diagnosis, {name}: |dlogit| per decode step "
          + ", ".join(f"pos {k0 + j}: {e:.3e}" for j, e in enumerate(errs))
          + f" (tolerance {1e-3 * scale:.3e}); the worst is pos {worst}")
    where = {}
    for j in range(len(cfg.layer_pattern)):
        for ln in ("ln1", "lnx", "ln2"):
            sc = params["blocks"][f"l{j}"].get(ln, {}).get("scale")
            for sb in range(cfg.num_superblocks) if sc is not None else ():
                where[sc[sb].data_ptr()] = f"superblock {sb} l{j} {ln}"
    where[params["final_norm"]["scale"].data_ptr()] = "final_norm"

    def runs(row, tok):
        norms, gates, drops = [], [], []
        keep_norm = (lambda a, out: (where.get(a[0]["scale"].data_ptr(),
                                               "?"),
                                     a[1][row].detach().float().clone()))
        keep_gate = (lambda a, out: out[0][tok, :2].tolist())
        keep_drop = (lambda a, out: float(out[1].dropped_frac)
                     * a[2].shape[0] * cfg.moe.experts_per_token)
        return norms, gates, drops, (
            _recorded(ly, "apply_norm", norms, keep_norm),
            _recorded(moe_core, "gate", gates, keep_gate),
            _recorded(moe_core, "moe_layer", drops, keep_drop))
    f_norm, f_gate, f_drop, rec = runs((0, worst), worst)
    with torch.inference_mode(), rec[0], rec[1], rec[2]:
        mdl.forward(cfg, mdl.Runtime(), params, toks, pa=pa, premat=premat)
    _, ck = run_p(params, {"tokens": toks[:, :k0]}, pa, premat)
    cache, ri = _paged_cache_of(torch, cfg, dev, ck, k0)
    d_norm, d_gate, d_drop, rec = runs((0, 0), 0)
    for i in range(k0, worst + 1):
        tk = torch.zeros((MAX_SLOTS, 1), dtype=torch.int32, device=dev)
        tk[0, 0] = toks[0, i]
        pos = torch.tensor([i, 0, 0, 0], dtype=torch.int32, device=dev)
        if i < worst:
            _, cache = run_s(params, cache, tk, pos, ri, pa, premat)
            continue
        with rec[0], rec[1], rec[2]:
            run_s(params, cache, tk, pos, ri, pa, premat)
    first = None
    for (lab, a), (_, b) in zip(f_norm, d_norm):
        d = float((a - b).abs().max())
        if d > 1e-3 * float(a.abs().max()) and first is None:
            first = (lab, d, float(a.abs().max()))
    print(f"  C18 diagnosis, {name}: the first norm input that parts from "
          f"the full forward's at pos {worst}: "
          + ("none" if first is None else
             f"{first[0]} (|d| {first[1]:.3e} of max {first[2]:.3e})")
          + f"; {len(f_norm)} norms in the forward, {len(d_norm)} in the "
          f"decode")
    for li, (ga, gb, da, db) in enumerate(zip(f_gate, d_gate, f_drop,
                                              d_drop)):
        print(f"  C18 diagnosis, {name}: MoE layer {li}: top-2 routes of "
              f"pos {worst} forward {ga} decode {gb}; dropped entries "
              f"forward {da:.0f} decode {db:.0f}")


def _embeds_prefill(torch, ops, cfg, dev, snap, S, name):
    """Qwen2-VL at its f32 cut: one forward of S stand-in frontend
    embeddings at distinct temporal, height and width position streams
    through the kernels (one flash-attention launch a layer) against the
    plain versions (1e-3 of the largest logit).  Returns the largest
    difference."""
    from repro_torch.models import model as mdl
    params = snap[0]
    g = torch.Generator(device=dev).manual_seed(11)
    emb = torch.randn((1, S, cfg.d_model), generator=g, device=dev)
    hw = torch.randint(0, 16, (2, S), generator=g, device=dev)
    pos = torch.stack([torch.arange(S, device=dev), hw[0], hw[1]], -1)[None]
    with torch.inference_mode():
        n0 = ops.launch_counts()["flash_attention_fwd"]
        got, _ = mdl.forward(cfg, mdl.Runtime(), params, embeds=emb,
                             positions=pos)
        flash = ops.launch_counts()["flash_attention_fwd"] - n0
        with ops.reference_mode():
            want, _ = mdl.forward(cfg, mdl.Runtime(), params, embeds=emb,
                                  positions=pos)
    d = float((got - want).abs().max())
    scale = float(want.abs().max())
    print(f"  {name} cut to {cfg.num_layers} layers, f32: forward of {S} "
          f"stand-in embeddings at distinct t/h/w position streams: "
          f"flash_attention_fwd launched {flash} times; max |dlogit| "
          f"kernels vs plain versions {d:.3e} (max |logit| {scale:.3f}; "
          f"tolerance 1e-3 x max |logit|)")
    if flash != cfg.num_layers or not d <= 1e-3 * scale:
        raise CheckFailed(f"{name}: embeds prefill through the kernels "
                          f"disagrees with the plain path")
    return d


def train_config(torch, ops, dev, card, name, path, layers, batch, seq,
                 grid):
    """Phase 10, training: ``name`` at full width cut to ``layers`` (bf16,
    f32 master weights and moments from seed 0), batch x seq of the bytes
    stream, through the grid path at world size 1 in the config's remat
    mode (``path`` "grid") or ``train_loop``'s world-size-1 path ("loop"):
    two identical steps bitwise equal, then ``SLICE10_STEPS`` steps of the
    Hecate loop with the launch counts reset just before."""
    import repro_torch.configs as configs
    from repro_torch.core import moe
    from repro_torch.core.moe import MoERuntime
    from repro_torch.data.pipeline import EmbedStubStream, make_stream
    from repro_torch.models import model as mdl
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_lib
    from repro_torch.train.trainer import HecateScheduler, train_loop

    cfg = configs.get(name).replace(num_layers=layers)
    moe_on = cfg.moe.enabled
    on_grid = path == "grid"
    impl = "ring" if on_grid else "ep"
    rt = mdl.Runtime(use_pallas=False, moe=MoERuntime(
        use_pallas=True, **(dict(grid=grid, impl="ring") if on_grid
                            else {})))
    tc = _train_setup(torch, dev, cfg)[1]
    stream = make_stream(cfg.vocab_size, seq, batch, kind="bytes", seed=0)
    if cfg.frontend is not None:        # stand-in frontend embeddings
        stream = EmbedStubStream(stream, cfg.d_model)

    def fresh():
        if on_grid:
            return step_lib.init_state(cfg, 0, 1, dev, grid)
        return step_lib.init_state(cfg, 0, device=dev)

    def sched():
        return HecateScheduler(cfg, ep=1, impl=impl, device=str(dev)) \
            if moe_on else None

    held_gb, freed_gb = _held_gb(torch)
    torch.cuda.reset_peak_memory_stats()
    batch0 = {k: torch.as_tensor(v, device=dev)
              for k, v in stream.next_batch().items()}
    step_fn = step_lib.build_train_step(cfg, rt, tc)
    pa = sched().plan_arrays() if moe_on else None
    first = None
    for _ in range(2):
        state = fresh()
        state, m = step_fn(state, batch0, pa)
        leaves = adamw.leaves(state.params)
        # the first step's parameters wait in host memory: a copy on the
        # card would take the room of the training state's deepest cut
        if first is None:
            first = ([t.detach().cpu() for t in leaves], float(m["loss"]))
        elif not all(torch.equal(a, b.cpu())
                     for a, b in zip(first[0], leaves)):
            raise CheckFailed(f"{name}: two identical train steps gave "
                              f"different parameters")
        del state, m, leaves
    del first
    torch.cuda.empty_cache()
    extra = {}
    if not on_grid and name.startswith("bert"):
        # the bidirectional step of the encoder (no mask: plain attention)
        state = fresh()
        ops.reset_launch_counts()
        state, m = step_lib.build_train_step(cfg, rt, tc, causal=False)(
            state, batch0, pa)
        extra = dict(bidirectional_loss=float(m["loss"]),
                     bidirectional_launches=ops.launch_counts())
        print(f"  {name} one build_train_step(causal=False) step: loss "
              f"{extra['bidirectional_loss']:.4f}; launches "
              f"{extra['bidirectional_launches']}")
        if not math.isfinite(extra["bidirectional_loss"]) or \
                extra["bidirectional_launches"]["flash_attention_fwd"]:
            raise CheckFailed(f"{name}: bidirectional step {extra}")
        del state, m
        torch.cuda.empty_cache()
    del batch0

    state = fresh()
    s = sched()
    state, _ = train_loop(cfg, rt, tc, stream, scheduler=s, state=state,
                          num_steps=1, log_every=0, device=dev)
    moe.reset_collective_counts()
    ops.reset_launch_counts()               # the main path's run starts
    state, hist = train_loop(cfg, rt, tc, stream, scheduler=s, state=state,
                             num_steps=SLICE10_STEPS, log_every=0,
                             device=dev)
    torch.cuda.synchronize()
    launches = ops.launch_counts()          # ... and ends
    coll = moe.collective_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del state
    torch.cuda.empty_cache()
    losses = [h["loss"] for h in hist]
    step_ms = [h["time_s"] * 1e3 for h in hist]
    med = statistics.median(step_ms)
    n = moe.num_moe_layers(cfg) * SLICE10_STEPS
    # remat re-runs each superblock's forward in the backward, and so do
    # the grid's gather and block modes
    rerun = cfg.remat or (on_grid and cfg.moe.rematerialize != "save")
    want = {"grouped_mlp_fwd_train": (2 if rerun else 1) * n,
            "grouped_mlp_dgrad": n, "grouped_mlp_wgrad": n,
            "grouped_mlp_fwd": 0, "flash_attention_fwd": 0,
            "paged_decode_attention": 0}
    hops = sum(coll.get(k, {"calls": 0})["calls"]
               for k in ("spag_ring", "sprs_ring")) / SLICE10_STEPS
    law = REMAT_LAW[cfg.moe.rematerialize] * int(
        pa.extra_experts.shape[-1]) * moe.num_moe_layers(cfg) \
        if on_grid else 0
    print(f"  {name} training: {layers} of {configs.get(name).num_layers} "
          f"layers, batch {batch} x seq {seq}, {path} path"
          + (f" in {cfg.moe.rematerialize} mode" if on_grid else "")
          + f"; losses {[round(x, 4) for x in losses]}; launches "
          f"{launches}" + (f"; ring hops per step {hops:g} (law {law})"
                           if on_grid else ""))
    print(f"  [{card}] {name} training: step ms "
          f"{[round(x, 1) for x in step_ms]}, median {med:.1f} ms, "
          f"{batch * seq / med * 1e3:.0f} tokens/s; device memory peak "
          f"{peak_gb:.2f} GB ({held_gb:.3f} GB held before, {freed_gb:.3f} "
          f"GB then freed by the garbage collector)")
    if not all(map(math.isfinite, losses)) or any(
            h["step_ok"] != 1.0 for h in hist):
        raise CheckFailed(f"{name}: training loss not finite: {losses}")
    if launches != want:
        raise CheckFailed(f"{name}: training launches {launches}, "
                          f"expected {want}")
    if hops != law:
        raise CheckFailed(f"{name}: {hops} ring hops per step, law {law}")
    return dict(layers=layers, batch=batch, seq=seq, path=path,
                losses=losses, step_ms=step_ms, median_step_ms=med,
                tokens_per_s=batch * seq / med * 1e3,
                peak_memory_gb=peak_gb, held_before_gb=held_gb,
                freed_by_gc_gb=freed_gb, launches=launches,
                ring_hops_per_step=hops,
                dropped_frac=[h.get("dropped_frac") for h in hist], **extra)


def slice10(torch, ops, dev, card):
    """Phase 10: each configuration of ``SLICE10`` served at full width and
    depth and, where it has a training path, trained at full width at its
    depth cut, one at a time; then gpt-moe-l's f32 gradients at 1 layer."""
    import torch.distributed as dist
    grid = _nccl_world()
    try:
        res = {}
        for name, path, layers, batch, seq in SLICE10:
            t = time.perf_counter()
            res[name] = {"serving": serve_config(torch, ops, dev, card,
                                                 name)}
            if path:
                res[name]["training"] = train_config(
                    torch, ops, dev, card, name, path, layers, batch, seq,
                    grid)
            print(f"  {name}: {time.perf_counter() - t:.1f} s")
        res["grads_gpt_moe_l_1_layer_f32"] = train_grads_cut_depth(
            torch, ops, dev, "gpt-moe-l", 1, 2)
        return res
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# phase 11: the decoder-only families at full width
# ---------------------------------------------------------------------------
def slice11(torch, ops, dev, card):
    """Phase 11: each configuration of ``SLICE11`` served at full width, at
    full depth or at its cut, and, where one superblock trains on one
    card, trained at full width at its depth cut through phase 5's loop,
    one at a time."""
    res = {}
    for name, served, trained, batch, seq in SLICE11:
        t = time.perf_counter()
        res[name] = {"serving": serve_config(torch, ops, dev, card, name,
                                             served)}
        if trained:
            res[name]["training"] = train_config(
                torch, ops, dev, card, name, "loop", trained, batch, seq,
                None)
        else:
            print(f"  {name} training: not on the card (one superblock "
                  f"at batch {batch} x seq {seq} does not fit); held to the "
                  f"JAX package in the CPU tests")
        print(f"  {name}: {time.perf_counter() - t:.1f} s")
    return res


# ---------------------------------------------------------------------------
T_START = time.perf_counter()


# ---------------------------------------------------------------------------
# phase 9: checkpoint, resume, rollback, restored serving
# ---------------------------------------------------------------------------
def _state_crcs(tree) -> dict:
    """{checkpoint key: CRC32 of the leaf's bytes}, one leaf on the host at
    a time, in ``checkpoint.store``'s naming."""
    import zlib

    from repro_torch.checkpoint import store
    out = {}
    for key, leaf in store._walk(tree):
        a = store.to_numpy(leaf)
        out[key] = zlib.crc32(a.reshape(-1).view("u1").data)
    return out


def checkpoint_world_one(torch, ops, dev, card):
    """Phase 9: full-width gpt-moe-s cut to 2 layers, bf16 compute, f32
    master weights from seed 0, batch 8 x 2,048, through phase 7's path
    (NCCL at world size 1, ring plan, ``save`` mode) with one row-permuting
    reshard at step 1, before the first checkpoint: (a) 6 steps without
    checkpoints; (b) 4 steps checkpointing every 2 (keep 2), the state and
    the scheduler dropped with the collector off (the memory must fall
    back to its level before the run), every restored tensor against the
    saved checksums, then auto-resume to step 6; (c) step 4's arrays
    bit-flipped, the resume falls back to step 2 and runs to 6; (d) from
    step 2, ``train.nan_grads`` for ``max_bad_steps`` steps: the
    ``TrainAbortError`` carries step 2's state, bitwise, and the
    rollback's peak stays below what was held plus one state; (e)
    ``launch/serve.py``'s restore path serves the newest intact checkpoint
    at its version, with the tokens of an engine built from the live
    parameters of that step.  Every run is bitwise against (a): the
    kernels sum in fixed order, so any difference is state not
    restored."""
    import dataclasses
    import shutil
    import tempfile

    import torch.distributed as dist

    import repro_torch.configs as configs
    from repro_torch.checkpoint import store
    from repro_torch.common import faults
    from repro_torch.core.moe import MoERuntime
    from repro_torch.data.pipeline import make_stream
    from repro_torch.launch.serve import restore_for_serving
    from repro_torch.models import model as mdl
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.scheduler import DONE, RequestScheduler
    from repro_torch.train import trainer as trainer_mod
    from repro_torch.train.trainer import (HecateScheduler, TrainAbortError,
                                           state_spec, train_loop)

    grid = _nccl_world()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    save_s, real_save = [], trainer_mod.save_train_state

    def timed_save(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        real_save(*a, **kw)
        save_s.append(time.perf_counter() - t)
    trainer_mod.save_train_state = timed_save
    try:
        cfg = configs.get("gpt-moe-s").replace(num_layers=CKPT_LAYERS)
        rt = mdl.Runtime(use_pallas=False, moe=MoERuntime(
            use_pallas=True, grid=grid, impl="ring"))
        spec = state_spec(cfg, 1, grid)
        state_bytes = sum(t.numel() * t.element_size() for _, t in
                          store._walk(trainer_mod._state_tree(spec)))
        free = shutil.disk_usage(tmp).free
        print(f"  gpt-moe-s at full width cut to {CKPT_LAYERS} layers: "
              f"state (f32 parameters and both AdamW moments) "
              f"{state_bytes / 1e9:.3f} GB; {free / 1e9:.1f} GB free "
              f"where the checkpoints go")
        if free < 3 * state_bytes:
            raise CheckFailed(f"{free / 1e9:.1f} GB free: phase 9 needs 3 "
                              f"checkpoints of {state_bytes / 1e9:.2f} GB")
        tc0 = dataclasses.replace(
            _train_setup(torch, dev, cfg)[1], total_steps=CKPT_STEPS,
            max_bad_steps=3, keep_checkpoints=2)

        def stream():
            return make_stream(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                               kind="bytes", seed=0)

        def sched():
            return HecateScheduler(cfg, ep=1, impl="ring", device=str(dev),
                                   resharding=_PermuteRows(at=1))

        def run(tc, n, **kw):
            sc = sched()
            ops.reset_launch_counts()
            state, hist = train_loop(cfg, rt, tc, stream(), scheduler=sc,
                                     num_steps=n, log_every=0, device=dev,
                                     **kw)
            torch.cuda.synchronize()
            return state, hist, sc, ops.launch_counts()

        def want_train(launches, steps, label):
            n = CKPT_LAYERS * steps
            fwd_runs = 2 if cfg.remat else 1    # remat re-runs the forward
            want = {"grouped_mlp_fwd_train": fwd_runs * n,
                    "grouped_mlp_dgrad": n,
                    "grouped_mlp_wgrad": n, "grouped_mlp_fwd": 0,
                    "flash_attention_fwd": 0, "paged_decode_attention": 0}
            if launches != want:
                raise CheckFailed(f"{label}: launches {launches}, expected "
                                  f"{want}")

        def same(label, hist, ref, first):
            got = [h["loss"] for h in hist]
            want = ref[first:first + len(got)]
            if [h["step"] for h in hist] != list(range(first, CKPT_STEPS)) \
                    or got != want:
                raise CheckFailed(f"{label}: losses {got} of steps "
                                  f"{[h['step'] for h in hist]}, the "
                                  f"uninterrupted run's {want}")

        # (a) uninterrupted
        tc_a = dataclasses.replace(tc0, checkpoint_dir="")
        state, hist, sc, launches = run(tc_a, CKPT_STEPS)
        ref = [h["loss"] for h in hist]
        want_train(launches, CKPT_STEPS, "(a)")
        train_launches = launches
        del state, sc
        print(f"  (a) {CKPT_STEPS} steps, reshard at step 1: losses "
              f"{ref}; launches {launches}")

        # (b) 4 steps with checkpoints, drop, auto-resume to 6
        tc_b = dataclasses.replace(tc0, checkpoint_dir=tmp,
                                   checkpoint_every=CKPT_EVERY)
        gc.disable()
        try:
            base = torch.cuda.memory_allocated()
            state, hist_b, sc, launches = run(tc_b, 4)
            held = torch.cuda.memory_allocated()
            del state, sc
            torch.cuda.synchronize()
            after = torch.cuda.memory_allocated()
        finally:
            gc.enable()
        want_train(launches, 4, "(b) first part")
        if after > base + GC_FREED_LIMIT_GB * 1e9:
            raise CheckFailed(f"(b) the dropped state was not freed: "
                              f"{after / 1e9:.3f} GB held after the drop, "
                              f"{base / 1e9:.3f} GB before the run")
        ckpt_bytes = os.path.getsize(os.path.join(
            tmp, "step_00000004", "arrays.npz"))
        print(f"  (b) 4 steps, checkpoints at steps {store.list_steps(tmp)}"
              f" of {ckpt_bytes / 1e9:.3f} GB each; C15 with the collector "
              f"off: {base / 1e9:.3f} GB before the run, {held / 1e9:.3f} "
              f"GB with the state, {after / 1e9:.3f} GB after the drop")
        saved = store.meta(tmp, 4)["checksums"]
        torch.cuda.synchronize()
        t = time.perf_counter()
        restored, at = trainer_mod.resume_train_state(
            cfg, tc_b, sched(), 1, device=dev, grid=grid)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        crcs = _state_crcs(trainer_mod._state_tree(restored))
        del restored
        if at != 4 or crcs != saved:
            bad = sorted(k for k in saved if crcs.get(k) != saved[k])
            raise CheckFailed(f"(b) restore of step {at}: {len(bad)} arrays "
                              f"differ from the saved ones: {bad[:4]}")
        print(f"  [{card}] save: {[round(x, 3) for x in save_s]} s per "
              f"checkpoint, {ckpt_bytes / 1e9 / statistics.median(save_s):.2f}"
              f" GB/s; restore of step 4: {restore_s:.3f} s, "
              f"{ckpt_bytes / 1e9 / restore_s:.2f} GB/s; every restored "
              f"array's CRC32 equals the saved one ({len(saved)} arrays)")
        tc_r = dataclasses.replace(tc_b, checkpoint_every=0)
        state, hist, sc, launches = run(tc_r, CKPT_STEPS)
        same("(b) resumed", hist, ref, 4)
        want_train(launches, 2, "(b) resumed")
        if hist[0]["resumes"] != 1:
            raise CheckFailed(f"(b) resumes {hist[0]['resumes']}")
        del state, sc
        print(f"  (b) auto-resume from step 4: steps 4-5 bitwise equal to "
              f"(a)")

        # (c) a bit flip in step 4's arrays: resume from 2
        faults.bitflip_file(os.path.join(tmp, "step_00000004",
                                         "arrays.npz"))
        state, hist, sc, launches = run(tc_r, CKPT_STEPS)
        same("(c)", hist, ref, 2)
        del state, sc
        print(f"  (c) step 4 bit-flipped: resume skipped it, steps 2-5 from "
              f"step 2 bitwise equal to (a)")

        # (d) rollback after max_bad_steps poisoned steps, from step 2
        saved2 = store.meta(tmp, 2)["checksums"]
        roll = {}

        def before_abort(i, st, m):
            # the third bad step's record: what is held just before the
            # rollback, and the peak from here
            if i == 2 + tc_r.max_bad_steps - 1:
                torch.cuda.synchronize()
                roll["held"] = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
        sc_d = sched()
        with faults.injected("train.nan_grads", mutate=faults.poison_grads,
                             times=None):
            try:
                train_loop(cfg, rt, tc_r, stream(), scheduler=sc_d,
                           num_steps=CKPT_STEPS, log_every=0, device=dev,
                           callback=before_abort)
                raise CheckFailed("(d) no TrainAbortError")
            except TrainAbortError as e:
                abort = e
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        held_after = torch.cuda.memory_allocated()
        rolled = abort.state
        last = abort.history[-1]
        crcs = _state_crcs(trainer_mod._state_tree(rolled))
        if crcs != saved2 or last["rollbacks"] != 1 or int(rolled.step) != 2:
            raise CheckFailed(f"(d) rolled back to step {int(rolled.step)} "
                              f"with rollbacks {last['rollbacks']}; arrays "
                              f"equal to step 2's: {crcs == saved2}")
        print(f"  [{card}] (d) {tc_r.max_bad_steps} poisoned steps from step "
              f"2: TrainAbortError at global step {abort.step} carries step "
              f"2's state bitwise, rollbacks 1; held {roll['held'] / 1e9:.3f}"
              f" GB just before the rollback, {held_after / 1e9:.3f} GB "
              f"after it, rollback peak {peak / 1e9:.3f} GB (limit held + "
              f"one state {(roll['held'] + state_bytes) / 1e9:.3f} GB)")
        if peak >= roll["held"] + state_bytes:
            raise CheckFailed("(d) the rollback held two states at once")

        # (e) restored serving against the live parameters of that step
        live = rolled.params
        live_pa = sc_d.plan_arrays()
        del rolled, abort
        params, pa, version, step = restore_for_serving(cfg, tmp, dev)
        if step != 2 or version != 2 or pa is None:
            raise CheckFailed(f"(e) restored step {step}, version "
                              f"{version}")

        def serve(p, plan, v):
            eng = Engine(cfg, mdl.Runtime(), p, max_len=MAX_LEN, pa=plan,
                         version=v)
            rs = RequestScheduler(eng, max_slots=MAX_SLOTS,
                                  num_pages=-(-MAX_LEN // PAGE_SIZE)
                                  * MAX_SLOTS + 1, page_size=PAGE_SIZE,
                                  max_kv=MAX_LEN, default_ttl_s=3600.0)
            reqs = [rs.submit(q, max_new_tokens=NEW_TOKENS)
                    for q in _prompts(cfg.vocab_size)]
            rs.run(max_ticks=10 * NEW_TOKENS)
            rs.close()
            if any(r.state != DONE for r in reqs):
                raise CheckFailed("(e) a request did not finish")
            eng.close()
            return eng.version, [list(r.generated) for r in reqs]
        ops.reset_launch_counts()
        v_got, toks = serve(params, pa, version)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        _, toks_live = serve(live, live_pa, 2)
        if v_got != 2 or toks != toks_live:
            raise CheckFailed(f"(e) engine at version {v_got}; tokens "
                              f"{toks} against the live engine's "
                              f"{toks_live}")
        if min(launches[k] for k in SERVE_KERNELS) <= 0 or any(
                launches[k] for k in TRAIN_KERNELS):
            raise CheckFailed(f"(e) launches {launches}")
        print(f"  (e) launch/serve.py restore: step {step}, engine at "
              f"version {v_got}; 4 greedy requests of {NEW_TOKENS} tokens "
              f"equal the live engine's; launches {launches}")
        del params, pa, live, live_pa
        return dict(losses=ref, state_gb=state_bytes / 1e9,
                    checkpoint_gb=ckpt_bytes / 1e9, save_s=save_s,
                    restore_s=restore_s,
                    save_gb_per_s=ckpt_bytes / 1e9
                    / statistics.median(save_s),
                    restore_gb_per_s=ckpt_bytes / 1e9 / restore_s,
                    c15=dict(before_gb=base / 1e9, with_state_gb=held / 1e9,
                             after_drop_gb=after / 1e9),
                    rollback=dict(held_gb=roll["held"] / 1e9,
                                  after_gb=held_after / 1e9,
                                  peak_gb=peak / 1e9),
                    # (a)'s training kernels and (e)'s serving kernels
                    launches={k: launches[k] or train_launches[k]
                              for k in launches})
    finally:
        trainer_mod.save_train_state = real_save
        shutil.rmtree(tmp, ignore_errors=True)
        dist.destroy_process_group()



# ---------------------------------------------------------------------------
# phase 12: serving and publication on the process grid
# ---------------------------------------------------------------------------
def serve_grid_world_one(torch, ops, dev, card):
    """Full-width, full-depth gpt-moe-s at world size 1 over a real NCCL
    group: ``train_loop`` through phase 7's grid path (ring plan, K = 68,
    bf16, batch 8 x 2,048) publishing every ``GRID_PUBLISH_EVERY`` steps
    into a ``PublicationBus`` of two grid engines with one host tag, whose
    one stacked build per publication both replicas share; a forced
    row-permuting reshard makes the next publication carry the fresh
    plan.  After each publication the bus is flushed (both replicas
    promote) and phase 4's four prompts are served through the
    continuous-batching scheduler on the first replica."""
    import threading

    import torch.distributed as dist

    import repro_torch.configs as configs
    from repro_torch.core import moe, placement
    from repro_torch.core.moe import MoERuntime
    from repro_torch.models import model as mdl
    from repro_torch.serve.bus import PublicationBus
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.scheduler import DECODING, DONE, RequestScheduler
    from repro_torch.train import step as step_lib
    from repro_torch.train.trainer import HecateScheduler, train_loop
    from repro_torch.common.params import snapshot

    grid = _nccl_world()
    stack = moe.materialize_stack
    builds = []                     # (thread, start event, end event)

    def timed_stack(*a, **kw):
        s = torch.cuda.current_stream()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record(s)
        out = stack(*a, **kw)
        e1.record(s)
        builds.append((threading.current_thread().name, e0, e1))
        return out

    def spag_calls():
        return sum(v["calls"] for k, v in moe.collective_counts().items()
                   if k.startswith("spag"))
    moe.materialize_stack = timed_stack
    bus = rs = None
    engines = []
    try:
        cfg = configs.get("gpt-moe-s")
        _, tc, stream = _train_setup(torch, dev, cfg)
        rt_train = mdl.Runtime(use_pallas=False, moe=MoERuntime(
            use_pallas=True, grid=grid, impl="ring"))
        # serving: a capacity of the longest call's tokens drops nothing
        rt_serve = mdl.Runtime(moe=MoERuntime(grid=grid, impl="ring",
                                              capacity=MAX_LEN))
        sched = HecateScheduler(cfg, ep=1, impl="ring", device=str(dev),
                                resharding=_PermuteRows(at=GRID_RESHARD_AT))
        pa0 = sched.plan_arrays()
        K = pa0.local_rows.shape[-1] + pa0.extra_experts.shape[-1]
        state = step_lib.init_state(cfg, 0, 1, dev, grid)
        live = snapshot(state.params)
        engines = [Engine(cfg, rt_serve, live, max_len=MAX_LEN, pa=pa0,
                          name=f"replica-{i}") for i in range(2)]
        del live
        bus = PublicationBus([(e.name, e, "host-0") for e in engines])
        pages = -(-MAX_LEN // PAGE_SIZE) * MAX_SLOTS + 1
        rs = RequestScheduler(engines[0], max_slots=MAX_SLOTS,
                              num_pages=pages, page_size=PAGE_SIZE,
                              max_kv=MAX_LEN, default_ttl_s=3600.0)
        prompts = _prompts(cfg.vocab_size)
        warm = rs.submit(prompts[0], max_new_tokens=2)   # the live slots
        rs.run(max_ticks=10)
        if warm.state != DONE:
            raise CheckFailed(f"warm-up request ended {warm.state}")
        print(f"  {dist.get_backend()} world of {dist.get_world_size()}; "
              f"two grid engines on one host behind a PublicationBus; ring "
              f"plan K={K}; serving capacity {MAX_LEN} rows a cell")
        tick_ms, tick_spag, pub, promote_ms, rounds = [], [], [], [], []
        step_fn = rs._step_fn

        def tick(*a, **kw):
            n0 = spag_calls()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step_fn(*a, **kw)
            torch.cuda.synchronize()
            tick_ms.append((time.perf_counter() - t) * 1e3)
            tick_spag.append(spag_calls() - n0)
            return out
        rs._step_fn = tick
        publish = bus.publish_params

        def timed_publish(params, version=None, **kw):
            pub.append((time.perf_counter(), version, kw.get("pa")))
            return publish(params, version=version, **kw)
        bus.publish_params = timed_publish

        def serve_round():
            reqs = [rs.submit(p, max_new_tokens=GRID_SERVE_NEW)
                    for p in prompts]
            rs.run(max_ticks=10 * GRID_SERVE_NEW)
            if any(r.state != DONE for r in reqs):
                raise CheckFailed(f"phase 12 requests ended "
                                  f"{[r.state for r in reqs]}")
            return [r.output() for r in reqs]

        def after_step(i, s, m):
            if (i + 1) % GRID_PUBLISH_EVERY:
                return
            bus.flush()                 # both replicas promote
            torch.cuda.synchronize()
            promote_ms.append((time.perf_counter() - pub[-1][0]) * 1e3)
            rounds.append(serve_round())
        held_gb, freed_gb = _held_gb(torch)
        torch.cuda.reset_peak_memory_stats()
        builds.clear()
        ops.reset_launch_counts()               # the main path's run starts
        state, hist = train_loop(cfg, rt_train, tc, stream, scheduler=sched,
                                 state=state, num_steps=GRID_SERVE_STEPS,
                                 log_every=0, device=dev,
                                 callback=after_step, publish_engine=bus,
                                 publish_every=GRID_PUBLISH_EVERY)
        bus.flush()
        torch.cuda.synchronize()
        launches = ops.launch_counts()          # ... and ends
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # the timing wrappers go; an instance attribute holding the bus's
        # own bound method would keep the bus, and the snapshot it last
        # published, in a reference cycle
        rs._step_fn = step_fn
        del bus.publish_params
        losses = [h["loss"] for h in hist]
        step_ms = [h["time_s"] * 1e3 for h in hist]
        build_ms = [a.elapsed_time(b) for _, a, b in builds]
        threads = [name for name, _, _ in builds]
        with_plan = [p is not None for _, _, p in pub]
        plans = [p for _, _, p in pub if p is not None]
        n_pub = len(pub)
        print(f"  {GRID_SERVE_STEPS} steps publishing every "
              f"{GRID_PUBLISH_EVERY} (versions {[v for _, v, _ in pub]}, "
              f"with a plan {with_plan}; reshard at step {GRID_RESHARD_AT}); "
              f"losses {[round(x, 4) for x in losses]}; dedup_hits "
              f"{bus.dedup_hits}; stacked builds {len(builds)} on "
              f"{sorted(set(threads))}; launches {launches}")
        print(f"  [{card}] step ms {[round(x, 1) for x in step_ms]}; host "
              f"build device ms {[round(x, 2) for x in build_ms]}; publish-"
              f"to-promotion ms {[round(x, 1) for x in promote_ms]} (the "
              f"step's readback included); decode tick ms median "
              f"{statistics.median(tick_ms):.3f} over {len(tick_ms)} ticks, "
              f"SparseAllGathers in them {sum(tick_spag)}; device memory "
              f"peak {peak_gb:.2f} GB, {held_gb:.2f} GB held before the loop "
              f"(the garbage collector then freed {freed_gb:.2f} GB)")
        if not all(map(math.isfinite, losses)):
            raise CheckFailed(f"phase 12 loss not finite: {losses}")
        if {k for k, v in launches.items() if v} != set(SERVE_KERNELS) | \
                set(TRAIN_KERNELS):
            raise CheckFailed(f"phase 12 launches {launches}")
        want_pub = GRID_SERVE_STEPS // GRID_PUBLISH_EVERY
        if (n_pub != want_pub or bus.dedup_hits != n_pub
                or len(builds) != n_pub
                or set(threads) != {"publication-bus"}
                or hist[-1]["publish_drops"]):
            raise CheckFailed(f"phase 12: {n_pub} publications, dedup_hits "
                              f"{bus.dedup_hits}, builds {threads}, drops "
                              f"{hist[-1]['publish_drops']}")
        first_after = GRID_RESHARD_AT // GRID_PUBLISH_EVERY
        if with_plan != [k == first_after for k in range(n_pub)]:
            raise CheckFailed(f"phase 12: the publication after the reshard "
                              f"does not carry the plan alone: {with_plan}")
        if sum(tick_spag):
            raise CheckFailed(f"phase 12: {sum(tick_spag)} SparseAllGathers "
                              f"in the decode ticks")
        if any(e.pa is not plans[-1] or e.version != pub[-1][1]
               for e in engines):
            raise CheckFailed("phase 12: a replica is not at the last "
                              "publication's (plan, version)")
        if freed_gb > GC_FREED_LIMIT_GB:
            raise CheckFailed(f"phase 12: the collector freed {freed_gb} GB")
        served = serve_round()

        def serve_profiled(eng):
            """Phase 4's prompts through a scheduler on ``eng``, one
            decode tick of the four under the profiler: (tokens, its
            launches, device-busy ms, wall ms)."""
            with RequestScheduler(eng, max_slots=MAX_SLOTS,
                                  num_pages=pages, page_size=PAGE_SIZE,
                                  max_kv=MAX_LEN,
                                  default_ttl_s=3600.0) as r:
                reqs = [r.submit(p, max_new_tokens=GRID_SERVE_NEW)
                        for p in prompts]
                for _ in range(10):
                    if all(q.state == DECODING for q in reqs):
                        break
                    r.step()
                prof = _profile_call(torch, r.step)[1:]
                r.run(max_ticks=10 * GRID_SERVE_NEW)
                if any(q.state != DONE for q in reqs):
                    raise CheckFailed(f"phase 12 requests ended "
                                      f"{[q.state for q in reqs]}")
                return ([q.output() for q in reqs],) + prof
        with Engine(cfg, rt_serve, state.params, max_len=MAX_LEN,
                    pa=plans[-1], version=engines[0].version) as fresh:
            ref, *grid_prof = serve_profiled(fresh)
        # the same tick without the grid: the world-size-1 engine, on the
        # EP plan of the trainer's sharding
        ep_pa = moe.plan_to_arrays(placement.ep_materialization(
            sched.sharding), str(dev))
        with Engine(cfg, mdl.Runtime(moe=MoERuntime(capacity=MAX_LEN)),
                    state.params, max_len=MAX_LEN, pa=ep_pa,
                    version=engines[0].version) as plain:
            _, *plain_prof = serve_profiled(plain)
        same = all((a == b).all() for a, b in zip(served, ref))
        print(f"  after the last promotion (version {engines[0].version}): "
              f"the replica's tokens equal a fresh engine's at the trainer's "
              f"(params, pa, version): {same}")
        tick_prof = {}
        for name, (n, busy, wall) in (("grid", grid_prof),
                                      ("world_size_1", plain_prof)):
            tick_prof[name] = dict(launches=n, device_busy_ms=busy,
                                   wall_ms=wall, idle_share=1 - busy / wall)
            print(f"  [{card}] one decode tick of the four prompts under the "
                  f"profiler, {name} engine: {n} kernel launches, device "
                  f"busy {busy:.3f} ms of {wall:.3f} ms wall (device idle "
                  f"share {1 - busy / wall:.3f})")
        if not same:
            raise CheckFailed("phase 12: the replica does not serve the "
                              "trainer's (params, pa, version)")
        return dict(losses=losses, step_ms=step_ms,
                    median_step_ms=statistics.median(step_ms),
                    build_device_ms=build_ms,
                    publish_to_promotion_ms=promote_ms,
                    decode_tick_ms=tick_ms,
                    median_decode_tick_ms=statistics.median(tick_ms),
                    profiled_tick=tick_prof,
                    peak_memory_gb=peak_gb, held_before_gb=held_gb,
                    freed_by_gc_gb=freed_gb, dedup_hits=bus.dedup_hits,
                    publications=n_pub, with_plan=with_plan, K=K,
                    launches=launches,
                    served=[[o.tolist() for o in r] for r in rounds])
    finally:
        moe.materialize_stack = stack
        if rs is not None:
            rs.close()
        if bus is not None:
            bus.close()
        for e in engines:
            e.close()
        del rs, bus, engines
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# phase 13: Whisper, the encoder-decoder, at full width and depth
# ---------------------------------------------------------------------------
def check_flash_whisper(torch, ops, dev, flush, cfg):
    """B4 at the shapes of Whisper's decoder self-attention in the one-shot
    prefill: (1, S, 16, 64) causal at each of phase 4's prompt lengths,
    against the plain version in bf16 and f32 and the step-wise version in
    bf16, two calls bitwise equal; each length timed in bf16 (kernel,
    plain version, SDPA, bound and its share).  Returns ({S: timings},
    largest error)."""
    from repro_torch.kernels import ref
    g = torch.Generator(device=dev).manual_seed(130)
    N, H = cfg.num_heads, cfg.head_dim
    errs, lengths = [], {}

    def qkv(S, dt):
        return [torch.randn((1, S, N, H), generator=g, device=dev)
                .mul_(0.5).to(dt) for _ in range(3)]

    for dname, dt in (("bfloat16", torch.bfloat16),
                      ("float32", torch.float32)):
        for S in PROMPT_LENS:
            q, k, v = qkv(S, dt)
            got = ops.flash_attention(q, k, v, causal=True)
            label = f"flash_attention_fwd (1,{S},{N},{H}) causal {dname}"
            errs.append(compare(torch, label, got, ref.flash_attention_ref(
                q, k, v, causal=True), *TOL[dname]))
            if dname != "bfloat16":
                continue
            errs.append(compare(torch, f"{label} vs step-wise", got,
                                ref.flash_attention_tiled_ref(
                                    q, k, v, causal=True), *TILED_TOL))
            if not torch.equal(got, ops.flash_attention(q, k, v,
                                                        causal=True)):
                raise CheckFailed("two identical flash_attention calls "
                                  "gave different bits")
            r = _time_flash(torch, flush, q, k, v)
            lengths[S] = dict(r, bound_share=r["bound_ms"] / r["ms"])
    return lengths, max(errs)


def _whisper_prompts(torch, cfg, dev):
    """Phase 4's prompts cut to the decoder's cap, and a seeded normal
    stand-in for the stub frontend's frames of each, (4, 1500, 1024)."""
    prompts = [p[:cfg.max_decoder_len] for p in _prompts(cfg.vocab_size)]
    g = torch.Generator(device=dev).manual_seed(0)
    frames = torch.randn((len(prompts), cfg.encoder_seq_len, cfg.d_model),
                         generator=g, device=dev)
    return prompts, frames


def _dense_cache_of(torch, cfg, dev, ck, n):
    """A dense cache of ``WHISPER_MAX_LEN`` rows holding a one-row
    prefill's cache ``ck`` of ``n`` tokens, its cross K/V included."""
    from repro_torch.models import model as mdl
    cache = mdl.init_cache(cfg, 1, WHISPER_MAX_LEN, dev)
    for k in ("k", "v"):
        cache["l0"][k][:, :, :n] = ck["l0"][k]
    cache["xk"], cache["xv"] = ck["xk"], ck["xv"]
    return cache


def _one_shot_then_decode(torch, ops, cfg, dev, prefill_fn, step_fn,
                          params, prompt, frames, new, ticks=None):
    """One-shot prefill of ``prompt`` (exact length) with its frames, then
    ``new`` greedy tokens through the dense decode step: (prefill's last
    logits, greedy tokens, prefill ms, the prefill's kernel launches);
    ``ticks`` collects each decode step's ms."""
    n = prompt.size
    toks = torch.as_tensor(prompt, device=dev).to(torch.int32)[None]
    n0 = ops.launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    lk, ck = prefill_fn(params, {"tokens": toks, "encoder_input": frames},
                        None)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t) * 1e3
    n1 = ops.launch_counts()
    if not bool(torch.isfinite(lk).all()):
        raise CheckFailed("whisper: non-finite prefill logits")
    cache = _dense_cache_of(torch, cfg, dev, ck, n)
    del ck
    out, logits = [], lk
    for i in range(new):
        nxt = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        out.append(int(nxt[0, 0]))
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = step_fn(params, cache, nxt, n + i, None)
        torch.cuda.synchronize()
        if ticks is not None:
            ticks.append((time.perf_counter() - t) * 1e3)
        if not bool(torch.isfinite(logits).all()):
            raise CheckFailed("whisper: non-finite decode logits")
    return lk, out, prefill_ms, {k: n1[k] - n0[k] for k in n1}


def whisper_serve(torch, ops, dev, card, flush):
    """Phase 13, serving: whisper-medium at full width and depth (bf16
    compute, f32 master weights from seed 0).  B4 at its shapes against
    its plain version; then the main path, with the launch counts reset
    just before: each of phase 4's prompts one-shot prefilled with its
    stand-in frames through ``build_prefill_step`` (B4 in every decoder
    layer, nothing else of the repo) and decoded ``WHISPER_NEW`` greedy
    tokens through the dense decode step (nothing of the repo launched);
    two identical prefills and decode steps bitwise equal;
    ``Engine.generate(encoder_input=)`` on four equal prompts (its loop
    prefill launches nothing); at 2 + 2 layers in f32 the kernel prefill
    against the plain path (1e-3 of the largest logit) and its greedy
    tokens against ``generate``'s loop prefill; the f32 distance at full
    depth; one profiled prefill."""
    import repro_torch.configs as configs
    from repro_torch.models import model as mdl
    from repro_torch.serve.engine import (Engine, build_prefill_step,
                                          build_serve_step)

    cfg = configs.get("whisper-medium")
    kern, kern_err = check_flash_whisper(torch, ops, dev, flush, cfg)
    for r in kern.values():
        print(f"  [{card}] whisper-medium flash_attention_fwd "
              f"{r['shape']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"{r['bound_share']:.3f} of the bound")
    held_gb, freed_gb = _held_gb(torch)
    torch.cuda.reset_peak_memory_stats()
    params = mdl.init_params(cfg, 0, dev)
    rt = mdl.Runtime()
    prefill_fn = build_prefill_step(cfg, rt)
    step_fn = build_serve_step(cfg, rt)
    prompts, frames = _whisper_prompts(torch, cfg, dev)
    # warm-up: the allocator, and each kernel's first launch
    _one_shot_then_decode(torch, ops, cfg, dev, prefill_fn, step_fn, params,
                          prompts[0], frames[:1], 2)

    prefill_ms, tick_ms, per_prefill, tokens = [], [], [], []
    ops.reset_launch_counts()               # the main path's run starts
    for i, p in enumerate(prompts):
        _, out, ms, n = _one_shot_then_decode(
            torch, ops, cfg, dev, prefill_fn, step_fn, params, p,
            frames[i:i + 1], WHISPER_NEW, tick_ms)
        prefill_ms.append(ms)
        per_prefill.append(n)
        tokens.append(out)
    torch.cuda.synchronize()
    launches = ops.launch_counts()          # ... and ends
    want = {k: 0 for k in launches}
    want["flash_attention_fwd"] = cfg.num_layers
    if any(pp != want for pp in per_prefill):
        raise CheckFailed(f"whisper: a prefill launched {per_prefill}, "
                          f"expected {want}")
    if launches != {k: n * len(prompts) for k, n in want.items()}:
        raise CheckFailed(f"whisper: the decode steps launched a kernel of "
                          f"the repo: {launches}")

    # two identical prefills, and two identical decode steps
    p = prompts[1]
    toks = torch.as_tensor(p, device=dev).to(torch.int32)[None]
    batch = {"tokens": toks, "encoder_input": frames[1:2]}
    a_l, a_c = prefill_fn(params, batch, None)
    b_l, b_c = prefill_fn(params, batch, None)
    same = torch.equal(a_l, b_l) and all(
        torch.equal(a_c["l0"][k], b_c["l0"][k]) for k in ("k", "v")) and \
        torch.equal(a_c["xk"], b_c["xk"]) and torch.equal(a_c["xv"],
                                                          b_c["xv"])
    nxt = a_l[:, -1].argmax(-1)[:, None].to(torch.int32)
    outs = []
    for c in (a_c, b_c):
        lg, c2 = step_fn(params, _dense_cache_of(torch, cfg, dev, c,
                                                 p.size), nxt, p.size, None)
        outs.append((lg, c2["l0"]["k"]))
    same = same and torch.equal(outs[0][0], outs[1][0]) and \
        torch.equal(outs[0][1], outs[1][1])
    if not same:
        raise CheckFailed("whisper: two identical prefills or decode steps "
                          "gave different bits")
    del a_l, a_c, b_l, b_c, outs

    # generate's loop prefill: four equal prompts in one batch
    gen_prompts = _dense_prompts(cfg.vocab_size, len(prompts),
                                 WHISPER_GEN_LEN)
    with Engine(cfg, rt, params, max_len=WHISPER_MAX_LEN) as eng:
        eng.generate(gen_prompts[:, :2], steps=1, encoder_input=frames)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        gen = eng.generate(gen_prompts, steps=WHISPER_NEW,
                           encoder_input=frames)
        gen_s = time.perf_counter() - t
        gen_launches = ops.launch_counts()
    if any(gen_launches.values()):
        raise CheckFailed(f"whisper: generate's loop prefill launched "
                          f"{gen_launches}")
    if gen.shape != (len(prompts), WHISPER_GEN_LEN + WHISPER_NEW):
        raise CheckFailed(f"whisper: generate returned {gen.shape}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    prof = _profile_whisper_prefill(torch, prefill_fn, params, prompts[-1],
                                    frames[-1:], dev, card)

    # f32: the full depth's distance, then the 2 + 2 cut's checks
    full = _f32_prefill(torch, ops, cfg.replace(dtype="float32"), dev,
                        params, prompts[1], frames[1:2])
    print(f"  whisper-medium at full depth, f32: one prefill of the "
          f"{prompts[1].size}-token prompt through B4 against the plain "
          f"path: max |dlogit| {full[0]:.3e} (max |logit| {full[1]:.3f}); "
          f"recorded, not checked (ROADMAP C7)")
    del params
    torch.cuda.empty_cache()
    cut = _whisper_f32_cut(torch, ops, cfg, dev, prompts[1], frames[1:2])

    med = statistics.median(tick_ms)
    print(f"  whisper-medium serving: {cfg.encoder_layers} + "
          f"{cfg.num_layers} layers, {len(prompts)} prompts of "
          f"{[q.size for q in prompts]} tokens one-shot prefilled with "
          f"{cfg.encoder_seq_len} stand-in frames each, {WHISPER_NEW} "
          f"greedy tokens each through the dense cache of "
          f"{WHISPER_MAX_LEN}; launches {launches} (flash_attention_fwd "
          f"{cfg.num_layers} per prefill, none in a decode step); two "
          f"identical prefills and decode steps bitwise equal; generate "
          f"of 4 x {WHISPER_GEN_LEN} tokens + {WHISPER_NEW} launched "
          f"nothing of the repo")
    print(f"  [{card}] whisper-medium serving: prefill ms "
          f"{[round(x, 3) for x in prefill_ms]}; median decode-step ms "
          f"{med:.3f}; generate {gen_s * 1e3:.1f} ms ("
          f"{WHISPER_GEN_LEN} loop-prefill + {WHISPER_NEW} decode steps at "
          f"batch 4); device memory peak {peak_gb:.2f} GB ({held_gb:.3f} "
          f"GB held before, {freed_gb:.3f} GB then freed by the garbage "
          f"collector)")
    return dict(kernel=kern, kernel_max_abs_err=kern_err,
                launches=launches, launches_per_prefill=per_prefill[0],
                prefill_ms=prefill_ms, decode_step_ms=tick_ms,
                median_decode_step_ms=med, generate_ms=gen_s * 1e3,
                generate_launches=gen_launches, tokens=tokens,
                peak_memory_gb=peak_gb, held_before_gb=held_gb,
                freed_by_gc_gb=freed_gb, profiled_prefill=prof,
                full_depth_f32_max_dlogit=full[0],
                full_depth_f32_max_logit=full[1], **cut)


def _f32_prefill(torch, ops, cfg, dev, params, prompt, frames):
    """(max |dlogit|, max |logit|) of one prefill of ``cfg`` (f32) through
    the kernels against the plain path."""
    from repro_torch.serve.engine import build_prefill_step
    from repro_torch.models import model as mdl
    prefill_fn = build_prefill_step(cfg, mdl.Runtime())
    toks = torch.as_tensor(prompt, device=dev).to(torch.int32)[None]
    batch = {"tokens": toks, "encoder_input": frames}
    got, _ = prefill_fn(params, batch, None)
    with ops.reference_mode():
        want, _ = prefill_fn(params, batch, None)
    return float((got - want).abs().max()), float(want.abs().max())


def _whisper_f32_cut(torch, ops, cfg, dev, prompt, frames):
    """Full width cut to 2 + 2 layers in f32: the kernel prefill's logits
    against the plain path's (1e-3 of the largest logit, as phases 10 and
    11 hold their cuts: the random-init model is ill-conditioned, a 1e-7
    perturbation of its frames moving its logits by 6.9e-4 of the largest
    at the smoke widths, tools/whisper_f32_error.py), with B4 launched
    once per decoder layer; then ``WHISPER_NEW`` greedy tokens after the
    one-shot prefill against ``Engine.generate``'s loop prefill on the
    same inputs, and the distance of the two prefills' last logits."""
    from repro_torch.models import model as mdl
    from repro_torch.serve.engine import (Engine, build_prefill_step,
                                          build_serve_step)
    cfg1 = cfg.replace(num_layers=2, encoder_layers=2, dtype="float32")
    p1 = mdl.init_params(cfg1, 0, dev)
    rt = mdl.Runtime()
    prefill_fn = build_prefill_step(cfg1, rt)
    n0 = ops.launch_counts()["flash_attention_fwd"]
    d, scale = _f32_prefill(torch, ops, cfg1, dev, p1, prompt, frames)
    flash = ops.launch_counts()["flash_attention_fwd"] - n0
    print(f"  whisper-medium cut to 2 + 2 layers, f32: prefill of "
          f"{prompt.size} tokens through B4 ({flash} launches) against "
          f"the plain path: max |dlogit| {d:.3e} (max |logit| "
          f"{scale:.3f}; tolerance 1e-3 x max |logit|)")
    if flash != cfg1.num_layers or not d <= 1e-3 * scale:
        raise CheckFailed("whisper: the f32 prefill through B4 disagrees "
                          "with the plain path")
    lk, one_shot, _, _ = _one_shot_then_decode(
        torch, ops, cfg1, dev, prefill_fn, build_serve_step(cfg1, rt), p1,
        prompt, frames, WHISPER_NEW)
    with Engine(cfg1, rt, p1, max_len=WHISPER_MAX_LEN) as eng:
        loop = eng.generate(prompt[None], steps=WHISPER_NEW,
                            encoder_input=frames)[0, prompt.size:].tolist()
        # the loop prefill's last logits, as generate computes them
        params, pa, premat = eng._snapshot()
        cache = mdl.init_cache(cfg1, 1, WHISPER_MAX_LEN, dev)
        with torch.inference_mode():
            enc = mdl._encode(cfg1, rt, params["encoder"], frames)
            cache["xk"], cache["xv"] = mdl.precompute_cross_kv(cfg1, params,
                                                               enc)
            toks = torch.as_tensor(prompt, device=dev).to(torch.int32)[None]
            for i in range(prompt.size):
                ll, cache = eng.step_fn(params, cache, toks[:, i:i + 1], i,
                                        pa, premat)
    dd = float((ll[0, -1] - lk[0, -1]).abs().max())
    equal = one_shot == loop
    print(f"  whisper-medium cut to 2 + 2 layers, f32: {WHISPER_NEW} greedy "
          f"tokens after the one-shot prefill {'equal' if equal else 'NOT equal'} "
          f"to generate's loop prefill's; last prefill logits "
          f"max |dlogit| {dd:.3e}")
    if not equal and dd > 1e-3 * scale:
        raise CheckFailed("whisper: the one-shot and the loop prefill part")
    return dict(f32_cut_max_dlogit=d, f32_cut_max_logit=scale,
                f32_cut_flash_launches=flash, f32_cut_tokens_equal=equal,
                f32_cut_one_shot_vs_loop_max_dlogit=dd)


def _profile_whisper_prefill(torch, prefill_fn, params, prompt, frames, dev,
                             card):
    """One one-shot prefill under torch.profiler: device-busy time, its idle
    share, B4's part and the top device operations."""
    toks = torch.as_tensor(prompt, device=dev).to(torch.int32)[None]
    dev_ev, launches, busy, wall = _profile_call(
        torch, lambda: prefill_fn(params, {"tokens": toks,
                                           "encoder_input": frames}, None))
    flash = _device_ms(dev_ev, "flash_fwd")
    top = sorted(dev_ev, key=lambda e: -e.self_device_time_total)[:8]
    top = [(e.key[:60], e.count, e.self_device_time_total / 1e3)
           for e in top]
    print(f"  [{card}] one whisper-medium prefill of {prompt.size} tokens "
          f"under the profiler: {launches} kernel launches, device busy "
          f"{busy:.3f} ms of {wall:.3f} ms wall (device idle share "
          f"{1 - busy / wall:.3f}), flash_attention_fwd {flash:.3f} ms of "
          f"it; top device operations:")
    for name, n, ms in top:
        print(f"    {ms:9.3f} ms  x{n:<5d} {name}")
    return dict(launches=launches, device_busy_ms=busy, wall_ms=wall,
                flash_ms=flash, top=top)


def _whisper_loop(torch, ops, cfg, rt, tc, stream, dev, label):
    """Two identical steps of ``cfg`` from seed 0 compared bit for bit
    (parameters, loss, gradient norm), then one warm-up step of
    ``train_loop`` and ``WHISPER_STEPS`` counted ones with the launch
    counts reset just before: (the state, the counted steps' history,
    their launches, the first step's metrics)."""
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_lib
    from repro_torch.train.trainer import train_loop
    batch0 = {k: torch.as_tensor(v, device=dev)
              for k, v in stream.next_batch().items()}
    step_fn = step_lib.build_train_step(cfg, rt, tc)
    first = None
    for _ in range(2):
        state = step_lib.init_state(cfg, 0, device=dev)
        state, m = step_fn(state, batch0, None)
        got = [t.detach().cpu() for t in adamw.leaves(state.params)] + [
            m["loss"].cpu(), m["grad_norm"].cpu()]
        if first is None:
            first, m0 = got, {k: float(v) for k, v in m.items()
                              if v.numel() == 1}
        elif not all(torch.equal(a, b) for a, b in zip(first, got)):
            raise CheckFailed(f"whisper {label}: two identical train steps "
                              f"gave different bits")
        del m, got
    del first, batch0
    state, _ = train_loop(cfg, rt, tc, stream, state=state, num_steps=1,
                          log_every=0, device=dev)
    ops.reset_launch_counts()               # the main path's run starts
    state, hist = train_loop(cfg, rt, tc, stream, state=state,
                             num_steps=WHISPER_STEPS, log_every=0,
                             device=dev)
    torch.cuda.synchronize()
    launches = ops.launch_counts()          # ... and ends
    losses = [h["loss"] for h in hist]
    if not all(map(math.isfinite, losses)):
        raise CheckFailed(f"whisper {label}: training loss not finite: "
                          f"{losses}")
    if any(launches.values()):
        raise CheckFailed(f"whisper {label}: training launched {launches}")
    return state, hist, launches, m0


def whisper_train(torch, ops, dev, card):
    """Phase 13, training: whisper-medium at full width and depth (bf16,
    f32 master weights and moments from seed 0) through ``train_loop`` at
    batch ``WHISPER_BATCH`` x 448 decoder tokens with 1,500 stand-in frames
    a row (``EncoderStubStream``): two identical steps bitwise equal, the
    gradients of one batch (every encoder parameter's finite and nonzero,
    none for the frames; their f32 global norm and largest entry), one
    warm-up step, then ``WHISPER_STEPS`` counted steps with the launch
    counts reset just before (finite losses; no kernel of the repo:
    attention trains plain, and Whisper has no experts), one profiled
    step.  The seeded init's gradient norm grows with depth in both
    packages (``WHISPER_TRAIN_CUT``), and at full depth its f32 sum of
    squares may overflow: the step guard then skips the step, as the JAX
    package's does, so the full-depth loop may not abort on that alone
    (``max_bad_steps``); at full width cut to ``WHISPER_TRAIN_CUT`` +
    ``WHISPER_TRAIN_CUT`` layers the same loop must take every step."""
    import repro_torch.configs as configs
    from repro_torch.common.config import TrainConfig
    from repro_torch.data.pipeline import EncoderStubStream, make_stream
    from repro_torch.models import model as mdl
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_lib

    cfg = configs.get("whisper-medium")
    seq = cfg.max_decoder_len
    rt = mdl.Runtime(use_pallas=False)
    tc = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                     total_steps=TRAIN_STEPS,
                     max_bad_steps=WHISPER_STEPS + 1)

    def stream():
        return EncoderStubStream(make_stream(cfg.vocab_size, seq,
                                             WHISPER_BATCH, kind="bytes",
                                             seed=0),
                                 cfg.encoder_seq_len, cfg.d_model, seed=0)

    held_gb, freed_gb = _held_gb(torch)
    torch.cuda.reset_peak_memory_stats()
    # the gradients of one batch at full depth
    data = stream()
    batch0 = {k: torch.as_tensor(v, device=dev)
              for k, v in data.next_batch().items()}
    params = mdl.init_params(cfg, 0, dev)
    metrics, grads = step_lib.loss_and_grads(cfg, rt, params, batch0, None)
    enc = adamw.leaves(grads["encoder"])
    enc_ok = all(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
                 for g in enc)
    frames = batch0["encoder_input"]
    if not enc_ok or frames.requires_grad or frames.grad is not None:
        raise CheckFailed("whisper: the encoder's parameters lack a finite "
                          "nonzero gradient, or its input got one")
    every = adamw.leaves(grads)
    gmax = max(float(g.float().abs().max()) for g in every)
    finite = all(bool(torch.isfinite(g).all()) for g in every)
    gnorm = float(adamw.global_norm(grads))
    print(f"  whisper-medium gradients of one batch at full depth: loss "
          f"{float(metrics['loss']):.4f}; all {len(enc)} encoder leaves "
          f"finite and nonzero, the frames carry no gradient; every leaf "
          f"finite: {finite}, largest |g| {gmax:.3e}, f32 global norm "
          f"{gnorm:.3e}")
    del grads, enc, every, metrics, batch0, frames, params
    torch.cuda.empty_cache()

    state, hist, launches, m0 = _whisper_loop(torch, ops, cfg, rt, tc,
                                              stream(), dev, "full depth")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prof = _profile_train_step(torch, cfg, rt, tc, stream(), state, None,
                               dev, card)
    del state
    torch.cuda.empty_cache()
    losses = [h["loss"] for h in hist]
    step_ms = [h["time_s"] * 1e3 for h in hist]
    med = statistics.median(step_ms)
    tok_s = WHISPER_BATCH * seq / med * 1e3
    print(f"  whisper-medium training: {cfg.encoder_layers} + "
          f"{cfg.num_layers} layers, batch {WHISPER_BATCH} x {seq} decoder "
          f"tokens and {cfg.encoder_seq_len} frames a row; two identical "
          f"steps bitwise equal (step_ok {m0['step_ok']:g}, grad_norm "
          f"{m0['grad_norm']:.3e}); losses {[round(x, 4) for x in losses]}; "
          f"step_ok {[h['step_ok'] for h in hist]}; launches {launches}")
    print(f"  [{card}] whisper-medium training: step ms "
          f"{[round(x, 1) for x in step_ms]}, median {med:.1f} ms, "
          f"{tok_s:.0f} decoder tokens/s; device memory peak {peak_gb:.2f} "
          f"GB ({held_gb:.3f} GB held before, {freed_gb:.3f} GB then freed "
          f"by the garbage collector)")

    # full width cut in depth: the loop takes every step
    n = WHISPER_TRAIN_CUT
    cut = cfg.replace(num_layers=n, encoder_layers=n)
    state, chist, _, c0 = _whisper_loop(torch, ops, cut, rt, tc, stream(),
                                        dev, f"{n} + {n} layers")
    del state
    torch.cuda.empty_cache()
    closses = [h["loss"] for h in chist]
    print(f"  whisper-medium cut to {n} + {n} layers: two identical steps "
          f"bitwise equal (grad_norm {c0['grad_norm']:.3e}); losses "
          f"{[round(x, 4) for x in closses]}, step_ok "
          f"{[h['step_ok'] for h in chist]}, step ms "
          f"{[round(h['time_s'] * 1e3, 1) for h in chist]}")
    if c0["step_ok"] != 1.0 or any(h["step_ok"] != 1.0 for h in chist):
        raise CheckFailed(f"whisper: the {n} + {n}-layer loop skipped a "
                          f"step")
    return dict(batch=WHISPER_BATCH, seq=seq, losses=losses,
                step_ok=[h["step_ok"] for h in hist], step_ms=step_ms,
                median_step_ms=med, decoder_tokens_per_s=tok_s,
                peak_memory_gb=peak_gb, held_before_gb=held_gb,
                freed_by_gc_gb=freed_gb, launches=launches,
                profiled_step=prof, grads_finite=finite, grad_max=gmax,
                grad_norm_f32=gnorm, first_step=m0, cut_layers=n,
                cut_losses=closses, cut_first_step=c0,
                cut_step_ms=[h["time_s"] * 1e3 for h in chist])


def whisper_world_one(torch, ops, dev, card):
    """Phase 13: whisper-medium served and trained at full width and
    depth on one card."""
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    t = time.perf_counter()
    res = {"serving": whisper_serve(torch, ops, dev, card, flush)}
    del flush
    torch.cuda.empty_cache()
    res["training"] = whisper_train(torch, ops, dev, card)
    res["seconds"] = time.perf_counter() - t
    print(f"  whisper-medium: {res['seconds']:.1f} s")
    return res


# ---------------------------------------------------------------------------
# phase 14: the dry run
# ---------------------------------------------------------------------------
# phase 14's records beside every config's train_4k under tp: the serving
# shapes that no grid of whole rows could run, and three configs under the
# reference's zero mode (the CLI has no perf_opts flag, as the reference's
# has none: these run dryrun_combo from ``python -c``)
DRYRUN_SERVE = (("qwen1p5_110b", "prefill_32k"), ("qwen1p5_110b",
                                                  "decode_32k"),
                ("gpt_moe_s", "prefill_32k"), ("gpt_moe_s", "decode_32k"))
DRYRUN_ZERO = ("qwen1p5_110b", "jamba_v0p1_52b", "olmoe_1b_7b")
# train_4k records left to the CPU dry run (``--all``): after qwen1.5's,
# the batch's longest (224.0 and 186.6 s with start-up on the card's host
# in PR 28), whose work kept the whole script over 1,000 s; qwen2-vl's
# layers are qwen1.5's, mamba2's are jamba's Mamba layers
DRYRUN_CPU_ONLY = ("qwen2_vl_72b", "mamba2_1p3b")
_ZERO_CALL = ("import json, sys; from repro_torch.launch import dryrun; "
              "json.dump(dryrun.dryrun_combo(sys.argv[1], 'train_4k', "
              "perf_opts={'sharding_mode': 'zero'}), open(sys.argv[2], 'w'))")


def _dryrun_batch(out_dir):
    """Start phase 14's dry runs on the 16 x 16 grid, the longest first,
    one process per record and at most one per spare core, each on one
    intra-op thread: ``python -m repro_torch.launch.dryrun`` at train_4k
    for every config but ``DRYRUN_CPU_ONLY`` and at ``DRYRUN_SERVE``, and
    ``DRYRUN_ZERO`` under ``zero``.  Returns a function that waits for
    them all and gives (config, shape, layout, exit code, record,
    seconds) of each."""
    from concurrent.futures import ThreadPoolExecutor

    import repro_torch.configs as configs
    first = ("qwen1p5_110b", "jamba_v0p1_52b", "gemma2_9b", "minitron_8b",
             "granite_moe_3b_a800m", "whisper_medium")
    archs = list(first) + [a for a in configs.PAPER + configs.ASSIGNED
                           if a not in first + DRYRUN_CPU_ONLY]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    jobs = [(a, "train_4k", "tp") for a in archs[:2]]
    jobs += [(a, sh, "tp") for a, sh in DRYRUN_SERVE[:1]]
    jobs += [(a, "train_4k", "tp") for a in archs[2:]]
    jobs += [(a, sh, "tp") for a, sh in DRYRUN_SERVE[1:]]
    jobs += [(a, "train_4k", "zero") for a in DRYRUN_ZERO]

    def one(job):
        arch, shape, layout = job
        t = time.perf_counter()
        tag = f"{arch}_{shape}_{layout}"
        path = os.path.join(out_dir, f"{arch}_{shape}_single_ring.json")
        if layout == "zero":
            path = os.path.join(out_dir, f"{tag}.json")
            argv = ["-c", _ZERO_CALL, arch, path]
        else:
            argv = ["-m", "repro_torch.launch.dryrun", "--arch", arch,
                    "--shape", shape, "--mesh", "single", "--out", out_dir]
        with open(os.path.join(out_dir, f"{tag}.log"), "w") as log:
            rc = subprocess.run(
                [sys.executable, "-W", "ignore::FutureWarning"] + argv,
                env=env, stdout=log, stderr=subprocess.STDOUT, cwd=ROOT,
                timeout=900).returncode
        rec = json.load(open(path)) if os.path.exists(path) else {}
        return arch, shape, layout, rc, rec, time.perf_counter() - t

    pool = ThreadPoolExecutor(max_workers=max(1, (os.cpu_count() or 2) - 1))
    futures = [pool.submit(one, j) for j in jobs]
    pool.shutdown(wait=False)
    return lambda: [f.result() for f in futures]


def _realize(torch, tree, dev, gen):
    """Real tensors on the card in the shapes and dtypes of a tree of the
    dry run's fake ones: floating ones drawn from N(0, 0.02²), the others
    zero (dicts, lists and named tuples kept)."""
    if isinstance(tree, dict):
        return {k: _realize(torch, v, dev, gen) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_realize(torch, v, dev, gen) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_realize(torch, v, dev, gen) for v in tree)
    if not isinstance(tree, torch.Tensor):
        return tree
    if tree.is_floating_point():
        return (torch.randn(tree.shape, generator=gen, device=dev)
                .mul_(0.02).to(tree.dtype))
    return torch.zeros(tree.shape, dtype=tree.dtype, device=dev)


def _one_rank_on_the_card(torch, ops, dev, arch, shape_name, expect):
    """Rank 0 of the 16 x 16 ``tp`` deployment of ``arch`` at
    ``shape_name`` on real tensors on the card: the fake process group of
    the dry run stands in for the other 255 ranks (its collectives move no
    data, so nothing here is held numerically), the inputs are the dry
    run's fake arguments made real (``_realize``: the rank's shard
    shapes, the dry run's dtypes; tokens drawn from the vocabulary; the
    real ring plan), and the step is the one a user would build, with the
    kernels on (the flash forward at prefill).  Fails unless every kernel
    of ``expect`` launched, every output lies on the card, and no kernel
    ran its plain version (``reference_mode`` off).  Returns the launches,
    the step's seconds and the card's peak."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    import repro_torch.configs as configs
    from repro_torch.common.config import INPUT_SHAPES, TrainConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch import inputs as inp
    from repro_torch.launch.mesh import fake_grid
    from repro_torch.optim import adamw
    from repro_torch.serve.engine import build_prefill_step
    from repro_torch.train import step as step_lib

    cfg = configs.get(arch)
    shape = INPUT_SHAPES[shape_name]
    gen = torch.Generator(device=dev).manual_seed(0)
    with fake_grid(16, 16) as g:
        lay = inp.make_layout(cfg, shape, g, "tp")
        _, fake = dryrun._step_and_args(
            cfg, shape, g, "ring", FakeTensorMode(allow_non_fake_inputs=True))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        pa = (inp.concrete_plan(cfg, g.model, "ring", device=dev)
              if cfg.moe.enabled else None)
        batch = _realize(torch, fake[1], dev, gen)
        for k in ("tokens", "labels"):
            if k in batch:
                batch[k] = torch.randint(0, cfg.vocab_size, batch[k].shape,
                                         generator=gen, device=dev,
                                         dtype=batch[k].dtype)
        if shape.mode == "train":
            params = _realize(torch, fake[0].params, dev, gen)
            first = step_lib.TrainState(
                params, adamw.init(params),
                torch.zeros((), dtype=torch.int32, device=dev))
            rt = inp.make_runtime(cfg, g, impl="ring", layout=lay)
            step = step_lib.build_train_step(cfg, rt, TrainConfig(
                microbatch=dryrun.default_microbatches(cfg, shape, g, lay)),
                causal=not cfg.name.startswith("bert"))
        else:
            first = _realize(torch, fake[0], dev, gen)
            rt = inp.make_runtime(cfg, g, impl="ring", layout=lay,
                                  use_pallas=True)
            step = build_prefill_step(cfg, rt)
        del fake
        args_gb = (torch.cuda.memory_allocated() - before) / 1e9
        ops.reset_launch_counts()             # the rank's step starts
        t = time.perf_counter()
        out = step(first, batch, pa)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = ops.launch_counts()        # ... and ends
        peak = torch.cuda.max_memory_allocated() - before
        off = [tuple(x.shape) for x in dryrun._tensors(out)
               if x.device.type != "cuda"]
        del out, first, batch, pa
    torch.cuda.empty_cache()
    if off:
        raise CheckFailed(f"{arch} {shape_name} on the card: outputs on the "
                          f"CPU {off}")
    missing = [k for k in expect if not launches.get(k)]
    if missing:
        raise CheckFailed(f"{arch} {shape_name} on the card: {missing} not "
                          f"launched ({launches})")
    return {"launches": launches, "seconds": secs, "peak_bytes": peak,
            "args_gb": args_gb}


# one rank of the 16 x 16 tp deployment on real tensors: (config, shape,
# the kernels its step must launch)
REAL_RANK = (("qwen1p5_110b", "prefill_32k", ("flash_attention_fwd",)),
             ("olmoe_1b_7b", "train_4k", ("grouped_mlp_fwd_train",
                                          "grouped_mlp_dgrad",
                                          "grouped_mlp_wgrad")))


def dryrun_world_one(torch, ops, dev, card):
    """Phase 14: the dry run (``launch/dryrun.py``).  The train_4k record
    of every config but ``DRYRUN_CPU_ONLY`` on the fake 16 x 16 grid under
    ``tp`` from the command line, with ``DRYRUN_SERVE`` and
    ``DRYRUN_ZERO`` (``_dryrun_batch``); in this process phase 7's step
    (gpt-moe-s, bf16, 8 x 2,048, ring plan, FSSDP layer at world size 1)
    dry-run on a fake 1 x 1 grid: it must allocate nothing on the card and
    launch no kernel, and its argument bytes must equal the real step's
    state, batch and plan tables, which the step then takes on the card
    over NCCL: its peak against the dry run's, and the model FLOPs' share
    of the card's bf16 peak; then one rank of the deployment on real
    tensors for each of ``REAL_RANK`` (``_one_rank_on_the_card``), its
    peak against its record's."""
    import torch.distributed as dist

    import repro_torch.configs as configs
    from repro_torch.common.config import H100, ShapeConfig, TrainConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch import inputs as inp
    from repro_torch.train import step as step_lib

    t_phase = time.perf_counter()
    out_dir = os.path.join(ROOT, "experiments", "dryrun_torch")
    os.makedirs(out_dir, exist_ok=True)
    wait = _dryrun_batch(out_dir)

    cfg = configs.get("gpt-moe-s")
    shape = ShapeConfig("phase7", TRAIN_SEQ, TRAIN_BATCH, "train")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    ops.reset_launch_counts()                # the dry run's path starts
    rec = dryrun.dryrun_combo(cfg, shape, grid=(1, 1))
    torch.cuda.synchronize()
    launches = ops.launch_counts()           # ... and ends
    grew = torch.cuda.memory_allocated() - before
    if rec["status"] != "ok":
        raise CheckFailed(f"dry run of phase 7's step: {rec}")
    if grew or any(launches.values()):
        raise CheckFailed(f"the dry run touched the card: {grew} bytes "
                          f"allocated, launches {launches}")
    mem, cost = rec["memory"], rec["cost"]
    print(f"  dry run of phase 7's step on a fake 1 x 1 grid: "
          f"{rec['run_s']:.2f} s, 0 bytes allocated on the card, no kernel "
          f"launched; arguments {mem['argument_bytes_per_device']} B, peak "
          f"{mem['peak_estimate_per_device'] / 1e9:.2f} GB, "
          f"{cost['flops']:.4e} FLOPs")

    grid = _nccl_world()
    try:
        state = step_lib.init_state(cfg, 0, 1, dev, grid)
        g = torch.Generator(device=dev).manual_seed(0)
        batch = {"tokens": torch.randint(
            0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1), generator=g,
            device=dev, dtype=torch.int32)}
        pa = inp.concrete_plan(cfg, 1, "ring", device=dev)
        arg_bytes = dryrun.storage_bytes((state, batch, pa))
        if arg_bytes != mem["argument_bytes_per_device"]:
            raise CheckFailed(f"argument bytes: the dry run's "
                              f"{mem['argument_bytes_per_device']}, the "
                              f"real step's {arg_bytes}")
        tc = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                         total_steps=TRAIN_STEPS,
                         microbatch=dryrun.default_microbatches(cfg, shape,
                                                                grid))
        step_fn = step_lib.build_train_step(
            cfg, inp.make_runtime(cfg, grid, impl="ring"), tc)
        step_s = []
        for i in range(3):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            state, m = step_fn(state, batch, pa)
            loss = float(m["loss"])
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            if not math.isfinite(loss):
                raise CheckFailed(f"phase 14 step {i}: loss {loss}")
            peak = torch.cuda.max_memory_allocated()
        del state, m, batch, pa
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    step = statistics.median(step_s[1:])
    model_flops = 6 * cfg.active_param_count() * TRAIN_BATCH * TRAIN_SEQ
    print(f"  the same step on the card ({card}): arguments {arg_bytes} B, "
          f"equal to the dry run's; steps {[round(x, 4) for x in step_s]} "
          f"s; peak {peak / 1e9:.2f} GB (torch.cuda.max_memory_allocated) "
          f"against the dry run's {mem['peak_estimate_per_device'] / 1e9:.2f}"
          f" GB: ratio {peak / mem['peak_estimate_per_device']:.4f}; model "
          f"FLOPs {model_flops:.4e} / (step {step:.4f} s x "
          f"{H100.peak_flops_bf16:.4g}) = "
          f"{model_flops / (step * H100.peak_flops_bf16):.4f}; counted "
          f"FLOPs / (step x peak) = "
          f"{cost['flops'] / (step * H100.peak_flops_bf16):.4f}")

    real = {}
    for arch, shape_name, expect in REAL_RANK:
        real[f"{arch}_{shape_name}"] = r = _one_rank_on_the_card(
            torch, ops, dev, arch, shape_name, expect)
        print(f"  one rank of the 16 x 16 tp deployment on the card "
              f"({card}): {arch} {shape_name}, real tensors in the rank's "
              f"shard shapes ({r['args_gb']:.2f} GB of arguments), the "
              f"fake group standing in for the other 255 ranks (its "
              f"collectives move no data: nothing held numerically); "
              f"launches {r['launches']}; step {r['seconds']:.3f} s; peak "
              f"{r['peak_bytes'] / 1e9:.2f} GB")

    t = time.perf_counter()
    done = wait()
    bad = [(a, sh, lay, rc, r.get("status")) for a, sh, lay, rc, r, _ in done
           if rc != 0 or r.get("status") != "ok"]
    if bad:
        raise CheckFailed(f"dry runs on the 16 x 16 grid: {bad}")
    over = [(a, lay, r["memory"]["peak_estimate_per_device"])
            for a, sh, lay, _, r, _ in done if sh == "train_4k"
            and r["memory"]["peak_estimate_per_device"] >= 80e9]
    if over:
        raise CheckFailed(f"train_4k records at or above 80 GB a rank: "
                          f"{over}")
    print(f"  dry runs on the fake 16 x 16 grid, per rank ({len(done)} "
          f"records, waited {time.perf_counter() - t:.1f} s):")
    rows = {}
    for arch, sh, lay, _, r, secs in sorted(done):
        m, c, rf = r["memory"], r["cost"], r["roofline"]
        coll = " ".join(f"{k} {v / 1e9:.3f}"
                        for k, v in sorted(c["collective_bytes"].items()))
        print(f"    {r['arch']} {sh} {lay}: peak "
              f"{m['peak_estimate_per_device'] / 1e9:.2f} GB, model "
              f"{r['memory_model']['total_bytes_est'] / 1e9:.2f} GB, "
              f"{c['flops']:.4e} FLOPs, collective GB {coll}; compute "
              f"{rf['compute_s'] * 1e3:.2f} ms, memory "
              f"{rf['memory_s'] * 1e3:.2f} ms, collective "
              f"{rf['collective_s'] * 1e3:.2f} ms ({rf['dominant']}); "
              f"useful {rf['useful_flops_ratio']:.4f}; microbatches "
              f"{r['microbatches']} (ran {r['measured_microbatches']}); run "
              f"{r['run_s']:.2f} s ({secs:.1f} s with start-up)")
        rows[f"{arch}_{sh}_{lay}"] = r
    for key, r in real.items():
        dry = rows[f"{key}_tp"]["memory"]["peak_estimate_per_device"]
        r["dryrun_peak_bytes"] = dry
        print(f"  [{card}] {key}, one rank on the card: peak "
              f"{r['peak_bytes'] / 1e9:.2f} GB (torch.cuda."
              f"max_memory_allocated) against the dry run's {dry / 1e9:.2f} "
              f"GB: ratio {r['peak_bytes'] / dry:.4f}")
    res = {"phase7_record": rec, "real_arg_bytes": arg_bytes,
           "real_peak_bytes": peak, "step_s": step_s, "records": rows,
           "one_rank": real, "seconds": time.perf_counter() - t_phase}
    print(f"  phase 14: {res['seconds']:.1f} s")
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="",
                    help="also write every measurement to this JSON file")
    ap.add_argument("--phases", default="",
                    help="comma-separated phases among 3-14 to run after "
                         "the device and the build (default: all); the "
                         "kernel table and the result line need all")
    args = ap.parse_args()
    # the training phase's plain versions allocate and free many large
    # (K, T, F) temporaries: grow segments instead of fragmenting
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run it from the "
             f"repository")
    sys.path.insert(0, src)
    from repro_torch.kernels import _build, ops

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card_line = smi.stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print("== 1. device")
    print(card_line)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("  TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")

    print("== 2. build")
    t = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t
    for src_name, log in logs.items():
        if not log:
            print(f"  {src_name}.cu: cached")
            continue
        stats = ptxas_stats(log)
        if src_name.startswith("grouped_mlp"):
            regs = [ln.strip() for ln in log.splitlines()
                    if "registers" in ln]
            print(f"  {src_name}.cu: {regs[0]}")
            stats = [(k, i) for k, i in stats
                     if any(t in k for t in PTXAS_KERNELS)]
        print(f"  {src_name}.cu, per kernel (ptxas -v):")
        for kname, info in stats:
            print(f"    {kname}: {info}")
    print(f"  built {len(logs)} kernel libraries in {build_s:.2f} s")

    results = {"device": card_line, "build_s": build_s}
    run = set(range(3, 15)) if not args.phases else \
        {int(x) for x in args.phases.split(",")}

    def phase(n, title):
        if n in run:
            print(f"== {n}. {title} (script wall so far "
                  f"{time.perf_counter() - T_START:.1f} s)")
        return n in run

    try:
        if phase(3, "kernels against their plain versions"):
            flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8,
                                device=dev)
            kern = {"grouped_mlp_fwd": check_grouped_mlp(torch, ops, dev,
                                                         flush),
                    "flash_attention_fwd": check_flash_attention(
                        torch, ops, dev, flush),
                    "paged_decode_attention": check_paged_attention(
                        torch, ops, dev, flush)}
            kern.update(check_grouped_mlp_train(torch, ops, dev, flush))
            _print_kernel_rows(card_line, kern)
            print("  -- at the shapes of phase 10's configurations")
            kern10 = check_slice10_kernels(torch, ops, dev, flush)
            for cname, rows in kern10.items():
                _print_kernel_rows(card_line, rows, f"{cname} ")
            print("  -- at the new shapes of phase 11's configurations")
            kern11 = check_slice11_kernels(torch, ops, dev, flush)
            for cname, rows in kern11.items():
                _print_kernel_rows(card_line, rows, f"{cname} ")
            results.update(kernels=kern, kernels_slice10=kern10,
                           kernels_slice11=kern11)
            del flush
        if phase(4, "serving gpt-moe-s at full width"):
            results["serving"] = serve_full_width(torch, ops, dev, card_line)
            serve_small_f32(torch, ops, dev)
            torch.cuda.empty_cache()
        if phase(5, "training gpt-moe-s at full width"):
            train = train_full_width(torch, ops, dev, card_line)
            train["learns_cut_depth"] = train_cut_depth_learns(torch, ops,
                                                               dev)
            train["grads_2_layers_f32"] = train_grads_cut_depth(torch, ops,
                                                                dev)
            results["training"] = train
            torch.cuda.empty_cache()
        if phase(6, "dense generate, publication under training, a fleet"):
            dense = dense_generate_full_width(torch, ops, dev, card_line)
            dense["against_paged"] = dense_against_paged(torch, ops, dev)
            torch.cuda.empty_cache()
            publication = publish_under_training(torch, ops, dev, card_line)
            publication["fleet"] = fleet_two_replicas(torch, ops, dev,
                                                      card_line)
            results.update(dense_generate=dense, publication=publication)
            torch.cuda.empty_cache()
        if phase(7, "the FSSDP layer across ranks"):
            results["fssdp"] = fssdp_world_one(
                torch, ops, dev, card_line,
                results["training"]["median_step_ms"]
                if "training" in results else float("nan"))
            torch.cuda.empty_cache()
        if phase(8, "overlap and re-materialization on the process grid"):
            results["overlap"] = overlap_world_one(torch, ops, dev,
                                                   card_line)
            torch.cuda.empty_cache()
        if phase(9, "checkpoint, resume, rollback, restored serving"):
            results["checkpoint"] = checkpoint_world_one(torch, ops, dev,
                                                         card_line)
            torch.cuda.empty_cache()
        if phase(10, "the other MoE configurations at full width"):
            results["slice10"] = slice10(torch, ops, dev, card_line)
            torch.cuda.empty_cache()
        if phase(11, "the decoder-only families at full width"):
            results["slice11"] = slice11(torch, ops, dev, card_line)
            torch.cuda.empty_cache()
        if phase(12, "serving and publication on the process grid"):
            results["serve_grid"] = serve_grid_world_one(torch, ops, dev,
                                                         card_line)
            torch.cuda.empty_cache()
        if phase(13, "whisper-medium, the encoder-decoder, at full width"):
            results["whisper"] = whisper_world_one(torch, ops, dev,
                                                   card_line)
            torch.cuda.empty_cache()
        if phase(14, "the dry run on fake tensors over a fake grid"):
            results["dryrun"] = dryrun_world_one(torch, ops, dev, card_line)
    except CheckFailed as e:
        fail(str(e))

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    if run != set(range(3, 15)):
        print(f"phases {sorted(run)} passed (script wall "
              f"{time.perf_counter() - T_START:.1f} s); the kernel table "
              f"and the result line come with every phase")
        return
    table = _kernel_table(results)
    print(f"== 15. kernels (script wall so far "
          f"{time.perf_counter() - T_START:.1f} s)")
    print(f"kernels: {json.dumps(list(results['kernels']))}")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


def _print_kernel_rows(card_line, kern, tag=""):
    """One line per timed shape of each kernel's results."""
    for k, r in kern.items():
        extra = [("prefill ", r.get("prefill")),
                 ("near max ", r.get("near_max"))]
        if "buckets" in r:
            extra = [(f"bucket S={S} ", rr) for S, rr in r["buckets"].items()]
        for sub, rr in [("", r)] + extra:
            if rr:
                rate = (f", {rr['tflops']:.1f} TFLOP/s, "
                        f"{rr['bound_share']:.3f} of the bound"
                        if "tflops" in rr else "")
                if "tile_list_ms" in rr:
                    rate += (f"; its tile list, built once per forward "
                             f"for it, dgrad and wgrad, "
                             f"{rr['tile_list_ms']:.4f} ms")
                print(f"  [{card_line}] {tag}{k} {sub}{rr['shape']}: kernel "
                      f"{rr['ms']:.4f} ms, plain {rr['plain_ms']:.4f} "
                      f"ms, library {rr['library_ms']:.4f} ms, bound "
                      f"{rr['bound_ms']:.4f} ms ({rr['bound_by']})"
                      f"{rate}")


KERNEL_META = {
    "grouped_mlp_fwd": ("kernels/csrc/grouped_mlp.cu",
                        "src/repro/kernels/grouped_mlp.py:106"),
    "flash_attention_fwd": ("kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:25"),
    "paged_decode_attention": ("kernels/csrc/paged_attention.cu",
                               "src/repro/kernels/paged_attention.py:59"),
    "grouped_mlp_fwd_train": ("kernels/csrc/grouped_mlp.cu",
                              "src/repro/kernels/grouped_mlp.py:106"),
    "grouped_mlp_dgrad": ("kernels/csrc/grouped_mlp_bwd.cu",
                          "src/repro/kernels/grouped_mlp.py:215"),
    "grouped_mlp_wgrad": ("kernels/csrc/grouped_mlp_bwd.cu",
                          "src/repro/kernels/grouped_mlp.py:324")}


def _kernel_table(results):
    """The rows of the kernels JSON line: each kernel at gpt-moe-s's shapes
    with its launches in phases 4/5 (and 7, 8, 9, 12), then at each phase-10
    configuration's shapes with its launches in phase 10, then the serving
    kernels at phase 11's new shapes with their launches in phase 11, then
    B4 at each of Whisper's prompt lengths with its launches in phase 13."""
    def row(k, r, launches, **more):
        return {"name": k, "route": "cuda",
                "source": "src/repro_torch/" + KERNEL_META[k][0],
                "replaces": KERNEL_META[k][1], "launches": launches,
                **more, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "shape": r["shape"],
                **{key: r[key] for key in ("tflops", "bound_share")
                   if key in r}}

    table = []
    for k, r in results["kernels"].items():
        main = results["training" if k in TRAIN_KERNELS else "serving"]
        table.append(row(
            k, r, main["launches"][k],
            config="gpt-moe-s",
            launches_fssdp=results["fssdp"]["launches"][k],
            launches_overlap={mode: r8["launches"][k] for mode, r8 in
                              results["overlap"]["modes"].items()},
            launches_checkpoint=results["checkpoint"]["launches"][k],
            launches_serve_grid=results["serve_grid"]["launches"][k]))
    for cname, rows in results["kernels_slice10"].items():
        ran = results["slice10"][cname]
        for k, r in rows.items():
            part = ran["training" if k in TRAIN_KERNELS else "serving"]
            table.append(row(k, r, part["launches"][k], config=cname))
    # phase 11's new shapes with their launches in phase 11's serving runs;
    # Jamba's training kernels were checked and timed in phase 3 only (it
    # trains on the CPU only), so they have no run of their own here
    for cname, rows in results["kernels_slice11"].items():
        ran = results["slice11"][cname]["serving"]
        for k, r in rows.items():
            if k not in TRAIN_KERNELS:
                table.append(row(k, r, ran["launches"][k], config=cname))
    # B4 at Whisper's prompt lengths (phase 13), with its launches in
    # phase 13's serving run, the only kernel of that path
    wh = results["whisper"]["serving"]
    for S, r in wh["kernel"].items():
        table.append(row("flash_attention_fwd",
                         dict(r, max_abs_err=wh["kernel_max_abs_err"]),
                         wh["launches"]["flash_attention_fwd"],
                         config="whisper-medium",
                         launches_per_prefill=wh["launches_per_prefill"][
                             "flash_attention_fwd"]))
    return table


if __name__ == "__main__":
    main()
