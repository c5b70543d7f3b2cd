#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Run from the repository root (it imports ``src/repro_torch`` and nothing of
JAX).  In order it:

1. prints the card (``nvidia-smi`` name and power limit) and turns TF32 off
   for float32 matrix products and convolutions;
2. builds the hand-written CUDA kernels from ``src/repro_torch/kernels/
   csrc/`` (one ``nvcc`` per source, in parallel) and prints the seconds;
3. holds each kernel against its plain PyTorch version on the card at
   gpt-moe-s shapes (stated tolerances): the serving kernels at serving
   shapes, the grouped-MLP training forward, dgrad and wgrad at training
   shapes (64 slots × 16,384 rows, 32,768 valid), in bf16 and f32; and times
   kernel, plain version and, where one exists, the PyTorch library call
   computing the same function (CUDA events, median, L2 flushed before
   each launch);
4. serves gpt-moe-s at full width (12 layers, bf16 compute, f32 master
   weights from a seed) through the continuous-batching scheduler: four
   byte-encoded prompts of mixed lengths, 16 greedy tokens each; it counts
   the kernel launches of that run, compares one prefill and one decode
   tick with the plain versions on the same tensors, and serves the smoke
   config in f32 with the kernels and with the plain versions, which must
   give the same tokens;
5. trains gpt-moe-s at full width (12 layers, bf16 compute, f32 master
   weights and AdamW moments from a seed) through the Hecate loop
   (``train.trainer.train_loop``, ``ep`` plan), batch 8 × seq 2,048 of
   the bytes stream: two identical steps must give bitwise-equal parameters,
   then 12 steps with the launch counters reset just before: a finite,
   falling loss, 12 dgrad and 12 wgrad launches per step and no
   flash-attention launch; one step under the profiler; and one step of
   full width cut to 2 layers in f32 whose every gradient must match the
   plain versions';
6. prints the kernel table as one JSON line, then
   ``{"ok": true, "device": {...}}`` as the last line.

Any failed check exits non-zero before the last line is printed.  Without
a CUDA device, or without the repository around it, it fails.
"""
from __future__ import annotations

import argparse
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
NEW_TOKENS = 16
MAX_LEN = 512
PAGE_SIZE = 8
MAX_SLOTS = 4
TOL = {"bfloat16": (2e-2, 2e-2), "float32": (2e-5, 2e-4)}
PAGED_TOL = {"bfloat16": (2e-2, 2e-2), "float32": (1e-5, 1e-5)}
# training: batch 8 × the paper's seq 2,048, so the MoE layer sees 16,384
# tokens, 32,768 (token, expert) assignments, in 64 slots of capacity 16,384
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 2048, 12
# at seq 2,048 the loss of random-init gpt-moe-s rose over 12 steps at lr
# 3e-3 (see PERF.md); 1e-3 is the rate that trains it here
TRAIN_LR, TRAIN_WARMUP = 1e-3, 3
GRAD_TOL = 1e-3     # 2-layer f32 gradients, relative to each tensor's max
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


# ---------------------------------------------------------------------------
# phase 3: every kernel against its plain version
# ---------------------------------------------------------------------------
def check_grouped_mlp(torch, ops, dev, flush):
    import torch.nn.functional as F
    K, D, Fd = 64, 768, 1536
    g = torch.Generator(device=dev).manual_seed(1)
    errs = []

    def inputs(T, dt):
        x = torch.randn((K, T, D), generator=g, device=dev).mul_(0.3).to(dt)
        wi = torch.randn((K, D, Fd), generator=g, device=dev).mul_(0.05) \
            .to(dt)
        wo = torch.randn((K, Fd, D), generator=g, device=dev).mul_(0.05) \
            .to(dt)
        return x, wi, wo

    for dname, dt in (("bfloat16", torch.bfloat16),
                      ("float32", torch.float32)):
        atol, rtol = TOL[dname]
        for T in (4, 256):
            x, wi, wo = inputs(T, dt)
            gs = torch.randint(0, T + 1, (K,), generator=g, device=dev,
                               dtype=torch.int32)
            gs[::5] = 0                           # zero groups
            gs[1] = T
            got = ops.grouped_mlp(x, wi, None, wo, gs, act="gelu")
            with ops.reference_mode():
                want = ops.grouped_mlp(x, wi, None, wo, gs, act="gelu")
            errs.append(compare(torch, f"grouped_mlp_fwd K={K} T={T} D={D} "
                                f"F={Fd} {dname} group_sizes", got, want,
                                atol, rtol))
        rv = torch.rand((K, 256), generator=g, device=dev) < 0.3
        rv[3] = False
        got = ops.grouped_mlp(x, wi, None, wo, None, rv, act="gelu")
        with ops.reference_mode():
            want = ops.grouped_mlp(x, wi, None, wo, None, rv, act="gelu")
        errs.append(compare(torch, f"grouped_mlp_fwd K={K} T=256 {dname} "
                            f"row_valid", got, want, atol, rtol))

    # timing at the decode tick's shape: 4 tokens, top-2 -> 8 slots hold
    # one token each (the other 56 slots are empty and skipped)
    x, wi, wo = inputs(MAX_SLOTS, torch.bfloat16)
    gs = torch.zeros(K, dtype=torch.int32, device=dev)
    gs[torch.randperm(K, generator=g, device=dev)[:2 * MAX_SLOTS]] = 1
    res = _time_grouped_mlp(torch, ops, F, x, wi, wo, gs, flush)
    # and at a prefill of the 300-token prompt (bucket 512): ~1024
    # assignments spread over the 64 slots
    xp, wip, wop = inputs(512, torch.bfloat16)
    cnt = torch.bincount(torch.randint(0, K, (1024,), generator=g,
                                       device=dev), minlength=K)
    res["prefill"] = _time_grouped_mlp(torch, ops, F, xp, wip, wop,
                                       cnt.clamp(max=512).to(torch.int32),
                                       flush)
    res["max_abs_err"] = max(errs)
    return res


def _time_grouped_mlp(torch, ops, F, x, wi, wo, gs, flush):
    K, T, D = x.shape
    Fd = wi.shape[-1]
    es = x.element_size()
    run = lambda: ops.grouped_mlp(x, wi, None, wo, gs, act="gelu")  # noqa
    ms = time_ms(torch, run, flush)
    with ops.reference_mode():
        plain = time_ms(torch, run, flush)
    groups = [(k, int(n)) for k, n in enumerate(gs.tolist()) if n > 0]

    def library():           # per-group products: the library's way
        for k, n in groups:
            h = F.gelu(x[k, :n] @ wi[k], approximate="tanh")
            h @ wo[k]
    lib = time_ms(torch, library, flush)
    rows = sum(n for _, n in groups)
    nbytes = (rows * D * es + K * T * D * es + K * T * 4
              + len(groups) * 2 * D * Fd * es)
    b_ms, b_by = bound(nbytes, 2 * rows * D * Fd * 2, "bfloat16")
    return dict(shape=f"K={K} T={T} D={D} F={Fd} bf16, {rows} valid rows "
                f"in {len(groups)} slots", ms=ms, plain_ms=plain,
                library_ms=lib, bound_ms=b_ms, bound_by=b_by)


def check_grouped_mlp_train(torch, ops, dev, flush):
    """The three training stages at the main path's shapes: K=64 slots of
    capacity T = batch × seq, 2T valid rows spread over the slots as the
    dispatch lays them out (a prefix per slot), D=768, F=1,536, GELU.
    Each kernel wrapper against its plain version on the same inputs, in
    bf16 and f32 (each stage takes the kernel outputs of the stage before
    it); timed in bf16.  The plain versions are compared a few slots at a
    time, which gives the same values in a fraction of the memory."""
    import torch.nn.functional as F
    from repro_torch.kernels import grouped_mlp as gm
    from repro_torch.kernels import ref
    K, T, D, Fd = 64, TRAIN_BATCH * TRAIN_SEQ, 768, 1536
    rows = 2 * T
    g = torch.Generator(device=dev).manual_seed(4)
    cnt = torch.bincount(torch.randint(0, K, (rows,), generator=g,
                                       device=dev), minlength=K)
    mask = (torch.arange(T, device=dev)[None, :] < cnt[:, None]) \
        .to(torch.int32)
    valid = mask.bool()
    errs = {n: [] for n in TRAIN_KERNELS}
    shape = f"K={K} T={T} D={D} F={Fd} gelu, {rows} valid rows"

    def inputs(dt):
        def rnd(shp, sc):
            return torch.randn(shp, generator=g, device=dev).mul_(sc).to(dt)
        return (rnd((K, T, D), 0.3), rnd((K, D, Fd), 0.05),
                rnd((K, Fd, D), 0.05), rnd((K, T, D), 0.1))

    def held(name, labels, got, plain, residuals=()):
        """Kernel outputs ``got`` against ``plain(slots)`` over slot
        chunks; the outputs named in ``residuals`` (h1, h2) only at valid
        rows, where the next stage reads them."""
        worst, bad = {}, set()
        for k0 in range(0, K, 8):
            sl = slice(k0, k0 + 8)
            for a, b, what in zip(got, plain(sl), labels.split(",")):
                if b is None:
                    continue
                a = a[sl]
                if what in residuals:
                    a, b = a[valid[sl]], b[valid[sl]]
                err = (a.float() - b.float()).abs()
                if not bool(torch.isfinite(a).all()) or bool(
                        (err > atol + rtol * b.float().abs()).any()):
                    bad.add(what)
                mx = float(err.max()) if err.numel() else 0.0
                worst[what] = max(worst.get(what, 0.0), mx)
        for what, mx in worst.items():
            ok = what not in bad
            print(f"  {name} {what} {shape} {dname}: max|kernel - plain| = "
                  f"{mx:.3e} (atol {atol:g}, rtol {rtol:g}) "
                  f"{'ok' if ok else 'FAILED'}")
            if not ok:
                raise CheckFailed(f"{name} {what}: kernel disagrees with "
                                  f"plain version")
            errs[name].append(mx)

    for dname, dt in (("bfloat16", torch.bfloat16),
                      ("float32", torch.float32)):
        atol, rtol = TOL[dname]
        x, wi, wo, dy = inputs(dt)
        fwd = gm.grouped_mlp_fwd_train(x, wi, None, wo, mask, act="gelu")
        held("grouped_mlp_fwd_train", "y,h1,h2", fwd,
             lambda s: ref.grouped_mlp_fwd_train_ref(
                 x[s], wi[s], None, wo[s], mask[s], act="gelu"),
             residuals=("h1", "h2"))
        h1 = fwd[1]
        del fwd
        dg = gm.grouped_mlp_dgrad(dy, mask, h1, None, wi, None, wo,
                                  act="gelu")
        held("grouped_mlp_dgrad", "dx,dh1,dh2,h", dg,
             lambda s: ref.grouped_mlp_dgrad_ref(
                 dy[s], mask[s], h1[s], None, wi[s], None, wo[s],
                 act="gelu"))
        dh1, h = dg[1], dg[3]
        del dg
        held("grouped_mlp_wgrad", "dwi,dwg,dwo",
             gm.grouped_mlp_wgrad(x, dy, mask, dh1, None, h),
             lambda s: ref.grouped_mlp_wgrad_ref(x[s], dy[s], mask[s],
                                                 dh1[s], None, h[s]))
        del x, wi, wo, dy, h1, dh1, h
        torch.cuda.empty_cache()
    # time in bf16
    x, wi, wo, dy = inputs(torch.bfloat16)
    _, h1, _ = gm.grouped_mlp_fwd_train(x, wi, None, wo, mask, act="gelu")
    _, dh1, _, h = gm.grouped_mlp_dgrad(dy, mask, h1, None, wi, None, wo,
                                        act="gelu")
    groups = [(k, int(n)) for k, n in enumerate(cnt.tolist()) if n > 0]
    es = x.element_size()
    wbytes = len(groups) * 2 * D * Fd * es
    ops2 = 2 * 2 * rows * D * Fd            # two products of 2·rows·D·F
    gelu_bwd = torch.ops.aten.gelu_backward

    def lib_fwd():
        for k, n in groups:
            F.gelu(x[k, :n] @ wi[k], approximate="tanh") @ wo[k]

    def lib_dgrad():
        for k, n in groups:
            d1 = gelu_bwd((dy[k, :n] @ wo[k].t()).float(),
                          h1[k, :n].float(), approximate="tanh")
            F.gelu(h1[k, :n], approximate="tanh")
            d1.to(x.dtype) @ wi[k].t()

    def lib_wgrad():
        for k, n in groups:
            x[k, :n].t() @ dh1[k, :n]
            h[k, :n].t() @ dy[k, :n]

    cases = {
        "grouped_mlp_fwd_train": (
            lambda: gm.grouped_mlp_fwd_train(x, wi, None, wo, mask,
                                             act="gelu"),
            lambda: ref.grouped_mlp_fwd_train_ref(x, wi, None, wo, mask,
                                                  act="gelu"),
            lib_fwd,
            # x's valid rows, mask, the used slots' weights in; y written
            # whole (the Pallas kernel writes all of it), h1 at valid rows
            # (its only reader, dgrad, reads those)
            rows * (D + Fd) * es + K * T * 4 + wbytes + K * T * D * es),
        "grouped_mlp_dgrad": (
            lambda: gm.grouped_mlp_dgrad(dy, mask, h1, None, wi, None, wo,
                                         act="gelu"),
            lambda: ref.grouped_mlp_dgrad_ref(dy, mask, h1, None, wi, None,
                                              wo, act="gelu"),
            lib_dgrad,
            # dy's and h1's valid rows, mask, weights in; dx, dh1, h out
            rows * (D + Fd) * es + K * T * 4 + wbytes
            + K * T * (D + 2 * Fd) * es),
        "grouped_mlp_wgrad": (
            lambda: gm.grouped_mlp_wgrad(x, dy, mask, dh1, None, h),
            lambda: ref.grouped_mlp_wgrad_ref(x, dy, mask, dh1, None, h),
            lib_wgrad,
            # x, dy, dh1, h valid rows and mask in; dwi and dwo written
            rows * 2 * (D + Fd) * es + K * T * 4 + K * 2 * D * Fd * es),
    }
    res = {}
    for name, (kern, plain, lib, nbytes) in cases.items():
        b_ms, b_by = bound(nbytes, ops2, "bfloat16")
        res[name] = dict(
            shape=shape + " bf16", ms=time_ms(torch, kern, flush),
            plain_ms=time_ms(torch, plain, flush, reps=5, warmup=1),
            library_ms=time_ms(torch, lib, flush, reps=5, warmup=1),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=max(errs[name]))
    return res


def check_flash_attention(torch, ops, dev, flush):
    import torch.nn.functional as F
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
                                             ((2, 64, 12, 64), True, 0)):
            q, k, v = qkv(B, S, N, H, dt)
            got = ops.flash_attention(q, k, v, causal=causal, window=window)
            with ops.reference_mode():
                want = ops.flash_attention(q, k, v, causal=causal,
                                           window=window)
            errs.append(compare(torch, f"flash_attention_fwd "
                                f"({B},{S},{N},{H}) causal={causal} "
                                f"window={window} {dname}", got, want, atol,
                                rtol))
    B, S, N, H = 1, 512, 12, 64
    q, k, v = qkv(B, S, N, H, torch.bfloat16)
    run = lambda: ops.flash_attention(q, k, v, causal=True)  # noqa: E731
    ms = time_ms(torch, run, flush)
    with ops.reference_mode():
        plain = time_ms(torch, run, flush)
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), flush)
    es = q.element_size()
    b_ms, b_by = bound(4 * q.numel() * es,
                       4 * B * N * H * S * (S + 1) / 2, "bfloat16")
    return dict(shape=f"(B,S,N,H)=({B},{S},{N},{H}) causal bf16", ms=ms,
                plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=max(errs))


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
    import torch.nn.functional as F
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
    # their prompts (17, 90, 200, 300 tokens) and half their new tokens
    positions = [n + NEW_TOKENS // 2 for n in PROMPT_LENS]
    q, k, v, ri, pos = _paged_inputs(torch, dev, g, positions, 12, 1,
                                     torch.bfloat16)
    run = lambda: ops.paged_decode_attention(  # noqa: E731
        q, k, v, ri, pos, page_size=PAGE_SIZE)
    ms = time_ms(torch, run, flush)
    with ops.reference_mode():
        plain = time_ms(torch, run, flush)
    B, nq, hd = q.shape
    kg = k[ri.long()].permute(0, 2, 1, 3).contiguous()   # (B, nkv, kv, hd)
    vg = v[ri.long()].permute(0, 2, 1, 3).contiguous()
    mask = (torch.arange(ri.shape[1], device=dev)[None, :]
            <= pos[:, None].long())[:, None, None, :]
    qs = q[:, :, None]
    lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, kg, vg, attn_mask=mask, enable_gqa=True), flush)
    es = q.element_size()
    toks = sum(p + 1 for p in positions)
    nbytes = 2 * q.numel() * es + toks * 12 * hd * es * 2 + ri.numel() // \
        PAGE_SIZE * 4 + B * 4
    b_ms, b_by = bound(nbytes, 4 * toks * nq * hd, "bfloat16")
    return dict(shape=f"B={B} 12/12 heads hd={hd} page {PAGE_SIZE} "
                f"positions {positions} bf16", ms=ms, plain_ms=plain,
                library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=max(errs))


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


def _timed(torch, fn, sink):
    def call(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        sink.append((time.perf_counter() - t) * 1e3)
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
    prefill_ms, tick_ms = [], []
    prefill_fn, step_fn = rs._prefill_fn, rs._step_fn
    rs._prefill_fn = _timed(torch, prefill_fn, prefill_ms)
    rs._step_fn = _timed(torch, step_fn, tick_ms)
    prompts = _prompts(cfg.vocab_size)
    # warm-up outside the counted run: library loads, first-call set-up
    warm = rs.submit(prompts[0], max_new_tokens=2)
    rs.run(max_ticks=10)
    if warm.state != DONE:
        raise CheckFailed(f"warm-up request ended {warm.state}")
    prefill_ms.clear()
    tick_ms.clear()
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
    dk, _ = step_fn(params, cache, tk, pos, ri, pa, premat)
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
    prof = _profile_tick(torch, rs, prompts, card)
    rs.close()
    eng.close()
    del premat, ck, cache, cache_r

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
                profiled_tick=prof)


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
    busy = sum(getattr(e, "self_device_time_total", 0.0) for e in ev
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    rs.run(max_ticks=10)
    print(f"  [{card}] one decode tick under the profiler: {launches} "
          f"kernel launches, device busy {busy:.3f} ms of {wall:.3f} ms "
          f"wall (device idle share {1 - busy / wall:.3f})")
    return dict(launches=launches, device_busy_ms=busy, wall_ms=wall)


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
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise CheckFailed(f"training loss not finite and falling: {losses}")
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
    top = sorted(dev_ev, key=lambda e: -e.self_device_time_total)[:8]
    top = [(e.key[:60], e.count, e.self_device_time_total / 1e3)
           for e in top]
    print(f"  [{card}] one train step under the profiler: {launches} kernel "
          f"launches, device busy {busy:.1f} ms of {wall:.1f} ms wall "
          f"(device idle share {1 - busy / wall:.3f})")
    for name, n, ms in top:
        print(f"    {ms:9.2f} ms  x{n:<5d} {name}")
    return dict(launches=launches, device_busy_ms=busy, wall_ms=wall,
                top_kernels=top)


def train_grads_cut_depth(torch, ops, dev):
    """Full width cut to 2 layers, f32: one step's loss and the gradient of
    every parameter through the kernels against the plain versions on the
    same tensors (no route flips at this depth)."""
    import repro_torch.configs as configs
    from repro_torch.common.params import _leaves
    from repro_torch.models import model as mdl
    from repro_torch.train import step as step_lib
    cfg = configs.get("gpt-moe-s").replace(num_layers=2, dtype="float32")
    rt, _, stream = _train_setup(torch, dev, cfg)
    params = mdl.init_params(cfg, 0, dev)
    pa = _plan(torch, cfg, dev)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in stream.next_batch().items()}
    ops.reset_launch_counts()
    mk, gk = step_lib.loss_and_grads(cfg, rt, params, batch, pa)
    launched = ops.launch_counts()
    with ops.reference_mode():
        mr, gr = step_lib.loss_and_grads(cfg, rt, params, batch, pa)
    if launched["grouped_mlp_dgrad"] != 2 or launched["grouped_mlp_wgrad"] \
            != 2:
        raise CheckFailed(f"the 2-layer kernel step launched {launched}")
    if not torch.equal(mk["expert_counts"], mr["expert_counts"]):
        raise CheckFailed("2-layer f32 routing differs between the kernels "
                          "and the plain versions")
    dl = abs(float(mk["loss"]) - float(mr["loss"]))
    worst = {}
    for (path, a), (_, b) in zip(_leaves(gk), _leaves(gr)):
        scale = float(b.abs().max())
        worst["/".join(path)] = float((a - b).abs().max()) / max(scale,
                                                                 1e-30)
    name = max(worst, key=worst.get)
    print(f"  full width cut to 2 layers, f32, one step: loss "
          f"{float(mr['loss']):.6f}, |dloss| kernels vs plain {dl:.3e}; "
          f"max |dgrad| / max |grad| over {len(worst)} parameters "
          f"{worst[name]:.3e} ({name}; tolerance {GRAD_TOL:g})")
    if not dl <= 1e-5 * abs(float(mr["loss"])) or worst[name] > GRAD_TOL:
        raise CheckFailed("2-layer f32 gradients disagree with the plain "
                          "path")
    return dict(dloss=dl, max_rel_grad_err=worst[name], worst_param=name,
                rel_grad_err=worst)


# ---------------------------------------------------------------------------
def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="",
                    help="also write every measurement to this JSON file")
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
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"  {src_name}.cu: {regs[0] if regs else 'cached'}")
    print(f"  built {len(logs)} kernel libraries in {build_s:.2f} s")

    results = {"device": card_line, "build_s": build_s}
    try:
        flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
        print("== 3. kernels against their plain versions")
        kern = {"grouped_mlp_fwd": check_grouped_mlp(torch, ops, dev, flush),
                "flash_attention_fwd": check_flash_attention(torch, ops, dev,
                                                             flush),
                "paged_decode_attention": check_paged_attention(torch, ops,
                                                                dev, flush)}
        kern.update(check_grouped_mlp_train(torch, ops, dev, flush))
        for k, r in kern.items():
            for tag, rr in (("", r), ("prefill ", r.get("prefill"))):
                if rr:
                    print(f"  [{card_line}] {k} {tag}{rr['shape']}: kernel "
                          f"{rr['ms']:.4f} ms, plain {rr['plain_ms']:.4f} "
                          f"ms, library {rr['library_ms']:.4f} ms, bound "
                          f"{rr['bound_ms']:.4f} ms ({rr['bound_by']})")
        del flush
        print("== 4. serving gpt-moe-s at full width")
        serve = serve_full_width(torch, ops, dev, card_line)
        serve_small_f32(torch, ops, dev)
        torch.cuda.empty_cache()
        print("== 5. training gpt-moe-s at full width")
        train = train_full_width(torch, ops, dev, card_line)
        train["grads_2_layers_f32"] = train_grads_cut_depth(torch, ops, dev)
    except CheckFailed as e:
        fail(str(e))
    results.update(kernels=kern, serving=serve, training=train)

    meta = {"grouped_mlp_fwd": ("kernels/csrc/grouped_mlp.cu",
                                "src/repro/kernels/grouped_mlp.py:106"),
            "flash_attention_fwd": ("kernels/csrc/flash_attention.cu",
                                    "src/repro/kernels/flash_attention.py:25"),
            "paged_decode_attention": (
                "kernels/csrc/paged_attention.cu",
                "src/repro/kernels/paged_attention.py:59"),
            "grouped_mlp_fwd_train": ("kernels/csrc/grouped_mlp.cu",
                                      "src/repro/kernels/grouped_mlp.py:106"),
            "grouped_mlp_dgrad": ("kernels/csrc/grouped_mlp_bwd.cu",
                                  "src/repro/kernels/grouped_mlp.py:215"),
            "grouped_mlp_wgrad": ("kernels/csrc/grouped_mlp_bwd.cu",
                                  "src/repro/kernels/grouped_mlp.py:324")}
    table = []
    for k, r in kern.items():
        table.append({"name": k, "route": "cuda",
                      "source": "src/repro_torch/" + meta[k][0],
                      "replaces": meta[k][1],
                      "launches": (train if k in TRAIN_KERNELS
                                   else serve)["launches"][k],
                      "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                      "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                      "bound_by": r["bound_by"],
                      "library_ms": r["library_ms"], "shape": r["shape"]})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print("== 6. kernels")
    print(f"kernels: {json.dumps(list(kern))}")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
