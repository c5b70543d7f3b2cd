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
   gpt-moe-s shapes (stated tolerances), and times kernel, plain version
   and, where one exists, the PyTorch library call computing the same
   function (CUDA events, median, L2 flushed before each launch);
4. serves gpt-moe-s at full width (12 layers, bf16 compute, f32 master
   weights from a seed) through the continuous-batching scheduler: four
   byte-encoded prompts of mixed lengths, 16 greedy tokens each; it counts
   the kernel launches of that run, compares one prefill and one decode
   tick with the plain versions on the same tensors, and serves the smoke
   config in f32 with the kernels and with the plain versions, which must
   give the same tokens;
5. prints the kernel table as one JSON line, then
   ``{"ok": true, "device": {...}}`` as the last line.

Any failed check exits non-zero before the last line is printed.  Without
a CUDA device, or without the repository around it, it fails.
"""
from __future__ import annotations

import argparse
import json
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
    if min(launches.values()) <= 0:
        raise CheckFailed(f"a kernel of the main path never launched: "
                          f"{launches}")

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
def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="",
                    help="also write every measurement to this JSON file")
    args = ap.parse_args()
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
    except CheckFailed as e:
        fail(str(e))
    results.update(kernels=kern, serving=serve)

    meta = {"grouped_mlp_fwd": ("kernels/csrc/grouped_mlp.cu",
                                "src/repro/kernels/grouped_mlp.py:106"),
            "flash_attention_fwd": ("kernels/csrc/flash_attention.cu",
                                    "src/repro/kernels/flash_attention.py:25"),
            "paged_decode_attention": (
                "kernels/csrc/paged_attention.cu",
                "src/repro/kernels/paged_attention.py:59")}
    table = []
    for k, r in kern.items():
        table.append({"name": k, "route": "cuda",
                      "source": "src/repro_torch/" + meta[k][0],
                      "replaces": meta[k][1],
                      "launches": serve["launches"][k],
                      "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                      "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                      "bound_by": r["bound_by"],
                      "library_ms": r["library_ms"], "shape": r["shape"]})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print("== 5. kernels")
    print(f"kernels: {json.dumps(list(kern))}")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
