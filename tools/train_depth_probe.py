#!/usr/bin/env python3
"""How deep a configuration trains on one card: the memory peak of its
training loop at full width, for each of a few depth cuts.

    python3 tools/train_depth_probe.py --arch minitron-8b --layers 4,5,6 \
        [--batch 8] [--seq 2048]

For each depth (in whole superblocks of the config's layer pattern) it
builds the config cut to that many layers (bf16 compute, f32 master
weights and AdamW moments from seed 0), runs two steps of
``train.trainer.train_loop`` on batch x seq of the bytes stream (the
``ep`` plan for an MoE config; stand-in embeddings for a frontend stub)
and prints the step times and ``torch.cuda.max_memory_allocated()``, or
that the card ran out of memory.  ``chip_smoke.py`` phase 11 trains each
configuration at the deepest cut whose peak this prints under 78 GB.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import gc
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def probe(arch: str, layers: int, batch: int, seq: int) -> str:
    import torch

    import repro_torch.configs as configs
    from repro_torch.common.config import TrainConfig
    from repro_torch.core.moe import MoERuntime
    from repro_torch.data.pipeline import EmbedStubStream, make_stream
    from repro_torch.models import model as mdl
    from repro_torch.train import step as step_lib
    from repro_torch.train.trainer import HecateScheduler, train_loop

    dev = torch.device("cuda")
    cfg = configs.get(arch).replace(num_layers=layers)
    rt = mdl.Runtime(use_pallas=False, moe=MoERuntime(use_pallas=True))
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=2)
    stream = make_stream(cfg.vocab_size, seq, batch, kind="bytes", seed=0)
    if cfg.frontend is not None:
        stream = EmbedStubStream(stream, cfg.d_model)
    torch.cuda.reset_peak_memory_stats()
    try:
        sched = (HecateScheduler(cfg, ep=1, impl="ep", device="cuda")
                 if cfg.moe.enabled else None)
        state = step_lib.init_state(cfg, 0, device=dev)
        t = time.perf_counter()
        state, hist = train_loop(cfg, rt, tc, stream, scheduler=sched,
                                 state=state, num_steps=2, log_every=0,
                                 device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        out = (f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB, "
               f"steps {[round(h['time_s'] * 1e3, 1) for h in hist]} ms, "
               f"losses {[round(h['loss'], 4) for h in hist]}, "
               f"{wall:.1f} s")
        del state, hist
    except torch.OutOfMemoryError:
        out = (f"out of memory (peak so far "
               f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB)")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--layers", required=True,
                    help="comma-separated depths, whole superblocks each")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=2048)
    args = ap.parse_args()
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import subprocess

    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this probe measures a card's memory")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    for n in (int(x) for x in args.layers.split(",")):
        print(f"[{card}] {args.arch} {n} layers, batch {args.batch} x seq "
              f"{args.seq}: {probe(args.arch, n, args.batch, args.seq)}",
              flush=True)


if __name__ == "__main__":
    main()
