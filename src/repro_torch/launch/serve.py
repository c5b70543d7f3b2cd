"""Serving launcher of the port: init a model from a seed and serve prompts
through the continuous-batching scheduler on one device.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt-moe-s \
      --smoke --continuous --prompt "In the beginning " --steps 16

Prompts are byte-encoded (each byte a token).  The device is ``cuda``
unless ``--device cpu`` is given; with the default device and no GPU the
launcher fails.  Only ``--continuous`` serving is ported: several replicas
behind a publication bus, checkpoint restore and fixed-batch generation
raise "not yet ported".
"""
from __future__ import annotations

import argparse


def _encode(prompt: str, vocab: int):
    import numpy as np
    return np.frombuffer(prompt.encode(), np.uint8).astype(np.int32) % vocab


def serve_continuous(eng, prompts, *, steps: int, max_len: int,
                     temperature: float = 0.0, seed: int = 0):
    """Serve byte-encoded ``prompts`` through a ``RequestScheduler`` (page
    size 8, up to 4 slots); returns (scheduler stats, output traces)."""
    from repro_torch.serve.scheduler import DONE, RequestScheduler
    slots = min(len(prompts), 4)
    with RequestScheduler(eng, max_slots=slots,
                          num_pages=-(-max_len // 8) * slots + 1,
                          page_size=8, max_kv=max_len, default_ttl_s=600.0,
                          temperature=temperature, seed=seed) as rs:
        reqs = [rs.submit(_encode(p, eng.cfg.vocab_size),
                          max_new_tokens=steps) for p in prompts]
        rs.run()
        bad = [(r.state, r.finish_reason) for r in reqs if r.state != DONE]
        if bad:
            raise RuntimeError(f"requests did not finish: {bad}")
        return rs, [r.output() for r in reqs]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--prompt", action="append", default=None)
    ap.add_argument("--continuous", action="store_true",
                    help="serve through the paged-KV continuous-batching "
                         "scheduler (the only serving mode ported)")
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.replicas > 1:
        raise SystemExit("--replicas > 1 is not yet ported to repro_torch")
    if args.checkpoint_dir:
        raise SystemExit("--checkpoint-dir is not yet ported to repro_torch")
    if not args.continuous:
        raise SystemExit("fixed-batch Engine.generate serving is not yet "
                         "ported to repro_torch; pass --continuous")

    import torch

    import repro_torch.configs as configs
    from repro_torch.core import moe as moe_core
    from repro_torch.core.placement import (ep_materialization,
                                            homogeneous_sharding)
    from repro_torch.models import model as mdl
    from repro_torch.serve.engine import Engine

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to serve on the "
                         "CPU with the kernels' plain versions")
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get(args.arch))
    rt = mdl.Runtime()
    params = mdl.init_params(cfg, args.seed, device)
    pa = None
    if cfg.moe.enabled:
        # single-device plan: every expert local
        sh = homogeneous_sharding(moe_core.num_moe_layers(cfg),
                                  cfg.moe.num_experts, 1)
        pa = moe_core.plan_to_arrays(ep_materialization(sh), device)

    prompts = args.prompt or ["Hello world", "The scheduler said"]
    with Engine(cfg, rt, params, max_len=args.max_len, pa=pa) as eng:
        rs, out = serve_continuous(eng, prompts, steps=args.steps,
                                   max_len=args.max_len,
                                   temperature=args.temperature,
                                   seed=args.seed)
    print(f"continuous batching: {rs.decode_ticks} decode ticks for "
          f"{len(prompts)} requests")
    for i, toks in enumerate(out):
        text = bytes(int(t) for t in toks if 0 < t < 128).decode(
            errors="replace")
        print(f"[{i}] {text!r}")


if __name__ == "__main__":
    main()
