"""Training launcher of the port: train a model from a seed on one device
through the Hecate loop (``train.trainer.train_loop``) with the ``ep``
plan.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt-moe-s \
      --steps 50 --data bytes

The device is ``cuda`` unless ``--device cpu`` is given (``--smoke
--device cpu`` trains the reduced model on the CPU with the kernels'
plain versions); with the default device and no GPU the launcher fails.
Attention runs its plain PyTorch version (the flash kernel has no
backward); the grouped expert FFN runs its CUDA kernels, forward, dgrad
and wgrad.  A mesh (``--mesh-data``), another plan than ``--impl ep``,
checkpointing and the elastic supervisor are not yet ported and are
refused.
"""
from __future__ import annotations

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--impl", default="ep",
                    choices=["ring", "a2a", "dense", "ep"],
                    help="materialization plan (only ep is ported)")
    ap.add_argument("--mesh-data", type=int, default=0,
                    help="0 = single device, no mesh (the only ported "
                         "layout)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--no-step-guard", action="store_true",
                    help="disable the non-finite loss/grad skip guard")
    ap.add_argument("--max-bad-steps", type=int, default=3,
                    help="consecutive skipped steps before abort")
    ap.add_argument("--elastic", action="store_true")
    ap.add_argument("--data", default="synthetic",
                    choices=["synthetic", "bytes"])
    ap.add_argument("--skew", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-json", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.mesh_data:
        raise SystemExit("--mesh-data (a device mesh) is not yet ported to "
                         "repro_torch; it trains on one device")
    if args.impl != "ep":
        raise SystemExit(f"--impl {args.impl} is not yet ported to "
                         f"repro_torch; pass --impl ep")
    if args.checkpoint_dir or args.checkpoint_every:
        raise SystemExit("--checkpoint-dir / --checkpoint-every are not yet "
                         "ported to repro_torch")
    if args.elastic:
        raise SystemExit("--elastic is not yet ported to repro_torch")

    import torch

    import repro_torch.configs as configs
    from repro_torch.common.config import TrainConfig
    from repro_torch.core.moe import MoERuntime
    from repro_torch.data.pipeline import make_stream
    from repro_torch.models import model as mdl
    from repro_torch.train.trainer import HecateScheduler, train_loop

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to train on the "
                         "CPU with the kernels' plain versions")
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get(args.arch))
    rt = mdl.Runtime(use_pallas=False, moe=MoERuntime(use_pallas=True))
    tc = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                     warmup_steps=max(args.steps // 10, 1), seed=args.seed,
                     microbatch=args.microbatch,
                     step_guard=not args.no_step_guard,
                     max_bad_steps=args.max_bad_steps)
    stream = make_stream(cfg.vocab_size, args.seq_len, args.global_batch,
                         kind=args.data, seed=args.seed, skew=args.skew)
    scheduler = None
    if cfg.moe.enabled:
        scheduler = HecateScheduler(cfg, ep=1, impl="ep",
                                    device=str(device))
    state, history = train_loop(cfg, rt, tc, stream, scheduler=scheduler,
                                num_steps=args.steps, device=device)
    if args.log_json:
        with open(args.log_json, "w") as f:
            json.dump(history, f)
    print(f"final loss: {history[-1]['loss']:.4f} "
          f"(start {history[0]['loss']:.4f})")
    return history


if __name__ == "__main__":
    main()
