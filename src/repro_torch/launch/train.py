"""Training launcher of the port: train a model from a seed through the
Hecate loop (``train.trainer.train_loop``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt-moe-s \
      --steps 50 --data bytes

The device is ``cuda`` unless ``--device cpu`` is given (``--smoke
--device cpu`` trains the reduced model on the CPU with the kernels'
plain versions); with the default device and no GPU the launcher fails.
Attention runs its plain PyTorch version (the flash kernel has no
backward); the grouped expert FFN runs its CUDA kernels, forward, dgrad
and wgrad.

With ``--mesh-data D --mesh-model M`` or an Algorithm 1 plan (``--impl
ring | a2a | dense``) it trains on a D × M process grid of FSSDP ranks,
``nccl`` on the card and ``gloo`` with ``--device cpu``: either started
here (``--spawn``: D·M processes of this machine, ``FileStore``
rendezvous) or one process per rank under ``python -m
torch.distributed.run --nproc-per-node D·M -m repro_torch.launch.train
...``.  Rank 0 prints the losses.  On a grid the MoE layers follow the
config's ``moe.rematerialize`` mode (``save`` by default: the
one-layer-ahead SparseAllGather prefetch), ``--microbatch n`` builds
every layer's slots once per step for the n microbatches, and the
scheduler plans ahead, calibrates and re-shards every
``--resharding-interval`` steps (Algorithm 2, for the ``ring`` and
``a2a`` plans).

An encoder-decoder (``--arch whisper-medium``) trains on
``data.pipeline.EncoderStubStream``: seeded stand-in frames for its stub
frontend beside the token stream; its ``--seq-len`` may not pass the
decoder's cap (``max_decoder_len``, 448), which is also the default where
it is below 128.

``--checkpoint-dir DIR --checkpoint-every N`` checkpoints the whole
training state every N steps (atomic, checksummed, the newest
``--keep-checkpoints`` kept, and a final save at the end) and resumes from
the newest intact checkpoint in DIR unless ``--no-resume``; on a grid
rank 0 writes global arrays.  ``--elastic`` (needs ``--checkpoint-dir``)
attaches the elastic supervisor: a declared device loss shrinks the grid
in-process to the surviving EP ranks (roll back and replay), a cleared
fault grows it back at a checkpoint boundary, and stragglers are
de-weighted at the next reshard.
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
    ap.add_argument("--seq-len", type=int, default=None,
                    help="decoder tokens per row (default 128, or an "
                         "encoder-decoder's cap where lower)")
    ap.add_argument("--impl", default="ep",
                    choices=["ring", "a2a", "dense", "ep"],
                    help="materialization plan")
    ap.add_argument("--mesh-data", type=int, default=0,
                    help="data ranks of the process grid (0 = one "
                         "process, no grid)")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="expert-parallel ranks of the process grid")
    ap.add_argument("--spawn", action="store_true",
                    help="start the grid's ranks on this machine")
    ap.add_argument("--spawn-timeout", type=float, default=3600.0,
                    help="seconds before --spawn kills every rank")
    ap.add_argument("--spawn-dir", default="",
                    help="directory of --spawn's rendezvous and results "
                         "(default: a temporary one)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--resharding-interval", type=int, default=100)
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="crash-safe periodic checkpointing interval "
                         "(atomic + checksummed; 0 = final save only)")
    ap.add_argument("--keep-checkpoints", type=int, default=3,
                    help="keep-last retention for store.gc")
    ap.add_argument("--no-resume", action="store_true",
                    help="do not auto-resume from the newest intact "
                         "checkpoint in --checkpoint-dir")
    ap.add_argument("--no-step-guard", action="store_true",
                    help="disable the non-finite loss/grad skip guard")
    ap.add_argument("--max-bad-steps", type=int, default=3,
                    help="consecutive skipped steps before abort with "
                         "rollback to the last intact checkpoint")
    ap.add_argument("--elastic", action="store_true",
                    help="attach the elastic recovery supervisor "
                         "(needs --checkpoint-dir)")
    ap.add_argument("--data", default="synthetic",
                    choices=["synthetic", "bytes"])
    ap.add_argument("--skew", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-json", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.elastic and not args.checkpoint_dir:
        ap.error("--elastic needs --checkpoint-dir (the shrink path rolls "
                 "back to the newest intact checkpoint)")

    grid = (max(args.mesh_data, 1), args.mesh_model)
    if args.mesh_data or args.mesh_model > 1 or args.impl != "ep":
        return _launch_grid(args, grid)
    return _train(args, None)


def _launch_grid(args, grid):
    """The multi-rank launch: ``--spawn`` starts the ranks here; under
    ``torch.distributed.run`` this process is one of them."""
    from repro_torch.launch import distributed
    if args.spawn:
        import tempfile
        with tempfile.TemporaryDirectory() as tmp:
            return distributed.spawn(_rank_main, grid, args.device,
                                     workdir=args.spawn_dir or tmp,
                                     args=(args,),
                                     timeout=args.spawn_timeout)[0]
    if not distributed.maybe_initialize(args.device):
        raise SystemExit(
            f"a {grid[0]} x {grid[1]} grid with --impl {args.impl} runs one "
            f"process per rank: pass --spawn, or launch under python -m "
            f"torch.distributed.run")
    from repro_torch.launch.mesh import make_grid
    return _rank_main(make_grid(*grid), args)


def _rank_main(grid, args):
    return _train(args, grid)


def _train(args, grid):
    import torch

    import repro_torch.configs as configs
    from repro_torch.common.config import TrainConfig
    from repro_torch.core.moe import MoERuntime
    from repro_torch.core.schedule import ReshardingPolicy
    from repro_torch.data.pipeline import (EmbedStubStream,
                                           EncoderStubStream, make_stream)
    from repro_torch.models import model as mdl
    from repro_torch.train.supervisor import TrainSupervisor
    from repro_torch.train.trainer import (HecateScheduler, save_train_state,
                                           train_loop)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to train on the "
                         "CPU with the kernels' plain versions")
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get(args.arch))
    cap = cfg.max_decoder_len
    if args.seq_len is None:
        args.seq_len = min(128, cap) if cap else 128
    elif cap and args.seq_len > cap:
        raise SystemExit(f"--seq-len {args.seq_len}: {cfg.name}'s decoder "
                         f"is capped at {cap} tokens")
    impl = {"ep": "none"}.get(args.impl, args.impl)

    def runtime(g):
        return mdl.Runtime(use_pallas=False, moe=MoERuntime(
            use_pallas=True, grid=g, impl=impl))
    rt = runtime(grid)
    tc = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                     warmup_steps=max(args.steps // 10, 1), seed=args.seed,
                     microbatch=args.microbatch,
                     step_guard=not args.no_step_guard,
                     max_bad_steps=args.max_bad_steps,
                     checkpoint_dir=args.checkpoint_dir,
                     checkpoint_every=args.checkpoint_every,
                     keep_checkpoints=args.keep_checkpoints,
                     auto_resume=not args.no_resume)
    stream = make_stream(cfg.vocab_size, args.seq_len, args.global_batch,
                         kind=args.data, seed=args.seed, skew=args.skew)
    # stand-in frontend embeddings: an encoder-decoder's frames, or the
    # decoder's own input embeddings
    if cfg.is_encoder_decoder:
        stream = EncoderStubStream(stream, cfg.encoder_seq_len, cfg.d_model,
                                   seed=args.seed)
    elif cfg.frontend is not None:
        stream = EmbedStubStream(stream, cfg.d_model, seed=args.seed)
    scheduler = None
    if cfg.moe.enabled:
        scheduler = HecateScheduler(
            cfg, ep=grid.model if grid else 1, impl=args.impl,
            device=str(device),
            resharding=ReshardingPolicy(interval=args.resharding_interval))
    supervisor = None
    if args.elastic:
        ep = grid.model if grid else 1
        sup = TrainSupervisor(
            ep=ep,
            # without a grid there is nothing to shrink
            runtime_factory=lambda e: runtime(sup.grid_for(e)) if grid
            else rt)
        supervisor = sup
    rank0 = grid is None or grid.rank == 0
    state, history = train_loop(cfg, rt, tc, stream, scheduler=scheduler,
                                num_steps=args.steps, device=device,
                                log_every=10 if rank0 else 0,
                                supervisor=supervisor)
    if args.checkpoint_dir and state is not None:
        save_train_state(tc, int(state.step), state, scheduler,
                         supervisor.grid_for(supervisor.ep)
                         if supervisor and grid else grid)
    if rank0:
        if args.log_json:
            with open(args.log_json, "w") as f:
                json.dump(history, f)
        print(f"final loss: {history[-1]['loss']:.4f} "
              f"(start {history[0]['loss']:.4f})", flush=True)
    return history


if __name__ == "__main__":
    main()
