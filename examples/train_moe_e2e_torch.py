"""End-to-end driver of the PyTorch port: train a ~100M-parameter MoE LM
for a few hundred steps with the Hecate/FSSDP stack (scheduler,
re-sharding, checkpointing), the counterpart of
``examples/train_moe_e2e.py``.

  PYTHONPATH=src python examples/train_moe_e2e_torch.py               # card
  PYTHONPATH=src python examples/train_moe_e2e_torch.py --steps 10 \\
      --device cpu                                                    # quick
"""
import argparse
import os
import tempfile
import time

import numpy as np

from repro_torch.checkpoint import store
from repro_torch.common.config import ModelConfig, MoEConfig, TrainConfig
from repro_torch.core.schedule import ReshardingPolicy
from repro_torch.data.pipeline import make_stream
from repro_torch.launch.inputs import make_runtime
from repro_torch.train.trainer import HecateScheduler, train_loop


def model_100m() -> ModelConfig:
    """~100M-param fine-grained MoE (olmoe-style family, reduced)."""
    return ModelConfig(
        name="moe-100m", arch_type="moe", num_layers=8, d_model=512,
        num_heads=8, num_kv_heads=4, head_dim=64, d_ff=1024,
        vocab_size=32_000,
        moe=MoEConfig(num_experts=16, experts_per_token=4, d_ff=1024,
                      slots_per_device=2),
        act="silu_glu", norm="rms", tie_embeddings=True,
        dtype="float32", remat=False)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_e2e_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = model_100m()
    print(f"{cfg.name}: {cfg.param_count()/1e6:.0f}M params "
          f"({cfg.active_param_count()/1e6:.0f}M active/token)")
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=min(20, args.steps),
                     total_steps=args.steps)
    stream = make_stream(cfg.vocab_size, args.seq_len, args.global_batch,
                         kind="bytes", seed=0)
    sched = HecateScheduler(cfg, ep=1, impl="ep", device=args.device,
                            resharding=ReshardingPolicy(interval=100))
    t0 = time.time()

    def cb(i, state, metrics):
        if i and i % 100 == 0:
            store.save(args.ckpt_dir, i, {"params": state.params})

    state, hist = train_loop(cfg, make_runtime(cfg, None), tc,
                             stream, scheduler=sched, num_steps=args.steps,
                             log_every=10, callback=cb, device=args.device)
    sched.close()
    store.save(args.ckpt_dir, args.steps, {"params": state.params})
    dt = time.time() - t0
    toks = args.steps * args.global_batch * args.seq_len
    first = np.mean([h["xent"] for h in hist[:10]])
    last = np.mean([h["xent"] for h in hist[-10:]])
    print(f"\n{args.steps} steps in {dt/60:.1f} min "
          f"({toks/dt:.0f} tokens/s, {args.device})")
    print(f"xent: {first:.3f} -> {last:.3f}")
    print(f"checkpoint: {store.latest_step(args.ckpt_dir)}")


if __name__ == "__main__":
    main()
