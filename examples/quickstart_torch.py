"""Quickstart of the PyTorch port: train a small FSSDP MoE model through
the Hecate loop (the counterpart of ``examples/quickstart.py``).

  PYTHONPATH=src python examples/quickstart_torch.py                # card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu   # CPU
"""
import argparse

import repro_torch.configs as configs
from repro_torch.common.config import TrainConfig
from repro_torch.core.schedule import ReshardingPolicy
from repro_torch.data.pipeline import make_stream
from repro_torch.launch.inputs import make_runtime
from repro_torch.train.trainer import HecateScheduler, train_loop


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = configs.get_smoke("gpt-moe-s")
    print(f"model: {cfg.name} — {cfg.param_count()/1e6:.1f}M params, "
          f"{cfg.moe.num_experts} experts (top-{cfg.moe.experts_per_token})")
    tc = TrainConfig(learning_rate=3e-3, warmup_steps=5,
                     total_steps=args.steps)
    stream = make_stream(cfg.vocab_size, seq_len=64, global_batch=8,
                         kind="bytes")
    # The Hecate control loop: load prediction -> Algorithm 1 plans ->
    # FSSDP step -> feedback; Algorithm 2 re-shards every 20 steps.
    scheduler = HecateScheduler(cfg, ep=1, impl="ep", device=args.device,
                                resharding=ReshardingPolicy(interval=20))
    state, history = train_loop(cfg, make_runtime(cfg, None), tc,
                                stream, scheduler=scheduler,
                                num_steps=args.steps, log_every=5,
                                device=args.device)
    scheduler.close()
    print(f"\nloss: {history[0]['loss']:.3f} -> {history[-1]['loss']:.3f}")
    assert history[-1]["loss"] < history[0]["loss"]
    print("quickstart OK")


if __name__ == "__main__":
    main()
