"""Serving example of the PyTorch port: train a tiny byte-level LM
briefly, then serve a batch of UNPADDED mixed-length prompts through the
continuous-batching request scheduler (paged KV cache, one-shot prefill,
per-request completion); the counterpart of ``examples/serve_decode.py``.

  PYTHONPATH=src python examples/serve_decode_torch.py                # card
  PYTHONPATH=src python examples/serve_decode_torch.py --device cpu   # CPU
"""
import argparse

import numpy as np

import repro_torch.configs as configs
from repro_torch.common.config import TrainConfig
from repro_torch.data.pipeline import make_stream
from repro_torch.launch.inputs import make_runtime
from repro_torch.models.model import Runtime
from repro_torch.serve.engine import Engine
from repro_torch.serve.scheduler import DONE, RequestScheduler
from repro_torch.train.trainer import train_loop


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--new-tokens", type=int, default=48)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = configs.get_smoke("smollm-360m").replace(vocab_size=256)
    tc = TrainConfig(learning_rate=3e-3, warmup_steps=min(10, args.steps),
                     total_steps=args.steps)
    stream = make_stream(256, seq_len=64, global_batch=8, kind="bytes")
    # training runs attention's plain version (the flash kernel has no
    # backward); serving takes the kernels
    state, hist = train_loop(cfg, make_runtime(cfg, None), tc,
                             stream, num_steps=args.steps, log_every=30,
                             device=args.device)

    prompts = ["In the beginning ", "The scheduler said", "Tokens moved "]
    eng = Engine(cfg, Runtime(), state.params, max_len=96)
    # each prompt keeps its TRUE length — the scheduler batches mixed
    # lengths through per-sequence page tables, no padding tokens decoded
    with RequestScheduler(eng, max_slots=4, num_pages=37, page_size=8,
                          max_kv=96, default_ttl_s=300.0) as rs:
        reqs = [rs.submit(np.frombuffer(p.encode(), np.uint8).astype(
            np.int32), max_new_tokens=args.new_tokens) for p in prompts]
        rs.run()
        print("\n--- greedy completions (byte-level) ---")
        for i, (p, r) in enumerate(zip(prompts, reqs)):
            assert r.state == DONE, (r.state, r.finish_reason)
            text = bytes(int(b) for b in r.output() if 0 < b < 128).decode(
                errors="replace")
            print(f"[{i}] {text!r}")
        print(f"({rs.decode_ticks} batched decode ticks for "
              f"{sum(len(r.output()) for r in reqs)} tokens)")
    eng.close()


if __name__ == "__main__":
    main()
