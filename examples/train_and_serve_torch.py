"""Training-while-serving in the PyTorch port: one process trains a tiny
byte-level MoE LM while a live decode engine serves completions from the
same parameters, refreshed through the engine's versioned publication
protocol; the counterpart of ``examples/train_and_serve.py``.

  PYTHONPATH=src python examples/train_and_serve_torch.py             # card
  PYTHONPATH=src python examples/train_and_serve_torch.py --steps 40 \\
      --device cpu                                                    # quick

The train loop publishes the optimizer-updated parameter tree into the
engine every ``--publish-every`` steps (``train_loop(publish_engine=,
publish_every=)``); the engine builds each new version's compute slots on
its background thread and swaps (params, slots, version) at decode-step
boundaries.  At the end the script checks bit-exact parity against a
fresh engine at the final published version, persists the (plan,
version, calibration) serving state next to the parameter checkpoint,
and restores both into a new engine.

With ``--replicas N`` the trainer publishes through a
``serve.bus.PublicationBus`` into an N-replica fleet, and the script
serves every healthy replica through the continuous-batching
``RequestScheduler`` and checks that the fleet decodes the same
completions.
"""
import argparse
import os
import tempfile

import numpy as np

import repro_torch.configs as configs
from repro_torch.checkpoint import store
from repro_torch.common.config import TrainConfig
from repro_torch.core import moe as moe_core
from repro_torch.data.pipeline import make_stream
from repro_torch.launch.inputs import make_runtime
from repro_torch.models.model import Runtime
from repro_torch.serve.engine import Engine
from repro_torch.train import step as step_lib
from repro_torch.train.trainer import HecateScheduler, train_loop

PROMPTS = ["In the beginning ", "The scheduler said"]


def encode(prompts):
    enc = np.zeros((len(prompts), max(len(p) for p in prompts)), np.int32)
    for i, p in enumerate(prompts):
        enc[i, :len(p)] = np.frombuffer(p.encode(), np.uint8)
    return enc


def show(tag, out):
    for i, row in enumerate(out):
        text = bytes(int(b) for b in row if 0 < b < 128).decode(
            errors="replace")
        print(f"  {tag}[{i}] {text!r}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=240)
    ap.add_argument("--publish-every", type=int, default=30)
    ap.add_argument("--sample-every", type=int, default=60)
    ap.add_argument("--decode-steps", type=int, default=32)
    ap.add_argument("--replicas", type=int, default=1,
                    help="publish into N engine replicas via a "
                         "PublicationBus (default: 1, engine direct)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = args.device

    cfg = configs.get_smoke("gpt-moe-s").replace(vocab_size=256)
    # training runs attention's plain version (the flash kernel has no
    # backward); the engines serve with the kernels
    train_rt, rt = make_runtime(cfg, None), Runtime()
    tc = TrainConfig(learning_rate=3e-3, warmup_steps=min(10, args.steps),
                     total_steps=args.steps)
    sched = HecateScheduler(cfg, ep=1, impl="ep", device=dev)
    pa = sched.plan_arrays()
    state = step_lib.init_state(cfg, 0, device=dev)
    stream = make_stream(256, seq_len=64, global_batch=8, kind="bytes")
    enc = encode(PROMPTS)

    # the LIVE engine: serves throughout training, receives publications
    # (with --replicas, the first of a fleet fed through a PublicationBus)
    bus, engines = None, []
    if args.replicas > 1:
        from repro_torch.serve.bus import PublicationBus
        engines = [Engine(cfg, rt, state.params, max_len=96, pa=pa,
                          name=f"replica-{i}")
                   for i in range(args.replicas)]
        bus = PublicationBus([(e.name, e) for e in engines])
        eng = engines[0]
    else:
        eng = Engine(cfg, rt, state.params, max_len=96, pa=pa)

    def cb(i, st_, metrics):
        if args.sample_every and i and i % args.sample_every == 0:
            # serve mid-training — the engine decodes at whatever version
            # the trainer last published (promoted at its step boundaries)
            out = eng.generate(enc, steps=args.decode_steps)
            print(f"-- live completions at train step {i} "
                  f"(engine version {eng.version}):")
            show("live", out)

    state, hist = train_loop(cfg, train_rt, tc, stream, scheduler=sched,
                             state=state, num_steps=args.steps,
                             log_every=max(args.steps // 6, 1),
                             callback=cb, publish_engine=bus or eng,
                             publish_every=args.publish_every, device=dev)
    if bus is not None:
        from repro_torch.serve.scheduler import DONE, RequestScheduler
        bus.flush()                   # broadcast + promote fleet-wide
        fleet = bus.route()           # healthy replicas, least-loaded first
        outs = []
        for e in fleet:
            # continuous batching per replica: each prompt at its TRUE
            # length (no padding tokens), retired when its request is done
            with RequestScheduler(e, max_slots=2, num_pages=25,
                                  page_size=8, max_kv=96) as rs:
                reqs = [rs.submit(
                    np.frombuffer(p.encode(), np.uint8).astype(np.int32),
                    max_new_tokens=args.decode_steps) for p in PROMPTS]
                rs.run()
                assert all(r.state == DONE for r in reqs)
                outs.append(np.concatenate([r.output() for r in reqs]))
        assert all((o == outs[0]).all() for o in outs[1:])
        print(f"fleet parity across {len(fleet)} replicas at version "
              f"{eng.version}: OK ({bus.dedup_hits} deduped builds, "
              f"{bus.replica_evictions} evictions)")
        bus.close()
        for e in engines[1:]:
            e.close()
    else:
        eng.flush()                   # promote the last publication
    print(f"trained {args.steps} steps; engine at version {eng.version} "
          f"({eng.publications} publications, {eng.promotions} promotions,"
          f" {eng.deferred_boundaries} deferred boundaries)")

    out_live = eng.generate(enc, steps=args.decode_steps)
    show("final", out_live)

    # parity: a fresh engine built at the published version decodes
    # bit-exactly what the long-lived published-into engine decodes
    with Engine(cfg, rt, eng.params, max_len=96, pa=eng.pa,
                version=eng.version) as fresh:
        out_fresh = fresh.generate(enc, steps=args.decode_steps)
    assert (out_live == out_fresh).all()
    print("parity vs fresh engine at published version: OK")

    # persist params + (plan, version, calibration) serving state, then
    # restore both into a new engine — the restarted server resumes at
    # the published version with the published plan
    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             "repro_torch_train_and_serve")
    last = eng.version
    store.save(ckpt_dir, last, {"params": eng.params})
    calib = ({"load_history": np.stack(sched.predictor.history)}
             if sched.predictor.history else None)
    store.save_serving_state(ckpt_dir, last, eng.pa, last, calib)
    eng.close()
    sched.close()

    restored = store.restore(ckpt_dir, last,
                             {"params": state.params})["params"]
    # restore the serving state PAIRED with the params step (a stale plan
    # from another step may describe a different row ownership)
    sstate = store.restore_serving_state(ckpt_dir, step=last)
    with Engine(cfg, rt, restored, max_len=96,
                pa=moe_core.tables_to_device(sstate["pa"], dev),
                version=sstate["version"]) as eng2:
        out_restored = eng2.generate(enc, steps=args.decode_steps)
    assert (out_restored == out_live).all()
    print(f"restored engine (version {sstate['version']}) decodes "
          f"identically: OK")


if __name__ == "__main__":
    main()
