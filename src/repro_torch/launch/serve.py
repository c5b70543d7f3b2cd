"""Serving launcher of the port: init a model from a seed and serve prompts
on one device, through the continuous-batching scheduler
(``--continuous``) or the fixed-batch ``Engine.generate``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt-moe-s \
      --smoke --continuous --prompt "In the beginning " --steps 16

Prompts are byte-encoded (each byte a token); the fixed batch pads them
with zeros to the longest.  An encoder-decoder (``--arch whisper-medium``)
decodes against a seeded standard-normal stand-in for its stub frontend's
frames, (prompts, encoder_seq_len, d_model), as the JAX launcher's, and
has no ``--continuous`` path.  ``--replicas N`` serves from N engines behind
a ``PublicationBus``, which broadcasts the parameters once before serving.
The device is ``cuda`` unless ``--device cpu`` is given; with the default
device and no GPU the launcher fails.  ``--checkpoint-dir DIR`` serves
the parameters of the newest intact checkpoint in DIR (the training
loop's or the JAX package's) with the serving state saved beside that
step: its plan tables, and its version, at which the engine starts
(``restore_for_serving``); ``--no-serve-state`` ignores that state and
serves the restored parameters with a fresh plan at version 0.
"""
from __future__ import annotations

import argparse


def _encode(prompt: str, vocab: int):
    import numpy as np
    return np.frombuffer(prompt.encode(), np.uint8).astype(np.int32) % vocab


def restore_for_serving(cfg, checkpoint_dir: str, device, params=None,
                        serve_state: bool = True):
    """(params, plan tables or None, version, step) from the newest intact
    checkpoint in ``checkpoint_dir``, as the JAX launcher restores them:
    the parameters go straight onto ``device``; the serving state must be
    the one of the same step (plan tables of another step describe
    another row ownership), and one from an EP > 1 run keeps only its
    version, since a single device decodes with a local plan.  Without
    ``serve_state`` the persisted (plan, version) is ignored: no tables,
    version 0.  With no checkpoint: ``params`` as given, no tables,
    version 0, step None."""
    from repro_torch.checkpoint import store
    from repro_torch.core import moe as moe_core
    from repro_torch.train.trainer import state_spec

    pa, version = None, 0
    step = store.latest_step(checkpoint_dir, verify=True)
    if step is not None:
        target = {"params": state_spec(cfg, 1).params}
        params = store.restore(checkpoint_dir, step, target, device=device,
                               checked=True)["params"]
        print(f"restored checkpoint step {step}")
    if step is not None and serve_state:
        ss = store.restore_serving_state(checkpoint_dir, step=step)
        if ss is None and store.latest_serving_step(checkpoint_dir) \
                is not None:
            print(f"serving state has no step {step} (params step); "
                  f"ignoring serving state")
        if ss is not None and int(ss["pa"].owner_dev.max()) > 0:
            print("serving state is from an EP > 1 run; single-device "
                  "decode rebuilds a local plan instead")
            version, ss = ss["version"], None
        if ss is not None:
            pa = moe_core.tables_to_device(ss["pa"], device)
            version = ss["version"]
            print(f"restored serving state: step {ss['step']}, version "
                  f"{version}")
    return params, pa, version, step


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
    ap.add_argument("--no-serve-state", action="store_true",
                    help="ignore persisted (plan, version) serving state")
    ap.add_argument("--prompt", action="append", default=None)
    ap.add_argument("--continuous", action="store_true",
                    help="serve through the paged-KV continuous-batching "
                         "scheduler instead of Engine.generate")
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
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
    params, pa, version = None, None, 0
    if args.checkpoint_dir:
        params, pa, version, _ = restore_for_serving(
            cfg, args.checkpoint_dir, device,
            serve_state=not args.no_serve_state)
    if params is None:
        params = mdl.init_params(cfg, args.seed, device)
    if cfg.moe.enabled and pa is None:
        # single-device plan: every expert local
        sh = homogeneous_sharding(moe_core.num_moe_layers(cfg),
                                  cfg.moe.num_experts, 1)
        pa = moe_core.plan_to_arrays(ep_materialization(sh), device)

    prompts = args.prompt or ["Hello world", "The scheduler said"]
    enc = [_encode(p, cfg.vocab_size) for p in prompts]
    batch = np.zeros((len(enc), max(e.size for e in enc)), np.int32)
    for i, e in enumerate(enc):
        batch[i, :e.size] = e
    enc_in = None
    if cfg.is_encoder_decoder:
        if args.continuous:
            raise SystemExit("--continuous requires a decoder-only arch "
                             "(the paged KV pool has no encoder "
                             "cross-attention cache)")
        enc_in = np.random.default_rng(0).standard_normal(
            (len(prompts), cfg.encoder_seq_len, cfg.d_model)).astype(
            np.float32)

    def serve(eng):
        if args.continuous:
            rs, out = serve_continuous(eng, prompts, steps=args.steps,
                                       max_len=args.max_len,
                                       temperature=args.temperature,
                                       seed=args.seed)
            print(f"continuous batching: {rs.decode_ticks} decode ticks "
                  f"for {len(prompts)} requests")
            return out
        out = eng.generate(batch, steps=args.steps,
                           temperature=args.temperature, seed=args.seed,
                           encoder_input=enc_in)
        print(f"fixed batch: {len(prompts)} prompts padded to "
              f"{batch.shape[1]} tokens, {args.steps} new tokens each")
        return out

    if args.replicas <= 1:
        with Engine(cfg, rt, params, max_len=args.max_len, pa=pa,
                    version=version) as eng:
            out = serve(eng)
    else:
        from repro_torch.serve.bus import PublicationBus
        engines = [Engine(cfg, rt, params, max_len=args.max_len, pa=pa,
                          version=version, name=f"replica-{i}")
                   for i in range(args.replicas)]
        bus = PublicationBus([(e.name, e) for e in engines])
        try:
            # the fleet promotes one bus-published version before serving
            bus.publish_params(params, version=version + 1, pa=pa,
                               wait=True)
            fleet = bus.route()     # healthy replicas, least loaded first
            if not fleet:
                raise SystemExit("no healthy replicas after broadcast")
            out = serve(fleet[0])
            for name, st in sorted(bus.poll().items()):
                print(f"replica {name}: {st.state.lower()} "
                      f"version {st.version}")
            print(f"fleet: {len(fleet)}/{args.replicas} healthy")
        finally:
            bus.close()
            for e in engines:
                e.close()
    for i, toks in enumerate(out):
        text = bytes(int(t) for t in toks if 0 < t < 128).decode(
            errors="replace")
        print(f"[{i}] {text!r}")


if __name__ == "__main__":
    main()
