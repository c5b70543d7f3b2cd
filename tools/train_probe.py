#!/usr/bin/env python3
"""Probe whether the training loop learns at a given depth, on one card.

    python3 tools/train_probe.py [--layers 12 4] [--perturb 0 1 2]
                                 [--other DIR] [--out FILE]

For each depth of gpt-moe-s at full width (bf16 compute, f32 master
weights from seed 0) it prints the gradient norm of every parameter at
the seeded init, then, for each perturbation seed p (0: none; else every
f32 master weight is multiplied by 1 + 1e-4 · N(0, 1) drawn from seed p,
a change at the scale of the bf16 rounding of the compute weights), runs
``chip_smoke.py``'s training loop for its 12 steps (batch 8 × seq 2,048
of the bytes stream from the batch after the one its determinism check
takes, AdamW lr 1e-3 with 3 warm-up steps) and prints the run's first
and last loss, and the cross-entropy of two fixed batches (the run's
first batch, and the batch after its last) before and after the run.
With ``--other DIR`` the bf16 training forward and dgrad are those of the
checkout at ``DIR`` (the FMA design, built and called as
``tools/grouped_mlp_ab.py`` does); B3 and the rest are this tree's.  The
last line is one JSON object with every number.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import chip_smoke as cs  # noqa: E402


def other_kernels(torch, other: str):
    """(fwd_train, dgrad) with this tree's wrapper signatures over the
    FMA design's C entry points of the tree at ``other`` (bf16, no gate,
    GELU: what the gpt-moe-s training path calls)."""
    import grouped_mlp_ab as ab
    fwd_c = ab.build_other(other, "grouped_mlp")
    dgrad_c = ab.build_other(other, "grouped_mlp_bwd")

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def fwd_train(x, wi, wg, wo, mask, *, act, tiles=None):
        if wg is not None or act != "gelu" or x.dtype != torch.bfloat16:
            raise ValueError("the probe's other kernels take bf16 GELU")
        k_, t_, d = x.shape
        f_ = wi.shape[-1]
        mask, x = mask.to(torch.int32).contiguous(), x.contiguous()
        y = torch.empty_like(x)
        h1 = torch.empty((k_, t_, f_), dtype=x.dtype, device=x.device)
        code = fwd_c(x.data_ptr(), wi.data_ptr(), None, wo.data_ptr(),
                     mask.data_ptr(), y.data_ptr(), h1.data_ptr(), None, k_,
                     t_, d, f_, wi.stride(0), 0, wo.stride(0), 0, 1,
                     stream())
        if code:
            raise RuntimeError(f"grouped_mlp_fwd_train: CUDA error {code}")
        return y, h1, None

    def dgrad(dy, mask, h1, h2, wi, wg, wo, *, act, tiles=None):
        k_, t_, d = dy.shape
        f_ = wi.shape[-1]
        mask = mask.to(torch.int32).contiguous()
        dy, h1 = dy.contiguous(), h1.contiguous()
        wo_t = wo.transpose(1, 2).contiguous()
        wi_t = wi.transpose(1, 2).contiguous()
        dx, dh1, h = (torch.empty_like(a) for a in (dy, h1, h1))
        code = dgrad_c(dy.data_ptr(), wo_t.data_ptr(), wi_t.data_ptr(), None,
                       mask.data_ptr(), h1.data_ptr(), None, dx.data_ptr(),
                       dh1.data_ptr(), None, h.data_ptr(), k_, t_, d, f_, 0,
                       1, stream())
        if code:
            raise RuntimeError(f"grouped_mlp_dgrad: CUDA error {code}")
        return dx, dh1, None, h
    return fwd_train, dgrad


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[12, 4])
    ap.add_argument("--perturb", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--other", default="",
                    help="root of a checkout whose bf16 B1-train and B2 "
                         "to use")
    ap.add_argument("--out", default="", help="also write the JSON here")
    args = ap.parse_args()
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    import repro_torch.configs as configs
    from repro_torch.common.params import _leaves
    from repro_torch.kernels import grouped_mlp as gm
    from repro_torch.models import model as mdl
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_lib
    from repro_torch.train.trainer import HecateScheduler, train_loop
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    if args.other:
        gm.grouped_mlp_fwd_train, gm.grouped_mlp_dgrad = other_kernels(
            torch, args.other)
    kernels = "other: " + args.other if args.other else "this tree's"
    res = {"device": card, "kernels": kernels, "depths": []}
    for n in args.layers:
        cfg = configs.get("gpt-moe-s").replace(num_layers=n)
        rt, tc, stream = cs._train_setup(torch, dev, cfg)
        pa = cs._plan(torch, cfg, dev)
        batches = [{k: torch.as_tensor(v, device=dev)
                    for k, v in stream.next_batch().items()}
                   for _ in range(cs.TRAIN_STEPS + 2)]
        fixed = (batches[1], batches[-1])     # the run's first, one after

        def xent(params, b):
            with torch.no_grad():
                return float(step_lib.loss_fn(cfg, rt, params, b, pa)[1]
                             ["xent"])
        params = mdl.init_params(cfg, 0, dev)
        _, grads = step_lib.loss_and_grads(cfg, rt, params, batches[1], pa)
        norms = {"/".join(p): float(g.float().norm())
                 for p, g in _leaves(grads)}
        total = sum(v * v for v in norms.values()) ** 0.5
        print(f"  [{card}] {n} layers, {kernels} kernels: gradient norm at "
              f"the seeded init {total:.4e}; per parameter "
              f"{ {k: float(f'{v:.3e}') for k, v in norms.items()} }")
        del params, grads
        runs = []
        for p in args.perturb:
            state = step_lib.init_state(cfg, 0, device=dev)
            if p:
                g = torch.Generator(device=dev).manual_seed(p)
                for t in adamw.leaves(state.params):
                    t.mul_(1 + 1e-4 * torch.randn(t.shape, generator=g,
                                                  device=dev, dtype=t.dtype))
            before = [xent(state.params, b) for b in fixed]
            run_stream = cs._train_setup(torch, dev, cfg)[2]
            run_stream.next_batch()           # as chip_smoke.py's run
            state, hist = train_loop(
                cfg, rt, tc, run_stream,
                scheduler=HecateScheduler(cfg, ep=1, impl="ep",
                                          device=str(dev)),
                state=state, num_steps=cs.TRAIN_STEPS, log_every=0,
                device=dev)
            after = [xent(state.params, b) for b in fixed]
            losses = [h["loss"] for h in hist]
            print(f"    perturbation {p}: loss {losses[0]:.4f} -> "
                  f"{losses[-1]:.4f} ({losses[-1] - losses[0]:+.4f}); "
                  f"xent of the first batch {before[0]:.4f} -> "
                  f"{after[0]:.4f} ({after[0] - before[0]:+.4f}), of a "
                  f"later batch {before[1]:.4f} -> {after[1]:.4f} "
                  f"({after[1] - before[1]:+.4f})", flush=True)
            runs.append(dict(perturb=p, losses=losses, xent_before=before,
                             xent_after=after))
            del state
            torch.cuda.empty_cache()
        res["depths"].append(dict(layers=n, grad_norm=total,
                                  grad_norms=norms, runs=runs))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
