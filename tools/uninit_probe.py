#!/usr/bin/env python3
"""Does a serving path read device memory it never wrote?  Runs
``chip_smoke.py``'s decode-after-prefill check of one config's f32 cut
(phase 11: a prefill at exact length handed to the paged cache, then 4
decode steps against the full forward) three times, each in its own
process, on memory prepared three ways:

* ``fresh``: as a process finds it;
* ``garbage``: the caching allocator first hands out and takes back
  ``--garbage-gb`` of memory filled with large random values, so later
  ``torch.empty`` tensors start from them (as after earlier phases);
* ``nan``: ``torch.utils.deterministic.fill_uninitialized_memory`` makes
  every ``torch.empty`` start as NaN.

A path that reads only what it wrote gives the same errors in all three.

    python3 tools/uninit_probe.py --arch jamba-v0.1-52b
"""
import argparse
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(arch: str, how: str, garbage_gb: float) -> None:
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    import chip_smoke as cs
    import repro_torch.configs as configs
    from repro_torch.models import model as mdl
    from repro_torch.serve.engine import (Engine, build_paged_serve_step,
                                          build_prefill_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    if how == "garbage":
        g = torch.empty(int(garbage_gb * 1e9) // 4, device=dev)
        g.uniform_(-1e4, 1e4)
        torch.cuda.synchronize()
        del g
    elif how == "nan":
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.utils.deterministic.fill_uninitialized_memory = True
    cfg = cs._f32_cut(configs.get(arch))
    params = mdl.init_params(cfg, 0, dev)
    pa = cs._plan(torch, cfg, dev) if cfg.moe.enabled else None
    prompt = cs._prompts(cfg.vocab_size)[1]
    run_p = build_prefill_step(cfg, mdl.Runtime())
    run_s = build_paged_serve_step(cfg, mdl.Runtime(), cs.PAGE_SIZE)
    with Engine(cfg, mdl.Runtime(), params, max_len=cs.MAX_LEN,
                pa=pa) as eng:
        p, pa_, premat = eng._snapshot()
        n, k0 = prompt.size, prompt.size - 4
        toks = torch.as_tensor(prompt, device=dev).to(torch.int32)[None]
        with torch.inference_mode():
            full, _ = mdl.forward(cfg, mdl.Runtime(), p, toks, pa=pa_,
                                  premat=premat)
        _, ck = run_p(p, {"tokens": toks[:, :k0]}, pa_, premat)
        cache, ri = cs._paged_cache_of(torch, cfg, dev, ck, k0)
        errs = []
        for i in range(k0, n):
            tk = torch.zeros((cs.MAX_SLOTS, 1), dtype=torch.int32,
                             device=dev)
            tk[0, 0] = toks[0, i]
            pos = torch.tensor([i, 0, 0, 0], dtype=torch.int32, device=dev)
            lg, cache = run_s(p, cache, tk, pos, ri, pa_, premat)
            errs.append(float((lg[0, 0] - full[0, i]).abs().max()))
    scale = float(full.abs().max())
    finite = all(math.isfinite(e) for e in errs) and math.isfinite(scale)
    print(f"{arch} f32 cut ({cfg.num_layers} layers), memory {how}: "
          f"|dlogit| per decode step {[f'{e:.3e}' for e in errs]}, max "
          f"|logit| {scale:.3f}, finite {finite}, within 1e-3 x max "
          f"{finite and max(errs) <= 1e-3 * scale}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="jamba-v0.1-52b")
    ap.add_argument("--garbage-gb", type=float, default=40.0)
    ap.add_argument("--how", default="")
    args = ap.parse_args()
    if args.how:
        return run(args.arch, args.how, args.garbage_gb)
    for how in ("fresh", "garbage", "nan"):
        subprocess.run([sys.executable, __file__, "--arch", args.arch,
                        "--how", how, "--garbage-gb", str(args.garbage_gb)],
                       check=False)


if __name__ == "__main__":
    main()
