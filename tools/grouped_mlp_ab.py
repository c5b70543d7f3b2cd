#!/usr/bin/env python3
"""Time two versions of the grouped-MLP kernels on one card, in turns.

    python3 tools/grouped_mlp_ab.py --other DIR [--out FILE]

DIR is another checkout of this repository, for example a commit unpacked
with ``git archive`` into a git-ignored directory.  The script imports that
tree's ``repro_torch.kernels.grouped_mlp`` under its own package objects
(this tree's modules are put back afterwards), so each version runs through
its own wrappers, builds its own CUDA sources with its own flags into its
own build directory, and pays for what its wrapper does on every call
(a tile list, transposed weight copies, partial-sum planes).  Where a
wrapper takes the shared tile list (``tiles=``), it is given, as the
training path hands it to every stage; the list is timed on its own.

Cases, bf16, GELU: the training forward (B1-train), dgrad (B2) and wgrad
(B3) at the shapes of ``chip_smoke.py``'s training check (64 slots of
capacity 16,384, 32,768 valid rows as a prefix of each slot, D 768, F
1,536), and the inference form (B1) at its decode tick (64 slots of 4
rows, one valid row in each of 8 slots) and at a 512-bucket prefill (64
slots of 512 rows, 1,024 valid rows).  Each version is held to the plain
PyTorch version (training stages on the first 8 slots), then timed in the
order other, this, this, other (CUDA events, median of 15, L2 flushed
before each call).  It prints the card, one line per case with both
versions' times and TFLOP/s and, as its last line, one JSON object with
every time.  Needs one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import importlib
import inspect
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402


def _port_modules():
    return [n for n in sys.modules
            if n == "repro_torch" or n.startswith("repro_torch.")]


def load_other(other: str):
    """The other checkout's ``repro_torch.kernels.grouped_mlp``, imported
    beside this tree's (which must be imported already)."""
    mine = {n: sys.modules.pop(n) for n in _port_modules()}
    sys.path.insert(0, os.path.join(os.path.abspath(other), "src"))
    try:
        return importlib.import_module("repro_torch.kernels.grouped_mlp")
    finally:
        sys.path.pop(0)
        for n in _port_modules():
            del sys.modules[n]
        sys.modules.update(mine)


def _call(fn, *args, tiles=None, **kw):
    """``fn(*args, **kw)``, with ``tiles=`` where the wrapper takes it."""
    if tiles is not None and "tiles" in inspect.signature(fn).parameters:
        kw["tiles"] = tiles
    return fn(*args, **kw)


def _train_cases(torch, gms, ref, dev):
    """B1-train, B2 and B3 at the training shapes: {name: (fns, plain,
    operations, rows compared only where valid)}."""
    K, T, D, Fd = 64, cs.TRAIN_BATCH * cs.TRAIN_SEQ, 768, 1536
    rows = 2 * T
    g = torch.Generator(device=dev).manual_seed(4)
    cnt = torch.bincount(torch.randint(0, K, (rows,), generator=g,
                                       device=dev), minlength=K)
    mask = (torch.arange(T, device=dev)[None, :] < cnt[:, None]) \
        .to(torch.int32)

    def rnd(shp, sc):
        return torch.randn(shp, generator=g, device=dev).mul_(sc) \
            .to(torch.bfloat16)
    x, dy = rnd((K, T, D), 0.3), rnd((K, T, D), 0.1)
    wi, wo = rnd((K, D, Fd), 0.05), rnd((K, Fd, D), 0.05)
    this = gms["this"]
    tiles = this.tile_list(mask)
    _, h1, _ = this.grouped_mlp_fwd_train(x, wi, None, wo, mask, act="gelu",
                                          tiles=tiles)
    _, dh1, _, h = this.grouped_mlp_dgrad(dy, mask, h1, None, wi, None, wo,
                                          act="gelu", tiles=tiles)
    s = slice(0, 8)
    ops2 = 2 * 2 * rows * D * Fd         # each function's two products
    cases = {
        "grouped_mlp_fwd_train": (
            {w: (lambda m=m: _call(m.grouped_mlp_fwd_train, x, wi, None, wo,
                                   mask, act="gelu", tiles=tiles)[:2])
             for w, m in gms.items()},
            ref.grouped_mlp_fwd_train_ref(x[s], wi[s], None, wo[s], mask[s],
                                          act="gelu")[:2], ops2, (1,)),
        "grouped_mlp_dgrad": (
            {w: (lambda m=m: [a for a in _call(
                m.grouped_mlp_dgrad, dy, mask, h1, None, wi, None, wo,
                act="gelu", tiles=tiles) if a is not None])
             for w, m in gms.items()},
            [a for a in ref.grouped_mlp_dgrad_ref(
                dy[s], mask[s], h1[s], None, wi[s], None, wo[s], act="gelu")
             if a is not None], ops2, ()),
        "grouped_mlp_wgrad": (
            {w: (lambda m=m: [a for a in _call(
                m.grouped_mlp_wgrad, x, dy, mask, dh1, None, h, tiles=tiles)
                if a is not None]) for w, m in gms.items()},
            [a for a in ref.grouped_mlp_wgrad_ref(x[s], dy[s], mask[s],
                                                  dh1[s], None, h[s])
             if a is not None], ops2, ()),
    }
    return cases, mask, tiles


def _inference_cases(torch, gms, ref, dev):
    """B1's inference form at the decode tick and at a 512-bucket
    prefill, with ``chip_smoke.py``'s timing inputs."""
    K, D, Fd = 64, 768, 1536
    g = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for tag, T in (("decode", cs.MAX_SLOTS), ("prefill", 512)):
        x = torch.randn((K, T, D), generator=g, device=dev).mul_(0.3) \
            .to(torch.bfloat16)
        wi = torch.randn((K, D, Fd), generator=g, device=dev).mul_(0.05) \
            .to(torch.bfloat16)
        wo = torch.randn((K, Fd, D), generator=g, device=dev).mul_(0.05) \
            .to(torch.bfloat16)
        if tag == "decode":      # 4 tokens, top-2: 8 slots hold one each
            gs = torch.zeros(K, dtype=torch.int32, device=dev)
            gs[torch.randperm(K, generator=g, device=dev)[
                :2 * cs.MAX_SLOTS]] = 1
        else:                    # ~1,024 assignments over the 64 slots
            gs = torch.bincount(torch.randint(0, K, (1024,), generator=g,
                                              device=dev), minlength=K) \
                .clamp(max=T).to(torch.int32)
        rows = int(gs.sum())
        out[f"grouped_mlp_fwd {tag}"] = (
            {w: (lambda m=m, x=x, wi=wi, wo=wo, gs=gs: [m.grouped_mlp(
                x, wi, None, wo, gs, act="gelu")]) for w, m in gms.items()},
            [ref.grouped_mlp_ref(x, wi, None, wo, act="gelu",
                                 group_sizes=gs)],
            2 * 2 * rows * D * Fd, ())
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the other checkout")
    ap.add_argument("--out", default="", help="also write the JSON here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    from repro_torch.kernels import grouped_mlp as this_gm
    from repro_torch.kernels import ref
    other_gm = load_other(args.other)
    gms = {"other": other_gm, "this": this_gm}
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    train, mask, tiles = _train_cases(torch, gms, ref, dev)
    cases = {**train, **_inference_cases(torch, gms, ref, dev)}
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    n_cmp = 8
    valid = mask[:n_cmp].bool()
    out = []
    for name, (fns, plain, ops, valid_only) in cases.items():
        for who, fn in fns.items():
            for i, (a, b) in enumerate(zip(fn(), plain)):
                if a.shape != b.shape:           # training: first 8 slots
                    a = a[:n_cmp]
                if i in valid_only:              # h1: its valid rows
                    a, b = a[valid], b[valid]
                cs.compare(torch, f"{name} output {i} {who}", a, b,
                           *cs.TOL["bfloat16"])
        times = {"other": [], "this": []}
        for who in ("other", "this", "this", "other"):
            times[who].append(cs.time_ms(torch, fns[who], flush))
        rate = {w: [ops / t / 1e9 for t in ts] for w, ts in times.items()}
        print(f"  [{card}] {name} bf16: other {times['other']} ms "
              f"({[round(r, 1) for r in rate['other']]} TFLOP/s), this "
              f"{times['this']} ms "
              f"({[round(r, 1) for r in rate['this']]} TFLOP/s)")
        out.append(dict(kernel=name, other_ms=times["other"],
                        this_ms=times["this"], other_tflops=rate["other"],
                        this_tflops=rate["this"]))
    tile_ms = cs.time_ms(torch, lambda: this_gm.tile_list(mask), flush)
    print(f"  [{card}] tile list ({tiles.numel()} tiles): {tile_ms} ms")
    res = {"device": card, "other": os.path.abspath(args.other),
           "cases": out, "tile_list_ms": tile_ms}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
