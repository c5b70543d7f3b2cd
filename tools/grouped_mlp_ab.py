#!/usr/bin/env python3
"""Time two versions of the grouped-MLP training kernels on one card, in
turns.

    python3 tools/grouped_mlp_ab.py --other DIR [--out FILE]

DIR is another checkout of this repository whose bf16 training forward
(B1-train) and dgrad (B2) are the first port's design, on the FMA units
(``grouped_mlp_fwd_train`` and ``grouped_mlp_dgrad`` taking bf16): for
example such a commit unpacked with ``git archive`` into a git-ignored
directory.  The script builds that tree's ``grouped_mlp.cu`` and
``grouped_mlp_bwd.cu`` with this tree's ``nvcc`` flags and calls their C
entry points as that tree's wrapper did (dgrad with the transposed weight
copies that wrapper made on every call, inside the timing); this tree's
kernels run through their wrappers (``kernels/grouped_mlp.py``) with the
tile list given, as the training path hands it to both, and the list is
timed on its own.  Both are held to the plain PyTorch versions on the first 8
slots, then timed in the order other, this, this, other (CUDA events,
median of 15, L2 flushed before each call) at the shapes of
``chip_smoke.py``'s training check: 64 slots of capacity 16,384, 32,768
valid rows as a prefix of each slot, D 768, F 1,536, GELU, bf16.  It
prints the card, one line per kernel with both versions' times and
TFLOP/s and, as its last line, one JSON object with every time.  Needs
one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the FMA design's C entry points
OLD_SIGS = {
    "grouped_mlp": ("grouped_mlp_fwd_train",
                    [_P] * 8 + [_I] * 4 + [_L] * 3 + [_I] * 2 + [_P]),
    "grouped_mlp_bwd": ("grouped_mlp_dgrad", [_P] * 11 + [_I] * 6 + [_P]),
}


def build_other(other: str, name: str):
    """The FMA design's entry point of ``name``.cu in the tree at
    ``other``, built with this tree's flags into that tree's (git-ignored)
    build directory."""
    from repro_torch.kernels import _build
    kdir = os.path.join(other, "src", "repro_torch", "kernels")
    os.makedirs(os.path.join(kdir, "build"), exist_ok=True)
    out = os.path.join(kdir, "build", f"ab_lib{name}.so")
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", out,
                    os.path.join(kdir, "csrc", f"{name}.cu")], check=True,
                   capture_output=True, text=True)
    fn_name, args = OLD_SIGS[name]
    fn = getattr(ctypes.CDLL(out), fn_name)
    fn.argtypes, fn.restype = args, ctypes.c_int
    return fn


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the other checkout")
    ap.add_argument("--out", default="", help="also write the JSON here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    from repro_torch.kernels import grouped_mlp as gm
    from repro_torch.kernels import ref
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    old_fwd = build_other(args.other, "grouped_mlp")
    old_dgrad = build_other(args.other, "grouped_mlp_bwd")
    stream = torch.cuda.current_stream().cuda_stream

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
    tiles = gm.tile_list(mask)
    _, h1, _ = gm.grouped_mlp_fwd_train(x, wi, None, wo, mask, act="gelu")

    def fwd_other():
        y, hh = torch.empty_like(x), torch.empty_like(h1)
        code = old_fwd(x.data_ptr(), wi.data_ptr(), None, wo.data_ptr(),
                       mask.data_ptr(), y.data_ptr(), hh.data_ptr(), None,
                       K, T, D, Fd, D * Fd, 0, Fd * D, 0, 1, stream)
        if code:
            raise RuntimeError(f"grouped_mlp_fwd_train: CUDA error {code}")
        return y, hh

    def dgrad_other():
        wo_t = wo.transpose(1, 2).contiguous()
        wi_t = wi.transpose(1, 2).contiguous()
        dx, dh1, h = (torch.empty_like(a) for a in (dy, h1, h1))
        code = old_dgrad(dy.data_ptr(), wo_t.data_ptr(), wi_t.data_ptr(),
                         None, mask.data_ptr(), h1.data_ptr(), None,
                         dx.data_ptr(), dh1.data_ptr(), None, h.data_ptr(),
                         K, T, D, Fd, 0, 1, stream)
        if code:
            raise RuntimeError(f"grouped_mlp_dgrad: CUDA error {code}")
        return dx, dh1, h

    cases = {
        "grouped_mlp_fwd_train": (
            {"other": fwd_other,
             "this": lambda: gm.grouped_mlp_fwd_train(
                 x, wi, None, wo, mask, act="gelu", tiles=tiles)[:2]},
            ref.grouped_mlp_fwd_train_ref(x[:8], wi[:8], None, wo[:8],
                                          mask[:8], act="gelu")[:2]),
        "grouped_mlp_dgrad": (
            {"other": dgrad_other,
             "this": lambda: [a for a in gm.grouped_mlp_dgrad(
                 dy, mask, h1, None, wi, None, wo, act="gelu", tiles=tiles)
                 if a is not None]},
            [a for a in ref.grouped_mlp_dgrad_ref(
                dy[:8], mask[:8], h1[:8], None, wi[:8], None, wo[:8],
                act="gelu") if a is not None]),
    }
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    valid = mask[:8].bool()
    ops = 2 * 2 * rows * D * Fd          # the function's two products
    out = []
    for name, (fns, plain) in cases.items():
        for who, fn in fns.items():
            for i, (a, b) in enumerate(zip(fn(), plain)):
                a = a[:8]
                if name == "grouped_mlp_fwd_train" and i == 1:  # h1
                    a, b = a[valid], b[valid]
                cs.compare(torch, f"{name} output {i} {who}", a, b,
                           *cs.TOL["bfloat16"])
        times = {"other": [], "this": []}
        for who in ("other", "this", "this", "other"):
            times[who].append(cs.time_ms(torch, fns[who], flush))
        rate = {w: [ops / t / 1e9 for t in ts] for w, ts in times.items()}
        print(f"  [{card}] {name} K={K} T={T} D={D} F={Fd} gelu bf16, "
              f"{rows} valid rows: other {times['other']} ms "
              f"({[round(r, 1) for r in rate['other']]} TFLOP/s), this "
              f"{times['this']} ms "
              f"({[round(r, 1) for r in rate['this']]} TFLOP/s)")
        out.append(dict(kernel=name, other_ms=times["other"],
                        this_ms=times["this"], other_tflops=rate["other"],
                        this_tflops=rate["this"]))
    tile_ms = cs.time_ms(torch, lambda: gm.tile_list(mask), flush)
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
