#!/usr/bin/env python3
"""Time two versions of the attention kernels on one card, in turns.

    python3 tools/attention_ab.py --other DIR [--out FILE]

DIR is another checkout of this repository, for example an earlier commit
unpacked with ``git archive`` into a git-ignored directory.  The script
builds ``src/repro_torch/kernels/csrc/flash_attention.cu`` and
``paged_attention.cu`` of both trees with the same ``nvcc`` flags, calls
each through its C interface (the same in both) on the same inputs, holds
both against the plain PyTorch version, and times them in the order
other, this, this, other (CUDA events, median of 15, L2 flushed before
each call): flash attention (B4) at the four prompt buckets of the
served run, batch 1, 12 heads, H 64, causal, bf16; paged decode
attention (B5) at the served decode tick and at positions near 511.  It
prints the card, one line per shape and, as its last line, one JSON
object with every time.  Needs one CUDA card and ``nvcc``.
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

NAMES = ("flash_attention", "paged_attention")


def build_other(other: str, name: str, argtypes) -> ctypes.CDLL:
    """``name``.cu of the tree at ``other``, built with this tree's flags
    into that tree's (git-ignored) kernel build directory."""
    from repro_torch.kernels import _build
    kdir = os.path.join(other, "src", "repro_torch", "kernels")
    os.makedirs(os.path.join(kdir, "build"), exist_ok=True)
    out = os.path.join(kdir, "build", f"ab_lib{name}.so")
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", out,
                    os.path.join(kdir, "csrc", f"{name}.cu")], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(out)
    fn = getattr(lib, "flash_attention_fwd" if name == "flash_attention"
                 else "paged_decode_attention")
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the other checkout")
    ap.add_argument("--out", default="", help="also write the JSON here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    this = {"flash_attention": fa._lib().flash_attention_fwd,
            "paged_attention": pa._lib().paged_decode_attention}
    other = {}
    for n in NAMES:
        lib = build_other(args.other, n, this[n].argtypes)
        other[n] = getattr(lib, this[n].__name__)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    cases = []

    def turns(label, fns, plain, extra):
        """Both versions against the plain result, then timed in turns."""
        for who, fn in fns.items():
            cs.compare(torch, f"{label} {who}", fn(), plain, *cs.TOL[
                "bfloat16"])
        order = ["other", "this", "this", "other"]
        times = {"other": [], "this": []}
        for who in order:
            times[who].append(cs.time_ms(torch, fns[who], flush))
        row = dict(shape=label, other_ms=times["other"],
                   this_ms=times["this"], **extra)
        print(f"  [{card}] {label}: other {times['other']} ms, this "
              f"{times['this']} ms, library {extra['library_ms']:.4f} ms, "
              f"bound {extra['bound_ms']:.4f} ms ({extra['bound_by']})")
        cases.append(row)

    g = torch.Generator(device=dev).manual_seed(7)
    for S in cs.PROMPT_BUCKETS:
        q, k, v = (torch.randn((1, S, 12, 64), generator=g, device=dev)
                   .mul_(0.5).to(torch.bfloat16) for _ in range(3))

        def flash(fn, q=q, k=k, v=v, S=S):
            o = torch.empty_like(q)
            code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                      1, S, 12, 64, 1, 0, 1.0 / 8.0, 1, stream)
            if code:
                raise RuntimeError(f"flash_attention_fwd: CUDA error {code}")
            return o
        with ops.reference_mode():
            plain = ops.flash_attention(q, k, v, causal=True)
        extra = cs._time_flash(torch, flush, q, k, v)
        turns(f"B4 (1,{S},12,64) causal bf16",
              {w: (lambda f=f: flash(f)) for w, f in
               (("other", other["flash_attention"]),
                ("this", this["flash_attention"]))}, plain,
              {key: extra[key] for key in ("library_ms", "bound_ms",
                                           "bound_by")})

    served = [n + cs.NEW_TOKENS // 2 for n in cs.PROMPT_LENS]
    for positions in (served, cs.PAGED_NEAR_MAX):
        q, kp, vp, ri, pos = cs._paged_inputs(torch, dev, g, positions, 12,
                                              1, torch.bfloat16)
        tbl = (ri[:, ::cs.PAGE_SIZE] // cs.PAGE_SIZE).to(torch.int32) \
            .contiguous()

        def paged(fn, q=q, kp=kp, vp=vp, tbl=tbl, pos=pos):
            o = torch.empty_like(q)
            code = fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                      tbl.data_ptr(), pos.data_ptr(), o.data_ptr(), 4, 12,
                      12, 64, kp.shape[0], tbl.shape[1], cs.PAGE_SIZE, 0,
                      0.0, 1.0 / 8.0, 1, stream)
            if code:
                raise RuntimeError(f"paged_decode_attention: CUDA error "
                                   f"{code}")
            return o
        with ops.reference_mode():
            plain = ops.paged_decode_attention(q, kp, vp, ri, pos,
                                               page_size=cs.PAGE_SIZE)
        extra = cs._time_paged(torch, flush, q, kp, vp, ri, pos,
                               positions)
        turns(f"B5 B=4 12/12 heads hd 64 page 8 positions {positions} bf16",
              {w: (lambda f=f: paged(f)) for w, f in
               (("other", other["paged_attention"]),
                ("this", this["paged_attention"]))}, plain,
              {key: extra[key] for key in ("library_ms", "bound_ms",
                                           "bound_by")})
    res = {"device": card, "other": os.path.abspath(args.other),
           "cases": cases}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
