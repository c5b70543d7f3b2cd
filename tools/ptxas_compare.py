#!/usr/bin/env python3
"""Registers, shared memory and spills of every kernel of the CUDA sources
(the grouped MLP's and the two attention kernels'), in this tree and in
another checkout, side by side.

    python3 tools/ptxas_compare.py --other DIR

DIR is another checkout of this repository, for example a commit unpacked
with ``git archive`` into a git-ignored directory.  Each tree's
``csrc/*.cu`` sources are compiled with this tree's ``nvcc`` flags
(``kernels/_build.py``, ``-Xptxas -v``) into a temporary directory, all
builds at once, and each kernel instantiation's ``ptxas`` line is printed
for both trees (names demangled where ``c++filt`` is present), marked
where the two differ.  A kernel that gained a template argument is paired
with the other tree's instantiation under its old name when the new
argument is the old behaviour's (``NEW_ARGS``); an instantiation that only
one tree has is listed as new or gone and is not a difference.  Needs
``nvcc``; no card.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

from chip_smoke import ptxas_stats  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

SOURCES = ("grouped_mlp", "grouped_mlp_bwd", "flash_attention",
           "paged_attention")
# template arguments appended since an earlier tree, with the value that
# keeps the earlier code: the f32 grouped-MLP kernels' XH (D above 3,072
# in two halves), the paged decode kernel's largest hd, and the f32 flash
# kernel's TAIL (S not a multiple of the query tile), which made it a
# template
NEW_ARGS = (("grouped_mlp_fwd_kernel<", "false"),
            ("grouped_mlp_dgrad_kernel<", "false"),
            ("paged_decode_kernel<", "128"),
            ("flash_fwd_f32_kernel<", "false"))


def old_name(name: str) -> str:
    """The name an instantiation had before its kernel gained the trailing
    template argument of ``NEW_ARGS`` (the name itself otherwise); a
    kernel that was no template had no ``void`` and no ``<>``."""
    for prefix, value in NEW_ARGS:
        if prefix in name and name.endswith(f", {value}>"):
            return name[:-len(value) - 3] + ">"
        if prefix in name and name.endswith(f"<{value}>"):
            return name.removeprefix("void ")[:-len(value) - 2]
    return name


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the other checkout")
    args = ap.parse_args()
    trees = {"this": ROOT, "other": os.path.abspath(args.other)}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for tag, root in trees.items():
            for name in SOURCES:
                src = os.path.join(root, "src", "repro_torch", "kernels",
                                   "csrc", f"{name}.cu")
                cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o",
                       os.path.join(tmp, f"{tag}_{name}.so"), src]
                procs[tag, name] = subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
        stats = {}
        for key, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                sys.exit(f"nvcc failed for {key}:\n{log}")
            stats[key] = dict(ptxas_stats(log))
    same = True
    for name in SOURCES:
        print(f"== {name}.cu")
        other = stats["other", name]
        this = {}
        for kern, info in stats["this", name].items():
            key = kern if kern in other else old_name(kern)
            this[key if key in other else kern] = info
        for kern in sorted(set(this) | set(other)):
            a, b = this.get(kern), other.get(kern)
            if a is None or b is None:
                print(f"  {kern}: {'new' if b is None else 'gone'} in this "
                      f"tree: {a or b}")
                continue
            same &= a == b
            print(f"  {kern}\n    this:  {a}\n    other: {b}"
                  f"{'' if a == b else '   <- differs'}")
    print(f"every kernel that both trees have: "
          f"{'the same' if same else 'NOT the same'}")


if __name__ == "__main__":
    main()
