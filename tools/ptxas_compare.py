#!/usr/bin/env python3
"""Registers, shared memory and spills of every kernel of the grouped-MLP
sources, in this tree and in another checkout, side by side.

    python3 tools/ptxas_compare.py --other DIR

DIR is another checkout of this repository, for example a commit unpacked
with ``git archive`` into a git-ignored directory.  Each tree's
``csrc/grouped_mlp.cu`` and ``csrc/grouped_mlp_bwd.cu`` are compiled with
this tree's ``nvcc`` flags (``kernels/_build.py``, ``-Xptxas -v``) into a
temporary directory, all four builds at once, and each kernel
instantiation's ``ptxas`` line is printed for both trees (names demangled
where ``c++filt`` is present), marked where the two differ.  Needs
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

SOURCES = ("grouped_mlp", "grouped_mlp_bwd")


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
        this, other = stats["this", name], stats["other", name]
        for kern in sorted(set(this) | set(other)):
            a, b = this.get(kern, "absent"), other.get(kern, "absent")
            same &= a == b
            print(f"  {kern}\n    this:  {a}\n    other: {b}"
                  f"{'' if a == b else '   <- differs'}")
    print(f"every kernel {'the same' if same else 'NOT the same'} in both "
          f"trees")


if __name__ == "__main__":
    main()
