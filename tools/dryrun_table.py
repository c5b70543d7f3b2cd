"""Print the dry run's records (``python -m repro_torch.launch.dryrun ...
--out DIR``) as a markdown table, one row per ``ok`` record, and the
count of each status.

  python tools/dryrun_table.py experiments/dryrun_torch [--shape train_4k]

Per rank, under the record's dense layout (``tp`` or ``zero``): the peak
of the fake step's live bytes, the reference's analytic
memory model, FLOPs, collective wire bytes by kind, the three roofline
terms on the H100 (data-sheet rates: a model, not a measurement) and the
fake step's wall time on the host that ran it.
"""
import argparse
import glob
import json
import os
from collections import Counter

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dir")
    ap.add_argument("--shape", default=None)
    args = ap.parse_args()
    recs = [json.load(open(p))
            for p in sorted(glob.glob(os.path.join(args.dir, "*.json")))]
    print("status: " + ", ".join(f"{k} {v}" for k, v in sorted(
        Counter(r["status"] for r in recs).items())))
    print()
    print("| config | grid | layout | peak GB | model GB | TFLOP | "
          + " | ".join(f"{k} GB" for k in KINDS)
          + " | compute ms | memory ms | collective ms | dominant | "
            "useful | run s |")
    print("|" + "---|" * (12 + len(KINDS)))
    for r in recs:
        if r["status"] != "ok" or (args.shape and r["shape"] != args.shape):
            continue
        m, c, rf = r["memory"], r["cost"], r["roofline"]
        coll = " | ".join(f"{c['collective_bytes'].get(k, 0) / 1e9:.3f}"
                          for k in KINDS)
        print(f"| {r['arch']} | {r['mesh']} | {r.get('layout', '-')} | "
              f"{m['peak_estimate_per_device'] / 1e9:.2f} | "
              f"{r['memory_model']['total_bytes_est'] / 1e9:.2f} | "
              f"{c['flops'] / 1e12:.1f} | {coll} | "
              f"{rf['compute_s'] * 1e3:.2f} | {rf['memory_s'] * 1e3:.2f} | "
              f"{rf['collective_s'] * 1e3:.2f} | {rf['dominant']} | "
              f"{rf['useful_flops_ratio']:.3f} | {r['run_s']} |")


if __name__ == "__main__":
    main()
