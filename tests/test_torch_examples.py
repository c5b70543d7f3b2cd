"""The five examples of the PyTorch port (``examples/*_torch.py``), each
run on the CPU at its smallest arguments in a fresh interpreter with one
torch intra-op thread: each must exit 0 and print its closing line (the
scripts assert their own checks: the quickstart's falling loss, the
published engine's parity with a fresh and a restored one, the fleet's
parity, FSSDP's recovery of the skewed EP load)."""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(__file__), "..")

CASES = {
    "quickstart": (["--steps", "6"], "quickstart OK"),
    "train_moe_e2e": (["--steps", "1", "--seq-len", "8", "--global-batch",
                       "1", "--ckpt-dir", "{tmp}"], "checkpoint: 1"),
    "serve_decode": (["--steps", "2", "--new-tokens", "4"],
                     "batched decode ticks"),
    "train_and_serve": (["--steps", "2", "--publish-every", "1",
                         "--sample-every", "1", "--decode-steps", "2",
                         "--ckpt-dir", "{tmp}"], "decodes identically: OK"),
    "train_and_serve-fleet": (["--steps", "2", "--publish-every", "1",
                               "--sample-every", "0", "--decode-steps", "2",
                               "--replicas", "2", "--ckpt-dir", "{tmp}"],
                              "fleet parity across 2 replicas"),
    "imbalance_demo": ([], "FSSDP recovery over skewed EP"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_example_runs_on_the_cpu(case, tmp_path):
    args, want = CASES[case]
    name = case.split("-")[0]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", f"{name}_torch.py"),
         "--device", "cpu", *[a.format(tmp=tmp_path) for a in args]],
        env=env, capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert want in r.stdout, r.stdout[-3000:]
