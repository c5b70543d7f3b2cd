"""The paper's core phenomenon on a 2 x 4 process grid of the PyTorch
port: skewed expert loads straggle EP; FSSDP's sparse materialization
recovers the balance.  The counterpart of ``examples/imbalance_demo.py``
(8 host devices there, 8 ranks here: 2 data x 4 expert-parallel).

Measured from real runs of the FSSDP layer on every rank
(``MoEAux.device_loads``: tokens processed per expert-parallel rank,
summed over the grid):

  * EP, uniform router   — even at init a random router is imbalanced;
  * EP, skewed router    — the hot experts' owner becomes the straggler;
  * FSSDP (Alg 1 + Alg 2)— replicas of hot experts flatten the per-rank
                           load back toward the mean.

The heterogeneous sharding (Algorithm 2) separates the hot experts across
owners, so that the ring's one slot per destination fed by an owner is
not contended by two of them.

  PYTHONPATH=src python examples/imbalance_demo_torch.py --device cpu
  PYTHONPATH=src python examples/imbalance_demo_torch.py   # 8 cards, NCCL

The ranks are processes of this machine started by
``launch.distributed.spawn``: gloo on the CPU, NCCL with one card a rank.
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch.common.config import ModelConfig, MoEConfig
from repro_torch.core import moe as moe_core
from repro_torch.core.moe import MoERuntime
from repro_torch.core.placement import (ep_materialization,
                                        homogeneous_sharding)
from repro_torch.core.schedule import (heterogeneous_sharding,
                                       sparse_materialization)
from repro_torch.launch.distributed import spawn

DATA, EP, T, E = 2, 4, 4096, 16


def _cfg():
    return ModelConfig(
        name="demo", arch_type="moe", num_layers=1, d_model=128,
        num_heads=4, num_kv_heads=4, d_ff=256, vocab_size=1024,
        moe=MoEConfig(num_experts=E, experts_per_token=2, d_ff=256),
        dtype="float32")


def _plans():
    sh = homogeneous_sharding(1, E, EP)
    loads = np.full((1, E), 0.01)
    loads[0, :2] = 1.0
    sh_het = heterogeneous_sharding(loads, EP, t=4)        # Algorithm 2
    return {"ep": ep_materialization(sh),
            "fssdp": sparse_materialization(sh_het, loads, t=E, m=3,
                                            impl="ring")}  # Algorithm 1


def rank_main(grid, device: str):
    """Every rank runs the layer on its rows; returns the loads (the same
    on every rank: they are summed over the grid) and dropped fractions.
    On CUDA rank r takes card r (NCCL refuses two ranks on one card)."""
    cfg = _cfg()
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", grid.rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    g = torch.Generator().manual_seed(0)
    buf = torch.randn((moe_core.buffer_rows(cfg, EP),
                       moe_core.chunk_len(cfg)), generator=g) * 0.05
    x = torch.randn((T, cfg.d_model), generator=g) + 2.0
    wr_u = torch.randn((cfg.d_model, E), generator=g) * 0.01
    wr_s = wr_u.clone()
    wr_s[:, :2] = 8.0 / (2.0 * cfg.d_model)
    n = T // grid.size
    xs = x[grid.rank * n:(grid.rank + 1) * n].to(dev)
    plans = _plans()

    def run(wr, plan, capacity=2048):
        pa = moe_core.plan_to_arrays(plan, dev).layer(0)
        rt = MoERuntime(grid=grid, impl=plan.impl, capacity=capacity,
                        local_first=(plan.m == 0))
        shard = moe_core.shard_buffer(buf, grid).to(dev)
        with torch.no_grad():
            _, aux = moe_core.moe_layer(cfg, rt, xs, wr.to(dev), shard, pa)
        return aux.device_loads.cpu().numpy(), float(aux.dropped_frac)

    out = {"uniform": run(wr_u, plans["ep"]),
           "skewed": run(wr_s, plans["ep"]),
           "fssdp": run(wr_s, plans["fssdp"])}
    # drops at balanced-load buffer sizing (the quality angle)
    bal_cap = int(1.3 * (T / (DATA * EP)) * 2 / (EP * (E // EP)))
    out["bal_cap"] = bal_cap
    out["drop_ep"] = run(wr_s, plans["ep"], bal_cap)[1]
    out["drop_fssdp"] = run(wr_s, plans["fssdp"], bal_cap)[1]
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn(rank_main, (DATA, EP), args.device, workdir=tmp,
                      args=(args.device,), timeout=600)
    r = ranks[0]
    cfg = _cfg()
    mean = T * cfg.moe.experts_per_token / EP

    def show(label, dev):
        bar = "  ".join(f"{int(v):5d}" for v in dev)
        print(f"{label:28s} max={dev.max():6.0f} ({dev.max()/mean:4.1f}x "
              f"mean)  per EP rank: {bar}")

    l_u, l_s, l_f = r["uniform"][0], r["skewed"][0], r["fssdp"][0]
    print(f"tokens/step={T}, top-{cfg.moe.experts_per_token} of {E} experts "
          f"on a {DATA} x {EP} grid -> mean load {mean:.0f}/EP rank\n")
    show("EP, uniform router", l_u)
    show("EP, skewed router", l_s)
    show("FSSDP(Alg1+Alg2), skewed", l_f)
    print(f"\nEP straggler factor under skew : "
          f"{l_s.max()/l_u.max():.2f}x (paper §1: up to 5.18x)")
    print(f"FSSDP recovery over skewed EP  : {l_s.max()/l_f.max():.2f}x")
    print(f"\nwith buffers sized for balanced loads (capacity "
          f"{r['bal_cap']} per cell):")
    print(f"  EP drops {r['drop_ep']*100:5.1f}% of expert assignments "
          f"on rank 0; FSSDP drops {r['drop_fssdp']*100:5.1f}%")
    assert all((rk["fssdp"][0] == l_f).all() for rk in ranks)
    assert l_s.max() / l_f.max() > 1.5


if __name__ == "__main__":
    main()
