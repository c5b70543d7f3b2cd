"""Dry run: one rank's step of every (arch x shape x grid) combination on
fake tensors over a fake process grid, the port's counterpart of the JAX
package's ``repro/launch/dryrun.py``.

The reference lowers and compiles each combination for 256 or 512 host
devices and reads XLA's memory and cost analyses.  The port has no
compiler to ask: it runs its own step once (``build_train_step``,
``build_prefill_step`` or ``build_serve_step``) as rank 0 of a fake
default group of the grid's size (``launch.mesh.fake_grid``), on tensors
made under a ``FakeTensorMode`` (shapes and dtypes, nothing allocated, on
the CPU device: no card is touched) and with every kernel in its plain
version (``kernels.ops.reference_mode``: the kernels are ``ctypes`` calls
that cannot take fake tensors; the reference lowers with
``use_pallas=False``).  A dispatch mode watches every op of the step and
records, per rank:

* ``memory``: the live bytes of the fake tensors' storages through the
  step (arguments, outputs, the peak and the temporaries above the
  arguments) and ``memory_model``, the reference's analytic HBM model;
* ``cost``: FLOPs (``FlopCounterMode``), operand and result bytes of every
  op that is not a view (before any fusion, XLA:CPU's notion of bytes
  accessed), and the wire bytes and op counts of every collective by the
  reference's HLO kind names, with its ring factors and each call's group
  size; the port runs every layer eagerly, so nothing is extrapolated and
  ``cost_raw`` equals ``cost``;
* ``roofline``: the reference's three terms on the H100.

Emits one JSON record per combination under ``experiments/dryrun_torch/``:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmoe-1b-7b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
      --include-paper-models --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref
from collections import Counter
from typing import Dict, Optional, Tuple, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro_torch.configs as configs
from repro_torch.common.config import (H100, INPUT_SHAPES, ModelConfig,
                                       ShapeConfig, TrainConfig)
from repro_torch.launch import inputs as inp
from repro_torch.launch.mesh import fake_grid, production_shape


# c10d ops -> the HLO kind of the reference's ``collective_bytes``.  Every
# op's first argument is its RESULT: the output of a gather, a reduce-scatter
# and an all-to-all, the tensors an all-reduce reduces in place, the tensors
# a send gives its peer.  A ``recv_`` is the other half of a send.
_C10D_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "send": "collective-permute",
}


def _tensors(tree):
    """The tensors of a nested structure of tuples, lists and dicts (named
    tuples included)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages under ``tree``."""
    seen = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


def wire_bytes(kind: str, nbytes: int, g: int) -> int:
    """The reference's ring wire factors for a group of ``g`` ranks,
    applied to the result's bytes (in integers, as ``core.moe``'s
    collective record takes them)."""
    if kind == "all-reduce":
        return 2 * nbytes * (g - 1) // g
    if kind == "reduce-scatter":
        return nbytes * (g - 1)
    if kind == "collective-permute":
        return nbytes
    return nbytes * (g - 1) // g             # all-gather, all-to-all


def _group_size(func, args, kwargs) -> int:
    for i, a in enumerate(func._schema.arguments):
        if "ProcessGroup" in str(a.type):
            pg = args[i] if i < len(args) else kwargs[a.name]
            return torch.distributed.ProcessGroup.unbox(pg).size()
    raise RuntimeError(f"{func} takes no process group")


class StepAccount(TorchDispatchMode):
    """Watches every op of a step: the live bytes of the storages the
    step makes (from the op that makes one until it is freed) on top of
    ``live_bytes``, the operand and result bytes of every op that is not
    a view, and the wire bytes and calls of every collective by HLO
    kind."""

    def __init__(self, live_bytes: int = 0):
        super().__init__()
        self.live = self.peak = live_bytes
        self.bytes_accessed = 0
        self.collective_bytes: Counter = Counter()
        self.collective_ops: Counter = Counter()
        self._seen = weakref.WeakValueDictionary()

    def know(self, tree) -> None:
        """Storages that exist before the step (its arguments): counted in
        ``live_bytes`` already."""
        for t in _tensors(tree):
            st = t.untyped_storage()
            self._seen[id(st)] = st

    def _free(self, n: int) -> None:
        self.live -= n

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if self._seen.get(id(st)) is st:
            return
        self._seen[id(st)] = st
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = list(_tensors(out))
        for t in outs:
            self._track(t)
        ns, _, name = func._schema.name.partition("::")
        kind = _C10D_KINDS.get(name) if ns == "c10d" else None
        if kind is not None:
            nbytes = sum(_nbytes(t) for t in _tensors(args[0]))
            self.collective_bytes[kind] += wire_bytes(
                kind, nbytes, _group_size(func, args, kwargs))
            self.collective_ops[kind] += 1
        if not any(r.alias_info is not None and not r.alias_info.is_write
                   for r in func._schema.returns):
            self.bytes_accessed += sum(
                _nbytes(t) for t in _tensors((args, kwargs))) + sum(
                _nbytes(t) for t in outs)
        return out


def default_microbatches(cfg: ModelConfig, shape: ShapeConfig, grid) -> int:
    """Gradient-accumulation depth: bound the rematerialization-saved
    activation stack (one (B_loc, S, d_model) residual per layer) to ~4 GB
    per rank, while keeping >= 1 batch row per rank (the reference's rule
    with the port's ``mesh_batch_size``)."""
    mb = inp.mesh_batch_size(grid)
    cap = max(1, shape.global_batch // mb)
    saved = (cfg.num_layers * shape.global_batch * shape.seq_len
             * cfg.d_model * 2) / mb
    want = -(-int(saved) // (4 << 30))
    want = max(1, min(cap, want))
    # round up to a divisor of the global batch
    while shape.global_batch % want:
        want += 1
    return int(want)


def analytic_memory(cfg: ModelConfig, shape: ShapeConfig, grid) -> Dict:
    """The reference's per-device HBM model, formula for formula, against
    the H100's 80 GB.  It models the reference's fully sharded layout:
    the port replicates its dense parameters on every rank, which the
    measured ``memory`` of a record shows."""
    n_dev = grid.size
    mb = inp.mesh_batch_size(grid)
    n_params = cfg.param_count()
    if shape.mode == "train":
        # f32 master + mu + nu fully sharded + f32 grads + bf16 compute copy
        weights = n_params * (4 + 4 + 4 + 4 + 2) / n_dev
        micro = default_microbatches(cfg, shape, grid)
        saved = (cfg.num_layers * shape.global_batch * shape.seq_len
                 * cfg.d_model * 2) / mb / micro
        work = 2e9  # attention/FFN workspace per layer (flash kernels)
        total = weights + saved + work
    else:
        weights = n_params * 2 / n_dev
        cache = 0.0
        s = min(shape.seq_len, cfg.max_decoder_len or shape.seq_len)
        for kind in cfg.layer_kinds():
            if kind in ("attn", "local"):
                eff = min(s, cfg.sliding_window) if kind == "local" else s
                cache += (shape.global_batch * eff * cfg.num_kv_heads
                          * cfg.head_dim * 2 * 2)
            elif kind == "mamba":
                ss = cfg.ssm
                nh = ss.num_heads(cfg.d_model)
                cache += shape.global_batch * nh * ss.state_dim \
                    * ss.head_dim * 4
        cache /= n_dev
        work = 1e9
        total = weights + cache + work
    return {"weights_bytes": weights, "total_bytes_est": total,
            "fits_80g_hbm": bool(total < H100.hbm_bytes)}


def _reduced_cfg(cfg: ModelConfig, depth: int) -> ModelConfig:
    """The depth-``depth`` (in superblocks) variant of ``cfg``."""
    kw = {"num_layers": len(cfg.layer_pattern) * depth}
    if cfg.is_encoder_decoder:
        kw["encoder_layers"] = depth
    return cfg.replace(**kw)


def _with_perf_opts(cfg: ModelConfig, perf_opts) -> ModelConfig:
    """``capacity_factor`` overrides the MoE dispatch capacity factor.  The
    reference's ``grad_constraint`` and ``sharding_mode="zero"`` are GSPMD
    layouts of the dense parameters, which the port does not shard."""
    po = dict(perf_opts or {})
    for k in ("grad_constraint", "sharding_mode"):
        if po.pop(k, None):
            raise ValueError(f"perf_opts {k!r}: a GSPMD layout of the dense "
                             f"parameters, which the port replicates on "
                             f"every rank; not ported")
    cf = po.pop("capacity_factor", None)
    if po:
        raise ValueError(f"unknown perf_opts {sorted(po)}")
    if cf:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cf)))
    return cfg


def _step_and_args(cfg: ModelConfig, shape: ShapeConfig, grid, impl: str,
                   mode):
    """(step, args): the port's step for ``shape.mode`` on ``grid`` and
    its fake arguments.  Training accumulates over
    ``default_microbatches``; BERT's step is bidirectional, as the
    reference's dry run lowers it."""
    from repro_torch.serve.engine import build_prefill_step, build_serve_step
    from repro_torch.train.step import build_train_step

    rt = inp.make_runtime(cfg, grid, impl=impl)
    pa = inp.abstract_plan(cfg, grid, mode, impl)
    if shape.mode == "train":
        tc = TrainConfig(microbatch=default_microbatches(cfg, shape, grid))
        step = build_train_step(cfg, rt, tc,
                                causal=not cfg.name.startswith("bert"))
        return step, (inp.abstract_state(cfg, grid, mode),
                      inp.abstract_batch(cfg, shape, grid, mode), pa)
    params = inp.abstract_params(cfg, grid, mode)
    if shape.mode == "prefill":
        return build_prefill_step(cfg, rt), (
            params, inp.abstract_batch(cfg, shape, grid, mode), pa)
    cache, tokens, pos = inp.abstract_decode_inputs(cfg, shape, grid, mode)
    return build_serve_step(cfg, rt), (params, cache, tokens, pos, pa)


def run_fake_step(cfg: ModelConfig, shape: ShapeConfig, grid,
                  impl: str = "ring") -> Dict:
    """Run one rank's step of ``cfg`` at ``shape`` on fake tensors over the
    (fake) process ``grid``; returns its memory, cost and wall time."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import ops

    mode = FakeTensorMode(allow_non_fake_inputs=True)
    step, args = _step_and_args(cfg, shape, grid, impl, mode)
    arg_bytes = storage_bytes(args)
    acct = StepAccount(arg_bytes)
    acct.know(args)
    flops = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with mode, ops.reference_mode(), flops, acct:
        out = step(*args)
    run_s = time.perf_counter() - t0
    out_bytes = storage_bytes(out)
    del out
    coll = {k: int(v) for k, v in acct.collective_bytes.items()}
    cost = {"flops": float(flops.get_total_flops()),
            "bytes_accessed": float(acct.bytes_accessed),
            "collective_bytes": coll,
            "collective_bytes_total": float(sum(coll.values())),
            "collective_op_counts": dict(acct.collective_ops)}
    memory = {"argument_bytes_per_device": int(arg_bytes),
              "output_bytes_per_device": int(out_bytes),
              "temp_bytes_per_device": int(acct.peak - arg_bytes),
              "peak_estimate_per_device": int(acct.peak)}
    return {"memory": memory, "cost": cost, "run_s": run_s}


def unsupported_reason(shape: ShapeConfig, grid_shape: Tuple[int, int]
                       ) -> Optional[str]:
    """Why the port cannot run ``shape`` on a grid of ``grid_shape``, or
    None: each rank holds whole rows of the batch."""
    n = grid_shape[0] * grid_shape[1]
    if shape.global_batch % n:
        return (f"global batch {shape.global_batch} is not a multiple of "
                f"the grid's {n} ranks: each rank of the port's grid holds "
                f"whole rows, and the port has no tensor-parallel dense "
                f"layers (the reference shards heads and ff over 'model', "
                f"src/repro/common/sharding.py)")
    return None


def dryrun_combo(arch: Union[str, ModelConfig],
                 shape: Union[str, ShapeConfig], *, multi_pod: bool = False,
                 impl: str = "ring", grid: Optional[Tuple[int, int]] = None,
                 perf_opts=None) -> Dict:
    """Full dry-run record for one (arch, shape, grid).  ``arch``: a
    config name (or a ``ModelConfig``); ``shape``: a name of
    ``INPUT_SHAPES`` (or a ``ShapeConfig``); ``grid``: any (data, model)
    shape, else the production grid (``multi_pod``)."""
    cfg = configs.get(arch) if isinstance(arch, str) else arch
    shape = INPUT_SHAPES[shape] if isinstance(shape, str) else shape
    gshape = tuple(grid) if grid is not None else production_shape(multi_pod)
    rec: Dict = {"arch": cfg.name, "shape": shape.name,
                 "mesh": f"grid{gshape[0]}x{gshape[1]}",
                 "grid": list(gshape),
                 "impl": impl if cfg.moe.enabled else "n/a",
                 "mode": shape.mode}
    skip = inp.skip_reason(cfg, shape)
    if skip:
        rec.update(status="skipped", reason=skip)
        return rec
    note = inp.shape_note(cfg, shape)
    if note:
        rec["note"] = note
    why = unsupported_reason(shape, gshape)
    if why:
        rec.update(status="unsupported", reason=why)
        return rec
    if perf_opts:
        rec["perf_opts"] = dict(perf_opts)
    cfg = _with_perf_opts(cfg, perf_opts)
    with fake_grid(*gshape) as g:
        run = run_fake_step(cfg, shape, g, impl)
        rec["run_s"] = round(run["run_s"], 2)
        rec["memory"] = run["memory"]
        rec["memory_model"] = analytic_memory(cfg, shape, g)
        rec["cost_raw"] = dict(run["cost"])
        rec["cost"] = dict(run["cost"])
        rec["roofline"] = roofline_terms(cfg, shape, rec, g.size)
    rec["status"] = "ok"
    return rec


def roofline_terms(cfg: ModelConfig, shape: ShapeConfig, rec: Dict,
                   n_dev: int) -> Dict:
    """The reference's three roofline terms (seconds) from one rank's
    costs, on the H100:
        compute    = flops_per_rank / peak (dense bf16)
        memory     = bytes_per_rank / hbm_bw
        collective = collective_bytes_per_rank / ici_bw
    ``ici_bw`` is one NVLink direction (``H100``), which a cluster of 256
    H100s has only between the 8 cards of one node; across nodes the
    network is slower, so the collective term is a lower bound there."""
    hw = H100
    c = rec["cost"]
    compute = c["flops"] / hw.peak_flops_bf16
    # the operand bytes of every op before fusion bound the HBM traffic
    # from above; reading every argument and writing every output once
    # bounds it from below; the headline term is their geometric mean
    mem_ub = c["bytes_accessed"] / hw.hbm_bw
    m = rec["memory"]
    mem_lb = (m["argument_bytes_per_device"]
              + m["output_bytes_per_device"]) / hw.hbm_bw
    memory = (mem_lb * mem_ub) ** 0.5 if mem_lb > 0 else mem_ub
    coll = c["collective_bytes_total"] / hw.ici_bw
    dominant = max((("compute", compute), ("memory", memory),
                    ("collective", coll)), key=lambda kv: kv[1])[0]
    s = inp.effective_seq(cfg, shape)
    tokens = shape.global_batch * (s if shape.mode != "decode" else 1)
    n_active = cfg.active_param_count()
    mult = 6 if shape.mode == "train" else 2
    model_flops = mult * n_active * tokens
    hlo_total = c["flops"] * n_dev
    return {
        "compute_s": compute,
        "memory_s": memory,
        "memory_s_lower": mem_lb,
        "memory_s_upper": mem_ub,
        "collective_s": coll,
        "dominant": dominant,
        "model_flops": float(model_flops),
        "hlo_flops_global": float(hlo_total),
        "useful_flops_ratio": float(model_flops / hlo_total)
        if hlo_total else 0.0,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--impl", default="ring",
                    choices=["ring", "a2a", "dense", "ep"])
    ap.add_argument("--all", action="store_true",
                    help="all assigned archs x all shapes")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--include-paper-models", action="store_true")
    args = ap.parse_args(argv)

    archs = ([configs.canonical(args.arch)] if args.arch else
             configs.ASSIGNED + (configs.PAPER
                                 if args.include_paper_models else []))
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = []
    t_all = time.perf_counter()
    for multi in meshes:
        for arch in archs:
            for shape in shapes:
                tag = (f"{configs.canonical(arch)}_{shape}_"
                       f"{'multi' if multi else 'single'}_{args.impl}")
                try:
                    rec = dryrun_combo(arch, shape, multi_pod=multi,
                                       impl=args.impl)
                except Exception as e:  # a failure here is a bug — surface it
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "multi" if multi else "single",
                           "status": "FAILED", "error": str(e),
                           "traceback": traceback.format_exc()}
                    failures.append(tag)
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(rec, f, indent=2)
                status = rec.get("status")
                if status == "ok":
                    r, m = rec["roofline"], rec["memory"]
                    extra = (f"run={rec['run_s']:.1f}s "
                             f"peak={m['peak_estimate_per_device'] / 1e9:.2f}"
                             f"GB dom={r['dominant']} "
                             f"comp={r['compute_s']*1e3:.2f}ms "
                             f"mem={r['memory_s']*1e3:.2f}ms "
                             f"coll={r['collective_s']*1e3:.2f}ms")
                elif status in ("skipped", "unsupported"):
                    extra = rec["reason"][:60]
                else:
                    extra = rec.get("error", "")[:120]
                print(f"[{status:11s}] {tag}: {extra}", flush=True)
    print(f"\n{time.perf_counter() - t_all:.1f} s")
    if failures:
        print(f"\n{len(failures)} FAILURES: {failures}")
        raise SystemExit(1)
    print("\nDry-run complete.")


if __name__ == "__main__":
    main()
