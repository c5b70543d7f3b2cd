"""Dry run: one rank's step of every (arch x shape x grid) combination on
fake tensors over a fake process grid, the port's counterpart of the JAX
package's ``repro/launch/dryrun.py``.

The reference lowers and compiles each combination for 256 or 512 host
devices and reads XLA's memory and cost analyses.  The port has no
compiler to ask: it runs its own step once, under the reference's dense
layout (``perf_opts`` ``sharding_mode``: ``tp`` by default, or ``zero``;
``grad_constraint`` reduce-scatters the weight gradients;
``models.model.make_layout``), (``build_train_step``,
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
  size; the port runs every layer eagerly, so only a training step of more
  than 3 microbatches is extrapolated, from its first 2 and 3
  (``run_fake_step``; ``cost_raw``: the 3's, else equal to ``cost``);
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


def default_microbatches(cfg: ModelConfig, shape: ShapeConfig, grid,
                         layout=None) -> int:
    """Gradient-accumulation depth: bound the rematerialization-saved
    activation stack (one (B_loc, S, d_model) residual per layer) to ~4 GB
    per rank, while keeping >= 1 batch row per rank (the reference's rule
    with the port's ``mesh_batch_size``: under ``tp`` the reference's
    own)."""
    return _microbatches(cfg, shape, inp.mesh_batch_size(grid, layout))


def _microbatches(cfg: ModelConfig, shape: ShapeConfig, mb: int) -> int:
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
    the H100's 80 GB: every parameter fully sharded, the batch over every
    axis but ``model`` (the reference's ``mesh_batch_size``), whatever the
    record's layout."""
    n_dev = grid.size
    mb = grid.data
    n_params = cfg.param_count()
    if shape.mode == "train":
        # f32 master + mu + nu fully sharded + f32 grads + bf16 compute copy
        weights = n_params * (4 + 4 + 4 + 4 + 2) / n_dev
        micro = _microbatches(cfg, shape, mb)
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


def _with_perf_opts(cfg: ModelConfig, perf_opts
                    ) -> Tuple[ModelConfig, str, bool]:
    """(config, sharding mode, grad_constraint) of the reference's
    ``perf_opts``: ``capacity_factor`` overrides the MoE dispatch capacity
    factor, ``sharding_mode`` picks the dense layout ("tp", the default,
    or "zero"), ``grad_constraint`` reduce-scatters the gradient of every
    gathered weight in place of an all-reduce."""
    po = dict(perf_opts or {})
    sharding = po.pop("sharding_mode", None) or "tp"
    if sharding not in ("tp", "zero"):
        raise ValueError(f"perf_opts sharding_mode {sharding!r}: 'tp' or "
                         f"'zero'")
    gc = bool(po.pop("grad_constraint", False))
    cf = po.pop("capacity_factor", None)
    if po:
        raise ValueError(f"unknown perf_opts {sorted(po)}")
    if cf:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cf)))
    return cfg, sharding, gc


def _step_and_args(cfg: ModelConfig, shape: ShapeConfig, grid, impl: str,
                   mode, sharding: str = "tp", grad_constraint: bool = False,
                   microbatch: Optional[int] = None):
    """(step, args): the port's step for ``shape.mode`` on ``grid`` under
    the dense layout ``sharding`` and its fake arguments.  Training
    accumulates over ``microbatch`` microbatches (default
    ``default_microbatches``); BERT's step is bidirectional, as the
    reference's dry run lowers it."""
    from repro_torch.serve.engine import build_prefill_step, build_serve_step
    from repro_torch.train.step import build_train_step

    lay = inp.make_layout(cfg, shape, grid, sharding, grad_constraint)
    rt = inp.make_runtime(cfg, grid, impl=impl, layout=lay)
    pa = inp.abstract_plan(cfg, grid, mode, impl)
    if shape.mode == "train":
        tc = TrainConfig(microbatch=microbatch or default_microbatches(
            cfg, shape, grid, lay))
        step = build_train_step(cfg, rt, tc,
                                causal=not cfg.name.startswith("bert"))
        return step, (inp.abstract_state(cfg, grid, mode, lay),
                      inp.abstract_batch(cfg, shape, grid, mode, lay), pa)
    params = inp.abstract_params(cfg, grid, mode, lay)
    if shape.mode == "prefill":
        return build_prefill_step(cfg, rt), (
            params, inp.abstract_batch(cfg, shape, grid, mode, lay), pa)
    cache, tokens, pos = inp.abstract_decode_inputs(cfg, shape, grid, mode,
                                                    lay)
    return build_serve_step(cfg, rt), (params, cache, tokens, pos, pa)


def _measure(step, args) -> Dict:
    """Run ``step(*args)`` once under the accounts; the raw numbers."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import ops
    arg_bytes = storage_bytes(args)
    acct = StepAccount(arg_bytes)
    acct.know(args)
    flops = FlopCounterMode(display=False)
    mode = next(t for t in _tensors(args)).fake_mode
    t0 = time.perf_counter()
    with mode, ops.reference_mode(), flops, acct:
        out = step(*args)
    run_s = time.perf_counter() - t0
    out_bytes = storage_bytes(out)
    del out
    return {"flops": float(flops.get_total_flops()),
            "bytes_accessed": float(acct.bytes_accessed),
            "collective_bytes": Counter(acct.collective_bytes),
            "collective_ops": Counter(acct.collective_ops),
            "arg_bytes": arg_bytes, "out_bytes": out_bytes,
            "peak": acct.peak, "run_s": run_s}


def run_fake_step(cfg: ModelConfig, shape: ShapeConfig, grid,
                  impl: str = "ring", sharding: str = "tp",
                  grad_constraint: bool = False) -> Dict:
    """Run one rank's step of ``cfg`` at ``shape`` on fake tensors over the
    (fake) process ``grid`` under the dense layout ``sharding``; returns
    its memory, cost and wall time.

    A training step of n > 3 microbatches runs its first 2 and its first 3
    microbatches instead (the batch cut to their rows, the layout's split
    unchanged): every microbatch after the second does the same work on
    the same shapes, so the costs are the 3-microbatch step's plus (n - 3)
    times the third microbatch's (their difference), and the peak is the
    larger of the two runs' above their arguments, over the whole step's
    arguments.  (A step of one microbatch takes another path, and one of
    more may hoist the SparseAllGather, so 2 is the first run.)
    ``measured_microbatches`` says which ran."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    lay = inp.make_layout(cfg, shape, grid, sharding, grad_constraint)
    n = (default_microbatches(cfg, shape, grid, lay)
         if shape.mode == "train" else 1)
    runs = [n] if n <= 3 else [2, 3]
    got = []
    for k in runs:
        sub = dataclasses.replace(shape,
                                  global_batch=shape.global_batch * k // n)
        mode = FakeTensorMode(allow_non_fake_inputs=True)
        step, args = _step_and_args(cfg, sub, grid, impl, mode, sharding,
                                    grad_constraint, microbatch=k)
        got.append(_measure(step, args))
    last = got[-1]
    if n > 3:
        a, b = got
        mode = FakeTensorMode(allow_non_fake_inputs=True)
        arg_bytes = storage_bytes(_step_and_args(
            cfg, shape, grid, impl, mode, sharding, grad_constraint,
            microbatch=n)[1])
        ext = n - 3

        def lin(x, y):
            return y + ext * (y - x)
        flops = lin(a["flops"], b["flops"])
        bytes_accessed = lin(a["bytes_accessed"], b["bytes_accessed"])
        coll = {k: lin(a["collective_bytes"][k], b["collective_bytes"][k])
                for k in b["collective_bytes"]}
        ops = {k: lin(a["collective_ops"][k], b["collective_ops"][k])
               for k in b["collective_ops"]}
        peak = max(r["peak"] - r["arg_bytes"] for r in got) + arg_bytes
    else:
        flops, bytes_accessed = last["flops"], last["bytes_accessed"]
        coll, ops = last["collective_bytes"], last["collective_ops"]
        arg_bytes, peak = last["arg_bytes"], last["peak"]
    coll = {k: int(v) for k, v in coll.items()}
    cost = {"flops": float(flops), "bytes_accessed": float(bytes_accessed),
            "collective_bytes": coll,
            "collective_bytes_total": float(sum(coll.values())),
            "collective_op_counts": {k: int(v) for k, v in ops.items()}}
    raw = dict(cost)
    if n > 3:
        raw = {"flops": last["flops"],
               "bytes_accessed": last["bytes_accessed"],
               "collective_bytes": {k: int(v) for k, v in
                                    last["collective_bytes"].items()},
               "collective_op_counts": dict(last["collective_ops"])}
        raw["collective_bytes_total"] = float(sum(
            raw["collective_bytes"].values()))
    memory = {"argument_bytes_per_device": int(arg_bytes),
              "output_bytes_per_device": int(last["out_bytes"]),
              "temp_bytes_per_device": int(peak - arg_bytes),
              "peak_estimate_per_device": int(peak)}
    return {"memory": memory, "cost": cost, "cost_raw": raw,
            "microbatches": n, "measured_microbatches": runs,
            "run_s": sum(r["run_s"] for r in got)}


def dryrun_combo(arch: Union[str, ModelConfig],
                 shape: Union[str, ShapeConfig], *, multi_pod: bool = False,
                 impl: str = "ring", grid: Optional[Tuple[int, int]] = None,
                 perf_opts=None) -> Dict:
    """Full dry-run record for one (arch, shape, grid).  ``arch``: a
    config name (or a ``ModelConfig``); ``shape``: a name of
    ``INPUT_SHAPES`` (or a ``ShapeConfig``); ``grid``: any (data, model)
    shape (one pod), else the production grid (``multi_pod``: two pods
    folded into its 32-way data axis); ``perf_opts``: the reference's
    (``_with_perf_opts``).  The record's ``layout`` names the dense
    layout."""
    cfg = configs.get(arch) if isinstance(arch, str) else arch
    shape = INPUT_SHAPES[shape] if isinstance(shape, str) else shape
    gshape = tuple(grid) if grid is not None else production_shape(multi_pod)
    pods = 2 if grid is None and multi_pod else 1
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
    if perf_opts:
        rec["perf_opts"] = dict(perf_opts)
    cfg, sharding, gc = _with_perf_opts(cfg, perf_opts)
    rec["layout"] = sharding
    with fake_grid(*gshape, pod=pods) as g:
        run = run_fake_step(cfg, shape, g, impl, sharding, gc)
        rec["run_s"] = round(run["run_s"], 2)
        rec["memory"] = run["memory"]
        rec["memory_model"] = analytic_memory(cfg, shape, g)
        rec["cost_raw"] = run["cost_raw"]
        rec["cost"] = run["cost"]
        rec["microbatches"] = run["microbatches"]
        rec["measured_microbatches"] = run["measured_microbatches"]
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
                elif status == "skipped":
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
