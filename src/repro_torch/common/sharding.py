"""Logical-axis layouts of the parameters, the batch and the caches over
the process grid, and the elastic re-layout of the chunk buffer: the port
of the JAX package's ``repro/common/sharding.py`` (and of the dry run's
``ZERO_RULES``), plain Python and numpy.

Every parameter is declared with logical axis names (``Param.axes``).
The rules map them onto the grid's axes, ``("pod", "data", "model")``:
``DEFAULT_RULES`` (the reference's ``tp`` mode: heads, ff, vocab and the
SSM's inner dim over ``model``, d_model over ``data``, the batch over
``("pod", "data")``) or with ``ZERO_RULES`` over them (the ``zero`` mode:
d_model over ``("data", "model")`` and the batch over every axis).
``shape_aware_pspec`` drops an axis that does not divide its dimension,
as the reference's does, so 8 KV heads over a 16-way ``model`` axis stay
replicated.  Where the reference hands the resulting ``PartitionSpec`` to
XLA, the port reads it as a *layout*: for each dimension the grid axes it
is split over (``dim_axes``), which ``models.parallel.Layout`` turns into
a rank's shard and into the explicit collectives of the step.

The FSSDP chunk buffer is a flat (global_rows, chunk_len) array whose row
layout is defined by the live ShardingPlan: expert (l, e) lives at global
row ``owner_dev * rows_per_device + owner_row``.  A checkpoint saved under
one EP size cannot be restored verbatim onto another, even where the row
counts agree (L=2, E=8: ep 2 and ep 4 both give 16 rows), because the
expert-to-row map differs.  ``elastic_row_remap`` and
``remap_buffer_rows`` compute and apply the per-row gather that re-lays
out a saved host array (the parameters and both AdamW moments: any array
whose leading dim is the global row dim) onto the new plan;
``train.trainer.resume_train_state`` hands them to
``checkpoint.store.restore(remap=...)``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

MeshAxes = Union[None, str, Tuple[str, ...]]

# the grid's axes, major to minor: a rank's global index is
# (pod * data + d) * model + e, jax.make_mesh's device order
MESH_AXES = ("pod", "data", "model")

# logical -> grid axes (the reference's table); ``batch`` picks up the
# "pod" axis where the grid has one
DEFAULT_RULES: Dict[str, MeshAxes] = {
    "batch": ("pod", "data"),
    "seq": None,
    "seq_shard": "data",          # long-context decode: KV seq sharded
    "embed": "data",              # d_model dim of weights (ZeRO/FSDP axis)
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ff": "model",                # dense FFN hidden
    "expert": "model",            # FSSDP: expert dim over the EP axis
    "expert_ff": "data",          # FSSDP: intra-expert FSDP axis
    "ssm_inner": "model",
    "ssm_state": None,
    "tokens": ("pod", "data", "model"),   # MoE boundary: fully token-sharded
    "tokens_batch": ("pod", "data"),      # staging point for the reshard
    "layers": None,               # scan axis
    "unsharded": None,
}

# the "zero" mode (the reference's ``launch/dryrun.py``): dense weights
# FSDP-sharded and gathered per layer, activations batch-sharded over
# every axis, so no tensor-parallel activation sums exist
ZERO_RULES: Dict[str, MeshAxes] = {
    "heads": None, "kv_heads": None, "ff": None, "ssm_inner": None,
    "embed": ("data", "model"), "batch": ("pod", "data", "model"),
}

MODES = ("tp", "zero")


def mode_rules(mode: str) -> Optional[Dict[str, MeshAxes]]:
    """The overrides of a layout mode: None for "tp", ``ZERO_RULES`` for
    "zero"."""
    if mode not in MODES:
        raise ValueError(f"sharding mode {mode!r}: one of {MODES}")
    return ZERO_RULES if mode == "zero" else None


def resolve_rules(axis_names: Sequence[str],
                  overrides: Optional[Dict[str, MeshAxes]] = None
                  ) -> Dict[str, MeshAxes]:
    """The rules with ``overrides`` applied and every axis the grid lacks
    (``pod`` on one pod) dropped."""
    rules = dict(DEFAULT_RULES)
    if overrides:
        rules.update(overrides)

    def fix(v: MeshAxes) -> MeshAxes:
        if v is None:
            return None
        if isinstance(v, str):
            return v if v in axis_names else None
        kept = tuple(a for a in v if a in axis_names)
        if not kept:
            return None
        return kept if len(kept) > 1 else kept[0]
    return {k: fix(v) for k, v in rules.items()}


def logical_to_pspec(logical_axes: Sequence[Optional[str]],
                     rules: Dict[str, MeshAxes]) -> Tuple[MeshAxes, ...]:
    """A tuple of logical axis names -> the partition entries of each
    dimension, no grid axis used twice (the first occurrence wins)."""
    used = set()
    out = []
    for name in logical_axes:
        phys = rules.get(name, None) if name is not None else None
        if phys is None:
            out.append(None)
            continue
        if isinstance(phys, str):
            phys = (phys,)
        free = tuple(a for a in phys if a not in used)
        if not free:
            out.append(None)
            continue
        used.update(free)
        out.append(free if len(free) > 1 else free[0])
    return tuple(out)


def shape_aware_pspec(shape: Sequence[int], logical_axes, rules,
                      sizes: Dict[str, int]) -> Tuple[MeshAxes, ...]:
    """``logical_to_pspec``, but an axis that does not divide what is left
    of its dimension is dropped (5 KV heads over a 16-way ``model`` axis:
    replicated); of a tuple mapping, every axis that still divides is
    kept.  ``sizes``: the grid's axis sizes by name."""
    used = set()
    out = []
    for dim, name in zip(shape, logical_axes):
        phys = rules.get(name, None) if name is not None else None
        if phys is None:
            out.append(None)
            continue
        if isinstance(phys, str):
            phys = (phys,)
        chosen = []
        prod = 1
        for a in phys:
            if a in used or a not in sizes:
                continue
            if dim % (prod * sizes[a]) == 0:
                chosen.append(a)
                prod *= sizes[a]
        if not chosen:
            out.append(None)
            continue
        used.update(chosen)
        out.append(tuple(chosen) if len(chosen) > 1 else chosen[0])
    return tuple(out)


def dim_axes(entry: MeshAxes) -> Tuple[str, ...]:
    """One partition entry as the tuple of grid axes its dimension is
    split over (``()``: whole)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def grid_sizes(data: int, model: int, pod: int = 1) -> Dict[str, int]:
    """The axis sizes of a (data, model) process grid whose ``data`` axis
    folds ``pod`` pods: ``{"pod": pod, "data": data // pod, "model":
    model}``, without ``pod`` when there is one pod (the reference's
    single-pod mesh has no such axis)."""
    if data % pod:
        raise ValueError(f"{pod} pods do not divide a data axis of {data}")
    sizes = {"data": data // pod, "model": model}
    return dict({"pod": pod}, **sizes) if pod > 1 else sizes


def layout_of(shape: Sequence[int], logical_axes, rules,
              sizes: Dict[str, int]) -> Tuple[Tuple[str, ...], ...]:
    """A leaf's layout: for each dimension the grid axes it is split over
    (``shape_aware_pspec`` read by ``dim_axes``)."""
    return tuple(dim_axes(e) for e in shape_aware_pspec(
        shape, logical_axes, rules, sizes))


def shard_shape(shape: Sequence[int], layout, sizes: Dict[str, int]
                ) -> Tuple[int, ...]:
    """A rank's shape of a leaf of global ``shape`` under ``layout``."""
    out = []
    for n, axes in zip(shape, layout):
        k = 1
        for a in axes:
            k *= sizes[a]
        out.append(n // k)
    return tuple(out)


def axes_index(axes: Sequence[str], coord: Dict[str, int],
               sizes: Dict[str, int]) -> int:
    """A rank's block index along a dimension split over ``axes`` (major
    to minor, as a ``PartitionSpec`` tuple tiles it)."""
    i = 0
    for a in axes:
        i = i * sizes[a] + coord[a]
    return i


def axes_size(axes: Sequence[str], sizes: Dict[str, int]) -> int:
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _plan_global_rows(plan) -> np.ndarray:
    """``ShardingPlan.global_rows()``, duck-typed."""
    return (np.asarray(plan.owner_dev, np.int64) * int(plan.rows_per_device)
            + np.asarray(plan.owner_row, np.int64))


def elastic_row_remap(old_plan, new_plan,
                      out_rows: Optional[int] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """The row table taking a buffer laid out by ``old_plan`` to
    ``new_plan``'s layout (any two ShardingPlans of the same (L, E),
    whatever their device counts): ``(src, valid)`` of length
    ``out_rows`` (default: the new plan's rows).  New global row ``i``
    comes from old row ``src[i]`` where ``valid[i]``, and is a pad row
    (zero-filled by :func:`remap_buffer_rows`) elsewhere."""
    if (old_plan.num_layers != new_plan.num_layers
            or old_plan.num_experts != new_plan.num_experts):
        raise ValueError(
            f"elastic remap needs matching (L, E): saved "
            f"({old_plan.num_layers}, {old_plan.num_experts}) vs new "
            f"({new_plan.num_layers}, {new_plan.num_experts})")
    old_g = _plan_global_rows(old_plan).reshape(-1)
    new_g = _plan_global_rows(new_plan).reshape(-1)
    if out_rows is None:
        out_rows = int(new_plan.rows_per_device) * int(new_plan.num_devices)
    if int(new_g.max(initial=-1)) >= out_rows:
        raise ValueError(
            f"new plan addresses row {int(new_g.max())} but the target "
            f"buffer has only {out_rows} rows")
    src = np.zeros(out_rows, np.int64)
    valid = np.zeros(out_rows, bool)
    src[new_g] = old_g
    valid[new_g] = True
    return src, valid


def remap_buffer_rows(arr: np.ndarray, src: np.ndarray,
                      valid: np.ndarray) -> np.ndarray:
    """Apply an :func:`elastic_row_remap` table to one saved host array
    (leading dim: the old global rows): the expert rows gathered into
    their new places, the new layout's pad rows zero, the dtype kept."""
    arr = np.asarray(arr)
    out = arr[np.where(valid, src, 0)]
    out[~valid] = 0
    return out
