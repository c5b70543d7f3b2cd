"""Elastic re-layout of the chunk buffer: the port of the JAX package's
``elastic_row_remap`` and ``remap_buffer_rows``
(``repro/common/sharding.py``), plain numpy.

The FSSDP chunk buffer is a flat (global_rows, chunk_len) array whose row
layout is defined by the live ShardingPlan: expert (l, e) lives at global
row ``owner_dev * rows_per_device + owner_row``.  A checkpoint saved under
one EP size cannot be restored verbatim onto another, even where the row
counts agree (L=2, E=8: ep 2 and ep 4 both give 16 rows), because the
expert-to-row map differs.  These helpers compute and apply the per-row
gather that re-lays out a saved host array (the parameters and both AdamW
moments: any array whose leading dim is the global row dim) onto the new
plan; ``train.trainer.resume_train_state`` hands them to
``checkpoint.store.restore(remap=...)``.

The reference's partition-spec helpers (logical axes to ``PartitionSpec``,
``with_sharding_constraint``) are XLA's and have no counterpart: the port
lays its shards out explicitly (``launch.mesh``, ``models.model.
shard_params``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


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
