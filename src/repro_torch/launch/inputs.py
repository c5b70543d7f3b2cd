"""Stand-in inputs of the dry run (``launch.dryrun``) for every
(architecture x input shape x grid) combination: the port's counterpart
of the JAX package's ``repro/launch/inputs.py``.

Where the reference makes ``jax.ShapeDtypeStruct``s with shardings, the
port makes tensors under a ``FakeTensorMode`` the caller passes in: the
shapes and dtypes of what one rank of a process grid holds, with nothing
allocated.  Under a dense layout (``models.model.make_layout``: the
reference's ``tp`` or ``zero`` mode) a rank holds its shard of every
parameter, its rows of the batch and its part of the decode cache.
Without one (``layout=None``) it holds whole rows of the global batch and
every dense parameter, and only the chunk buffer is sharded, its rows over
``model`` and its columns over ``data`` (``models.model.shard_params``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.common import sharding as shd
from repro_torch.common.config import ModelConfig, ShapeConfig
from repro_torch.common.params import _leaves, _set, torch_dtype
from repro_torch.core import moe as moe_core
from repro_torch.core.moe import MoERuntime
from repro_torch.models import model as mdl
from repro_torch.optim import adamw
from repro_torch.train.step import TrainState

_CPU = torch.device("cpu")


def ep_size(grid) -> int:
    return grid.model


def batch_axes(grid, layout=None) -> Tuple[str, ...]:
    """The grid axes the batch is split over.  Under a layout its
    ``row_axes``: in ``tp`` the reference's, every axis but ``model``; in
    ``zero`` every axis; an axis that does not divide the global batch is
    dropped (``long_500k``'s one sequence is replicated).  Without one
    both axes, since each rank runs the whole model on its own rows."""
    return ("data", "model") if layout is None else layout.row_axes


def mesh_batch_size(grid, layout=None) -> int:
    """Ranks the global batch is split over (``batch_axes``).  Without a
    layout every rank of the grid (no tensor-parallel dense layers: a rank
    of the ``model`` axis cannot share rows with its EP peers); on an
    (N, 1) grid this equals the reference's value."""
    return grid.size if layout is None else layout.rows


def make_runtime(cfg: ModelConfig, grid, *, impl: str = "ring",
                 use_pallas: bool = False, capacity: int = 0,
                 layout=None) -> mdl.Runtime:
    """The runtime of a training step on ``grid`` (None: world size 1, the
    ``ep`` plan).  ``impl`` is the plan's (``ep`` runs the layer without
    extra slots); the grouped expert FFN takes its kernels.  ``use_pallas``
    routes attention's prefill to the flash kernel (off by default: it has
    no backward); ``capacity`` is the tokens per (source, slot) cell (0:
    ``auto_capacity``); ``layout`` the dense layout (``make_layout``)."""
    moe_rt = MoERuntime(grid=grid, impl="none" if impl == "ep" else impl,
                        capacity=capacity)
    return mdl.Runtime(use_pallas=use_pallas, moe=moe_rt, layout=layout)


def make_layout(cfg: ModelConfig, shape: ShapeConfig, grid,
                mode: Optional[str] = "tp", grad_constraint: bool = False):
    """The dense layout of ``shape``'s step on ``grid`` in ``mode`` ("tp",
    "zero"; None: no layout)."""
    if mode is None:
        return None
    return mdl.make_layout(cfg, grid, mode, global_batch=shape.global_batch,
                           grad_constraint=grad_constraint)


# ---------------------------------------------------------------------------
# Parameters / optimizer / plan tables
# ---------------------------------------------------------------------------
def abstract_params(cfg: ModelConfig, grid, mode, layout=None):
    """One rank's parameter tree, fake: under a ``layout`` every leaf in
    its shard shape, made directly; without one every dense parameter
    whole and the chunk buffer's shard (``models.model.shard_params``)."""
    out: Dict[str, Any] = {}
    with mode:
        for path, p in _leaves(mdl.param_decls(cfg, ep_size(grid))):
            shape = p.shape
            if layout is not None:
                node = layout.dims
                for k in path:
                    node = node[k]
                shape = shd.shard_shape(shape, node, layout.sizes)
            _set(out, path, torch.empty(
                shape, dtype=torch_dtype(p.dtype or cfg.param_dtype),
                device=_CPU))
        return out if layout is not None else mdl.shard_params(out, grid)


def abstract_state(cfg: ModelConfig, grid, mode, layout=None) -> TrainState:
    """One rank's training state, fake: the parameters, AdamW's f32
    moments of each and the step."""
    params = abstract_params(cfg, grid, mode, layout)
    with mode:
        return TrainState(params=params, opt=adamw.init(params),
                          step=torch.zeros((), dtype=torch.int32,
                                           device=_CPU))


def concrete_plan(cfg: ModelConfig, ep: int, impl: str = "ring",
                  loads: Optional[np.ndarray] = None, device="cuda"):
    """Real plan tables on ``device`` for executing distributed steps:
    the homogeneous sharding over ``ep`` ranks and, for ``ring`` / ``a2a``
    / ``dense``, Algorithm 1 on ``loads`` (uniform by default), as the
    reference makes them."""
    from repro_torch.core.placement import (ep_materialization,
                                            homogeneous_sharding)
    from repro_torch.core.schedule import sparse_materialization
    L = moe_core.num_moe_layers(cfg)
    sh = homogeneous_sharding(L, cfg.moe.num_experts, ep)
    if impl == "ep":
        return moe_core.plan_to_arrays(ep_materialization(sh), device)
    if loads is None:
        loads = np.ones((L, cfg.moe.num_experts))
    plan = sparse_materialization(sh, loads, t=cfg.moe.num_experts,
                                  m=cfg.moe.slots_per_device, impl=impl)
    return moe_core.plan_to_arrays(plan, device)


def abstract_plan(cfg: ModelConfig, grid, mode, impl: str = "ring"):
    """Fake plan tables of ``concrete_plan``'s shapes and dtype (int32),
    or None for a model without experts."""
    if not cfg.moe.enabled:
        return None
    real = concrete_plan(cfg, ep_size(grid), impl, device=_CPU)
    with mode:
        return moe_core.PlanArrays(*[torch.empty(t.shape, dtype=t.dtype,
                                                 device=_CPU)
                                     for t in real])


# ---------------------------------------------------------------------------
# Batches / caches per input shape
# ---------------------------------------------------------------------------
def effective_seq(cfg: ModelConfig, shape: ShapeConfig) -> int:
    if cfg.max_decoder_len:
        return min(shape.seq_len, cfg.max_decoder_len)
    return shape.seq_len


def rows_per_rank(shape: ShapeConfig, grid, layout=None) -> int:
    """A rank's rows of the global batch (``mesh_batch_size``)."""
    n = mesh_batch_size(grid, layout)
    if shape.global_batch % n:
        raise ValueError(f"global batch {shape.global_batch} does not split "
                         f"over {n} ranks")
    return shape.global_batch // n


def abstract_batch(cfg: ModelConfig, shape: ShapeConfig, grid, mode,
                   layout=None) -> Dict[str, Any]:
    """One rank's training or prefill batch, fake: tokens (one more for
    the training labels), a vision frontend's embeddings (and labels), or
    an encoder-decoder's frames and tokens."""
    b = rows_per_rank(shape, grid, layout)
    s = effective_seq(cfg, shape)
    plus = 1 if shape.mode == "train" else 0
    dt = torch_dtype(cfg.dtype)
    with mode:
        def empty(shp, dtype=torch.int32):
            return torch.empty(shp, dtype=dtype, device=_CPU)
        if cfg.frontend == "vision":
            out = {"embeds": empty((b, s, cfg.d_model), dt)}
            if shape.mode == "train":
                out["labels"] = empty((b, s))
            return out
        if cfg.is_encoder_decoder:
            return {"encoder_input": empty((b, cfg.encoder_seq_len,
                                            cfg.d_model), dt),
                    "tokens": empty((b, s + plus))}
        return {"tokens": empty((b, s + plus))}


def abstract_decode_inputs(cfg: ModelConfig, shape: ShapeConfig, grid, mode,
                           layout=None):
    """(cache, tokens, pos) of one rank's decode step: the dense cache of
    its rows at the shape's length (under a layout its part of it:
    ``models.model.init_cache``), one token a row, and the position
    written (the last; a Python int, as the dense decode takes it)."""
    b = rows_per_rank(shape, grid, layout)
    s = effective_seq(cfg, shape)
    with mode:
        if layout is None:
            cache = mdl.init_cache(cfg, b, s, device=_CPU)
        else:
            cache = mdl.init_cache(cfg, shape.global_batch, s, device=_CPU,
                                   lay=layout)
        tokens = torch.empty((b, 1), dtype=torch.int32, device=_CPU)
    return cache, tokens, s - 1


# ---------------------------------------------------------------------------
# Applicability (the reference's)
# ---------------------------------------------------------------------------
def skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    if shape.name == "long_500k" and not cfg.supports_long_context():
        return ("pure full-attention architecture: no sub-quadratic variant "
                "in the published design — long_500k skipped (DESIGN.md)")
    return None


def shape_note(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    s = effective_seq(cfg, shape)
    if s != shape.seq_len:
        return (f"seq capped at the architecture's maximum "
                f"({cfg.max_decoder_len}); lowered at seq={s}")
    return None
