"""Serving engine: one-shot prefill and batched paged decode steps, and the
(plan, version) slot cache they read.

FSSDP keeps the chunk buffer as the single source of truth for every MoE
parameter; the engine's only derived artifact is the materialized
compute-slot cache (``moe.materialize_chunks``: every layer's slots in the
compute dtype).  It is built once per (plan epoch, parameter version,
buffer) and every prefill and decode step reads it through ``_snapshot``,
one locked, consistent (params, plan, slots) view.

The background publication machinery of the JAX package's engine
(``publish_params``, staged ``set_plan`` with promotion at step
boundaries, the background slot-building thread) is not yet ported.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.core import moe as moe_core
from repro_torch.core.moe import PlanArrays
from repro_torch.models import model as mdl


@dataclasses.dataclass(frozen=True)
class EngineHealth:
    """A lock-free snapshot of an engine's state and the load signals an
    attached request scheduler reports (``attach_load_probe``)."""
    name: str
    version: int
    closed: bool
    queue_depth: int = 0
    kv_used_frac: float = 0.0


def build_prefill_step(cfg: ModelConfig, rt: mdl.Runtime):
    """fn(params, batch, pa, premat=None) -> (last-position logits
    (B,1,V), cache).

    The cache holds every layer's rotated K/V for the whole prompt.
    ``batch["last_pos"]`` (optional, (B,) int) picks each sequence's last
    REAL position instead of -1: prompts padded up to a shape bucket keep
    their real positions unaffected under the causal mask."""
    @torch.inference_mode()
    def prefill_step(params, batch, pa: Optional[PlanArrays], premat=None):
        logits, _, cache = mdl.forward(cfg, rt, params, batch["tokens"],
                                       pa=pa, collect_cache=True,
                                       premat=premat)
        if "last_pos" in batch:
            idx = batch["last_pos"].long()
            last = logits[torch.arange(logits.shape[0],
                                       device=logits.device), idx]
            return last[:, None], cache
        return logits[:, -1:], cache
    return prefill_step


def build_paged_serve_step(cfg: ModelConfig, rt: mdl.Runtime,
                           page_size: int):
    """fn(params, cache, tokens:(B,1), positions:(B,), row_idx:(B,max_kv),
    pa, premat=None) -> (logits (B,1,V), cache): one decode token for B
    independent sequences against the block-paged cache of ``page_size``
    pages, which it updates in place."""
    @torch.inference_mode()
    def paged_step(params, cache, tokens, positions, row_idx,
                   pa: Optional[PlanArrays], premat=None):
        return mdl.decode_step(cfg, rt, params, cache, tokens, positions,
                               pa, premat=premat, row_idx=row_idx,
                               page_size=page_size)
    return paged_step


class Engine:
    """Holds the served model state (config, runtime, parameters, plan,
    version) and its per-(plan, version) compute-slot cache."""

    def __init__(self, cfg: ModelConfig, rt: mdl.Runtime, params,
                 max_len: int = 512, pa: Optional[PlanArrays] = None,
                 version: int = 0, name: str = "engine"):
        self.cfg, self.rt, self.params, self.pa = cfg, rt, params, pa
        self.max_len = max_len
        self.version = version
        self.name = name
        self._premat = None
        self._premat_key = (None, None, None)   # (plan, version, buffer)
        self._lock = threading.Lock()
        self._closed = False
        # load probe installed by an attached request scheduler:
        # () -> (queue_depth, kv_used_frac); read lock-free by health()
        self._load_probe = None

    def _check_open(self):
        if self._closed:
            raise RuntimeError("Engine is closed")

    def _buf_of(self, params):
        return params.get("moe_buffer") if self.cfg.moe.enabled else None

    def _materialized(self):
        """The slot cache: (L_moe, 1, K, chunk_len) or None.  Rebuilt when
        the plan, the version or the buffer object changed since it was
        built (a direct ``eng.params = ...`` assignment included)."""
        buf = self._buf_of(self.params)
        if buf is None or self.pa is None:
            return None
        key = (self.pa, self.version, buf)
        old = self._premat_key
        if (self._premat is None or key[0] is not old[0]
                or key[1] != old[1] or key[2] is not old[2]):
            self._premat = None          # free the old slots first
            with torch.inference_mode():
                self._premat = moe_core.materialize_chunks(self.cfg, buf,
                                                           self.pa)
            self._premat_key = key
        return self._premat

    def _snapshot(self):
        """One step's consistent (params, pa, slots) view."""
        self._check_open()
        with self._lock:
            return self.params, self.pa, self._materialized()

    def attach_load_probe(self, probe) -> None:
        """Install (or clear, with None) the scheduler load probe whose
        (queue_depth, kv_used_frac) surfaces through :meth:`health`."""
        self._load_probe = probe

    def health(self) -> EngineHealth:
        qd, kv = 0, 0.0
        probe = self._load_probe
        if probe is not None:
            qd, kv = probe()
        return EngineHealth(name=self.name, version=self.version,
                            closed=self._closed, queue_depth=int(qd),
                            kv_used_frac=float(kv))

    def close(self) -> None:
        """Drop the slot cache; every later snapshot raises.  Idempotent."""
        with self._lock:
            self._closed = True
            self._premat = None
            self._premat_key = (None, None, None)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _sample(logits, temperature: float, generator=None):
    """logits: (B, V) -> (B,) int64 tokens: argmax (first maximum) when
    ``temperature <= 0``, else a draw from softmax(logits / temperature)
    with the given ``torch.Generator``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
