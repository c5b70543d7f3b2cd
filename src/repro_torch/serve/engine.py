"""Serving engine: loop-prefill ``generate`` over the dense cache, one-shot
prefill and batched paged decode steps for the request scheduler, and the
(plan, version) state machine that lets training publish parameters into
a live engine.

FSSDP keeps the chunk buffer as the single source of truth for every MoE
parameter; the engine's only derived artifact is the materialized
compute-slot cache (``moe.materialize_chunks``: every layer's slots in the
compute dtype), built once per (plan, parameter version, buffer).  Every
decode step reads it through ``_snapshot``, one locked, consistent
(params, plan, slots) view.

The (plan, version) state machine, as in the JAX package's engine:

* LIVE: ``(self.pa, self.params, self.version)`` and the slot cache built
  for them.  Every decode step reads only live state.
* STAGED: at most one pending ``(pa, params, version)`` triple whose slots
  a background thread builds (``_staged``).  ``set_plan`` and
  ``publish_params`` both stage here, and staging composes: the last
  staged triple carries the newest plan and the newest params.

* ``publish_params`` / ``set_plan`` return once the build is submitted;
  they never touch the live cache.
* ``_step_boundary`` (run by every ``_snapshot``, between decode steps)
  promotes the staged triple atomically, and only once its build has
  finished: a decode step never waits for a build, and a step that
  straddles a publication reads old state throughout.
* ``flush()`` is a boundary that waits for the pending build.
* A build that raised is dropped at the boundary (``publish_drops``,
  ``last_publish_error``); the engine keeps serving the previous state and
  the decode path never raises.
* ``close()`` joins the builder, then drops the staged state unpromoted.

``publish_params`` does not copy the tree: the caller must not change it
in place afterwards (``train.trainer.train_loop`` publishes a snapshot).

On a CUDA device the builder runs on a stream of its own.  It waits for an
event recorded on the publisher's stream when the triple was staged, so it
reads the published tree as it stood then, and records the build's end;
``_promote`` makes the promoting thread's stream wait for that event
before any decode step reads the new slots, and marks the slots as used
there (``record_stream``), as the builder marks the buffer it reads.

On a process grid (``rt.grid``) every rank runs its own engine over its
shard of the chunk buffer, and every rank makes the same calls in the
same order (lockstep): publications, plan swaps, ``generate``, the
scheduler's ticks.  The slot cache is then this rank's (L_moe, 1, K,
chunk_len) slots from the stacked SparseAllGather
(``moe.materialize_stack``), as the JAX engine builds them on a mesh.
The builder thread issues its collectives on process groups of the
engine's own (``launch.mesh.private_grid``, made collectively with the
engine), so they never interleave with the decode or train step's on the
grid's groups; its single thread keeps the builds in staging order.
Every boundary and every flush runs one MIN all-reduce over the world,
whether or not this rank has a triple staged (behind a bus each rank
stages at its own moment), of the staged build's state and its staging
number.  A triple promotes only when every rank has staged it and built
it, so every rank serves the same version in every step; a build that
failed on any rank is dropped on all.  ``close`` destroys the engine's
groups.  ``generate`` runs each rank's rows of the batch
(``data.pipeline.host_slice``, as the grid train step takes its rows)
and all-gathers the last logits, so every rank samples the same tokens.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.common import faults
from repro_torch.common.config import ModelConfig
from repro_torch.core import moe as moe_core
from repro_torch.core.moe import PlanArrays
from repro_torch.data.pipeline import host_slice
from repro_torch.launch.mesh import destroy_grid, private_grid
from repro_torch.models import model as mdl

# a staged build's state, agreed over the ranks of a grid by its minimum
_PENDING, _FAILED, _BUILT = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class EngineHealth:
    """A lock-free snapshot of an engine's publication state and of the
    load signals an attached request scheduler reports
    (``attach_load_probe``).

    ``staged_version`` / ``staged_pending`` / ``staged_age_s`` describe
    the pending publication: the version being built, whether its build is
    still in flight, and for how long (0.0 when done or nothing staged).
    ``queue_depth`` / ``kv_used_frac`` read 0 when no scheduler is
    attached."""
    name: str
    version: int
    staged_version: Optional[int]
    staged_pending: bool
    staged_age_s: float
    publications: int
    promotions: int
    deferred_boundaries: int
    publish_drops: int
    last_publish_error: Optional[BaseException]
    closed: bool
    queue_depth: int = 0
    kv_used_frac: float = 0.0


def build_serve_step(cfg: ModelConfig, rt: mdl.Runtime):
    """fn(params, cache, tokens:(B,1), pos:int, pa, premat=None) ->
    (logits (B,1,V), cache): one decode token for B sequences at the same
    position against the dense cache (``mdl.init_cache``), which it
    updates in place.  Under ``rt.layout`` every argument is this rank's:
    its shards of the parameters, its rows of the tokens and its part of
    the cache (``mdl.init_cache(..., lay=)``: the reference's cache layout
    but for the KV heads, of which it holds those its query heads read);
    the logits are its rows' vocabulary shard where the vocabulary runs
    tensor-parallel."""
    @torch.inference_mode()
    def serve_step(params, cache, tokens, pos: int,
                   pa: Optional[PlanArrays], premat=None):
        return mdl.decode_step(cfg, rt, params, cache, tokens, pos, pa,
                               premat=premat)
    return serve_step


def build_prefill_step(cfg: ModelConfig, rt: mdl.Runtime):
    """fn(params, batch, pa, premat=None) -> (last-position logits
    (B,1,V), cache).

    The cache holds every attention layer's rotated K/V for the whole
    prompt and every mamba layer's state after it.  ``batch["embeds"]``
    (B, S, D), where given, replaces ``batch["tokens"]`` (a frontend
    stub's embeddings; ``batch["positions"]`` may give M-RoPE's (B, S, 3)
    streams); an encoder-decoder also takes ``batch["encoder_input"]`` (B,
    S_enc, D), and its cache then holds the cross K/V ``xk`` / ``xv``.
    ``batch["last_pos"]`` (optional, (B,) int) picks each
    sequence's last REAL position instead of -1: prompts padded up to a
    shape bucket keep their real positions unaffected under the causal
    mask (a model with mamba layers is prefilled at exact length: their
    state would take in the padding).  Under ``rt.layout`` the batch is
    this rank's rows, and the cache and the logits are its part of them
    (``build_serve_step``)."""
    @torch.inference_mode()
    def prefill_step(params, batch, pa: Optional[PlanArrays], premat=None):
        inputs = ({"embeds": batch["embeds"]} if "embeds" in batch
                  else {"tokens": batch["tokens"]})
        if cfg.is_encoder_decoder:
            inputs["encoder_input"] = batch["encoder_input"]
        logits, _, cache = mdl.forward(cfg, rt, params, pa=pa,
                                       positions=batch.get("positions"),
                                       collect_cache=True, premat=premat,
                                       **inputs)
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
    """Batched greedy/sampling decode engine, double-buffered against plan
    swaps and parameter publications (see the module docstring)."""

    _UNSET = object()           # "not passed" sentinel of publish_params

    def __init__(self, cfg: ModelConfig, rt: mdl.Runtime, params,
                 max_len: int = 512, pa: Optional[PlanArrays] = None,
                 version: int = 0, name: str = "engine"):
        self.cfg, self.rt, self.params, self.pa = cfg, rt, params, pa
        self.max_len = max_len
        self.version = version
        self.name = name            # replica identity (bus, fault sites)
        self.step_fn = build_serve_step(cfg, rt)
        self._premat = None
        self._premat_key = (None, None, None)   # (plan, version, buffer)
        self._staged = None     # dict: pa, params, version, fut, seq, ...
        self._stages = 0        # triples staged so far (their seq)
        self._executor = None
        # the builder's CUDA stream, made here: making a process's first
        # side stream waits for the work queued on the card, which must
        # not happen on the publication path
        buf = self._buf_of(params)
        self._stream = (torch.cuda.Stream(device=buf.device)
                        if buf is not None and buf.is_cuda else None)
        # the builder thread's process groups on a grid (collective), and
        # whether boundaries are agreed over the ranks
        self._build_grid = None
        self._lockstep = rt.grid is not None and rt.grid.size > 1
        if buf is not None and rt.grid is not None:
            self._build_grid = private_grid(rt.grid)
            self._build_grid.comm_stream = self._stream
        self._lock = threading.Lock()
        self._closed = False
        # load probe installed by an attached request scheduler:
        # () -> (queue_depth, kv_used_frac); read lock-free by health()
        self._load_probe = None
        # publications staged / boundaries that promoted / boundaries
        # that found the build in flight / staged builds dropped because
        # they raised (the exception lands in last_publish_error)
        self.publications = 0
        self.promotions = 0
        self.deferred_boundaries = 0
        self.publish_drops = 0
        self.last_publish_error: Optional[BaseException] = None

    def _check_open(self):
        if self._closed:
            raise RuntimeError("Engine is closed")

    def _buf_of(self, params):
        return params.get("moe_buffer") if self.cfg.moe.enabled else None

    # ---- background slot builder ----------------------------------------
    def _build_slots(self, pa, buf, grid=None):
        """The slot cache of (pa, buf): (L_moe, 1, K, chunk_len) or None.
        On a process grid it is this rank's stacked SparseAllGather over
        ``grid`` (default ``rt.grid``, the decode thread's groups), one
        owned row at a time."""
        if buf is None or pa is None:
            return None
        with torch.inference_mode():
            if self.rt.grid is None:
                return moe_core.materialize_chunks(self.cfg, buf, pa)
            return moe_core.materialize_stack(
                self.cfg, dataclasses.replace(self.rt.moe,
                                              grid=grid or self.rt.grid),
                buf, pa, rows_per=1)

    def _pool(self):
        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="engine-build")
        return self._executor

    def _build_async(self, pa, buf, staged_ev, stream, grid):
        """(slots, event marking their end on the device, or None on the
        CPU): the build on ``stream`` once ``staged_ev`` (the publisher's
        stream when the triple was staged) has passed, over ``grid``'s
        groups.  The engine's builder thread runs it on its own stream and
        groups, a ``PublicationBus`` on the bus's."""
        args = (pa, buf) if grid is None else (pa, buf, grid)
        if staged_ev is None:
            return self._build_slots(*args), None
        with torch.cuda.stream(stream):
            stream.wait_event(staged_ev)
            slots = self._build_slots(*args)
            if buf is not None:
                buf.record_stream(stream)
            done = torch.cuda.Event()
            done.record(stream)
        return slots, done

    def _staged_build(self, pa, buf, staged_ev, slots=_UNSET):
        """The builder thread's body: ``_build_async`` on the engine's
        stream and groups.  The fault sites live here, not in
        ``_build_slots``, so an injected failure hits the publication path
        only; ``replica.build_hang`` carries the engine's name so a fleet
        test can wedge one replica's builder.  With prebuilt ``slots`` (a
        bus shared one build between the replicas of a host) the build is
        a hand-off, and the sites still fire."""
        faults.fire("engine.publish_build")
        faults.fire("replica.build_hang", self.name)
        if slots is not Engine._UNSET:
            return slots
        return self._build_async(pa, buf, staged_ev, self._stream,
                                 self._build_grid)

    # ---- staging: set_plan / publish_params -----------------------------
    def _stage(self, pa, params, version, slots=_UNSET) -> None:
        """Submit the triple's slot build and make it the staged state
        (lock held).  ``_closed`` is re-checked under the lock that
        ``close`` sets it under, so no build is submitted after close.  A
        superseded triple's build drains on the builder thread; one that
        already raised is counted as a drop first."""
        self._check_open()
        st = self._staged
        if (st is not None and st["fut"].done()
                and st["fut"].exception() is not None):
            self._drop_failed(st)
        buf = self._buf_of(params)
        staged_ev = None
        if buf is not None and buf.is_cuda:
            staged_ev = torch.cuda.Event()
            # the publisher's stream, as of now
            staged_ev.record(torch.cuda.current_stream(buf.device))
        fut = self._pool().submit(self._staged_build, pa, buf, staged_ev,
                                  slots)
        self._stages += 1
        self._staged = dict(pa=pa, params=params, version=version, fut=fut,
                            seq=self._stages, buf=buf, base=self.params,
                            staged_at=time.monotonic())

    def set_plan(self, pa: Optional[PlanArrays], *,
                 defer: bool = True) -> None:
        """Stage the next materialization plan.

        With a live slot cache (or a pending publication) and ``defer``,
        the new plan's slots build on the background thread and swap in
        at the next step boundary; a pending publication's params and
        version stay staged with it.  Otherwise the plan installs at once
        (a pending publication with it) and the slots rebuild lazily."""
        self._check_open()
        with self._lock:
            st = self._staged
            if defer and (st is not None or self._live_slots() is not None):
                params = st["params"] if st is not None else self.params
                version = st["version"] if st is not None else self.version
                self._stage(pa, params, version)
                return
            self.pa = pa
            if st is not None:              # the publication survives
                self.params = st["params"]
                self.version = st["version"]
            self._staged = None

    def publish_params(self, params, version: Optional[int] = None, *,
                       pa=_UNSET, wait: bool = False, slots=_UNSET) -> int:
        """Stage a new parameter tree at ``version`` (default: the last
        published version + 1).  Its slots build in the background
        against the current plan (or the staged one), and the whole state
        swaps at the next step boundary.  ``pa`` stages a new plan with
        the params as one atomic pair: a publication after a reshard needs
        it, since the old plan's tables point at the rows' old owners.
        ``wait`` blocks until the build has finished (the swap still waits
        for a boundary).  ``slots``: prebuilt slots of this triple as
        ``(slots, event marking the end of their build or None)``, which
        a ``PublicationBus`` hands every replica of a host, so the staged
        build is a hand-off.  Returns the staged version."""
        self._check_open()
        with self._lock:
            st = self._staged
            if version is None:
                version = (st["version"] if st is not None
                           else self.version) + 1
            if pa is Engine._UNSET:
                pa = st["pa"] if st is not None else self.pa
            self._stage(pa, params, version, slots)
            self.publications += 1
            fut = self._staged["fut"]
        if wait:
            fut.result()
        return version

    # ---- promotion -------------------------------------------------------
    def _drop_failed(self, st) -> None:
        """A staged build raised (on this rank or, on a grid, another):
        drop the triple (lock held).  The live state keeps serving."""
        err = st["fut"].exception() if st["fut"].done() else None
        self.last_publish_error = err or RuntimeError(
            "the staged build failed on another rank of the grid")
        self._staged = None
        self.publish_drops += 1

    def _agree(self, st, expired: bool = False):
        """``(state, expired)`` of the staged triple ``st`` (None when
        nothing is staged): its build's state, ``_PENDING``, ``_FAILED``
        or ``_BUILT``, and whether a flush's wait timed out.  On a grid of
        more than one rank both are agreed by one MIN all-reduce on the
        decode thread's world group, together with the triple's staging
        number (-1 for none), which every rank runs at every boundary and
        flush, staged or not; a triple that not every rank has staged
        counts as ``_PENDING``."""
        code, seq = _PENDING, -1
        if st is not None:
            seq, fut = st["seq"], st["fut"]
            if fut.done():
                code = _FAILED if fut.exception() is not None else _BUILT
        if not self._lockstep:
            return code, expired
        grid = self.rt.grid
        dev = "cuda" if dist.get_backend(grid.world_group) == "nccl" \
            else "cpu"
        t = torch.tensor([code, seq, -seq, -int(expired)],
                         dtype=torch.int64, device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=grid.world_group)
        code, lo, neg_hi, neg_expired = t.tolist()
        return (code if lo == -neg_hi else _PENDING), neg_expired < 0

    def _boundary_locked(self) -> None:
        st = self._staged
        if st is None and not self._lockstep:
            return
        code, _ = self._agree(st)
        if st is None:
            return
        if code == _PENDING:
            self.deferred_boundaries += 1
        elif code == _FAILED:
            self._drop_failed(st)
        else:
            self._promote(st)

    def _step_boundary(self) -> None:
        """Promote the staged state if its build has finished; never
        waits for it."""
        with self._lock:
            self._boundary_locked()

    def _promote(self, st) -> None:
        """Install a staged triple as the live state (lock held).  If
        ``self.params`` was assigned directly after the triple was staged,
        the assignment wins: the staged plan installs, the staged params,
        version and slots are dropped, and slots rebuild lazily."""
        slots, done = st["fut"].result()
        if done is not None:
            stream = torch.cuda.current_stream(st["buf"].device)
            stream.wait_event(done)
            if slots is not None:
                slots.record_stream(stream)
        self.pa = st["pa"]
        if self.params is st["base"]:
            self.params, self.version = st["params"], st["version"]
            self._premat = slots
            self._premat_key = (self.pa, self.version, st["buf"])
        self._staged = None
        self.promotions += 1

    def flush(self, timeout: Optional[float] = None) -> None:
        """A boundary that waits: join the pending build and promote it.
        A build that raised is dropped as at a boundary; a timeout (on
        any rank of a grid) is raised, and so is a grid whose ranks have
        staged different triples."""
        self._check_open()
        with self._lock:
            st = self._staged
            if st is None and not self._lockstep:
                return
            expired = False
            if st is not None:
                try:
                    st["fut"].result(timeout=timeout)
                except FuturesTimeout:
                    expired = True
                except Exception:
                    pass                # dropped below
            code, expired = self._agree(st, expired)
            if expired:
                raise FuturesTimeout("Engine.flush timed out")
            if st is None:
                return
            if code == _PENDING:        # built here, not staged everywhere
                raise RuntimeError("Engine.flush: the ranks of the grid "
                                   "staged different triples")
            if code == _FAILED:
                self._drop_failed(st)
            else:
                self._promote(st)

    def close(self) -> None:
        """Join the builder, drop the staged state unpromoted and the slot
        cache; every later call raises.  Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            ex, self._executor = self._executor, None
            self._staged = None
        if ex is not None:
            ex.shutdown(wait=True)      # joins an in-flight build
        if self._build_grid is not None:
            destroy_grid(self._build_grid)
            self._build_grid = None
        with self._lock:
            self._premat = None
            self._premat_key = (None, None, None)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- the live slot cache --------------------------------------------
    def _live_slots(self):
        """The slot cache if it was built for the live (plan, version,
        buffer), else None."""
        key, old = (self.pa, self.version, self._buf_of(self.params)), \
            self._premat_key
        if (self._premat is not None and key[0] is old[0]
                and key[1] == old[1] and key[2] is old[2]):
            return self._premat
        return None

    def _materialized(self):
        """The slot cache, rebuilt when the plan, the version or the
        buffer object changed since it was built (a direct
        ``eng.params = ...`` assignment included)."""
        slots = self._live_slots()
        if slots is None:
            self._premat = None          # free the old slots first
            self._premat = self._build_slots(self.pa,
                                             self._buf_of(self.params))
            self._premat_key = (self.pa, self.version,
                                self._buf_of(self.params))
            slots = self._premat
        return slots

    def _snapshot(self):
        """One step's consistent view: run the boundary and read
        (params, pa, slots) in one locked section."""
        self._check_open()
        with self._lock:
            self._boundary_locked()
            return self.params, self.pa, self._materialized()

    # ---- health ----------------------------------------------------------
    def attach_load_probe(self, probe) -> None:
        """Install (or clear, with None) the scheduler load probe whose
        (queue_depth, kv_used_frac) surfaces through :meth:`health`."""
        self._load_probe = probe

    def health(self) -> EngineHealth:
        """Takes no lock: ``_staged`` is read once (staged dicts are
        replaced, never changed), so a poller never contends with a decode
        step; the snapshot may be one transition stale."""
        st = self._staged
        staged_version, pending, age = None, False, 0.0
        if st is not None:
            staged_version = st["version"]
            pending = not st["fut"].done()
            if pending:
                age = time.monotonic() - st["staged_at"]
        qd, kv = 0, 0.0
        probe = self._load_probe
        if probe is not None:
            try:
                qd, kv = probe()
            except Exception:
                pass                    # a dead scheduler reads unloaded
        return EngineHealth(
            name=self.name, version=self.version,
            staged_version=staged_version, staged_pending=pending,
            staged_age_s=age, publications=self.publications,
            promotions=self.promotions,
            deferred_boundaries=self.deferred_boundaries,
            publish_drops=self.publish_drops,
            last_publish_error=self.last_publish_error,
            closed=self._closed, queue_depth=int(qd),
            kv_used_frac=float(kv))

    # ---- fixed-batch generation -------------------------------------------
    def generate(self, prompts, steps: int, temperature: float = 0.0,
                 seed: int = 0, encoder_input=None) -> np.ndarray:
        """prompts: (B, P) int (left-aligned, no padding).  Prefills one
        token at a time through the decode step, then decodes ``steps``
        tokens, greedy or sampled with a ``torch.Generator`` seeded by
        ``seed``; every step runs a boundary and reads one snapshot.
        Returns (B, P + steps) int32.  On a grid of more than one rank
        (B a multiple of its size) each rank decodes its rows of the batch
        and every rank returns the whole array.

        An encoder-decoder needs ``encoder_input`` (B, S_enc, D): it is
        encoded once, with the live parameters, into the cache's cross K/V
        (``precompute_cross_kv``) before the prefill; on a grid each rank
        encodes its own rows."""
        self._check_open()
        dev = self.params["embed"]["embedding"].device
        toks = torch.as_tensor(np.asarray(prompts), dtype=torch.int32,
                               device=dev)
        b, p = toks.shape
        rows = self._rows(b)
        gen = None
        if temperature > 0.0:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
        with torch.inference_mode():
            cache = mdl.init_cache(self.cfg, toks[rows].shape[0],
                                   self.max_len, dev)
            if self.cfg.is_encoder_decoder:
                if encoder_input is None:
                    raise ValueError(f"{self.cfg.name} is an "
                                     f"encoder-decoder: generate needs "
                                     f"encoder_input")
                if not isinstance(encoder_input, torch.Tensor):
                    encoder_input = torch.from_numpy(
                        np.asarray(encoder_input))
                enc_in = encoder_input.to(dev, cache["xk"].dtype)[rows]
                enc = mdl._encode(self.cfg, self.rt, self.params["encoder"],
                                  enc_in)
                cache["xk"], cache["xv"] = mdl.precompute_cross_kv(
                    self.cfg, self.params, enc)
                del enc, enc_in
            out, logits = [toks], None
            for i in range(p):                  # loop prefill
                params, pa, premat = self._snapshot()
                logits, cache = self.step_fn(params, cache,
                                             toks[rows, i:i + 1], i, pa,
                                             premat)
            for s in range(steps):
                params, pa, premat = self._snapshot()
                nxt = _sample(self._all_rows(logits[:, -1]), temperature,
                              gen)[:, None].to(torch.int32)
                out.append(nxt)
                logits, cache = self.step_fn(params, cache, nxt[rows],
                                             p + s, pa, premat)
            return torch.cat(out, dim=1).cpu().numpy()

    # ---- the rows of a grid ---------------------------------------------
    def _rows(self, b: int) -> slice:
        """This rank's rows of a batch of ``b`` (all of them off a grid of
        more than one rank), as the grid train step takes them."""
        grid = self.rt.grid
        if grid is None or grid.size == 1:
            return slice(None)
        if b % grid.size:
            raise ValueError(f"a batch of {b} rows does not split over the "
                             f"{grid.size} ranks of the grid")
        return host_slice(b, grid.rank, grid.size)

    def _all_rows(self, t):
        """Every rank's rows of ``t`` (this rank's ``_rows``), in rank
        order: one all-gather over the grid's world (``t`` itself off a
        grid of more than one rank)."""
        grid = self.rt.grid
        if grid is None or grid.size == 1:
            return t
        t = t.contiguous()
        out = t.new_empty((grid.size * t.shape[0],) + tuple(t.shape[1:]))
        dist.all_gather_into_tensor(out, t, group=grid.world_group)
        return out


def _sample(logits, temperature: float, generator=None):
    """logits: (B, V) -> (B,) int64 tokens: argmax (first maximum) when
    ``temperature <= 0``, else a draw from softmax(logits / temperature)
    with the given ``torch.Generator``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
