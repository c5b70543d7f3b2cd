"""Continuous-batching request scheduler over the block-paged KV cache —
the port of the JAX package's ``repro/serve/scheduler.py``, with the same
request state machine, admission, prompt bucketing, preemption and TTL.

The request state machine
-------------------------
Every :class:`Request` is in exactly one state::

    QUEUED ──(admitted: pages + token budget + watermark)──▶ PREFILL
      │                                                        │
      │ (TTL expired)                 (one-shot prefill through one
      ▼                                (params, plan, slots) snapshot;
    TIMED_OUT                          a crash past the retry budget →
                                       REJECTED, else back to QUEUED)
                                                               ▼
                        ┌───────────────────────── DECODING ◀─┐
                        │                             │       │
              (TTL expired: pages freed)    (page pool exhausted: the
                        │                    YOUNGEST sequence is
                        ▼                    PREEMPTED — pages freed,
                   TIMED_OUT                 requeued at the queue head
                                             with prompt + generated —
                                             and re-prefills later)
                      DONE (max_new reached / EOS)

Terminal states are exactly ``DONE | REJECTED | TIMED_OUT``; overload
comes back as a typed result on the request (``state`` +
``finish_reason``), never as an exception from the decode path.  The
chaos sites ``serve.page_exhausted``, ``serve.request_hang`` and
``serve.prefill_crash`` (``repro_torch.common.faults``) sit where the JAX
package has them.

The overload policy
-------------------
* **Bounded queue** — ``submit`` beyond ``max_queue`` returns the request
  REJECTED (``"queue_full"``); one that can never fit the pool is
  REJECTED up front (``"too_long"``).  Preempted requests re-enter at the
  queue head and do not count against the bound.
* **Admission gate** — a free slot, the per-tick
  ``prefill_token_budget`` (the first admission of a tick always passes),
  and the ``admit_free_frac`` pool watermark while others run.
* **Preemption** — when a decoding sequence needs a page and the pool is
  exhausted, the youngest sequence is preempted and later resumes
  losslessly by re-prefill; the oldest always progresses.
* **Deadlines** — every request carries a TTL; expiry in any
  non-terminal state yields TIMED_OUT.

Each decode tick batches all slots into one fixed-shape paged decode step
(idle slots park on the trash page 0) that reads the engine's slot cache.
Counters mirror into ``RobustnessCounters`` (:meth:`robustness`).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, List, Optional

import numpy as np
import torch

from repro_torch.common import faults
from repro_torch.models import model as mdl
from repro_torch.serve.engine import (build_paged_serve_step,
                                      build_prefill_step, _sample)
from repro_torch.serve.kv_pool import KVPagePool, PageTable
from repro_torch.train import metrics as metrics_lib

QUEUED = "QUEUED"
PREFILL = "PREFILL"
DECODING = "DECODING"
DONE = "DONE"
PREEMPTED = "PREEMPTED"
REJECTED = "REJECTED"
TIMED_OUT = "TIMED_OUT"

TERMINAL = frozenset({DONE, REJECTED, TIMED_OUT})


@dataclasses.dataclass
class Request:
    """One generation request and its lifecycle state.

    ``prompt`` is the CURRENT prompt (grows across preemptions so a
    re-prefill resumes losslessly); ``orig_prompt`` is what the caller
    submitted.  ``generated`` accumulates every sampled token across
    preemptions; ``output()`` is the caller-facing trace."""
    rid: int
    orig_prompt: np.ndarray
    max_new_tokens: int
    deadline: float
    prompt: np.ndarray = None
    state: str = QUEUED
    generated: List[int] = dataclasses.field(default_factory=list)
    finish_reason: Optional[str] = None
    preemptions: int = 0
    prefill_failures: int = 0
    admitted_seq: int = -1              # admission order (youngest = max)

    def __post_init__(self):
        if self.prompt is None:
            self.prompt = self.orig_prompt

    @property
    def done(self) -> bool:
        return self.state in TERMINAL

    @property
    def remaining(self) -> int:
        return self.max_new_tokens - len(self.generated)

    def output(self) -> np.ndarray:
        """Prompt + everything generated, as one int32 trace."""
        return np.concatenate([self.orig_prompt,
                               np.asarray(self.generated, np.int32)])


class RequestScheduler:
    """Admit / prefill / batch-decode / evict individual sequences against
    one :class:`~repro_torch.serve.engine.Engine`.

    ``max_slots`` concurrent sequences share a ``num_pages``-page KV pool
    (page 0 reserved as the trash page idle slots park on), allocated on
    the device of the engine's parameters.  ``max_kv`` bounds any
    sequence's total length and fixes the decode step's shape; it defaults
    to the engine's ``max_len`` rounded up to a page multiple."""

    def __init__(self, engine, *, max_slots: int = 4, num_pages: int = 32,
                 page_size: int = 8, max_kv: Optional[int] = None,
                 max_queue: int = 16, default_ttl_s: float = 30.0,
                 prefill_token_budget: int = 2048,
                 admit_free_frac: float = 0.0, temperature: float = 0.0,
                 seed: int = 0, eos_id: Optional[int] = None,
                 max_prefill_retries: int = 1,
                 clock: Callable[[], float] = time.monotonic):
        self.engine = engine
        self.cfg, self.rt = engine.cfg, engine.rt
        self.device = engine.params["embed"]["embedding"].device
        self.pool = KVPagePool(num_pages, page_size)
        ps = page_size
        mk = max_kv if max_kv is not None else engine.max_len
        self.max_kv = -(-mk // ps) * ps             # page-aligned width
        self.max_slots = max_slots
        self.max_queue = max_queue
        self.default_ttl_s = default_ttl_s
        self.prefill_token_budget = prefill_token_budget
        self.admit_free_frac = admit_free_frac
        self.temperature = temperature
        self.seed = seed
        self.eos_id = eos_id
        self.max_prefill_retries = max_prefill_retries
        self.clock = clock
        self._step_fn = build_paged_serve_step(self.cfg, self.rt,
                                               page_size=page_size)
        self._prefill_fn = build_prefill_step(self.cfg, self.rt)
        self.cache = mdl.init_paged_cache(self.cfg, max_slots,
                                          self.pool.num_rows, self.device)

        self._queue: Deque[Request] = deque()
        self._slots: List[Optional[Request]] = [None] * max_slots
        self._tables: List[Optional[PageTable]] = [None] * max_slots
        self._positions = np.zeros(max_slots, np.int32)
        self._last_tok = np.zeros(max_slots, np.int32)
        self._row_idx = np.zeros((max_slots, self.max_kv), np.int32)
        self._next_rid = 0
        self._admit_seq = 0
        self._closed = False
        # overload counters (mirrored into RobustnessCounters)
        self.requests_rejected = 0
        self.requests_preempted = 0
        self.requests_timed_out = 0
        self.requests_completed = 0
        self.prefill_crashes = 0
        self.decode_ticks = 0
        engine.attach_load_probe(self._load)

    # ---- observability --------------------------------------------------
    def _load(self):
        """The EngineHealth load probe: (queue depth, KV occupancy)."""
        return len(self._queue), self.pool.used_frac

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    def active(self) -> List[Request]:
        return [r for r in self._slots if r is not None]

    def robustness(self) -> metrics_lib.RobustnessCounters:
        """The scheduler's overload outcomes as RobustnessCounters."""
        return metrics_lib.RobustnessCounters(
            requests_rejected=self.requests_rejected,
            requests_preempted=self.requests_preempted,
            requests_timed_out=self.requests_timed_out)

    # ---- submission -----------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 16,
               ttl_s: Optional[float] = None) -> Request:
        """Enqueue one request.  Never raises on overload: a full queue or
        an impossible-to-fit request comes back already REJECTED."""
        if self._closed:
            raise RuntimeError("RequestScheduler is closed")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        req = Request(rid=self._next_rid, orig_prompt=prompt,
                      max_new_tokens=max_new_tokens,
                      deadline=self.clock() + (ttl_s if ttl_s is not None
                                               else self.default_ttl_s))
        self._next_rid += 1
        total = prompt.size + max_new_tokens
        if (total > self.max_kv
                or self.pool.pages_for(total) > self.pool.usable_pages):
            self._reject(req, "too_long")
        elif len(self._queue) >= self.max_queue:
            self._reject(req, "queue_full")
        else:
            self._queue.append(req)
        return req

    def _reject(self, req: Request, reason: str) -> None:
        req.state = REJECTED
        req.finish_reason = reason
        self.requests_rejected += 1

    # ---- the scheduling tick -------------------------------------------
    def step(self) -> int:
        """One tick: reap deadlines, admit + prefill arrivals, run ONE
        batched paged decode step for every active sequence.  Returns the
        number of sequences that advanced."""
        if self._closed:
            raise RuntimeError("RequestScheduler is closed")
        now = self.clock()
        self._reap(now)
        self._admit(now)
        return self._decode_tick()

    def run(self, max_ticks: Optional[int] = None) -> None:
        """Drive ticks until every submitted request is terminal (or
        ``max_ticks`` elapse)."""
        ticks = 0
        while max_ticks is None or ticks < max_ticks:
            if not (self._queue or any(s is not None for s in self._slots)):
                return
            self.step()
            ticks += 1

    # ---- deadlines ------------------------------------------------------
    def _reap(self, now: float) -> None:
        for req in list(self._queue):
            if now > req.deadline:
                self._queue.remove(req)
                req.state = TIMED_OUT
                req.finish_reason = "ttl"
                self.requests_timed_out += 1
        for b, req in enumerate(self._slots):
            if req is not None and now > req.deadline:
                self._release_slot(b)
                req.state = TIMED_OUT
                req.finish_reason = "ttl"
                self.requests_timed_out += 1

    # ---- admission ------------------------------------------------------
    def _free_slot(self) -> Optional[int]:
        for b, r in enumerate(self._slots):
            if r is None:
                return b
        return None

    def _alloc(self, n: int):
        """Pool allocation behind the ``serve.page_exhausted`` chaos site:
        an armed fault reports exhaustion (None), as a full pool does."""
        try:
            faults.fire("serve.page_exhausted")
        except Exception:       # only an armed fault raises here
            return None
        return self.pool.alloc(n)

    def _admit(self, now: float) -> None:
        budget = self.prefill_token_budget
        admitted = 0
        while self._queue:
            b = self._free_slot()
            if b is None:
                return
            req = self._queue[0]
            p_len = int(req.prompt.size)
            if admitted and p_len > budget:
                return                  # token budget: next tick
            need = self.pool.pages_for(p_len + 1)   # +1: first decode write
            if (self.active() and self.pool.usable_pages
                    and (self.pool.free_pages - need) / self.pool.usable_pages
                    < self.admit_free_frac):
                return                  # watermark: leave growth headroom
            pages = self._alloc(need)
            if pages is None:
                return                  # exhausted: arrivals wait
            self._queue.popleft()
            budget -= p_len
            admitted += 1
            self._prefill(req, b, pages)

    # ---- prefill --------------------------------------------------------
    def _bucket(self, n: int) -> int:
        """Prompts pad up to a power-of-two bucket (>= 8), the shapes the
        prefill kernels take."""
        b = 8
        while b < n:
            b *= 2
        return b

    def _prefill(self, req: Request, slot: int, pages) -> bool:
        """One-shot prefill through one (params, plan, slots) snapshot;
        scatter the prompt's K/V rows into the request's pages.  A crash
        at the ``serve.prefill_crash`` site frees the pages and re-queues
        (bounded retries, then REJECTED)."""
        req.state = PREFILL
        p_len = int(req.prompt.size)
        try:
            faults.fire("serve.prefill_crash", req.rid)
        except Exception:       # only an armed fault raises here
            self.pool.free(pages)
            self.prefill_crashes += 1
            req.prefill_failures += 1
            if req.prefill_failures > self.max_prefill_retries:
                self._reject(req, "prefill_crash")
            else:
                req.state = QUEUED
                self._queue.appendleft(req)
            return False
        params, pa, premat = self.engine._snapshot()
        toks = np.zeros((1, self._bucket(p_len)), np.int32)
        toks[0, :p_len] = req.prompt
        batch = {"tokens": torch.as_tensor(toks, device=self.device),
                 "last_pos": torch.tensor([p_len - 1], device=self.device)}
        logits, pcache = self._prefill_fn(params, batch, pa, premat)
        table = PageTable(self.pool.page_size, self.max_kv, pages)
        self._slots[slot] = req
        self._tables[slot] = table
        self._row_idx[slot] = table.row_idx()
        self._positions[slot] = p_len
        req.state = DECODING
        req.admitted_seq = self._admit_seq
        self._admit_seq += 1
        self._write_prompt_kv(slot, pcache, p_len)
        tok = self._sample(req, logits[:, -1])
        self._last_tok[slot] = tok
        self._append(req, slot, tok)
        return True

    def _write_prompt_kv(self, slot: int, pcache, p_len: int) -> None:
        """Copy the prompt's K/V rows into the slot's pages (in place)."""
        rows = torch.as_tensor(self._row_idx[slot][:p_len],
                               device=self.device).long()
        for j in range(len(self.cfg.layer_pattern)):
            dst, src = self.cache[f"l{j}"], pcache[f"l{j}"]
            for kv in ("k", "v"):
                dst[kv][:, rows] = src[kv][:, 0, :p_len]

    # ---- decode ---------------------------------------------------------
    def _sample(self, req: Request, logits_row) -> int:
        """logits_row: (1, V).  Sampling draws from a generator seeded by
        (seed, request, token index), so a preempted request resumes its
        draws where it stopped."""
        if self.temperature <= 0.0:
            return int(_sample(logits_row, 0.0)[0])
        gen = torch.Generator(device=logits_row.device)
        gen.manual_seed(hash((self.seed, req.rid, len(req.generated)))
                        & 0x7FFFFFFF)
        return int(_sample(logits_row, self.temperature, gen)[0])

    def _append(self, req: Request, slot: int, tok: int) -> None:
        req.generated.append(int(tok))
        if (req.remaining <= 0
                or (self.eos_id is not None and tok == self.eos_id)):
            self._release_slot(slot)
            req.state = DONE
            req.finish_reason = ("eos" if self.eos_id is not None
                                 and tok == self.eos_id else "length")
            self.requests_completed += 1

    def _release_slot(self, b: int) -> None:
        if self._tables[b] is not None:
            self.pool.free(self._tables[b].pages)
        self._slots[b] = None
        self._tables[b] = None
        self._positions[b] = 0
        self._last_tok[b] = 0
        self._row_idx[b] = 0            # park on the trash page

    def _youngest(self) -> Optional[int]:
        best, seq = None, -1
        for b, r in enumerate(self._slots):
            if r is not None and r.admitted_seq > seq:
                best, seq = b, r.admitted_seq
        return best

    def _preempt(self, b: int) -> None:
        """Release slot b's pages and requeue it at the head with its
        prompt extended by everything generated (lossless resume)."""
        req = self._slots[b]
        self._release_slot(b)
        req.state = PREEMPTED
        req.preemptions += 1
        self.requests_preempted += 1
        req.prompt = np.concatenate(
            [req.orig_prompt, np.asarray(req.generated, np.int32)])
        req.state = QUEUED
        self._queue.appendleft(req)     # head: oldest-work-first

    def _ensure_pages(self) -> None:
        """Every active sequence's next write position must be paged; an
        exhausted pool preempts the youngest sequence until it fits."""
        for b in range(self.max_slots):
            req = self._slots[b]
            if req is None:
                continue
            table = self._tables[b]
            while int(self._positions[b]) >= table.capacity:
                got = self._alloc(1)
                if got is not None:
                    table.pages.extend(got)
                    self._row_idx[b] = table.row_idx()
                    continue
                victim = self._youngest()
                self._preempt(victim)
                if victim == b:
                    break               # the writer itself was youngest

    def _decode_tick(self) -> int:
        self._ensure_pages()
        live = [b for b in range(self.max_slots)
                if self._slots[b] is not None]
        if not live:
            return 0
        # a hung request (chaos site) makes no progress this tick: it keeps
        # its slot, recomputes an idempotent KV write, and its TTL reaps it
        hung = set()
        for b in live:
            try:
                faults.fire("serve.request_hang", self._slots[b].rid)
            except Exception:   # only an armed fault raises here
                hung.add(b)
        params, pa, premat = self.engine._snapshot()
        dev = self.device
        logits, self.cache = self._step_fn(
            params, self.cache,
            torch.as_tensor(self._last_tok[:, None], device=dev),
            torch.as_tensor(self._positions, device=dev),
            torch.as_tensor(self._row_idx, device=dev), pa, premat)
        self.decode_ticks += 1
        lg = logits[:, -1]
        greedy = (_sample(lg, 0.0).cpu().numpy()
                  if self.temperature <= 0.0 else None)
        advanced = 0
        for b in live:
            req = self._slots[b]
            if req is None or b in hung:
                continue
            self._positions[b] += 1
            tok = (int(greedy[b]) if greedy is not None
                   else self._sample(req, lg[b:b + 1]))
            self._last_tok[b] = tok
            self._append(req, b, tok)
            advanced += 1
        return advanced

    # ---- lifecycle ------------------------------------------------------
    def close(self) -> None:
        """Detach from the engine.  Queued/active requests stay in their
        current (non-terminal) states."""
        if self._closed:
            return
        self._closed = True
        self.engine.attach_load_probe(None)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
