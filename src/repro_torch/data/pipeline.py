"""Data pipeline: deterministic synthetic LM stream + byte-level corpus.

This package's own copy of the JAX package's ``repro/data/pipeline.py``
(numpy only): the same config and seed give the same batches.  For a
multi-process launch ``host_slice`` is a rank's rows of the global batch,
and a stream made with ``process_index`` / ``process_count`` yields only
one process's rows, from a seed of its own (as the JAX package's does).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

_BUILTIN_CORPUS = (
    "In the beginning the framework was without form, and load was upon the "
    "face of the experts. Tokens moved over the mesh, and the gate divided "
    "the hot experts from the cold. The scheduler said: let there be "
    "placement, and there was placement; and the straggler was subdued. "
    "Every iteration the shards were gathered sparsely and scattered back "
    "reduced, and the optimizer state stayed exactly where it lived. "
) * 64


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    kind: str = "synthetic"        # synthetic | bytes
    seed: int = 0
    skew: float = 0.0              # >0: zipf-skewed token ids (drives
                                   # imbalanced expert routing in benchmarks)


class LMStream:
    """Yields {tokens:(B,S+1) int32}; targets are tokens shifted by one."""

    def __init__(self, cfg: DataConfig, process_index: int = 0,
                 process_count: int = 1):
        assert cfg.global_batch % process_count == 0
        self.cfg = cfg
        self.local_batch = cfg.global_batch // process_count
        self.rng = np.random.default_rng(cfg.seed + process_index * 100003)
        if cfg.kind == "bytes":
            self.corpus = np.frombuffer(
                _BUILTIN_CORPUS.encode(), dtype=np.uint8).astype(np.int32)
            self.corpus = self.corpus % cfg.vocab_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()

    def next_batch(self) -> Dict[str, np.ndarray]:
        c = self.cfg
        shape = (self.local_batch, c.seq_len + 1)
        if c.kind == "bytes":
            starts = self.rng.integers(
                0, len(self.corpus) - c.seq_len - 1, self.local_batch)
            toks = np.stack([self.corpus[s:s + c.seq_len + 1]
                             for s in starts])
        elif c.skew > 0:
            # zipf-ish skew: concentrates mass on low token ids, which the
            # randomly initialized router maps to skewed expert loads
            z = self.rng.zipf(1.0 + c.skew, size=shape)
            toks = np.minimum(z - 1, c.vocab_size - 1).astype(np.int32)
        else:
            toks = self.rng.integers(0, c.vocab_size, shape, dtype=np.int32)
        return {"tokens": toks.astype(np.int32)}


class EmbedStubStream:
    """Batches of a frontend-stub architecture (Qwen2-VL), whose train
    step takes ``{"embeds": (B, S, D) f32, "labels": (B, S) int32}``.  The
    vision frontend is a stub in both packages; its patch and text
    embeddings stand in here as seeded normal draws, beside the next-token
    labels of the wrapped token stream."""

    def __init__(self, stream: LMStream, d_model: int, seed: int = 0):
        self.stream = stream
        self.d_model = d_model
        self.rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()

    def next_batch(self) -> Dict[str, np.ndarray]:
        toks = self.stream.next_batch()["tokens"]
        b, s = toks.shape[0], toks.shape[1] - 1
        return {"embeds": self.rng.standard_normal((b, s, self.d_model),
                                                   np.float32),
                "labels": toks[:, 1:]}


class EncoderStubStream:
    """Batches of an encoder-decoder (Whisper), whose train step takes
    ``{"encoder_input": (B, S_enc, D) f32, "tokens": (B, S+1) int32}``.
    The audio frontend is a stub in both packages; its frame embeddings
    stand in here as seeded normal draws, beside the wrapped stream's
    tokens."""

    def __init__(self, stream: LMStream, encoder_seq_len: int,
                 d_model: int, seed: int = 0):
        self.stream = stream
        self.shape = (encoder_seq_len, d_model)
        self.rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()

    def next_batch(self) -> Dict[str, np.ndarray]:
        toks = self.stream.next_batch()["tokens"]
        return {"encoder_input": self.rng.standard_normal(
                    (toks.shape[0],) + self.shape, np.float32),
                "tokens": toks}


def host_slice(global_batch: int, process_index: int, process_count: int
               ) -> slice:
    per = global_batch // process_count
    return slice(process_index * per, (process_index + 1) * per)


def microbatch_rows(global_batch: int, process_index: int,
                    process_count: int, microbatches: int) -> np.ndarray:
    """The global rows a rank takes when a step splits its rows into
    ``microbatches`` equal parts: its ``host_slice`` of each microbatch's
    rows, microbatch after microbatch, so that microbatch i holds the
    same global rows (``i·B/n`` onwards) as a step that splits the global
    batch first."""
    n = max(microbatches, 1)
    if n > 1 and global_batch % (n * process_count):
        raise ValueError(f"a global batch of {global_batch} rows does not "
                         f"split into {n} microbatches over "
                         f"{process_count} ranks")
    per_mb = global_batch // n
    rows = np.arange(per_mb)[host_slice(per_mb, process_index,
                                        process_count)]
    return np.concatenate([i * per_mb + rows for i in range(n)])


def make_stream(vocab_size: int, seq_len: int, global_batch: int,
                kind: str = "synthetic", seed: int = 0, skew: float = 0.0,
                process_index: int = 0, process_count: int = 1) -> LMStream:
    return LMStream(DataConfig(vocab_size, seq_len, global_batch, kind,
                               seed, skew), process_index, process_count)
