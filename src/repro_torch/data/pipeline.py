"""Data pipeline: deterministic synthetic LM stream + byte-level corpus.

This package's own copy of the JAX package's ``repro/data/pipeline.py``
(numpy only): the same config and seed give the same batches.  The
per-host slicing of multi-process launches comes with the distributed
layer; here one process makes the whole batch.
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

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        if cfg.kind == "bytes":
            self.corpus = np.frombuffer(
                _BUILTIN_CORPUS.encode(), dtype=np.uint8).astype(np.int32)
            self.corpus = self.corpus % cfg.vocab_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()

    def next_batch(self) -> Dict[str, np.ndarray]:
        c = self.cfg
        shape = (c.global_batch, c.seq_len + 1)
        if c.kind == "bytes":
            starts = self.rng.integers(
                0, len(self.corpus) - c.seq_len - 1, c.global_batch)
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


def make_stream(vocab_size: int, seq_len: int, global_batch: int,
                kind: str = "synthetic", seed: int = 0, skew: float = 0.0
                ) -> LMStream:
    return LMStream(DataConfig(vocab_size, seq_len, global_batch, kind,
                               seed, skew))
