"""Hecate scheduler pieces of the port: load prediction.

This package's own copy of the JAX package's ``repro/core/schedule.py``
``LoadPredictor`` (numpy only).  Algorithms 1 and 2 (sparse
materialization, heterogeneous resharding) come with the distributed
layer; at world size 1 the ``ep`` plan needs neither.
"""
from __future__ import annotations

import numpy as np


class LoadPredictor:
    """Predicts next-iteration expert loads per MoE layer from history
    (paper §3.2: sliding-window average, w = 5)."""

    def __init__(self, num_layers: int, num_experts: int, window: int = 5):
        self.window = window
        self.history: list[np.ndarray] = []   # each (L, E) token counts
        self.num_layers = num_layers
        self.num_experts = num_experts

    def observe(self, loads: np.ndarray) -> None:
        loads = np.asarray(loads, np.float64)
        assert loads.shape == (self.num_layers, self.num_experts)
        self.history.append(loads)
        if len(self.history) > self.window:
            self.history.pop(0)

    def predict(self) -> np.ndarray:
        if not self.history:
            return np.ones((self.num_layers, self.num_experts))
        return np.mean(self.history, axis=0)
