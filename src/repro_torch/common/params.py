"""Parameter declaration machinery and the weight bridge to the JAX package.

Model code declares parameters as ``Param`` descriptors carrying shape,
logical sharding axes and an initializer; ``init_tree`` materializes them
as tensors on an explicit device from an explicit ``torch.Generator``.  A
parameter tree is a nested dict of tensors with the same keys and layouts
as the JAX package's ``repro.models.model.init_params`` tree, so
``params_from_jax`` / ``params_to_numpy`` move weights across the two
packages bit for bit (the two random generators differ, so the port's own
init never matches JAX's).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class Param:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"        # normal | zeros | ones | scaled
    scale: float = 1.0
    dtype: Optional[str] = None  # override param dtype

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def torch_dtype(name) -> torch.dtype:
    """``"bfloat16"`` / ``"float32"`` (config strings) -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16, "int32": torch.int32}[name]


def _init_one(p: Param, gen: torch.Generator, param_dtype: str, device):
    dtype = torch_dtype(p.dtype or param_dtype)
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dtype, device=device)
    if p.init == "scaled":  # fan-in scaled normal
        fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
        std = p.scale / math.sqrt(fan_in)
    elif p.init == "normal":
        std = 0.02 * p.scale
    else:
        raise ValueError(f"unknown init {p.init!r}")
    a = torch.randn(p.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return a.mul_(std).to(dtype)


def _leaves(tree, prefix=()):
    """(path, leaf) pairs in sorted-key order — deterministic init order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def init_tree(tree, seed: int, param_dtype: str = "float32",
              device="cuda"):
    """Materialize a ``Param`` tree on ``device`` from one seeded
    ``torch.Generator`` living on that device."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = {}
    for path, p in _leaves(tree):
        _set(out, path, _init_one(p, gen, param_dtype, device))
    return out


def stack_params(tree, n: int, axis_name: str = "layers"):
    """Add a leading axis of size n to every Param in the tree."""
    if isinstance(tree, dict):
        return {k: stack_params(v, n, axis_name) for k, v in tree.items()}
    return Param((n,) + tree.shape, (axis_name,) + tree.axes,
                 init=tree.init, scale=tree.scale, dtype=tree.dtype)


def params_from_jax(np_tree, device="cuda", dtype=None):
    """The weight bridge: a JAX parameter tree (leaves converted with
    ``np.asarray``) -> the port's nested dict of tensors on ``device``.
    ``dtype`` (optional) casts every floating leaf; None keeps each leaf's
    own dtype, which makes the round trip through ``params_to_numpy``
    bit-exact."""
    out = {}
    for path, a in _leaves(np_tree):
        t = torch.from_numpy(np.array(a, copy=True))
        if dtype is not None and t.is_floating_point():
            t = t.to(torch_dtype(dtype))
        _set(out, path, t.to(device))
    return out


def params_to_numpy(tree):
    """The port's parameter tree -> nested dict of numpy arrays."""
    out = {}
    for path, t in _leaves(tree):
        _set(out, path, t.detach().cpu().numpy())
    return out
