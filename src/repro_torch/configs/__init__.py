"""Architecture registry of the port.  ``get(name)`` -> full ModelConfig;
``get_smoke(name)`` -> the reduced same-family variant the CPU tests use.
``PAPER`` and ``ASSIGNED`` name the JAX registry's MoE architectures
(Hecate Table 1, and the assigned MoE configs); only those listed in
``PORTED`` exist here so far.  CLI ids use dashes (``olmoe-1b-7b``), module
names underscores."""
from __future__ import annotations

import importlib

PAPER = ["gpt_moe_s", "gpt_moe_l", "bert_moe", "bert_moe_deep"]
ASSIGNED = ["olmoe_1b_7b", "granite_moe_3b_a800m"]
PORTED = PAPER + ASSIGNED


def canonical(name: str) -> str:
    return name.replace("-", "_").replace(".", "p")


def _module(name: str):
    mod = canonical(name)
    if mod not in PORTED:
        raise NotImplementedError(
            f"architecture {name!r} is not yet ported to repro_torch "
            f"(ported: {', '.join(PORTED)})")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get(name: str):
    return _module(name).config()


def get_smoke(name: str):
    return _module(name).smoke()
