"""Architecture registry of the port.  ``get(name)`` -> full ModelConfig;
``get_smoke(name)`` -> the reduced same-family variant the CPU tests use.
``ASSIGNED`` and ``PAPER`` mirror the JAX registry's lists (the assigned
architectures, and the paper's MoE models of Hecate Table 1), and all of
them are ported (``PORTED``); any other name raises "not yet ported".
CLI ids use dashes (``olmoe-1b-7b``, ``mamba2-1.3b``), module names
underscores."""
from __future__ import annotations

import importlib

ASSIGNED = [
    "minitron_8b", "mamba2_1p3b", "qwen1p5_110b", "smollm_360m",
    "jamba_v0p1_52b", "gemma2_9b", "olmoe_1b_7b", "qwen2_vl_72b",
    "granite_moe_3b_a800m", "whisper_medium",
]
PAPER = ["gpt_moe_s", "gpt_moe_l", "bert_moe", "bert_moe_deep"]
PORTED = PAPER + ASSIGNED

# CLI ids whose dashes and dots do not map mechanically (the JAX
# registry's aliases)
_ALIASES = {
    "mamba2-1.3b": "mamba2_1p3b",
    "qwen1.5-110b": "qwen1p5_110b",
    "jamba-v0.1-52b": "jamba_v0p1_52b",
}


def canonical(name: str) -> str:
    return _ALIASES.get(name, name.replace("-", "_").replace(".", "p"))


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
