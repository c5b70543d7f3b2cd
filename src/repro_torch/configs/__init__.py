"""Architecture registry of the port.  ``get(name)`` -> full ModelConfig;
``get_smoke(name)`` -> the reduced same-family variant the CPU tests use.
Only the architectures listed in ``PORTED`` exist here so far."""
from __future__ import annotations

import importlib

PORTED = ["gpt_moe_s"]


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
