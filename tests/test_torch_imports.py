"""The port stands alone: importing every module of ``repro_torch`` loads
no JAX and nothing of the JAX package ``repro``, and no source of the port
imports either."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
PORT = SRC / "repro_torch"


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(SRC).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_every_port_module_imports_without_jax_or_repro():
    mods = list(_modules())
    assert "repro_torch.serve.scheduler" in mods and len(mods) >= 17
    assert "repro_torch.serve.bus" in mods
    for m in ("repro_torch.checkpoint.store", "repro_torch.common.sharding",
              "repro_torch.train.supervisor", "repro_torch.train.metrics"):
        assert m in mods, m
    for arch in ("gpt_moe_s", "gpt_moe_l", "bert_moe", "bert_moe_deep",
                 "olmoe_1b_7b", "granite_moe_3b_a800m", "smollm_360m",
                 "minitron_8b", "qwen1p5_110b", "gemma2_9b", "mamba2_1p3b",
                 "jamba_v0p1_52b", "qwen2_vl_72b", "whisper_medium"):
        assert f"repro_torch.configs.{arch}" in mods, arch
    assert "repro_torch.models.mamba2" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print('BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "BAD []" in r.stdout, r.stdout


def test_no_port_source_imports_jax_or_repro():
    pat = re.compile(r"^\s*(import (jax|jaxlib|repro)\b|from (jax|jaxlib|"
                     r"repro)(\.| import))", re.M)
    for path in PORT.rglob("*.py"):
        text = path.read_text()
        assert not pat.search(text), path
        assert "from repro." not in text, path


def test_distributed_modules_import_without_jax_or_repro():
    """The modules of the distributed layer, the cost model, the
    checkpoint store and the elastic supervisor, each imported alone in a
    fresh interpreter, load no ``jax*`` and no ``repro.*`` module."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    for mod in ("repro_torch.core.schedule", "repro_torch.launch.mesh",
                "repro_torch.launch.distributed", "repro_torch.core.costs",
                "repro_torch.checkpoint.store",
                "repro_torch.train.supervisor"):
        assert (PORT / (mod.split(".", 1)[1].replace(".", "/") + ".py")
                ).exists(), mod
        code = (f"import importlib, sys\nimportlib.import_module({mod!r})\n"
                "print('BAD', sorted(m for m in sys.modules if m.split('.')"
                "[0] in ('jax', 'jaxlib', 'repro')))\n")
        r = subprocess.run([sys.executable, "-c", code], env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-3000:]
        assert "BAD []" in r.stdout, (mod, r.stdout)
