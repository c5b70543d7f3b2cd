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
