"""banzai_tpu_torch stands alone: no module of the port, and not
``chip_smoke.py``, imports the JAX package ``banzai_tpu`` or JAX."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "banzai_tpu_torch"


def _modules() -> list[str]:
    names = []
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        names.append(".".join(parts))
    return names


def _run(code: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


_LOADED = """
import sys, json
loaded = lambda: sorted(m for m in sys.modules
                        if m == "jax" or m.startswith("jax.")
                        or m == "banzai_tpu" or m.startswith("banzai_tpu."))
"""


def test_every_module_imports_and_compresses_without_the_jax_package():
    mods = _modules()
    assert {"banzai_tpu_torch.cli", "banzai_tpu_torch.fuzz",
            "banzai_tpu_torch.native",
            "banzai_tpu_torch.oracle"} <= set(mods)
    code = _LOADED + f"""
import importlib, bz2
for m in {mods!r}:
    importlib.import_module(m)
import banzai_tpu_torch
out = banzai_tpu_torch.compress(b"abc" * 1000, 9, device="cpu")
assert bz2.decompress(out) == b"abc" * 1000
print(json.dumps({{"loaded": loaded()}}))
"""
    assert _run(code)["loaded"] == []


@pytest.mark.parametrize("module", [
    "banzai_tpu_torch",
    "banzai_tpu_torch.encoder_host",
    "banzai_tpu_torch.cli",
])
def test_host_side_imports_no_torch(module):
    """Spawned hybrid workers unpickle ``encoder_host`` functions, which
    imports the package's ``__init__``: neither may pull in torch (or
    the JAX package)."""
    code = _LOADED + f"""
import importlib
importlib.import_module({module!r})
print(json.dumps({{"torch": "torch" in sys.modules, "loaded": loaded()}}))
"""
    assert _run(code) == {"torch": False, "loaded": []}


def _jax_package_imports(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            if top in ("banzai_tpu", "jax", "jaxlib"):
                bad.append(f"{path.relative_to(ROOT)}:{node.lineno} {n}")
    return bad


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [
    ROOT / "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_the_jax_package(path):
    assert _jax_package_imports(path) == []
