"""No module the benchmark runs loads JAX or the JAX package (whole
top-level names), and the reference loads nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "banzai_tpu"}


def imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def sources(sub: str = ""):
    return [p for p in (ROOT / sub).rglob("*.py") if "tests" not in p.relative_to(ROOT).parts]


def test_no_source_imports_jax_or_the_jax_package():
    for p in sources():
        assert not imported(p) & BANNED, p


def test_reference_imports_nothing_of_the_program():
    for p in sources("reference"):
        names = imported(p)
        assert not names & (BANNED | {"banzai_tpu_torch", "torch"}), p
        assert names <= {"__future__", "dataclasses", "numpy", "zlib"}, (p, names)


def test_a_run_loads_no_banned_module():
    """Everything a run imports, on the CPU: the harness, every reader
    and generator, the program's entry; then the guard's own list."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import harness, spec, pool, control\n"
        "b = spec.load()\n"
        "[spec.reader(m['name']) for m in b['end_to_end'] + b['per_layer']]\n"
        "t = [pool.load_traffic(w['traffic']) for w in b['workloads']]\n"
        "[pool.generator(c['generator']) for x in t for c in x['categories']]\n"
        "import banzai_tpu_torch, banzai_tpu_torch.pipeline\n"
        "bad = harness.banned_modules()\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & %r), bad)\n"
    ) % (str(ROOT.parent), BANNED)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    assert out.strip() == "[] []"
