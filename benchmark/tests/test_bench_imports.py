"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
references load nothing of the port. Top-level module names are compared
whole: ``mega_pytorch_tpu_torch`` is the port, ``mega_pytorch_tpu`` the JAX
package."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.harness.result import FORBIDDEN, loaded_forbidden  # noqa: E402

PROBE = """
import sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
{body}
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(",".join(tops))
"""


def _top_levels(body: str) -> set:
    code = PROBE.format(root=str(ROOT), tests=str(ROOT / "benchmark" / "tests"), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.strip().splitlines()[-1].split(","))


def test_a_tiny_run_loads_no_jax():
    """A whole driver run on the CPU: the modules loaded at its end."""
    tops = _top_levels(
        "import time\n"
        "from bench_tiny import tiny_cell\n"
        "from benchmark.drivers import offline_lockstep as ol\n"
        "ol.run(tiny_cell('mega'), 5, 0.5, False, time.time(), device='cpu')\n")
    assert "mega_pytorch_tpu_torch" in tops
    assert not tops & set(FORBIDDEN), tops & set(FORBIDDEN)


def test_the_references_load_nothing_of_the_port():
    tops = _top_levels("import benchmark.reference.vid, benchmark.reference.params, "
                       "benchmark.reference.ops")
    assert not tops & ({"mega_pytorch_tpu_torch"} | set(FORBIDDEN))
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in ({"mega_pytorch_tpu_torch"} | set(FORBIDDEN))


def test_the_guard_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "mega_pytorch_tpu_torch_probe", sys)
    assert "mega_pytorch_tpu" not in loaded_forbidden()
    monkeypatch.setitem(sys.modules, "mega_pytorch_tpu.ops", sys)
    assert "mega_pytorch_tpu" in loaded_forbidden()
