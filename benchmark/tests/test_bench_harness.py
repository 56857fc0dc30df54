"""The benchmark's files against its contract: everything found by name, new
cells added as new files, names, units and limits in range, and no run
without a card or without the program."""

from __future__ import annotations

import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_fixtures import cuda_absent, cuda_card  # noqa: E402,F401
from benchmark.harness.spec import NAME_RE, UNIT_RE, load_cell, metric_reader  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
KEYS = {"top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                "per_layer"},
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    c = load_cell(cell)
    assert c.config["name"] == next(w["config"] for w in BENCH["workloads"] if w["name"] == cell)
    assert c.traffic["lanes"] >= 1 and c.settings["limits"]
    assert hasattr(c.driver(), "run")
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.per_layer:
        assert callable(metric_reader(m["name"]))


def test_contract_keys_names_units():
    assert set(BENCH) == KEYS["top"]
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[section]]
        assert len(names) == len(set(names))
        for e in BENCH[section]:
            extra = set(e) - KEYS[section]
            assert not extra - ({"workloads"} if section in ("end_to_end", "per_layer") else set())
            assert KEYS[section] <= set(e)
            assert NAME_RE.match(e["name"])
            if "unit" in e:
                assert UNIT_RE.match(e["unit"]) and e["better"] in ("lower", "higher")
            for key in ("why", "layer"):
                assert key not in e or _line(e[key])
    for c in BENCH["configs"]:
        assert _line(c["source"]) and (ROOT / c["file"]).is_file()
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert all(NAME_RE.match(k) and k in cfg for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and NAME_RE.match(w["config"]) and NAME_RE.match(w["traffic"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)
    assert all(_line(word) for word in BENCH["command"]) and len(BENCH["command"]) <= 32
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_bounds_and_run_length():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_every_per_layer_metric_moves_what_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span",
                                                      "program_counter", "host_clock")
        for cell in m.get("workloads", CELLS):
            assert cell in e2e[m["moves"]].get("workloads", CELLS), (m["name"], cell)
    for cell in CELLS:
        c = load_cell(cell)
        assert any(m["name"] != "setup_s" for m in c.end_to_end)


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_is_new_files(tmp_path):
    """A cell with a new traffic mix and a new per-layer metric: new files and
    new entries in BENCHMARK.json, no existing file of the benchmark edited."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / "benchmark")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "mega_r101.offline_l6", "config": "mega_r101",
                               "traffic": "offline_l6", "chips": 1, "why": "six lanes"})
    bench["per_layer"].append({"name": "steps_per_window.offline", "unit": "steps",
                               "better": "higher", "source": "host_clock", "layer": "engine",
                               "moves": "frames_per_s", "workloads": ["mega_r101.offline_l6"]})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("mega_r101.offline_l6")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    b = tmp_path / "benchmark"
    traffic = json.loads((b / "traffic" / "offline_l12.json").read_text())
    traffic["lanes"] = 6
    (b / "traffic" / "offline_l6.json").write_text(json.dumps(traffic))
    shutil.copy(b / "workloads" / "mega_r101.offline_l12.json",
                b / "workloads" / "mega_r101.offline_l6.json")
    (b / "metrics" / "steps_per_window.offline.py").write_text(
        "def read(ctx):\n    return ctx['window']['steps']\n")
    cell = load_cell("mega_r101.offline_l6", root=tmp_path)
    assert cell.traffic["lanes"] == 6
    assert [m["name"] for m in cell.per_layer][-1] == "steps_per_window.offline"
    read = metric_reader.__globals__["load_module"](
        b / "metrics" / "steps_per_window.offline.py", "tmp_metric").read
    assert read({"window": {"steps": 7}}) == 7
    after = _digest(b)
    assert {k: v for k, v in after.items() if k in before} == before


def _run(cwd: Path) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0],
                           "--seed", str(2 ** 31 + 11), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result(cuda_absent):
    """Without a CUDA card the run fails and prints no result line."""
    out = _run(ROOT)
    assert out.returncode != 0 and "{" not in out.stdout


def test_without_the_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, the run fails and prints no result line."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _run(tmp_path)
    assert out.returncode != 0 and "{" not in out.stdout


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(cuda_card):
    """One short run of the first cell on the card: a correct result line."""
    out = _run(ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
