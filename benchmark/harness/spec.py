"""Everything of a cell, found by name: its entry in ``BENCHMARK.json``, its
configuration (``configs/<config>.json``), its traffic (``traffic/<traffic>.json``),
its driver (``drivers/<driver>.py``), its settings (``workloads/<cell>.json``)
and the metrics it reports, each per-layer metric a reader
``metrics/<metric>.py``. Adding a cell, a configuration, a traffic mix or
a metric adds files and entries; no existing file changes."""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import the file at ``path`` (names may hold dots) as module ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    settings: dict
    end_to_end: list = field(default_factory=list)  # BENCHMARK.json metric entries
    per_layer: list = field(default_factory=list)

    def driver(self):
        return importlib.import_module(f"benchmark.drivers.{self.settings['driver']}")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = load_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"known: {sorted(entries)}")
    w = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    base = root / "benchmark"
    return Cell(
        name=name, chips=w["chips"], config=config,
        traffic=load_json(base / "traffic" / f"{w['traffic']}.json"),
        settings=load_json(base / "workloads" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def metric_reader(name: str):
    """The per-layer metric's reader: ``read(ctx) -> float | None``."""
    return load_module(BENCH_DIR / "metrics" / f"{name}.py",
                       "benchmark_metric_" + name.replace(".", "_")).read
