"""Everything a run reads by name: `BENCHMARK.json` at the checkout's root,
the cell's file in `workloads/`, its configuration in `configs/`, its
traffic mix in `traffic/`, the mix's mode in `modes/<mode>.py` (how the
system is built, warmed up, driven and checked), and one reader per
metric in `metrics/<name>.py`. A cell, a mix, a mode or a metric is added
by adding files and `BENCHMARK.json` entries; nothing here names one."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    bench: Dict          # BENCHMARK.json
    entry: Dict          # its workloads entry
    workload: Dict       # workloads/<name>.json
    config: Dict         # configs/<config>.json
    traffic: Dict        # traffic/<traffic>.json

    def metrics(self, kind: str) -> List[Dict]:
        """The cell's `end_to_end` or `per_layer` metrics: those that list
        it under `workloads`, or list no cells."""
        return [m for m in self.bench[kind]
                if self.name in m.get("workloads", [self.name])]


def load_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = read_json(bench_path)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no cell {name!r} in {bench_path.name}: "
                       f"{sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(ROOT / configs[entry["config"]]["file"])
    return Cell(name, bench, entry,
                read_json(BENCH_DIR / "workloads" / f"{name}.json"), config,
                read_json(BENCH_DIR / "traffic" / f"{entry['traffic']}.json"))


def _load(kind: str, name: str):
    path = BENCH_DIR / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(metric: str):
    """The `read(ctx)` function of metrics/<metric>.py."""
    return _load("metrics", metric).read


def load_mode(mode: str):
    """modes/<mode>.py: `make(cell, seed, device)` returns the session
    (harness/serving.py says what it offers)."""
    return _load("modes", mode)
