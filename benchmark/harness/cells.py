"""Cells and their files, found by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration and
traffic.  Everything else is a file of its own under ``benchmark/``:

- ``configs/<config>.json``: the network, its weights and its recipe;
- ``traffic/<traffic>.json``: the mix's parameters; its ``kind`` names the
  driver ``drivers/<kind>.py`` (``set_up``, ``window``, ``check``);
- ``checks/<cell>.json``: the numbers that decide ``correct``, their limits
  and the readings the limits were set from;
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(run)``, which
  returns a number or None where it finds nothing to read.

A later cell, configuration, traffic mix or metric is a new file and a new
entry of ``BENCHMARK.json``; no code here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[2]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(Path(root) / "BENCHMARK.json")


def cell(name: str, root: Path = ROOT) -> dict:
    for entry in benchmark(root)["workloads"]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def config(name: str, root: Path = ROOT) -> dict:
    return _json(Path(root) / "benchmark" / "configs" / f"{name}.json")


def traffic(name: str, root: Path = ROOT) -> dict:
    return _json(Path(root) / "benchmark" / "traffic" / f"{name}.json")


def checks(cell_name: str, root: Path = ROOT) -> dict:
    return _json(Path(root) / "benchmark" / "checks" / f"{cell_name}.json")


def _module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(kind: str, root: Path = ROOT) -> ModuleType:
    return _module(Path(root) / "benchmark" / "drivers" / f"{kind}.py", f"bench_driver_{kind}")


def metric_reader(name: str, root: Path = ROOT) -> ModuleType:
    return _module(Path(root) / "benchmark" / "metrics" / f"{name}.py",
                   "bench_metric_" + name.replace(".", "_").replace("-", "_"))


def end_to_end(cell_name: str, root: Path = ROOT) -> List[dict]:
    """The end-to-end metrics a cell reports, ``setup_s`` among them."""
    return [m for m in benchmark(root)["end_to_end"]
            if "workloads" not in m or cell_name in m["workloads"]]


def per_layer(cell_name: str, root: Path = ROOT) -> List[dict]:
    """The per-layer metrics a cell's traced run reports: those that list it,
    and those without a list whose end-to-end metric the cell reports."""
    reported = {m["name"] for m in end_to_end(cell_name, root)}
    return [m for m in benchmark(root)["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def resolve(cell_name: str, root: Path = ROOT) -> Dict[str, object]:
    """A cell with its configuration, traffic, driver and checks loaded."""
    entry = cell(cell_name, root)
    mix = traffic(entry["traffic"], root)
    return {"cell": entry, "config": config(entry["config"], root), "traffic": mix,
            "driver": driver(mix["kind"], root), "checks": checks(cell_name, root)}
