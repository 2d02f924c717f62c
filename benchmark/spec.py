"""Where the benchmark finds its parts, by the names in `BENCHMARK.json`.

Everything that belongs to one configuration, traffic mix, cell or per-layer
metric is a file of its own, so that a later cell or metric is new files and
new entries, not an edit:

    configs/<config>.json           sizes, source, precision, what is assumed
    traffic/<traffic>.json          the mix's parameters; "kind" names the
                                    cell runner, benchmark/<kind>_cell.py
    flops/<config>.<traffic>.json   the model FLOPs of each unit of work
    limits/<workload>.json          the limit of each number `correct` compares
    metrics/<metric>.py             the reader of one per-layer metric: read(record)

`root` is the benchmark's directory; tests point it at a copy.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent


def load_benchmark(path: Path = REPO / "BENCHMARK.json") -> dict:
    with open(path) as f:
        return json.load(f)


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"the benchmark has no {path}")
    with open(path) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"BENCHMARK.json has no workload {name!r}")


def config(name: str, root: Path = ROOT) -> dict:
    return _json(root / "configs" / f"{name}.json")


def traffic(name: str, root: Path = ROOT) -> dict:
    return _json(root / "traffic" / f"{name}.json")


def flops(config_name: str, traffic_name: str, root: Path = ROOT) -> dict:
    return _json(root / "flops" / f"{config_name}.{traffic_name}.json")


def limits(workload_name: str, root: Path = ROOT) -> dict:
    return _json(root / "limits" / f"{workload_name}.json")


def metric_reader(name: str, root: Path = ROOT) -> ModuleType:
    """The module metrics/<name>.py, which defines read(record) -> value or None."""
    path = root / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"the benchmark has no reader {path}")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_runner(kind: str) -> ModuleType:
    """The module benchmark/<kind>_cell.py that runs a traffic mix of this kind."""
    return importlib.import_module(f"benchmark.{kind}_cell")


def per_layer_for(bench: dict, workload_name: str) -> list:
    """The per-layer metrics a cell reports: those that list it, and those
    without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end_for(bench, workload_name)}
    out = []
    for m in bench["per_layer"]:
        if workload_name in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in e2e):
            out.append(m)
    return out


def end_to_end_for(bench: dict, workload_name: str) -> list:
    return [m for m in bench["end_to_end"] if "workloads" not in m or workload_name in m["workloads"]]
