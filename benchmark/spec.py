"""Where the benchmark finds its parts, by the names in `BENCHMARK.json`.

Everything that belongs to one configuration, traffic mix, cell or per-layer
metric is a file of its own, so that a later cell or metric is new files and
new entries, not an edit:

    configs/<config>.json           sizes, source, precision, what is assumed;
                                    "arch" names the generator architecture
                                    ("stylegan2" where it names none)
    reference/<arch>.py             the architecture's plain G and D
    programs/<arch>.py              the port's G and D of the architecture
    traffic/<traffic>.json          the mix's parameters; "kind" names the
                                    cell runner, benchmark/<kind>_cell.py
    flops/<config>.<traffic>.json   the model FLOPs of each unit of work
    limits/<workload>.json          the limit of each number `correct` compares
    metrics/<metric>.py             the reader of one per-layer metric: read(record)

A new architecture is one configuration file that names it, its two files
`reference/<arch>.py` and `programs/<arch>.py`, its traffic, limits and FLOP
data files, and its entries in `BENCHMARK.json`; the runners `fid_cell.py`
and `train_cell.py`, `faults.py` and `control.py` take it unchanged.  The
harness reads `size` (the image side) and `style_dim` (the latent width) of
every configuration; the rest of it is the architecture's files' own.

`reference/<arch>.py` is plain PyTorch that imports nothing of the program:

    models(cfg, device) -> (g, d)   G and D of the configuration's sizes,
                                    weights empty (the benchmark draws them)
    init_rule(name, cfg) -> (scale, shift) of leaf `name`'s draw,
                                    randn * scale + shift

and its G has `style_dim`, `num_layers` and `noise_res(j)` (the per-layer
noise `reference/train.py::layer_noise` draws, none where `num_layers` is 0)
and `g(z, noise)`.  On the `train` kind its G and D also provide what
`reference/train.py` calls (`make_latent`, `synthesis`, `n_latent`, `size`),
and their leaves and masks are named and keyed as the port's
`rick_tpu_torch/train/masks.py` keys them.

`programs/<arch>.py` may import the port:

    generator(cfg, device, rng) -> (G, what the Evaluator and the training
                                    state take as G's configuration)
    discriminator(cfg, device, rng) -> (D, its configuration)

each built as the port's train CLI builds it, the constructors' draws from
`rng` (the benchmark's weights are loaded over them).

`root` is the benchmark's directory; tests point it at a copy.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
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


def _module(path: Path, name: str) -> ModuleType:
    """The file `path` loaded as the module `name`."""
    if not path.is_file():
        raise FileNotFoundError(f"the benchmark has no {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module  # as an import would, for what looks its module up (dataclasses)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, root: Path = ROOT) -> ModuleType:
    """The module metrics/<name>.py, which defines read(record) -> value or None."""
    return _module(root / "metrics" / f"{name}.py", f"benchmark_metric_{name.replace('.', '_')}")


def arch(cfg: dict) -> str:
    """The generator architecture a configuration names."""
    return cfg.get("arch", "stylegan2")


def reference_models(cfg: dict, root: Path = ROOT) -> ModuleType:
    """The module reference/<arch>.py of the configuration's architecture."""
    return _module(root / "reference" / f"{arch(cfg)}.py", f"benchmark_reference_{arch(cfg)}")


def program_models(cfg: dict, root: Path = ROOT) -> ModuleType:
    """The module programs/<arch>.py of the configuration's architecture."""
    return _module(root / "programs" / f"{arch(cfg)}.py", f"benchmark_program_{arch(cfg)}")


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
