"""BENCHMARK.json against the benchmark's contract, the discovery of every
part it names, and a later cell, traffic mix and metric taken as new files
alone."""

import json
import re
import shutil

import pytest

from benchmark import harness, spec
from benchmark.trace import Capture

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert (spec.REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert BENCH["paths"] == ["benchmark"] and 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32 and not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)


def test_entries():
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for e in BENCH[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"benchmark/configs/{c['name']}.json" and (spec.REPO / c["file"]).is_file()
        assert c["reduced"] == spec.config(c["name"])["reduced"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and 1 <= len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_finds_its_parts_and_reports_what_it_must(cell):
    e2e = {m["name"] for m in spec.end_to_end_for(BENCH, cell["name"])}
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = spec.per_layer_for(BENCH, cell["name"])
    assert per_layer and all(m["moves"] in e2e for m in per_layer)
    ctx = harness.make_ctx(cell["name"], 1, False, "cpu", BENCH)
    assert callable(ctx.runner.setup) and callable(ctx.runner.compare) and ctx.limits
    assert all(hasattr(spec.metric_reader(m["name"]), "read") for m in per_layer)


def test_metric_lists_name_reporting_cells():
    for m in BENCH["per_layer"]:
        for w in m.get("workloads", []):
            assert m["moves"] in {e["name"] for e in spec.end_to_end_for(BENCH, w)}


def test_a_later_cell_and_metric_are_files_alone(tmp_path):
    """A new configuration, traffic mix and per-layer metric: new files and
    new entries of BENCHMARK.json, no existing file edited."""
    root = tmp_path / "bench"
    for sub in ("configs", "traffic", "flops", "limits", "metrics"):
        shutil.copytree(spec.ROOT / sub, root / sub)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    cfg = dict(spec.config("stylegan2-ffhq256"), name="throwaway", size=512, d_size=512)
    (root / "configs" / "throwaway.json").write_text(json.dumps(cfg))
    (root / "traffic" / "throwaway-mix.json").write_text(json.dumps(dict(spec.traffic("recipe-train"), batch=4)))
    (root / "flops" / "throwaway.throwaway-mix.json").write_text(json.dumps({"d": 1, "g": 1}))
    (root / "limits" / "throwaway.train.json").write_text(json.dumps({"change_gap": 0.5}))
    (root / "metrics" / "busy_ms.throwaway.py").write_text(
        "def read(record):\n    return None if record.capture is None else 1e3 * record.capture.busy_s()\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "throwaway", "source": "https://example.org", "file": "x", "reduced": [],
                             "why": "x"})
    bench["workloads"].append({"name": "throwaway.train", "config": "throwaway", "traffic": "throwaway-mix",
                               "chips": 1, "why": "x"})
    bench["end_to_end"][-1]["workloads"].append("throwaway.train")
    bench["per_layer"].append({"name": "busy_ms.throwaway", "unit": "ms", "better": "lower", "source": "device_trace",
                               "layer": "device", "moves": "train_iter_ms", "workloads": ["throwaway.train"]})
    ctx = harness.make_ctx("throwaway.train", 3, False, "cpu", bench, root)
    assert ctx.cfg["size"] == 512 and ctx.traffic["batch"] == 4 and ctx.runner.__name__ == "benchmark.train_cell"
    assert [m["name"] for m in spec.per_layer_for(bench, "throwaway.train")][-1] == "busy_ms.throwaway"
    cap = Capture(window_s=1.0, t0_ns=0, t1_ns=10**9, device=[("k", 0, 250_000_000)])
    record = harness.Record(harness.Window(seconds=1.0, units=1, capture=cap), ctx.flops)
    assert spec.metric_reader("busy_ms.throwaway", root).read(record) == 250.0
    assert {p: p.read_bytes() for p in before} == before


def test_missing_parts_raise():
    with pytest.raises(FileNotFoundError):
        spec.config("no-such-config")
    with pytest.raises(FileNotFoundError):
        spec.metric_reader("no_such_metric.train")
    with pytest.raises(KeyError):
        spec.workload(BENCH, "no-such-cell")
