"""The harness is driven by data: a cell, a configuration, a traffic mix
or a per-layer metric is found by the name BENCHMARK.json gives it, so a
later change adds one with new files and new entries alone."""
import json
import shutil

import pytest

from portbench import harness as H
from portbench import trace


def _copy(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(H.ROOT / "portbench", root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(H.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def test_every_cell_and_metric_of_benchmark_json_resolves():
    bench = H.benchmark()
    for w in bench["workloads"]:
        entry, cfg, wl = H.cell(bench, w["name"])
        assert cfg["name"] == entry["config"]
        assert (H.ROOT / "portbench" / "drivers" / f"{wl['driver']}.py").exists()
        e2e, per_layer = H.cell_metrics(bench, w["name"])
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2 and per_layer
        for m in per_layer:
            assert callable(H.load_module("metrics", m["name"]).read)


def test_an_added_cell_and_metric_are_found_without_editing(tmp_path):
    root = _copy(tmp_path)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    bench = json.loads((root / "BENCHMARK.json").read_text())
    # a new cell: a data file for the mix, one for the cell, entries in BENCHMARK.json
    (root / "portbench" / "mixes" / "small-pool.json").write_text(json.dumps(
        {"driver": "train", "params": {"pool_batches": 4, "canvas": 256}}))
    (root / "portbench" / "workloads" / "train-small.json").write_text(json.dumps({"limits": {"mr1_gap": 0.1}}))
    bench["workloads"].append({"name": "train-small", "config": "hmr-r50-hybrid", "traffic": "small-pool",
                               "chips": 1, "why": "test"})
    # a new per-layer metric: a reader file and an entry that lists the new cell
    (root / "portbench" / "metrics" / "demo_share.train.py").write_text(
        "def read(ctx, trace):\n    return 100.0 * trace.busy_s / trace.window_s\n")
    bench["per_layer"].append({"name": "demo_share.train", "unit": "%", "better": "higher", "source": "device_trace",
                               "layer": "device", "moves": "train_img_s", "workloads": ["train-small"]})
    for m in bench["end_to_end"]:
        if m["name"] == "train_img_s":
            m["workloads"].append("train-small")

    entry, cfg, wl = H.cell(bench, "train-small", root)
    assert (entry["config"], wl["driver"], wl["traffic"]["pool_batches"]) == ("hmr-r50-hybrid", "train", 4)
    assert wl["limits"] == {"mr1_gap": 0.1}
    e2e, per_layer = H.cell_metrics(bench, "train-small")
    assert [m["name"] for m in e2e] == ["train_img_s", "setup_s"]
    assert [m["name"] for m in per_layer] == ["demo_share.train"]
    s = trace.TraceSummary(2.0, 0.5, {}, {}, [], [], {})
    assert H.load_module("metrics", "demo_share.train", root).read(None, s) == pytest.approx(25.0)
    # the old cell is untouched and reports no new metric
    assert "demo_share.train" not in [m["name"] for m in H.cell_metrics(bench, "hybrid-train-b8")[1]]
    changed = [p for p, b in before.items() if p.read_bytes() != b]
    assert changed == []


def test_readers_return_nothing_without_a_device_trace():
    s = trace.TraceSummary(2.0, 0.0, {}, {}, [], [], {"images": 10, "steps": 2, "batches": 0})

    class Ctx:
        config = H.cell(H.benchmark(), "hybrid-train-b8")[1]
        extra = {}

    for m in H.benchmark()["per_layer"]:
        assert H.load_module("metrics", m["name"]).read(Ctx, s) is None, m["name"]


def test_trace_union_and_kernel_names():
    class E:
        def __init__(self, name, start, dur, kind="kernel", dev=True):
            import torch

            self._n, self._s, self._d, self._k = name, start, dur, kind
            self._t = torch.autograd.DeviceType.CUDA if dev else torch.autograd.DeviceType.CPU

        def name(self): return self._n
        def start_ns(self): return self._s
        def duration_ns(self): return self._d
        def activity_type(self): return self._k
        def device_type(self): return self._t
        def is_user_annotation(self): return False

    class P:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return [E("void vertex_kernel<int>(float)", 0, 100), E("vertex_merge_kernel", 50, 100),
                            E("Memcpy HtoD", 400, 100, "gpu_memcpy"), E("range", 0, 10_000, "gpu_user_annotation"),
                            E("aten::mm", 200, 300, "cpu_op", dev=False)]

    s = trace.summarize(P, 1e-6, {})
    assert s.busy_s == pytest.approx(250e-9)  # [0, 150) and [400, 500); the annotation is no work
    assert s.kernel_seconds(["vertex_kernel"]) == (pytest.approx(100e-9), 1)
    assert s.kernel_seconds(["vertex_kernel", "vertex_merge_kernel"])[1] == 2
    assert s.launches == 2
    assert s.idle_gaps == [("aten::mm", pytest.approx(250e-9))]
