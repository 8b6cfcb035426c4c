"""What the run, the drivers and the metric readers share: where the files
are, the run's context, a driver's result, and the loaders that find a
cell's configuration, driver and readers by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix, and
which metrics it reports. A configuration is
``portbench/configs/<config>.json``; a traffic mix is
``portbench/mixes/<traffic>.json``: the driver that runs its window and
the generator's parameters; a cell's own file,
``portbench/workloads/<cell>.json``, holds the limits of its compared
numbers. A driver is ``portbench/drivers/<driver>.py`` with ``run(ctx) ->
Result``; a per-layer metric is ``portbench/metrics/<metric>.py`` with
``read(ctx, trace) -> float | None``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent  # the checkout
CACHE = ROOT / "build" / "portbench"  # fixed cache directories inside the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "human_pose_estimation_tpu")


def forbidden_modules() -> List[str]:
    """The loaded modules whose top-level name, compared whole, is JAX's,
    Flax's or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(bench: dict, name: str, root: Path = ROOT) -> Tuple[dict, dict, dict]:
    """(the cell's entry in BENCHMARK.json, its configuration, {'driver',
    'traffic': the mix's parameters, 'limits'})."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json lists no cell {name!r}")
    own = load_json(root / "portbench" / "workloads" / f"{name}.json")
    cfg = load_json(root / "portbench" / "configs" / f"{entry['config']}.json")
    mix = load_json(root / "portbench" / "mixes" / f"{entry['traffic']}.json")
    return entry, cfg, {"driver": mix["driver"], "traffic": mix["params"], "limits": own["limits"]}


def load_module(kind: str, name: str, root: Path = ROOT):
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = root / "portbench" / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str) -> Tuple[List[dict], List[dict]]:
    """(end-to-end, per-layer) metric entries that ``cell`` reports: those
    that list it, and those that list no cells."""
    pick = lambda ms: [m for m in ms if cell in m.get("workloads", [cell])]  # noqa: E731
    return pick(bench["end_to_end"]), pick(bench["per_layer"])


@dataclasses.dataclass
class Check:
    """One compared number: ``correct`` needs value <= limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit  # NaN fails


def correct(checks: List[Check], failed: int) -> bool:
    """A run is correct when it compared something, every compared number
    is within its limit, and no request failed."""
    return bool(checks) and all(c.ok for c in checks) and failed == 0


@dataclasses.dataclass
class Result:
    metrics: Dict[str, float]  # the end-to-end metrics the driver timed
    attempted: int
    failed: int
    checks: List[Check]
    memory_peak_bytes: int
    notes: Dict[str, object] = dataclasses.field(default_factory=dict)  # printed to stderr


@dataclasses.dataclass
class Ctx:
    """What a driver gets: the cell, its configuration, the run's
    arguments, the device, the tracer, and the clock of the run."""

    name: str
    workload: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    tracer: object
    t_process: float  # when the run's process started its work
    t_window: Optional[float] = None
    extra: Dict[str, object] = dataclasses.field(default_factory=dict)  # a driver's data for the readers
    marks: List[Tuple[str, float]] = dataclasses.field(default_factory=list)

    def mark(self, name: str) -> None:
        """A part of set-up named ``name`` ends now."""
        self.marks.append((name, time.perf_counter()))

    def setup_parts(self) -> Dict[str, float]:
        """Seconds of each marked part of set-up, from the process's start;
        the rest up to the window under ``other``."""
        out, t = {}, self.t_process
        for name, at in self.marks:
            out[name], t = at - t, at
        if self.t_window is not None:
            out["other"] = self.t_window - t
        return out

    def open_window(self) -> None:
        """Set-up ends: the measured window starts now."""
        self.t_window = time.perf_counter()
        self.tracer.begin()

    @property
    def setup_s(self) -> float:
        return self.t_window - self.t_process
