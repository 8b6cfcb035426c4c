"""One run of one cell of the port's benchmark:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cell's NVIDIA cards. The
run builds or loads the port's kernels (caches inside the checkout),
makes weights and inputs from the seed, warms up the cell's own shapes,
measures for ``--seconds``, checks what the timed path produced against
the plain reference in ``portbench/reference/``, and prints as the last
line of its standard output one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number with its limit
(also the last lines of standard error). It exits non-zero, printing no
result, without the cards the cell needs, without the port, or when JAX,
Flax or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Optional  # noqa: E402

from portbench import harness as H  # noqa: E402


CORES = 4  # host cores a run keeps to


def _pin() -> None:
    """Keep the process, and every thread it starts after this, to the
    first ``CORES`` cores it may use, the same in every run: where the
    scheduler puts the host-bound loop is then no part of a run's
    reading."""
    cores = sorted(os.sched_getaffinity(0))[:CORES]
    os.sched_setaffinity(0, cores)


def _caches() -> None:
    """Every compile cache at a fixed path inside the checkout (the port
    builds its CUDA kernels into build/kernels/ and its C++ into
    build/native/ there by itself)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
        path = H.CACHE / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


def _card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "nvidia-smi gave nothing"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi not read: {e}"


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda", overrides: Optional[dict] = None,
             traffic: Optional[dict] = None, t_process: Optional[float] = None):
    """Run one cell and return (result line dict, check lines, the driver's
    notes). ``device``, ``overrides`` (configuration keys) and ``traffic``
    (the mix's parameters) serve the CPU tests, which run the same path at
    a tiny size."""
    import torch

    bench = H.benchmark()
    entry, cfg, wl = H.cell(bench, name)
    cfg.update(overrides or {})
    wl["traffic"].update(traffic or {})
    e2e, per_layer = H.cell_metrics(bench, name)
    dev = torch.device(device)
    from portbench.trace import Tracer

    tracer = Tracer(trace, seconds, wl["traffic"].get("trace_s", 3.0), dev)
    ctx = H.Ctx(name, wl, cfg, seed, seconds, trace, dev, tracer,
                t_process if t_process is not None else time.perf_counter())
    driver = H.load_module("drivers", wl["driver"])
    res = driver.run(ctx)
    res.notes["set-up parts, s"] = {k: round(v, 3) for k, v in ctx.setup_parts().items()}

    metrics = {}
    breakdown = None
    if not trace:
        for m in e2e:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": ctx.setup_s, "unit": "s"}
            elif m["name"] in res.metrics:
                metrics[m["name"]] = {"value": res.metrics[m["name"]], "unit": m["unit"]}
    else:
        summary = tracer.summary()
        if summary is not None:
            for m in per_layer:
                v = H.load_module("metrics", m["name"]).read(ctx, summary)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            breakdown = {"device_ops": [list(x) for x in summary.device_ops],
                         "idle_gaps": [list(x) for x in summary.idle_gaps]}
            lead, traced = summary.lead_counts.get("images", 0), summary.counts.get("images", 0)
            if lead > 0 and summary.lead_s > 0 and summary.window_s > 0:
                res.notes["images/s untraced | traced (device activity recorded)"] = (
                    lead / summary.lead_s, traced / summary.window_s)
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                "count": entry["chips"], "memory_peak_bytes": int(res.memory_peak_bytes)}
    if trace and tracer.summary() is not None:
        s = tracer.summary()
        dev_info.update(busy_s=s.busy_s, window_s=s.window_s)
    line = {"correct": H.correct(res.checks, res.failed),
            "attempted": int(res.attempted), "failed": int(res.failed), "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    # a number that is not finite (an answer missing) is written as text:
    # JSON has no infinity
    line["checks"] = {c.name: {"value": c.value if math.isfinite(c.value) else str(c.value), "limit": c.limit}
                      for c in res.checks}
    for k, v in res.notes.items():
        H.log(f"[{name}] {k}: {v}")
    checks = [f"check {c.name} = {c.value!r} (limit {c.limit!r}) {'ok' if c.ok else 'FAILED'}" for c in res.checks]
    return line, checks, res.notes


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _pin()
    _caches()
    os.environ["USE_FLAX"] = "0"

    import torch

    import human_pose_estimation_tpu_torch  # noqa: F401  the system under test; absent, the run ends here

    need = H.cell(H.benchmark(), args.workload)[0]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        H.log(f"needs {need} CUDA device(s); found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    # one intra-op thread: the program's host work is one Python thread, and
    # more only spin against them and widen the spread of host-bound rates
    torch.set_num_threads(1)
    # the program's progress output goes to standard error: the last line of
    # standard output is the result
    with contextlib.redirect_stdout(sys.stderr):
        line, checks, _ = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_process=T_PROCESS)
    gc.collect()
    # read after the window: the query's time is no part of set-up
    H.log(f"card: {_card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    bad = H.forbidden_modules()
    if bad:
        H.log(f"modules of JAX or of the JAX package were loaded: {', '.join(bad)}")
        return 3
    for c in checks:
        H.log(c)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
