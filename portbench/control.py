"""The readings that the limits of ``correct`` are set from, on the card
at each cell's own size: for every seed, one run of the cell (the
program's numbers) and the cell's control and planted faults, from its
driver's ``control(cell, seed, device, overrides)``, each judged by the
harness's own rule against the cell's limits.

    python3 -m portbench.control --workload <cell> --seeds <n,n,n> [--seconds <s>]

For every seed it prints one JSON line: each reading's numbers and its
``correct``. It exits 1 when a control or a planted fault comes out
correct.

* ``drivers/train.py``: the configuration states bfloat16 for the encoder
  and the regressor, and the port has no lower-precision training path,
  so the control is the reference put in the program's place with float8
  training: per-tensor scaled e4m3 at every tensor that bfloat16 autocast
  holds in bfloat16, and e5m2 on the gradients flowing back through them.
  The planted fault: half of every batch left out (the means over the
  rest), in the reference put in the program's place. A state left
  unchanged reads 1 in ``change_gap`` and needs no run. Beside them, not
  a control (it may come out correct): the reference rounded to bfloat16
  the same way, the configuration's own precision, which reads as the
  program does.

The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

from portbench import harness as H


def _program(cell: str, seed: int, seconds: float, dev, overrides=None, traffic_params=None) -> dict:
    from portbench.run import run_cell

    with contextlib.redirect_stdout(sys.stderr):
        line, _, notes = run_cell(cell, seed, seconds, False, device=str(dev), overrides=overrides,
                                  traffic=traffic_params)
    return {"correct": line["correct"], **notes["all numbers"]}


def readings(cell: str, seed: int, seconds: float, dev, overrides=None, traffic_params=None) -> dict:
    """The program's numbers and its control's (and fault's) for one seed."""
    out = {"program": _program(cell, seed, seconds, dev, overrides, traffic_params)}
    out.update(H.load_module("drivers", H.cell(H.benchmark(), cell)[2]["driver"]).control(cell, seed, dev, overrides))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        H.log("needs a CUDA device")
        return 2
    torch.set_num_threads(1)
    dev = torch.device("cuda")
    passed = []
    for seed in (int(s) for s in args.seeds.split(",")):
        out = readings(args.workload, seed, args.seconds, dev)
        passed += [f"{k} (seed {seed})" for k, v in out.items() if k.startswith(("control", "fault")) and v["correct"]]
        print(json.dumps({"workload": args.workload, "seed": seed, **out}, default=str), flush=True)
    if passed:
        H.log(f"came out correct: {', '.join(passed)}")
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
