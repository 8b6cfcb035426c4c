#!/usr/bin/env python3
"""Sweep of the compiled sizes of the chamfer value-and-gradient kernel K2
(``human_pose_estimation_tpu_torch/csrc/chamfer_bwd.cu``) on one NVIDIA GPU.

    python3 chamfer_bwd_sweep.py

Each candidate changes one or more of the source's ``constexpr`` sizes
(pixels per thread of the assign pass, vertices per thread of the vertex
pass, pixel chunk, vertex chunk), or asks ``__launch_bounds__`` for a least
number of resident vertex-pass blocks per SM (which caps its registers),
in a patched copy of the source under ``build/sweep/``; the first
candidate is the source as it stands. One ``nvcc`` per candidate, all
started together. Holds each candidate's K2 against the plain version at
chip_smoke.py's kernel-phase inputs (L1 gradient and vmin bit-equal, L2
gradient within 1e-6, two runs bit-identical) and prints one line per
candidate: ptxas's registers, shared memory and spills, the resident warps
per SM of the four kernels, K2's device time per call (CUDA events over
100 calls queued ahead of the device; two rounds, in turns forward then
backward over the candidates) and its device time per launch of each
kernel (torch.profiler, 20 calls). The last line is a JSON list of the
results. Needs one CUDA device and exits non-zero without one.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "build", "sweep")

CANDIDATES = [
    {},
    {"kPixelsPerThread": 4},
    {"kPixelsPerThread": 8},
    {"kVertsPerThread": 4},
    {"kVertsPerThread": 8},
    {"vertex_min_blocks": 8},
    {"kPixelChunk": 128},
    {"kVertexChunk": 256},
]


def _patched(source: str, changes: dict) -> str:
    """``source`` with each size in ``changes`` set to its value."""
    for name, value in changes.items():
        if name == "vertex_min_blocks":
            pattern, repl = r"__launch_bounds__\(kThreads\)(\s*vertex_kernel)", rf"__launch_bounds__(kThreads, {value})\1"
        else:
            pattern, repl = rf"(constexpr int {name} = )\d+;", rf"\g<1>{value};"
        source, hits = re.subn(pattern, repl, source)
        if hits != 1:
            raise ValueError(f"{name} found {hits} times in the source, not once")
    return source


def _build(cc, candidates):
    """(library path, nvcc output) per candidate, one nvcc each, all
    started together."""
    os.makedirs(OUT, exist_ok=True)
    source = cc._SOURCES["chamfer_bwd"].read_text()
    procs = []
    for i, changes in enumerate(candidates):
        src = os.path.join(OUT, f"chamfer_bwd_{i}.cu")
        lib = os.path.join(OUT, f"libchamfer_bwd_{i}.so")
        with open(src, "w") as f:
            f.write(_patched(source, changes))
        cmd = [cc._nvcc(), *cc._NVCC_FLAGS, "-o", lib, src]
        procs.append((lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    built = []
    for (lib, proc), changes in zip(procs, candidates):
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) building candidate {changes}:\n{log}")
        built.append((lib, log))
    return built


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chamfer_bwd_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from human_pose_estimation_tpu_torch.ops import cuda_chamfer as cc

    card = cs._card_line()
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} | {card}", flush=True)
    built = _build(cc, CANDIDATES)
    libs = [cc._load_bwd(path) for path, _ in built]

    gt, mask, pred = cs._kernel_inputs(torch)
    ref = cc.chamfer_bwd_parts_reference(gt, mask, pred)
    results = []
    for changes, (_, log), lib in zip(CANDIDATES, built, libs):
        run = lambda lib=lib: cc._launch_bwd(lib, gt, mask, pred, True, False)
        out, again = run(), run()
        torch.cuda.synchronize()
        l2_err = cs._check_bwd_parts(torch, f"candidate {changes}", out, again, ref)
        results.append({
            "changes": changes,
            "tiling": cc.bwd_tiling(lib),
            "resident_warps": cc.bwd_resident_warps(lib),
            "ptxas": cs._ptxas_summary(log),
            "l2_err": l2_err,
            "device_ms": [],
            "per_launch_ms": {k: t for k, (t, _) in cs._per_launch_ms(torch, run, 20, cs.K2_KERNELS).items()},
        })
    order = list(range(len(CANDIDATES)))
    for turn in (order, order[::-1]):
        for i in turn:
            run = lambda lib=libs[i]: cc._launch_bwd(lib, gt, mask, pred, True, False)
            results[i]["device_ms"].append(cs._time_cuda(run, 100, queued=True))
    for r in results:
        print(
            f"[sweep] {r['changes'] or 'the source as it stands'} {r['tiling']}: K2 device ms "
            f"{', '.join(f'{t:.4f}' for t in r['device_ms'])} | per launch "
            f"{', '.join(f'{k} {t:.4f}' for k, t in r['per_launch_ms'].items())} | resident warps "
            f"{r['resident_warps']} | {r['ptxas']} | l2_err {r['l2_err']:.1e} | on {card}",
            flush=True,
        )
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
