#!/usr/bin/env python3
"""Sweep of the compiled sizes of the chamfer kernels on one NVIDIA GPU:
the value-and-gradient kernel K2
(``human_pose_estimation_tpu_torch/csrc/chamfer_bwd.cu``) by default, the
value-only kernel K1 (``csrc/chamfer_fwd.cu``) with ``--k1``.

    python3 chamfer_bwd_sweep.py [--k1]

Each candidate changes one or more of the source's ``constexpr`` sizes
(pixels per thread of the pixel pass, vertices per thread of the vertex
pass, pixel chunk, vertex chunk), or asks ``__launch_bounds__`` for a least
number of resident vertex-pass blocks per SM (which caps its registers),
in a patched copy of the source under ``build/sweep/``; the first
candidate is the source as it stands. One ``nvcc`` per candidate, all
started together. Holds each candidate against the plain version at
chip_smoke.py's kernel-phase inputs (K2: L1 gradient and vmin bit-equal,
L2 gradient within 1e-6; K1: vmin bit-equal, L1 and value within rtol
1e-5; both: two runs bit-identical) and prints one line per candidate:
ptxas's registers, shared memory and spills, the resident warps per SM of
the kernels, the device time per call (CUDA events over 100 calls queued
ahead of the device; two rounds, in turns forward then backward over the
candidates) and the device time per launch of each kernel
(torch.profiler, 20 calls). The last line is a JSON list of the results.
Needs one CUDA device and exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "build", "sweep")

CANDIDATES = {
    "chamfer_bwd": [
        {},
        {"kPixelsPerThread": 4},
        {"kPixelsPerThread": 8},
        {"kVertsPerThread": 4},
        {"kVertsPerThread": 8},
        {"vertex_min_blocks": 8},
        {"kPixelChunk": 128},
        {"kVertexChunk": 256},
    ],
    "chamfer_fwd": [
        {},
        {"kPixelsPerThread": 1},
        {"kPixelsPerThread": 4},
        {"kVertsPerThread": 4},
        {"kVertsPerThread": 8},
        {"kVertsPerThread": 12},
        {"kVertsPerThread": 16},
        {"kPixelChunk": 128},
        {"kPixelChunk": 512},
        {"kVertexChunk": 64},
        {"kVertexChunk": 256},
    ],
}
VERTEX_PASS = {"chamfer_bwd": "vertex_kernel", "chamfer_fwd": "fwd_vertex_pass"}


def _patched(source: str, changes: dict, vertex_pass: str) -> str:
    """``source`` with each size in ``changes`` set to its value."""
    for name, value in changes.items():
        if name == "vertex_min_blocks":
            pattern = rf"__launch_bounds__\(kThreads\)(\s*{vertex_pass}\b)"
            repl = rf"__launch_bounds__(kThreads, {value})\1"
        else:
            pattern, repl = rf"(constexpr int {name} = )\d+;", rf"\g<1>{value};"
        source, hits = re.subn(pattern, repl, source)
        if hits != 1:
            raise ValueError(f"{name} found {hits} times in the source, not once")
    return source


def _build(cc, name, candidates):
    """(library path, nvcc output) per candidate, one nvcc each, all
    started together."""
    os.makedirs(OUT, exist_ok=True)
    source = cc._SOURCES[name].read_text()
    procs = []
    for i, changes in enumerate(candidates):
        src = os.path.join(OUT, f"{name}_{i}.cu")
        lib = os.path.join(OUT, f"lib{name}_{i}.so")
        with open(src, "w") as f:
            f.write(_patched(source, changes, VERTEX_PASS[name]))
        cmd = [cc._nvcc(), *cc._NVCC_FLAGS, "-o", lib, src]
        procs.append((lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    built = []
    for (lib, proc), changes in zip(procs, candidates):
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) building candidate {changes}:\n{log}")
        built.append((lib, log))
    return built


def _kernel(cs, cc, k1: bool, gt, mask, pred):
    """(source name, loader, call of a loaded library, check of a
    candidate's two runs returning its error, tiling, resident warps,
    kernel names) of K1 or K2."""
    import torch

    if k1:
        ref = cc.chamfer_forward_parts_reference(gt, mask, pred)
        ref_value = cc.chamfer_forward_reference(gt, mask, pred)

        def check(tag, out, again):
            return cs._check_fwd_parts(torch, tag, out, again, ref, ref_value)

        run = lambda lib: cc._launch_fwd(lib, gt, mask, pred, parts=True)
        return ("chamfer_fwd", cc._load_fwd, run, check, cc.fwd_tiling, cc.fwd_resident_warps, cs.K1_KERNELS)
    ref = cc.chamfer_bwd_parts_reference(gt, mask, pred)

    def check(tag, out, again):
        return cs._check_bwd_parts(torch, tag, out, again, ref)

    run = lambda lib: cc._launch_bwd(lib, gt, mask, pred, True, False)
    return ("chamfer_bwd", cc._load_bwd, run, check, cc.bwd_tiling, cc.bwd_resident_warps, cs.K2_KERNELS)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--k1", action="store_true", help="sweep K1 (csrc/chamfer_fwd.cu) instead of K2")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chamfer_bwd_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from human_pose_estimation_tpu_torch.ops import cuda_chamfer as cc

    card = cs._card_line()
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} | {card}", flush=True)
    gt, mask, pred = cs._kernel_inputs(torch)
    name, load, call, check, tiling, warps, kernels = _kernel(cs, cc, args.k1, gt, mask, pred)
    candidates = CANDIDATES[name]
    built = _build(cc, name, candidates)
    libs = [load(path) for path, _ in built]

    results = []
    for changes, (_, log), lib in zip(candidates, built, libs):
        run = lambda lib=lib: call(lib)
        out, again = run(), run()
        torch.cuda.synchronize()
        err = check(f"candidate {changes}", out, again)
        results.append({
            "changes": changes,
            "tiling": tiling(lib),
            "resident_warps": warps(lib),
            "ptxas": cs._ptxas_summary(log),
            "err": err,
            "device_ms": [],
            "per_launch_ms": {k: t for k, (t, _) in cs._per_launch_ms(torch, run, 20, kernels).items()},
        })
    order = list(range(len(candidates)))
    for turn in (order, order[::-1]):
        for i in turn:
            run = lambda lib=libs[i]: call(lib)
            results[i]["device_ms"].append(cs._time_cuda(run, 100, queued=True))
    for r in results:
        print(
            f"[sweep] {name} {r['changes'] or 'the source as it stands'} {r['tiling']}: device ms "
            f"{', '.join(f'{t:.4f}' for t in r['device_ms'])} | per launch "
            f"{', '.join(f'{k} {t:.4f}' for k, t in r['per_launch_ms'].items())} | resident warps "
            f"{r['resident_warps']} | {r['ptxas']} | err {r['err']:.1e} | on {card}",
            flush=True,
        )
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
