#!/usr/bin/env python3
"""Time the streaming median and krum d2 kernels on an H100, and variants
that split their time between memory and arithmetic: the record of their
grid (``stream_grid`` in ``kernels/masked_agg/ops.py``).

    PYTHONPATH=src python3 tools/agg_stream_probe.py [--reps 10] [--rounds 3]

At the swarm round's shape, a (10, 162,417,408) float32 stack with every
row kept, it times with CUDA events:
- ``x.clone()`` of the stack, the card's streaming rate;
- ``masked_median_f32`` and ``masked_krum_d2_f32`` on the wrappers' grid,
  with 4-byte loads (VEC 1) on the same grid, and at the other ones of 1,
  2, 4 and 8 waves of 2 blocks an SM; the median also on one step a
  thread (a block for every 1,024 columns) and at K = 7 kept rows;
- the variants of ``tools/agg_stream_probe.cu``: loads and store without
  the network (median) or the pair products (krum), and the network or the
  products on values made in registers without the loads.
Cases are timed in turns, ``--rounds`` times over, so the spread between
rounds shows beside each mean; the rate is over each case's bytes (the
median's (K + 1)·D·4, krum's N·D·4, the clone's 2·N·D·4; the variants
without loads move none).  Prints one JSON object a line, then the card's
name and power limit.  Needs one CUDA card and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

N, D = 10, 162_417_408
HBM_BYTES_PER_S = 3.35e12
F32 = 4


def build_probe() -> ctypes.CDLL:
    """tools/agg_stream_probe.cu (with masked_agg.cu inside) as a library."""
    from repro_torch.kernels import build
    out = build.BUILD_DIR / "libagg_stream_probe.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out),
           str(ROOT / "tools" / "agg_stream_probe.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"probe build failed:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(out))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("agg_stream_probe: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels.masked_agg import ops as magg
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn((N, D), generator=g, device=dev).mul_(2.0).add_(0.5)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = build_probe()
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    med_fn = lib.masked_median_f32
    med_fn.argtypes, med_fn.restype = [p, p, p, i32, i32, i32, i64, p], i32
    krum_fn = lib.masked_krum_d2_f32
    krum_fn.argtypes, krum_fn.restype = [p, p, i32, i32, p, i32, i64, p], i32
    probe_med, probe_krum = lib.probe_median_f32, lib.probe_krum_f32
    for f in (probe_med, probe_krum):
        f.argtypes, f.restype = [p, p, i32, i64, i32, p], i32

    grid = magg.grid_for(x)
    assert grid.vec == 4, "the probe's stack should take 16-byte loads"
    out = torch.empty(D, device=dev)
    one_step = -(-D // (magg.THREADS * 4))
    partial = torch.empty((N * (N + 1) // 2, 8 * magg.STREAM_BLOCKS_PER_SM * sms), device=dev)
    d2 = torch.empty((N, N), device=dev)
    masks = {k: (torch.arange(N, device=dev) < k).float() for k in (N, 7)}

    def median(nblk, vec, k=N):
        def run():
            build.check(med_fn(x.data_ptr(), masks[k].data_ptr(), out.data_ptr(), nblk, vec, N,
                               D, stream), "probe median")
            return out
        return run

    def krum(nblk, vec):
        def run():
            build.check(krum_fn(x.data_ptr(), partial.data_ptr(), nblk, vec, d2.data_ptr(), N,
                                D, stream), "probe krum")
            return d2
        return run

    def variant(fn, buf, mode, nblk):
        return lambda: build.check(fn(x.data_ptr(), buf.data_ptr(), nblk, D, mode, stream),
                                   "probe variant")

    med_bytes, krum_bytes = (N + 1) * D * F32, N * D * F32
    per_wave = magg.STREAM_BLOCKS_PER_SM * sms
    cases = {"x.clone()": (x.clone, 2 * N * D * F32)}
    for name, nblk in ((f"wrapper grid nblk={grid.nblk}", grid.nblk),
                       *((f"waves={w} nblk={w * per_wave}", w * per_wave)
                         for w in (1, 2, 4, 8) if w != magg.STREAM_WAVES)):
        cases[f"median vec=4 {name}"] = (median(nblk, 4), med_bytes)
        cases[f"krum_d2 vec=4 {name}"] = (krum(nblk, 4), krum_bytes)
    # a block for every 1,024 columns, as the first median ran (not krum:
    # its finalize would add 158,611 partials a pair)
    cases[f"median vec=4 one step a thread nblk={one_step}"] = (median(one_step, 4), med_bytes)
    cases[f"median vec=1 nblk={grid.nblk}"] = (median(grid.nblk, 1), med_bytes)
    cases[f"krum_d2 vec=1 nblk={grid.nblk}"] = (krum(grid.nblk, 1), krum_bytes)
    cases[f"median K=7 vec=4 nblk={grid.nblk}"] = (median(grid.nblk, 4, 7), 8 * D * F32)
    cases["median loads+store, no network"] = (variant(probe_med, out, 0, grid.nblk), med_bytes)
    cases["median network, no loads"] = (variant(probe_med, out, 1, grid.nblk), 0)
    cases["krum_d2 loads, no products"] = (variant(probe_krum, partial, 0, grid.nblk),
                                           krum_bytes)
    cases["krum_d2 products, no loads"] = (variant(probe_krum, partial, 1, grid.nblk), 0)

    # the default cases are the wrappers' launches
    m = torch.ones(N, dtype=torch.bool, device=dev)
    assert torch.equal(median(grid.nblk, 4)().clone(), magg.masked_median(x, m))
    assert torch.equal(krum(grid.nblk, 4)().clone(), magg.masked_krum_d2(x))

    times = {k: [] for k in cases}
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for r in range(args.rounds):
        order = list(cases) if r % 2 == 0 else list(reversed(cases))
        for name in order:
            fn = cases[name][0]
            fn()
            torch.cuda.synchronize()
            start.record()
            for _ in range(args.reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / args.reps)
    for name, (_, nbytes) in cases.items():
        t = times[name]
        mean = sum(t) / len(t)
        print(json.dumps({"case": name, "ms": t, "mean_ms": mean,
                          "spread_ms": max(t) - min(t), "bytes": nbytes,
                          "TB_per_s": nbytes / mean / 1e9,
                          "share_of_bound": nbytes / HBM_BYTES_PER_S * 1e3 / mean}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
