#!/usr/bin/env python3
"""Time the masked CenteredClip chain on an H100 under other column layouts:
the record of the chain's grid size, ``WAVES`` in ``kernels/cc_chain.py``.

    PYTHONPATH=src python3 tools/cc_chain_probe.py [--reps 10] [--rounds 3]

The kernels take whatever layout ``chain_plan`` gives; this probe hands
``masked_cc_chain_f32`` other ones (``waves`` waves of the 2 resident
blocks an SM that n = 10 allows, times the SM count; 4- or 16-byte loads)
at the swarm round's shape, (10, 162,417,408) float32 from the masked
median, fixed tau 2.0, 3 iterations, and times each with CUDA events.
Layouts are timed in turns, ``--rounds`` times over, so the spread between
rounds shows beside each mean; the rate is over the chain's dependency
floor, the bytes it moves.  Run it again when the layout is retuned.
Prints one JSON object a line, then the card's name and power limit.
Needs one CUDA card and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

N, D, ITERS = 10, 162_417_408, 3
HBM_BYTES_PER_S = 3.35e12
CHAIN_BYTES = ((ITERS + 1) * N * D + (2 * ITERS + 1) * D) * 4


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("cc_chain_probe: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels import cc_chain as cc
    from repro_torch.kernels.masked_agg import ops as magg
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn((N, D), generator=g, device=dev).mul_(2.0).add_(0.5)
    m = torch.ones(N, dtype=torch.bool, device=dev)
    mf = m.float()
    v0 = magg.masked_median(x, m)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    p = ctypes.c_void_p
    fn = build.function("masked_agg", "masked_cc_chain_f32",
                        [p, p, p, p, p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, p, p,
                         ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                         ctypes.c_int, p])
    stream = torch.cuda.current_stream(dev).cuda_stream

    def chain(waves, vec):
        # chain_plan's layout at `waves` waves: its WAVES waves of an
        # sms * waves / WAVES card
        plan = cc.chain_plan(N, D, vec == 4, sms * waves // cc.WAVES)
        assert sms * waves % cc.WAVES == 0, "waves the SM count cannot give exactly"
        out = torch.empty(D, device=dev)
        partial = torch.empty((N, plan.nblk), device=dev)
        w, kf = torch.empty(N, device=dev), torch.empty(1, device=dev)

        def run():
            build.check(fn(x.data_ptr(), v0.data_ptr(), mf.data_ptr(), out.data_ptr(),
                           partial.data_ptr(), plan.nblk, plan.chunk, plan.vec, w.data_ptr(),
                           kf.data_ptr(), N, D, ITERS, 2.0, 0, stream), "probe")
            return out
        return run, plan, CHAIN_BYTES

    cases = {}
    for waves in (1, 2, 3, 4, 5, 6, 8):
        for vec in (4, 1):
            run, plan, nbytes = chain(waves, vec)
            cases[f"chain waves={waves} vec={vec} nblk={plan.nblk}"] = (run, nbytes)
    default = f"chain waves={cc.WAVES} vec=4 nblk={cc.chain_plan(N, D, True, sms).nblk}"
    want = magg.masked_cc_chain(x, v0, m, iters=ITERS, clip_tau=2.0)
    assert torch.equal(cases[default][0](), want), "the probe's default layout is not the wrapper's"

    times = {k: [] for k in cases}
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for r in range(args.rounds):
        order = list(cases) if r % 2 == 0 else list(reversed(cases))
        for name in order:
            fn_, _ = cases[name]
            fn_()
            torch.cuda.synchronize()
            start.record()
            for _ in range(args.reps):
                fn_()
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / args.reps)
    for name, (_, nbytes) in cases.items():
        t = times[name]
        mean = sum(t) / len(t)
        print(json.dumps({"case": name, "ms": t, "mean_ms": mean,
                          "spread_ms": max(t) - min(t), "bytes": nbytes,
                          "TB_per_s": nbytes / mean / 1e9,
                          "share_of_peak": nbytes / HBM_BYTES_PER_S * 1e3 / mean}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
