#!/usr/bin/env python3
"""Time the QSGD decode-accumulate kernel on an H100, and variants that
split its time between memory and arithmetic: the record of its design
(``csrc/qsgd_decode.cu``).

    PYTHONPATH=src python3 tools/qsgd_decode_probe.py [--reps 10] [--rounds 3]

At compressed_wire's shape, (10, 162,417,664) int8 codes of a 64-level wire
in buckets of 512 with every node's weight 1, it prints the compiler's
register, stack and spill report of each kernel and, from ``cuobjdump
-sass``, each N = 10 instantiation's conversions and reciprocals and the
loads it issues before its first multiply, then times with CUDA events:
- ``codes.clone()``, the card's streaming rate;
- the entry point ``qsgd_decode_accumulate_f32`` (one thread a group of 16
  codes, blocks of 128); the same through its Python wrapper
  (``decode_accumulate_kernel``, which checks its inputs and allocates its
  output; its host time a call is printed too); the same kernel on grids
  of 1, 2, 4 and 8 waves of the blocks an SM holds, with a grid-stride
  loop, and with fewer blocks resident an SM (8 and 6, capped by unused
  dynamic shared memory);
- the variants of ``tools/qsgd_decode_probe.cu`` on the entry point's
  grid: the bytes converted on the conversion unit (I2F), the run-time
  node loop, register loads in place of cp.async (with and without an L2
  prefetch of every row first), the tile in dynamic shared memory, the
  kernel's loads and stores without the arithmetic, the arithmetic without
  the loads, and the kernel before its redesign (a divide and an I2F a
  code, the run-time node loop).
Cases are timed in turns, ``--rounds`` times over, so the spread between
rounds shows beside each mean; the rate is over the bytes the function
must move (codes, norms and weights read, the output written; the clone's
2·N·L; the variant without loads moves none).  Every variant that computes
the function is first held bit-equal to the entry point, and the entry
point to ``decode_accumulate_plain``.  Prints one JSON object a line, then
the card's name and power limit.  Needs one CUDA card and nvcc; imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

N, L, BUCKET, LEVELS = 10, 162_417_664, 512, 64
THREADS, VEC = 128, 16             # the kernel's block, codes a thread takes
SM_SHARED = 233_472                # shared memory an SM holds (228 KB)
TILE = N * THREADS * 16            # the kernel's static tile at N nodes
HBM_BYTES_PER_S = 3.35e12
F32 = 4


def build_probe() -> ctypes.CDLL:
    """tools/qsgd_decode_probe.cu (with qsgd_decode.cu inside) as a library;
    prints each kernel's ``-Xptxas -v`` report on one line."""
    from repro_torch.kernels import build
    out = build.BUILD_DIR / "libqsgd_decode_probe.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out),
           str(ROOT / "tools" / "qsgd_decode_probe.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"probe build failed:\n{proc.stdout}{proc.stderr}")
    fn, report = None, {}
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif fn is not None and ("stack frame" in line or "Used" in line):
            report.setdefault(fn, []).append(line.split(":", 1)[-1].strip())
    for fn, lines in report.items():
        print(json.dumps({"ptxas": fn, "report": lines}), flush=True)
    return ctypes.CDLL(str(out))


def load_order(lib: Path) -> None:
    """For each instantiation at N = 10 in the library's SASS
    (``cuobjdump -sass``): its I2F (int-to-float conversion) and MUFU
    (reciprocal, the divide's first step) instructions; the global loads
    issued before its first float multiply, and of them the code-row
    requests (16-byte loads, cp.async copies or L2 prefetches: 10 where
    every code row is in flight before the arithmetic); and the
    run-length order of its loads (LDG128: a code row; LDG: a norm or
    weight; LDGSTS: a cp.async copy; LDS128: a row from shared memory;
    CCTL: a prefetch), multiplies, adds and stores up to the first
    store."""
    from repro_torch.kernels import build
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    proc = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300)
    fn, seqs, units = None, {}, {}
    for line in proc.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            fn = name if ("decode_accumulate_kernelILi10E" in name
                          or "decode_registers_kernel" in name
                          or "decode_dynamic_tile_kernel" in name) else None
            if fn:
                seqs[fn], units[fn] = [], {"I2F": 0, "MUFU": 0}
            continue
        if fn:
            for unit in units[fn]:
                units[fn][unit] += f" {unit}." in line or f" {unit} " in line
        if fn and (not seqs[fn] or seqs[fn][-1] != "STG"):
            op = next((o for o in ("LDGSTS", "LDG", "LDS", "FMUL", "FADD", "STG", "CCTL")
                       if f" {o}." in line or f" {o} " in line), None)
            if op in ("LDG", "LDS") and ".128" in line:
                op += "128"
            if op:
                seqs[fn].append(op)
    for fn, seq in seqs.items():
        first = seq.index("FMUL") if "FMUL" in seq else len(seq)
        runs = []
        for op in seq:
            if runs and runs[-1][0] == op:
                runs[-1][1] += 1
            else:
                runs.append([op, 1])
        print(json.dumps({"sass": fn, "loads_before_first_fmul": sum(
            o.startswith("LDG") for o in seq[:first]), "code_loads_before_first_fmul":
            sum(o in ("LDG128", "LDGSTS", "CCTL") for o in seq[:first]),
            "conversions_and_divides": units[fn], "order": " ".join(f"{o}x{k}" for o, k in runs)}),
            flush=True)
    if not seqs:
        print(json.dumps({"sass": "not measured", "cuobjdump": proc.stderr[-300:]}), flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("qsgd_decode_probe: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.core.compression import inverse
    from repro_torch.kernels import build
    from repro_torch.kernels.qsgd_decode import ops as qdec
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    codes = torch.randint(-LEVELS, LEVELS + 1, (N, L), generator=g, dtype=torch.int8,
                          device=dev)
    norms = torch.rand((N, L // BUCKET), generator=g, device=dev) * 30
    w = torch.ones(N, device=dev)
    out = torch.empty(L, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    r = float(inverse(LEVELS, "cpu"))
    lib = build_probe()
    load_order(build.BUILD_DIR / "libqsgd_decode_probe.so")
    p, i32, i64, f32, u32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
                             ctypes.c_uint)
    entry = lib.qsgd_decode_accumulate_f32
    entry.argtypes, entry.restype = [p, p, p, p, i32, i64, i32, f32, p], i32
    probe = lib.probe_decode_f32
    probe.argtypes, probe.restype = [p, p, p, p, i32, i64, i32, f32, f32, i32, u32, i32, p], i32
    lib.probe_decode_blocks_per_sm.argtypes = [i32, i32]
    lib.probe_decode_blocks_per_sm.restype = i32
    per_sm = {v: lib.probe_decode_blocks_per_sm(v, 0) for v in (0, 1, 2, 4, 5, 6, 7, 8)}
    # dynamic shared memory a block, beyond its static tile, that caps the
    # kernel at 8 and 6 blocks an SM (1,024 and 768 threads; each block also
    # holds 1 KB of the SM's 228 KB)
    caps = {cap: SM_SHARED // cap - 1024 - TILE for cap in (8, 6)}
    capped = {c: lib.probe_decode_blocks_per_sm(0, b) for c, b in caps.items()}
    print(json.dumps({"blocks_per_sm": per_sm, "capped_blocks_per_sm": capped, "sms": sms}),
          flush=True)
    ptrs = (codes.data_ptr(), norms.data_ptr(), w.data_ptr(), out.data_ptr())

    def run_entry():
        build.check(entry(*ptrs, N, L, BUCKET, r, stream), "probe entry")
        return out

    def variant(v, nblk, smem=0):
        def run():
            build.check(probe(*ptrs, N, L, BUCKET, r, float(LEVELS), v, nblk, smem, stream),
                        f"probe variant {v}")
            return out
        return run

    one_step = -(-(L // VEC) // THREADS)
    nbytes = N * L + N * (L // BUCKET) * F32 + N * F32 + L * F32
    def run_wrapper():
        return qdec.decode_accumulate_kernel(codes, norms, w, levels=LEVELS, bucket_size=BUCKET)

    cases = {"codes.clone()": (codes.clone, 2 * N * L),
             f"kernel, entry point nblk={one_step}": (run_entry, nbytes),
             "kernel through its wrapper (checks, allocates its output)": (run_wrapper, nbytes)}
    for waves in (1, 2, 4, 8):
        nblk = waves * per_sm[0] * sms
        cases[f"kernel waves={waves} nblk={nblk}"] = (variant(0, nblk), nbytes)
    for cap, smem in caps.items():
        cases[f"kernel capped at {capped[cap]} blocks an SM"] = (variant(0, one_step, smem),
                                                                 nbytes)
    cases["I2F conversion"] = (variant(1, one_step), nbytes)
    cases["run-time node loop"] = (variant(2, one_step), nbytes)
    cases["register loads in the compiler's order"] = (variant(6, one_step), nbytes)
    cases["register loads, rows prefetched to L2 first"] = (variant(7, one_step), nbytes)
    cases["the tile in dynamic shared memory"] = (variant(8, one_step), nbytes)
    cases["loads+stores, no arithmetic"] = (variant(4, one_step), nbytes)
    cases["arithmetic, no loads"] = (variant(5, one_step), 0)
    cases["before the redesign (divide, I2F, run-time loop)"] = (variant(3, one_step), nbytes)

    # every variant that computes the function against the entry point, the
    # entry point against the plain version
    ref = run_entry().clone()
    plain = qdec.decode_accumulate_plain(codes, norms, w, levels=LEVELS, bucket_size=BUCKET)
    assert torch.equal(ref, plain), "entry point differs from decode_accumulate_plain"
    assert torch.equal(ref, qdec.decode_accumulate_kernel(codes, norms, w, levels=LEVELS,
                                                          bucket_size=BUCKET))
    del plain
    for name, (fn, _) in cases.items():
        if name.startswith(("kernel", "I2F", "run-time", "register loads", "the tile")):
            assert torch.equal(fn(), ref), f"{name} differs from the entry point"
    before = variant(3, one_step)().clone()
    print(json.dumps({"before_vs_kernel_max_abs": float((before - ref).abs().max()),
                      "before_vs_kernel_differing": int((before != ref).sum())}), flush=True)
    del before

    # the wrapper's host time a call, enqueued back to back without a sync:
    # where it exceeds the kernel's time, back-to-back calls leave the card idle
    run_wrapper()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.reps):
        run_wrapper()
    host_ms = (time.perf_counter() - t0) * 1e3 / args.reps
    torch.cuda.synchronize()
    print(json.dumps({"wrapper_host_ms_per_call": host_ms}), flush=True)

    times = {k: [] for k in cases}
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for rnd in range(args.rounds):
        order = list(cases) if rnd % 2 == 0 else list(reversed(cases))
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
    for name, (_, b) in cases.items():
        t = times[name]
        mean = sum(t) / len(t)
        print(json.dumps({"case": name, "ms": t, "mean_ms": mean,
                          "spread_ms": max(t) - min(t), "bytes": b,
                          "TB_per_s": b / mean / 1e9,
                          "share_of_bound": b / HBM_BYTES_PER_S * 1e3 / mean}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
