#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper, sm_90a) and ``nvcc``; imports nothing of JAX
or of the JAX package.  Exits non-zero, printing no result, when CUDA is
missing, when run outside the repository, or when any phase fails.
Phases, each timed with CUDA events:

1. build the four CUDA kernels from ``src/repro_torch/csrc`` (nvcc, in
   parallel);
2. each kernel against its plain PyTorch version, on the card, at the
   swarm round's full-width shapes (N = 10 nodes, D = 162,417,408) and at
   ragged ones (N = 3, D not a multiple of a block; k = 1, an even k, all
   rows masked): the median bit-equal, CenteredClip within 3e-5, krum's d2
   selection-equal and within 1e-5 of the squared norms of both its plain
   version and a float64 gram, decode-accumulate within 1e-6;
3. the main path: ``python -m repro_torch.launch.swarm --full --rounds 3``
   (the showcase: protocol-125m at full width, 10 nodes, QSGD wire,
   CenteredClip, audits), with finite loss, only Byzantine nodes slashed
   and a conserving ledger;
4. one more full-width round on each config that reaches the other
   kernels: krum (krum_d2), the compressed-wire scenario's mean over a
   64-level QSGD wire (decode-accumulate), sign_flip_minority's adaptive-τ
   CenteredClip.  Each of these runs, and the showcase's, has launch
   counters of its own: zeroed just before it, read just after it, and
   held to the launches that path must make (``EXPECTED_LAUNCHES``);
5. fused against unfused: one showcase round from the same state with the
   same draws; equal audits and masks, close aggregate and params; then two
   more showcase rounds timed, and one under torch.profiler (device time by
   kernel, the device's busy share);
6. time each kernel, its plain version and the matching PyTorch library
   call where one exists, at the full-width shapes.

Output: one line per phase, then a ``{"kernels": [...]}`` JSON line, the
card's ``name, power.limit`` from nvidia-smi, and as the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_NODES = 10
D_FULL = 162_417_408            # protocol-125m's parameter count
SHOWCASE_ROUNDS = 3
BUCKET, LEVELS_WIRE = 512, 64   # compressed_wire's QSGD wire
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores

# kernel -> (source, TPU kernel it replaces, the driven path that is its own)
KERNELS = {
    "masked_median": ("src/repro_torch/csrc/masked_agg.cu",
                      "src/repro/kernels/masked_agg/kernel.py:133", "showcase"),
    "masked_cc_iter": ("src/repro_torch/csrc/masked_agg.cu",
                       "src/repro/kernels/masked_agg/kernel.py:192", "showcase"),
    "masked_krum_d2": ("src/repro_torch/csrc/masked_agg.cu",
                       "src/repro/kernels/masked_agg/kernel.py:234", "krum"),
    "qsgd_decode_accumulate": ("src/repro_torch/csrc/qsgd_decode.cu",
                               "src/repro/kernels/qsgd_decode/kernel.py:41",
                               "compressed_wire"),
}

# launches each driven path must make (kernels not named: none).  A
# CenteredClip round warm-starts from one median and runs 3 iterations.
EXPECTED_LAUNCHES = {
    "showcase": {"masked_median": SHOWCASE_ROUNDS,
                 "masked_cc_iter": 3 * SHOWCASE_ROUNDS},
    "krum": {"masked_krum_d2": 1},
    "compressed_wire": {"qsgd_decode_accumulate": 1},
    "sign_flip_minority": {"masked_median": 1, "masked_cc_iter": 3},
}


class PhaseFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this test runs on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable from {ROOT / 'src'}: {e}",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke = Smoke(torch, build)
    try:
        smoke.run()
    except Exception:                       # any failed phase: no result line
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    return 0


class Smoke:
    def __init__(self, torch, build):
        self.torch = torch
        self.build = build
        self.dev = torch.device("cuda")
        self.errors = {}           # kernel -> max abs error at main-path shapes
        self.launches = {}         # driven path -> {kernel: launches on it}

    # -- helpers ------------------------------------------------------------------
    def phase(self, name, fn):
        torch = self.torch
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.time()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        print(f"[phase] {name}: ok, {start.elapsed_time(end) / 1e3:.3f} s on CUDA "
              f"events ({time.time() - t0:.3f} s wall)", flush=True)
        return out

    def free(self):
        import gc
        gc.collect()
        self.torch.cuda.empty_cache()

    def stack(self, n, d, seed):
        g = self.torch.Generator(device=self.dev).manual_seed(seed)
        x = self.torch.randn((n, d), generator=g, device=self.dev)
        return x.mul_(2.0).add_(0.5)

    def mask(self, n, kind):
        torch = self.torch
        i = torch.arange(n, device=self.dev)
        return {"all": i < n, "k1": i == min(2, n - 1), "even": i < 2 * max(1, n // 3),
                "none": i < 0}[kind]

    def bit_equal(self, a, b):
        """Identical bit patterns (signed zeros included); NaN matches NaN."""
        same = a.view(self.torch.int32) == b.view(self.torch.int32)
        return bool((same | (a.isnan() & b.isnan())).all())

    def record_err(self, name, a, b):
        diff = (a - b).abs()
        diff = diff[~(a.isnan() & b.isnan())]
        err = float(diff.max()) if diff.numel() else 0.0
        self.errors[name] = max(self.errors.get(name, 0.0), err)
        return err

    def counted(self, path, fn):
        """Run ``fn`` with every launch counter at 0 and hold the counts
        just after it to ``EXPECTED_LAUNCHES[path]``."""
        from repro_torch.kernels.masked_agg import ops as magg
        from repro_torch.kernels.qsgd_decode import ops as qdec
        for d in (magg.LAUNCHES, qdec.LAUNCHES):
            for k in d:
                d[k] = 0
        out = fn()
        got = {**magg.LAUNCHES, **qdec.LAUNCHES}
        want = {k: EXPECTED_LAUNCHES[path].get(k, 0) for k in got}
        print(f"  launches on {path}: {json.dumps(got)}", flush=True)
        check(got == want, f"{path}: launches {got}, expected {want}")
        self.launches[path] = got
        return out

    # -- phases -------------------------------------------------------------------
    def run(self):
        torch = self.torch
        self.phase("1 build kernels", self.build_kernels)
        self.phase("2 kernels vs plain", self.kernels_vs_plain)
        torch.cuda.reset_peak_memory_stats()
        main_out = self.phase("3 main path (showcase, full width)", self.main_path)
        self.phase("4 other configs (full width)", lambda: self.other_configs(main_out))
        self.phase("5 fused vs unfused", lambda: self.fused_vs_unfused(main_out))
        self.phase("5b showcase rounds timed and profiled",
                   lambda: self.profile_rounds(main_out))
        del main_out
        self.free()
        rows = self.phase("6 timings", self.timings)
        print(json.dumps({"kernels": rows}), flush=True)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
              else f"nvidia-smi: {smi.stderr.strip()}", flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)

    def build_kernels(self):
        logs = self.build.build()
        for lib, log in logs.items():
            fn = None
            for line in log.splitlines():
                if "Compiling entry function" in line:
                    fn = line.split("'")[1]
                elif "Used" in line and fn is not None:
                    print(f"  ptxas {lib}: {fn[-60:]} {line.split(':', 1)[1].strip()}")
                    fn = None
        for name in self.build.SOURCES:
            self.build.load(name)

    def kernels_vs_plain(self):
        torch = self.torch
        from repro_torch.core.aggregation import _krum_scores_from_d2
        from repro_torch.kernels.masked_agg import ops as magg
        from repro_torch.kernels.qsgd_decode import ops as qdec
        cases = [(N_NODES, D_FULL, True), (3, 1_000_003, False)]
        for n, d, main_shape in cases:
            x = self.stack(n, d, seed=n)
            for kind in ("all", "k1", "even", "none"):
                m = self.mask(n, kind)
                tag = f"N={n} D={d} mask={kind}"
                # median: bit-equal, NaN where no row is kept
                out, ref = magg.masked_median(x, m), magg.masked_median_plain(x, m)
                check(self.bit_equal(out, ref), f"median not bit-equal ({tag})")
                if main_shape:
                    self.record_err("masked_median", out, ref)
                # CenteredClip iteration, fixed and adaptive tau, from the median
                v = torch.nan_to_num(out)
                for tau in (2.0, None):
                    o = magg.masked_cc_iter(x, v, m, clip_tau=tau)
                    r = magg.masked_cc_iter_plain(x, v, m, tau)
                    both_nan = o.isnan() & r.isnan()
                    ok = ((o - r).abs() <= 3e-5 + 3e-5 * r.abs()) | both_nan
                    check(bool(ok.all()), f"cc_iter beyond 3e-5 ({tag}, tau={tau})")
                    if main_shape:
                        self.record_err("masked_cc_iter", o, r)
                    del o, r
                del out, ref, v
                print(f"  median + cc_iter ok: {tag}", flush=True)
            # krum d2: gram-form rounding, same selection on every mask.  The
            # gram form cancels: d2 = |x_i|^2 + |x_j|^2 - 2 x_i.x_j, so float32
            # rounding scales with the squared norms, sums of D products
            # (~1e-6 of them at D = 1.6e8).  Held against the plain version
            # (which sums the same 128-column tiles) and against an
            # independent float64 gram, each within 1e-5 of the squared norms
            d2, ref = magg.masked_krum_d2(x), magg.masked_krum_d2_plain(x)
            g64 = torch.zeros((n, n), dtype=torch.float64, device=self.dev)
            step = (1 << 24) // n
            for c0 in range(0, d, step):
                xc = x[:, c0:c0 + step].double()
                g64 += xc @ xc.T
            del xc
            q = torch.diagonal(g64)
            d64 = q[:, None] + q[None, :] - 2.0 * g64
            scale = q[:, None] + q[None, :]
            for who, val in (("plain", ref.double()), ("float64", d64)):
                rel = float(((d2.double() - val).abs() / scale).max())
                print(f"  krum_d2: max |d2 - {who}| / (|x_i|^2 + |x_j|^2) = "
                      f"{rel:.3e}", flush=True)
                check(rel <= 1e-5, f"krum d2 beyond 1e-5 of the squared norms "
                                   f"from {who} (N={n})")
            del g64, d64
            for kind in ("all", "k1", "even"):
                m = self.mask(n, kind)
                for f in (1, 2):
                    a = int(torch.argmin(_krum_scores_from_d2(d2, m, f)))
                    b = int(torch.argmin(_krum_scores_from_d2(ref, m, f)))
                    check(a == b, f"krum selection differs (N={n}, mask={kind}, f={f})")
            if main_shape:
                self.record_err("masked_krum_d2", d2, ref)
            print(f"  krum_d2 ok: N={n} D={d}", flush=True)
            # decode-accumulate on a 64-level wire of x's rows
            nb = -(-d // BUCKET)
            codes = torch.empty((n, nb * BUCKET), dtype=torch.int8, device=self.dev)
            norms = torch.empty((n, nb), dtype=torch.float32, device=self.dev)
            g = torch.Generator(device=self.dev).manual_seed(7)
            for i in range(n):
                u = torch.rand((nb, BUCKET), generator=g, device=self.dev)
                p = qdec.wire_encode(x[i], u, levels=LEVELS_WIRE, bucket_size=BUCKET)
                codes[i], norms[i] = p.codes.reshape(-1), p.norms.reshape(-1)
                del u, p
            del x
            self.free()
            for kind in ("all", "k1", "none"):
                w = self.mask(n, kind).float()
                o = qdec.decode_accumulate_kernel(codes, norms, w, levels=LEVELS_WIRE,
                                                  bucket_size=BUCKET)
                r = qdec.decode_accumulate_plain(codes, norms, w, levels=LEVELS_WIRE,
                                                 bucket_size=BUCKET)
                check(bool(((o - r).abs() <= 1e-6 * r.abs().clamp(min=1.0)).all()),
                      f"decode beyond 1e-6 (N={n}, mask={kind})")
                if main_shape:
                    self.record_err("qsgd_decode_accumulate", o, r)
                del o, r
            print(f"  decode_accumulate ok: N={n} L={nb * BUCKET}", flush=True)
            del codes, norms
            self.free()

    def main_path(self):
        torch = self.torch
        from repro_torch.core.swarm import BEHAVIOURS
        from repro_torch.launch import swarm as launch
        out = self.counted("showcase", lambda: launch.main(
            ["--full", "--rounds", str(SHOWCASE_ROUNDS)]))
        sw = out["swarm"]
        byz = {n.node_id for n in sw.nodes if n.byzantine in BEHAVIOURS[1:]}
        check(all(math.isfinite(l) for l in out["losses"]), "non-finite loss")
        check(sw.slashed <= byz, f"honest node slashed: {sorted(sw.slashed - byz)}")
        check(sw.ledger.check_conservation(), "ledger does not conserve")
        check(sw.fused, "the full-width showcase should take the fused path")
        print(f"  showcase: {out['seconds'] / out['rounds']:.3f} s/round, "
              f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
              f"losses {out['losses']}, slashed {sorted(sw.slashed)}", flush=True)
        return out

    def other_configs(self, main_out):
        from repro_torch.core.swarm import NodeSpec, SwarmConfig
        from repro_torch.launch import swarm as launch
        problem = main_out["problem"]
        showcase_nodes = main_out["nodes"]
        honest = [NodeSpec(f"h{i}") for i in range(N_NODES)]
        minority = ([NodeSpec(f"h{i}") for i in range(N_NODES - 2)]
                    + [NodeSpec(f"adv{i}", byzantine="sign_flip", byzantine_scale=10.0)
                       for i in range(2)])
        configs = [
            ("krum", showcase_nodes, SwarmConfig(aggregator="krum")),
            ("compressed_wire", honest, SwarmConfig(
                aggregator="mean", compression="qsgd",
                compression_kwargs={"levels": LEVELS_WIRE, "bucket_size": BUCKET})),
            ("sign_flip_minority", minority, SwarmConfig(aggregator="centered_clip")),
        ]
        for name, nodes, cfg in configs:
            sw = launch.make_showcase_swarm(problem, nodes, cfg)
            check(sw.fused, f"{name}: the full-width round should be fused")
            t0 = time.time()
            rec = self.counted(name, lambda: sw.step(0))
            self.torch.cuda.synchronize()
            loss = problem.eval_loss(sw.params, len(nodes))
            check(math.isfinite(rec["agg_norm"]) and math.isfinite(loss),
                  f"{name}: non-finite result")
            print(f"  {name}: 1 round {time.time() - t0:.3f} s, agg_norm "
                  f"{rec['agg_norm']:.4f}, loss {loss:.4f}", flush=True)
            del sw
            self.free()

    def fused_vs_unfused(self, main_out):
        torch = self.torch
        from dataclasses import replace
        from repro_torch.launch import swarm as launch
        from repro_torch.models.convert import flatten
        problem = main_out["problem"]
        nodes, cfg = launch.showcase_roster(3)
        outs = {}
        for fused in (True, False):
            sw = launch.make_showcase_swarm(problem, nodes, replace(cfg, fused=fused))
            check(sw.fused is fused, "fused flag not honoured")
            rec = sw.step(0)
            keep = sorted(n for op, n, _ in sw.ledger.history if op == "mint")
            outs[fused] = (rec, keep, flatten(sw.params))
            del sw
            self.free()
        (rf, kf, pf), (ru, ku, pu) = outs[True], outs[False]
        p0 = flatten(problem.params)
        check(rf["caught"] == ru["caught"], "caught differs fused vs unfused")
        check(kf == ku, "keep differs fused vs unfused")
        agg_rel = abs(rf["agg_norm"] - ru["agg_norm"]) / ru["agg_norm"]
        par_rel = float((pf - pu).norm() / (pu - p0).norm())
        print(f"  fused vs unfused: caught {rf['caught']} == {ru['caught']}, "
              f"agg_norm {rf['agg_norm']:.6f} vs {ru['agg_norm']:.6f} "
              f"(rel {agg_rel:.3e}), |dparams|/|update| {par_rel:.3e}", flush=True)
        # the aggregates differ only in float-sum order (~1e-6 relative);
        # AdamW's first step moves a coordinate by +-lr by the sign of its
        # aggregate, so a coordinate within rounding of zero may flip
        check(agg_rel <= 1e-5, "agg_norm differs fused vs unfused beyond 1e-5")
        check(par_rel <= 1e-2, "params differ fused vs unfused beyond 1e-2 of the update")

    def profile_rounds(self, main_out):
        """Two more showcase rounds timed on the host clock, then one under
        torch.profiler: device time by kernel and the device's busy share."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        sw = main_out["swarm"]
        times = []
        for r in (3, 4):
            t0 = time.time()
            sw.step(r)
            torch.cuda.synchronize()
            times.append(time.time() - t0)
        print(f"  showcase round wall times (no profiler): {times} s", flush=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            sw.step(5)
            torch.cuda.synchronize()
            wall_ms = (time.time() - t0) * 1e3

        def self_dev(e):
            return (getattr(e, "self_device_time_total", None)
                    or getattr(e, "self_cuda_time_total", 0) or 0) / 1e3

        # device-side rows only (kernels, memcpy, memset): the aten:: rows
        # repeat their kernels' time
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(self_dev(e) for e in events)
        if busy_ms <= 0:
            print("  profiler: no device time recorded (device busy share not "
                  "measured)", flush=True)
            return
        plain_ms = 1e3 * sorted(times)[0]
        print(f"  profiled round: {wall_ms:.1f} ms wall with the profiler on; device "
              f"busy {busy_ms:.1f} ms = {busy_ms / plain_ms:.1%} of the faster "
              f"unprofiled round ({plain_ms:.1f} ms)", flush=True)
        for e in sorted(events, key=self_dev, reverse=True)[:14]:
            print(f"    {self_dev(e):9.2f} ms  x{e.count:<5d} {e.key[:90]}", flush=True)

    def time_ms(self, fn, reps):
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def timings(self):
        torch = self.torch
        from repro_torch.kernels.masked_agg import ops as magg
        from repro_torch.kernels.qsgd_decode import ops as qdec
        n, d = N_NODES, D_FULL
        x = self.stack(n, d, seed=11)
        m = self.mask(n, "all")
        v = magg.masked_median(x, m)

        def nanquantile_chunks():
            step = (1 << 24) // n
            for c0 in range(0, d, step):
                torch.nanquantile(x[:, c0:c0 + step], 0.5, dim=0,
                                  interpolation="midpoint")

        rows = []
        f32 = 4
        specs = [
            ("masked_median", lambda: magg.masked_median(x, m),
             lambda: magg.masked_median_plain(x, m), nanquantile_chunks,
             (n * d + d) * f32 + n * f32, 0),
            ("masked_cc_iter", lambda: magg.masked_cc_iter(x, v, m, clip_tau=2.0),
             lambda: magg.masked_cc_iter_plain(x, v, m, 2.0), None,
             (n * d + 2 * d) * f32 + n * f32, 0),
            ("masked_krum_d2", lambda: magg.masked_krum_d2(x),
             lambda: magg.masked_krum_d2_plain(x),
             lambda: torch.cdist(x, x) ** 2,
             n * d * f32 + n * n * f32, n * (n + 1) * d),
        ]
        for name, kern, plain, lib, nbytes, flops in specs:
            rows.append(self.row(name, kern, plain, lib, nbytes, flops))
        del v
        nb = -(-d // BUCKET)
        codes = torch.randint(-LEVELS_WIRE, LEVELS_WIRE + 1, (n, nb * BUCKET),
                              dtype=torch.int8, device=self.dev)
        del x
        self.free()
        norms = torch.rand((n, nb), device=self.dev) * 30
        w = m.float()
        rows.append(self.row(
            "qsgd_decode_accumulate",
            lambda: qdec.decode_accumulate_kernel(codes, norms, w, levels=LEVELS_WIRE,
                                                  bucket_size=BUCKET),
            lambda: qdec.decode_accumulate_plain(codes, norms, w, levels=LEVELS_WIRE,
                                                 bucket_size=BUCKET),
            None, n * nb * BUCKET + n * nb * f32 + n * f32 + nb * BUCKET * f32, 0))
        return rows

    def row(self, name, kern, plain, lib, nbytes, flops):
        ms = self.time_ms(kern, 10)
        plain_ms = self.time_ms(plain, 2)
        lib_ms = self.time_ms(lib, 2) if lib is not None else None
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOP_PER_S * 1e3
        src, replaces, path = KERNELS[name]
        # launches: on the kernel's own path; by path: every driven path
        by_path = {p: c[name] for p, c in self.launches.items() if c[name]}
        row = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
               "launches": self.launches[path][name], "launches_by_path": by_path,
               "max_abs_err": self.errors[name],
               "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": lib_ms}
        print(f"  {name}: {ms:.3f} ms (bound {row['bound_ms']:.3f} ms by "
              f"{row['bound_by']}, {row['bound_ms'] / ms:.1%} of it), plain "
              f"{plain_ms:.3f} ms, library {lib_ms}", flush=True)
        self.free()
        return row


if __name__ == "__main__":
    sys.exit(main())
