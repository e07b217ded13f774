"""Package contract of the port: no JAX inside, no quiet CPU fallback, and
each CUDA kernel against its plain version on the card.

The ``cuda`` tests need an NVIDIA GPU and ``nvcc``; on a machine without
them they skip with that reason.  Run them on the card with (the shared
``conftest.py`` imports JAX, which the card's machine need not have)

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_package.py
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import compression, scenarios, serving, unextractable
from repro_torch.core import swarm as tswarm
from repro_torch.core.swarm import make_round_fn
from repro_torch.data import pipeline
from repro_torch.device import resolve_device
from repro_torch.kernels import cc_chain
from repro_torch.kernels.centered_clip import ops as cc_ops
from repro_torch.kernels.mamba2_scan import ops as ssd_ops
from repro_torch.kernels.masked_agg import ops as magg
from repro_torch.kernels.qsgd import ops as qsgd_ops
from repro_torch.kernels.qsgd_decode import ops as qdec
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.kernels.swa_attention import ops as swa
from repro_torch.launch import custody_frontier as launch_custody
from repro_torch.launch import derailment_no_off as launch_derailment
from repro_torch.launch import problems
from repro_torch.launch import protocol_inference as launch_protocol
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import serving_no_off as launch_serving
from repro_torch.launch import swarm as launch_swarm
from repro_torch.launch import topology_no_off as launch_topology
from repro_torch.models import convert
from repro_torch.models.model import build_model
from repro_torch.optim.optimizer import SGD

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one intra-op thread for the module: the suite runs several
    test files at once, and a thread pool each oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for m in mods:
    importlib.import_module(m)
sys.path.insert(0, sys.argv[1])
import chip_smoke
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")]
print(" ".join(mods))
"""


def test_port_imports_without_jax_or_the_reference():
    """Every ``repro_torch`` module and ``chip_smoke.py`` import in a process
    where importing ``jax`` or ``repro`` raises."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT, str(ROOT)],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    mods = set(out.stdout.split())
    assert len(mods) >= 48
    assert {"repro_torch.kernels.swa_attention.ops", "repro_torch.core.protocol",
            "repro_torch.core.serving", "repro_torch.core.unextractable",
            "repro_torch.launch.serve", "repro_torch.launch.protocol_inference",
            "repro_torch.configs.h2o_danube_1_8b", "repro_torch.configs.rwkv6_1_6b",
            "repro_torch.models.rwkv6", "repro_torch.kernels.rwkv6_wkv.ops",
            "repro_torch.configs.zamba2_1_2b", "repro_torch.models.mamba2",
            "repro_torch.models.hybrid", "repro_torch.kernels.mamba2_scan.ops",
            "repro_torch.kernels.qsgd.ops", "repro_torch.kernels.centered_clip.ops",
            "repro_torch.core.scenarios", "repro_torch.core.derailment",
            "repro_torch.core.economy",
            "repro_torch.launch.problems", "repro_torch.core.topology",
            "repro_torch.core.gossip", "repro_torch.launch.derailment_no_off",
            "repro_torch.checkpoint.checkpoint", "repro_torch.launch.custody_frontier",
            "repro_torch.launch.topology_no_off", "repro_torch.launch.serving_no_off",
            "repro_torch.models.moe", "repro_torch.configs.mixtral_8x7b",
            "repro_torch.configs.qwen3_moe_30b_a3b", "repro_torch.configs.qwen2_vl_2b",
            "repro_torch.configs.stablelm_3b", "repro_torch.configs.tinyllama_1_1b",
            "repro_torch.configs.granite_20b"} <= mods


def test_entry_points_refuse_the_cpu_unless_asked():
    """Without CUDA, every entry point that defaults to the card raises
    instead of running on the CPU; naming the CPU runs there."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is the card here")
    cfg = get_config("protocol-125m").reduced(num_layers=1, d_model=32,
                                              num_heads=2, head_dim=16,
                                              d_ff=64, vocab_size=64)
    dcfg = pipeline.DataConfig(vocab_size=64, seq_len=8, global_batch=2)
    layout = convert.layout_of(build_model(cfg).init(0, "cpu"))
    rwkv = build_model(get_config("rwkv6-1.6b").reduced())
    zamba = build_model(get_config("zamba2-1.2b").reduced())
    for call in (lambda: resolve_device(None),
                 lambda: resolve_device("cuda"),
                 lambda: build_model(cfg).init(0),
                 lambda: pipeline.sample_tokens(dcfg, 0),
                 lambda: pipeline.data_fn_for_swarm(cfg, dcfg, 2),
                 lambda: convert.params_from_jax({"w": np.zeros(2, np.float32)}),
                 lambda: unextractable.reconstruct_params({}, layout, 4,
                                                          convert.flat_size(layout)),
                 lambda: launch_swarm.main(["--rounds", "1"]),
                 lambda: launch_serve.main([]),
                 lambda: launch_protocol.main([]),
                 lambda: rwkv.init(0),
                 lambda: rwkv.init_cache(1, 8),
                 lambda: rwkv.concrete_batch(0, 1, 8),
                 lambda: launch_serve.main(["--arch", "rwkv6-1.6b"]),
                 lambda: launch_protocol.main(["--arch", "rwkv6-1.6b"]),
                 lambda: zamba.init(0),
                 lambda: zamba.init_cache(1, 8),
                 lambda: zamba.concrete_batch(0, 1, 8),
                 lambda: launch_serve.main(["--arch", "zamba2-1.2b"]),
                 lambda: launch_protocol.main(["--arch", "zamba2-1.2b"]),
                 lambda: problems.tiny_quadratic_problem(),
                 lambda: problems.small_lm_problem(),
                 lambda: launch_swarm.main(["--rounds", "1", "--scenario",
                                            "byzantine_neighborhood"]),
                 lambda: launch_derailment.main(["--rounds", "1"]),
                 lambda: launch_topology.main(["--rounds", "1", "--tiny"]),
                 lambda: launch_custody.main(["--rounds", "1", "--tiny"]),
                 lambda: launch_serve.main(["--driver", "engine"]),
                 lambda: launch_serving.main(["--smoke"]),
                 lambda: serving.ServingEngine(build_model(cfg), serving.ServingConfig(),
                                               np.zeros((2, 4), np.int32)),
                 lambda: serving.build_lane(n_requests=1, prompt_lens=[1], max_new=1,
                                            steps=1, n_nodes=1, balances=[1.0], load=1.0),
                 lambda: serving.sweep(build_model(cfg), {},
                                       scenarios.get_serving_grid("serving_smoke"))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert resolve_device("cpu").type == "cpu"
    assert build_model(cfg).init(0, "cpu")["embed"].device.type == "cpu"


def test_launcher_runs_the_showcase_on_the_cpu_when_asked(capsys):
    out = launch_swarm.main(["--device", "cpu", "--rounds", "2"])
    swarm = out["swarm"]
    assert swarm.fused and len(swarm.history) == 2
    assert all(np.isfinite(out["losses"]))
    assert swarm.ledger.check_conservation()
    assert "fractional ownership (ledger):" in capsys.readouterr().out


def test_serving_launchers_run_on_the_cpu_when_asked(capsys):
    out = launch_serve.main(["--device", "cpu", "--arch", "h2o-danube-1.8b",
                             "--prompt-len", "30", "--max-new", "4"])
    assert out["cfg"].use_pallas_kernels and out["cfg"].sliding_window == 32
    assert out["tokens"].shape == (4, 4)
    out = launch_protocol.main(["--device", "cpu", "--arch", "h2o-danube-1.8b",
                                "--seq", "40", "--batch", "1"])
    assert torch.equal(out["logits"], out["ref"])
    assert torch.equal(out["logits_online"], out["ref"])
    assert out["refused"] is not None and out["collapsed"] is not None
    assert out["extract_err"] > 1e-2 and out["protocol_model"]
    text = capsys.readouterr().out
    assert "use_pallas_kernels=True" in text and "missing shard ids" in text
    out = launch_serve.main(["--device", "cpu", "--driver", "engine", "--batch", "3",
                             "--slots", "2", "--prompt-len", "4", "--max-new", "3"])
    assert out["result"].done.all() and out["result"].tokens_served == 9


def test_rwkv6_launchers_run_on_the_cpu_when_asked(capsys):
    """rwkv6 through both serving launchers at the reduced width, each
    printing the count of the params it built."""
    out = launch_serve.main(["--device", "cpu", "--arch", "rwkv6-1.6b",
                             "--prompt-len", "20", "--max-new", "4"])
    assert out["cfg"].use_pallas_kernels and out["tokens"].shape == (4, 4)
    out = launch_protocol.main(["--device", "cpu", "--arch", "rwkv6-1.6b",
                                "--seq", "40", "--batch", "1"])
    assert out["model"].cfg.rwkv_head_dim == 32 and out["model"].cfg.d_model == 256
    assert torch.equal(out["logits"], out["ref"])
    assert torch.equal(out["logits_online"], out["ref"])
    assert out["refused"] is not None and out["collapsed"] is not None
    assert out["n_params"] == sum(t.numel() for t in out["params"].values())
    assert f"N={out['n_params']:,}" in capsys.readouterr().out


def test_zamba2_launchers_run_on_the_cpu_when_asked(capsys):
    """zamba2 through both serving launchers at the reduced width (4 groups
    of 1 mamba layer, 16 SSD heads of 32, state 16), each printing the
    count of the params it built."""
    out = launch_serve.main(["--device", "cpu", "--arch", "zamba2-1.2b",
                             "--prompt-len", "20", "--max-new", "4"])
    assert out["cfg"].use_pallas_kernels and out["tokens"].shape == (4, 4)
    out = launch_protocol.main(["--device", "cpu", "--arch", "zamba2-1.2b",
                                "--seq", "40", "--batch", "1"])
    cfg = out["model"].cfg
    assert (cfg.num_layers, cfg.mamba_per_group, cfg.ssm_head_dim, cfg.ssm_state_size,
            cfg.d_model) == (4, 1, 32, 16, 256)
    assert torch.equal(out["logits"], out["ref"])
    assert torch.equal(out["logits_online"], out["ref"])
    assert out["refused"] is not None and out["collapsed"] is not None
    assert out["n_params"] == sum(t.numel() for t in out["params"].values())
    assert f"N={out['n_params']:,}" in capsys.readouterr().out


def test_unported_families_name_their_item():
    """The audio family, still to port, raises naming its ROADMAP item; the
    hybrid (zamba2), MoE and VLM families build, and model_batch serves the
    VLM."""
    with pytest.raises(NotImplementedError, match="queue 1, item 11"):
        build_model(get_config("rwkv6-1.6b").reduced(family="audio"))
    with pytest.raises(NotImplementedError, match="queue 1, item 11"):
        pipeline.model_batch(get_config("rwkv6-1.6b").reduced(family="audio"),
                             pipeline.DataConfig(64, 8, 2), 0, device="cpu")
    assert build_model(get_config("zamba2-1.2b").reduced()).family.__name__.endswith("hybrid")
    for arch in ("mixtral-8x7b", "qwen2-vl-2b"):
        assert build_model(get_config(arch).reduced()).family.__name__.endswith("transformer")
    vlm = pipeline.model_batch(get_config("qwen2-vl-2b").reduced(),
                               pipeline.DataConfig(64, 16, 2), 0, device="cpu")
    assert vlm["tokens"].shape == (2, 8) and vlm["positions"].shape == (3, 2, 16)


def test_swa_kernel_has_no_backward():
    """As in the reference, the kernel path is inference only: the wrapper
    raises on an input that requires grad (on any device), and runs under
    no_grad or inference_mode."""
    q, k, v = _qkv(1, 16, 4, 2, 16, torch.float32, "cpu")
    with pytest.raises(RuntimeError, match="no backward"):
        swa.swa_attention(q.requires_grad_(), k, v, window=4)
    with torch.no_grad():
        assert swa.swa_attention(q, k, v, window=4).shape == q.shape


def test_wkv_kernel_has_no_backward():
    r, k, v, w, u = _wkv(1, 16, 2, 16, torch.float32, "cpu")
    with pytest.raises(RuntimeError, match="no backward"):
        wkv_ops.wkv(r.requires_grad_(), k, v, w, u)
    with torch.no_grad():
        y, s = wkv_ops.wkv(r, k, v, w, u)
    assert y.shape == r.shape and s.shape == (1, 2, 16, 16)


def test_ssd_kernel_has_no_backward():
    x, dt, a, b, c, d = _ssd(1, 16, 2, 16, 16, torch.float32, "cpu")
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_ops.ssd(x.requires_grad_(), dt, a, b, c, d)
    with torch.no_grad():
        y, h = ssd_ops.ssd(x, dt, a, b, c, d)
    assert y.shape == x.shape and h.shape == (1, 2, 16, 16)


@pytest.mark.parametrize("device,size,levels,expect", [
    ("cpu", 8, 127, False),                       # below FUSED_MIN_BYTES
    ("cpu", magg.FUSED_MIN_BYTES // 8, 127, True),
    ("cpu", magg.FUSED_MIN_BYTES // 8, 200, False),   # codes beyond int8
    pytest.param("cuda", 8, 127, True, marks=pytest.mark.cuda),
])
def test_fused_auto_choice(device, size, levels, expect):
    """``fused=None`` resolves as the reference does on the CPU (fusable and
    the (2, size) float32 stack reaches FUSED_MIN_BYTES); on the card any
    fusable round takes the kernels."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available here)")
    fn = make_round_fn(None, SGD(), {"w": torch.zeros(size, device=device)}, 2,
                       aggregator="mean", compression_kind="qsgd",
                       compression_kwargs={"levels": levels})
    assert fn.fused is expect


# ------------------------------- on the card -----------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available here)")
    return torch.device("cuda")


def _stack(n, d, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, d), generator=g) * 2 + 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(10, 100_003), (3, 4097), (64, 1000)])
@pytest.mark.parametrize("k", [0, 1, 2, -1])
def test_median_kernel_bit_equal(cuda, n, d, k):
    x = _stack(n, d).to(cuda)
    mask = torch.arange(n, device=cuda) < (n if k == -1 else k)
    out = magg.masked_median(x, mask)
    torch.testing.assert_close(out, magg.masked_median_plain(x, mask), rtol=0,
                               atol=0, equal_nan=True)


def _bit_equal(a, b):
    """Identical bit patterns (signed zeros included); NaN matches NaN."""
    return bool(((a.view(torch.int32) == b.view(torch.int32)) | (a.isnan() & b.isnan())).all())


def _stack_at(n, d, layout, device, seed=0):
    """An (n, d) stack: 16-byte aligned (the VEC = 4 route), at a base 4
    bytes off a 16-byte boundary, or with an odd d (both VEC = 1)."""
    if layout == "odd_d":
        d += 1 - d % 2
    x = _stack(n, d, seed)
    if layout == "misaligned":
        buf = torch.empty(n * d + 1, device=device)
        out = buf[1:].view(n, d)
        out.copy_(x)
        assert out.data_ptr() % 16 == 4
        return out
    return x.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["aligned", "misaligned", "odd_d"])
@pytest.mark.parametrize("n", [10, 16])
def test_median_kernel_bit_equal_every_k(cuda, n, layout):
    """Every kept count K = 0..n, kept rows a random subset, on the route
    the layout takes; columns of +0.0/-0.0 ties and of +-inf among them,
    so the kernel's networks must be the plain version's exactly."""
    x = _stack_at(n, 40_000, layout, cuda)
    g = torch.Generator().manual_seed(n)
    zeros = torch.where(torch.rand((n, 64), generator=g) < 0.5, 0.0, -0.0)
    x[:, 100:164] = zeros.to(cuda)
    x[:, 300:364] = torch.where(torch.rand((n, 64), generator=g) < 0.5, float("inf"),
                                float("-inf")).to(cuda)
    assert magg.grid_for(x).vec == (4 if layout == "aligned" else 1)
    for k in range(n + 1):
        keep = torch.randperm(n, generator=g)[:k]
        mask = torch.zeros(n, dtype=torch.bool)
        mask[keep] = True
        mask = mask.to(cuda)
        out, ref = magg.masked_median(x, mask), magg.masked_median_plain(x, mask)
        assert _bit_equal(out, ref), f"K={k}"


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["aligned", "misaligned", "odd_d"])
@pytest.mark.parametrize("n", list(range(1, 18)) + [64])
def test_krum_d2_kernel_every_n(cuda, n, layout):
    """n = 1..16 take the register Gram at the exact n, 17 and 64 the tile
    route; within 1e-5 of the squared norms of both the plain version and a
    float64 gram, and the same selection."""
    from repro_torch.core.aggregation import _krum_scores_from_d2
    x = _stack_at(n, 30_001 if n > 16 else 200_000, layout, cuda, seed=n)
    d2, ref = magg.masked_krum_d2(x), magg.masked_krum_d2_plain(x)
    x64 = x.double()
    g64 = x64 @ x64.T
    q = torch.diagonal(g64)
    d64 = q[:, None] + q[None, :] - 2.0 * g64
    scale = q[:, None] + q[None, :]
    for val in (ref.double(), d64):
        assert float(((d2.double() - val).abs() / scale).max()) <= 1e-5
    assert torch.equal(d2, d2.T)
    for f in (1, 2):
        mask = torch.ones(n, dtype=torch.bool, device=cuda)
        assert int(torch.argmin(_krum_scores_from_d2(d2, mask, f))) == \
            int(torch.argmin(_krum_scores_from_d2(ref, mask, f)))


@pytest.mark.cuda
def test_median_and_krum_d2_replay_in_a_cuda_graph(cuda):
    """Both wrappers captured once in a CUDA graph: replays equal eager
    calls, at the captured mask and after another mask is copied into its
    buffer, so the kept count is read on the device."""
    n = 10
    x = _stack(n, 100_000).to(cuda)
    mask = torch.ones(n, dtype=torch.bool, device=cuda)
    magg.masked_median(x, mask), magg.masked_krum_d2(x)        # build and warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        med = magg.masked_median(x, mask)
        d2 = magg.masked_krum_d2(x)
    for keep in (n, 7, 0, 4):
        mask.copy_(torch.arange(n, device=cuda) < keep)
        graph.replay()
        torch.cuda.synchronize()
        assert _bit_equal(med, magg.masked_median(x, mask)), f"K={keep}"
        assert torch.equal(d2, magg.masked_krum_d2(x))


@pytest.mark.cuda
@pytest.mark.parametrize("clip_tau", [None, 0.7])
@pytest.mark.parametrize("n,d", [(10, 100_003), (3, 4097)])
def test_cc_iter_kernel_bounded(cuda, clip_tau, n, d):
    x = _stack(n, d).to(cuda)
    v = x.mean(0) * 0.5
    mask = torch.arange(n, device=cuda) % 3 != 0
    out = magg.masked_cc_iter(x, v, mask, clip_tau=clip_tau)
    ref = magg.masked_cc_iter_plain(x, v, mask, clip_tau)
    torch.testing.assert_close(out, ref, rtol=3e-5, atol=3e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(10, 100_003), (3, 4097), (64, 1000)])
def test_krum_d2_kernel_selection_equal(cuda, n, d):
    from repro_torch.core.aggregation import _krum_scores_from_d2
    x = _stack(n, d).to(cuda)
    d2, ref = magg.masked_krum_d2(x), magg.masked_krum_d2_plain(x)
    # gram form: d2 = |x_i|^2 + |x_j|^2 - 2 x_i.x_j cancels, so the bound
    # scales with the squared norms (the diagonal is ~0 by cancellation)
    sq = (x * x).sum(1)
    bound = 1e-5 * (sq[:, None] + sq[None, :])
    assert bool(((d2 - ref).abs() <= bound).all())
    mask = torch.ones(n, dtype=torch.bool, device=cuda)
    assert int(torch.argmin(_krum_scores_from_d2(d2, mask, 1))) == \
        int(torch.argmin(_krum_scores_from_d2(ref, mask, 1)))


@pytest.mark.cuda
@pytest.mark.parametrize("n,size", [(10, 100_003), (3, 4097)])
def test_decode_accumulate_kernel_bit_equal(cuda, n, size):
    x = _stack(n, size).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    pays = [qdec.wire_encode(x[i], torch.rand((-(-size // 512), 512), generator=g,
                                              device=cuda), levels=64, bucket_size=512)
            for i in range(n)]
    codes = torch.stack([p.codes for p in pays]).reshape(n, -1)
    norms = torch.stack([p.norms for p in pays]).reshape(n, -1)
    w = torch.linspace(0, 1, n, device=cuda)
    out = qdec.decode_accumulate_kernel(codes, norms, w, levels=64, bucket_size=512)
    ref = qdec.decode_accumulate_plain(codes, norms, w, levels=64, bucket_size=512)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert compression.WIRE_CODECS == (None, "qsgd", "topk", "powersgd")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 10, 16, 17])
@pytest.mark.parametrize("levels", [64, 127, 15, 128])
def test_decode_accumulate_kernel_bit_equal_at_every_node_count(cuda, levels, n):
    """Each unrolled node count (1, 10, 16) and the run-time loop (17);
    levels whose float32 1/levels is inexact (127, 15); and, at 128, codes
    over the whole int8 range (the kernel's byte-to-float path at every
    byte).  Negative weights keep sums away from one sign."""
    g = torch.Generator(device=cuda).manual_seed(levels + n)
    length, bucket = 4096 * 3, 256
    lo, hi = (-128, 128) if levels == 128 else (-levels, levels + 1)
    codes = torch.randint(lo, hi, (n, length), generator=g, dtype=torch.int8, device=cuda)
    norms = torch.rand((n, length // bucket), generator=g, device=cuda) * 30
    w = torch.linspace(-0.7, 1.3, n, device=cuda)
    out = qdec.decode_accumulate_kernel(codes, norms, w, levels=levels, bucket_size=bucket)
    ref = qdec.decode_accumulate_plain(codes, norms, w, levels=levels, bucket_size=bucket)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [10, 17])
@pytest.mark.parametrize("bucket", [16, 48, 272, 512])
def test_decode_accumulate_kernel_bit_equal_across_buckets(cuda, bucket, n):
    """The kernel finds a group's bucket by a multiply-high: one group a
    bucket (16), bucket sizes that are not powers of two (48, 272), and the
    wire's 512; an odd count of buckets."""
    g = torch.Generator(device=cuda).manual_seed(bucket + n)
    length = bucket * 37
    codes = torch.randint(-127, 128, (n, length), generator=g, dtype=torch.int8, device=cuda)
    norms = torch.rand((n, 37), generator=g, device=cuda) * 30
    w = torch.linspace(-0.7, 1.3, n, device=cuda)
    out = qdec.decode_accumulate_kernel(codes, norms, w, levels=127, bucket_size=bucket)
    ref = qdec.decode_accumulate_plain(codes, norms, w, levels=127, bucket_size=bucket)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("size,bucket,levels,offset", [
    (7, 128, 16, 0), (1000, 1024, 64, 0), (3 * 5 * 17, 128, 127, 0),
    (100_003, 512, 127, 0), (4099, 512, 64, 1),     # x not 16-byte aligned
    (1000, 1000, 16, 3),                            # a bucket not a multiple of 4
])
def test_qsgd_encode_kernel_code_equal(cuda, size, bucket, levels, offset):
    """The codes equal the plain version's, given the same norms and
    uniforms, at ragged lengths and with signed zeros in x."""
    x = _stack(1, size + offset).to(cuda)[0]
    x[::97] = 0.0
    x[1::89] = -0.0
    x = x[offset:]
    nb = -(-size // bucket)
    g = torch.Generator(device=cuda).manual_seed(size)
    u = torch.rand((nb, bucket), generator=g, device=cuda)
    norms = compression.bucket_norms(compression.pad_buckets(x, bucket)).reshape(-1)
    out = qsgd_ops.qsgd_encode_kernel(x, u, norms, levels=levels, bucket_size=bucket)
    ref = qsgd_ops.qsgd_encode_plain(x, u, norms, levels=levels, bucket_size=bucket)
    assert out.dtype == torch.int8 and torch.equal(out, ref)
    pay = qdec.wire_encode(x, u, levels=levels, bucket_size=bucket)
    assert torch.equal(pay.codes, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("clip_tau", [None, 2.0])
@pytest.mark.parametrize("k,d", [(10, 100_003), (1, 257), (2, 1000), (3, 257), (7, 1000),
                                 (64, 1000)])
def test_cc_iter_kernel_bounded_and_repeatable(cuda, clip_tau, k, d):
    """Within 3e-5 of the plain version, fixed and adaptive τ; two launches
    give the same bits."""
    x = _stack(k, d).to(cuda)
    v = x.mean(0) * 0.5
    out = cc_ops.cc_iter(x, v, clip_tau=clip_tau)
    torch.testing.assert_close(out, cc_ops.cc_iter_plain(x, v, clip_tau), rtol=3e-5,
                               atol=3e-5)
    assert torch.equal(out, cc_ops.cc_iter(x, v, clip_tau=clip_tau))


def _bits_equal(a, b):
    """The same bit patterns (NaN's included), as ``torch.equal`` would say
    if NaN equalled itself."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _chain_stack(cuda, k, d, offset):
    """A (k, d) stack whose base lies ``offset`` floats past an allocation's
    (16-byte aligned) start; contiguous either way."""
    flat = _stack(1, k * d + offset, seed=k + d)[0].to(cuda)
    return flat[offset:].view(k, d)


# (k, d, offset): d not a multiple of 4; a row base not 16-byte aligned;
# n = 64 (one float a thread); the main path's vector layout
CHAIN_CASES = [(10, 100_003, 0), (10, 100_000, 0), (10, 100_000, 1), (3, 4097, 0),
               (64, 1000, 0), (32, 4096, 0), (7, 1024, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("clip_tau", [None, 2.0])
@pytest.mark.parametrize("k,d,offset", CHAIN_CASES)
def test_cc_chain_kernel_equals_its_iterations(cuda, clip_tau, k, d, offset):
    """The chain at iters = 1, 2, 3 is bit-equal to that many ``cc_iter``
    calls, within 3e-5 of the plain loop, and repeats its bits; it counts
    one launch an iteration and takes 16-byte loads where it may."""
    x = _chain_stack(cuda, k, d, offset)
    v0 = x.mean(0) * 0.5
    assert cc_chain.plan_for(x).vec == (4 if d % 4 == 0 and offset == 0 and k <= 32 else 1)
    v, plain = v0, v0
    for iters in (1, 2, 3):
        v = cc_ops.cc_iter(x, v, clip_tau=clip_tau)
        plain = cc_ops.cc_iter_plain(x, plain, clip_tau)
        before = cc_ops.LAUNCHES["cc_iter"]
        chain = cc_ops.cc_chain(x, v0, iters=iters, clip_tau=clip_tau)
        assert cc_ops.LAUNCHES["cc_iter"] == before + iters
        assert _bits_equal(chain, v)
        torch.testing.assert_close(chain, plain, rtol=3e-5, atol=3e-5)
        assert _bits_equal(chain, cc_ops.cc_chain(x, v0, iters=iters, clip_tau=clip_tau))
    assert cc_ops.cc_chain(x, v0, iters=0, clip_tau=clip_tau) is v0


@pytest.mark.cuda
@pytest.mark.parametrize("clip_tau", [None, 2.0])
@pytest.mark.parametrize("mask_kind", ["all", "some", "none"])
@pytest.mark.parametrize("k,d,offset", CHAIN_CASES)
def test_masked_cc_chain_kernel_equals_its_iterations(cuda, clip_tau, mask_kind, k, d, offset):
    """The masked chain as the dense one above; with no row kept and an
    adaptive τ every value is NaN (τ is the median of nothing), on the
    chain, its iterations and the plain loop alike, and the fused
    aggregator's ``any(mask)`` guard then gives zeros."""
    x = _chain_stack(cuda, k, d, offset)
    v0 = x.mean(0) * 0.5
    i = torch.arange(k, device=cuda)
    mask = {"all": i < k, "some": i % 3 != 0, "none": i < 0}[mask_kind]
    v, plain = v0, v0
    for iters in (1, 2, 3):
        v = magg.masked_cc_iter(x, v, mask, clip_tau=clip_tau)
        plain = magg.masked_cc_iter_plain(x, plain, mask, clip_tau)
        before = magg.LAUNCHES["masked_cc_iter"]
        chain = magg.masked_cc_chain(x, v0, mask, iters=iters, clip_tau=clip_tau)
        assert magg.LAUNCHES["masked_cc_iter"] == before + iters
        assert _bits_equal(chain, v)
        torch.testing.assert_close(chain, plain, rtol=3e-5, atol=3e-5, equal_nan=True)
        assert _bits_equal(chain, magg.masked_cc_chain(x, v0, mask, iters=iters,
                                                       clip_tau=clip_tau))
    if mask_kind == "none" and clip_tau is None:
        assert bool(chain.isnan().all())
        fused = magg.masked_centered_clip_fused(x, mask, clip_tau=clip_tau)
        assert _bits_equal(fused, torch.zeros_like(fused))


def _qkv(b, s, hq, hkv, hd, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(shape, generator=g).to(dtype).to(device)
                 for shape in ((b, s, hq, hd), (b, s, hkv, hd), (b, s, hkv, hd)))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,hq,hkv,hd,window", [
    (1, 256, 4, 2, 32, 64),
    (2, 200, 4, 1, 64, 32),          # S not a multiple of the tile
    (1, 300, 8, 2, 80, 17),          # window below a tile
    (1, 333, 4, 4, 128, 100),        # window not a multiple of a tile
    (2, 130, 8, 8, 16, 4096),        # window >= S
    (1, 5, 2, 1, 8, 3),
    # the TMA + wgmma path (bf16, hd 64 / 80, S >= 128): full causal as the
    # zamba2 route calls it (window = S, MHA), a band cut at both edges of
    # its 128-key tiles (GQA), B 2; and S below one of its 128-query tiles
    (1, 1000, 4, 4, 64, 1000),
    (1, 4099, 4, 4, 64, 4099),
    (1, 1000, 8, 2, 80, 300),
    (2, 777, 8, 2, 80, 200),
    (1, 100, 4, 2, 80, 4096),
    # the same path at hd 128 (two 128-byte-swizzled boxes a row): a band
    # both edges of its tiles cut, window = S with MQA and B 2, a ragged
    # triangle past a tile; and S below one tile (the simple path)
    (1, 1000, 8, 2, 128, 300),
    (2, 777, 8, 1, 128, 777),
    (1, 4099, 4, 4, 128, 4099),
    (1, 100, 4, 2, 128, 4096),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swa_kernel_matches_plain_and_repeats_its_bits(cuda, b, s, hq, hkv, hd, window, dtype):
    """Within the reference test's tolerances (2e-4 float32, 2e-2 bfloat16)
    of the plain version; in bfloat16 also within 6e-4 mean row relative L2
    (chip_smoke phase 3's bound, which a bf16 p in place of the kernel's
    fp32 p exceeds); two launches give the same bits."""
    q, k, v = _qkv(b, s, hq, hkv, hd, dtype, cuda)
    wgmma = dtype == torch.bfloat16 and hd in (64, 80, 128) and s >= 128
    assert swa.kernel_path(s, hd, dtype) == swa.PATHS[
        2 if wgmma else 0 if dtype == torch.float32 else 1]
    out = swa.swa_attention_kernel(q, k, v, window=window)
    ref = swa.swa_attention_plain(q, k, v, window=window)
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        o, r = out.float(), ref.float()
        assert float(((o - r).norm(dim=-1) / r.norm(dim=-1)).mean()) <= 6e-4
    again = swa.swa_attention_kernel(q, k, v, window=window)
    assert torch.equal(out.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       again.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))


def _wkv(b, s, h, dk, dtype, device, seed=0, strong=False):
    """r, k, v, w (B, S, H, K) in ``dtype`` and u (H, K) float32; w in
    [0.45, 0.95], or [0.05, 0.95] with ``strong``."""
    g = torch.Generator().manual_seed(seed)
    shape = (b, s, h, dk)
    r, k = (torch.randn(shape, generator=g) * 0.5 for _ in range(2))
    v = torch.randn(shape, generator=g)
    lo = 0.05 if strong else 0.45
    w = lo + (0.95 - lo) * torch.rand(shape, generator=g)
    u = torch.randn((h, dk), generator=g) * 0.1
    return tuple(t.to(dtype).to(device) for t in (r, k, v, w)) + (u.to(device),)


def _rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,dk,strong,with_s0", [
    (1, 64, 2, 64, False, False),
    (2, 37, 3, 32, False, True),     # S not a multiple of the chunk, a non-zero state
    (1, 1, 2, 128, False, True),     # one token
    (1, 200, 2, 16, True, False),    # strong decay
    (1, 1000, 4, 64, True, True),
    (2, 63, 2, 32, False, True),     # the chunk's boundaries: 64 - 1, 64, 64 + 1, 3 * 64 + 5
    (1, 65, 2, 64, True, True),
    (1, 197, 3, 48, True, True),
    (1, 197, 2, 128, False, False),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv_kernel_matches_plain_and_repeats_its_bits(cuda, b, s, h, dk, strong, with_s0,
                                                       dtype):
    """y within 1e-4 relative L2 of the plain version in float32 and
    wkv_ops.BF16_REL in bfloat16, where the bf16-operand control lands beyond
    that bound under strong decay; s_final within 1e-4; two launches give
    the same bits."""
    r, k, v, w, u = _wkv(b, s, h, dk, dtype, cuda, strong=strong)
    s0 = torch.randn((b, h, dk, dk), device=cuda) if with_s0 else None
    y, sf = wkv_ops.wkv_kernel(r, k, v, w, u, s0)
    ry, rs = wkv_ops.wkv_plain(r, k, v, w, u, s0)
    assert y.dtype == dtype and sf.dtype == torch.float32
    assert bool(torch.isfinite(y.float()).all()) and bool(torch.isfinite(sf).all())
    assert _rel(y, ry) <= (1e-4 if dtype == torch.float32 else wkv_ops.BF16_REL)
    assert _rel(sf, rs) <= 1e-4
    if dtype == torch.bfloat16 and strong and s > 100:
        cy, _ = wkv_ops.wkv_plain(r, k, v, w, u, s0, bf16_operands=True)
        assert _rel(cy, ry) > wkv_ops.BF16_REL
    y2, sf2 = wkv_ops.wkv_kernel(r, k, v, w, u, s0)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(y.view(bits), y2.view(bits)) and torch.equal(sf, sf2)


def _ssd(b, s, h, p, n, dtype, device, seed=0, strong=False):
    """x, dt, a, b, c, d_skip: x, b, c in ``dtype``, the rest float32; dt =
    softplus(normal), a = -exp(normal / 2), or with ``strong`` dt near 4 and
    a near -8 (a·Δ about -1,000 over a chunk)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, s, h, p), generator=g)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=g) + (4.0 if strong else 0.0))
    a = -torch.exp(torch.randn((h,), generator=g) * 0.5) * (8.0 if strong else 1.0)
    bb, cc = (torch.randn((b, s, n), generator=g) * 0.5 for _ in range(2))
    d = torch.rand((h,), generator=g)
    return (x.to(dtype).to(device), dt.to(device), a.to(device), bb.to(dtype).to(device),
            cc.to(dtype).to(device), d.to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,n,strong,with_h0", [
    (1, 64, 2, 64, 64, False, False),
    (2, 37, 3, 32, 16, False, True),     # S not a multiple of the chunk, a non-zero state
    (1, 1, 2, 16, 128, False, True),     # one token
    (1, 200, 2, 48, 32, True, False),    # strong decay
    (1, 1040, 4, 64, 64, True, True),
    (2, 63, 9, 64, 64, False, True),     # the chunk's boundaries; 9 heads: a ragged head group
    (1, 65, 3, 80, 48, True, True),      # P above one 64-column slice
    (1, 197, 2, 128, 128, True, True),
    (1, 197, 16, 64, 64, False, False),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_matches_plain_and_repeats_its_bits(cuda, b, s, h, p, n, strong, with_h0,
                                                       dtype):
    """y within 1e-4 relative L2 of the plain version in float32 and
    ssd_ops.BF16_REL in bfloat16, where the bf16-operand control lands beyond
    that bound under strong decay; h_final within 1e-4; two launches give
    the same bits."""
    x, dt, a, bb, cc, d = _ssd(b, s, h, p, n, dtype, cuda, strong=strong)
    h0 = torch.randn((b, h, p, n), device=cuda) if with_h0 else None
    y, hf = ssd_ops.ssd_kernel(x, dt, a, bb, cc, d, h0)
    ry, rh = ssd_ops.ssd_plain(x, dt, a, bb, cc, d, h0)
    assert y.dtype == dtype and hf.dtype == torch.float32
    assert bool(torch.isfinite(y.float()).all()) and bool(torch.isfinite(hf).all())
    assert _rel(y, ry) <= (1e-4 if dtype == torch.float32 else ssd_ops.BF16_REL)
    assert _rel(hf, rh) <= 1e-4
    if dtype == torch.bfloat16 and strong and s > 100:
        cy, _ = ssd_ops.ssd_plain(x, dt, a, bb, cc, d, h0, bf16_operands=True)
        assert _rel(cy, ry) > ssd_ops.BF16_REL
    y2, hf2 = ssd_ops.ssd_kernel(x, dt, a, bb, cc, d, h0)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(y.view(bits), y2.view(bits)) and torch.equal(hf, hf2)


def _card_quadratic(cuda, d, n, rounds):
    """A D-parameter quadratic on the card: ``(loss_fn, data_fn)``."""
    g = torch.Generator().manual_seed(0)
    target = torch.randn(d, generator=g).to(cuda)
    xs = {(i, r): torch.randn((4, d), generator=g).to(cuda)
          for r in range(rounds) for i in range(n)}

    def loss_fn(p, b):
        return torch.mean(torch.square(b["x"] @ (p["w"] - target)))

    return loss_fn, lambda i, r: {"x": xs[i, r]}


def _assert_lane_is_single_run(cuda, out, k, loss_fn, data_fn, nodes, cfg, rounds):
    """Lane ``k`` of a campaign against its roster and config run alone:
    params, contrib and history bit-equal to the single-run Swarm, every
    record field bit-equal to the single-run scan program."""
    state, recs, _ = out
    d = state.params["w"].shape[1]
    sw = tswarm.Swarm(loss_fn, {"w": torch.zeros(d, device=cuda)},
                      SGD(lr=0.1, momentum=0.0), nodes, cfg, data_fn)
    assert sw.fused
    for r in range(rounds):
        sw.step(r)
    assert torch.equal(state.params["w"][k].view(torch.int32),
                       sw.params["w"].view(torch.int32))
    assert torch.equal(state.contrib[k], sw.contrib)
    lane_recs = tswarm.lane_slice(recs, k)
    assert tswarm.history_from_records(lane_recs, [x.node_id for x in nodes]) == sw.history
    round_fn = make_round_fn(loss_fn, SGD(lr=0.1, momentum=0.0), sw.params, len(nodes),
                             aggregator=cfg.aggregator, agg_kwargs=cfg.agg_kwargs)
    run = tswarm.make_scan_program(
        round_fn, lambda r: [data_fn(i, r) for i in range(len(nodes))], rounds)
    params0 = {"w": torch.zeros(d, device=cuda)}
    _, one, _ = run(tswarm.lane_for_nodes(nodes, cfg, cuda),
                    *tswarm.init_state(params0, SGD(lr=0.1, momentum=0.0), len(nodes)))
    for field in tswarm.RoundRecord._fields:
        a, b = getattr(lane_recs, field), getattr(one, field)
        if a is None or b is None:           # a field of an axis not in the run
            assert a is b, field
            continue
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                           b.view(torch.int32) if b.dtype == torch.float32 else b), field


def _card_roster(n):
    return [tswarm.NodeSpec(f"h{i}") for i in range(n - 2)] + [
        tswarm.NodeSpec(f"adv{i}", byzantine="sign_flip", byzantine_scale=10.0)
        for i in range(2)]


@pytest.mark.cuda
def test_campaign_lanes_bit_equal_to_single_run_swarms_on_the_card(cuda):
    """A 3-lane campaign at D = 4,096 on the card (the fused round: the
    CenteredClip lanes through the median and the chain): each lane
    bit-equal to the single-run Swarm of its roster and config."""
    d, n, rounds = 4096, 8, 4
    loss_fn, data_fn = _card_quadratic(cuda, d, n, rounds)
    nodes = _card_roster(n)
    aggs = [("mean", {}), ("centered_clip", {}), ("krum", {"f": 2})]
    cfgs = [tswarm.SwarmConfig(aggregator=name, agg_kwargs=kw, seed=seed)
            for (name, kw), seed in zip(aggs, (0, 1, 2))]
    lanes = tswarm.stack_lanes([tswarm.lane_for_nodes(nodes, c, cuda)._replace(agg_id=k)
                                for k, c in enumerate(cfgs)])
    params0 = {"w": torch.zeros(d, device=cuda)}
    out = tswarm.run_campaign(loss_fn, params0, SGD(lr=0.1, momentum=0.0),
                              data_fn, lanes, rounds=rounds, aggregator=aggs)
    for k, cfg in enumerate(cfgs):
        _assert_lane_is_single_run(cuda, out, k, loss_fn, data_fn, nodes, cfg, rounds)


@pytest.mark.cuda
def test_campaign_mixed_set_runs_the_kernels_on_the_card(cuda):
    """A set that mixes an aggregator without a fused twin (median) with
    CenteredClip: on the card the CenteredClip lane still launches the
    median and the chain every round, as its single-run Swarm does, and
    stays bit-equal to it; the median lane launches nothing."""
    d, n, rounds = 4096, 8, 3
    loss_fn, data_fn = _card_quadratic(cuda, d, n, rounds)
    nodes = _card_roster(n)
    aggs = [("centered_clip", {}), ("median", {})]
    cfgs = [tswarm.SwarmConfig(aggregator=name, seed=seed)
            for (name, _), seed in zip(aggs, (0, 1))]
    lanes = tswarm.stack_lanes([tswarm.lane_for_nodes(nodes, c, cuda)._replace(agg_id=k)
                                for k, c in enumerate(cfgs)])
    params0 = {"w": torch.zeros(d, device=cuda)}
    program = tswarm.make_campaign_program(loss_fn, params0, SGD(lr=0.1, momentum=0.0),
                                           data_fn, lanes, rounds=rounds, aggregator=aggs)
    assert program.fused_by_agg == (True, False) and not program.fused
    sw = tswarm.Swarm(loss_fn, {"w": torch.zeros(d, device=cuda)},
                      SGD(lr=0.1, momentum=0.0), nodes, cfgs[0], data_fn)
    for k in magg.LAUNCHES:
        magg.LAUNCHES[k] = 0
    sw.step(0)
    one_round = dict(magg.LAUNCHES)
    assert one_round["masked_median"] == 1 and one_round["masked_cc_iter"] > 0
    for k in magg.LAUNCHES:
        magg.LAUNCHES[k] = 0
    out = program(lanes)
    assert magg.LAUNCHES == {k: rounds * v for k, v in one_round.items()}
    _assert_lane_is_single_run(cuda, out, 0, loss_fn, data_fn, nodes, cfgs[0], rounds)


@pytest.mark.cuda
def test_decentralized_round_aggregates_with_the_kernels_on_the_card(cuda, monkeypatch):
    """A decentralized CenteredClip round at D = 4,096 and N = 8 on a
    random-regular graph (2 sign-flip attackers): each node's neighbourhood
    aggregate is bit-equal to a lone ``masked_centered_clip_fused`` call
    with its mask and within 3e-5 of the plain version; a round launches
    one median and a chain of 3 a node; the mix and consensus are finite."""
    d, n, rounds = 4096, 8, 2
    loss_fn, data_fn = _card_quadratic(cuda, d, n, rounds)
    seen = []
    fused_cc = magg.FUSED_MASKED_AGGREGATORS["centered_clip"]

    def recording(updates, mask, **kw):
        out = fused_cc(updates, mask, **kw)
        seen.append((updates.clone(), mask.clone(), out.clone(), kw))
        return out

    monkeypatch.setitem(magg.FUSED_MASKED_AGGREGATORS, "centered_clip", recording)
    cfg = tswarm.SwarmConfig(aggregator="centered_clip", topology="random_regular")
    sw = tswarm.Swarm(loss_fn, {"w": torch.zeros(d, device=cuda)}, SGD(lr=0.1, momentum=0.0),
                      _card_roster(n), cfg, data_fn)
    for k in magg.LAUNCHES:
        magg.LAUNCHES[k] = 0
    for r in range(rounds):
        sw.step(r)
    assert magg.LAUNCHES == {"masked_median": n * rounds, "masked_cc_iter": 3 * n * rounds,
                             "masked_krum_d2": 0}
    assert len(seen) == n * rounds and sw.params["w"].shape == (n, d)
    w = sw._lane.mixing
    for j, (x, mask, out, kw) in enumerate(seen):
        assert torch.equal(mask, w[j % n] > 0)          # node j % n's neighbourhood
        lone = magg.masked_centered_clip_fused(x, mask, **kw)
        assert torch.equal(lone.view(torch.int32), out.view(torch.int32)), j
        v = magg.masked_median_plain(x, mask)
        for _ in range(3):
            v = magg.masked_cc_iter_plain(x, v, mask, None)
        assert bool(((out - v).abs() <= 3e-5 + 3e-5 * v.abs()).all()), j
    assert all(np.isfinite(h["consensus_error"]) and h["consensus_error"] > 0
               for h in sw.history)


def _stale_roster(n):
    """``stale_poisoning``'s roster: honest nodes fresh, 2 sign-flip
    attackers that may lag 3 rounds."""
    return [tswarm.NodeSpec(f"h{i}") for i in range(n - 2)] + [
        tswarm.NodeSpec(f"adv{i}", byzantine="sign_flip", byzantine_scale=10.0, delay=3)
        for i in range(2)]


@pytest.mark.cuda
def test_async_round_launches_the_kernels_on_the_card(cuda):
    """An async CenteredClip round (K = 3) at D = 4,096 and N = 8 on the
    card takes the fused median and chain as the synchronous round does:
    one median and 3 iterations a round; the delays are drawn on the host,
    so the card's staleness equals a CPU run's of the same roster; a K = 3
    run whose
    caps are all 0 is bit-equal to the synchronous run."""
    from repro_torch.core.verification import VerificationConfig
    d, n, rounds = 4096, 8, 4
    loss_fn, data_fn = _card_quadratic(cuda, d, n, rounds)
    ver = VerificationConfig(p_check=0.25, stake=10.0, tolerance=1e-3, jackpot=5.0)
    cfg = tswarm.SwarmConfig(aggregator="centered_clip", verification=ver, staleness_bound=3)
    sw = tswarm.Swarm(loss_fn, {"w": torch.zeros(d, device=cuda)}, SGD(lr=0.1, momentum=0.0),
                      _stale_roster(n), cfg, data_fn)
    assert sw.fused
    for k in magg.LAUNCHES:
        magg.LAUNCHES[k] = 0
    for r in range(rounds):
        sw.step(r)
    assert magg.LAUNCHES == {"masked_median": rounds, "masked_cc_iter": 3 * rounds,
                             "masked_krum_d2": 0}
    assert max(h["staleness"] for h in sw.history) > 0
    assert not sw.slashed & {f"h{i}" for i in range(n - 2)}
    # without audits (whose draws come from the device's generator) the
    # active sets match, and so does the staleness
    plain = tswarm.SwarmConfig(aggregator="centered_clip", staleness_bound=3)
    stale = []
    for dev in (cuda, torch.device("cpu")):
        dev_loss, dev_data = _card_quadratic(dev, d, n, rounds)
        one = tswarm.Swarm(dev_loss, {"w": torch.zeros(d, device=dev)},
                           SGD(lr=0.1, momentum=0.0), _stale_roster(n), plain, dev_data)
        for r in range(rounds):
            one.step(r)
        stale.append([h["staleness"] for h in one.history])
    assert stale[0] == stale[1] and max(stale[0]) > 0
    runs = []
    for bound in (0, 3):
        one = tswarm.Swarm(loss_fn, {"w": torch.zeros(d, device=cuda)},
                           SGD(lr=0.1, momentum=0.0), _card_roster(n),
                           tswarm.SwarmConfig(aggregator="centered_clip", staleness_bound=bound),
                           data_fn)
        for r in range(rounds):
            one.step(r)
        runs.append(one)
    assert torch.equal(runs[0].params["w"].view(torch.int32), runs[1].params["w"].view(torch.int32))
    assert runs[0].history == runs[1].history


@pytest.mark.cuda
def test_sequential_async_round_launches_the_dense_kernels_on_the_card(cuda):
    """``SequentialSwarm``'s async path (K = 3) at D = 4,096 on the card:
    the dense CenteredClip over the survivors launches one median warm
    start and 3 ``cc_iter`` a round, and the history equals the batched
    engine's (staleness exactly, agg_norm within 1e-5: the dense aggregator
    over the compacted survivors against the masked one over the stack)."""
    d, n, rounds = 4096, 8, 4
    loss_fn, data_fn = _card_quadratic(cuda, d, n, rounds)
    cfg = tswarm.SwarmConfig(aggregator="centered_clip", staleness_bound=3)
    runs = []
    for engine in ("sequential", "batched"):
        sw = tswarm.make_swarm(loss_fn, {"w": torch.zeros(d, device=cuda)},
                               SGD(lr=0.1, momentum=0.0), _stale_roster(n), cfg, data_fn,
                               engine=engine)
        for counters in (magg.LAUNCHES, cc_ops.LAUNCHES):
            for k in counters:
                counters[k] = 0
        for r in range(rounds):
            sw.step(r)
        runs.append((sw, dict(magg.LAUNCHES), dict(cc_ops.LAUNCHES)))
    (seq, seq_magg, seq_cc), (bat, _, _) = runs
    assert seq_magg["masked_median"] == rounds and seq_cc["cc_iter"] == 3 * rounds
    assert max(h["staleness"] for h in seq.history) > 0
    for hs, hb in zip(seq.history, bat.history):
        assert (hs["n_active"], hs["staleness"]) == (hb["n_active"], hb["staleness"])
        np.testing.assert_allclose(hs["agg_norm"], hb["agg_norm"], rtol=1e-5)


@pytest.mark.cuda
def test_custody_round_launches_the_kernels_on_the_card(cuda):
    """A custody lane on the card changes nothing of the training: the
    CenteredClip rounds launch what the plain ones do and end bit-equal;
    ``coverage`` is 1.0 with every node active, and a campaign's
    reconstruct attack by a partial coalition evaluates exactly the params
    with the shards it lacks zeroed."""
    from repro_torch.core.unextractable import CustodyConfig
    d, n, rounds = 4096, 8, 3
    loss_fn, data_fn = _card_quadratic(cuda, d, n, rounds)
    custody = CustodyConfig(num_shards=16, redundancy=2, max_fraction=0.4,
                            coalition_fraction=0.25)
    runs, launches = [], []
    for c in (None, custody):
        sw = tswarm.Swarm(loss_fn, {"w": torch.zeros(d, device=cuda)},
                          SGD(lr=0.1, momentum=0.0), _card_roster(n),
                          tswarm.SwarmConfig(aggregator="centered_clip", custody=c), data_fn)
        for k in magg.LAUNCHES:
            magg.LAUNCHES[k] = 0
        for r in range(rounds):
            sw.step(r)
        runs.append(sw)
        launches.append(dict(magg.LAUNCHES))
    assert launches[0] == launches[1] and launches[1]["masked_median"] == rounds
    assert torch.equal(runs[0].params["w"].view(torch.int32), runs[1].params["w"].view(torch.int32))
    assert runs[0].history == runs[1].history
    assert all(h["coverage"] == 1.0 for h in runs[1].history)
    cfg = tswarm.SwarmConfig(aggregator="centered_clip", custody=custody)
    lanes = tswarm.stack_lanes([tswarm.lane_for_nodes(_card_roster(n), cfg, cuda)])

    def eval_fn(p):
        return loss_fn(p, data_fn(0, 0))

    state, recs, final = tswarm.run_campaign(
        loss_fn, {"w": torch.zeros(d, device=cuda)}, SGD(lr=0.1, momentum=0.0), data_fn,
        lanes, rounds=rounds, aggregator="centered_clip", eval_fn=eval_fn)
    assert bool((recs.coverage == 1.0).all()) and final.shape == (1, 2)
    covered = unextractable.shards_covered(lanes.custody[0], lanes.coalition[0])
    assert not bool(covered.all())
    params = tswarm.lane_slice(state.params, 0)
    with torch.no_grad():
        want = torch.stack([eval_fn(params), eval_fn(unextractable.masked_reconstruct(
            params, covered))])
    assert torch.equal(final[0].view(torch.int32), want.view(torch.int32))
    assert float(final[0, 1]) != float(final[0, 0])


@pytest.mark.cuda
def test_economy_round_scores_with_the_kernels_on_the_card(cuda, monkeypatch):
    """An adaptive CenteredClip economy lane (``economy_sybil_adaptive``'s
    economy, 4 of 8 nodes an inner-product coalition) at D = 4,096 on the
    card: each round the coalition scores the 4 scales through the median
    and the chain, then the round aggregates through them (5 medians and 15
    iterations a round), each aggregate within 3e-5 of the unfused masked
    CenteredClip on the same stack, relative to the column's largest entry
    beside the value (a column's sums cancel); a fixed lane launches only
    its own round's; the books balance within 1e-4 of the inflow."""
    from repro_torch.core import aggregation
    from repro_torch.core.economy import ADAPTIVE_SCALES, EconomyConfig, conservation_gap
    from repro_torch.core.verification import VerificationConfig
    d, n, rounds = 4096, 8, 3
    loss_fn, data_fn = _card_quadratic(cuda, d, n, rounds)
    nodes = [tswarm.NodeSpec(f"h{i}") for i in range(4)] + [
        tswarm.NodeSpec(f"adv{i}", byzantine="inner_product", byzantine_scale=20.0)
        for i in range(4)]
    fused_cc = magg.FUSED_MASKED_AGGREGATORS["centered_clip"]
    gaps = []

    def recording(updates, mask, **kw):
        out = fused_cc(updates, mask, **kw)
        plain = aggregation.masked_centered_clip(updates, mask, **kw)
        terms = updates.abs().amax(0) + plain.abs()
        gaps.append(float(((out - plain).abs() - 3e-5 * (1.0 + terms)).max()))
        return out

    monkeypatch.setitem(magg.FUSED_MASKED_AGGREGATORS, "centered_clip", recording)
    for adaptive, per_round in ((True, 1 + len(ADAPTIVE_SCALES)), (False, 1)):
        cfg = tswarm.SwarmConfig(
            aggregator="centered_clip",
            verification=VerificationConfig(p_check=0.1, stake=5.0, tolerance=1e-3, jackpot=5.0),
            economy=EconomyConfig(identity_cost=0.1, adaptive=adaptive))
        sw = tswarm.Swarm(loss_fn, {"w": torch.zeros(d, device=cuda)},
                          SGD(lr=0.1, momentum=0.0), nodes, cfg, data_fn)
        assert sw.fused
        for k in magg.LAUNCHES:
            magg.LAUNCHES[k] = 0
        gaps.clear()
        for r in range(rounds):
            sw.step(r)
        assert magg.LAUNCHES == {"masked_median": per_round * rounds,
                                 "masked_cc_iter": 3 * per_round * rounds,
                                 "masked_krum_d2": 0}, adaptive
        assert len(gaps) == per_round * rounds and max(gaps) <= 0.0
        econ = sw._econ_state
        inflow = float(econ.capital_in.sum() + econ.minted + econ.fees_in)
        assert float(conservation_gap(econ)) <= 1e-4 * inflow
        assert 0.0 < sw.history[0]["coalition_stake"] < 1.0
