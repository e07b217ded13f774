"""Model / run configuration for the Protocol Learning framework.

A copy of ``repro.configs.base``: the port imports nothing of the JAX
package, so it keeps its own; keep the two in step.

One ``ModelConfig`` describes any architecture in the assigned pool (dense,
MoE, SSM, hybrid, VLM backbone, audio enc-dec backbone).  Configs are plain
frozen dataclasses — no I/O, no framework imports — so importing a config never
touches device state.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# Architecture families ------------------------------------------------------
DENSE = "dense"          # decoder-only transformer (GQA, optionally SWA)
MOE = "moe"              # decoder-only transformer with MoE FFN
HYBRID = "hybrid"        # Mamba2 blocks + shared attention blocks (zamba2)
SSM = "ssm"              # attention-free recurrent (rwkv6)
VLM = "vlm"              # decoder-only transformer consuming patch embeddings (M-RoPE)
AUDIO = "audio"          # encoder-decoder consuming frame embeddings (seamless)

FAMILIES = (DENSE, MOE, HYBRID, SSM, VLM, AUDIO)


@dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    family: str
    source: str = ""                    # citation for the architecture

    # core transformer dims
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4               # GQA; ==1 is MQA
    head_dim: int = 0                   # 0 -> d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 1000
    tie_embeddings: bool = False

    # attention variants
    sliding_window: Optional[int] = None   # SWA window (tokens); None = full attention
    rope_theta: float = 10_000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE (t, h, w)

    # MoE
    num_experts: int = 0                # 0 = dense FFN
    experts_per_token: int = 0          # top-k
    moe_capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.01

    # SSM / Mamba2 (hybrid + zamba2)
    ssm_state_size: int = 0             # d_state
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    mamba_per_group: int = 6            # zamba2: mamba layers per shared-attn block

    # RWKV6
    rwkv_head_dim: int = 64

    # enc-dec (audio)
    num_encoder_layers: int = 0         # >0 -> encoder-decoder
    encoder_frames: int = 4096          # fixed encoder memory length at decode

    # multimodal stubs
    num_media_tokens: int = 0           # VLM: patch embeddings prepended (train/prefill)

    # normalization / misc
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"             # activations/params compute dtype

    # Kernel compute paths (INFERENCE-ONLY): when set, sliding-window
    # attention of a full sequence, rwkv6's WKV and Mamba2's SSD scan run
    # the CUDA kernels on CUDA tensors and their plain versions on CPU
    # tensors (``kernels/swa_attention/ops.py``, ``kernels/rwkv6_wkv/ops.py``,
    # ``kernels/mamba2_scan/ops.py``).  None has a backward, so the wrappers
    # raise on inputs that require grad; training keeps the flag off and
    # takes ``models.attention._swa``, ``models.rwkv6.wkv_chunked`` and
    # ``models.mamba2.ssd_chunked``.
    use_pallas_kernels: bool = False

    # training
    max_seq_len: int = 4096
    xent_chunk: int = 512               # sequence-chunked cross entropy

    # -- derived -------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_encdec(self) -> bool:
        return self.num_encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return self.family == SSM

    @property
    def supports_long_decode(self) -> bool:
        """True if decode cost/state is sub-quadratic in context length."""
        if self.family in (SSM, HYBRID):
            return True
        return self.sliding_window is not None

    def param_count(self) -> int:
        """Analytic parameter count (matches the model zoo's actual trees)."""
        d, v = self.d_model, self.vocab_size
        hd = self.resolved_head_dim
        n_q, n_kv = self.num_heads, self.num_kv_heads
        emb = v * d * (1 if self.tie_embeddings else 2)

        def attn_params() -> int:
            return d * hd * n_q + 2 * d * hd * n_kv + hd * n_q * d

        def dense_ffn() -> int:
            return 3 * d * self.d_ff          # SwiGLU: gate, up, down

        def moe_ffn() -> int:
            return self.num_experts * 3 * d * self.d_ff + d * self.num_experts

        def mamba_block() -> int:
            d_in = self.ssm_expand * d
            nheads = d_in // self.ssm_head_dim
            in_proj = d * (2 * d_in + 2 * self.ssm_state_size + nheads)
            conv = self.ssm_conv_width * (d_in + 2 * self.ssm_state_size)
            out = d_in * d
            return in_proj + conv + out + 2 * nheads  # + A, D

        def rwkv_block() -> int:
            # time-mix (r,k,v,g,w,o) + lora decay + channel-mix (k,r,v)
            tm = 5 * d * d + d * d            # r,k,v,g,o + w low-rank approx as full
            cm = d * self.d_ff * 2 + self.d_ff * 0 + d * self.d_ff
            return tm + cm

        norms = 2 * d
        if self.family in (DENSE, VLM):
            per_layer = attn_params() + dense_ffn() + norms
            total = emb + self.num_layers * per_layer + d
        elif self.family == MOE:
            per_layer = attn_params() + moe_ffn() + norms
            total = emb + self.num_layers * per_layer + d
        elif self.family == HYBRID:
            n_groups = self.num_layers // self.mamba_per_group
            total = (emb + self.num_layers * (mamba_block() + d)
                     + (attn_params() + dense_ffn() + norms)  # one shared block
                     + n_groups * 0 + d)
        elif self.family == SSM:
            total = emb + self.num_layers * (rwkv_block() + norms) + d
        elif self.family == AUDIO:
            dec = self.num_layers * (2 * attn_params() + dense_ffn() + 3 * d)
            enc = self.num_encoder_layers * (attn_params() + dense_ffn() + norms)
            total = emb + enc + dec + d
        else:
            raise ValueError(self.family)
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if self.family != MOE:
            return self.param_count()
        full = self.param_count()
        ffn_all = self.num_layers * self.num_experts * 3 * self.d_model * self.d_ff
        ffn_active = self.num_layers * self.experts_per_token * 3 * self.d_model * self.d_ff
        return int(full - ffn_all + ffn_active)

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests."""
        small = dict(
            dtype="float32",
            num_layers=2,
            d_model=128,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            max_seq_len=128,
            xent_chunk=64,
            encoder_frames=32,
        )
        if self.num_experts:
            small.update(num_experts=4, experts_per_token=min(2, self.experts_per_token))
        if self.ssm_state_size:
            small.update(ssm_state_size=16, ssm_head_dim=32, mamba_per_group=1)
        if self.family == SSM:
            small.update(rwkv_head_dim=32, d_ff=256)
        if self.num_encoder_layers:
            small.update(num_encoder_layers=2)
        if self.sliding_window:
            small.update(sliding_window=32)
        if self.num_media_tokens:
            small.update(num_media_tokens=8)
        if self.mrope_sections:
            small.update(mrope_sections=(8, 4, 4))  # sums to head_dim//2 = 16
        small.update(overrides)
        return dataclasses.replace(self, **small)


# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input shapes."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
