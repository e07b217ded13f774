"""qwen3-moe-30b-a3b — MoE 48L d_model=2048 32H (GQA kv=4) d_ff=768
vocab=151936, 128 experts top-8.

[hf:Qwen/Qwen3-30B-A3B]
"""
from repro_torch.configs.base import MOE, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family=MOE,
    source="hf:Qwen/Qwen3-30B-A3B",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,                 # per-expert ffn dim
    vocab_size=151936,
    num_experts=128,
    experts_per_token=8,
    rope_theta=1e6,
)
