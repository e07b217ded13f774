"""qwen2-vl-2b — VLM backbone 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936, M-RoPE (t/h/w sections), dynamic-resolution vision frontend
STUBBED per the assignment (input_specs provides patch embeddings).

[arXiv:2409.12191]
"""
from repro_torch.configs.base import VLM, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family=VLM,
    source="arXiv:2409.12191",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    mrope_sections=(16, 24, 24),   # sums to head_dim // 2 = 64
    num_media_tokens=256,
    rope_theta=1e6,
)
