"""rwkv6-1.6b (Finch) — attention-free 24L d_model=2048 d_ff=7168 vocab=65536,
data-dependent decay WKV recurrence.

[arXiv:2404.05892]
"""
from repro_torch.configs.base import SSM, ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family=SSM,
    source="arXiv:2404.05892",
    num_layers=24,
    d_model=2048,
    num_heads=32,             # wkv heads = d_model // rwkv_head_dim
    num_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    rwkv_head_dim=64,
)
