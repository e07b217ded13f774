"""zamba2-1.2b — hybrid 38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000,
ssm_state=64.  Mamba2 backbone with a shared attention block applied between
groups of mamba layers.

[arXiv:2411.15242]
"""
from repro_torch.configs.base import HYBRID, ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family=HYBRID,
    source="arXiv:2411.15242",
    num_layers=38,            # mamba2 layers
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    ssm_state_size=64,
    ssm_head_dim=64,
    ssm_expand=2,
    mamba_per_group=6,        # shared attn block after every 6 mamba layers
)
