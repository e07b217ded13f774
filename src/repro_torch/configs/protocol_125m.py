"""protocol-125m — the paper's own end-to-end demonstrator: a ~125M dense
model trained across a simulated incentivized swarm (``launch/swarm.py``).
162,417,408 parameters at full width.
"""
from repro_torch.configs.base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="protocol-125m",
    family=DENSE,
    source="this paper (Protocol Learning demonstrator)",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=32000,
    max_seq_len=1024,
)
