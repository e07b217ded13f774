"""granite-20b — dense 52L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152,
llama-architecture code model.

[arXiv:2405.04324]
"""
from repro_torch.configs.base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family=DENSE,
    source="arXiv:2405.04324",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,           # MQA
    d_ff=24576,
    vocab_size=49152,
)
