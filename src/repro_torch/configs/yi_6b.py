"""yi-6b [dense]: llama-arch GQA, copied from ``repro.configs.yi_6b``.

[arXiv:2403.04652] 32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab=64000,
    rope_theta=5_000_000.0,
    max_seq=4096,
    source="arXiv:2403.04652",
)
