"""h2o-danube-3-4b [dense]: llama+mistral mix with sliding-window
attention, copied from ``repro.configs.h2o_danube_3_4b``.

[arXiv:2401.16818] 24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab=32000,
    rope_theta=10_000.0,
    max_seq=8192,
    sliding_window=4096,
    source="arXiv:2401.16818",
)
