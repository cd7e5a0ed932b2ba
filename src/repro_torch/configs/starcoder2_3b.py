"""starcoder2-3b [dense]: GQA, RoPE, sliding-window attention (4096),
copied from ``repro.configs.starcoder2_3b``.

[arXiv:2402.19173] 30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab=49152,
    rope_theta=999_999.0,
    max_seq=16_384,
    sliding_window=4096,
    norm="layernorm",
    act="gelu",
    gated_mlp=False,
    source="arXiv:2402.19173",
)
