"""hymba-1.5b [hybrid]: parallel attention and Mamba heads in every layer,
copied from ``repro.configs.hymba_1_5b``.

[arXiv:2411.13676] 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16; 128 meta tokens; sliding-window attention except at the
global layers 0, 15 and 31.
"""
from repro_torch.configs.base import HybridConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32001,
    head_dim=64,
    rope_theta=10_000.0,
    max_seq=8192,
    sliding_window=1024,
    ssm=SSMConfig(d_state=16, head_dim=64, expand=2, chunk=64),
    hybrid=HybridConfig(n_meta_tokens=128, global_attn_layers=(0, 15, 31)),
    source="arXiv:2411.13676",
)
