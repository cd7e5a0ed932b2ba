"""mamba2-1.3b [ssm]: SSD (state-space duality), attention-free, copied
from ``repro.configs.mamba2_1_3b``.

[arXiv:2405.21060] 48L d_model=2048 vocab=50280 ssm_state=128.
d_inner = 2*d_model = 4096, head_dim=64 -> 64 SSD heads per layer.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=64,              # SSD heads (d_inner / head_dim)
    n_kv_heads=64,
    d_ff=0,                  # attention-free, no FFN (mamba block only)
    vocab=50280,
    max_seq=1_048_576,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=128, conv_kernel=4),
    source="arXiv:2405.21060",
)
