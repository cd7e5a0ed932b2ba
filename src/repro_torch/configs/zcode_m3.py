"""The paper's own architectures (Kim et al. 2021 Z-code M3 baselines),
copied from ``repro.configs.zcode_m3``.

zcode-m3-base: Transformer-base MoE for WMT-10 — 12 enc + 6 dec layers,
d=512, 8H, d_ff=2048, 128 experts at every other FFN (2.53 B parameters).

zcode-m3-big: Transformer-big MoE for Web-50 — 24 enc + 12 dec layers,
d=1024, 16H, d_ff=4096, 64 experts.

Both use top-1 (Switch) routing, capacity 1.0 train / 2.0 eval, input
jitter, balance coeff 0.01 — the paper's §4.1 settings.
"""
from repro_torch.configs.base import (EncDecConfig, GatingDropoutConfig,
                                      ModelConfig, MoEConfig)


def _moe(n_experts: int, gd_mode: str = "off", rate: float = 0.0) -> MoEConfig:
    return MoEConfig(
        n_experts=n_experts,
        top_k=1,
        router_type="softmax",
        capacity_factor=1.0,
        eval_capacity_factor=2.0,
        jitter_eps=0.01,
        balance_coef=0.01,
        moe_layer_period=2,          # every other FFN sub-layer (Fedus et al.)
        gating_dropout=GatingDropoutConfig(mode=gd_mode, rate=rate),
    )


CONFIG = ModelConfig(                 # zcode-m3-base (WMT-10)
    arch_id="zcode-m3-base",
    family="encdec",
    n_layers=6,                       # decoder layers
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=64_000,
    max_seq=1024,
    norm="layernorm",
    act="gelu",
    gated_mlp=False,
    encdec=EncDecConfig(n_encoder_layers=12, encoder_seq=1024, frontend="tokens"),
    moe=_moe(128, "gate_drop", 0.3),
    source="Kim et al. 2021 (arXiv:2109.10465) / Liu et al. 2022 §4.1",
)

CONFIG_BIG = ModelConfig(             # zcode-m3-big (Web-50)
    arch_id="zcode-m3-big",
    family="encdec",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=128_000,
    max_seq=1024,
    norm="layernorm",
    act="gelu",
    gated_mlp=False,
    encdec=EncDecConfig(n_encoder_layers=24, encoder_seq=1024, frontend="tokens"),
    moe=_moe(64, "gate_drop", 0.3),
    source="Kim et al. 2021 (arXiv:2109.10465) / Liu et al. 2022 §4.1",
)
