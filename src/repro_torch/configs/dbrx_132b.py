"""dbrx-132b [moe]: 16 experts, top-4, fine-grained MoE, copied from
``repro.configs.dbrx_132b``.

[hf:databricks/dbrx-base] 40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352, MoE 16e top-4. Gating Dropout applies (first-class).

``fsdp=True`` as in the reference: the sharding rules
(``parallel/sharding.py``) shard its dense weights over the data axis of
the production mesh, which the meta-device dry run (``launch/dryrun.py``)
reads; a live run changes no number or layout for it. At 131.6 B
parameters (526 GB in f32) the 40-layer model fits no single H100: the
card runs it with its depth cut.
"""
from repro_torch.configs.base import GatingDropoutConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab=100352,
    rope_theta=500_000.0,
    max_seq=32_768,
    norm="layernorm",
    fsdp=True,
    moe=MoEConfig(
        n_experts=16,
        top_k=4,
        d_ff_expert=10752,
        router_type="softmax",
        capacity_factor=1.25,
        moe_layer_period=1,
        gating_dropout=GatingDropoutConfig(mode="gate_drop", rate=0.3),
    ),
    source="hf:databricks/dbrx-base",
)
