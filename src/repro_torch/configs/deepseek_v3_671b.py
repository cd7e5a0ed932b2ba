"""deepseek-v3-671b [moe]: multi-head latent attention, 1 shared + 256
routed experts top-8 with a sigmoid router, multi-token prediction;
copied from ``repro.configs.deepseek_v3_671b``.

[arXiv:2412.19437] 61L d_model=7168 128H d_ff=2048(expert) vocab=129280,
MoE 256e top-8, first 3 layers dense (dense d_ff=18432), sigmoid router.
Gating Dropout applies (first-class): the shared expert is local by
construction and never dropped; on a dropped step the routed top-8 is
restricted to the local group.

``n_kv_heads=128`` is unused under MLA (keys and values are decompressed
per head from the shared latent), and ``head_dim_`` (d / H = 56) is not
any of MLA's head widths: the MLA layers read ``mla`` alone.

``fsdp=True`` as in the reference and as for dbrx-132b: read by the
sharding rules of the dry run, changing nothing on a live run. At 671 B
parameters the 61-layer model fits no single H100: the card runs it with
its depth cut.
"""
from repro_torch.configs.base import (GatingDropoutConfig, MLAConfig,
                                      ModelConfig, MoEConfig)

CONFIG = ModelConfig(
    arch_id="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,           # MLA: kv heads == heads post-decompression
    d_ff=18432,               # dense layers' FFN width
    vocab=129280,
    rope_theta=10_000.0,
    max_seq=131_072,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(
        n_experts=256,
        top_k=8,
        d_ff_expert=2048,
        n_shared_experts=1,
        router_type="sigmoid",
        capacity_factor=1.25,
        moe_layer_period=1,
        first_dense_layers=3,
        gating_dropout=GatingDropoutConfig(mode="gate_drop", rate=0.3),
    ),
    mtp=True,
    fsdp=True,
    dtype="bfloat16",
    source="arXiv:2412.19437",
)
