"""llama-3.2-vision-90b [vlm]: a tanh-gated cross-attention layer every
fifth layer onto stub image embeddings, copied from
``repro.configs.llama_3_2_vision_90b``.

[hf:meta-llama/Llama-3.2-11B-Vision] scaled to 90B: 100L d_model=8192
64H (GQA kv=8) d_ff=28672 vocab=128256. The vision encoder is a stub: the
batch carries its output, ``img_embeds`` (B, 1601, 1280). ``fsdp=True``
as in the reference: read by the sharding rules of the dry run
(``parallel/sharding.py``), changing nothing on a live run.
"""
from repro_torch.configs.base import ModelConfig, VLMConfig

CONFIG = ModelConfig(
    arch_id="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    rope_theta=500_000.0,
    max_seq=131_072,
    fsdp=True,
    vlm=VLMConfig(cross_attn_period=5, n_image_tokens=1601, d_image=1280),
    source="hf:meta-llama/Llama-3.2-11B-Vision (90B scale per assignment)",
)
