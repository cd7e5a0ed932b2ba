"""whisper-small [audio]: an encoder-decoder whose encoder reads audio
frames, copied from ``repro.configs.whisper_small``.

[arXiv:2212.04356] 12 + 12 layers, d_model=768 12H d_ff=3072 vocab=51865,
layernorm, GELU. The mel spectrogram and the conv feature extractor are a
stub: the batch carries their output, ``frames`` (B, 1500, 768). The
encoder also takes source tokens (``enc_tokens``), as the reference's
``--task mt`` feeds it.
"""
from repro_torch.configs.base import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-small",
    family="encdec",
    n_layers=12,             # decoder layers
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    max_seq=4096,
    norm="layernorm",
    act="gelu",
    gated_mlp=False,
    encdec=EncDecConfig(n_encoder_layers=12, encoder_seq=1500, frontend="stub"),
    source="arXiv:2212.04356",
)
