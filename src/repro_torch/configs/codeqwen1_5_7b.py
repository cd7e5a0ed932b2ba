"""codeqwen1.5-7b [dense]: qwen1.5 arch (MHA: kv heads == heads), copied
from ``repro.configs.codeqwen1_5_7b``.

[hf:Qwen/CodeQwen1.5-7B] 32L d_model=4096 32H (kv=32) d_ff=13440 vocab=92416.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab=92416,
    rope_theta=1_000_000.0,
    max_seq=65_536,
    source="hf:Qwen/CodeQwen1.5-7B",
)
