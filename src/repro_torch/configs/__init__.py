"""Config registry: ``get_config(arch_id)`` / ``ARCHS``. Holds the archs
this port serves (the encoder-decoder zcode pair, the decoder-only archs
with full attention, those with sliding-window attention, DeepSeek-V3
with multi-head latent attention, the Mamba-2 SSM, the Hymba hybrid, the
llama-3.2-vision VLM and the whisper-small audio encoder-decoder): every
arch of the reference, in its order. ``ASSIGNED_ARCHS`` (the first ten)
and ``applicable_pairs`` are the (arch, input shape) pairs of the dry run
(``launch/dryrun.py``), as in the reference.
"""
from __future__ import annotations

from repro_torch.configs.base import (COMM_SUBSTRATES, INPUT_SHAPES,
                                      CommConfig, EncDecConfig,
                                      GatingDropoutConfig, HybridConfig,
                                      InputShape, MLAConfig, ModelConfig,
                                      MoEConfig, PagedKVConfig, SSMConfig,
                                      Topology, TrainConfig, VLMConfig,
                                      reduced)
from repro_torch.configs.codeqwen1_5_7b import CONFIG as _CODEQWEN
from repro_torch.configs.dbrx_132b import CONFIG as _DBRX
from repro_torch.configs.deepseek_v3_671b import CONFIG as _DEEPSEEK
from repro_torch.configs.h2o_danube_3_4b import CONFIG as _DANUBE
from repro_torch.configs.hymba_1_5b import CONFIG as _HYMBA
from repro_torch.configs.llama_3_2_vision_90b import CONFIG as _LLAMA_VISION
from repro_torch.configs.mamba2_1_3b import CONFIG as _MAMBA2
from repro_torch.configs.starcoder2_3b import CONFIG as _STARCODER2
from repro_torch.configs.whisper_small import CONFIG as _WHISPER
from repro_torch.configs.yi_6b import CONFIG as _YI
from repro_torch.configs.zcode_m3 import CONFIG as _ZCODE_BASE
from repro_torch.configs.zcode_m3 import CONFIG_BIG as _ZCODE_BIG

_REGISTRY = {c.arch_id: c for c in (_LLAMA_VISION, _STARCODER2, _DANUBE, _DBRX,
                                    _YI, _HYMBA, _DEEPSEEK, _CODEQWEN,
                                    _WHISPER, _MAMBA2, _ZCODE_BASE,
                                    _ZCODE_BIG)}

ARCHS = tuple(_REGISTRY)
ASSIGNED_ARCHS = ARCHS[:10]


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


# Which (arch, shape) pairs are applicable. long_500k requires sub-quadratic
# attention (SWA / SSM / hybrid); decode shapes need a decoder.
_LONG_OK = {"starcoder2-3b", "h2o-danube-3-4b", "hymba-1.5b", "mamba2-1.3b"}


def shape_applicable(arch_id: str, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return arch_id in _LONG_OK
    return True


def applicable_pairs():
    for a in ASSIGNED_ARCHS:
        for s in INPUT_SHAPES:
            if shape_applicable(a, s):
                yield a, s


__all__ = ["ARCHS", "ASSIGNED_ARCHS", "COMM_SUBSTRATES", "CommConfig",
           "EncDecConfig", "GatingDropoutConfig", "HybridConfig",
           "INPUT_SHAPES", "InputShape", "MLAConfig", "ModelConfig",
           "MoEConfig", "PagedKVConfig", "SSMConfig", "Topology",
           "TrainConfig", "VLMConfig", "applicable_pairs", "get_config",
           "reduced", "shape_applicable"]
