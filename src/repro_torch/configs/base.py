"""Config dataclasses of the port (the subset of ``repro.configs.base`` the
encoder-decoder MoE needs, and ``TrainConfig``).

Plain frozen dataclasses, field for field the reference's defaults, so a
config built here describes the same model as the reference's. The
reference's communication substrate (``CommConfig``), parallel layouts and
the MLA/SSM/VLM/hybrid families arrive with their slices.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import torch

MOE_BACKENDS = ("auto", "oracle", "cuda", "cuda_fused")


@dataclass(frozen=True)
class GatingDropoutConfig:
    """Gating Dropout (Liu et al., ICML 2022).

    mode: "off" | "gate_drop" (route within the local expert group with
    probability ``rate``) | "gate_expert_drop" (skip the MoE sub-layer).
    local_combine: "prob" (renormalised local softmax weight) | "one".
    The reference's ``strategy`` (traced or host branch) has no port
    counterpart: eager PyTorch takes the decision as a host bool.
    """
    mode: str = "off"
    rate: float = 0.0
    local_combine: str = "prob"

    def __post_init__(self):
        if self.mode not in ("off", "gate_drop", "gate_expert_drop"):
            raise ValueError(f"gating_dropout.mode {self.mode!r}")
        if self.local_combine not in ("prob", "one"):
            raise ValueError(f"local_combine {self.local_combine!r}")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate {self.rate}")

    @property
    def enabled(self) -> bool:
        return self.mode != "off" and self.rate > 0.0


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 1
    d_ff_expert: int = 0                # 0 -> use model d_ff
    n_shared_experts: int = 0
    router_type: str = "softmax"        # softmax | sigmoid | hash
    capacity_factor: float = 1.0        # train
    eval_capacity_factor: float = 2.0
    jitter_eps: float = 0.01
    balance_coef: float = 0.01
    router_z_coef: float = 0.0
    moe_layer_period: int = 1
    first_dense_layers: int = 0
    # execution backend (core/backend.py): auto | oracle | cuda | cuda_fused
    backend: str = "auto"
    gating_dropout: GatingDropoutConfig = field(
        default_factory=GatingDropoutConfig)

    def __post_init__(self):
        if self.backend not in MOE_BACKENDS:
            raise ValueError(f"moe.backend {self.backend!r}; "
                             f"known: {MOE_BACKENDS}")

    def d_ff(self, model_d_ff: int) -> int:
        return self.d_ff_expert or model_d_ff

    def is_moe_layer(self, layer_idx: int) -> bool:
        if layer_idx < self.first_dense_layers:
            return False
        return (layer_idx - self.first_dense_layers) % self.moe_layer_period == 0


@dataclass(frozen=True)
class EncDecConfig:
    n_encoder_layers: int = 12
    encoder_seq: int = 1500
    frontend: str = "stub"              # stub (frames) | tokens
    encoder_causal: bool = False


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str = "tiny"
    family: str = "encdec"              # the only family ported so far
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab: int = 1024
    head_dim: int = 0                   # 0 -> d_model // n_heads
    rope_theta: float = 10_000.0
    max_seq: int = 8192
    norm: str = "rmsnorm"               # rmsnorm | layernorm
    act: str = "silu"                   # silu | gelu (tanh approximation)
    gated_mlp: bool = True
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    encdec: Optional[EncDecConfig] = None
    dtype: str = "bfloat16"             # activation dtype
    param_dtype: str = "float32"
    remat: bool = True                  # recompute each layer in the backward
    source: str = ""

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def torch_param_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def _ffn_params(self, layer_idx: int) -> int:
        d, dff = self.d_model, self.d_ff
        mult = 3 if self.gated_mlp else 2
        if self.moe is not None and self.moe.is_moe_layer(layer_idx):
            n = self.moe.n_experts + self.moe.n_shared_experts
            return n * mult * d * self.moe.d_ff(dff) + self.moe.n_experts * d
        return mult * d * dff

    def n_params(self) -> int:
        """Analytic parameter count (embeddings + blocks), as the
        reference counts it (norm scales and biases are not counted)."""
        d = self.d_model
        hd = self.head_dim_
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        total += sum(attn + self._ffn_params(i) for i in range(self.n_layers))
        if self.encdec is not None:
            total += sum(4 * d * d + self._ffn_params(i)
                         for i in range(self.encdec.n_encoder_layers))
            total += self.n_layers * 4 * d * d          # decoder cross-attention
        return total


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A smoke-test-sized variant of the same family (<=2 layers, d<=256,
    <=4 experts), with the reference's cuts."""
    kw = dict(
        n_layers=2,
        d_model=min(cfg.d_model, 256),
        d_ff=min(cfg.d_ff, 512) or 512,
        vocab=min(cfg.vocab, 512),
        max_seq=512,
        remat=False,
        param_dtype="float32",
        dtype="float32",
    )
    n_heads = min(cfg.n_heads, 4)
    kw["n_heads"] = n_heads
    kw["n_kv_heads"] = max(1, min(cfg.n_kv_heads, n_heads))
    while n_heads % kw["n_kv_heads"] != 0:
        kw["n_kv_heads"] -= 1
    kw["head_dim"] = kw["d_model"] // n_heads
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=min(cfg.moe.d_ff(cfg.d_ff), 256),
            n_shared_experts=min(cfg.moe.n_shared_experts, 1),
            first_dense_layers=min(cfg.moe.first_dense_layers, 1))
    if cfg.encdec is not None:
        kw["encdec"] = dataclasses.replace(cfg.encdec, n_encoder_layers=2,
                                           encoder_seq=32)
    kw.update(overrides)
    return dataclasses.replace(cfg, **kw)


@dataclass(frozen=True)
class TrainConfig:
    """Optimizer and training-run settings, field for field the
    reference's. ``metrics_frame`` adds the router-health metrics
    (expert_load, router_entropy, gate_dropped) to every step's metrics;
    it changes no loss or update."""
    lr: float = 3e-4
    warmup_steps: int = 5000
    schedule: str = "inverse_sqrt"       # inverse_sqrt | cosine | constant
    b1: float = 0.9
    b2: float = 0.99                     # paper: beta2 = 0.99
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    seed: int = 0
    steps: int = 1000
    microbatches: int = 1                # grad accumulation: activation mem /k
    moment_dtype: str = "float32"        # bfloat16 for the huge archs
    loss: str = "xent"                   # xent | xent+dae (paper Web-50)
    dae_coef: float = 1.0
    metrics_frame: bool = True

    def __post_init__(self):
        if self.schedule not in ("inverse_sqrt", "cosine", "constant"):
            raise ValueError(f"schedule {self.schedule!r}")
        if self.microbatches < 1:
            raise ValueError(f"microbatches {self.microbatches}")
