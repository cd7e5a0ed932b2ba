"""Config dataclasses of the port (the subset of ``repro.configs.base`` the
encoder-decoder MoE needs, the communication substrate, ``PagedKVConfig``
and ``TrainConfig``).

Plain frozen dataclasses, field for field the reference's defaults, so a
config built here describes the same model as the reference's. The
reference's MLA/SSM/VLM/hybrid families are not ported.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import torch

MOE_BACKENDS = ("auto", "oracle", "sharded", "cuda", "cuda_fused")


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


# ---------------------------------------------------------------------------
# communication substrate (comm/substrate.py)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Topology:
    """Two-tier interconnect descriptor: the hierarchical substrate's
    ep_inner / ep_outer tiers mapped onto link classes, so the cost model
    can price a two-tier group. ``intra_gbps`` is the intra-tier
    (NVLink-class) per-device bandwidth in GB/s, ``inter_gbps`` the
    inter-tier (network-class) one. Flat substrates span every tier, so
    all their wire is priced at ``inter_gbps``."""
    intra_gbps: float = 400.0
    inter_gbps: float = 50.0

    def __post_init__(self):
        if not (self.intra_gbps > 0 and self.inter_gbps > 0):
            raise ValueError(f"bandwidths {self.intra_gbps}, {self.inter_gbps}")

    @property
    def intra_bps(self) -> float:
        return self.intra_gbps * 1e9

    @property
    def inter_bps(self) -> float:
        return self.inter_gbps * 1e9


COMM_SUBSTRATES = (
    "dense", "hierarchical", "compressed", "hierarchical_compressed",
    "overlapped", "overlapped_hierarchical", "overlapped_compressed",
    "overlapped_hierarchical_compressed")


@dataclass(frozen=True)
class CommConfig:
    """Collective-communication substrate of the MoE dispatch and combine
    all-to-alls (the ``comm/substrate.py`` registry).

    substrate:
      "dense"                   -- one all-to-all over the whole ep group.
      "hierarchical"            -- two hops over ep = ep_inner x ep_outer:
                                   intra-tier, then inter-tier; the same
                                   permutation as dense, bitwise.
      "compressed"              -- dense topology, payload quantized to
                                   ``quant`` with one f32 scale per row;
                                   the backward wire is compressed too
                                   (straight-through rounding).
      "hierarchical_compressed" -- both.
      "overlapped[...]"         -- any of the above, split into
                                   ``n_chunks`` pieces along the capacity
                                   axis, the next piece's dispatch issued
                                   before the current piece's expert FFN;
                                   bitwise its base substrate.
    quant: wire dtype of compressed substrates: "int8" | "fp8" (e4m3).
    ep_inner: intra-tier group size of hierarchical substrates (divides
      ep); 0 = the largest divisor <= sqrt(ep).
    n_chunks: requested micro-chunks of overlapped substrates (the count
      run is the largest divisor of the capacity <= n_chunks).
    topology: bandwidths the cost model prices the wire with (estimates
      only; never changes numerics).
    """
    substrate: str = "dense"
    quant: str = "int8"
    ep_inner: int = 0
    n_chunks: int = 4
    topology: Topology = field(default_factory=Topology)

    def __post_init__(self):
        if self.substrate not in COMM_SUBSTRATES:
            raise ValueError(f"comm substrate {self.substrate!r}; "
                             f"known: {COMM_SUBSTRATES}")
        if self.quant not in ("int8", "fp8"):
            raise ValueError(f"comm quant {self.quant!r}")
        if self.ep_inner < 0:
            raise ValueError(f"ep_inner {self.ep_inner}")
        if self.n_chunks < 1:
            raise ValueError(f"n_chunks {self.n_chunks}")

    @property
    def overlapped(self) -> bool:
        return self.substrate.startswith("overlapped")

    @property
    def hierarchical(self) -> bool:
        return "hierarchical" in self.substrate

    @property
    def compressed(self) -> bool:
        return self.substrate.endswith("compressed")


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
    # execution backend (core/backend.py):
    #   auto | oracle | sharded | cuda | cuda_fused
    backend: str = "auto"
    # substrate of the dispatch and combine all-to-alls (comm/substrate.py)
    comm: CommConfig = field(default_factory=CommConfig)
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
class PagedKVConfig:
    """Block-table-addressed decode cache (vLLM-style page pool), field for
    field the reference's.

    ``page_size`` logical positions per physical page. ``n_pages`` is the
    usable arena size (one extra scratch page is always appended); 0
    derives it from the slot pool it replaces: ``n_slots_equiv *
    ceil(seq_len / page_size)``, equal paged KV bytes to an
    ``n_slots_equiv``-row slot pool. ``prefix_caching`` shares full
    prompt-prefix pages across requests via a token-hash page cache;
    ``reserve_pages`` is the admission headroom (a request is admitted
    only when its prompt pages + this reserve are free or evictable)."""
    page_size: int = 16
    n_pages: int = 0
    n_slots_equiv: int = 8
    prefix_caching: bool = True
    reserve_pages: int = 1

    def __post_init__(self):
        if self.page_size < 1:
            raise ValueError(f"page_size {self.page_size}")
        if self.reserve_pages < 0:
            raise ValueError(f"reserve_pages {self.reserve_pages}")


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
