"""Config dataclasses of the port (the subset of ``repro.configs.base`` the
encoder-decoder MoE and its audio variant, the decoder-only families with
full or sliding-window attention or multi-head latent attention (MLA),
the Mamba-2 SSM family, the Hymba hybrid and the VLM with gated
cross-attention need, the communication substrate, ``PagedKVConfig``
and ``TrainConfig``).

Plain frozen dataclasses, field for field the reference's defaults, so a
config built here describes the same model as the reference's.
``MoEConfig.ep_on_model`` picks the experts' layout on a ``--mesh d,m``
group with m > 1 (``core/moe.py``): tensor parallelism inside the experts
(False, the paper's footnote 1) or whole experts over data x model. The
reference's other layout fields, ``ModelConfig.fsdp`` and
``seq_parallel``, are read by the sharding rules of the meta-device dry
run (``parallel/sharding.py``, ``launch/dryrun.py``) alone: on a live run
they change no number and no layout, as in the reference, whose trainer
and server build no sharding from them. ``InputShape`` and
``INPUT_SHAPES`` are the reference's four production input shapes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

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
    # on a model axis m > 1: experts over data x model, each whole on one
    # rank, the layer's tokens split along the sequence over model (needs
    # E % (d*m) == 0 and L % m == 0); False slices every expert's d_ff
    # over model (tensor parallelism)
    ep_on_model: bool = False
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
class MLAConfig:
    """DeepSeek-V3 multi-head latent attention: queries through a rank
    ``q_lora_rank`` bottleneck, keys and values from one shared latent of
    ``kv_lora_rank`` plus a decoupled RoPE key of ``qk_rope_head_dim``."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD (state-space duality): ``d_inner = expand * d_model``
    split into heads of ``head_dim``, a state of ``d_state`` per head,
    B/C shared over ``n_groups`` groups of heads, the scan in chunks of
    ``chunk`` positions after a causal conv of ``conv_kernel`` taps."""
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk: int = 64
    conv_kernel: int = 4
    n_groups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class HybridConfig:
    """Hymba: attention and SSM heads side by side in every layer, the
    attention windowed except at ``global_attn_layers``, and
    ``n_meta_tokens`` learned tokens prepended to every sequence."""
    n_meta_tokens: int = 128
    global_attn_layers: Tuple[int, ...] = (0, 15, 31)


@dataclass(frozen=True)
class VLMConfig:
    """Llama-3.2-Vision: a tanh-gated cross-attention layer every
    ``cross_attn_period`` layers onto ``n_image_tokens`` image embeddings
    of width ``d_image`` (a stub vision encoder's output), projected to
    ``d_model``."""
    cross_attn_period: int = 5
    n_image_tokens: int = 1601
    d_image: int = 1280


@dataclass(frozen=True)
class EncDecConfig:
    """The encoder of an encoder-decoder: ``frontend`` "stub" takes audio
    frames (whisper's conv frontend stubbed: the batch carries ``frames``
    (B, encoder_seq, d_model)), "tokens" source tokens (``enc_tokens``)."""
    n_encoder_layers: int = 12
    encoder_seq: int = 1500
    frontend: str = "stub"              # stub (frames) | tokens
    encoder_causal: bool = False


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str = "tiny"
    family: str = "dense"               # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab: int = 1024
    head_dim: int = 0                   # 0 -> d_model // n_heads
    rope_theta: float = 10_000.0
    max_seq: int = 8192
    sliding_window: int = 0             # 0 = full attention
    norm: str = "rmsnorm"               # rmsnorm | layernorm
    act: str = "silu"                   # silu | gelu (tanh approximation)
    gated_mlp: bool = True
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    vlm: Optional[VLMConfig] = None
    encdec: Optional[EncDecConfig] = None
    hybrid: Optional[HybridConfig] = None
    mtp: bool = False                   # DeepSeek-V3 multi-token-prediction head
    dtype: str = "bfloat16"             # activation dtype
    param_dtype: str = "float32"
    remat: bool = True                  # recompute each layer in the backward
    fsdp: bool = False                  # shard weights over data axis too
    seq_parallel: bool = False          # shard layer-boundary activations
                                        # (sequence dim) over the model axis
                                        # (both read by the dry run's
                                        # sharding rules alone; a live run
                                        # changes no number or layout)
    banded_swa: bool = False            # sliding-window attention with block
                                        # skipping: O(L*W) instead of masked
                                        # O(L^2)
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

    def _attn_params(self) -> int:
        d, h = self.d_model, self.n_heads
        if self.mla is not None:
            m = self.mla
            return (d * m.q_lora_rank
                    + m.q_lora_rank * h * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                    + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    + m.kv_lora_rank * h * (m.qk_nope_head_dim + m.v_head_dim)
                    + h * m.v_head_dim * d)
        if self.ssm is not None and self.family == "ssm":
            s = self.ssm
            di = s.d_inner(d)
            return d * (2 * di + 2 * s.n_groups * s.d_state + di // s.head_dim) + di * d
        hd = self.head_dim_
        return d * hd * (h + 2 * self.n_kv_heads) + h * hd * d

    @property
    def n_meta(self) -> int:
        """Meta tokens prepended to every sequence (the hybrid's), 0 else."""
        return self.hybrid.n_meta_tokens if self.hybrid is not None else 0

    def n_params(self) -> int:
        """Analytic parameter count (embeddings + blocks), as the
        reference counts it (norm scales and biases are not counted, nor
        the MTP head, nor the conv, ``dt_bias``, ``A_log`` and ``D`` of an
        SSM; the mixer of ``family == "ssm"`` is its SSM, while a hybrid
        layer counts its attention alone, the reference's undercount; a
        VLM's gated cross-attention layer counts as a GQA self-attention
        layer, where the init holds four d x d projections, and
        ``img_proj`` is left out, the reference's undercount again:
        llama-3.2-vision-90b counts 87.665 B against the 90.024 B of its
        init's weight matrices, 20 x 2 x d x (d - kv x hd) + d_image x d
        more)."""
        d = self.d_model
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        attn = self._attn_params()
        total += sum(attn + self._ffn_params(i) for i in range(self.n_layers))
        if self.encdec is not None:
            total += sum(4 * d * d + self._ffn_params(i)
                         for i in range(self.encdec.n_encoder_layers))
            total += self.n_layers * 4 * d * d          # decoder cross-attention
        return total

    def n_active_params(self) -> int:
        """Parameters a token runs through (its top-k experts and the
        shared ones in place of every expert), as the reference counts
        them: the encoder's MoE layers keep every expert."""
        if self.moe is None:
            return self.n_params()
        mult = 3 if self.gated_mlp else 2
        per_expert = mult * self.d_model * self.moe.d_ff(self.d_ff)
        idle = (self.moe.n_experts - self.moe.top_k - self.moe.n_shared_experts)
        n_moe = sum(1 for i in range(self.n_layers) if self.moe.is_moe_layer(i))
        return self.n_params() - n_moe * idle * per_expert


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
        fsdp=False,
        param_dtype="float32",
        dtype="float32",
    )
    n_heads = min(cfg.n_heads, 4)
    kw["n_heads"] = n_heads
    kw["n_kv_heads"] = max(1, min(cfg.n_kv_heads, n_heads))
    while n_heads % kw["n_kv_heads"] != 0:
        kw["n_kv_heads"] -= 1
    kw["head_dim"] = kw["d_model"] // n_heads
    if cfg.sliding_window:
        kw["sliding_window"] = 128
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=min(cfg.moe.d_ff(cfg.d_ff), 256),
            n_shared_experts=min(cfg.moe.n_shared_experts, 1),
            first_dense_layers=min(cfg.moe.first_dense_layers, 1))
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                              qk_nope_head_dim=32, qk_rope_head_dim=16,
                              v_head_dim=32)
        kw["head_dim"] = 0
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=32, chunk=16)
    if cfg.vlm is not None:
        kw["vlm"] = VLMConfig(cross_attn_period=2, n_image_tokens=16, d_image=64)
    if cfg.encdec is not None:
        kw["encdec"] = dataclasses.replace(cfg.encdec, n_encoder_layers=2,
                                           encoder_seq=32)
    if cfg.hybrid is not None:
        kw["hybrid"] = HybridConfig(n_meta_tokens=4, global_attn_layers=(0,))
        kw["ssm"] = SSMConfig(d_state=16, head_dim=32, expand=2, chunk=16)
    kw.update(overrides)
    return dataclasses.replace(cfg, **kw)


# ---------------------------------------------------------------------------
# input shapes (the reference's four production shapes)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                            # train | prefill | decode


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",   524_288, 1,   "decode"),
}


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
