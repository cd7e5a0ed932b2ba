"""The program's configuration objects built from the benchmark's
configuration file and a cell's system settings, and the weights'
layout (the program's input format: leaf paths and shapes)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

_MODEL_KEYS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
               "vocab", "rope_theta", "max_seq", "norm", "act", "gated_mlp",
               "tie_embeddings", "dtype", "param_dtype", "remat")
_MOE_KEYS = ("n_experts", "top_k", "d_ff_expert", "n_shared_experts", "router_type",
             "capacity_factor", "eval_capacity_factor", "jitter_eps", "balance_coef",
             "router_z_coef", "moe_layer_period", "first_dense_layers")
_TRAIN_KEYS = ("lr", "warmup_steps", "schedule", "b1", "b2", "eps", "weight_decay",
               "grad_clip")


def model_config(cj: Dict[str, Any], system: Dict[str, Any]):
    """The program's ``ModelConfig`` of configuration file ``cj`` under a
    cell's ``system`` settings (MoE backend, comm substrate); every size
    the file states is checked against the result."""
    from repro_torch.configs import get_config
    cfg = get_config(cj["arch"])
    cfg = dataclasses.replace(cfg, **{k: cj[k] for k in _MODEL_KEYS})
    if "encoder" in cj:
        e = cj["encoder"]
        cfg = dataclasses.replace(cfg, encdec=dataclasses.replace(
            cfg.encdec, n_encoder_layers=e["n_layers"], encoder_seq=e["seq"],
            encoder_causal=e["causal"]))
    m = cj["moe"]
    gd = dataclasses.replace(cfg.moe.gating_dropout, **m["gating_dropout"])
    comm = dataclasses.replace(cfg.moe.comm, substrate=system.get("comm", "dense"))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, gating_dropout=gd, comm=comm, backend=system["backend"],
        **{k: m[k] for k in _MOE_KEYS}))
    for k in _MODEL_KEYS:
        if getattr(cfg, k) != cj[k]:
            raise ValueError(f"{k}: {getattr(cfg, k)!r} != {cj[k]!r}")
    return cfg


def train_config(cj: Dict[str, Any], seed: int, steps: int = 1):
    from repro_torch.configs.base import TrainConfig
    return TrainConfig(seed=seed, steps=steps, **{k: cj["train"][k] for k in _TRAIN_KEYS})


def layout(cfg) -> List[Tuple[str, Tuple[int, ...]]]:
    from repro_torch.models.model import init_model_meta
    from repro_torch.tree import flatten_with_paths
    return [(k, tuple(v.shape)) for k, v in flatten_with_paths(init_model_meta(cfg)).items()]


def n_layers_total(cj: Dict[str, Any]) -> int:
    return cj["n_layers"] + cj.get("encoder", {}).get("n_layers", 0)


def tree(flat: Dict[str, Any]):
    """The program's nested parameter tree over the leaves of ``flat``."""
    from repro_torch.tree import unflatten_paths
    return unflatten_paths(dict(flat))


def flat_of(tree) -> Dict[str, Any]:
    from repro_torch.tree import flatten_with_paths
    return flatten_with_paths(tree)
