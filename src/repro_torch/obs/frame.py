"""Typed host view over the router/comm MetricsFrame (port of
``repro/obs/frame.py``).

The frame's values are computed on the device: every train step's
metrics carry the per-step router-health values (built in the MoE aux
path, ``core/moe.py``, and surfaced by ``training/steps.py::total_loss``
when ``TrainConfig.metrics_frame`` is on) beside the ``comm_*`` wire
counters. The Trainer stacks a chunk's steps on a leading K axis and
fetches them in its one device-to-host read per chunk, so the frame adds
no host sync.

This module is the HOST half: numpy-only typing and summary math over
the fetched arrays (no torch import: building a frame never touches a
device).

Frame schema (per step; E = n_experts):
    expert_load        (E,)  mean per-expert routed load, layer-averaged
                             (sums to top_k on fully-routed steps)
    router_entropy     ()    mean per-token routing entropy, nats
    dropped_frac       ()    capacity-dropped fraction of dispatch slots
    gate_dropped       ()    the step's Gating-Dropout consensus bit
    comm_a2a_calls     ()    all-to-all ops this step's forward launched
    comm_bytes         ()    payload bytes entering the wire
    comm_wire_bytes    ()    per-device bytes actually on the wire
    comm_exposed_bytes ()    wire NOT hidden behind expert compute
    comm_hidden_bytes  ()    wire pipelined behind expert compute
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = ["FRAME_KEYS", "MetricsFrame", "load_imbalance", "router_health"]

FRAME_KEYS = ("expert_load", "router_entropy", "dropped_frac",
              "gate_dropped", "comm_a2a_calls", "comm_bytes",
              "comm_wire_bytes", "comm_exposed_bytes", "comm_hidden_bytes")


def load_imbalance(load: np.ndarray) -> np.ndarray:
    """max/mean over the expert axis of a (..., E) load histogram — 1.0
    is perfect balance, E is total collapse onto one expert. Steps that
    routed nothing (gate-dropped under expert-drop) report 0."""
    load = np.asarray(load, np.float64)
    mean = load.mean(axis=-1)
    return np.where(mean > 0.0,
                    load.max(axis=-1) / np.maximum(mean, 1e-12), 0.0)


@dataclasses.dataclass
class MetricsFrame:
    """The fetched frame of one train chunk: every field stacked to a
    leading K (steps-in-chunk) axis."""
    expert_load: np.ndarray          # (K, E)
    router_entropy: np.ndarray       # (K,)
    dropped_frac: np.ndarray         # (K,)
    gate_dropped: np.ndarray         # (K,)
    comm_a2a_calls: np.ndarray       # (K,)
    comm_bytes: np.ndarray           # (K,)
    comm_wire_bytes: np.ndarray      # (K,)
    comm_exposed_bytes: np.ndarray   # (K,)
    comm_hidden_bytes: np.ndarray    # (K,)

    @classmethod
    def from_metrics(cls, ms: Dict[str, Any]) -> Optional["MetricsFrame"]:
        """Build from a fetched chunk-metrics dict; None when the frame
        keys are absent (dense model, or ``metrics_frame=False``)."""
        if not all(k in ms for k in FRAME_KEYS):
            return None
        return cls(**{k: np.asarray(ms[k]) for k in FRAME_KEYS})

    def __len__(self) -> int:
        return int(self.router_entropy.shape[0])

    def load_imbalance(self) -> np.ndarray:
        """(K,) per-step expert-load imbalance (max/mean)."""
        return load_imbalance(self.expert_load)

    def summary(self) -> Dict[str, float]:
        """Chunk-level scalars. Router health (entropy / imbalance /
        dropped_frac) averages ROUTED steps only — gate-dropped
        expert-drop steps route nothing and would dilute the signal
        toward zero; wire totals sum over all steps."""
        routed = np.asarray(self.gate_dropped) < 0.5
        n_routed = int(routed.sum())

        def rmean(x):
            return float(np.asarray(x)[routed].mean()) if n_routed else 0.0

        return {
            "steps": len(self),
            "routed_steps": n_routed,
            "gate_drop_rate": float(np.mean(self.gate_dropped)),
            "router_entropy": rmean(self.router_entropy),
            "load_imbalance": rmean(self.load_imbalance()),
            "dropped_frac": rmean(self.dropped_frac),
            "wire_bytes_total": float(np.sum(self.comm_wire_bytes)),
            "exposed_bytes_total": float(np.sum(self.comm_exposed_bytes)),
            "hidden_bytes_total": float(np.sum(self.comm_hidden_bytes)),
            "a2a_calls_total": float(np.sum(self.comm_a2a_calls)),
        }


def router_health(history: List[Dict[str, Any]]) -> Dict[str, float]:
    """Router-health summary over Trainer ``history`` records (which
    carry the per-record frame scalars when the frame was on): mean
    entropy / imbalance over routed records, plus the realized
    gate-drop rate. The train CLI's ``--metrics-out`` reports it as
    ``train/router/*``."""
    recs = [r for r in history if "router_entropy" in r]
    if not recs:
        return {"records": 0, "router_entropy": float("nan"),
                "load_imbalance": float("nan"),
                "gate_drop_rate": float("nan")}
    routed = [r for r in recs if r.get("gate_dropped", 0.0) < 0.5]
    use = routed if routed else recs
    return {
        "records": len(recs),
        "router_entropy": float(np.mean([r["router_entropy"]
                                         for r in use])),
        "load_imbalance": float(np.mean([r["load_imbalance"]
                                         for r in use])),
        "gate_drop_rate": float(np.mean([r.get("gate_dropped", 0.0)
                                         for r in recs])),
    }
