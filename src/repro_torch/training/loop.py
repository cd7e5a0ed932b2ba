"""The Trainer (port of ``repro/training/loop.py``), as an eager per-step
loop.

The reference fuses K steps into one ``lax.scan`` inside a single jit; that
is a JAX compile-unit device with no counterpart here. What carries over:

  * data comes as CHUNKS of K steps from the background prefetcher
    (``repro_torch.data.prefetch``);
  * each chunk is split into maximal runs of equal host-drawn consensus
    bits (``same_decision_runs``, the reference's host_cond strategy);
  * every step's metrics stay on the device and are fetched once per
    chunk (``analysis.hostsync.fetch``, the chunk's one device-to-host
    sync: batches are copied in from pinned memory without a sync, and the
    learning rate and the drop bit live on the host);
  * checkpoint and resume at the ABSOLUTE step: after a restore, the data
    stream and the consensus bits continue where the run left off; under
    an expert-parallel group the checkpoint holds the gathered experts
    (``checkpoint.save_checkpoint``), so a run may resume at another
    group size;
  * history records carry loss, acc, lr and tok/s, where tok/s counts the
    decoder ``tokens`` AND the encoder ``enc_tokens``, ``mtp_xent`` where
    the model has an MTP head, the ``comm_*``
    wire counters of the step's forward and, with the MetricsFrame on,
    ``router_entropy``, ``load_imbalance`` (of ``expert_load``,
    ``obs.frame.load_imbalance``) and ``gate_dropped``;
  * spans on the tracer (default the process's): ``train_chunk`` per
    chunk, ``chunk.execute`` per same-decision run (under a
    ``torch.profiler`` annotation ``train_chunk``), ``chunk.fetch``
    around the fetch, ``eval`` per evaluation, and the Prefetcher's
    ``prefetch.produce`` / ``prefetch.wait``;
  * evaluation (``eval_fn``, BLEU in the CLI) every ``eval_every`` steps
    and at the last: the schedule cuts chunks so that every eval step ends
    one, and the eval sees the params after that step. A record's clock
    is read before its eval runs, so later records' clocks include the
    eval's time (the reference's convention).

Under a (data, model) ``ctx`` every rank runs the same loop on the same
global batches (each step takes its data index's rows), from the same
full init with its block of experts in the context's layout
(``bridge.shard_experts``).
"""
from __future__ import annotations

import json
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.hostsync import fetch
from repro_torch.bridge import shard_experts
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.gating_dropout import drop_decisions_host
from repro_torch.data.prefetch import Prefetcher, stack_batches
from repro_torch.models import init_model
from repro_torch.obs.frame import load_imbalance
from repro_torch.obs.trace import Tracer, get_tracer, monotonic
from repro_torch.training.steps import init_train_state, make_train_step

# tokens a step consumes: decoder tokens AND (for enc-dec tasks) encoder
# tokens
TOKEN_KEYS = ("tokens", "enc_tokens")


def same_decision_runs(gd, seed: int, lo: int, hi: int
                       ) -> List[Tuple[int, int, bool]]:
    """Split [lo, hi) into maximal runs of equal consensus bits:
    [(start, stop, decision), ...] covering the span in order."""
    if gd is None or not gd.enabled:
        return [(lo, hi, False)]
    decs = [bool(d) for d in drop_decisions_host(gd, seed, lo, hi)]
    runs, i = [], 0
    while i < len(decs):
        j = i
        while j < len(decs) and decs[j] == decs[i]:
            j += 1
        runs.append((lo + i, lo + j, decs[i]))
        i = j
    return runs


def to_device(batch: Dict[str, np.ndarray], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device``; to a card through pinned
    memory, so the copy waits for nothing already queued there."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


class Trainer:
    """Owns a training run: state, data, chunked execution, checkpoints,
    logging and resume.

    ``batch_fn``: step -> dict of numpy arrays (called on the prefetch
    thread, or inline without ``prefetch``; pure host work). ``chunk``:
    steps per metrics fetch. ``eval_fn``: (state, step) -> dict merged
    into that step's record, at the steps ``_eval_steps`` names. ``log``:
    callable for per-record lines (default: print as JSON); None disables
    printing (history is still returned). ``ctx``: the expert-parallel
    context; ``params`` are then this rank's (default: the full seeded
    init, sharded). ``tracer``: where the spans go (default the process's
    tracer, disabled unless a launcher set one).
    """

    def __init__(self, cfg: ModelConfig, tc: TrainConfig,
                 batch_fn: Callable[[int], Dict[str, np.ndarray]], *,
                 device: torch.device, params: Any = None, chunk: int = 8,
                 ctx=None, ckpt_dir: Optional[str] = None,
                 eval_every: int = 0,
                 eval_fn: Optional[Callable[[Any, int], Dict]] = None,
                 log_every: int = 20, prefetch: bool = True,
                 log: Optional[Callable[[str], None]] = print,
                 tracer: Optional[Tracer] = None):
        self.cfg, self.tc, self.ctx = cfg, tc, ctx
        self.batch_fn = batch_fn
        self.device = torch.device(device)
        self.chunk = max(int(chunk), 1)
        gd = cfg.moe.gating_dropout if cfg.moe is not None else None
        self.gd = gd if (gd is not None and gd.enabled) else None
        self.ckpt_dir = ckpt_dir
        self.eval_every, self.eval_fn = eval_every, eval_fn
        self.log_every, self.log = log_every, log
        self.prefetch = prefetch
        if params is None:
            params = init_model(
                torch.Generator(device=self.device).manual_seed(tc.seed), cfg)
            params = shard_experts(params, ctx)
        self.state = init_train_state(params, tc)
        self.start_step = 0
        self.history: List[Dict] = []
        self.step_fn = make_train_step(cfg, tc, ctx)
        self.tracer = tracer if tracer is not None else get_tracer()

    def restore(self) -> int:
        """Restore params, optimizer state and step from ``ckpt_dir``; the
        run continues at that absolute step."""
        if not self.ckpt_dir or latest_step(self.ckpt_dir) is None:
            raise FileNotFoundError(f"restore: no checkpoint in {self.ckpt_dir}")
        self.state, meta = restore_checkpoint(self.ckpt_dir, self.state,
                                              ctx=self.ctx)
        self.start_step = int(meta["step"])
        return self.start_step

    def _eval_steps(self) -> set:
        if not self.eval_every or self.eval_fn is None:
            return set()
        return ({i for i in range(self.tc.steps) if i % self.eval_every == 0}
                | {self.tc.steps - 1})

    def schedule(self) -> List[Tuple[int, int]]:
        """Chunk spans [s, e) covering [start_step, steps), at most
        ``chunk`` long, cut so that every eval step is a chunk's last."""
        ends = sorted({i + 1 for i in self._eval_steps()} | {self.tc.steps})
        spans, s = [], self.start_step
        for e in ends:
            while s < e:
                spans.append((s, min(s + self.chunk, e)))
                s = spans[-1][1]
        return spans

    def _record_steps(self) -> set:
        rec = {self.tc.steps - 1} | self._eval_steps()
        if self.log_every:
            rec |= {i for i in range(self.tc.steps) if i % self.log_every == 0}
        return rec

    def _run_chunk(self, span: Tuple[int, int], stacked: Dict[str, np.ndarray]
                   ) -> Dict[str, np.ndarray]:
        """Run one chunk's steps; returns their metrics stacked over the
        span, fetched from the device at once (the chunk's one sync)."""
        s, e = span
        tr = self.tracer
        per_step = []
        for rs, re, dec in same_decision_runs(self.gd, self.tc.seed, s, e):
            with tr.span("chunk.execute", start=rs, stop=re, decision=bool(dec)), \
                    tr.annotation("train_chunk"):
                for i in range(rs, re):
                    batch = to_device({k: v[i - s] for k, v in stacked.items()},
                                      self.device)
                    self.state, m = self.step_fn(self.state, batch, dec)
                    per_step.append(m)
        keys = per_step[0]
        dev = {k: torch.stack([m[k] for m in per_step])
               for k in keys if torch.is_tensor(keys[k])}
        groups: Dict[torch.device, List[str]] = {}
        for k, t in dev.items():
            groups.setdefault(t.device, []).append(k)
        with tr.span("chunk.fetch", start=s, stop=e):
            # one copy per device the metrics live on (under a group some
            # are host tensors): each device's metrics as f64 (exact for
            # f32 and ints) in one buffer
            flat = fetch([torch.cat([dev[k].reshape(-1).double() for k in ks])
                          for ks in groups.values()])
        out = {}
        for ks, buf in zip(groups.values(), flat):
            at = 0
            for k in ks:
                n = dev[k].numel()
                out[k] = buf[at:at + n].reshape(dev[k].shape)
                at += n
        for k in keys:
            if k not in out:
                out[k] = np.asarray([m[k] for m in per_step])
        return out

    def run(self) -> Tuple[Any, List[Dict]]:
        spans = self.schedule()
        batches = lambda span: stack_batches(self.batch_fn, *span)  # noqa: E731
        it = (Prefetcher(batches, spans, tracer=self.tracer) if self.prefetch
              else map(batches, spans))
        rec_steps, eval_steps = self._record_steps(), self._eval_steps()
        tokens_done, t0 = 0, monotonic()
        try:
            for span, stacked in zip(spans, it):
                s, e = span
                tok_per_step = sum(int(stacked[k][0].size)
                                   for k in TOKEN_KEYS if k in stacked)
                with self.tracer.span("train_chunk", start=s, stop=e,
                                      tokens=(e - s) * tok_per_step):
                    ms = self._run_chunk(span, stacked)
                el = monotonic() - t0
                tokens_done += (e - s) * tok_per_step
                for i in range(s, e):
                    if i not in rec_steps:
                        continue
                    j = i - s
                    rec = {"step": i, "loss": float(ms["loss"][j]),
                           "acc": float(ms["acc"][j]),
                           "lr": float(ms["lr"][j]),
                           "tok_s": tokens_done / max(el, 1e-9),
                           "time_s": el}
                    for k in ("balance", "mtp_xent", "comm_wire_bytes",
                              "comm_a2a_calls", "comm_exposed_bytes",
                              "comm_hidden_bytes"):
                        if k in ms:
                            rec[k] = float(ms[k][j])
                    if "router_entropy" in ms:
                        # the MetricsFrame's router health, on the host
                        # since the chunk's fetch
                        rec["router_entropy"] = float(ms["router_entropy"][j])
                        rec["load_imbalance"] = float(load_imbalance(
                            ms["expert_load"][j]))
                        rec["gate_dropped"] = float(ms["gate_dropped"][j])
                    if i in eval_steps:    # the schedule makes i == e - 1
                        with self.tracer.span("eval", step=i):
                            rec.update(self.eval_fn(self.state, i))
                    self.history.append(rec)
                    if self.log is not None:
                        self.log(json.dumps(rec))
        finally:
            if isinstance(it, Prefetcher):
                it.close()
        if self.ckpt_dir:
            save_checkpoint(self.ckpt_dir, self.tc.steps, self.state,
                            {"arch": self.cfg.arch_id}, ctx=self.ctx)
        return self.state, self.history
