"""The Trainer (port of ``repro/training/loop.py``), as an eager per-step
loop.

The reference fuses K steps into one ``lax.scan`` inside a single jit; that
is a JAX compile-unit device with no counterpart here. What carries over:

  * data comes as CHUNKS of K steps from the background prefetcher
    (``repro_torch.data.prefetch``);
  * each chunk is split into maximal runs of equal host-drawn consensus
    bits (``same_decision_runs``, the reference's host_cond strategy);
  * every step's metrics stay on the device and are fetched once per
    chunk (one device-to-host sync per chunk: batches are copied in from
    pinned memory without a sync, and the learning rate and the drop bit
    live on the host);
  * checkpoint and resume at the ABSOLUTE step: after a restore, the data
    stream and the consensus bits continue where the run left off;
  * history records carry loss, acc, lr and tok/s, where tok/s counts the
    decoder ``tokens`` AND the encoder ``enc_tokens``, and the ``comm_*``
    wire counters of the step's forward;
  * evaluation (``eval_fn``, BLEU in the CLI) every ``eval_every`` steps
    and at the last: the schedule cuts chunks so that every eval step ends
    one, and the eval sees the params after that step. A record's clock
    is read before its eval runs, so later records' clocks include the
    eval's time (the reference's convention).

Under an expert-parallel ``ctx`` every rank runs the same loop on the same
global batches (each step takes its rows), from the same full init with
its block of experts (``bridge.shard_experts``).
"""
from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.bridge import shard_experts
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.gating_dropout import drop_decisions_host
from repro_torch.data.prefetch import Prefetcher, stack_batches
from repro_torch.models import init_model
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
    init, sharded).
    """

    def __init__(self, cfg: ModelConfig, tc: TrainConfig,
                 batch_fn: Callable[[int], Dict[str, np.ndarray]], *,
                 device: torch.device, params: Any = None, chunk: int = 8,
                 ctx=None, ckpt_dir: Optional[str] = None,
                 eval_every: int = 0,
                 eval_fn: Optional[Callable[[Any, int], Dict]] = None,
                 log_every: int = 20, prefetch: bool = True,
                 log: Optional[Callable[[str], None]] = print):
        if ckpt_dir and ctx is not None and ctx.ep > 1:
            raise NotImplementedError(
                "checkpoints of an expert-parallel run (gathered save and "
                "restore) are not ported; see ROADMAP.md")
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
            if ctx is not None and ctx.ep > 1:
                params = shard_experts(params, ctx.rank, ctx.ep)
        self.state = init_train_state(params, tc)
        self.start_step = 0
        self.history: List[Dict] = []
        self.step_fn = make_train_step(cfg, tc, ctx)

    def restore(self) -> int:
        """Restore params, optimizer state and step from ``ckpt_dir``; the
        run continues at that absolute step."""
        if not self.ckpt_dir or latest_step(self.ckpt_dir) is None:
            raise FileNotFoundError(f"restore: no checkpoint in {self.ckpt_dir}")
        self.state, meta = restore_checkpoint(self.ckpt_dir, self.state)
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
        span, fetched from the device at once."""
        s, e = span
        per_step = []
        for rs, re, dec in same_decision_runs(self.gd, self.tc.seed, s, e):
            for i in range(rs, re):
                batch = to_device({k: v[i - s] for k, v in stacked.items()},
                                  self.device)
                self.state, m = self.step_fn(self.state, batch, dec)
                per_step.append(m)
        fetched = {k: torch.stack([torch.as_tensor(m[k]) for m in per_step]).cpu()
                   for k in per_step[0] if torch.is_tensor(per_step[0][k])}
        out = {k: v.numpy() for k, v in fetched.items()}
        for k in per_step[0]:
            if k not in out:
                out[k] = np.asarray([m[k] for m in per_step])
        return out

    def run(self) -> Tuple[Any, List[Dict]]:
        spans = self.schedule()
        fetch = lambda span: stack_batches(self.batch_fn, *span)  # noqa: E731
        it = Prefetcher(fetch, spans) if self.prefetch else map(fetch, spans)
        rec_steps, eval_steps = self._record_steps(), self._eval_steps()
        tokens_done, t0 = 0, time.perf_counter()
        try:
            for span, stacked in zip(spans, it):
                s, e = span
                tok_per_step = sum(int(stacked[k][0].size)
                                   for k in TOKEN_KEYS if k in stacked)
                ms = self._run_chunk(span, stacked)
                el = time.perf_counter() - t0
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
                    for k in ("balance", "comm_wire_bytes", "comm_a2a_calls",
                              "comm_exposed_bytes", "comm_hidden_bytes",
                              "router_entropy", "gate_dropped"):
                        if k in ms:
                            rec[k] = float(ms[k][j])
                    if i in eval_steps:    # the schedule makes i == e - 1
                        rec.update(self.eval_fn(self.state, i))
                    self.history.append(rec)
                    if self.log is not None:
                        self.log(json.dumps(rec))
        finally:
            if isinstance(it, Prefetcher):
                it.close()
        if self.ckpt_dir:
            save_checkpoint(self.ckpt_dir, self.tc.steps, self.state,
                            {"arch": self.cfg.arch_id})
        return self.state, self.history
