"""One rank of the port's expert-parallel tests (``test_torch_comm.py``,
``test_torch_ep.py``), run as a process of its own under gloo:

  python tests/torch_ep_worker.py RANK WORLD DIR

``DIR/spec.json`` names what to run; the inputs are in ``DIR`` as numpy
files the test wrote, and the rank writes ``DIR/rank{RANK}.npz`` (arrays)
and ``DIR/rank{RANK}.json`` (records). Imports torch and the port only.
``Ranks`` starts the processes of one group from a test and collects what
they wrote.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch import bridge  # noqa: E402
from repro_torch.comm import COUNTER  # noqa: E402
from repro_torch.configs import TrainConfig, get_config, reduced  # noqa: E402
from repro_torch.core import backend as B  # noqa: E402
from repro_torch.launch.mesh import make_group  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402


class Ranks:
    """The ``world`` processes of one gloo group, started at construction
    (they rendezvous through a file in ``d``); ``join`` waits for them,
    at most ``timeout`` seconds, and returns each rank's (arrays,
    records)."""

    def __init__(self, world: int, d: str, spec: dict, timeout: float = 240):
        self.world, self.d, self.timeout = world, str(d), timeout
        with open(os.path.join(self.d, "spec.json"), "w") as f:
            json.dump(spec, f)
        env = dict(os.environ, OMP_NUM_THREADS="1")
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(world), self.d],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
            for r in range(world)]

    def join(self):
        logs = []
        try:
            for p in self.procs:
                logs.append(p.communicate(timeout=self.timeout)[0])
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(self.procs, logs)):
            assert p.returncode == 0, f"rank {r} failed:\n{log[-6000:]}"
        return [(dict(np.load(os.path.join(self.d, f"rank{r}.npz"))),
                 json.load(open(os.path.join(self.d, f"rank{r}.json"))))
                for r in range(self.world)]


def layer_cfg(case):
    cfg = reduced(get_config("zcode-m3-base"))
    comm = dataclasses.replace(cfg.moe.comm, substrate=case["substrate"],
                               quant=case.get("quant", "int8"),
                               ep_inner=case.get("ep_inner", 0),
                               n_chunks=case.get("n_chunks", 4))
    gd = dataclasses.replace(cfg.moe.gating_dropout,
                             mode=case.get("mode", "gate_drop"), rate=0.3)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, top_k=case.get("top_k", 1), jitter_eps=0.0, comm=comm,
        gating_dropout=gd, backend=case.get("backend", "sharded")))


def run_layer(case, inputs, ctx, out, rec):
    """One MoE layer call on this rank's rows and experts, forward and
    backward, with the collective counter read after each."""
    cfg = layer_cfg(case)
    n = inputs["x"].shape[0] // ctx.ep
    rows = slice(ctx.rank * n, (ctx.rank + 1) * n)
    full = bridge.to_torch({k[2:]: v for k, v in inputs.items()
                            if k.startswith("p/")}, "cpu")
    params = bridge.shard_experts(full, ctx.rank, ctx.ep)
    leaves = flatten_with_paths(params)
    for t in leaves.values():
        t.requires_grad_(True)
    x = torch.from_numpy(inputs["x"][rows]).requires_grad_(True)
    tv = (torch.from_numpy(inputs["tv"][rows]) if case.get("masked") else None)
    COUNTER.reset()
    y, aux = B.get_backend(cfg.moe.backend)(
        params, x, cfg, ctx=ctx, decision=case["decision"], is_training=True,
        token_valid=tv)
    fwd = (COUNTER.calls["fwd"], COUNTER.bytes["fwd"], COUNTER.wire_bytes["fwd"])
    loss = (y * torch.from_numpy(inputs["g"][rows])).sum()
    names = ["x"] + list(leaves)
    grads = ([None] * len(names) if not loss.requires_grad   # expert drop
             else torch.autograd.grad(loss, [x] + list(leaves.values()),
                                      allow_unused=True))
    name = case["name"]
    out[f"{name}/y"] = y.detach().numpy()
    for k, v in aux.items():
        out[f"{name}/aux/{k}"] = v.detach().numpy()
    for k, g in zip(names, grads):
        if g is not None:
            out[f"{name}/grad/{k}"] = g.numpy()
    rec[name] = {"fwd_calls": fwd[0], "fwd_bytes": fwd[1], "fwd_wire": fwd[2],
                 "bwd_calls": COUNTER.calls["bwd"], "bwd_bytes": COUNTER.bytes["bwd"],
                 "bwd_wire": COUNTER.wire_bytes["bwd"]}


def run_train(spec, ctx, out, rec):
    """Gate-Drop steps through the Trainer from the full init in
    ``init.npz``, each rank on its experts."""
    from repro_torch.data import MTTaskConfig, MultilingualMT
    from repro_torch.training import Trainer
    d = spec["dir"]
    for backend in spec["backends"]:
        cfg = reduced(get_config("zcode-m3-base"))
        gd = dataclasses.replace(cfg.moe.gating_dropout, mode="gate_drop", rate=0.3)
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, jitter_eps=0.0, backend=backend, gating_dropout=gd))
        tc = TrainConfig(lr=1e-3, warmup_steps=2, seed=0, steps=spec["steps"])
        init = dict(np.load(os.path.join(d, "init.npz")))
        params = bridge.shard_experts(bridge.to_torch(init, "cpu"), ctx.rank, ctx.ep)
        batches = MultilingualMT(MTTaskConfig(vocab=cfg.vocab, n_langs=4,
                                              max_len=16)).train_batches(4)
        ckpt = os.path.join(d, spec["ckpt"]) if backend == spec.get("ckpt_backend") else None
        trainer = Trainer(cfg, tc, batches, device="cpu", params=params, ctx=ctx,
                          chunk=2, log_every=1, log=None, prefetch=False, ckpt_dir=ckpt)
        state, history = trainer.run()
        rec[f"train/{backend}"] = history
        for k, v in flatten_with_paths(state["params"]).items():
            out[f"train/{backend}/{k}"] = v.detach().numpy()


def ckpt_cfg():
    """Reduced zcode-m3-base whose steps are the same function at any group
    size: no Gating Dropout (its local group is the rank's experts), no
    jitter, no capacity drops (capacity factor = expert count) and no
    balance term (a group mean of per-rank terms)."""
    cfg = reduced(get_config("zcode-m3-base"))
    e = float(cfg.moe.n_experts)
    gd = dataclasses.replace(cfg.moe.gating_dropout, mode="off", rate=0.0)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, jitter_eps=0.0, balance_coef=0.0, capacity_factor=e,
        eval_capacity_factor=e, backend="sharded", gating_dropout=gd))


def ckpt_trainer(d, ckpt, steps, params=None, ctx=None):
    """A Trainer of ``ckpt_cfg`` on the MT batches, saving to ``d/ckpt``
    at its last step; from the full init in ``d/init.npz`` (sharded under
    ``ctx``) unless ``params`` are given."""
    from repro_torch.data import MTTaskConfig, MultilingualMT
    from repro_torch.training import Trainer
    cfg = ckpt_cfg()
    if params is None:
        params = bridge.to_torch(dict(np.load(os.path.join(d, "init.npz"))), "cpu")
        if ctx is not None:
            params = bridge.shard_experts(params, ctx.rank, ctx.ep)
    tc = TrainConfig(lr=1e-3, warmup_steps=2, seed=0, steps=steps)
    batches = MultilingualMT(MTTaskConfig(vocab=cfg.vocab, n_langs=4,
                                          max_len=16)).train_batches(4)
    return Trainer(cfg, tc, batches, device="cpu", params=params, ctx=ctx, chunk=2,
                   log_every=1, log=None, prefetch=False,
                   ckpt_dir=os.path.join(d, ckpt))


def resume_copy(d, src, dst):
    """``d/dst``, a copy of checkpoint directory ``d/src`` that a resumed
    run saves into (the source keeps its latest step)."""
    import shutil
    shutil.copytree(os.path.join(d, src), os.path.join(d, dst))
    return dst


def run_ckpt(spec, ctx, out, rec):
    """Gathered checkpoints: ``spec["steps"]`` steps saved at this group
    size into ``spec["save"]``, then each checkpoint of ``spec["resume"]``
    restored at this group size and taken one step further; the final
    expert leaves of each resumed run are this rank's block."""
    d = spec["dir"]
    ckpt_trainer(d, spec["save"], spec["steps"], ctx=ctx).run()
    for src in spec["resume"]:
        dst = f"resume_{src}_ep{ctx.ep}"
        if ctx.rank == 0:
            resume_copy(d, src, dst)
        dist.barrier(group=ctx.group)
        trainer = ckpt_trainer(d, dst, spec["steps"] + 1, ctx=ctx)
        rec[f"ckpt/{src}/restored_step"] = trainer.restore()
        state, _ = trainer.run()
        for k, v in flatten_with_paths(state["params"]).items():
            out[f"ckpt/{src}/{k}"] = v.detach().numpy()


def run_generate(spec, ctx, out, rec):
    """``greedy_bleu`` and ``generate`` under the group, this rank's rows."""
    from repro_torch.data import MTTaskConfig, MultilingualMT
    from repro_torch.launch.train import greedy_bleu
    from repro_torch.serve import GenerateConfig, generate
    d = spec["dir"]
    cfg = reduced(get_config("zcode-m3-base"))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, backend=spec["backend"]))
    params = bridge.shard_experts(
        bridge.to_torch(dict(np.load(os.path.join(d, "gen_params.npz"))), "cpu"),
        ctx.rank, ctx.ep)
    task = MultilingualMT(MTTaskConfig(vocab=cfg.vocab, n_langs=4, max_len=16))
    rec["bleu"] = greedy_bleu(params, cfg, task, n=spec["n"], max_new=spec["max_new"],
                              ctx=ctx, device="cpu")
    b = task.sample_batch(10_000, spec["n"])
    n = spec["n"] // ctx.ep
    rows = slice(ctx.rank * n, (ctx.rank + 1) * n)
    COUNTER.reset()
    res = generate(params, {"enc_tokens": torch.from_numpy(b["enc_tokens"][rows]),
                            "tokens": torch.from_numpy(b["tokens"][rows, :1])},
                   cfg, GenerateConfig(max_new=spec["max_new"]), ctx=ctx)
    out["gen/tokens"] = res.tokens.numpy()
    rec["gen_steps"] = res.steps
    rec["gen_calls"] = COUNTER.calls["fwd"]


def main():
    rank, world, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.manual_seed(0)
    torch.set_num_threads(1)
    spec = json.load(open(os.path.join(d, "spec.json")))
    ctx = make_group(world, "cpu", init_method=f"file://{d}/rendezvous",
                     rank=rank, world_size=world)
    out, rec = {}, {}
    try:
        if spec.get("layer"):
            inputs = dict(np.load(os.path.join(d, "layer.npz")))
            for case in spec["layer"]:
                run_layer(case, inputs, ctx, out, rec)
        if spec.get("train"):
            run_train(dict(spec["train"], dir=d), ctx, out, rec)
        if spec.get("generate"):
            run_generate(dict(spec["generate"], dir=d), ctx, out, rec)
        if spec.get("ckpt"):
            run_ckpt(dict(spec["ckpt"], dir=d), ctx, out, rec)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(d, f"rank{rank}.npz"), **out)
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


if __name__ == "__main__":
    main()
