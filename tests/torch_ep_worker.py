"""One rank of the port's expert-parallel tests (``test_torch_comm.py``,
``test_torch_ep.py``, ``test_torch_tp.py``), run as a process of its own
under gloo:

  python tests/torch_ep_worker.py RANK WORLD DIR

on the (data, model) mesh ``spec["mesh"]`` (default (WORLD, 1)); a
case's ``ep_on_model`` picks the experts' layout on its model axis.

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
        cfg.moe, top_k=case.get("top_k", 1), jitter_eps=case.get("jitter_eps", 0.0),
        comm=comm, gating_dropout=gd, backend=case.get("backend", "sharded"),
        ep_on_model=case.get("ep_on_model", False)))


def case_arrays(arrays, case):
    """The layer inputs of ``case``: its first ``case["rows"]`` rows of x, g
    and the token mask (all of them by default)."""
    n = case.get("rows")
    if n is None:
        return arrays
    return {k: v[:n] if k in ("x", "g", "tv") else v for k, v in arrays.items()}


def run_layer(case, inputs, ctx, out, rec):
    """One MoE layer call on this rank's rows (its data index's) and
    experts, forward and backward (of sum(y * g), or of the balance term
    alone with ``case["loss"]`` "balance"), with the collective counter
    read after each."""
    cfg = layer_cfg(case)
    ctx = ctx.with_layout(cfg.moe.ep_on_model)
    inputs = case_arrays(inputs, case)
    n = inputs["x"].shape[0] // ctx.dp
    rows = slice(ctx.data * n, (ctx.data + 1) * n)
    full = bridge.to_torch({k[2:]: v for k, v in inputs.items()
                            if k.startswith("p/")}, "cpu")
    params = bridge.shard_experts(full, ctx)
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
    loss = (aux["balance"] if case.get("loss") == "balance"
            else (y * torch.from_numpy(inputs["g"][rows])).sum())
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


def run_routing(spec, inputs, ctx, out, rec):
    """Routed layer calls with router jitter on and off (seeded
    generator): the expert ids of this rank's tokens, read off
    ``router.route``."""
    from repro_torch.core import router as R
    orig, ids = R.route, []

    def recorded(*a, **k):
        rr = orig(*a, **k)
        ids.append(rr.topk_idx.clone())
        return rr

    R.route = recorded
    ctx = ctx.with_layout(spec.get("ep_on_model", False))
    try:
        for jitter in (0.5, 0.0):
            case = dict(name=f"routing/{jitter}", substrate="dense", decision=False,
                        jitter_eps=jitter, ep_on_model=spec.get("ep_on_model", False))
            cfg = layer_cfg(case)
            n = inputs["x"].shape[0] // ctx.dp
            full = bridge.to_torch({k[2:]: v for k, v in inputs.items()
                                    if k.startswith("p/")}, "cpu")
            params = bridge.shard_experts(full, ctx)
            x = torch.from_numpy(inputs["x"][ctx.data * n:(ctx.data + 1) * n])
            with torch.no_grad():
                B.get_backend("sharded")(params, x, cfg, ctx=ctx, decision=False,
                                         generator=torch.Generator().manual_seed(3))
            out[f"routing/ids/{jitter}"] = ids.pop().numpy()
    finally:
        R.route = orig


def run_fault(spec, ctx, out, rec):
    """``moe_sharded`` under ``ep_on_model`` at one position (a decode
    step's x): the error it raises."""
    from repro_torch.configs.base import ModelConfig, MoEConfig
    from repro_torch.core.moe import init_moe_params
    cfg = ModelConfig(d_model=32, d_ff=64, vocab=64, dtype="float32", moe=MoEConfig(
        n_experts=8, top_k=1, d_ff_expert=64, jitter_eps=0.0, ep_on_model=True,
        backend="sharded"))
    eom = ctx.with_layout(True)
    params = bridge.shard_experts(init_moe_params(torch.Generator().manual_seed(0), cfg),
                                  eom)
    try:
        B.get_backend("sharded")(params, torch.zeros(2, 1, 32), cfg, ctx=eom,
                                 decision=False)
        rec["fault"] = None
    except ValueError as e:
        rec["fault"] = str(e)


def run_train(spec, ctx, out, rec):
    """Gate-Drop steps through the Trainer from the full init in
    ``init.npz``, each rank on its experts (in the layout of
    ``spec["ep_on_model"]``)."""
    from repro_torch.data import MTTaskConfig, MultilingualMT
    from repro_torch.training import Trainer
    d = spec["dir"]
    ctx = ctx.with_layout(spec.get("ep_on_model", False))
    for backend in spec["backends"]:
        cfg = reduced(get_config("zcode-m3-base"))
        gd = dataclasses.replace(cfg.moe.gating_dropout, mode="gate_drop", rate=0.3)
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, jitter_eps=0.0, backend=backend, gating_dropout=gd,
            ep_on_model=ctx.ep_on_model))
        tc = TrainConfig(lr=1e-3, warmup_steps=2, seed=0, steps=spec["steps"])
        init = dict(np.load(os.path.join(d, "init.npz")))
        params = bridge.shard_experts(bridge.to_torch(init, "cpu"), ctx)
        batches = MultilingualMT(MTTaskConfig(vocab=cfg.vocab, n_langs=4,
                                              max_len=16)).train_batches(4)
        ckpt = os.path.join(d, spec["ckpt"]) if backend == spec.get("ckpt_backend") else None
        trainer = Trainer(cfg, tc, batches, device="cpu", params=params, ctx=ctx,
                          chunk=2, log_every=1, log=None, prefetch=False, ckpt_dir=ckpt)
        state, history = trainer.run()
        rec[f"train/{backend}"] = history
        for k, v in flatten_with_paths(state["params"]).items():
            out[f"train/{backend}/{k}"] = v.detach().numpy()


def ckpt_cfg(ep_on_model: bool = False):
    """Reduced zcode-m3-base whose steps are the same function at any group
    size and layout: no Gating Dropout (its local group is the rank's
    experts), no jitter, no capacity drops (capacity factor = expert
    count) and no balance term (a group mean of per-rank terms)."""
    cfg = reduced(get_config("zcode-m3-base"))
    e = float(cfg.moe.n_experts)
    gd = dataclasses.replace(cfg.moe.gating_dropout, mode="off", rate=0.0)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, jitter_eps=0.0, balance_coef=0.0, capacity_factor=e,
        eval_capacity_factor=e, backend="sharded", gating_dropout=gd,
        ep_on_model=ep_on_model))


def ckpt_trainer(d, ckpt, steps, params=None, ctx=None):
    """A Trainer of ``ckpt_cfg`` (in ``ctx``'s layout) on the MT batches,
    saving to ``d/ckpt`` at its last step; from the full init in
    ``d/init.npz`` (sharded under ``ctx``) unless ``params`` are given."""
    from repro_torch.data import MTTaskConfig, MultilingualMT
    from repro_torch.training import Trainer
    cfg = ckpt_cfg(ctx is not None and ctx.ep_on_model)
    if params is None:
        params = bridge.to_torch(dict(np.load(os.path.join(d, "init.npz"))), "cpu")
        params = bridge.shard_experts(params, ctx)
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


def read_checkpoint(d, name, step):
    """(arrays, meta) of ``d/name``'s checkpoint at ``step``."""
    path = os.path.join(d, name, f"step_{step:08d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return dict(np.load(os.path.join(path, "arrays.npz"))), meta


def assert_same_checkpoint(got, want):
    """Keys, shapes, dtypes and meta equal; parameters within 2e-4,
    moments within 1e-6, counters exact."""
    (ga, gm), (wa, wm) = got, want
    assert sorted(ga) == sorted(wa)
    assert (gm["step"], gm["n_arrays"], gm["dtypes"], gm["arch"]) == \
        (wm["step"], wm["n_arrays"], wm["dtypes"], wm["arch"])
    for key, want_arr in wa.items():
        assert ga[key].shape == want_arr.shape and ga[key].dtype == want_arr.dtype, key
        atol = 2e-4 if key.startswith("params/") else 1e-6
        if key.startswith("params/") or key.startswith("opt/m/") or key.startswith("opt/v/"):
            np.testing.assert_allclose(ga[key], want_arr, atol=atol, rtol=0, err_msg=key)
        else:
            np.testing.assert_array_equal(ga[key], want_arr, err_msg=key)


def _wait_for(path, timeout=380.0):
    """Waits for ``path`` (a checkpoint another group of ranks writes)."""
    import time
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.2)


def run_ckpt(spec, ctx, out, rec):
    """Gathered checkpoints: ``spec["steps"]`` steps saved on this group
    into ``spec["save"]`` (if given), then each checkpoint of
    ``spec["resume"]`` (a name in DIR, or a path) restored on this group
    in each layout of ``spec["layouts"]`` (default the tensor-parallel
    one; its records under ``ckpt/<name>``, ``ep_on_model``'s under
    ``ckpt/<name>@eom``) and taken one step further; the final expert
    leaves of each resumed run are this rank's block."""
    d = spec["dir"]
    if spec.get("save"):
        ckpt_trainer(d, spec["save"], spec["steps"], ctx=ctx).run()
    for src in spec["resume"]:
        _wait_for(os.path.join(d, src, "latest"))
        name = os.path.basename(src)
        for eom in spec.get("layouts", [False]):
            lctx = ctx.with_layout(eom)
            tag = f"{name}@eom" if lctx.ep_on_model else name
            dst = f"resume_{tag}_{ctx.dp}x{ctx.tp}"
            if ctx.rank == 0:
                resume_copy(d, src, dst)
            dist.barrier(group=ctx.group)
            trainer = ckpt_trainer(d, dst, spec["steps"] + 1, ctx=lctx)
            rec[f"ckpt/{tag}/restored_step"] = trainer.restore()
            state, _ = trainer.run()
            for k, v in flatten_with_paths(state["params"]).items():
                out[f"ckpt/{tag}/{k}"] = v.detach().numpy()


def run_generate(spec, ctx, out, rec):
    """``greedy_bleu`` and ``generate`` under the group, this rank's rows."""
    from repro_torch.data import MTTaskConfig, MultilingualMT
    from repro_torch.launch.train import greedy_bleu
    from repro_torch.serve import GenerateConfig, generate
    d = spec["dir"]
    cfg = reduced(get_config("zcode-m3-base"))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, backend=spec["backend"]))
    params = bridge.shard_experts(
        bridge.to_torch(dict(np.load(os.path.join(d, "gen_params.npz"))), "cpu"), ctx)
    task = MultilingualMT(MTTaskConfig(vocab=cfg.vocab, n_langs=4, max_len=16))
    rec["bleu"] = greedy_bleu(params, cfg, task, n=spec["n"], max_new=spec["max_new"],
                              ctx=ctx, device="cpu")
    b = task.sample_batch(10_000, spec["n"])
    n = spec["n"] // ctx.dp
    rows = slice(ctx.data * n, (ctx.data + 1) * n)
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
    ctx = make_group(tuple(spec.get("mesh", (world, 1))), "cpu",
                     init_method=f"file://{d}/rendezvous",
                     rank=rank, world_size=world)
    out, rec = {}, {}
    try:
        if spec.get("layer") or "routing" in spec:
            inputs = dict(np.load(os.path.join(d, "layer.npz")))
            for case in spec.get("layer", []):
                run_layer(case, inputs, ctx, out, rec)
            if "routing" in spec:
                run_routing(spec["routing"], inputs, ctx, out, rec)
        if "fault" in spec:
            run_fault(spec["fault"], ctx, out, rec)
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
