"""Meta-device dry run (port of ``repro/launch/dryrun.py``): every
applicable (architecture x input shape) runs its step at full width on
``torch.device("meta")``, where nothing is allocated, and the production
meshes' sharding rules (``parallel/sharding.py``) give its bytes per
device.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --comm-table \\
      --arch zcode-m3-base --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --lint-table [--lint-device cpu]

Artifacts: <--out-dir, default build/dryrun>/<arch>__<shape>__<mesh>[__tag].json

The step is the train step with Adam (``training/steps.py``), the prefill,
or one decode step against a ``seq_len`` cache. The reference lowers and
compiles it with XLA; eager PyTorch has no compiled artifact, so the
artifact holds what the meta device can count:

  * ``flops_step``: the matmul-family FLOPs of the whole step (forward,
    backward with remat's recomputation, as executed) from
    ``torch.utils.flop_counter.FlopCounterMode``. It is no per-device XLA
    ``flops``: XLA also counts elementwise work and counts a scan body
    once. The blocked flash attention counts the key blocks it runs (it
    skips those no row can see); ``banded_flash_attention`` runs its
    ``use_full`` cost mode (``models/flash.py::full_bands``), as the
    reference's unrolled costing does;
  * ``memory.argument_bytes_per_device``: the state (or parameters),
    batch, cache and token under the specs, the counterpart of XLA's
    ``argument_size_in_bytes``;
  * ``memory.saved_activation_bytes`` (train only): the bytes the forward
    saves for the backward (``torch.autograd.graph.saved_tensors_hooks``;
    each storage once, arguments left out), of which
    ``saved_layer_boundary_bytes`` are the layers' inputs that remat keeps
    (``models/transformer.py::observe_layer_inputs``). Per device
    (``saved_activation_bytes_per_device``) the batch splits over the data
    axes and, under ``seq_parallel``, the layer-boundary saves also over
    the model axis. The model axis splits no other save (logits over
    vocab, heads, d_ff intermediates and expert buffers are counted
    whole), so the figure overstates a device's share on a mesh with a
    model axis; ``saved_activation_split`` says so;
  * ``collectives``: the MoE all-to-all count and bytes per device of the
    layout (``comm/cost.py::step_cost``: a train step's backward doubles
    the forward's, remat's recomputation adds one more forward). No
    GSPMD-inserted collective and no ``temp`` bytes: the meta device has
    no counterpart of them.

FLOPs and saved bytes are counted on shallow variants of the config
(``_variant_cfgs``) and extrapolated to full depth through the per-type
layer counts (``_type_counts``), as the reference costs depth: each is
exactly linear in those counts, and the linear system is solved in
rational arithmetic, so the extrapolation equals a full-depth count.
Parameters, state and caches are built at full depth. The MoE layers run
the plain path (``moe_backend`` "oracle": the kernels have no meta
implementation), and the Gating Dropout decision is a host bool, so the
step takes one branch: ``routed`` by default, the costlier one that pays
the all-to-all (``--decision dropped`` for the other).

``--lint-table`` prints the lint gate's static pass x executable matrix
(``analysis/lint.py::lint_table``). The reference's comes from lowering
alone; the port's runs each executable once, on ``--lint-device`` (the
card by default, never falling back to the CPU).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from collections import Counter
from fractions import Fraction
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from repro_torch.comm.cost import layer_cost, step_cost
from repro_torch.configs import (INPUT_SHAPES, InputShape, ModelConfig,
                                 TrainConfig, applicable_pairs, get_config,
                                 shape_applicable)
from repro_torch.launch.mesh import EP_AXIS, TP_AXIS, MeshShape, production_mesh
from repro_torch.models import flash as FL
from repro_torch.models import transformer as T
from repro_torch.models.model import (decode_step, init_cache, init_model,
                                      init_model_meta, prefill)
from repro_torch.obs import MetricsRegistry, Tracer, get_tracer, monotonic, set_tracer
from repro_torch.parallel.sharding import (axis_size, batch_specs, cache_specs,
                                           param_specs, shard_bytes, state_specs,
                                           tree_bytes)
from repro_torch.training.steps import (init_train_state, make_train_step,
                                        n_moe_layers)
from repro_torch.tree import flatten_with_paths

ART_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
META = torch.device("meta")
DECISIONS = {"routed": False, "dropped": True}


# ---------------------------------------------------------------------------
# inputs, state and arguments on the meta device
# ---------------------------------------------------------------------------

def input_batch(cfg: ModelConfig, shape: InputShape, device=META,
                gen: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """The model inputs of this (arch, shape), with the reference's shapes
    and dtypes (``input_specs``): int32 ids, f32 loss mask, the image
    embeddings or audio frames in the activation dtype. Empty on the meta
    device; elsewhere drawn from ``gen`` (ids in [3, vocab), mask 1)."""
    B, L = shape.global_batch, shape.seq_len
    dt = cfg.torch_dtype
    ids = lambda *s: _ids(cfg, s, device, gen)  # noqa: E731

    def floats(*s):
        if gen is None:
            return torch.empty(s, dtype=dt, device=device)
        return torch.randn(s, generator=gen, device=device).to(dt)

    batch = {"tokens": ids(B, L)}
    if shape.kind == "train":
        batch["labels"] = ids(B, L)
        batch["loss_mask"] = (torch.empty if gen is None else torch.ones)(
            (B, L), dtype=torch.float32, device=device)
    if cfg.vlm is not None:
        batch["img_embeds"] = floats(B, cfg.vlm.n_image_tokens, cfg.vlm.d_image)
    if cfg.encdec is not None:
        if cfg.encdec.frontend == "stub":
            batch["frames"] = floats(B, cfg.encdec.encoder_seq, cfg.d_model)
        else:
            batch["enc_tokens"] = ids(B, cfg.encdec.encoder_seq)
    return batch


def _ids(cfg: ModelConfig, dims, device, gen: Optional[torch.Generator]) -> torch.Tensor:
    """int32 token ids: empty on the meta device, else drawn in [3, vocab)."""
    if gen is None:
        return torch.empty(dims, dtype=torch.int32, device=device)
    return torch.randint(3, cfg.vocab, dims, generator=gen, device=device,
                         dtype=torch.int32)


def train_config(cfg: ModelConfig) -> TrainConfig:
    """The reference's dry-run optimizer: bf16 moments on the fsdp archs."""
    return TrainConfig(moment_dtype="bfloat16" if cfg.fsdp else "float32")


def step_arguments(cfg: ModelConfig, shape: InputShape, device=META,
                   seed: int = 0) -> Dict[str, Any]:
    """The step's arguments, the reference's: the train state and batch;
    the parameters and batch of a prefill; the parameters, the ``seq_len``
    cache, the (B, 1) int32 token and the int32 position of a decode step.
    On the meta device nothing is drawn or allocated; elsewhere the
    weights and inputs are drawn from ``seed`` (to count a step's work on
    real tensors)."""
    meta = torch.device(device).type == "meta"
    gen = None if meta else torch.Generator(device=device).manual_seed(seed)
    params = init_model_meta(cfg) if meta else init_model(gen, cfg)
    if shape.kind == "train":
        return {"state": init_train_state(params, train_config(cfg)),
                "batch": input_batch(cfg, shape, device, gen)}
    args = {"params": params}
    if shape.kind == "prefill":
        args["batch"] = input_batch(cfg, shape, device, gen)
    else:
        args["caches"] = init_cache(cfg, shape.global_batch, shape.seq_len, device=device)
        args["token"] = _ids(cfg, (shape.global_batch, 1), device, gen)
        args["index"] = torch.full((), shape.seq_len - 1, dtype=torch.int32, device=device)
    return args


def argument_bytes(cfg: ModelConfig, mesh: MeshShape, args: Dict[str, Any]) -> int:
    """Bytes per device of the step's arguments: the state, parameters,
    batch and cache under the rules' specs; the decode token and
    position replicated."""
    rules = {"state": state_specs, "params": param_specs, "batch": batch_specs,
             "caches": cache_specs}
    total = 0
    for name, tree in args.items():
        specs = (rules[name](cfg, mesh, tree) if name in rules
                 else {"": (None,) * tree.dim()})
        total += tree_bytes(tree, specs, mesh)
    return total


# ---------------------------------------------------------------------------
# one step on the meta device: FLOPs and saved activations
# ---------------------------------------------------------------------------

class SavedActivations:
    """``saved_tensors_hooks`` that record, once per storage, what the
    forward saves for the backward, leaving out the arguments' storages;
    recording stops at the first unpack (the backward has begun).
    ``boundary`` holds the storages of the layers' inputs."""

    def __init__(self, arguments: Iterable[torch.Tensor]):
        self.skip = {t.untyped_storage()._cdata for t in arguments}
        self.saved: Dict[int, torch.Tensor] = {}
        self.boundary: Dict[int, torch.Tensor] = {}
        self.recording = True

    def pack(self, t: torch.Tensor) -> torch.Tensor:
        if self.recording:
            key = t.untyped_storage()._cdata
            if key not in self.skip and key not in self.saved:
                self.saved[key] = t
        return t

    def unpack(self, t: torch.Tensor) -> torch.Tensor:
        self.recording = False
        return t

    def layer_input(self, x: torch.Tensor) -> None:
        self.boundary.setdefault(x.untyped_storage()._cdata, x)

    def split(self, cfg: ModelConfig, shape: InputShape,
              meshes: Sequence[MeshShape]) -> Dict[str, Any]:
        """Total and layer-boundary bytes, and bytes per device on each
        mesh: the batch over the data axes, and under ``seq_parallel`` a
        layer input's sequence over the model axis where it divides (the
        model axis splits nothing else, an overestimate)."""
        nbytes = {k: t.untyped_storage().nbytes() for k, t in self.saved.items()}
        bound = {k for k in nbytes if k in self.boundary}
        out = {"saved": sum(nbytes.values()),
               "boundary": sum(nbytes[k] for k in bound)}
        for mesh in meshes:
            dp = mesh.dp_axes
            batch_div = (axis_size(mesh, dp)
                         if shape.global_batch % axis_size(mesh, dp) == 0 else 1)
            per_dev = Fraction(0)
            for k, n in nbytes.items():
                if k not in bound:
                    per_dev += Fraction(n, batch_div)
                    continue
                x = self.boundary[k]
                b_ax = dp if x.shape[0] % axis_size(mesh, dp) == 0 else None
                s_ax = None
                if (cfg.seq_parallel and TP_AXIS in mesh.axis_names
                        and x.shape[1] % mesh.shape[TP_AXIS] == 0):
                    s_ax = TP_AXIS
                spec = (b_ax, s_ax) + (None,) * (x.dim() - 2)
                per_dev += Fraction(n * shard_bytes(x, spec, mesh),
                                    x.numel() * x.element_size())
            out[f"saved_per_device/{mesh.name}"] = per_dev
        return out


def _arg_tensors(args: Dict[str, Any]) -> List[torch.Tensor]:
    return [t for t in flatten_with_paths(args).values() if isinstance(t, torch.Tensor)]


def run_step(cfg: ModelConfig, shape: InputShape, decision: bool = False,
             meshes: Sequence[MeshShape] = (), device=META) -> Dict[str, Any]:
    """Run the step of ``shape`` once, on the meta device unless ``device``
    names another (seeded weights and inputs there): its matmul FLOPs and,
    for a train step, its saved activations (``SavedActivations.split``
    over ``meshes``)."""
    from torch.utils.flop_counter import FlopCounterMode
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, backend="oracle"))
    args = step_arguments(cfg, shape, device)
    out: Dict[str, Any] = {}
    with FL.full_bands(), FlopCounterMode(display=False) as fc:
        if shape.kind == "train":
            rec = SavedActivations(_arg_tensors(args))
            step = make_train_step(cfg, train_config(cfg))
            with torch.autograd.graph.saved_tensors_hooks(rec.pack, rec.unpack), \
                    T.observe_layer_inputs(rec.layer_input):
                step(args["state"], args["batch"], decision)
            out.update(rec.split(cfg, shape, meshes))
        else:
            with torch.no_grad():
                if shape.kind == "prefill":
                    logits, _ = prefill(args["params"], args["batch"], cfg,
                                        max_seq=shape.seq_len)
                else:
                    logits, _ = decode_step(args["params"], args["caches"], args["token"],
                                            shape.seq_len - 1, cfg)
            if logits.shape != (shape.global_batch, 1, cfg.vocab):
                raise AssertionError(f"{cfg.arch_id} {shape.name}: logits {tuple(logits.shape)}")
    out["flops"] = fc.get_total_flops()
    return out


# ---------------------------------------------------------------------------
# depth by per-layer-type extrapolation
# ---------------------------------------------------------------------------

def _variant_cfgs(cfg: ModelConfig) -> List[ModelConfig]:
    """Shallow variants that keep the config's layer types (the
    reference's, without ``scan_layers``: eager PyTorch has no scan)."""
    mk = lambda **kw: dataclasses.replace(cfg, **kw)  # noqa: E731
    if cfg.encdec is not None:
        e = cfg.encdec
        return [mk(n_layers=2, encdec=dataclasses.replace(e, n_encoder_layers=2)),
                mk(n_layers=2, encdec=dataclasses.replace(e, n_encoder_layers=4)),
                mk(n_layers=4, encdec=dataclasses.replace(e, n_encoder_layers=2))]
    if cfg.vlm is not None:
        v = cfg.vlm
        return [mk(n_layers=5), mk(n_layers=10),
                mk(n_layers=4, vlm=dataclasses.replace(v, cross_attn_period=2))]
    if cfg.hybrid is not None:
        h = cfg.hybrid
        return [mk(n_layers=4, hybrid=dataclasses.replace(h, global_attn_layers=(0,))),
                mk(n_layers=5, hybrid=dataclasses.replace(h, global_attn_layers=(0,))),
                mk(n_layers=5, hybrid=dataclasses.replace(h, global_attn_layers=(0, 4)))]
    if cfg.moe is not None and cfg.moe.first_dense_layers > 0:
        m1 = dataclasses.replace(cfg.moe, first_dense_layers=1)
        m2 = dataclasses.replace(cfg.moe, first_dense_layers=2)
        return [mk(n_layers=2, moe=m1), mk(n_layers=3, moe=m1), mk(n_layers=3, moe=m2)]
    if cfg.moe is not None and cfg.moe.moe_layer_period > 1:
        return [mk(n_layers=2), mk(n_layers=4), mk(n_layers=6)]
    return [mk(n_layers=2), mk(n_layers=4)]


def _type_counts(cfg: ModelConfig) -> Dict[Any, int]:
    """{("dec" | "enc", LayerSpec): layers} over the decoder (and encoder)
    plans."""
    c: Counter = Counter()
    for seg in T.layer_plan(cfg):
        for spec in seg.pattern:
            c[("dec", spec)] += seg.repeats
    if cfg.encdec is not None:
        for seg in T.layer_plan(cfg, encoder=True):
            for spec in seg.pattern:
                c[("enc", spec)] += seg.repeats
    return dict(c)


def _combination(rows: List[List[int]], target: List[int]) -> List[Fraction]:
    """Weights w with sum_i w_i rows[i] == target, in exact rational
    arithmetic (free weights 0); raises where the target is no
    combination of the rows. A metric linear in the rows' entries then
    has target's value sum_i w_i metric_i, whichever solution w is."""
    n_eq, n_var = len(target), len(rows)
    m = [[Fraction(rows[j][i]) for j in range(n_var)] + [Fraction(target[i])]
         for i in range(n_eq)]
    pivots, r = [], 0
    for c in range(n_var):
        p = next((i for i in range(r, n_eq) if m[i][c] != 0), None)
        if p is None:
            continue
        m[r], m[p] = m[p], m[r]
        m[r] = [v / m[r][c] for v in m[r]]
        for i in range(n_eq):
            if i != r and m[i][c] != 0:
                m[i] = [a - m[i][c] * b for a, b in zip(m[i], m[r])]
        pivots.append(c)
        r += 1
    if any(m[i][-1] != 0 for i in range(r, n_eq)):
        raise ValueError("the full depth's layer counts are no combination of "
                         "the variants'")
    w = [Fraction(0)] * n_var
    for i, c in enumerate(pivots):
        w[c] = m[i][-1]
    return w


def extrapolate(variants: List[ModelConfig], full: ModelConfig,
                metrics: List[Dict[str, Any]]) -> Dict[str, int]:
    """The variants' metrics (``metrics[i]`` of ``variants[i]``),
    extrapolated to ``full``'s layer-type counts."""
    full_counts = _type_counts(full)
    types = sorted(full_counts, key=str)
    rows = []
    for vc in variants:
        counts = _type_counts(vc)
        if not set(counts) <= set(full_counts):
            raise ValueError(f"{full.arch_id}: a variant has a layer type the config lacks")
        rows.append([1] + [counts.get(t, 0) for t in types])
    w = _combination(rows, [1] + [full_counts[t] for t in types])
    return {k: round(sum(wi * Fraction(m[k]) for wi, m in zip(w, metrics)))
            for k in metrics[0]}


def measure(cfg: ModelConfig, shape: InputShape, decision: bool = False,
            meshes: Sequence[MeshShape] = ()) -> Dict[str, int]:
    """``run_step``'s counts at ``cfg``'s full depth, by extrapolation over
    its variants."""
    variants = _variant_cfgs(cfg)
    return extrapolate(variants, cfg, [run_step(vc, shape, decision, meshes)
                                       for vc in variants])


# ---------------------------------------------------------------------------
# collectives of the layout
# ---------------------------------------------------------------------------

def a2a_per_device(cfg: ModelConfig, shape: InputShape, mesh: MeshShape,
                   decision: bool) -> Dict[str, Any]:
    """The MoE all-to-alls of one step per device: the expert-parallel
    group is the data axis (data x model under ``ep_on_model``, whose
    layers split their tokens over the model axis too), a shard's tokens
    the step's over the data axes; a dropped step sends nothing."""
    zero = {"count": 0, "bytes": 0.0, "wire_bytes": 0.0}
    if cfg.moe is None or decision:
        return {"all-to-all": zero}
    ep = mesh.shape[EP_AXIS]
    tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    per_shard = max(tokens // axis_size(mesh, mesh.dp_axes), 1)
    if cfg.moe.ep_on_model and TP_AXIS in mesh.axis_names:
        ep *= mesh.shape[TP_AXIS]
        per_shard = max(per_shard // mesh.shape[TP_AXIS], 1)
    train = shape.kind == "train"
    c = step_cost(cfg, tokens_per_shard=per_shard, ep=ep, is_training=train,
                  backward=train)
    if train and cfg.remat:          # the recomputed forward's all-to-alls
        per = layer_cost(cfg, tokens_per_shard=per_shard, ep=ep, is_training=True)
        c = {k: v + per[k] * n_moe_layers(cfg) for k, v in c.items()}
    return {"all-to-all": {"count": int(c["calls"]), "bytes": c["bytes"],
                           "wire_bytes": c["wire_bytes"]},
            "ep": ep, "tokens_per_shard": per_shard}


# ---------------------------------------------------------------------------
# artifacts
# ---------------------------------------------------------------------------

def dry_run(cfg: ModelConfig, shape: InputShape, meshes: Sequence[MeshShape], *,
            decision: bool = False, tag: str = "", out_dir: Optional[Path] = None,
            measured: Optional[Dict[str, int]] = None,
            seconds: float = 0.0) -> List[Dict[str, Any]]:
    """One artifact per mesh of (cfg, shape): FLOPs and saved bytes counted
    once (``measure``, unless ``measured`` holds them already, taken in
    ``seconds``), the arguments and collectives per mesh; written under
    ``out_dir`` when given. ``seconds`` in the artifact is the pair's
    time: its steps' and its arguments'."""
    tr = get_tracer()
    t0 = monotonic()
    if measured is None:
        with tr.span("dryrun.measure", arch=cfg.arch_id, shape=shape.name):
            measured = measure(cfg, shape, decision, meshes)
    with tr.span("dryrun.arguments", arch=cfg.arch_id, shape=shape.name):
        args = step_arguments(cfg, shape)
        arg_bytes = [argument_bytes(cfg, mesh, args) for mesh in meshes]
    seconds += monotonic() - t0
    out = []
    for mesh, nbytes in zip(meshes, arg_bytes):
        memory = {"argument_bytes_per_device": nbytes}
        if shape.kind == "train":
            memory.update(
                saved_activation_bytes=measured["saved"],
                saved_layer_boundary_bytes=measured["boundary"],
                saved_activation_bytes_per_device=measured[f"saved_per_device/{mesh.name}"],
                saved_activation_split=(
                    f"batch over {'x'.join(mesh.dp_axes)}"
                    + (f"; layer-boundary saves also over {TP_AXIS}"
                       if cfg.seq_parallel else "")
                    + (f"; {TP_AXIS} axis not applied to the other saves "
                       "(overstates a device's share)"
                       if TP_AXIS in mesh.axis_names else "")))
        res = {
            "arch": cfg.arch_id, "shape": shape.name, "kind": shape.kind,
            "mesh": mesh.shape, "n_devices": mesh.size, "tag": tag,
            "tokens_per_step": shape.global_batch * (1 if shape.kind == "decode"
                                                     else shape.seq_len),
            "n_params": cfg.n_params(), "n_active_params": cfg.n_active_params(),
            "flops_step": measured["flops"],
            "memory": memory,
            "collectives": a2a_per_device(cfg, shape, mesh, decision),
            "method": "meta device; layer-type extrapolation",
            "variants": len(_variant_cfgs(cfg)),
            "decision": "dropped" if decision else "routed",
            "moe_backend": "oracle" if cfg.moe is not None else None,
            "remat": cfg.remat, "fsdp": cfg.fsdp, "seq_parallel": cfg.seq_parallel,
            "dtype": cfg.dtype, "seconds": seconds,
        }
        if out_dir is not None:
            with open(art_path(out_dir, cfg.arch_id, shape.name, mesh.name, tag), "w") as f:
                json.dump(res, f, indent=1)
        out.append(res)
    return out


def _step_task(task) -> Tuple[Optional[Dict[str, Any]], float, str]:
    """One variant's ``run_step`` in a worker process: its counts (None if
    it raised), its seconds and the error."""
    cfg, shape, decision, meshes = task
    t0 = monotonic()
    try:
        out, err = run_step(cfg, shape, decision, meshes), ""
    except Exception as e:  # noqa: BLE001  (reported per pair by run_all)
        out, err = None, f"{type(e).__name__}: {str(e)[:300]}"
    return out, monotonic() - t0, err


def _task_cost(task) -> Tuple[int, int]:
    """Sort key, costliest first: 32k prefills (the blocked attention's
    many blocks), then train steps, then decode steps; deeper first."""
    cfg, shape = task[0], task[1]
    rank = {"prefill": 0, "train": 1, "decode": 2}[shape.kind]
    depth = cfg.n_layers + (cfg.encdec.n_encoder_layers if cfg.encdec else 0)
    return rank, -depth


def run_all(jobs: Sequence[Tuple[ModelConfig, InputShape]],
            meshes: Sequence[MeshShape], *, decision: bool = False, tag: str = "",
            out_dir: Optional[Path] = None, workers: Optional[int] = None
            ) -> Tuple[List[Optional[List[Dict[str, Any]]]], List[str]]:
    """``dry_run`` of every (cfg, shape) job, the variants' steps spread
    over ``workers`` processes (default one per CPU core; spawned, and no
    worker touches a device), the costliest first. Returns per job its
    artifacts, one per mesh (None where a step raised), and the
    failures, one line each."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    tasks = [(vc, shape, decision, tuple(meshes))
             for cfg, shape in jobs for vc in _variant_cfgs(cfg)]
    order = sorted(range(len(tasks)), key=lambda i: _task_cost(tasks[i]))
    results: List[Any] = [None] * len(tasks)
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(min(workers or os.cpu_count() or 1, len(tasks)),
                             mp_context=ctx, initializer=torch.set_num_threads,
                             initargs=(1,)) as pool:
        for i, r in zip(order, pool.map(_step_task, [tasks[i] for i in order])):
            results[i] = r
    out, failures, k = [], [], 0
    for cfg, shape in jobs:
        variants = _variant_cfgs(cfg)
        got = results[k:k + len(variants)]
        k += len(variants)
        errs = [e for _, _, e in got if e]
        try:
            if errs:
                raise RuntimeError(errs[0])
            measured = extrapolate(variants, cfg, [m for m, _, _ in got])
            out.append(dry_run(cfg, shape, meshes, decision=decision, tag=tag,
                               out_dir=out_dir, measured=measured,
                               seconds=sum(t for _, t, _ in got)))
        except Exception as e:  # noqa: BLE001
            out.append(None)
            failures.append(f"{cfg.arch_id} x {shape.name}: {type(e).__name__}: "
                            f"{str(e)[:300]}")
    return out, failures


def art_path(out_dir: Path, arch: str, shape: str, mesh_name: str, tag: str = "") -> Path:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    suff = f"__{tag}" if tag else ""
    return out_dir / f"{arch}__{shape}__{mesh_name}{suff}.json"


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            decision: bool = False, tag: str = "", verbose: bool = True,
            overrides: Optional[Dict[str, Any]] = None,
            registry: Optional[MetricsRegistry] = None,
            out_dir: Optional[Path] = ART_DIR) -> Dict[str, Any]:
    """The artifact of one (arch, shape) on a production mesh; refuses a
    pair the reference marks inapplicable."""
    if not shape_applicable(arch, shape_name):
        raise ValueError(f"{arch} x {shape_name} marked inapplicable (the reference's "
                         "DESIGN.md §3: long_500k needs sub-quadratic attention)")
    cfg = _with(get_config(arch), overrides)
    mesh = production_mesh(multi_pod=multi_pod)
    res = dry_run(cfg, INPUT_SHAPES[shape_name], [mesh], decision=decision, tag=tag,
                  out_dir=out_dir)[0]
    if registry is not None:
        registry.counter("dryrun/combos").inc()
        registry.histogram("dryrun/seconds").observe(res["seconds"])
    if verbose:
        print(summary(res, mesh.name), flush=True)
    return res


def _with(cfg: ModelConfig, overrides: Optional[Dict[str, Any]]) -> ModelConfig:
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def summary(res: Dict[str, Any], mesh_name: str) -> str:
    mem = res["memory"]
    a2a = res["collectives"]["all-to-all"]
    saved = (f" saved/dev<={mem['saved_activation_bytes_per_device'] / 2**30:.2f}GiB"
             if "saved_activation_bytes_per_device" in mem else "")
    tag = f" {res['tag']}" if res["tag"] else ""
    return (f"[dryrun] {res['arch']} x {res['shape']} x {mesh_name}{tag}: OK  "
            f"flops/step={res['flops_step']:.4g} "
            f"arg/dev={mem['argument_bytes_per_device'] / 2**30:.2f}GiB{saved} "
            f"a2a={a2a['count']}ops/{a2a['bytes'] / 2**20:.1f}MiB "
            f"({res['seconds']:.2f}s)")


def comm_table(arch: str, shape_name: str, *, multi_pod: bool = False,
               quant: str = "int8", n_chunks: int = 0) -> Dict[str, Any]:
    """Per-substrate predicted wire bytes for (arch x shape) on the
    production mesh, the reference's what-if table: pure cost-model math
    (``comm/cost.py``); nothing is built or run."""
    from repro_torch.comm import format_table, substrate_table
    cfg = get_config(arch)
    if cfg.moe is None:
        raise ValueError(f"{arch} has no MoE layer to dispatch")
    shape = INPUT_SHAPES[shape_name]
    mesh = production_mesh(multi_pod=multi_pod)
    dp = axis_size(mesh, mesh.dp_axes)       # batch-sharding axes
    ep = mesh.shape[EP_AXIS]                 # EP group == data axis
    tokens = (shape.global_batch if shape.kind == "decode"
              else shape.global_batch * shape.seq_len)
    per_shard = max(tokens // dp, 1)
    table = substrate_table(cfg, tokens_per_shard=per_shard, ep=ep,
                            is_training=shape.kind == "train",
                            quant=quant, n_chunks=n_chunks)
    nc = n_chunks or cfg.moe.comm.n_chunks
    print(f"[comm-table] {arch} x {shape_name} x {mesh.name}: "
          f"{per_shard} tokens/device, ep={ep}, quant={quant}, "
          f"n_chunks={nc} "
          f"(per-device FORWARD bytes per step; train backward doubles)")
    print(format_table(table))
    return table


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true",
                    help="run every applicable (arch x shape)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--comm-table", action="store_true",
                    help="print the per-substrate predicted bytes table for "
                         "--arch x --shape (comm/cost.py; no step)")
    ap.add_argument("--comm-quant", default="int8", choices=["int8", "fp8"],
                    help="wire dtype the --comm-table prices compressed "
                         "substrates at")
    ap.add_argument("--comm-chunks", type=int, default=0,
                    help="capacity micro-chunks the --comm-table prices "
                         "overlapped substrates at (0 = config default)")
    ap.add_argument("--lint-table", action="store_true",
                    help="print the static lint pass x executable matrix "
                         "(analysis/lint.py; runs each executable once)")
    ap.add_argument("--lint-device", choices=("cuda", "cpu"), default="cuda",
                    help="where --lint-table runs the executables")
    ap.add_argument("--tag", default="")
    ap.add_argument("--decision", default="routed", choices=list(DECISIONS),
                    help="the Gating Dropout branch of the step (a host bool "
                         "here: one branch runs)")
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--out-dir", default=str(ART_DIR),
                    help="directory of the JSON artifacts")
    ap.add_argument("--trace-out", default=None,
                    help="enable the span tracer and write a Chrome-trace/"
                         "Perfetto JSON of the dry run's timing here")
    ap.add_argument("--metrics-out", default=None,
                    help="write the dry run's timing histograms here "
                         "(.prom/.txt = Prometheus text, else JSON)")
    args = ap.parse_args(argv)
    set_tracer(Tracer(enabled=bool(args.trace_out)))
    reg = MetricsRegistry()
    if args.comm_table:
        if not (args.arch and args.shape):
            ap.error("--comm-table needs --arch and --shape")
        comm_table(args.arch, args.shape, multi_pod=args.multi_pod,
                   quant=args.comm_quant, n_chunks=args.comm_chunks)
        return 0
    if args.lint_table:
        from repro_torch.analysis.lint import check_device, format_lint_table, lint_table
        try:
            check_device(args.lint_device)
        except RuntimeError as e:
            print(f"dryrun: {e} (pass --lint-device cpu to lint on the CPU)",
                  file=sys.stderr)
            return 2
        print(format_lint_table(lint_table(device=args.lint_device)))
        return 0
    overrides: Dict[str, Any] = {}
    if args.seq_parallel:
        overrides["seq_parallel"] = True
    if args.no_remat:
        overrides["remat"] = False
    if args.dtype:
        overrides["dtype"] = args.dtype
    kw = dict(multi_pod=args.multi_pod, decision=DECISIONS[args.decision],
              tag=args.tag, overrides=overrides, registry=reg,
              out_dir=Path(args.out_dir))
    if args.all:
        mesh = production_mesh(multi_pod=args.multi_pod)
        jobs = [(_with(get_config(a), overrides), INPUT_SHAPES[s])
                for a, s in applicable_pairs()]
        t0 = monotonic()
        with get_tracer().span("dryrun.all", pairs=len(jobs)):
            results, failures = run_all(jobs, [mesh], decision=kw["decision"],
                                        tag=args.tag, out_dir=Path(args.out_dir))
        for got in results:
            if got is not None:
                reg.counter("dryrun/combos").inc()
                reg.histogram("dryrun/seconds").observe(got[0]["seconds"])
                print(summary(got[0], mesh.name), flush=True)
        for line in failures:
            print(f"[dryrun] {line}: FAIL", flush=True)
        print(f"[dryrun] done: {len(results) - len(failures)} ok, {len(failures)} failed "
              f"in {monotonic() - t0:.1f} s on {os.cpu_count()} processes", flush=True)
        _obs_out(args, reg)
        return 1 if failures else 0
    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all)")
    if not shape_applicable(args.arch, args.shape):
        ap.error(f"{args.arch} x {args.shape} marked inapplicable (long_500k needs "
                 "sub-quadratic attention)")
    res = run_one(args.arch, args.shape, **kw)
    print(json.dumps({k: v for k, v in res.items() if k != "collectives"}, indent=1))
    print(json.dumps(res["collectives"], indent=1))
    _obs_out(args, reg)
    return 0


def _obs_out(args, reg: MetricsRegistry) -> None:
    if args.trace_out:
        get_tracer().export(args.trace_out)
    if args.metrics_out:
        if args.metrics_out.endswith((".prom", ".txt")):
            reg.to_prometheus(args.metrics_out)
        else:
            reg.to_json(args.metrics_out)


if __name__ == "__main__":
    raise SystemExit(main())
