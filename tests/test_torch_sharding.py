"""The sharding rules of the port (``repro_torch/parallel/sharding.py``), its
production meshes and the dry run's meta trees, against the JAX package,
on the CPU at full size: nothing is allocated on either side (the
reference's trees are ``jax.eval_shape`` structs over its abstract
production meshes, the port's live on ``torch.device("meta")``).

  * spec parity: for the 10 assigned archs on (data 16, model 16) and
    (pod 2, data 16, model 16), the parameter, train-state, batch and cache
    specs (decode_32k, and long_500k where it applies: the cache's
    fallback to sequence sharding) equal the reference's, leaf for leaf by
    path; dbrx-132b also under ``ep_on_model``;
  * shape parity: the port's meta parameter, state, cache and input trees
    equal the reference's in keys, shapes and dtypes, and the parameter
    counts are equal;
  * bytes: the dry run's argument bytes per device equal the sum of shard
    sizes computed here from the reference's specs and trees;
  * the configs' ``InputShape``, ``ASSIGNED_ARCHS``, ``applicable_pairs``
    and ``fsdp`` / ``seq_parallel`` against the reference's.

Every comparison is exact.
"""
import dataclasses
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import ASSIGNED_ARCHS as JAX_ASSIGNED  # noqa: E402
from repro.configs import INPUT_SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import applicable_pairs as jax_applicable_pairs  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.configs.base import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.core.moe import ParallelContext as JaxParallelContext  # noqa: E402
from repro.launch.mesh import abstract_mesh  # noqa: E402
from repro.models.model import init_cache as jax_init_cache  # noqa: E402
from repro.models.model import init_model as jax_init_model  # noqa: E402
from repro.parallel import sharding as JS  # noqa: E402
from repro.training.steps import init_train_state as jax_init_train_state  # noqa: E402
from repro_torch.configs import (ARCHS, ASSIGNED_ARCHS, INPUT_SHAPES,  # noqa: E402
                                 applicable_pairs, get_config, reduced,
                                 shape_applicable)
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.mesh import MeshShape, production_mesh  # noqa: E402
from repro_torch.parallel import sharding as S  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402

MESHES = {"pod256": ((16, 16), ("data", "model")),
          "pod512": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several workers on few
    cores, and torch's thread pool would contend with theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_input_specs():
    """The reference's ``input_specs``. Importing ``repro.launch.dryrun``
    sets XLA_FLAGS for its own CLI (512 host devices); the variable is put
    back at once, before any backend reads it."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import input_specs
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return input_specs


def _key(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def _flat_structs(tree):
    """{path: (shape, dtype name)} of a reference ShapeDtypeStruct tree."""
    return {_key(p): (tuple(l.shape), np.dtype(l.dtype).name)
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_specs(tree):
    return {_key(p): s for p, s in jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda s: isinstance(s, P))[0]}


def _norm(spec, ndim):
    """A reference PartitionSpec as the port's tuple: one entry per
    dimension, trailing ones replicated, a one-axis tuple its name."""
    ent = tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a for a in tuple(spec))
    return ent + (None,) * (ndim - len(ent))


def _port_structs(tree):
    """{path: (shape, dtype name)} of a port tree; a host int is an int32
    scalar, as the reference's step counters."""
    out = {}
    for k, v in flatten_with_paths(tree).items():
        if isinstance(v, torch.Tensor):
            out[k] = (tuple(v.shape), str(v.dtype).replace("torch.", ""))
        else:
            out[k] = ((), "int32")
    return out


def _ref_tc(cfg):
    return JaxTrainConfig(moment_dtype="bfloat16" if cfg.fsdp else "float32")


@pytest.fixture(scope="module")
def ref():
    """The reference's abstract trees per arch: train state (its params
    inside), the caches of the decode shapes, the inputs of every shape."""
    input_specs = _ref_input_specs()
    key = jax.random.PRNGKey(0)
    out = {}
    for arch in ASSIGNED_ARCHS + ("dbrx-132b-ep_on_model",):
        cfg = _ref_cfg(arch)
        state = jax.eval_shape(lambda: jax_init_train_state(jax_init_model(key, cfg),
                                                            _ref_tc(cfg)))
        caches = {s: jax.eval_shape(lambda s=s: jax_init_cache(
                      cfg, JAX_SHAPES[s].global_batch, JAX_SHAPES[s].seq_len))
                  for s in ("decode_32k", "long_500k") if shape_applicable(arch, s)}
        inputs = {s: input_specs(cfg, JAX_SHAPES[s]) for s in JAX_SHAPES}
        out[arch] = dict(cfg=cfg, state=state, caches=caches, inputs=inputs)
    return out


def _ref_cfg(arch):
    if arch.endswith("-ep_on_model"):
        cfg = jax_get_config(arch.split("-ep_on_model")[0])
        return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, ep_on_model=True))
    return jax_get_config(arch)


def _port_cfg(arch):
    if arch.endswith("-ep_on_model"):
        cfg = get_config(arch.split("-ep_on_model")[0])
        return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, ep_on_model=True))
    return get_config(arch)


@pytest.fixture(scope="module")
def port():
    """The port's meta trees per arch: the dry run's arguments of every
    applicable shape."""
    out = {}
    for arch in ASSIGNED_ARCHS + ("dbrx-132b-ep_on_model",):
        cfg = _port_cfg(arch)
        out[arch] = {s: D.step_arguments(cfg, INPUT_SHAPES[s]) for s in INPUT_SHAPES
                     if shape_applicable(arch.split("-ep_on_model")[0], s)}
    return out


def _check_specs(port_specs, ref_specs, ref_structs, what):
    assert sorted(port_specs) == sorted(ref_specs), what
    for k, spec in port_specs.items():
        want = _norm(ref_specs[k], len(ref_structs[k][0]))
        assert spec == want, f"{what} {k}: {spec} != {want}"


def _spec_parity(arch, mesh_name, ref, port):
    shape, axes = MESHES[mesh_name]
    jctx = JaxParallelContext(mesh=abstract_mesh(shape, axes))
    mesh = MeshShape(axes, shape)
    r, t = ref[arch], port[arch]
    cfg, jcfg = _port_cfg(arch), r["cfg"]
    structs = _flat_structs(r["state"])
    # parameters, then the train state (params, both moments, step counters)
    pstructs = _flat_structs(r["state"]["params"])
    _check_specs(S.param_specs(cfg, mesh, t["train_4k"]["state"]["params"]),
                 _flat_specs(JS.param_specs(jcfg, jctx, r["state"]["params"])),
                 pstructs, f"{arch} {mesh_name} params")
    _check_specs(S.state_specs(cfg, mesh, t["train_4k"]["state"]),
                 _flat_specs(JS.state_specs(jcfg, jctx, r["state"])), structs,
                 f"{arch} {mesh_name} state")
    for s in t:
        batch = t[s].get("batch")
        if batch is not None:
            _check_specs(S.batch_specs(cfg, mesh, batch),
                         _flat_specs(JS.batch_specs(jcfg, jctx, r["inputs"][s])),
                         _flat_structs(r["inputs"][s]), f"{arch} {mesh_name} {s} batch")
        if "caches" in t[s]:
            _check_specs(S.cache_specs(cfg, mesh, t[s]["caches"]),
                         _flat_specs(JS.cache_specs(jcfg, jctx, r["caches"][s])),
                         _flat_structs(r["caches"][s]), f"{arch} {mesh_name} {s} cache")


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_specs_match_reference(arch, mesh_name, ref, port):
    """Parameter, state, batch and cache specs, leaf for leaf by path."""
    _spec_parity(arch, mesh_name, ref, port)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_specs_match_reference_ep_on_model(mesh_name, ref, port):
    """dbrx-132b with whole experts over (data, model): no tensor
    parallelism inside the experts, and its 16 experts do not split 256
    ways, so they replicate (the ``div`` fallback); 256 would split."""
    _spec_parity("dbrx-132b-ep_on_model", mesh_name, ref, port)
    mesh = MeshShape(*reversed(MESHES[mesh_name]))
    cfg = _port_cfg("dbrx-132b-ep_on_model")
    specs = S.param_specs(cfg, mesh, port["dbrx-132b-ep_on_model"]["train_4k"]["state"]["params"])
    assert specs["decoder/0/p0/moe/experts/w_in"] == (None, None, None, None)
    b = S.SpecBuilder(cfg, mesh)
    assert b.param_spec(("decoder", "0", "p0", "moe", "experts", "w_out"),
                        (40, 256, 10752, 6144)) == (None, ("data", "model"), None, None)


def test_fallbacks_and_layouts():
    """The rules' edge cases by name: hymba's 25 heads replicate over a
    16-way model axis, fsdp shards dbrx's dense weights over data, the
    experts shard E over data and d_ff over model, long_500k's cache of
    one row shards its sequence over data."""
    mesh = production_mesh()
    hymba = get_config("hymba-1.5b")
    hp = D.step_arguments(hymba, INPUT_SHAPES["prefill_32k"])["params"]
    specs = S.param_specs(hymba, mesh, hp)
    assert hp["decoder"][0]["p0"]["attn"]["wq"].shape[2] == 25
    assert specs["decoder/0/p0/attn/wq"] == (None, None, None, None)
    dbrx = get_config("dbrx-132b")
    dp = D.step_arguments(dbrx, INPUT_SHAPES["decode_32k"])
    specs = S.param_specs(dbrx, mesh, dp["params"])
    assert specs["decoder/0/p0/attn/wq"] == (None, "data", "model", None)
    assert specs["decoder/0/p0/moe/experts/w_in"] == (None, "data", None, "model")
    assert specs["decoder/0/p0/moe/experts/w_out"] == (None, "data", "model", None)
    assert specs["lm_head"] == ("data", "model")
    nofsdp = dataclasses.replace(dbrx, fsdp=False)
    assert S.param_specs(nofsdp, mesh, dp["params"])["lm_head"] == (None, "model")
    # 8 kv heads do not split 16 ways: replicated over model
    assert S.cache_specs(dbrx, mesh, dp["caches"])["0/p0/attn/k"] == \
        (None, "data", None, None, None)
    danube = get_config("h2o-danube-3-4b")
    long = D.step_arguments(danube, INPUT_SHAPES["long_500k"])["caches"]
    cs = S.cache_specs(danube, mesh, long)
    assert cs["0/p0/attn/k"] == (None, None, "data", None, None)
    assert cs["0/p0/attn/pos"] == (None, None)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_meta_trees_match_reference(arch, ref, port):
    """The port's meta trees (train state, decode caches, inputs of every
    shape) equal the reference's eval_shape trees in keys, shapes and
    dtypes; so do the parameter counts."""
    r, t = ref[arch], port[arch]
    assert _port_structs(t["train_4k"]["state"]) == _flat_structs(r["state"])
    for s in t:
        if "caches" in t[s]:
            assert _port_structs(t[s]["caches"]) == _flat_structs(r["caches"][s]), s
        if "batch" in t[s]:
            assert _port_structs(t[s]["batch"]) == _flat_structs(r["inputs"][s]), s
        else:          # decode: the (B, 1) int32 token and the int32 position
            b = INPUT_SHAPES[s].global_batch
            assert _port_structs(t[s]["token"]) == {"": ((b, 1), "int32")}
            assert _port_structs(t[s]["index"]) == {"": ((), "int32")}
    cfg, jcfg = get_config(arch), r["cfg"]
    assert (cfg.n_params(), cfg.n_active_params()) == (jcfg.n_params(), jcfg.n_active_params())
    # no tensor of the dry run's trees holds memory
    for args in t.values():
        assert all(v.device.type == "meta" for v in flatten_with_paths(args).values()
                   if isinstance(v, torch.Tensor))


def _ref_bytes(structs, specs, mesh_shape):
    """Bytes per device of a reference tree under its specs, from shard
    shapes computed here."""
    total = 0
    for k, (shape, dtype) in structs.items():
        spec = _norm(specs[k], len(shape))
        n = 1
        for dim, ax in zip(shape, spec):
            axes = () if ax is None else (ax,) if isinstance(ax, str) else ax
            n *= -(-dim // math.prod(mesh_shape[a] for a in axes))
        total += n * np.dtype(dtype).itemsize
    return total


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_argument_bytes_match_reference_specs(arch, mesh_name, ref, port):
    """The dry run's argument bytes per device, every applicable shape:
    the sum of the shard sizes of the reference's trees under the
    reference's specs (state and batch; parameters and batch; parameters,
    cache, the replicated token and position)."""
    shape, axes = MESHES[mesh_name]
    jctx = JaxParallelContext(mesh=abstract_mesh(shape, axes))
    mshape = dict(zip(axes, shape))
    r, cfg = ref[arch], get_config(arch)
    state, params = r["state"], r["state"]["params"]
    for s, args in port[arch].items():
        kind = INPUT_SHAPES[s].kind
        if kind == "train":
            want = _ref_bytes(_flat_structs(state),
                              _flat_specs(JS.state_specs(r["cfg"], jctx, state)), mshape)
        else:
            want = _ref_bytes(_flat_structs(params),
                              _flat_specs(JS.param_specs(r["cfg"], jctx, params)), mshape)
        if kind == "decode":
            cache = r["caches"][s]
            want += _ref_bytes(_flat_structs(cache),
                               _flat_specs(JS.cache_specs(r["cfg"], jctx, cache)), mshape)
            want += INPUT_SHAPES[s].global_batch * 4 + 4
        else:
            batch = r["inputs"][s]
            want += _ref_bytes(_flat_structs(batch),
                               _flat_specs(JS.batch_specs(r["cfg"], jctx, batch)), mshape)
        assert D.argument_bytes(cfg, MeshShape(axes, shape), args) == want, s


def test_meshes_and_shard_helpers():
    m1, m2 = production_mesh(), production_mesh(multi_pod=True)
    assert (m1.shape, m1.size, m1.dp_axes, m1.name) == (
        {"data": 16, "model": 16}, 256, ("data",), "pod256")
    assert (m2.shape, m2.size, m2.dp_axes, m2.name) == (
        {"pod": 2, "data": 16, "model": 16}, 512, ("pod", "data"), "pod512")
    assert MeshShape(("data", "model"), (1, 1)).name == "1x1"
    t = torch.empty((4, 32, 8), dtype=torch.bfloat16, device="meta")
    assert S.shard_shape((4, 32, 8), (None, ("pod", "data"), "model"), m2) == (4, 1, 1)
    assert S.shard_bytes(t, (None, "data", None), m1) == 4 * 2 * 8 * 2
    assert S.shard_bytes(3, (), m1) == 4             # a host step counter: int32
    assert S.tree_bytes({"a": t, "b": 7}) == 4 * 32 * 8 * 2 + 4
    with pytest.raises(ValueError):
        MeshShape(("data",), (2, 2))


def test_configs_match_reference():
    """The input shapes, the assigned archs and their applicable pairs,
    and the layout fields of every arch (full and reduced)."""
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}
    assert ASSIGNED_ARCHS == JAX_ASSIGNED == ARCHS[:10]
    assert list(applicable_pairs()) == list(jax_applicable_pairs()) and \
        len(list(applicable_pairs())) == 34
    for arch in ARCHS:
        for tc, jc in ((get_config(arch), jax_get_config(arch)),
                       (reduced(get_config(arch)), jax_reduced(jax_get_config(arch)))):
            assert (tc.fsdp, tc.seq_parallel) == (jc.fsdp, jc.seq_parallel), arch
    assert {a for a in ARCHS if get_config(a).fsdp} == \
        {"dbrx-132b", "deepseek-v3-671b", "llama-3.2-vision-90b"}
