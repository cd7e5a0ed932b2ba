"""The port's communication substrates (src/repro_torch/comm) against the
JAX package's, on the CPU: the analytic cost model, the quantization, the
oracle's virtual wire, the serving trace's comm accounting, and the
expert-parallel MoE layer on a 4-rank gloo group (ep_inner = 2, so both
hops of the hierarchical substrates carry data) against the reference's
``moe_oracle(ep=4)``.

Tolerances:
  * cost model, quantization, virtual permutations: exact (bitwise);
  * MoE layer, f32, router jitter off: outputs, aux and gradients within
    1e-5 (absolute and relative; the two packages' CPU matmuls sum in
    different orders); hierarchical and overlapped substrates bitwise
    their base substrates' outputs;
  * collective counts: the transport's counter equals the layer's
    ``comm_*`` telemetry equals ``cost.transport_cost``, exactly, and is
    zero on Gate-Drop and Gate-Expert-Drop steps.
"""
import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.comm import cost as JC  # noqa: E402
from repro.comm import substrate as JS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.configs.base import CommConfig as JaxComm  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.serve import GenerateConfig as JaxGen  # noqa: E402
from repro_torch.comm import cost as C  # noqa: E402
from repro_torch.comm import substrate as S  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import COMM_SUBSTRATES, CommConfig  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.serve import GenerateConfig  # noqa: E402

import torch_ep_worker as W  # noqa: E402
from torch_ep_jax import check_layer, gather_ranks, jax_layer, layer_inputs  # noqa: E402

WORLD = 4
EP_INNER = 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several workers on few
    cores, and torch's thread pool would contend with theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the cost model
# ---------------------------------------------------------------------------

GRID = list(itertools.product(COMM_SUBSTRATES, [1, 2, 4, 6, 8],
                              [0, 1, 2], [1, 3, 4, 12], [1, 3, 4]))


@pytest.mark.parametrize("substrate", COMM_SUBSTRATES)
def test_transport_cost_matches_reference(substrate):
    """transport_cost over (ep, ep_inner, cap, n_chunks), both quant
    modes and two activation widths, including groups of one."""
    n = 0
    for sub, ep, inner, cap, chunks in GRID:
        if sub != substrate or (inner and ep % inner):
            continue
        for quant, itemsize in (("int8", 4), ("fp8", 2)):
            comm = CommConfig(substrate=sub, quant=quant, ep_inner=inner, n_chunks=chunks)
            jcomm = JaxComm(substrate=sub, quant=quant, ep_inner=inner, n_chunks=chunks)
            kw = dict(ep=ep, n_experts=8 * ep, cap=cap, d_model=24, itemsize=itemsize)
            assert C.transport_cost(comm, **kw) == JC.transport_cost(jcomm, **kw)
            n += 1
    assert n >= 60


def test_cost_helpers_match_reference():
    for ep, inner in ((1, 0), (2, 0), (4, 0), (4, 2), (6, 0), (6, 3), (8, 2), (7, 0)):
        assert C.factored_ep(ep, inner) == JC.factored_ep(ep, inner)
        assert C.ep_tier_groups(ep, inner) == JC.ep_tier_groups(ep, inner)
    for cap, n in itertools.product((1, 4, 6, 7, 12), (1, 2, 3, 4, 8)):
        assert C.effective_chunks(cap, n) == JC.effective_chunks(cap, n)
    for compute, comm, n in ((1.0, 0.5, 1), (1.0, 0.5, 4), (0.2, 1.3, 3)):
        assert C.pipeline_time(compute, comm, n) == JC.pipeline_time(compute, comm, n)
    with pytest.raises(ValueError):
        C.factored_ep(6, 4)


@pytest.mark.parametrize("training", [True, False])
def test_layer_and_step_cost_match_reference(training):
    """layer_cost, step_cost, substrate_table and format_table on the
    full-width zcode-m3-base (bf16 activations) at ep = 8."""
    cfg, jcfg = get_config("zcode-m3-base"), jax_get_config("zcode-m3-base")
    kw = dict(tokens_per_shard=1024, ep=8, is_training=training)
    assert C.layer_cost(cfg, **kw) == JC.layer_cost(jcfg, **kw)
    assert C.step_cost(cfg, backward=True, **kw) == JC.step_cost(jcfg, backward=True, **kw)
    table = C.substrate_table(cfg, quant="fp8", n_chunks=2, **kw)
    jtable = JC.substrate_table(jcfg, quant="fp8", n_chunks=2, **kw)
    assert table == jtable
    assert C.format_table(table) == JC.format_table(jtable)


# ---------------------------------------------------------------------------
# quantization and the virtual wire
# ---------------------------------------------------------------------------

def _quant_input():
    rs = np.random.RandomState(5)
    x = rs.randn(6, 5, 16).astype(np.float32) * np.float32(3.0)
    x[0, 0] = 0.0                                        # a zero row: scale 1
    x[1, 1] = np.arange(16, dtype=np.float32) - 7.5      # halves at scale 1/127 steps
    x[1, 2] = (np.arange(16, dtype=np.float32) + 0.5) * np.float32(127 / 15.5)
    x[2, 0, :4] = [448.0 * 3, -1e-30, 1e-3, 0.0]         # fp8 clipping and subnormals
    return x


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantize_bitwise(mode):
    x = _quant_input()
    q, s = S.quantize(torch.from_numpy(x), mode)
    jq, js = JS.quantize(jnp.asarray(x), mode)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert float(s[0, 0, 0]) == 1.0
    if mode == "fp8":
        assert q.dtype == torch.float8_e4m3fn
        np.testing.assert_array_equal(q.view(torch.uint8).numpy(),
                                      np.asarray(jq).view(np.uint8))
    else:
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = S.dequantize(q, s, dt).float().numpy()
        want = np.asarray(JS.dequantize(jq, js, jdt).astype(jnp.float32))
        np.testing.assert_array_equal(got, want)


def _transports(substrate, ep, ep_inner=0, quant="int8"):
    comm = CommConfig(substrate=substrate, quant=quant, ep_inner=ep_inner, n_chunks=3)
    jcomm = JaxComm(substrate=substrate, quant=quant, ep_inner=ep_inner, n_chunks=3)
    return (S.make_transport(comm, S.CommEnv(ep=ep)),
            JS.make_transport(jcomm, JS.CommEnv(ep=ep)))


@pytest.mark.parametrize("substrate", COMM_SUBSTRATES)
@pytest.mark.parametrize("ep,ep_inner", [(1, 0), (4, 2), (8, 2)])
def test_virtual_wire_matches_reference(substrate, ep, ep_inner):
    """vdispatch / vcombine and vpipelined (with an identity-like FFN) of
    every substrate, bitwise, and the compressed roundtrip's gradient
    (straight-through, the reverse wire quantized) against JAX's VJP."""
    E, cap, d = 2 * ep, 6, 8
    t, j = _transports(substrate, ep, ep_inner)
    x = np.random.RandomState(ep).randn(ep, E, cap, d).astype(np.float32)
    got = t.vdispatch(torch.from_numpy(x))
    want = j.vdispatch(jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(t.vcombine(got).numpy(),
                                  np.asarray(j.vcombine(want)))
    ffn = lambda b: b * 2.0 + 1.0   # noqa: E731  (per row, like the experts)
    np.testing.assert_array_equal(t.vpipelined(torch.from_numpy(x), ffn).numpy(),
                                  np.asarray(j.vpipelined(jnp.asarray(x), ffn)))
    g = np.random.RandomState(ep + 1).randn(*x.shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    (t.roundtrip(xt) * torch.from_numpy(g)).sum().backward()
    _, vjp = jax.vjp(j.roundtrip, jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))


def test_telemetry_and_comm_zero():
    t, j = _transports("overlapped_hierarchical_compressed", 8, 2, "fp8")
    got = t.telemetry(16, 12, 32, 2)
    want = j.telemetry(16, 12, 32, 2)
    assert set(got) == set(want) == set(S.COMM_KEYS)
    for k in got:
        assert got[k].device.type == "cpu" and got[k].dtype == torch.float32
        assert float(got[k]) == float(want[k]), k
    assert {k: float(v) for k, v in S.comm_zero().items()} == \
        {k: float(v) for k, v in JS.comm_zero().items()}
    assert S.available_substrates() == JS.available_substrates()
    with pytest.raises(KeyError):
        S.get_substrate("ring")


# ---------------------------------------------------------------------------
# serving: the trace's comm accounting
# ---------------------------------------------------------------------------

class _Ticks:
    def __init__(self, log):
        self.tick_log = log


@pytest.mark.parametrize("local_routing", [False, True])
@pytest.mark.parametrize("substrate,ep", [("dense", 1), ("dense", 4),
                                          ("overlapped_compressed", 8),
                                          ("hierarchical", 4)])
def test_trace_comm_section_matches_reference(substrate, ep, local_routing):
    """The same tick log priced by both packages; decode ticks under
    --local-routing price at zero."""
    cfg, jcfg = get_config("zcode-m3-base"), jax_get_config("zcode-m3-base")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, comm=CommConfig(substrate=substrate)))
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, comm=JaxComm(substrate=substrate)))
    log = [("prefill", 4 * 64), ("decode", 9), ("decode", 9), ("prefill", 2 * 16),
           ("decode", 9)]
    got = port_serve.trace_comm_section(cfg, GenerateConfig(local_routing=local_routing),
                                        _Ticks(log), ep)
    want = jax_serve.trace_comm_section(jcfg, JaxGen(local_routing=local_routing),
                                        _Ticks(log), ep)
    assert got == want
    if local_routing:
        assert got["wire_bytes_total"] == sum(
            port_serve.trace_comm_section(cfg, GenerateConfig(), _Ticks([t]), ep)
            ["wire_bytes_total"] for t in log if t[0] == "prefill")


def test_scheduler_tick_log():
    """The port's schedulers log (kind, tokens) per device call as the
    reference's do: W * bucket per prefill, n_slots + 1 per decode tick."""
    from repro_torch.models import init_model
    from repro_torch.serve import ContinuousScheduler, Request
    cfg = reduced(get_config("zcode-m3-base"))
    params = init_model(torch.Generator().manual_seed(0), cfg)
    rs = np.random.RandomState(0)
    reqs = [Request(rid=i, tokens=rs.randint(3, cfg.vocab, size=3 + i).astype(np.int64),
                    extras={"enc_tokens": rs.randint(3, cfg.vocab, size=32).astype(np.int64)},
                    max_new=3) for i in range(3)]
    sched = ContinuousScheduler(params, cfg, GenerateConfig(max_new=3, eos_id=-1),
                                n_slots=2, prefill_buckets=(8,), admit_width=2)
    sched.run(reqs)
    kinds = [k for k, _ in sched.tick_log]
    assert kinds.count("prefill") == sched.stats["prefill_calls"] >= 2
    assert kinds.count("decode") == sched.stats["decode_steps"]
    assert {n for k, n in sched.tick_log if k == "decode"} == {3}
    assert {n for k, n in sched.tick_log if k == "prefill"} <= {8, 16}


# ---------------------------------------------------------------------------
# the MoE layer on 4 gloo ranks against moe_oracle(ep=4)
# ---------------------------------------------------------------------------

BASES = {"dense": ("dense", "hierarchical", "overlapped", "overlapped_hierarchical"),
         "compressed": ("compressed", "hierarchical_compressed", "overlapped_compressed",
                        "overlapped_hierarchical_compressed")}

CASES = ([dict(name=s, substrate=s, decision=False) for s in COMM_SUBSTRATES]
         + [dict(name="compressed_fp8", substrate="compressed", quant="fp8", decision=False),
            dict(name="local", substrate="hierarchical", decision=True),
            dict(name="expert_drop", substrate="dense", decision=True,
                 mode="gate_expert_drop"),
            dict(name="cuda_routed", substrate="overlapped_hierarchical", decision=False,
                 backend="cuda"),
            dict(name="cuda_local", substrate="dense", decision=True, backend="cuda",
                 masked=True)])
for _c in CASES:
    _c.setdefault("ep_inner", EP_INNER)


EP1_CASES = [dict(name=f"{b}-{s}-{q}-{'local' if d else 'routed'}", substrate=s, quant=q,
                  decision=d, backend=b, ep_inner=0)
             for b, s, q, d in (("cuda", "compressed", "int8", False),
                                ("cuda", "compressed", "fp8", False),
                                ("cuda", "overlapped_hierarchical_compressed", "int8", False),
                                ("cuda", "compressed", "int8", True),
                                ("cuda", "dense", "int8", False),
                                ("cuda_fused", "dense", "int8", False),
                                ("cuda_fused", "overlapped", "int8", True),
                                ("cuda_fused", "compressed", "fp8", False))]


@pytest.mark.parametrize("case", EP1_CASES, ids=[c["name"] for c in EP1_CASES])
def test_kernel_backends_without_group_match_oracle(case):
    """Without a group the kernel backends run as a group of one: a
    compressed wire is its quantize -> dequantize around B1 on a routed
    step (``cuda_fused`` takes the pipeline there), as the reference's
    ``moe_oracle(ep=1)`` and ``pallas`` quantize it; a Gate-Drop local
    step moves nothing and is not quantized, as the reference's oracle.
    Forward, aux and gradients; the counter stays at zero."""
    from repro_torch.core.moe import ParallelContext
    jp, arrays = layer_inputs()
    out, rec = {}, {}
    W.run_layer(case, arrays, ParallelContext(), out, rec)
    moe_cfg = jax_reduced(jax_get_config("zcode-m3-base")).moe
    check_layer([(out, rec)], jax_layer(jp, arrays, case, 1), arrays, case, 1, moe_cfg)
    assert rec[case["name"]]["fwd_calls"] == rec[case["name"]]["bwd_calls"] == 0


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The ranks' results and, computed while they run, the reference's."""
    d = tmp_path_factory.mktemp("ep4")
    jp, arrays = layer_inputs()
    np.savez(d / "layer.npz", **arrays)
    ranks = W.Ranks(WORLD, d, {"layer": CASES}, timeout=150)
    want = {c["name"]: jax_layer(jp, arrays, c, WORLD) for c in CASES}
    return want, arrays, ranks.join()


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_layer_on_four_ranks_matches_oracle(case, four_ranks):
    want, arrays, results = four_ranks
    moe_cfg = jax_reduced(jax_get_config("zcode-m3-base")).moe
    check_layer(results, want[case["name"]], arrays, case, WORLD, moe_cfg)


@pytest.mark.parametrize("base", sorted(BASES))
def test_hierarchical_and_overlapped_bitwise_their_base(base, four_ranks):
    _, _, results = four_ranks
    want = gather_ranks(results, f"{base}/y")
    for name in BASES[base][1:]:
        np.testing.assert_array_equal(gather_ranks(results, f"{name}/y"), want,
                                      err_msg=name)
