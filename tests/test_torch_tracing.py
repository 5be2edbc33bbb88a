"""The port's tracing (``repro_torch.runtime.tracing``) on the CPU:

  * off (the default), ``span`` hands back one shared no-op context, and a
    MoE model's decode step and prefill leave no record;
  * on, under ``torch.profiler``, the serving step's spans nest as the
    work does (``serve.step`` > ``serve.step.dispatch`` > ``lm.decode_step``
    > ``lm.layer`` > ``lm.decode_attention`` / ``lm.moe`` >
    ``lm.moe.assign``), in the records and on the profiler's timeline,
    one ``lm.layer`` a layer, and a finished request's ``serve.persist``
    carries its ``rid``;
  * logits and served tokens are bitwise the same with tracing on and off;
  * the store's replication counters: a PUT on Riak KV's deployment (5
    nodes, ``n_val`` 3, ``w`` 2) queues two acknowledged copies that only
    ``deliver_replication`` applies;
  * ``moe.pairs_kept`` is ``assign``'s count of kept pairs.
"""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import DVV_MECHANISM
from repro_torch.launch.serve import BatchScheduler, Request
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import init_cache, init_params
from repro_torch.models import moe as M
from repro_torch.runtime import tracing
from repro_torch.store import KVCluster, SimNetwork

pytestmark = pytest.mark.torch


@pytest.fixture
def traced():
    """Tracing on for the test, off and emptied after it."""
    tracing.enable()
    try:
        yield
    finally:
        tracing.disable()
        tracing.drain()


@pytest.fixture(scope="module")
def moe_model():
    cfg = get_config("grok-1-314b").smoke()
    gen = torch.Generator().manual_seed(0)
    return cfg, init_params(gen, cfg, device="cpu")


def _cluster(n_val=3, w=2):
    return KVCluster(tuple(f"n{i}" for i in range(5)), DVV_MECHANISM,
                     replication=n_val, read_quorum=2, write_quorum=w,
                     network=SimNetwork(seed=0, jitter=0.0), seed=0,
                     device="cpu")


def _serve(cfg, params, steps=6):
    """Served tokens and every step's logits of a 2-slot scheduler over
    requests that finish and write their sessions."""
    sched = BatchScheduler(cfg, params, 2, 32, _cluster(), "n0")
    step, logits = sched._step, []

    def keeping(*args):
        out, cache = step(*args)
        logits.append(out.clone())
        return out, cache

    sched._step = keeping
    queue = [Request(rid=i, prompt_token=3 + i, max_tokens=2 + i % 2)
             for i in range(5)]
    served = queue[:]
    for _ in range(steps):
        sched.admit(queue)
        sched.step()
    return [r.generated for r in served], torch.stack(logits)


def test_off_span_is_the_shared_no_op_and_records_nothing(moe_model):
    cfg, params = moe_model
    assert tracing.span("lm.layer") is tracing.span("serve.step", pos=1)
    tracing.drain()
    make_prefill_step(cfg)(params, {"tokens": torch.ones((1, 8),
                                                         dtype=torch.int32)})
    cache = init_cache(cfg, 2, 16, device="cpu")
    make_decode_step(cfg)(params, cache, torch.ones(2, dtype=torch.int32), 0)
    assert tracing.drain() == []
    assert tracing.snapshot()["spans"] == {}


def _inside(outer, inner):
    return outer.start_ns <= inner.start_ns and inner.end_ns <= outer.end_ns


def test_serving_spans_nest_in_records_and_on_the_profiler(moe_model,
                                                           traced):
    from torch.profiler import ProfilerActivity, profile
    cfg, params = moe_model
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(cfg, params, steps=3)
    records = tracing.drain()

    def parent(rec):
        return records[rec.parent].name if rec.parent >= 0 else None

    chain = {"serve.step.dispatch": "serve.step",
             "lm.decode_step": "serve.step.dispatch",
             "lm.layer": "lm.decode_step",
             "lm.decode_attention": "lm.layer", "lm.moe": "lm.layer",
             "lm.moe.assign": "lm.moe", "serve.step.sync": "serve.step",
             "serve.persist": "serve.step", "store.get": "serve.persist",
             "store.put.coordinate": "store.put"}
    names = {r.name for r in records}
    assert set(chain) <= names
    for rec in records:
        if rec.name in chain:
            assert parent(rec) == chain[rec.name], rec
            assert _inside(records[rec.parent], rec)
    steps = [i for i, r in enumerate(records) if r.name == "serve.step"]
    assert len(steps) == 3
    assert [records[i].ids["pos"] for i in steps] == [0, 1, 2]
    for i in steps:
        decode = [j for j, r in enumerate(records) if r.name ==
                  "lm.decode_step" and records[r.parent].parent == i]
        layers = [r for r in records if r.name == "lm.layer"
                  and r.parent == decode[0]]
        assert len(decode) == 1 and len(layers) == cfg.n_layers
    persists = [r for r in records if r.name == "serve.persist"]
    assert sorted(r.ids["rid"] for r in persists) == [0, 1]

    # the profiler's ranges of the same names nest alike
    ranges = {}
    for e in prof.events():
        ranges.setdefault(e.name, []).append(e.time_range)
    for inner, outer in [("serve.step.dispatch", "serve.step"),
                         ("lm.decode_step", "serve.step.dispatch"),
                         ("lm.layer", "lm.decode_step"),
                         ("lm.decode_attention", "lm.layer"),
                         ("lm.moe", "lm.layer"),
                         ("lm.moe.assign", "lm.moe")]:
        assert len(ranges[inner]) == sum(r.name == inner for r in records)
        for t in ranges[inner]:
            assert any(o.start <= t.start and t.end <= o.end
                       for o in ranges[outer]), (inner, outer)
    assert len(ranges["lm.layer"]) == 3 * cfg.n_layers


def test_outputs_are_bitwise_the_same_traced_or_not(moe_model):
    cfg, params = moe_model
    tokens_off, logits_off = _serve(cfg, params)
    tracing.enable()
    try:
        tokens_on, logits_on = _serve(cfg, params)
        batch = {"tokens": torch.arange(24, dtype=torch.int32)[None] % 200}
        prefill_on = make_prefill_step(cfg)(params, batch)
    finally:
        tracing.disable()
        tracing.drain()
    assert tokens_on == tokens_off
    assert torch.equal(logits_on, logits_off)
    assert torch.equal(prefill_on, make_prefill_step(cfg)(params, batch))


def test_replication_counters_show_the_acknowledged_backlog(traced):
    cluster = _cluster(n_val=3, w=2)
    ack = cluster.put("session/1", "a", via="n0")
    assert len(ack.replicated_to) == 3
    counters = tracing.snapshot(cluster)["counters"]
    assert counters["store.replication_queued"] == 2
    assert counters.get("store.replication_delivered", 0) == 0
    assert cluster.deliver_replication() == 2
    snap = tracing.snapshot(cluster)
    assert snap["counters"]["store.replication_queued"] == 2
    assert snap["counters"]["store.replication_delivered"] == 2
    assert snap["store"] == {"plane_reads": 0, "plane_writes": 1}
    res = cluster.get("session/1", via="n0")
    assert tracing.snapshot()["counters"]["store.siblings_returned"] == \
        len(res.values) == 1
    spans = tracing.snapshot()["spans"]
    for name in ("store.put", "store.put.coordinate", "store.put.replicate",
                 "store.get", "store.get.merge"):
        assert spans[name]["count"] == 1


def test_pairs_kept_is_what_assign_kept(traced):
    spec = M.MoESpec(n_experts=4, top_k=2, d_ff=16)
    gen = torch.Generator().manual_seed(1)
    params = M.init_moe_params(gen, 32, spec, torch.float32)
    # one shared direction sends most tokens to the same two experts, past
    # their capacity
    x = 0.1 * torch.randn(2, 40, 32, generator=gen) + torch.randn(
        32, generator=gen)
    _, _, gates, idx = M.route(params, x, spec)
    _, _, kept = M.assign(idx, gates, 4, M.capacity(40, spec), x.dtype)
    _, metrics = M.moe_ffn(params, x, spec)
    counters = tracing.snapshot()["counters"]
    assert counters["moe.pairs_routed"] == 2 * 40 * 2
    assert counters["moe.pairs_kept"] == int(kept) < 2 * 40 * 2
    assert float(metrics["fraction_dropped"]) == pytest.approx(
        1 - int(kept) / 160)
