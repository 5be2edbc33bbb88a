"""The port's coalescing serving plane against the JAX package's.

The schedules of tests/test_serving.py (randomized multi-session rounds,
per-op failure isolation) run through ``OpScheduler`` and through solo
calls on the port's cluster (``device="cpu"``: the kernels' plain torch
versions, or the numpy twins with ``use_kernel=False``) and on the
reference cluster (``use_kernel=False``: its numpy twins).  Coalesced must
equal sequential inside each package, and the port must equal the
reference: per-op results (values, token bytes, resolution walls, acks),
every replica's versions, and the scheduler's stats.  A seeded
``ClosedLoopEngine`` run with gossip, and the launcher's
``--store-workload``, must give the reference's summary (wall-clock fields
aside), tokens and store roots.
"""
import argparse
import io
import json
import random
from contextlib import redirect_stdout

import pytest

import repro.core as ref_core
import repro.store as ref_store
import repro_torch.core as port_core
import repro_torch.store as port_store
from repro_torch.kernels.dvv_ops import dvv_read_sweep_bucketed, \
    dvv_sync_mask_bucketed

pytestmark = pytest.mark.torch

NODES = ("n0", "n1", "n2", "n3", "n4")
KEYS = tuple(f"k{i}" for i in range(8))
#: the engine's summary fields read from the host's clock
WALL_FIELDS = ("wall_s", "ops_per_sec_wall")
#: (package, cluster keyword arguments, use_kernel) of each run
PORT = {"kernel": (port_core, port_store, {"device": "cpu"}, True),
        "twin": (port_core, port_store, {"device": "cpu"}, False)}
REF = (ref_core, ref_store, {}, False)


def _cluster(pkg, seed, packed, nodes=NODES, replication=3):
    core, store, kw, _ = pkg
    return store.KVCluster(nodes, core.DVV_MECHANISM, packed=packed,
                           network=store.SimNetwork(seed=seed), seed=seed,
                           replication=replication, read_quorum=2,
                           write_quorum=2, **kw)


def _plain(res):
    """A result (``{key: GetResult}``, ``{key: PutAck}`` or a failure) as
    plain values, comparable across the two packages."""
    if isinstance(res, tuple):
        return res
    out = {}
    for k, r in res.items():
        if hasattr(r, "values"):
            out[k] = ("get", r.values, r.context.to_bytes(), r.siblings,
                      r.resolution)
        else:
            out[k] = ("put", repr(r.clock), r.coordinator, r.replicated_to)
    return out


def _versions(c, keys=KEYS):
    return {(n, k): sorted((v.clock.components, v.value, v.wall)
                           for v in node.versions(k))
            for n, node in c.nodes.items() for k in keys}


# -- tests/test_serving.py's conformance schedule ---------------------------

def _schedule(seed, rounds=8, sessions=4):
    rng = random.Random(seed)
    out = []
    for _ in range(rounds):
        batch = []
        for s in range(sessions):
            if rng.random() < 0.85:
                kind = "put" if rng.random() < 0.5 else "get"
                ks = rng.sample(KEYS, 1 + (rng.random() < 0.3))
                batch.append((s, kind, tuple(ks)))
        out.append(batch)
    return out


def _put_items(s, r, j, ks, snap):
    return {k: (f"v{s}.{r}.{j}", snap.get((s, k))) for k in ks}


def _record_gets(client, ctxs, s, ks, res):
    for k in ks:
        ctxs[(s, k)] = client.encode_context(res[k].context)


def _run_sequential(pkg, cluster, sched, n_sessions):
    store, use_kernel = pkg[1], pkg[3]
    clients = {s: store.KVClient(cluster, f"s{s}", via="n0", read_quorum=2,
                                 write_quorum=2, read_repair=True,
                                 use_kernel=use_kernel)
               for s in range(n_sessions)}
    results, ctxs = [], {}
    for r, batch in enumerate(sched):
        snap = dict(ctxs)
        for j, (s, kind, ks) in enumerate(batch):
            cl = clients[s]
            try:
                if kind == "get":
                    res = cl.get_many(list(ks))
                    _record_gets(cl, ctxs, s, ks, res)
                else:
                    res = cl.put_many(_put_items(s, r, j, ks, snap))
            except store.Unavailable as e:
                res = ("unavailable", str(e))
            results.append(res)
        cluster.deliver_replication()
    return results


def _run_coalesced(pkg, cluster, sched, n_sessions, *, max_batch=64,
                   by_timer=False):
    store, use_kernel = pkg[1], pkg[3]
    sch = store.OpScheduler(cluster, via="n0", max_batch=max_batch,
                            max_delay=2.0, use_kernel=use_kernel)
    clients = {s: sch.session(f"s{s}", read_quorum=2, write_quorum=2,
                              read_repair=True)
               for s in range(n_sessions)}
    results, ctxs = [], {}
    for r, batch in enumerate(sched):
        snap = dict(ctxs)
        pend = []
        for j, (s, kind, ks) in enumerate(batch):
            cl = clients[s]
            if kind == "get":
                pend.append((s, kind, ks, cl.submit_get(list(ks))))
            else:
                pend.append((s, kind, ks,
                             cl.submit_put(_put_items(s, r, j, ks, snap))))
        if by_timer:
            cluster.network.advance(2.001)
        else:
            sch.flush()
        for s, kind, ks, op in pend:
            assert op.done, "flush must complete every queued op"
            try:
                res = op.result()
            except store.Unavailable as e:
                res = ("unavailable", str(e))
            results.append(res)
            if kind == "get" and not isinstance(res, tuple):
                _record_gets(clients[s], ctxs, s, ks, res)
        cluster.deliver_replication()
    return results, sch


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "object"])
@pytest.mark.parametrize("seed", [0, 7, 19])
def test_coalesced_equals_sequential(seed, packed):
    """Inside the port, coalesced == sequential (results and replica
    state); across packages, the port's coalesced run == the reference's,
    through the plain torch sweeps and through the numpy twins."""
    sched = _schedule(seed)
    runs = {}
    for name, pkg in (("ref", REF), *PORT.items()):
        cs = _cluster(pkg, seed, packed)
        seq = _run_sequential(pkg, cs, sched, 4)
        cc = _cluster(pkg, seed, packed)
        coal, sch = _run_coalesced(pkg, cc, sched, 4)
        assert coal == seq, name
        assert cc.clock_time == cs.clock_time
        assert _versions(cc) == _versions(cs), name
        assert sch.ops_submitted == sum(len(b) for b in sched)
        assert sch.pending == 0
        runs[name] = ([_plain(r) for r in coal], _versions(cc), sch.stats(),
                      cc.network.bytes_sent)
    assert runs["kernel"] == runs["ref"]
    assert runs["twin"] == runs["ref"]


@pytest.mark.parametrize("by_timer", [False, True], ids=["size", "timer"])
def test_flush_triggers_match_reference(by_timer):
    """Size-triggered (max_batch 4) and timer-triggered flushes give the
    reference's results, state and trigger counts."""
    sched = _schedule(11, rounds=6, sessions=6)
    runs = {}
    for name, pkg in (("ref", REF), ("kernel", PORT["kernel"])):
        cc = _cluster(pkg, 11, True)
        coal, sch = _run_coalesced(pkg, cc, sched, 6, by_timer=by_timer,
                                   max_batch=64 if by_timer else 4)
        runs[name] = ([_plain(r) for r in coal], _versions(cc), sch.stats())
    assert runs["kernel"] == runs["ref"]
    trigger = "timer" if by_timer else "size"
    assert runs["ref"][2]["flush_triggers"].get(trigger, 0) > 0


def _partitioned_keys(c):
    """One key whose read quorum survives the down node and one whose
    doesn't (probed, so the choice tracks the ring placement)."""
    ok = bad = None
    for i in range(64):
        k = f"p{i}"
        if c.probe_read(k, via="n0", quorum=2):
            ok = ok or k
        else:
            bad = bad or k
        if ok and bad:
            return ok, bad
    raise AssertionError("no suitable keys found")


def _isolation_run(pkg, packed):
    store, use_kernel = pkg[1], pkg[3]
    nodes = ("n0", "n1", "n2", "n3")
    cs = _cluster(pkg, 1, packed, nodes=nodes, replication=2)
    cc = _cluster(pkg, 1, packed, nodes=nodes, replication=2)
    for c in (cs, cc):
        c.put("seed", "x", via="n0")     # identical warm-up
        c.deliver_replication()
        c.network.fail_node("n3")
    ok_key, bad_key = _partitioned_keys(cs)
    assert _partitioned_keys(cc) == (ok_key, bad_key)
    plan = [("get", ok_key), ("get", bad_key), ("put", ok_key),
            ("put", bad_key)]

    seq = []
    cli = store.KVClient(cs, "s0", via="n0", read_quorum=2, write_quorum=2,
                         read_repair=True, use_kernel=use_kernel)
    for kind, key in plan:
        try:
            if kind == "get":
                seq.append(cli.get_many([key]))
            else:
                seq.append(cli.put_many({key: (f"w.{key}", None)}))
        except store.Unavailable:
            seq.append("unavailable")

    sch = store.OpScheduler(cc, via="n0", use_kernel=use_kernel)
    s = sch.session("s0", read_quorum=2, write_quorum=2, read_repair=True)
    ops = [s.submit_get([key]) if kind == "get"
           else s.submit_put({key: (f"w.{key}", None)})
           for kind, key in plan]
    sch.flush()
    coal = []
    for op in ops:
        try:
            coal.append(op.result())
        except store.Unavailable:
            coal.append("unavailable")
    assert coal == seq
    assert coal[0] != "unavailable" and coal[1] == "unavailable"
    keys = ("seed", ok_key, bad_key)
    return ([r if r == "unavailable" else _plain(r) for r in coal],
            _versions(cc, keys), sch.stats())


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "object"])
def test_per_op_failure_isolation(packed):
    """With a replica down, only the ops whose solo call would raise
    ``Unavailable`` fail; flush-mates on healthy keys succeed with the
    sequential-identical results, as in the reference."""
    assert _isolation_run(PORT["kernel"], packed) == \
        _isolation_run(REF, packed)


def test_quorum_miss_put_still_writes_durably():
    c = _cluster(PORT["kernel"], 2, True, nodes=("n0", "n1", "n2", "n3"),
                 replication=2)
    c.network.fail_node("n3")
    _, bad_key = _partitioned_keys(c)
    sch = port_store.OpScheduler(c, via="n0")
    op = sch.session("s0", write_quorum=2).submit_put(
        {bad_key: ("survives", None)})
    sch.flush()
    with pytest.raises(port_store.Unavailable):
        op.result()
    c.network.recover_node("n3")
    c.deliver_replication()
    assert "survives" in c.get(bad_key, via="n0", quorum=2).values


def test_scheduler_defaults_sweep_on_the_cluster_device():
    """``use_kernel`` defaults to True in the port's scheduler, engine and
    drivers, so their plane calls go through the cluster's front ends."""
    c = _cluster(PORT["kernel"], 0, True)
    sch = port_store.OpScheduler(c, via="n0")
    eng = port_store.ClosedLoopEngine(c, sessions=10, keys=4,
                                      mode="direct")
    driver = port_store.GossipDriver(c, autostart=False)
    assert sch.use_kernel and eng.client.use_kernel and driver.use_kernel
    fronts = (dvv_sync_mask_bucketed("cpu"), dvv_read_sweep_bucketed("cpu"))
    seen = [f.hits + f.misses for f in fronts]
    s = sch.session("s0")
    s.submit_put({"k0": ("v", None), "k1": ("w", None)})
    sch.flush()
    s.submit_get(["k0", "k1"])
    sch.flush()
    assert all(f.hits + f.misses > n for f, n in zip(fronts, seen))


# -- the closed-loop engine --------------------------------------------------

def _engine_run(pkg, mode, *, steps=300):
    core, store, kw, use_kernel = pkg
    net = store.SimNetwork(seed=7, jitter=0.0)
    c = store.KVCluster(NODES, core.DVV_MECHANISM, replication=3,
                        network=net, read_quorum=2, write_quorum=2, seed=7,
                        **kw)
    driver = store.GossipDriver(c, period=10.0, seed=7,
                                use_kernel=use_kernel)
    eng = store.ClosedLoopEngine(
        c, sessions=10_000, keys=200, zipf_s=0.9, concurrency=256,
        mode=mode, via="n0", seed=11, read_repair=True,
        use_kernel=use_kernel, max_batch=256, max_delay=2.0)
    out = eng.run(steps)
    for f in WALL_FIELDS:
        out.pop(f)
    out["gossip"] = (driver.rounds, driver.ticks, driver.wire_bytes(),
                     driver.intervals())
    roots = {(n, s): (st.digest_root(), st.value_root())
             for n, node in c.nodes.items()
             for s, st in enumerate(node.shard_stores)}
    return out, dict(eng._tokens), roots, net.timers_fired


@pytest.mark.parametrize("port", ["kernel", "twin"])
@pytest.mark.parametrize("mode", ["coalesced", "direct"])
def test_engine_matches_reference(mode, port):
    """One seeded 300-step run with gossip between the flushes: the same
    summary (scheduler stats, planes, bytes, latencies, codec meters),
    the same session tokens, the same store roots and timer count."""
    got = _engine_run(PORT[port], mode)
    want = _engine_run(REF, mode)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[3] == want[3]
    assert got[0]["ops"] == 600 and got[0]["ops_failed"] == 0
    if mode == "coalesced":
        assert got[0]["scheduler"]["plane_calls"] < 600


def _summaries(text):
    """The JSON summaries a --store-workload run prints, by mode."""
    dec = json.JSONDecoder()
    out, i = {}, text.find("{")
    while i >= 0:
        obj, end = dec.raw_decode(text, i)
        out[obj["mode"]] = obj
        i = text.find("\n{", end)
        i = i + 1 if i >= 0 else -1
    return out


def test_store_workload_cli_matches_reference():
    """``serve --store-workload --device cpu`` prints the reference
    launcher's per-mode summaries, field for field (wall fields aside)."""
    from repro.launch import serve as ref_serve
    from repro_torch.launch import serve as port_serve

    argv = ["--store-workload", "--device", "cpu", "--sessions", "10000",
            "--store-steps", "300", "--gossip-period", "10"]
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert port_serve.main(argv) == 0
    got = _summaries(buf.getvalue())
    args = port_serve.parse_args(argv)
    assert args.seed == 11
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert ref_serve.store_workload_main(argparse.Namespace(**{
            k: v for k, v in vars(args).items() if k != "device"})) == 0
    want = _summaries(buf.getvalue())
    assert set(got) == set(want) == {"coalesced", "direct"}
    for mode in got:
        assert set(got[mode]) == set(want[mode])
        for f in WALL_FIELDS:
            got[mode].pop(f)
            want[mode].pop(f)
        assert got[mode] == want[mode], mode
