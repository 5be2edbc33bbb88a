"""The port's geo tier against the JAX package's.

The geo schedule of chip_smoke.py at a few dozen keys — writes from both
datacenters shipped by the ``WanShipper``, a WAN cut with concurrent
overwrites in each DC from pre-cut contexts, snapshot reads in each DC
through an ``OpScheduler`` (one ``snapshot_get_many`` a flush), a heal,
shipping until ``cluster_converged``, and quorum reads from each DC — runs
on the reference cluster (its numpy twins) and on the port's
(``device="cpu"``: the plain torch sweeps, or the numpy twins).  Acks,
snapshot and quorum results with their token bytes (the HLC watermark
included), the stable frontiers and lags, the WAN meters and backlogs,
and every store's roots must be exactly equal.  The single-DC probes of
tests/test_geo.py hold the port's flat default to the reference's sends.
"""
import pytest

import repro.core as ref_core
import repro.store as ref_store
import repro_torch.core as port_core
import repro_torch.store as port_store

pytestmark = pytest.mark.torch

DCS = {"east": ("e0", "e1", "e2"), "west": ("w0", "w1", "w2")}
NODES = DCS["east"] + DCS["west"]
PKGS = {"ref": (ref_core, ref_store, {}, False),
        "kernel": (port_core, port_store, {"device": "cpu"}, True),
        "twin": (port_core, port_store, {"device": "cpu"}, False)}


def _res(results):
    return {k: (r.values, r.context.to_bytes(), r.siblings, r.resolution)
            for k, r in results.items()}


def _acks(acks):
    return {k: (repr(a.clock), a.coordinator, a.replicated_to)
            for k, a in acks.items()}


def _converge(c, store, step):
    c.deliver_replication()
    for _ in range(50):
        if store.cluster_converged(c):
            return c.network.now
        c.network.advance(step)
        c.deliver_replication()
    raise AssertionError("not converged")


def _frontiers(g):
    return {dc: (g.geo.stable_frontier(dc), g.geo.frontier_lag(dc))
            for dc in DCS}


def _meters(g):
    geo, net = g.geo, g.network
    return (geo.wan_ticks, geo.wan_rounds, geo.ship_digest_bytes,
            geo.ship_payload_bytes, geo.ship_payload_slots,
            geo.shipper.ticks, net.wan_messages, net.wan_bytes,
            net.bytes_sent, net.timers_fired,
            {k: list(v) for k, v in geo.wan_backlog.items()},
            {k: list(v) for k, v in geo.drop_backlog.items()})


def _geo_run(pkg, *, packed=True, shards=1, n_keys=48, seed=5):
    core, store, kw, use_kernel = pkg
    net = store.SimNetwork(seed=seed)
    net.set_latency_classes(lan=(1.0, 0.5), wan=(30.0, 10.0))
    g = store.KVCluster(NODES, core.DVV_MECHANISM, network=net, seed=seed,
                        packed=packed, shards=shards, datacenters=DCS, **kw)
    g.geo.shipper.use_kernel = use_kernel
    cl = store.KVClient(g, "geo", use_kernel=use_kernel)
    keys = [f"key-{i:04d}" for i in range(n_keys)]
    out = {"acks": [], "frontiers": []}
    half = n_keys // 2
    for via, part in (("e0", keys[:half]), ("w0", keys[half:])):
        out["acks"].append(_acks(cl.put_many(
            {k: (f"v0-{k}", None) for k in part}, via=via)))
    out["ship_done_at"] = _converge(g, store, g.geo.shipper.period)
    out["frontiers"].append(_frontiers(g))

    forked = keys[::10]
    ctx = {k: r.context
           for k, r in cl.get_many(forked, via="e0", quorum=2).items()}
    net.partition(set(DCS["east"]), set(DCS["west"]))
    for via, tag in (("e0", "ge"), ("w0", "gw")):
        out["acks"].append(_acks(cl.put_many(
            {k: (f"{tag}-{k}", ctx[k]) for k in forked}, via=via)))
    g.deliver_replication()
    net.advance(2 * g.geo.shipper.period)   # shipping ticks fail on the cut
    out["frontiers"].append(_frontiers(g))

    wan0 = net.wan_messages
    out["snaps"], out["sched"] = {}, {}
    for via in ("e0", "w0"):
        sched = store.OpScheduler(g, via=via, max_batch=4,
                                  use_kernel=use_kernel)
        s = sched.session(f"snap-{via}")
        ops = [s.submit_snapshot_get(keys[i: i + 8])
               for i in range(0, n_keys, 8)]
        sched.flush()
        snap = {}
        for op in ops:
            snap.update(op.result())
        out["snaps"][via] = _res(snap)
        out["sched"][via] = sched.stats()
    out["snapshot_wan"] = net.wan_messages - wan0
    out["meters_cut"] = _meters(g)

    net.heal()
    out["heal_done_at"] = _converge(g, store, g.geo.shipper.period)
    out["frontiers"].append(_frontiers(g))
    out["reads"] = {via: _res(cl.get_many(keys, via=via, quorum=2))
                    for via in ("e0", "w0")}
    out["meters"] = _meters(g)
    out["roots"] = {(n, s): (st.digest_root(), st.value_root())
                    for n, node in g.nodes.items() if node.is_packed
                    for s, st in enumerate(node.shard_stores)}
    out["versions"] = {(n, k): sorted((v.clock.components, v.value, v.wall)
                                      for v in node.versions(k))
                       for n, node in g.nodes.items() for k in keys}
    return out, keys, forked


@pytest.mark.parametrize("port", ["kernel", "twin"])
@pytest.mark.parametrize("packed,shards", [(True, 1), (True, 4),
                                           (False, 1)],
                         ids=["packed", "sharded", "object"])
def test_geo_schedule_matches_reference(packed, shards, port):
    got, keys, forked = _geo_run(PKGS[port], packed=packed, shards=shards)
    want, _, _ = _geo_run(PKGS["ref"], packed=packed, shards=shards)
    for field in want:
        assert got[field] == want[field], field
    # what the schedule must show in its own right
    assert want["snapshot_wan"] == 0
    assert want["meters_cut"][0] > 2        # shipping ticks ran on the cut
    for via, st in want["sched"].items():
        assert st["ops_failed"] == 0
        assert st["snapshot_calls"] == st["flushes"] > 1
    for via, other in (("e0", "gw"), ("w0", "ge")):
        for k in keys:
            vals = want["snaps"][via][k][0]
            assert len(vals) == 1 and not vals[0].startswith(other), (via, k)
            want_vals = {f"ge-{k}", f"gw-{k}"} if k in forked \
                else {f"v0-{k}"}
            assert set(want["reads"][via][k][0]) == want_vals, (via, k)
    # flag byte bit 1: the token carries its HLC watermark
    assert all(r[1][4] & 2 for via in ("e0", "w0")
               for r in want["snaps"][via].values() if r[0]), \
        "a snapshot token lacks its HLC watermark"


def test_geo_cluster_builds_a_geo_plane_with_mirrored_placement():
    g = port_store.KVCluster(NODES, port_core.DVV_MECHANISM, shards=4,
                             datacenters=DCS, device="cpu")
    assert isinstance(g.geo, port_store.GeoPlane)
    assert isinstance(g.geo.shipper, port_store.WanShipper)
    assert g.replication == 3
    ref = ref_store.KVCluster(NODES, ref_core.DVV_MECHANISM, shards=4,
                              datacenters=DCS)
    for key in (f"key{i}" for i in range(40)):
        assert g.replicas_for(key) == ref.replicas_for(key)
    for n in NODES:
        assert g.geo.mirrors(n) == ref.geo.mirrors(n)
    with pytest.raises(ValueError, match="geo"):
        g.add_node("late")


def _traced_run(store, core, tag_dcs, **kw):
    """tests/test_geo.py's flat-default probe: a fixed workload on a
    single-DC cluster, recording every successful send's latency."""
    net = store.SimNetwork(seed=99)
    if tag_dcs:
        for i, n in enumerate(("a", "b", "c")):
            net.set_datacenter(n, f"dc{i % 2}")
    c = store.KVCluster(("a", "b", "c"), core.DVV_MECHANISM, network=net,
                        seed=99, **kw)
    trace = []
    orig = store.SimNetwork.send

    def send(self, src, dst, payload):
        ok = orig(self, src, dst, payload)
        if ok:
            trace.append((src, dst, self.now, self.queue[-1].deliver_at))
        return ok

    store.SimNetwork.send = send
    try:
        ctx = None
        for t in range(12):
            node = ("a", "b", "c")[t % 3]
            c.put("k", f"v{t}", context=ctx, via=node, coordinator=node)
            if t % 3 == 0:
                c.deliver_replication()
            r = c.get("k", via=node)
            ctx = r.context
        c.deliver_replication()
    finally:
        store.SimNetwork.send = orig
    return (trace, net.bytes_sent, net.wan_messages, ctx.to_bytes(),
            sorted((v.clock.components, v.value, v.wall)
                   for v in c.nodes["a"].versions("k")))


@pytest.mark.parametrize("tag_dcs", [False, True], ids=["flat", "tagged"])
def test_single_dc_sends_match_reference(tag_dcs):
    """Single-DC behaviour is the reference's down to every send's
    latency, the wire bytes, the walls and the token bytes (no HLC flag)."""
    got = _traced_run(port_store, port_core, tag_dcs, device="cpu")
    want = _traced_run(ref_store, ref_core, tag_dcs)
    assert got == want
    assert len(want[0]) > 10
    assert want[3][4] == 0                     # no HLC flag in the token
