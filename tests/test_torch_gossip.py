"""The port's gossip driver against the JAX package's, on seeded runs.

One schedule (seeded writes, a joiner, a partition with writes on both
sides, a heal, a narrow range budget that saturates and ramps, a removal)
runs under a ``GossipDriver`` on the reference cluster (``use_kernel``
False: its numpy twins) and on the port's (``device="cpu"``: the plain
torch sweep, or the numpy twins).  At every checkpoint the driver's
meters (ticks, rounds, wire bytes, fallbacks), every node's adaptive
state (interval, fanout, range budgets), the timers fired,
``cluster_converged`` and every store's digest and value roots must be
exactly equal.
"""
import random

import pytest

import repro.core as ref_core
import repro.store as ref_store
import repro_torch.core as port_core
import repro_torch.store as port_store
from repro_torch.kernels.dvv_ops import dvv_sync_mask_bucketed

pytestmark = pytest.mark.torch

KEYS = tuple(f"k{i}" for i in range(24))
PKGS = {"ref": (ref_core, ref_store, {}, False),
        "kernel": (port_core, port_store, {"device": "cpu"}, True),
        "twin": (port_core, port_store, {"device": "cpu"}, False)}


def _write(c, rng, n_ops, nodes=None):
    nodes = nodes or list(c.nodes)
    for i in range(n_ops):
        n = rng.choice(nodes)
        c.put(rng.choice(KEYS), f"v{i}.{n}", via=n, coordinator=n)


def _observe(c, d):
    st = {n: d.node_state(n) for n in c.nodes}
    return {
        "meters": (d.ticks, d.rounds, d.digest_bytes, d.payload_bytes,
                   d.payload_slots, d.fallbacks, d.divergent_ticks,
                   d.suspect_probes, d.wire_bytes()),
        "state": {n: (s.interval, s.fanout, s.max_ranges, s.step, s.ticks,
                      s.idle_ticks, dict(s.shard_ranges))
                  for n, s in st.items()},
        "intervals": d.intervals(),
        "timers_fired": c.network.timers_fired,
        "now": c.network.now,
        "bytes_sent": c.network.bytes_sent,
        "converged": port_store.cluster_converged(c)
        if c.__module__.startswith("repro_torch")
        else ref_store.cluster_converged(c),
        "nodes": list(c.nodes),
        "roots": {(n, s): (st.digest_root(), st.value_root())
                  for n, node in c.nodes.items() if node.is_packed
                  for s, st in enumerate(node.shard_stores)},
        "versions": {(n, k): sorted((v.clock.components, v.value)
                                    for v in node.versions(k))
                     for n, node in c.nodes.items() for k in KEYS},
    }


def _run(pkg, *, packed, shards, seed=11):
    core, store, kw, use_kernel = pkg
    rng = random.Random(seed)
    c = store.KVCluster(("a", "b", "c", "d"), core.DVV_MECHANISM,
                        packed=packed, shards=shards, seed=seed,
                        network=store.SimNetwork(seed=seed), **kw)
    d = store.GossipDriver(c, period=4.0, seed=seed, max_ranges=1,
                           max_ranges_cap=16, use_kernel=use_kernel)
    out = []
    _write(c, rng, 40)
    d.run_for(60.0)
    out.append(_observe(c, d))
    c.add_node("e")
    c.network.partition({"a", "b"}, {"c", "d", "e"})
    _write(c, rng, 30, nodes=["a", "c"])
    c.network.queue.clear()                 # only gossip carries these
    c.network.heal()
    for _ in range(6):                      # the budget ramps mid-flight
        d.run_for(4.0)
        out.append(_observe(c, d))
    d.run_for(200.0)
    out.append(_observe(c, d))
    c.remove_node("b")
    _write(c, rng, 10)
    d.run_for(300.0)
    out.append(_observe(c, d))
    return out


@pytest.mark.parametrize("port", ["kernel", "twin"])
@pytest.mark.parametrize("packed,shards", [(True, 1), (True, 4),
                                           (False, 1)],
                         ids=["packed", "sharded", "object"])
def test_gossip_driver_matches_reference(packed, shards, port):
    got = _run(PKGS[port], packed=packed, shards=shards)
    want = _run(PKGS["ref"], packed=packed, shards=shards)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        for field in w:
            assert g[field] == w[field], (i, field)
    assert want[-1]["converged"]
    # object backends run every round as a full-payload fallback
    assert not packed or any(
        s[2] > 1 or any(b > 1 for b in s[6].values())
        for o in want for s in o["state"].values()), \
        "the range budget never ramped"


def test_gossip_rounds_sweep_on_the_cluster_device():
    """The driver's default (``use_kernel=True``) runs every round's
    survival sweep through the cluster's front end."""
    front = dvv_sync_mask_bucketed("cpu")
    seen = front.hits + front.misses
    _run(PKGS["kernel"], packed=True, shards=1)
    assert front.hits + front.misses > seen


def test_driver_same_seed_same_schedule():
    def run():
        rng = random.Random(3)
        c = port_store.KVCluster(("a", "b", "c", "d"),
                                 port_core.DVV_MECHANISM, seed=3,
                                 network=port_store.SimNetwork(seed=3),
                                 device="cpu")
        d = port_store.GossipDriver(c, period=4.0, seed=3)
        _write(c, rng, 40)
        c.add_node("e")
        d.run_for(120.0)
        c.remove_node("b")
        d.run_for(200.0)
        return _observe(c, d)
    assert run() == run()
