"""The port's failure detection, self-driving membership and membership
services against the JAX package's.

Pinned schedules of tests/test_faults.py (the fault matrix under a
``MembershipController``) and tests/test_churn.py (hand-called joins and
removals under gossip) run on the reference cluster (its numpy twins) and
on the port's (``device="cpu"``: the plain torch sweeps, or the numpy
twins).  The controller's decisions (probes, evictions, re-admissions,
the members left), the gossip meters, every node's versions, the reads
with their token bytes and every store's roots must be exactly equal.
``MembershipService``, ``Lease`` and ``WorkStealer`` round trips run on
both packages and must agree too.
"""
import random

import pytest

import repro.core as ref_core
import repro.store as ref_store
import repro_torch.core as port_core
import repro_torch.store as port_store

pytestmark = pytest.mark.torch

KEYS = tuple(f"k{i}" for i in range(5))
BASE_NODES = ("n0", "n1", "n2")
MAX_NODES = 6
PKGS = {"ref": (ref_core, ref_store, {}, False),
        "kernel": (port_core, port_store, {"device": "cpu"}, True),
        "twin": (port_core, port_store, {"device": "cpu"}, False)}


# -- the pinned schedules (tests/test_churn.py, tests/test_faults.py) -------

def _run_schedule(pkg, seed, ops, *, packed=True, shards=1,
                  membership=False):
    """tests/test_churn.py's schedule interpreter (without the durable
    logs), on one package."""
    core, store, kw, use_kernel = pkg
    net = store.SimNetwork(seed=seed)
    c = store.KVCluster(BASE_NODES, core.DVV_MECHANISM, packed=packed,
                        network=net, seed=seed, shards=shards, **kw)
    driver = store.GossipDriver(c, period=6.0, seed=seed,
                                use_kernel=use_kernel)
    controller = store.MembershipController(c, period=6.0, seed=seed) \
        if membership else None
    contexts = {}
    next_id = len(BASE_NODES)
    for t, op in enumerate(ops):
        kind = op[0]
        nodes = list(c.nodes)
        if kind == "put":
            _, ki, ni, use_ctx = op
            node = nodes[ni % len(nodes)]
            key = KEYS[ki % len(KEYS)]
            ctx = contexts.get((node, key)) if use_ctx else None
            try:
                c.put(key, f"v{t}", context=ctx, via=node, coordinator=node)
            except store.Unavailable:
                pass
        elif kind == "get":
            _, ki, ni = op
            node = nodes[ni % len(nodes)]
            key = KEYS[ki % len(KEYS)]
            try:
                contexts[(node, key)] = c.get(key, via=node).context
            except store.Unavailable:
                pass
        elif kind == "partition":
            _, p = op
            g1 = {n for i, n in enumerate(nodes) if (i + p) % 2}
            g2 = set(nodes) - g1
            if g1 and g2:
                net.partition(g1, g2)
        elif kind == "heal":
            net.heal()
        elif kind == "fail":
            _, ni = op
            if len(net.down) < len(nodes) - 1:   # keep one node alive
                net.fail_node(nodes[ni % len(nodes)])
        elif kind == "recover":
            _, ni = op
            net.recover_node(nodes[ni % len(nodes)])
        elif kind == "add":
            if len(c.nodes) < MAX_NODES:
                c.add_node(f"n{next_id}")
                next_id += 1
        elif kind == "remove":
            _, ni = op
            if len(c.nodes) > 2:
                c.remove_node(nodes[ni % len(nodes)])
        elif kind == "advance":
            _, dt = op
            driver.run_for(float(dt))
        elif kind == "deliver":
            c.deliver_replication()
        elif kind == "cut":
            _, i, j = op
            a, b = nodes[i % len(nodes)], nodes[j % len(nodes)]
            if a != b:
                net.cut_link(a, b)
        elif kind == "heal_link":
            _, i, j = op
            net.heal_link(nodes[i % len(nodes)], nodes[j % len(nodes)])
        elif kind == "slow":
            _, ni, factor = op
            net.set_delay_factor(nodes[ni % len(nodes)], float(factor))
        elif kind == "dup":
            net.set_duplication(float(op[1]))
        elif kind == "reorder":
            net.set_reorder(float(op[1]), spread=25.0)
        elif kind == "flap":
            _, i, j = op
            a, b = nodes[i % len(nodes)], nodes[j % len(nodes)]
            if a != b and len(net._flaps) < 2:
                net.flap_link(a, b, up_for=8.0, down_for=8.0)
        else:                                    # pragma: no cover
            raise AssertionError(op)
    mid = _observe(store, c, driver, controller)
    net.stop_flaps()
    net.heal()
    for n in list(net.down):
        net.recover_node(n)
    for n in list(net.delay_factors):
        net.set_delay_factor(n, 1.0)
    net.set_duplication(0.0)
    net.set_reorder(0.0)
    c.deliver_replication()
    driver.run_for(60.0 * len(c.nodes))
    c.deliver_replication()
    for _ in range(len(c.nodes) + 1):
        c.delta_antientropy_round(use_kernel=use_kernel)
    return mid, _observe(store, c, driver, controller)


def _observe(store, c, driver, controller):
    out = {
        "nodes": list(c.nodes),
        "down": sorted(c.network.down),
        "versions": {(n, k): sorted((v.clock.components, v.value, v.wall)
                                    for v in node.versions(k))
                     for n, node in c.nodes.items() for k in KEYS},
        "roots": {(n, s): (st.digest_root(), st.value_root())
                  for n, node in c.nodes.items() if node.is_packed
                  for s, st in enumerate(node.shard_stores)},
        "gossip": (driver.ticks, driver.rounds, driver.wire_bytes(),
                   driver.fallbacks, driver.suspect_probes,
                   driver.intervals()),
        "net": (c.network.now, c.network.timers_fired,
                c.network.bytes_sent),
        "converged": store.cluster_converged(c),
    }
    if controller is not None:
        now = c.network.now
        out["decisions"] = (
            controller.probes, controller.evictions, controller.readmissions,
            controller.evicted_nodes(), controller.suspect_nodes(now),
            {n: controller.suspicion(n, now) for n in c.nodes})
    return out


def _reads(store, c):
    out = {}
    for k in KEYS:
        try:
            r = c.get(k)
            out[k] = (r.values, r.value, r.context.to_bytes())
        except store.Unavailable:
            out[k] = None
    return out


def _fault_ops(seed, n_ops=34, modes=("cut", "slow", "dup", "reorder",
                                      "flap")):
    """tests/test_faults.py's pinned fault-matrix schedule: traffic with
    fault modes and no hand-called membership."""
    rng = random.Random(seed)
    ops = []
    for _ in range(n_ops):
        p = rng.random()
        if p < 0.30:
            ops.append(("put", rng.randrange(8), rng.randrange(8),
                        rng.random() < 0.5))
        elif p < 0.42:
            ops.append(("get", rng.randrange(8), rng.randrange(8)))
        elif p < 0.50:
            ops.append(("advance", rng.randrange(1, 25)))
        elif p < 0.56:
            ops.append(("fail", rng.randrange(8)))
        elif p < 0.62:
            ops.append(("recover", rng.randrange(8)))
        elif p < 0.66:
            ops.append(("partition", rng.randrange(1, 6)))
        elif p < 0.70:
            ops.append(("heal",))
        elif p < 0.92:
            mode = modes[rng.randrange(len(modes))]
            if mode == "cut":
                ops.append(("cut", rng.randrange(8), rng.randrange(8)))
            elif mode == "slow":
                ops.append(("slow", rng.randrange(8),
                            rng.choice([1.0, 2.0, 8.0])))
            elif mode == "dup":
                ops.append(("dup", rng.choice([0.0, 0.3, 0.9])))
            elif mode == "reorder":
                ops.append(("reorder", rng.choice([0.0, 0.4, 0.8])))
            elif mode == "flap":
                ops.append(("flap", rng.randrange(8), rng.randrange(8)))
        elif p < 0.96:
            ops.append(("heal_link", rng.randrange(8), rng.randrange(8)))
        else:
            ops.append(("advance", rng.randrange(20, 60)))
    return ops


def _churn_ops(seed, n_ops=40):
    """tests/test_churn.py's pinned churn schedule: traffic, partitions,
    failures and hand-called joins and removals."""
    rng = random.Random(seed)
    ops = []
    for _ in range(n_ops):
        p = rng.random()
        if p < 0.35:
            ops.append(("put", rng.randrange(8), rng.randrange(8),
                        rng.random() < 0.5))
        elif p < 0.50:
            ops.append(("get", rng.randrange(8), rng.randrange(8)))
        elif p < 0.58:
            ops.append(("partition", rng.randrange(1, 6)))
        elif p < 0.64:
            ops.append(("heal",))
        elif p < 0.70:
            ops.append(("fail", rng.randrange(8)))
        elif p < 0.76:
            ops.append(("recover", rng.randrange(8)))
        elif p < 0.81:
            ops.append(("add",))
        elif p < 0.86:
            ops.append(("remove", rng.randrange(8)))
        elif p < 0.96:
            ops.append(("advance", rng.randrange(1, 25)))
        else:
            ops.append(("deliver",))
    return ops


def _compare(port, ops, seed, **kw):
    got = _run_schedule(PKGS[port], seed, ops, **kw)
    want = _run_schedule(PKGS["ref"], seed, ops, **kw)
    for stage, (g, w) in enumerate(zip(got, want)):
        for field in w:
            assert g[field] == w[field], (stage, field)
    assert want[1]["converged"]
    return got, want


@pytest.mark.parametrize("port", ["kernel", "twin"])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "object"])
def test_fault_matrix_with_self_driving_membership_matches_reference(
        packed, port):
    """Fault-matrix seed 5 under the MembershipController: the same
    evictions, re-admissions and probes, and the same final state."""
    _, want = _compare(port, _fault_ops(5, n_ops=28), 5, packed=packed,
                       membership=True)
    assert want[1]["decisions"][1] > 0, "the schedule evicted no node"
    assert not want[1]["decisions"][3], "an evicted node was not readmitted"


@pytest.mark.parametrize("port", ["kernel", "twin"])
@pytest.mark.parametrize("shards", [1, 4])
def test_churn_schedule_matches_reference(shards, port):
    """Churn seed 23 (joins, removals, failures, partitions) under gossip,
    with a MembershipController watching: the same decisions and state."""
    _compare(port, _churn_ops(23), 23, shards=shards, membership=True)


@pytest.mark.parametrize("port", ["kernel", "twin"])
def test_controller_decisions_match_reference(port):
    """tests/test_faults.py's same-seed loop: a node fails, is evicted,
    recovers and is readmitted through the warm bootstrap."""
    def run(pkg):
        core, store, kw, use_kernel = pkg
        net = store.SimNetwork(seed=7)
        c = store.KVCluster(("a", "b", "c", "d"), core.DVV_MECHANISM,
                            network=net, seed=7, **kw)
        driver = store.GossipDriver(c, period=5.0, seed=7,
                                    use_kernel=use_kernel)
        mem = store.MembershipController(c, period=5.0, seed=7)
        for i in range(4):
            c.put(f"k{i}", f"v{i}", via="a", coordinator="a")
        trail = []
        for fault, dt in ((None, 20.0), ("fail", 250.0),
                          ("recover", 250.0)):
            if fault == "fail":
                net.fail_node("b")
            elif fault == "recover":
                net.recover_node("b")
            driver.run_for(dt)
            trail.append((mem.probes, mem.evictions, mem.readmissions,
                          list(c.nodes), mem.evicted_nodes(),
                          net.timers_fired, net.bytes_sent,
                          mem.detector.known(),
                          dict(mem.detector.last_beat)))
        return trail, _reads(store, c)

    got, want = run(PKGS[port]), run(PKGS["ref"])
    assert got == want
    assert want[0][1][1] == 1 and want[0][2][2] == 1   # evicted, readmitted


def test_failure_detector_matches_reference():
    rng = random.Random(4)
    beats = [(rng.choice("wxyz"), t + rng.random())
             for t in range(40) for _ in range(3)]
    dets = [store.FailureDetector(heartbeat_interval=1.0)
            for store in (port_store, ref_store)]
    for det in dets:
        det.register("silent", 0.0)
        for node, now in beats:
            if not (node == "z" and now > 20.0):   # z goes quiet
                det.record(node, now)
        det.forget("y")
    for now in (20.0, 25.0, 41.0, 60.0):
        got, want = ((d.suspects(now), d.dead(now), d.alive(now),
                      {n: d.suspicion(n, now) for n in d.known()})
                     for d in dets)
        assert got == want, now
    assert "z" in dets[0].dead(60.0) and "silent" in dets[0].dead(60.0)


# -- membership and lease services --------------------------------------------

def _service_store(pkg, seed):
    core, store, kw, _ = pkg
    return store.KVCluster(("s1", "s2", "s3"), core.DVV_MECHANISM,
                           network=store.SimNetwork(seed=seed), seed=seed,
                           **kw)


def _membership_round_trip(pkg):
    store = pkg[1]
    c = _service_store(pkg, 1)
    a = store.MembershipService(c, "s1")
    b = store.MembershipService(c, "s2")
    a.join("w0")
    c.deliver_replication()
    c.network.partition({"s1"}, {"s2", "s3"})
    a.join("w-left")
    b.join("w-right")
    b.leave("w0")
    c.network.heal()
    c.antientropy_round()
    raw = c.get(store.MEMBERSHIP_KEY, via="s1")
    merged = a.reconcile()
    c.antientropy_round()
    view = b.view()
    b.mark_dead("w-left")
    c.deliver_replication()
    final = a.view()
    again = store.MemberView.deserialize(final.serialize())
    return (len(raw.values), merged.serialize(), view.serialize(),
            final.serialize(), final.alive(), again == final,
            raw.context.to_bytes())


def test_membership_service_round_trip_matches_reference():
    got = _membership_round_trip(PKGS["kernel"])
    assert got == _membership_round_trip(PKGS["ref"])
    siblings, merged, view, final, alive, round_trips, _ = got
    assert siblings == 2                       # the concurrent joins
    assert merged == view                      # reconcile converged
    assert alive == ("w-right",)
    assert round_trips
    left = dict(port_store.MemberView.deserialize(final).to_dict())
    assert left["w-left"][0] == port_store.NodeStatus.DEAD
    assert left["w0"][0] == port_store.NodeStatus.LEAVING


def _lease_round_trip(pkg):
    store = pkg[1]
    c = _service_store(pkg, 3)
    w1 = store.WorkStealer(c, "worker1", lease_duration=5.0)
    w2 = store.WorkStealer(c, "worker2", lease_duration=5.0)
    trail = []
    # both claim through the same coordinator with an empty context: the
    # paper's Fig. 3 concurrency, siblings under DVV, one resolved owner
    trail.append(w1.try_claim("shard-7", now=0.0, via="s1"))
    trail.append(w2.try_claim("shard-7", now=0.0, via="s1"))
    trail.append(w1.owner("shard-7", via="s1"))
    trail.append(w1.try_claim("shard-0", now=0.0, via="s1"))
    trail.append(w2.try_claim("shard-0", now=3.0, via="s1"))
    trail.append(w1.renew("shard-0", now=4.0, via="s1"))
    trail.append(w2.steal_expired("shard-0", now=6.0, via="s1"))
    trail.append(w2.steal_expired("shard-0", now=10.0, via="s1"))
    trail.append(w2.owner("shard-0", via="s1"))
    trail.append(w1.renew("shard-0", now=11.0, via="s1"))
    c.deliver_replication()
    raw = c.get("lease/shard-7", via="s2")
    leases = tuple(store.Lease.deserialize(v) for v in raw.values)
    win = store.resolve_lease_siblings(leases)
    trail.append((len(leases), win.serialize(),
                  store.Lease.deserialize(win.serialize()) == win))
    return trail


def test_lease_round_trip_matches_reference():
    got = _lease_round_trip(PKGS["kernel"])
    assert got == _lease_round_trip(PKGS["ref"])
    assert not (got[0] and got[1])             # never both owners
    assert got[2] in ("worker1", "worker2")
    assert got[3] and not got[4] and got[5]    # held, refused, renewed
    assert not got[6] and got[7]               # stolen once it lapsed
    assert got[8] == "worker2" and not got[9]  # the straggler cannot renew
    assert got[10][2]
