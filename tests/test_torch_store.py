"""The port's store against the JAX package's, on one seeded schedule.

The schedule (put_many, partition, concurrent put_many from both sides
with the pre-partition contexts, heal, delta rounds, get_many with
read-repair) runs on the reference ``KVCluster`` with ``use_kernel`` True
(its Pallas kernels in interpret mode) and False (its numpy twins), and on
the port with ``device="cpu"`` (the kernels' plain torch versions) and
``use_kernel=False``.  Results, DVV token bytes, every store's digest and
value roots, the delta rounds' stats and the wire bytes must be exactly
equal.
"""
import numpy as np
import pytest

import repro.core as ref_core
import repro.store as ref_store
import repro_torch.core as port_core
import repro_torch.store as port_store
from repro_torch.kernels.dvv_ops import dvv_read_sweep_bucketed, \
    dvv_sync_mask_bucketed
from repro_torch.store.packed import PackedVersionStore

pytestmark = pytest.mark.torch

NODES = ("n0", "n1", "n2", "n3", "n4")
SIDE_A, SIDE_B = {"n0", "n1"}, {"n2", "n3", "n4"}


def _schedule(core, store, *, use_kernel, n_keys=40, shards=4, seed=7,
              batch=16, **kw):
    c = store.KVCluster(NODES, core.DVV_MECHANISM, replication=3,
                        read_quorum=2, write_quorum=2, shards=shards,
                        seed=seed, network=store.SimNetwork(seed=seed), **kw)
    cl = store.KVClient(c, "t", via="n0", use_kernel=use_kernel)
    keys = [f"key-{i:04d}" for i in range(n_keys)]
    for i in range(0, n_keys, batch):
        cl.put_many({k: (f"v0-{k}", None) for k in keys[i: i + batch]})
    c.deliver_replication()
    before = cl.get_many(keys)
    # Fork keys whose replica set spans the partition: both sides can then
    # coordinate a write to them.
    forked = [k for k in keys if set(c.replicas_for(k)) & SIDE_A
              and set(c.replicas_for(k)) & SIDE_B][: max(1, n_keys // 5)]
    c.network.partition(SIDE_A, SIDE_B)
    for via, tag in (("n0", "a"), ("n2", "b")):
        cl.put_many({k: (f"{tag}-{k}", before[k].context) for k in forked},
                    via=via, quorum=1)
    c.deliver_replication()
    c.network.heal()
    stats = [c.delta_antientropy_round(use_kernel=use_kernel)
             for _ in range(2)]
    read = cl.get_many(keys, repair=True)
    c.deliver_replication()
    return c, keys, forked, before, read, stats


def _observe(run):
    """Everything the comparison holds equal, as plain values."""
    c, keys, _, before, read, stats = run
    return {
        "before": {k: (r.values, r.context.to_bytes(), r.siblings,
                       r.resolution) for k, r in before.items()},
        "read": {k: (r.values, r.context.to_bytes(), r.siblings,
                     r.resolution) for k, r in read.items()},
        "versions": {(n, k): sorted((v.clock.components, v.value, v.wall)
                                    for v in node.versions(k))
                     for n, node in c.nodes.items() for k in keys},
        "roots": {(n, s): (st.digest_root(), st.value_root())
                  for n, node in c.nodes.items()
                  for s, st in enumerate(node.shard_stores)},
        "stats": [repr(st) for st in stats],
        "bytes_sent": c.network.bytes_sent,
    }


@pytest.fixture(scope="module")
def reference_runs():
    return {uk: _observe(_schedule(ref_core, ref_store, use_kernel=uk))
            for uk in (False, True)}


@pytest.mark.parametrize("ref_kernel", [False, True])
@pytest.mark.parametrize("port_kernel", [False, True])
def test_schedule_matches_reference(reference_runs, ref_kernel, port_kernel):
    run = _schedule(port_core, port_store, use_kernel=port_kernel,
                    device="cpu")
    got = _observe(run)
    want = reference_runs[ref_kernel]
    for field in want:
        assert got[field] == want[field], field


def test_schedule_reads_back_every_acknowledged_write():
    c, keys, forked, _, read, _ = _schedule(
        port_core, port_store, use_kernel=True, device="cpu")
    for k in keys:
        want = {f"a-{k}", f"b-{k}"} if k in forked else {f"v0-{k}"}
        assert set(read[k].values) == want, k
        assert read[k].siblings == len(want)
    # read-repair left every replica set converged
    for s in range(c.shards):
        owners = c._placement[s]
        roots = {c.nodes[n].shard_stores[s].digest_root() for n in owners}
        assert len(roots) == 1, s


def test_batched_planes_sweep_through_the_cpu_front_ends():
    fronts = (dvv_sync_mask_bucketed("cpu"), dvv_read_sweep_bucketed("cpu"))
    seen = [f.hits + f.misses for f in fronts]
    _schedule(port_core, port_store, use_kernel=True, device="cpu",
              n_keys=12)
    assert all(f.hits + f.misses > s for f, s in zip(fronts, seen))


def test_unported_geo_tier_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        port_store.KVCluster(NODES, port_core.DVV_MECHANISM, device="cpu",
                             datacenters={"x": ["n0"], "y": ["n1"]})


def _arrays(store):
    p = store.payload()
    return {f: getattr(p, f) for f in PackedVersionStore.ARRAY_FIELDS}


def _port_payload(p):
    return port_store.PackedPayload(
        replica_ids=p.replica_ids, keys=p.keys, vv=p.vv, dot_id=p.dot_id,
        dot_n=p.dot_n, key_ix=p.key_ix, values=p.values, wall=p.wall)


@pytest.mark.parametrize("shard", [0, 3])
def test_from_arrays_round_trips_a_reference_store(shard):
    c, keys, _, _, _, _ = _schedule(ref_core, ref_store, use_kernel=False)
    ref = c.nodes["n0"].shard_stores[shard]
    d = _arrays(ref)
    port = PackedVersionStore.from_arrays(d)
    assert (port.digest_root(), port.value_root()) == \
        (ref.digest_root(), ref.value_root())
    back = port.to_arrays()
    for f in ("replica_ids", "keys", "values"):
        assert back[f] == d[f], f
    for f in ("vv", "dot_id", "dot_n", "key_ix", "wall"):
        np.testing.assert_array_equal(back[f], d[f], err_msg=f)
    assert port.check_digests()
    # the same operations on both keep them equal
    other = c.nodes["n3"].shard_stores[shard].payload()
    assert port.apply_payload(_port_payload(other)) == \
        ref.apply_payload(other)
    mine = [k for k in keys if k in ref._key_index][:3]
    upd = [(k, ref.context_of(k).ceiling_items(), f"w-{k}", 99.0)
           for k in mine]
    ref.update_keys(upd, "n0")
    port.update_keys(upd, "n0")
    assert (port.digest_root(), port.value_root()) == \
        (ref.digest_root(), ref.value_root())
    for k in ref.keys:
        assert sorted((v.clock.components, v.value)
                      for v in port.versions(k)) == \
            sorted((v.clock.components, v.value) for v in ref.versions(k))


def test_empty_store_round_trips():
    st = PackedVersionStore()
    st.intern_replica("n0")
    st.intern_key("k")
    back = PackedVersionStore.from_arrays(st.to_arrays())
    assert back.replica_ids == ["n0"] and back.keys == ["k"]
    assert back.digest_root() == st.digest_root() == 0


def test_durable_restart_matches_reference(tmp_path):
    def run(core, store, sub, **kw):
        c = store.KVCluster(("a", "b", "c"), core.DVV_MECHANISM,
                            replication=3, write_quorum=2, shards=4, seed=7,
                            wal_dir=str(tmp_path / sub),
                            wal_snapshot_every=4, wal_seal_bytes=600, **kw)
        for i in range(10):
            via = ("a", "b", "c")[i % 3]
            c.put(f"k{i % 4}", f"v{i}", via=via, coordinator=via)
            c.deliver_replication()
        c.network.fail_node("b")
        c.wal["b"].detach()
        for i in range(5):
            c.put(f"k{i % 4}", f"miss{i}", via="a", coordinator="a")
            c.deliver_replication()
        c.network.recover_node("b")
        stats = c.restart_node("b")
        c.deliver_replication()
        return ([repr(s) for s in stats],
                {(n, s): (st.digest_root(), st.value_root())
                 for n, node in c.nodes.items()
                 for s, st in enumerate(node.shard_stores)})

    assert run(port_core, port_store, "port", device="cpu") == \
        run(ref_core, ref_store, "ref")
