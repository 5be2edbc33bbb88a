"""Two datacenters, one key space: the geo tier end to end.

A six-node cluster spans ``east`` and ``west``.  Writes commit against a
local-DC quorum (no WAN round trip on the write path), a ``WanShipper``
carries committed versions across the ocean asynchronously on digest-
diffed delta rounds, every version is stamped with a hybrid logical
clock, and each DC maintains a Global Stable Frontier — the wall below
which everything is locally visible.  ``snapshot_get`` serves causally
consistent (possibly stale) reads from local replicas only: zero WAN
messages, even while the other DC is partitioned away.

The PyTorch port of ``examples/geo_replication.py``: the same run and the same
output, with the cluster's batched planes on ``--device``.

Run:  PYTHONPATH=src python examples_torch/geo_replication.py [--device cpu]
"""
import argparse
import random

from repro_torch.core import DVV_MECHANISM
from repro_torch.store import GossipDriver, KVClient, KVCluster, SimNetwork

DCS = {"east": ("e0", "e1", "e2"), "west": ("w0", "w1", "w2")}
EAST, WEST = set(DCS["east"]), set(DCS["west"])


def status(c, label):
    g = c.geo
    fr = {dc: f"{g.stable_frontier(dc):.1f}" for dc in g.dc_names}
    print(f"  [{label}] t={c.network.now:8.1f}  frontiers={fr}  "
          f"wan_msgs={c.network.wan_messages}  ship={g.ship_bytes:,}B")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    net = SimNetwork(seed=7)
    net.set_latency_classes(lan=(1.0, 0.5), wan=(40.0, 10.0))
    cluster = KVCluster(tuple(n for ns in DCS.values() for n in ns),
                        DVV_MECHANISM, network=net, seed=7,
                        datacenters=DCS, wan_period=25.0,
                        device=args.device)
    driver = GossipDriver(cluster, period=10.0, seed=7)
    client = KVClient(cluster, "geo-client")

    print("== writes commit on local quorums; the shipper carries them ==")
    rng = random.Random(0)
    for i in range(24):
        home = "east" if i % 3 else "west"
        node = rng.choice(DCS[home])
        ack = client.put(f"user/{i % 6}", f"rev{i}", via=node)
        driver.run_for(4.0)
        if i == 0:
            wall = cluster.nodes[ack.coordinator].max_wall
            print(f"  first put: wall={wall:.1f} coordinator={ack.coordinator}"
                  f" replicated_to={sorted(ack.replicated_to)} "
                  f"({home} only)")
    driver.run_for(200.0)
    status(cluster, "steady")

    print("\n== snapshot reads: causal, local-DC only, zero WAN traffic ==")
    wan_before = net.wan_messages
    snap = client.snapshot_get("user/0", via="w0")
    print(f"  west snapshot user/0 = {snap.value!r} "
          f"(frontier={cluster.geo.stable_frontier('west'):.1f}, "
          f"wan msgs used: {net.wan_messages - wan_before})")

    print("\n== the ocean cable is cut: snapshots keep serving ==")
    net.partition(EAST, WEST)
    for i in range(6):
        client.put(f"user/{i}", f"cutrev{i}", via="e0")
        driver.run_for(5.0)
    lag = cluster.geo.frontier_lag("west")
    snap = client.snapshot_get("user/0", via="w1")
    print(f"  west still answers: user/0 = {snap.value!r} "
          f"(stale by {lag:.0f} ticks — east's cut-era writes are pending)")
    many = client.snapshot_get_many([f"user/{i}" for i in range(6)], via="w2")
    print(f"  snapshot_get_many: {len(many)} keys from local replicas")

    print("\n== heal: delta rounds drain the backlog, frontiers catch up ==")
    net.heal()
    driver.run_for(300.0)
    while cluster.geo.frontier_lag("west") > 0.0:
        cluster.geo.wan_round()
        cluster.delta_antientropy_round()
    status(cluster, "healed")
    east_read = client.get("user/0", via="e1")
    west_snap = client.snapshot_get("user/0", via="w1")
    print(f"  east quorum read == west snapshot: "
          f"{east_read.value!r} == {west_snap.value!r} "
          f"-> {east_read.value == west_snap.value}")

    print("\n== HLC: walls order causally-related writes across DCs ==")
    r = client.get("user/5", via="e2")
    a1 = client.put("user/5", "seen-in-east", r.context, via="e2")
    w1 = max(v.wall for v in cluster.nodes[a1.coordinator].versions("user/5"))
    cluster.geo.wan_round()
    r = client.get("user/5", via="w0")
    a2 = client.put("user/5", "then-west", r.context, via="w0")
    w2 = max(v.wall for v in cluster.nodes[a2.coordinator].versions("user/5"))
    print(f"  east wall {w1:.6f} < west wall {w2:.6f} -> {w1 < w2}")


if __name__ == "__main__":
    main()
