"""A cluster that runs itself: continuous gossip under live churn.

Everything previous examples did by hand — delivering replication,
cranking anti-entropy rounds — happens here as a side effect of simulated
time passing: a ``GossipDriver`` owns per-node timers on the SimNetwork
heap, adapts each node's cadence and range budget to the divergence it
observes, and follows the membership as nodes join (bootstrapping warm),
fail, recover and depart.

The PyTorch port of ``examples/gossip_churn.py``: the same run and the same
output, with the cluster's batched planes on ``--device``.

Run:  PYTHONPATH=src python examples_torch/gossip_churn.py [--device cpu]
"""
import argparse
import random

from repro_torch.core import DVV_MECHANISM
from repro_torch.store import (GossipDriver, KVClient, KVCluster,
                               SimNetwork, cluster_converged)


def status(c, d, label):
    ivs = ", ".join(f"{n}:{iv:.0f}s"
                    for n, iv in sorted(d.intervals().items()))
    print(f"  [{label}] t={c.network.now:7.1f}  "
          f"converged={cluster_converged(c)}"
          f"  wire={d.wire_bytes():,}B  intervals {{{ivs}}}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    net = SimNetwork(seed=42)
    cluster = KVCluster(("a", "b", "c"), DVV_MECHANISM, network=net, seed=42,
                        device=args.device)
    driver = GossipDriver(cluster, period=10.0, seed=42)
    client = KVClient(cluster, "cart-client")

    print("== write a working set; gossip converges it unattended ==")
    rng = random.Random(0)
    for i in range(30):
        node = rng.choice(list(cluster.nodes))
        client.put(f"item/{i % 8}", f"rev{i}", via=node)
        driver.run_for(2.0)
    driver.run_for(120.0)
    status(cluster, driver, "steady")

    print("\n== idle cluster: cadences back off to a digest heartbeat ==")
    driver.run_for(400.0)
    status(cluster, driver, "idle")

    print("\n== a node joins and bootstraps warm (ranked digest catch-up) ==")
    stats = cluster.add_node("d")
    print(f"  bootstrap: {len(stats)} pulls, "
          f"{sum(s.payload_slots for s in stats)} versions, "
          f"{sum(s.payload_bytes for s in stats):,}B payload")
    print(f"  d now stores {cluster.nodes['d'].total_keys()} keys")
    driver.run_for(60.0)
    status(cluster, driver, "joined")

    print("\n== node b dies mid-traffic; the survivors keep converging ==")
    net.fail_node("b")
    for i in range(10):
        client.put(f"item/{i % 8}", f"outage-rev{i}", via="a")
        driver.run_for(3.0)
    driver.run_for(60.0)
    status(cluster, driver, "b down")

    print("\n== b recovers: the topology wake-up snaps cadences back ==")
    net.recover_node("b")
    driver.run_for(60.0)
    status(cluster, driver, "healed")
    got = client.get("item/0", via="b")
    print(f"  read-your-recovery at b: item/0 = {got.value!r} "
          f"({got.siblings} sibling)")

    print("\n== node a is decommissioned; the cluster shrinks cleanly ==")
    cluster.remove_node("a")
    client.via = "c"
    client.put("item/0", "final-rev", via="c")
    driver.run_for(120.0)
    status(cluster, driver, "removed")
    print(f"  members: {sorted(cluster.nodes)}  "
          f"driver: {driver.ticks} ticks, {driver.rounds} rounds")


if __name__ == "__main__":
    main()
