"""Sharded stores on the vnode ring: cache-sized shards, K/N rebalance.

``KVCluster(..., shards=S)`` splits every replica's packed store into S
shard-local stores (DESIGN.md §10).  Placement is one blake2b-8 hash +
one table index (the vnode consistent-hash ring is consulted only on
membership change); gossip runs one plane per shard, opening each with a
32-byte root probe so converged shards cost two int compares; and a
join/leave moves only the shards whose ring walk changed — the joiner's
~K/N share, never the whole store.

The PyTorch port of ``examples/sharded_cluster.py``: the same run and the same
output, with the cluster's batched planes on ``--device``.

Run:  PYTHONPATH=src python examples_torch/sharded_cluster.py [--device cpu]
"""
import argparse
from repro_torch.core import DVV_MECHANISM
from repro_torch.store import (GossipDriver, KVCluster, SimNetwork,
                               cluster_converged)


def shard_histogram(node):
    sizes = [len(st.keys) for st in node.shard_stores]
    return f"{len(sizes)} shards, {min(sizes)}–{max(sizes)} keys each"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    net = SimNetwork(seed=7)
    cluster = KVCluster([f"n{i}" for i in range(4)], DVV_MECHANISM,
                        replication=2, network=net, seed=7,
                        shards=16,                      # <- the new knob
                        device=args.device)
    driver = GossipDriver(cluster, period=8.0, seed=7)

    print("== 2,000 keys spread over 16 shard-local stores ==")
    for i in range(2000):
        cluster.put(f"user/{i}", f"profile-{i}")
    cluster.deliver_replication()
    driver.run_for(200.0)
    print(f"  converged={cluster_converged(cluster)}  "
          f"n0 holds {shard_histogram(cluster.nodes['n0'])}")

    print("\n== join: warm bootstrap pulls ONLY the joiner's shards ==")
    stats = cluster.add_node("n4")
    moved = sum(s.payload_bytes for s in stats)
    owned = len(cluster._owned["n4"])
    print(f"  n4 owns {owned}/16 shards; pulled {moved:,}B "
          f"({sum(s.changed for s in stats)} keys) — its K/N share")
    driver.run_for(200.0)
    print(f"  converged={cluster_converged(cluster)}")

    print("\n== planned departure: handoff covers only moved shards ==")
    cluster.remove_node("n2")
    driver.run_for(200.0)
    print(f"  converged={cluster_converged(cluster)}  "
          f"reads still serve: user/42 -> "
          f"{cluster.get('user/42').values[0]!r}")


if __name__ == "__main__":
    main()
