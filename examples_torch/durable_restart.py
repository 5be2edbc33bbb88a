"""Durability walkthrough: write, crash mid-write, come back warm.

A cluster built with ``wal_dir`` logs every replica's post-state changes
to per-shard segment logs (DESIGN.md §14).  This demo crashes node "b"
*mid-byte* with a ``CrashFS`` budget — the torn record is truncated on
reopen — lets the survivors keep writing, then warm-restarts b from its
log: snapshot + tail replay, plus one digest-diffed pull+push delta pass
per peer, and the cluster is digest-equal again.  Compare the resync
bytes against what a cold full-payload bootstrap would have shipped.

The PyTorch port of ``examples/durable_restart.py``: the same run and the
same output (but the WAL's byte counts: its bodies pickle the port's own
``PackedPayload``), with the cluster's batched planes on ``--device``.

Run:  PYTHONPATH=src python examples_torch/durable_restart.py [--device cpu]
"""
import argparse
import shutil
import tempfile

from repro_torch.core import DVV_MECHANISM
from repro_torch.store import (CrashFS, CrashPoint, KVCluster, LocalFS,
                               cluster_converged)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    tmp = tempfile.mkdtemp(prefix="dvv-wal-")
    fs = CrashFS(None)                       # recording mode for now
    cluster = KVCluster(("a", "b", "c"), DVV_MECHANISM, shards=4, seed=11,
                        replication=3, write_quorum=2, wal_dir=tmp,
                        wal_snapshot_every=8, wal_seal_bytes=2048,
                        wal_fs={"b": fs}, device=args.device)

    print("== phase 1: a working set, logged as it lands ==")
    for i in range(12):
        via = ("a", "b", "c")[i % 3]
        cluster.put(f"item/{i % 5}", f"rev{i}", via=via, coordinator=via)
        cluster.deliver_replication()
    print(f"  b's log: {cluster.wal['b'].log_bytes():,}B across "
          f"{len(cluster.wal['b']._logs)} shard streams")

    print("\n== phase 2: power cut mid-append on b ==")
    fs.budget = fs.written + 37              # dies 37 bytes from now
    try:
        for i in range(12, 24):
            cluster.put(f"item/{i % 5}", f"crash{i}", via="b",
                        coordinator="b")
            cluster.deliver_replication()
    except CrashPoint as e:
        print(f"  b crashed: {e}")
    cluster.network.fail_node("b")
    cluster.wal["b"].detach()

    print("\n== phase 3: the survivors move on without b ==")
    for i in range(6):
        cluster.put(f"item/{i % 5}", f"while-b-down{i}", via="a",
                    coordinator="a")
        cluster.deliver_replication()

    print("\n== phase 4: warm restart from the log ==")
    cluster.network.recover_node("b")
    cluster.wal["b"].set_fs(LocalFS())       # new process, same bytes
    stats = cluster.restart_node("b")
    cluster.deliver_replication()
    replay = cluster.last_replay
    warm = sum(s.payload_bytes + s.digest_bytes for s in stats)
    print(f"  replayed {replay.records} records "
          f"(snapshot {replay.snapshot_bytes:,}B + tail "
          f"{replay.tail_bytes:,}B, torn {replay.torn_bytes}B truncated)")
    print(f"  resync wire: {warm:,}B over {len(stats)} delta rounds")
    for st in cluster.nodes["b"].shard_stores:
        st.check_digests()                   # replay kept the trees exact
    print(f"  converged={cluster_converged(cluster)}")

    print("\n== the cold comparison: what a full bootstrap ships ==")
    cold = cluster.bootstrap_node("b")
    print(f"  bootstrap_node after the fact: "
          f"{sum(s.payload_bytes + s.digest_bytes for s in cold):,}B "
          f"(mostly digests now — but an *empty* returnee pays the "
          f"whole payload; see BENCH_durable.json)")

    shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
