#!/usr/bin/env python3
"""Drive the PyTorch port of the DVV store on one CUDA card.

    python3 chip_smoke.py [--seed 0]

Phases, each printed as one JSON line; a failure in any phase raises and
exits non-zero:

  device   the card (nvidia-smi name and power limit), torch and CUDA
           versions, and the time to build the dvv_ops kernels with nvcc.
  kernels  each CUDA kernel against its plain torch version on the card,
           on random clock sets from --seed, at the store's bucket shapes
           and at one large shape: exact equality (bool and int outputs,
           so no tolerance), kernel and plain times from CUDA events, and
           the bound (bytes or int32 operations) computed from the inputs.
  store    the port's KVClient/KVCluster on the card, deployed as Riak KV's
           documented DVV setup (5 nodes, n_val=3, r=w=2, a 64-partition
           ring): put 262,144 keys with 64-byte values, partition
           {n0,n1}|{n2,n3,n4}, overwrite 10% of the keys on both sides
           with their pre-partition contexts, heal, run delta rounds until
           every shard's replicas agree, read every key at quorum 2, and
           check every acknowledged write comes back.  The launch counters
           are zeroed just before and read just after.
  parity   the same schedule at 16,384 keys through the kernels and
           through the numpy twins (use_kernel=False): identical digest and
           value roots for every store, identical reads.
  trace    the 16,384-key schedule once more under torch.profiler,
           tracing the card only: device-busy seconds against wall seconds
           (the device's idle share) and each kernel's device time per
           launch at the shapes the store gives it.

Kernel "ms"/"plain_ms" are CUDA-event times per call, so they include the
host's cost of issuing each call; "device_ms" is the profiler's device
time per call alone.

The last lines are the per-kernel JSON summary, the nvidia-smi line, and
{"ok": true, "device": {...}}.  Without a CUDA device the script exits
non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

NODES = ("n0", "n1", "n2", "n3", "n4")
SIDE_A, SIDE_B = frozenset({"n0", "n1"}), frozenset({"n2", "n3", "n4"})
STORE_KEYS = 262144          # cut from 1,048,576 for the run's time limit
PARITY_KEYS = 16384
BATCH = 4096
VALUE_BYTES = 64
KERNEL_SHAPES = ((64, 2, 8), (4096, 4, 8), (16384, 4, 8), (1048576, 8, 8))
SUMMARY_SHAPE = (4096, 4, 8)

# H100 SXM peaks (NVIDIA data sheet and Hopper white paper): 3.35 TB/s of
# HBM3; int32 outside the tensor cores is 64 lanes per SM on 132 SMs at the
# 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
OPS_PER_COLUMN = 2            # one compare and one fold per column


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def clock_sets(rng, N, K, R):
    """Random encoded clock sets: ranges 0..5, a dot above its column on
    most clocks, about 15% invalid slots."""
    import numpy as np
    vvs = rng.integers(0, 6, (N, K, R), dtype=np.int32)
    dids = rng.integers(-1, R, (N, K), dtype=np.int32)
    at = np.take_along_axis(vvs, np.clip(dids, 0, None)[..., None],
                            axis=-1)[..., 0]
    dns = np.where(dids >= 0, at + rng.integers(1, 3, (N, K)),
                   0).astype(np.int32)
    valid = rng.random((N, K)) < 0.85
    return vvs, dids, dns, valid


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call from CUDA events, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_profile(fn):
    """Run ``fn`` under torch.profiler tracing the card only (CUPTI).
    Returns the total device-busy microseconds and ``{name: (count,
    total_us)}`` per device event, or ``(0.0, {})`` if the trace holds no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per = {e.key: (e.count, e.self_device_time_total)
           for e in prof.key_averages() if e.self_device_time_total > 0}
    return sum(us for _, us in per.values()), per


def device_ms(fn, reps: int):
    """Mean device milliseconds per call from the profiler, after one
    warm-up; None where the trace shows no device time."""
    import torch
    fn()
    torch.cuda.synchronize()
    busy_us, _ = device_profile(lambda: [fn() for _ in range(reps)])
    return busy_us / reps / 1e3 if busy_us else None


def bound(nbytes: int, ops: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(got, want) -> int:
    import torch
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
        if got.numel() else 0


def kernels_phase(seed: int):
    import numpy as np
    import torch
    from repro_torch.kernels.dvv_ops import ops, ref

    dev = torch.device("cuda")
    rows = []
    for N, K, R in KERNEL_SHAPES:
        rng = np.random.default_rng([seed, N, K, R])
        vvs, dids, dns, valid = (torch.from_numpy(a).to(dev)
                                 for a in clock_sets(rng, N, K, R))
        nv = valid.sum(dim=1, dtype=torch.int64)
        pairs = int((nv * (nv - 1)).sum())      # ordered valid pairs
        sweep_ops = 2 * pairs * R * OPS_PER_COLUMN
        sweep_in = N * K * (4 * R + 9)
        reps = 5 if N >= 1 << 20 else 50
        plain_reps = 2 if N >= 1 << 20 else 10

        mask = ops.dvv_sync_mask(vvs, dids, dns, valid)
        smask, ceil = ops.dvv_read_sweep(vvs, dids, dns, valid)
        want_mask, want_ceil = ref.read_sweep_ref(vvs, dids, dns, valid)
        torch.cuda.synchronize()
        errs = {"dvv_sync_mask": max_abs_err(mask, want_mask),
                "dvv_read_sweep": max(max_abs_err(smask, want_mask),
                                      max_abs_err(ceil, want_ceil))}
        # dvv_leq on the key's first two slots as N flat pairs
        vx, vy = vvs[:, 0].contiguous(), vvs[:, 1 % K].contiguous()
        ix, iy = dids[:, 0].contiguous(), dids[:, 1 % K].contiguous()
        nx, ny = dns[:, 0].contiguous(), dns[:, 1 % K].contiguous()
        errs["dvv_leq"] = max_abs_err(ops.dvv_leq(vx, ix, nx, vy, iy, ny),
                                      ref.leq_ref(vx, ix, nx, vy, iy, ny))
        specs = {
            "dvv_sync_mask": (
                lambda: ops.dvv_sync_mask(vvs, dids, dns, valid),
                lambda: ref.sync_mask_ref(vvs, dids, dns, valid),
                sweep_in + N * K, sweep_ops),
            "dvv_read_sweep": (
                lambda: ops.dvv_read_sweep(vvs, dids, dns, valid),
                lambda: ref.read_sweep_ref(vvs, dids, dns, valid),
                sweep_in + N * K + N * R * 8,
                sweep_ops + N * K * R),
            "dvv_leq": (
                lambda: ops.dvv_leq(vx, ix, nx, vy, iy, ny),
                lambda: ref.leq_ref(vx, ix, nx, vy, iy, ny),
                N * (8 * R + 16) + N, N * R * OPS_PER_COLUMN),
        }
        for name, (kern, plain, nbytes, nops) in specs.items():
            if errs[name]:
                raise AssertionError(
                    f"{name} disagrees with its plain version at "
                    f"{(N, K, R)}: max abs err {errs[name]}")
            b_ms, b_by = bound(nbytes, nops)
            rows.append({"name": name, "shape": [N, K, R],
                         "max_abs_err": errs[name],
                         "ms": cuda_ms(kern, reps),
                         "plain_ms": cuda_ms(plain, plain_reps),
                         "device_ms": device_ms(kern, reps),
                         "plain_device_ms": device_ms(plain, plain_reps),
                         "bound_ms": b_ms, "bound_by": b_by,
                         "bytes": nbytes, "int32_ops": nops})
        del vvs, dids, dns, valid, mask, smask, ceil, want_mask, want_ceil
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# store
# ---------------------------------------------------------------------------

def values_for(seed: int, n: int, tag: str):
    """``n`` distinct 64-byte string values made from ``seed``: the tag, the
    index in hex, and random hex filler."""
    import numpy as np
    hexed = np.random.default_rng([seed, *tag.encode()]).bytes(
        VALUE_BYTES * n // 2).hex()
    head = len(tag) + 8
    return [f"{tag}{i:08x}" + hexed[i * VALUE_BYTES + head:
                                    (i + 1) * VALUE_BYTES]
            for i in range(n)]


def converged(c) -> bool:
    """Every shard's replica set agrees on digest and value roots."""
    for s, owners in enumerate(c._placement):
        roots = {(c.nodes[n].shard_stores[s].digest_root(),
                  c.nodes[n].shard_stores[s].value_root()) for n in owners}
        if len(roots) != 1:
            return False
    return True


def run_schedule(n_keys: int, seed: int, *, device="cuda",
                 use_kernel=True, max_rounds: int = 4):
    """The store phase's schedule; returns the cluster, the reads, the
    expected value set per key and seconds per step."""
    from repro_torch.core import DVV_MECHANISM
    from repro_torch.store import KVClient, KVCluster, SimNetwork

    secs = {}
    c = KVCluster(NODES, DVV_MECHANISM, replication=3, read_quorum=2,
                  write_quorum=2, shards=64, seed=seed,
                  network=SimNetwork(seed=seed), device=device)
    cl = KVClient(c, "smoke", via="n0", use_kernel=use_kernel)
    keys = [f"key-{i:08d}" for i in range(n_keys)]
    vals = values_for(seed, n_keys, "v0-")
    expect = {k: {v} for k, v in zip(keys, vals)}

    t = time.perf_counter()
    acked = 0
    for i in range(0, n_keys, BATCH):
        acked += len(cl.put_many(dict(zip(keys[i: i + BATCH],
                                          ((v, None) for v in
                                           vals[i: i + BATCH])))))
    c.deliver_replication()
    secs["put"] = time.perf_counter() - t

    # Fork 10% of the keys: those whose replicas sit on both sides.  Each
    # side overwrites them with the pre-partition context, so both writes
    # supersede the first value and neither sees the other.
    t = time.perf_counter()
    forked = [k for k in keys if SIDE_A & set(c.replicas_for(k))
              and SIDE_B & set(c.replicas_for(k))][: n_keys // 10]
    ctx = {}
    for i in range(0, len(forked), BATCH):
        ctx.update({k: r.context for k, r in
                    cl.get_many(forked[i: i + BATCH], quorum=2).items()})
    c.network.partition(SIDE_A, SIDE_B)
    sides = {via: values_for(seed, len(forked), tag)
             for via, tag in (("n0", "a-"), ("n2", "b-"))}
    for via, fvals in sides.items():
        for i in range(0, len(forked), BATCH):
            part = forked[i: i + BATCH]
            acked += len(cl.put_many(
                {k: (v, ctx[k]) for k, v in zip(part, fvals[i: i + BATCH])},
                via=via, quorum=1))
    for k, a, b in zip(forked, sides["n0"], sides["n2"]):
        expect[k] = {a, b}
    c.deliver_replication()
    c.network.heal()
    secs["fork"] = time.perf_counter() - t

    t = time.perf_counter()
    rounds = 0
    while not converged(c):
        if rounds == max_rounds:
            raise AssertionError(f"not converged after {rounds} rounds")
        c.delta_antientropy_round(use_kernel=use_kernel, max_ranges=None)
        rounds += 1
    secs["heal"] = time.perf_counter() - t

    t = time.perf_counter()
    reads = {}
    for i in range(0, n_keys, BATCH):
        reads.update(cl.get_many(keys[i: i + BATCH], quorum=2))
    secs["read"] = time.perf_counter() - t
    return c, keys, forked, expect, reads, acked, rounds, secs


def check_reads(keys, expect, reads) -> None:
    """Every acknowledged write is read back, and nothing else: a forked
    key shows exactly its two siblings, any other key its one value."""
    for k in keys:
        if set(reads[k].values) != expect[k] or \
                reads[k].siblings != len(expect[k]):
            raise AssertionError(f"{k}: read {reads[k].values}, "
                                 f"expected {sorted(expect[k])}")


def store_phase(n_keys: int, seed: int, device="cuda"):
    from repro_torch.kernels import dvv_ops

    dvv_ops.reset_launches()
    c, keys, forked, expect, reads, acked, rounds, secs = run_schedule(
        n_keys, seed, device=device)
    launches = dict(dvv_ops.launches)
    check_reads(keys, expect, reads)
    if c.device.type == "cuda":
        for name in ("dvv_sync_mask", "dvv_read_sweep"):
            if launches[name] == 0:
                raise AssertionError(f"{name} never launched in the store "
                                     f"phase: {launches}")
    return {"phase": "store", "keys": n_keys, "forked": len(forked),
            "acked_writes": acked, "delta_rounds": rounds,
            "seconds": secs, "launches": launches,
            "buckets": {
                "sync_mask": dvv_ops.dvv_sync_mask_bucketed(device)
                .cache_info(),
                "read_sweep": dvv_ops.dvv_read_sweep_bucketed(device)
                .cache_info()}}


def parity_phase(n_keys: int, seed: int, device="cuda"):
    runs = {}
    for use_kernel in (True, False):
        c, keys, forked, expect, reads, _, _, _ = run_schedule(
            n_keys, seed, device=device, use_kernel=use_kernel)
        check_reads(keys, expect, reads)
        runs[use_kernel] = (
            {(n, s): (st.digest_root(), st.value_root())
             for n, node in c.nodes.items()
             for s, st in enumerate(node.shard_stores)},
            {k: (r.values, r.context.to_bytes(), r.resolution)
             for k, r in reads.items()})
    if runs[True][0] != runs[False][0]:
        raise AssertionError("store roots differ between kernel and twin")
    if runs[True][1] != runs[False][1]:
        raise AssertionError("reads differ between kernel and twin")
    return {"phase": "parity", "keys": n_keys,
            "stores_compared": len(runs[True][0]),
            "reads_compared": len(runs[True][1])}


def trace_phase(n_keys: int, seed: int):
    """The store schedule once more, traced on the card alone: how busy
    the device was over the run's wall time, and per-launch device time
    of each dvv_ops kernel at the main path's own shapes."""
    t = time.perf_counter()
    busy_us, per = device_profile(lambda: run_schedule(n_keys, seed))
    wall_s = time.perf_counter() - t
    kernels = {}
    for name in ("dvv_sync_mask", "dvv_read_sweep", "dvv_leq"):
        hits = [(n, us) for key, (n, us) in per.items()
                if f"{name}_kernel" in key]
        n = sum(c for c, _ in hits)
        kernels[name] = {"launches": n, "device_us_per_launch":
                         sum(us for _, us in hits) / n if n else None}
    return {"phase": "trace", "keys": n_keys, "wall_s": wall_s,
            "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1 - busy_us / 1e6 / wall_s
            if busy_us else None,
            "kernels": kernels,
            "top_device_events": sorted(
                ({"name": k[:80], "count": c, "us": us}
                 for k, (c, us) in per.items()),
                key=lambda e: -e["us"])[:8]}


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from repro_torch.kernels.dvv_ops import dvv_ops

    smi = nvidia_smi()
    t = time.perf_counter()
    dvv_ops.build()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_seconds": time.perf_counter() - t,
          "nvcc_log": str(dvv_ops.build_info.get("log", ""))[-1500:]})

    rows = kernels_phase(args.seed)
    emit({"phase": "kernels", "rows": rows})
    store = store_phase(STORE_KEYS, args.seed)
    emit(store)
    emit(parity_phase(PARITY_KEYS, args.seed))
    trace = trace_phase(PARITY_KEYS, args.seed)
    emit(trace)

    replaces = {
        "dvv_sync_mask": "src/repro/kernels/dvv_ops/dvv_ops.py:95",
        "dvv_read_sweep": "src/repro/kernels/dvv_ops/ops.py:47",
        "dvv_leq": "src/repro/kernels/dvv_ops/dvv_ops.py:140",
    }
    summary = []
    for r in rows:
        if tuple(r["shape"]) != SUMMARY_SHAPE:
            continue
        summary.append({
            "name": r["name"], "route": "cuda",
            "source": "src/repro_torch/kernels/dvv_ops/csrc/dvv_ops.cu",
            "replaces": replaces[r["name"]],
            "launches": store["launches"][r["name"]],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "shape": r["shape"], "device_ms": r["device_ms"],
            "main_path_device_us_per_launch":
                trace["kernels"][r["name"]]["device_us_per_launch"]})
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
