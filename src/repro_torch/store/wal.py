"""Durable write-ahead segment log + warm restart (DESIGN.md §14).

Every replica today is in-memory; a crash loses its dots and digest trees
and the only recovery is the PR-9 eviction → full O(store) re-bootstrap.
This module gives each node an append-only per-shard segment log so a
crashed process restarts *warm*: rebuild from the last packed-SoA snapshot
plus the log tail, then run exactly one PR-2 digest-diffed delta round to
fetch only what was missed while down.

Why logging post-states is sound: DVV store evolution is monotone in the
version-set join semilattice — every committed mutation's result dominates
what it replaced.  So the log records each changed key's *post-state*
(``REC_UPDATE``), and replaying records in order reconstructs the exact
final per-key sets (the last record per key dominates all earlier ones; a
periodic snapshot of the live store subsumes everything before it, so
replay cost is bounded by the tail, not history).

What durability means here: the store mutates *then* logs, so a crash
inside the very append that records a coordinated write loses that write
everywhere only if it was never replicated (``put`` raises before any
replication send).  The log is a *recovery accelerator* — replication
(W > 1) remains the durability story, and the §14 warm-restart protocol
closes any remaining gap with its one post-replay delta round against a
live peer.

Record framing (little-endian)::

    [u32 body_len][u32 crc32(kind ++ body)][u8 kind][body ...]

Bodies are pickled snapshots of wire-ready types (``PackedPayload``,
``Version`` sets).  Pickles name their classes' modules, so a log written
by this package (``repro_torch.store.packed.PackedPayload``) is not
readable by the JAX package's ``repro.store.wal``, nor the other way
round.  Torn-tail rule: on open, a segment is replayed up to
the first incomplete or checksum-failing record and truncated there
(atomically, via rewrite-rename) — everything before that point was
fsynced before the writer acknowledged anything, everything after is the
crash's garbage.

Manifest layout (one JSON doc per (node, shard) directory, written
atomically): the sealed-segment table (file, record count, byte length,
``ckpt.manifest.content_checksum``), the active segment name, and at most
one snapshot blob reference (a ``ckpt.manifest.ShardRecord``).  Every
crash window is safe because the manifest is the *only* naming authority:
a blob or segment the manifest does not reference is invisible garbage,
and the manifest itself flips atomically.

``CrashFS`` is the fuzzing harness: it counts every byte the log writes
and, given a byte budget, writes exactly that prefix and raises
``CrashPoint`` — simulating a power cut at any offset of a recorded
schedule.  After a crash it keeps raising (the process is dead).
"""
from __future__ import annotations

import json
import os
import pickle
import struct
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, FrozenSet, List, Optional, Tuple

from ..ckpt.atomic import atomic_write_bytes
from ..ckpt.manifest import ShardRecord, content_checksum
from .packed import PackedPayload, PackedVersionStore
from .sharding import shard_of_key
from .version import Version

# -- record codec -----------------------------------------------------------

REC_UPDATE = 1    # post-state of changed keys (PackedPayload / (key, set))
REC_KILL = 2      # key dropped entirely (tombstone GC hook)
REC_COMPACT = 3   # informational: a snapshot subsumed the log prefix
REC_EPOCH = 4     # cluster membership epoch marker

_HEADER = struct.Struct("<IIB")
_PROTO = 4        # pickle protocol for record bodies / snapshot blobs


def encode_record(kind: int, body: bytes) -> bytes:
    crc = zlib.crc32(bytes([kind]) + body) & 0xFFFFFFFF
    return _HEADER.pack(len(body), crc, kind) + body


def decode_records(data: bytes) -> Tuple[List[Tuple[int, bytes]], int]:
    """Decode a segment's valid prefix.

    Returns ``(records, good_bytes)`` where ``good_bytes`` is the offset of
    the first incomplete or checksum-failing record — the torn-tail
    truncation point.
    """
    out: List[Tuple[int, bytes]] = []
    off, n = 0, len(data)
    while n - off >= _HEADER.size:
        length, crc, kind = _HEADER.unpack_from(data, off)
        end = off + _HEADER.size + length
        if end > n:
            break
        body = data[off + _HEADER.size:end]
        if zlib.crc32(bytes([kind]) + body) & 0xFFFFFFFF != crc:
            break
        out.append((kind, body))
        off = end
    return out, off


# -- filesystem layer -------------------------------------------------------


class CrashPoint(Exception):
    """The simulated power cut: raised by ``CrashFS`` mid-write once its
    byte budget is exhausted (and on every operation thereafter)."""


class LocalFS:
    """The plain filesystem ops the log writes through.

    Kept as an object (rather than bare calls) so ``CrashFS`` can sit in
    front of *exactly* the operations whose partial effects matter.
    """

    def append(self, path: str, data: bytes) -> None:
        with open(path, "ab") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())

    def write_atomic(self, path: str, data: bytes) -> None:
        atomic_write_bytes(path, data)

    def read(self, path: str) -> Optional[bytes]:
        try:
            with open(path, "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def remove(self, path: str) -> None:
        try:
            os.remove(path)
        except FileNotFoundError:
            pass


class CrashFS(LocalFS):
    """Byte-budgeted crash injector.

    ``budget=None`` is the *recording* mode: nothing crashes, but every
    write's byte extent is recorded so a fuzz driver can enumerate kill
    offsets.  With a budget, writes spend it byte by byte; the write that
    would exceed it persists only the affordable prefix (appends) or
    nothing (atomic writes — the temp file never gets renamed) and raises
    ``CrashPoint``.  A crashed fs stays crashed.
    """

    def __init__(self, budget: Optional[int] = None):
        self.budget = budget
        self.written = 0
        self.crashed = False
        #: (op, path, start, end) byte extents of every write issued.
        self.extents: List[Tuple[str, str, int, int]] = []

    def _allow(self, n: int) -> int:
        if self.crashed:
            raise CrashPoint("filesystem already crashed")
        if self.budget is None:
            return n
        return max(0, min(n, self.budget - self.written))

    def append(self, path: str, data: bytes) -> None:
        allow = self._allow(len(data))
        self.extents.append(
            ("append", path, self.written, self.written + len(data)))
        if allow:
            super().append(path, data[:allow])
        self.written += allow
        if allow < len(data):
            self.crashed = True
            raise CrashPoint(f"crash at byte {self.written} (torn append)")

    def write_atomic(self, path: str, data: bytes) -> None:
        allow = self._allow(len(data))
        self.extents.append(
            ("atomic", path, self.written, self.written + len(data)))
        if allow < len(data):
            # Temp file dies unrenamed: the target keeps its old content.
            self.written += allow
            self.crashed = True
            raise CrashPoint(f"crash at byte {self.written} (atomic write)")
        super().write_atomic(path, data)
        self.written += len(data)

    def read(self, path: str) -> Optional[bytes]:
        if self.crashed:
            raise CrashPoint("filesystem already crashed")
        return super().read(path)

    def remove(self, path: str) -> None:
        if self.crashed:
            raise CrashPoint("filesystem already crashed")
        super().remove(path)


# -- per-shard segment log --------------------------------------------------


@dataclass
class ReplayStats:
    """What a warm restore read back (per node, summed over shard logs)."""
    records: int = 0
    snapshot_bytes: int = 0
    tail_bytes: int = 0
    torn_bytes: int = 0
    epoch: int = 0

    def merge(self, other: "ReplayStats") -> None:
        self.records += other.records
        self.snapshot_bytes += other.snapshot_bytes
        self.tail_bytes += other.tail_bytes
        self.torn_bytes += other.torn_bytes
        self.epoch = max(self.epoch, other.epoch)


class SegmentLog:
    """One shard's append-only segments + snapshot + manifest.

    Directory layout (under ``root/node/shard-NN/``)::

        MANIFEST.json      atomic naming authority (see module docstring)
        seg-000003.log     sealed + active segments
        snap-000001.bin    at most one referenced snapshot blob

    ``snapshot_source`` is attached by ``DurableLog`` and returns the
    *live* full-state blob; because the store mutates before it logs, the
    blob taken right after appending record N subsumes records 1..N.
    """

    MANIFEST = "MANIFEST.json"

    def __init__(self, root: str, node_id: str, shard: int, *,
                 fs: Optional[LocalFS] = None,
                 snapshot_every: int = 64, seal_bytes: int = 1 << 15):
        self.dir = os.path.join(root, node_id, f"shard-{shard:02d}")
        # Directory creation is not crash-fuzzed: an empty directory
        # carries no state, so a crash around mkdir is trivially safe.
        os.makedirs(self.dir, exist_ok=True)
        self.fs = fs if fs is not None else LocalFS()
        self.node_id = node_id
        self.shard = shard
        self.snapshot_every = snapshot_every
        self.seal_bytes = seal_bytes
        self.snapshot_source: Optional[Callable[[], bytes]] = None
        self._open()

    # -- manifest ----------------------------------------------------------

    def _path(self, name: str) -> str:
        return os.path.join(self.dir, name)

    def _open(self) -> None:
        raw = self.fs.read(self._path(self.MANIFEST))
        if raw is None:
            self.segments: List[Dict[str, Any]] = []
            self.snapshot_rec: Optional[ShardRecord] = None
            self.next_seg = 1
            self.next_snap = 1
            self.active = "seg-000000.log"
            self.active_bytes = 0
            self.active_records = 0
            self.records_since_snapshot = 0
            return
        d = json.loads(raw.decode())
        self.segments = list(d["segments"])
        self.snapshot_rec = (
            ShardRecord(**dict(d["snapshot"],
                               shape=tuple(d["snapshot"]["shape"])))
            if d["snapshot"] else None)
        self.next_seg = d["next_seg"]
        self.next_snap = d["next_snap"]
        self.active = d["active"]
        # Counters for the active segment are recovered lazily by load();
        # until then assume the manifest's view (safe: sealing/snapshots
        # only ever under-fire before a load()).
        self.active_bytes = 0
        self.active_records = 0
        self.records_since_snapshot = 0

    def _write_manifest(self) -> None:
        d = {
            "node": self.node_id, "shard": self.shard,
            "segments": self.segments,
            "snapshot": (dict(vars(self.snapshot_rec),
                              shape=list(self.snapshot_rec.shape))
                         if self.snapshot_rec else None),
            "next_seg": self.next_seg, "next_snap": self.next_snap,
            "active": self.active,
        }
        self.fs.write_atomic(self._path(self.MANIFEST),
                             json.dumps(d, sort_keys=True).encode())

    # -- writing -----------------------------------------------------------

    def append_record(self, kind: int, body: bytes) -> None:
        data = encode_record(kind, body)
        self.fs.append(self._path(self.active), data)
        self.active_bytes += len(data)
        self.active_records += 1
        self.records_since_snapshot += 1
        if self.active_bytes >= self.seal_bytes:
            self._seal()
        if (self.snapshot_source is not None
                and self.records_since_snapshot >= self.snapshot_every):
            self.take_snapshot()

    def _seal(self) -> None:
        """Freeze the active segment: checksum it into the manifest and
        start a fresh one.  Crash anywhere here → the manifest still names
        the old active, whose content replays identically."""
        data = self.fs.read(self._path(self.active)) or b""
        self.segments.append({
            "file": self.active, "records": self.active_records,
            "nbytes": len(data), "checksum": content_checksum(data)})
        self.active = f"seg-{self.next_seg:06d}.log"
        self.next_seg += 1
        self.active_bytes = 0
        self.active_records = 0
        self._write_manifest()

    def take_snapshot(self) -> None:
        """Snapshot the live store and retire the log prefix it subsumes.

        Order matters for crash safety: (1) write the blob atomically
        (unreferenced until named), (2) flip the manifest to reference it
        with a fresh empty active segment (the atomic commit point),
        (3) GC the now-orphaned old files (crash here merely leaks
        unreferenced bytes).
        """
        if self.snapshot_source is None:
            return
        blob = self.snapshot_source()
        fname = f"snap-{self.next_snap:06d}.bin"
        self.next_snap += 1
        self.fs.write_atomic(self._path(fname), blob)
        old = [s["file"] for s in self.segments] + [self.active]
        if self.snapshot_rec is not None:
            old.append(self.snapshot_rec.file)
        self.snapshot_rec = ShardRecord(
            path=f"{self.node_id}/shard-{self.shard:02d}", file=fname,
            shape=(len(blob),), dtype="bytes",
            checksum=content_checksum(blob))
        self.segments = []
        self.active = f"seg-{self.next_seg:06d}.log"
        self.next_seg += 1
        self.active_bytes = 0
        self.active_records = 0
        self.records_since_snapshot = 0
        self._write_manifest()
        for f in old:
            self.fs.remove(self._path(f))
        self.append_record(REC_COMPACT, pickle.dumps(
            {"snapshot": fname, "nbytes": len(blob)}, _PROTO))

    # -- reading -----------------------------------------------------------

    def load(self) -> Tuple[Optional[bytes], List[Tuple[int, bytes]],
                            ReplayStats]:
        """Reopen: verify the snapshot, replay sealed segments, truncate
        the active segment's torn tail (checksum-gated) on disk."""
        stats = ReplayStats()
        snap: Optional[bytes] = None
        if self.snapshot_rec is not None:
            snap = self.fs.read(self._path(self.snapshot_rec.file))
            if snap is None or content_checksum(snap) != \
                    self.snapshot_rec.checksum:
                # The manifest only ever names fully-written blobs
                # (write_atomic precedes the manifest flip), so a mismatch
                # is real corruption, not a crash artifact.
                raise IOError(
                    f"wal snapshot {self.snapshot_rec.file}: bad checksum")
            stats.snapshot_bytes = len(snap)
        records: List[Tuple[int, bytes]] = []
        for seg in self.segments:
            data = self.fs.read(self._path(seg["file"])) or b""
            if content_checksum(data) != seg["checksum"]:
                raise IOError(f"wal segment {seg['file']}: bad checksum")
            recs, good = decode_records(data)
            records.extend(recs)
            stats.tail_bytes += good
        data = self.fs.read(self._path(self.active)) or b""
        recs, good = decode_records(data)
        if good < len(data):
            stats.torn_bytes = len(data) - good
            self.fs.write_atomic(self._path(self.active), data[:good])
        records.extend(recs)
        stats.tail_bytes += good
        stats.records = len(records)
        self.active_bytes = good
        self.active_records = len(recs)
        self.records_since_snapshot = len(recs)
        return snap, records, stats


# -- per-node durable log ---------------------------------------------------


class DurableLog:
    """All of one node's shard logs, plus backend attachment and restore.

    Packed backends get one ``SegmentLog`` per shard store (records are
    per-shard streams, matching the per-shard digest trees); object
    backends route every key through shard logs by the same stable key
    hash, so the on-disk layout is backend-agnostic.
    """

    def __init__(self, root: str, node_id: str, *,
                 fs: Optional[LocalFS] = None,
                 snapshot_every: int = 64, seal_bytes: int = 1 << 15):
        self.root = root
        self.node_id = node_id
        self.fs = fs if fs is not None else LocalFS()
        self.snapshot_every = snapshot_every
        self.seal_bytes = seal_bytes
        self._logs: List[SegmentLog] = []
        self.node: Optional[Any] = None
        self.last_epoch = 0

    def _ensure_logs(self, n: int) -> List[SegmentLog]:
        while len(self._logs) < n:
            self._logs.append(SegmentLog(
                self.root, self.node_id, len(self._logs), fs=self.fs,
                snapshot_every=self.snapshot_every,
                seal_bytes=self.seal_bytes))
        return self._logs[:n]

    def _logs_for(self, node: Any) -> List[SegmentLog]:
        return self._ensure_logs(node.shards if node.is_packed else 1)

    # -- attachment --------------------------------------------------------

    def attach(self, node: Any) -> None:
        """Hook the backend's mutation funnels so every committed change
        appends a post-state record to its shard's log."""
        self.detach()
        self.node = node
        logs = self._logs_for(node)
        if node.is_packed:
            for st, lg in zip(node.shard_stores, logs):
                lg.snapshot_source = (
                    lambda s=st: pickle.dumps(s.payload(), _PROTO))
                st.wal_hook = (
                    lambda payload, lg=lg: lg.append_record(
                        REC_UPDATE, pickle.dumps(payload, _PROTO)))
        else:
            be = node.backend
            n = len(logs)
            for i, lg in enumerate(logs):
                lg.snapshot_source = (
                    lambda be=be, i=i, n=n: pickle.dumps(
                        {"store": {k: v for k, v in be.store.items()
                                   if shard_of_key(k, n) == i},
                         "max_wall": be.max_wall}, _PROTO))

            def _hook(key: str, merged: FrozenSet[Version],
                      logs=logs, n=n) -> None:
                logs[shard_of_key(key, n)].append_record(
                    REC_UPDATE, pickle.dumps((key, merged), _PROTO))

            be.wal_hook = _hook

    def detach(self) -> None:
        """Unhook (the pre-restore state: replay must not re-log)."""
        if self.node is None:
            return
        if self.node.is_packed:
            for st in self.node.shard_stores:
                st.wal_hook = None
        else:
            self.node.backend.wal_hook = None
        for lg in self._logs:
            lg.snapshot_source = None
        self.node = None

    # -- non-update records ------------------------------------------------

    def log_epoch(self, epoch: int, members: Tuple[str, ...]) -> None:
        """Membership epoch marker (node-level → shard-0 stream)."""
        self.last_epoch = epoch
        self._ensure_logs(1)[0].append_record(
            REC_EPOCH, pickle.dumps((epoch, members), _PROTO))

    def log_kill(self, key: str) -> None:
        """Drop a key everywhere: live store + a KILL record.

        This is the tombstone-GC hook — the store itself never forgets a
        key today, so only explicit reclamation calls this.
        """
        if self.node is None:
            raise RuntimeError("log_kill requires an attached node")
        node = self.node
        if node.is_packed:
            st = node.store_for(key)
            _packed_drop_key(st, key)
            lg = self._logs[shard_of_key(key, node.shards)]
        else:
            node.backend.store.pop(key, None)
            lg = self._logs[shard_of_key(key, len(self._logs))]
        lg.append_record(REC_KILL, pickle.dumps(key, _PROTO))

    # -- restore -----------------------------------------------------------

    def set_fs(self, fs: LocalFS) -> None:
        """Swap the filesystem layer — a restarted process gets a fresh,
        uncrashed handle onto the same on-disk bytes (the fuzzer's
        post-``CrashPoint`` move)."""
        self.fs = fs
        for lg in self._logs:
            lg.fs = fs

    def restore_into(self, node: Any) -> ReplayStats:
        """Warm restart: truncate torn tails, rebuild ``node``'s backend
        from snapshot + tail, then re-attach the logging hooks.

        Shard logs are re-opened from the on-disk manifests: the crashed
        writer's in-memory segment state can run *ahead* of disk (a seal
        or snapshot whose manifest flip never landed), and recovery must
        see exactly what a freshly exec'd process would."""
        self.detach()
        self._logs = []
        logs = self._logs_for(node)
        total = ReplayStats()
        if node.is_packed:
            for st, lg in zip(node.shard_stores, logs):
                snap, records, stats = lg.load()
                total.merge(stats)
                if snap is not None:
                    st.apply_payload(pickle.loads(snap))
                for kind, body in records:
                    if kind == REC_UPDATE:
                        st.apply_payload(pickle.loads(body))
                    elif kind == REC_KILL:
                        _packed_drop_key(st, pickle.loads(body))
                    elif kind == REC_EPOCH:
                        total.epoch = max(total.epoch,
                                          pickle.loads(body)[0])
        else:
            be = node.backend
            for lg in logs:
                snap, records, stats = lg.load()
                total.merge(stats)
                if snap is not None:
                    state = pickle.loads(snap)
                    for k, v in state["store"].items():
                        be.replace_key(k, v)
                    be.max_wall = max(be.max_wall, state["max_wall"])
                for kind, body in records:
                    if kind == REC_UPDATE:
                        key, merged = pickle.loads(body)
                        be.replace_key(key, merged)
                    elif kind == REC_KILL:
                        be.store.pop(pickle.loads(body), None)
                    elif kind == REC_EPOCH:
                        total.epoch = max(total.epoch,
                                          pickle.loads(body)[0])
        self.last_epoch = total.epoch
        self.attach(node)
        return total

    def reset(self) -> None:
        """Wipe all shard logs (a *fresh* join of a previously-known id
        must not resurrect pre-departure state).  Wipes by directory scan,
        not via open logs — the files may belong to an incarnation this
        process object never opened."""
        self.detach()
        self._logs = []
        node_dir = os.path.join(self.root, self.node_id)
        if os.path.isdir(node_dir):
            for shard_dir in os.listdir(node_dir):
                full = os.path.join(node_dir, shard_dir)
                if os.path.isdir(full):
                    for f in os.listdir(full):
                        self.fs.remove(os.path.join(full, f))

    # -- introspection -----------------------------------------------------

    def log_bytes(self) -> int:
        """Total bytes currently referenced by the manifests (snapshot +
        sealed + active) — the bench's log-overhead metric."""
        total = 0
        for lg in self._logs:
            if lg.snapshot_rec is not None:
                total += lg.snapshot_rec.shape[0]
            total += sum(s["nbytes"] for s in lg.segments)
            total += lg.active_bytes
        return total


def _packed_drop_key(store: PackedVersionStore, key: str) -> None:
    """Remove every live slot of ``key`` (KILL replay / tombstone GC).
    Reaches package-internal surface: kill + compact keep the digest tree
    and bucket index coherent, as ``check_digests`` verifies."""
    kix = store._key_index.get(key)
    if kix is None:
        return
    slots = list(store._slots_by_key.get(kix, []))
    if slots:
        store._kill_slots(kix, slots)
        store.compact()


__all__ = [
    "REC_UPDATE", "REC_KILL", "REC_COMPACT", "REC_EPOCH",
    "encode_record", "decode_records",
    "CrashPoint", "LocalFS", "CrashFS",
    "ReplayStats", "SegmentLog", "DurableLog",
]
