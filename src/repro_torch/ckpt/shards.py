"""Bulk shard I/O — array bytes on (simulated) blob storage.

Arrays are saved per logical path; on real hardware each host writes only
its addressable shards (the manifest records the global layout so restore
can re-shard onto a different mesh).  Checksums let restores detect torn or
corrupted writes — a manifest referencing a bad shard is rejected and the
manager falls back to the parent lineage.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Tuple

import numpy as np

from .atomic import atomic_write
from .manifest import ShardRecord, content_checksum


def _blob_name(run_id: str, step: int, path: str, writer: str) -> str:
    # Writer-namespaced: concurrent coordinators finalizing the same step
    # (post-partition) must not clobber each other's bytes — the DVV
    # manifest layer decides which lineage wins, and its shards must still
    # exist intact.
    safe = path.replace("/", "__")
    return f"{run_id}-step{step:08d}-{writer}-{safe}.npy"


def _c_bytes(value: np.ndarray):
    """The array's bytes in C order (what ``tobytes`` gives), without a
    copy where the array is C-contiguous."""
    return value.data if value.flags.c_contiguous else value.tobytes()


def save_array(root: str, run_id: str, step: int, path: str,
               value: np.ndarray, writer: str = "w") -> ShardRecord:
    os.makedirs(root, exist_ok=True)
    fname = _blob_name(run_id, step, path, writer)
    full = os.path.join(root, fname)
    value = np.asarray(value)
    # temp → fsync → rename: a crash mid-save leaves either no blob or the
    # complete blob, never a torn .npy that a later manifest could
    # reference.  np.save writes the array's own buffer, and the checksum
    # hashes that buffer in a second thread meanwhile (both release the
    # interpreter lock): no copy of the array is made.
    with ThreadPoolExecutor(1) as pool:
        digest = pool.submit(content_checksum, _c_bytes(value))
        atomic_write(full, lambda f: np.save(f, value))
        checksum = digest.result()
    return ShardRecord(path=path, file=fname, shape=tuple(value.shape),
                       dtype=str(value.dtype), checksum=checksum)


def load_array(root: str, record: ShardRecord, *,
               verify: bool = True) -> np.ndarray:
    full = os.path.join(root, record.file)
    value = np.load(full)
    if tuple(value.shape) != tuple(record.shape) or str(value.dtype) != record.dtype:
        raise IOError(f"shard {record.file}: shape/dtype mismatch vs manifest")
    if verify:
        checksum = content_checksum(_c_bytes(value))
        if checksum != record.checksum:
            raise IOError(f"shard {record.file}: checksum mismatch (torn write?)")
    return value


def save_tree(root: str, run_id: str, step: int,
              tree: Dict[str, np.ndarray],
              writer: str = "w") -> Tuple[ShardRecord, ...]:
    return tuple(save_array(root, run_id, step, path, v, writer)
                 for path, v in sorted(tree.items()))


def load_tree(root: str, records: Tuple[ShardRecord, ...],
              *, verify: bool = True) -> Dict[str, np.ndarray]:
    return {r.path: load_array(root, r, verify=verify) for r in records}
