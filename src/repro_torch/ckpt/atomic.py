"""Crash-safe file writes: write temp → fsync → atomic rename.

The one torn-write discipline shared by everything that persists control
state: checkpoint shard blobs (``ckpt/shards.py``), WAL manifests and
packed-SoA snapshots (``store/wal.py``).  ``os.replace`` is atomic on
POSIX, so a reader either sees the complete previous file or the complete
new one — never a prefix.  The durability chain is: file bytes are fsynced
before the rename (no rename-to-garbage), and the containing directory is
fsynced after it (the rename itself survives a power cut), best-effort on
platforms where directories cannot be opened.
"""
from __future__ import annotations

import os
import tempfile
from typing import BinaryIO, Callable


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Replace ``path`` with ``data`` atomically (all-or-nothing on crash)."""
    atomic_write(path, lambda f: f.write(data))


def atomic_write(path: str, write: Callable[[BinaryIO], object]) -> None:
    """Replace ``path`` with what ``write`` writes into the open file,
    atomically (all-or-nothing on crash)."""
    directory = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".tmp-", suffix=".part")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    fsync_dir(directory)


def fsync_dir(directory: str) -> None:
    """Flush a directory entry (the rename) to stable storage, best effort."""
    try:
        dfd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(dfd)
    except OSError:
        pass
    finally:
        os.close(dfd)


__all__ = ["atomic_write", "atomic_write_bytes", "fsync_dir"]
