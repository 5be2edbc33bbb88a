"""Deterministic, shardable, resumable token pipeline.

Batches are a pure function of ``(seed, cursor)`` — the counter-mode design
means resume-from-checkpoint needs exactly one integer (the manifest's
``data_cursor``), replays are bitwise identical, and each DP rank draws its
disjoint slice without coordination.  A memmap-backed corpus reader with
the same interface is provided for real token files.

``SyntheticTokens`` draws the JAX package's tokens bit for bit without
JAX: sequence i is ``randint(fold_in(key(seed), i), (S + 1,), 0, V)``
under ``jax.random``'s default threefry2x32 generator with
``jax_threefry_partitionable`` on, computed here in numpy (whose uint32
arithmetic wraps as threefry needs).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(k1: np.ndarray, k2: np.ndarray, x1: np.ndarray,
                 x2: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 (20 rounds) of counters (x1, x2) under keys (k1, k2),
    elementwise over broadcast uint32 arrays, as JAX's
    ``_threefry2x32_lowering`` computes it."""
    k1, k2, x1, x2 = np.broadcast_arrays(*(np.asarray(a, np.uint32)
                                           for a in (k1, k2, x1, x2)))
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    x = [x1 + ks[0], x2 + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> Tuple[np.uint32, np.uint32]:
    """``jax.random.key(seed)``'s data with 64-bit types off (JAX's
    default): the seed as a 32-bit integer in the low word, 0 in the
    high."""
    if not -2 ** 31 <= seed < 2 ** 32:
        raise ValueError(f"seed {seed} is not a 32-bit integer")
    return np.uint32(0), np.uint32(seed & 0xFFFFFFFF)


def fold_in(key, data: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``jax.random.fold_in(key, d)`` for each uint32 ``d`` of ``data``:
    threefry of the counter pair (0, d)."""
    data = np.asarray(data, np.uint32)
    return threefry2x32(key[0], key[1], np.zeros_like(data), data)


def split2(key1: np.ndarray, key2: np.ndarray):
    """``jax.random.split(key)`` (two keys) under the partitionable scheme:
    threefry of the counters (0, 0) and (0, 1)."""
    lo = [threefry2x32(key1, key2, np.uint32(0), np.uint32(i))
          for i in (0, 1)]
    return lo[0], lo[1]


def random_bits32(key1: np.ndarray, key2: np.ndarray, n: int) -> np.ndarray:
    """``random_bits(key, 32, (n,))`` for a batch of keys [...]: threefry of
    the counters (0, j), its two words xored -> uint32 [..., n]."""
    j = np.arange(n, dtype=np.uint32)
    b1, b2 = threefry2x32(key1[..., None], key2[..., None], np.uint32(0), j)
    return b1 ^ b2


def randint(key1: np.ndarray, key2: np.ndarray, n: int, minval: int,
            maxval: int) -> np.ndarray:
    """``jax.random.randint(key, (n,), minval, maxval, int32)`` for a batch
    of keys: two draws of 32 bits, combined modulo the span as
    ``jax.random._randint`` combines them (in wrapping uint32)."""
    if not (-2 ** 31 <= minval < maxval <= 2 ** 31 - 1):
        raise ValueError(f"randint over [{minval}, {maxval}) is not an "
                         f"int32 range this port draws")
    (a1, a2), (b1, b2) = split2(key1, key2)
    higher, lower = random_bits32(a1, a2, n), random_bits32(b1, b2, n)
    span = np.uint32(maxval - minval)
    # 2^32 mod span, formed in wrapping uint32 as JAX forms it: for a span
    # above 2^16 the square wraps to 0, and only the lower draw counts
    mult = np.array([2 ** 16], np.uint32) % span
    mult = (mult * mult) % span
    offset = (higher % span) * mult + lower % span
    offset = offset % span
    return (np.int64(minval) + offset.astype(np.int64)).astype(np.int32)


@dataclass
class PipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    dp_rank: int = 0
    dp_size: int = 1
    seed: int = 0

    @property
    def local_batch(self) -> int:
        if self.global_batch % self.dp_size:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split over {self.dp_size} ranks")
        return self.global_batch // self.dp_size


class SyntheticTokens:
    """Counter-mode synthetic corpus: sequence i is threefry(seed, i)."""

    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg
        self.cursor = 0  # global sequences consumed

    def state(self) -> int:
        return self.cursor

    def restore(self, cursor: int) -> None:
        self.cursor = cursor

    def _sequence_ids(self) -> np.ndarray:
        """Global sequence ids for this step, sliced to this rank."""
        c = self.cfg
        start = self.cursor
        ids = start + np.arange(c.global_batch)
        return ids[c.dp_rank * c.local_batch:(c.dp_rank + 1) * c.local_batch]

    def next_batch(self) -> Dict[str, np.ndarray]:
        c = self.cfg
        ids = self._sequence_ids()
        k1, k2 = fold_in(prng_key(c.seed), ids.astype(np.uint32))
        toks = randint(k1, k2, c.seq_len + 1, 0, c.vocab_size)
        self.cursor += c.global_batch
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class MemmapTokens:
    """Token-file corpus with the same cursor/restore interface."""

    def __init__(self, cfg: PipelineConfig, path: str, dtype=np.int32):
        self.cfg = cfg
        self.data = np.memmap(path, dtype=dtype, mode="r")
        self.n_sequences = len(self.data) // (cfg.seq_len + 1)
        if self.n_sequences == 0:
            raise ValueError(f"{path}: shorter than one sequence")
        self.cursor = 0

    def state(self) -> int:
        return self.cursor

    def restore(self, cursor: int) -> None:
        self.cursor = cursor

    def next_batch(self) -> Dict[str, np.ndarray]:
        c = self.cfg
        ids = (self.cursor + np.arange(c.global_batch)) % self.n_sequences
        ids = ids[c.dp_rank * c.local_batch:(c.dp_rank + 1) * c.local_batch]
        L = c.seq_len + 1
        rows = np.stack([self.data[i * L:(i + 1) * L] for i in ids])
        rows = rows.astype(np.int32) % c.vocab_size
        self.cursor += c.global_batch
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}
