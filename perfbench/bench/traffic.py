"""The one traffic generator: it reads a mix's parameters (a data file
``traffic/<mix>.json``) and the run's seed, and yields the requests.

Lengths are drawn by strata, so that every seed gets the same set of
sizes in another order: a block of ``strata`` requests holds the lengths
at the quantiles (i + 1/2) / strata of the mix's distribution, permuted
by the seed.  A window that completes whole blocks has done the same work
under every seed.  What the seed changes besides the order is what the
sizes do not decide: the prompts' tokens, the sessions' ids (a Zipf draw
over the mix's sessions), the decode requests' first tokens.

Distributions (``dist``): ``lognormal`` (``median``, ``sigma``),
``loguniform`` and ``uniform`` (integers), each clipped to
[``min``, ``max``].
"""
from __future__ import annotations

import math
from statistics import NormalDist
from typing import Iterator, List, Mapping

import numpy as np


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator for one stream of the run's seed (any integer)."""
    return np.random.default_rng([seed % 2 ** 64, *stream])


def quantile_lengths(dist: Mapping, n: int) -> List[int]:
    """The ``n`` strata's lengths, at the quantiles (i + 1/2) / n."""
    lo, hi = int(dist["min"]), int(dist["max"])
    out = []
    for i in range(n):
        q = (i + 0.5) / n
        kind = dist["dist"]
        if kind == "lognormal":
            x = math.exp(math.log(dist["median"])
                         + dist["sigma"] * NormalDist().inv_cdf(q))
        elif kind == "loguniform":
            x = math.exp(math.log(lo) + q * (math.log(hi) - math.log(lo)))
        elif kind == "uniform":
            x = lo + math.floor(q * (hi - lo + 1))
        else:
            raise ValueError(f"unknown distribution {kind!r}")
        out.append(min(hi, max(lo, int(round(x)))))
    return out


def lengths(dist: Mapping, strata: int, seed: int, stream: int
            ) -> Iterator[int]:
    """Endless lengths: block after block of the strata, each block
    permuted by ``(seed, stream, block)``."""
    base = np.array(quantile_lengths(dist, strata))
    block = 0
    while True:
        yield from base[rng(seed, stream, block).permutation(strata)
                        ].tolist()
        block += 1


class Zipf:
    """Ranks 0..n-1 drawn with probability proportional to
    1 / (rank + 1) ** s, by the inverse of the cumulative weights."""

    def __init__(self, n: int, s: float):
        w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** s
        self.cdf = np.cumsum(w) / w.sum()

    def draw(self, g: np.random.Generator, k: int) -> np.ndarray:
        return np.minimum(np.searchsorted(self.cdf, g.random(k)),
                          len(self.cdf) - 1)


PROMPT_LENGTHS, PROMPT_TOKENS, OUTPUT_LENGTHS, SESSIONS, FIRST_TOKENS = \
    range(5)


def prompts(mix: Mapping, seed: int) -> Iterator[int]:
    """A prefill mix's prompt lengths, in order."""
    return lengths(mix["prompt"], mix["strata"], seed, PROMPT_LENGTHS)


def prompt_tokens(seed: int, index: int, S: int, vocab: int) -> np.ndarray:
    """The tokens of prompt ``index``: uniform over the vocabulary."""
    return rng(seed, PROMPT_TOKENS, index).integers(
        0, vocab, S, dtype=np.int64).astype(np.int32)


def decode_requests(mix: Mapping, seed: int, vocab: int):
    """A decode mix's requests in order: (session id, first token, output
    tokens), endless, drawn a block of ``strata`` at a time."""
    outs = lengths(mix["output"], mix["strata"], seed, OUTPUT_LENGTHS)
    zipf = Zipf(mix["sessions"], mix["zipf"])
    block = 0
    while True:
        n = mix["strata"]
        rids = zipf.draw(rng(seed, SESSIONS, block), n)
        firsts = rng(seed, FIRST_TOKENS, block).integers(0, vocab, n)
        for rid, first in zip(rids.tolist(), firsts.tolist()):
            yield rid, first, next(outs)
        block += 1
