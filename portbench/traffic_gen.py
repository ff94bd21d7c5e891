"""Traffic from a seed: the one generator that every mix file
(``traffic/<mix>.json``) parameterises.

Tokens are Zipf-distributed ids, a frozen copy of the program's
``train/data.py::make_batch_np`` for token families (``_zipf_probs``; a
batch for step t drawn by ``default_rng(seed * 1_000_003 + t)``).

An ``infer`` mix is a closed loop of requests.  Its lengths come in cycles
of ``cycle`` requests whose multiset is fixed: the cycle's quantiles of a
log-uniform draw on [``length_min``, ``length_max``], rounded up to a
multiple of ``length_multiple``; each seed shuffles every cycle its own
way.  So every seed asks for the same work in another order, and a run's
rate does not move with the seed.  Request i's ``batch`` rows are
consecutive slices of a seeded token pool, at a seeded offset: rows differ
within and between requests.
"""
from __future__ import annotations

import functools
import math

import numpy as np


@functools.lru_cache(maxsize=4)
def zipf_probs(vocab: int, alpha: float) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    return (p / p.sum()).astype(np.float64)


def train_batch(seed: int, step: int, vocab: int, batch: int, seq_len: int,
                alpha: float) -> np.ndarray:
    """The (batch, seq_len) int32 tokens of training step ``step``."""
    rng = np.random.default_rng(seed * 1_000_003 + step)
    return rng.choice(vocab, size=(batch, seq_len), p=zipf_probs(vocab, alpha)).astype(np.int32)


def length_cycle(mix: dict) -> list[int]:
    """The lengths of one cycle, in ascending order."""
    lo, hi, m, n = mix["length_min"], mix["length_max"], mix["length_multiple"], mix["cycle"]
    return [int(math.ceil(lo * (hi / lo) ** ((i + 0.5) / n) / m)) * m for i in range(n)]


class Requests:
    """The requests of an ``infer`` mix for one seed and vocabulary:
    ``length(i)`` and ``tokens(i)`` ((batch, length) int32), the same for the
    same seed."""

    def __init__(self, mix: dict, seed: int, vocab: int) -> None:
        self.seed = seed
        self.batch = mix["batch"]
        self._cycle = length_cycle(mix)
        self.cycle = len(self._cycle)
        self._orders: dict[int, list[int]] = {}
        self._pool = np.random.default_rng([seed, 2]).choice(
            vocab, size=mix["pool_tokens"], p=zipf_probs(vocab, mix["zipf_alpha"])
        ).astype(np.int32)

    def lengths(self) -> list[int]:
        """The distinct lengths of the mix, ascending."""
        return sorted(set(self._cycle))

    def length(self, i: int) -> int:
        c, j = divmod(i, len(self._cycle))
        order = self._orders.get(c)
        if order is None:
            order = list(self._cycle)
            np.random.default_rng([self.seed, 1, c]).shuffle(order)
            self._orders = {c: order}
        return order[j]

    def tokens_of_length(self, length: int) -> np.ndarray:
        """The pool's first rows of ``length``, for warming a shape up."""
        return self._pool[:self.batch * length].reshape(self.batch, -1)

    def tokens(self, i: int) -> np.ndarray:
        n = self.batch * self.length(i)
        off = int(np.random.default_rng([self.seed, 3, i]).integers(0, len(self._pool) - n))
        return self._pool[off:off + n].reshape(self.batch, -1)
