"""The one traffic generator: it reads a mix's parameters
(``traffic/<name>.json``) and ``--seed`` and makes the requests.  Every
seed gets the same sizes in another order: lengths are stratified over
their range within each block of requests (one block is as many requests
as the mix has clients or streams) and shuffled by the seed, and token ids
are drawn from the seed.

Kinds:

* ``closed_loop``: ``clients`` clients, each sending its next request when
  its reply ends; prompts uniform over ``prompt_len`` [lo, hi] and
  outputs over ``output_len`` [lo, hi] tokens;
* ``closed_batch``: ``streams`` requests of prompts over ``prompt_len``
  and ``max_new`` tokens each, all admitted before the window."""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Request:
    """One request and what the benchmark saw of it (monotonic seconds)."""
    prompt: list
    max_new: int
    t_submit: float = 0.0
    future: object = None

    @property
    def times(self):
        """(t_admit, [emit times]) from the future: the session records the
        admission first, then one time per token."""
        t = list(self.future._times) if self.future is not None else []
        return (t[0], t[1:]) if t else (None, [])

    @property
    def tokens(self):
        return self.future.tokens_so_far if self.future is not None else []


def rng(seed, stream):
    """The generator of one purpose (``stream``) under ``seed``."""
    return np.random.default_rng([int(seed) % (2 ** 64), stream])


def stratified(lo, hi, n, gen):
    """n lengths spread evenly over [lo, hi] (the midpoints of n equal
    parts), in an order drawn from ``gen``."""
    vals = [lo + int((i + 0.5) * (hi - lo + 1) / n) for i in range(n)]
    return [vals[i] for i in gen.permutation(n)]


@dataclass
class Generator:
    traffic: dict
    seed: int
    vocab: int
    _blocks: int = 0
    _ids: object = field(default=None, repr=False)

    def __post_init__(self):
        self._ids = rng(self.seed, 1)
        self._sizes = rng(self.seed, 2)

    def _prompt(self, n):
        return self._ids.integers(0, self.vocab, size=n).tolist()

    def block(self):
        """The next block of requests."""
        t = self.traffic
        self._blocks += 1
        if t["kind"] == "closed_batch":
            n = t["streams"]
            lens = stratified(*t["prompt_len"], n, self._sizes)
            return [Request(self._prompt(p), t["max_new"]) for p in lens]
        n = t["clients"]
        plen = stratified(*t["prompt_len"], n, self._sizes)
        olen = stratified(*t["output_len"], n, self._sizes)
        return [Request(self._prompt(p), o) for p, o in zip(plen, olen)]
