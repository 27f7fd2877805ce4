"""Deterministic synthetic data pipelines.

No datasets ship with the container, so both the LM substrate and the paper's
image-classification reproduction run on synthetic-but-learnable tasks:

* ``lm_stream``      — order-2 Markov token stream (a model that learns the
                       transition table drops well below unigram entropy).
* ``cluster_images`` — Gaussian-cluster "images": class c has a fixed random
                       template; samples are template + noise. Mirrors the
                       difficulty knobs of CIFAR-like tasks while training in
                       seconds on 1 CPU core; used for paper Figs 6/7/9/10
                       reproductions.
* ``batched``        — epoch shuffler/batcher.
"""
from __future__ import annotations

import numpy as np


def lm_stream(vocab, n_tokens, seed=0, branch=4):
    """Order-2 Markov chain over ``vocab`` with ``branch`` successors per
    state — entropy ~= log(branch) << log(vocab)."""
    rng = np.random.default_rng(seed)
    succ = rng.integers(0, vocab, size=(vocab, vocab, branch))
    probs = rng.dirichlet(np.ones(branch), size=(vocab, vocab))
    out = np.empty(n_tokens, np.int32)
    a, b = rng.integers(0, vocab, 2)
    for i in range(n_tokens):
        nxt = rng.choice(succ[a, b], p=probs[a, b])
        out[i] = nxt
        a, b = b, nxt
    return out


def lm_batches(vocab, batch, seq, n_batches, seed=0):
    stream = lm_stream(vocab, batch * (seq + 1) * n_batches + 1, seed)
    toks = stream[: batch * (seq + 1) * n_batches]
    return toks.reshape(n_batches, batch, seq + 1)[:, :, : seq + 1]


def cluster_images(n, n_classes=10, image_shape=(32, 32, 3), noise=1.0,
                   seed=0, templates=None):
    """Returns (x [n, *image_shape] float32, y [n] int32, templates)."""
    rng = np.random.default_rng(seed)
    if templates is None:
        templates = rng.normal(0, 1, size=(n_classes,) + tuple(image_shape))
    y = rng.integers(0, n_classes, size=n)
    x = templates[y] + rng.normal(0, noise, size=(n,) + tuple(image_shape))
    return x.astype(np.float32), y.astype(np.int32), templates


def batched(x, y, batch, seed=0, epochs=1):
    rng = np.random.default_rng(seed)
    n = len(x)
    for _ in range(epochs):
        order = rng.permutation(n)
        for i in range(0, n - batch + 1, batch):
            sel = order[i:i + batch]
            yield x[sel], y[sel]
