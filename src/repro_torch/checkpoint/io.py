"""Checkpointing: parameter trees <-> ``.npz``, in the JAX package's layout.

A file holds ``__meta__`` (JSON: tree description, leaf count, dtypes, step,
extra) and one array ``leaf_i`` per leaf, in ``convert.tree_leaves`` order —
dict keys sorted, as JAX flattens them — so a file written by either package
loads with the other's ``load(path, like)``.  bfloat16 leaves are stored as
float32 (numpy has no bfloat16) with their dtype recorded."""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.convert import to_host, tree_leaves, tree_map


def _describe(tree):
    """The tree's structure with ``*`` leaves, in JAX's PyTreeDef spelling
    (informational: ``load`` rebuilds from ``like``)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{key!r}: {_describe(tree[key])}"
                               for key in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_describe(v) for v in tree) + "]"
    if isinstance(tree, tuple):
        inner = ", ".join(_describe(v) for v in tree)
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    return "*"


def _dtype_name(x):
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return str(np.asarray(x).dtype)


def save(path, params, step=None, extra=None):
    leaves = tree_leaves(params)
    arrs, dtypes = {}, []
    for i, x in enumerate(leaves):
        dtypes.append(_dtype_name(x))
        a = to_host(x)                        # bfloat16 arrives as float32
        if a.dtype.kind not in "fiub":
            a = a.astype(np.float32)
        arrs[f"leaf_{i}"] = a
    meta = {"treedef": f"PyTreeDef({_describe(params)})",
            "n_leaves": len(leaves), "dtypes": dtypes, "step": step,
            "extra": extra or {}}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, __meta__=json.dumps(meta), **arrs)


def weighted_merge(params_list, weights_list, eps=1e-12):
    """Leaf-wise weighted average of k structurally identical trees:

        merged_leaf = sum_i w_i * leaf_i / (sum_i w_i + eps)

    ``weights_list`` holds one weight tree per member (leaves broadcastable
    against the parameter leaves: per-element Fisher diagonals, or scalars
    for a plain convex combination).  Accumulates in fp32 and casts each
    merged leaf back to the first member's dtype, on its device.  Identical
    members with any positive weights merge to (numerically) themselves."""
    if not params_list or len(params_list) != len(weights_list):
        raise ValueError(
            f"weighted_merge needs one weight tree per member, got "
            f"{len(params_list)} members and {len(weights_list)} weights")
    leaves0 = tree_leaves(params_list[0])
    stacked = [tree_leaves(p) for p in params_list]
    wstacked = [tree_leaves(w) for w in weights_list]
    if any(len(s) != len(leaves0) for s in stacked + wstacked):
        raise ValueError("weighted_merge: leaf count mismatch")
    out = []
    for li, first in enumerate(leaves0):
        first = torch.as_tensor(first)
        num = den = None
        for p_leaves, w_leaves in zip(stacked, wstacked):
            leaf = torch.as_tensor(p_leaves[li], dtype=torch.float32,
                                   device=first.device)
            w = torch.as_tensor(w_leaves[li], dtype=torch.float32,
                                device=first.device).expand(leaf.shape)
            num = w * leaf if num is None else num + w * leaf
            den = w if den is None else den + w
        out.append((num / (den + eps)).to(first.dtype))
    it = iter(out)
    return tree_map(lambda _: next(it), params_list[0])


def load(path, like):
    """Restore into the structure of ``like``: shapes verified, each leaf
    cast to the dtype of ``like``'s leaf (a tensor on its device, or a numpy
    array where ``like`` holds numpy).  Returns ``(params, meta)``."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        leaves = [z[f"leaf_{i}"] for i in range(meta["n_leaves"])]
    like_leaves = tree_leaves(like)
    if len(leaves) != len(like_leaves):
        raise ValueError(f"{path}: {len(leaves)} leaves, but the target "
                         f"tree has {len(like_leaves)}")
    out = []
    for got, want in zip(leaves, like_leaves):
        if tuple(got.shape) != tuple(want.shape):
            raise ValueError(f"{path}: leaf shape {got.shape} does not "
                             f"match {tuple(want.shape)}")
        if isinstance(want, torch.Tensor):
            out.append(torch.tensor(got).to(device=want.device,
                                            dtype=want.dtype))
        else:
            out.append(np.asarray(got).astype(np.asarray(want).dtype))
    it = iter(out)
    return tree_map(lambda _: next(it), like), meta
