"""Carrying parameters and arrays between numpy, the host and the card.

``params_from_numpy`` takes a parameter tree with numpy leaves — what
``jax.tree.map(np.asarray, params)`` gives for the JAX package's models — and
returns the same tree of tensors on a device; the layouts are kept (dense
weights [in, out], convolutions HWIO), so no leaf is transposed.
``params_to_numpy`` is the way back.  Trees are nested dicts, lists and
tuples, as in the JAX package.

``resolve_device`` is the one place the port decides where work runs: every
entry point defaults to ``"cuda"`` and raises when no card is present, unless
the caller asks for ``"cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import DTensor


def resolve_device(device="cuda"):
    """``torch.device`` for ``device``; raises for a CUDA device on a machine
    without one (the port never moves work to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but torch.cuda is not "
            f"available; pass device='cpu' to run on the CPU")
    return dev


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a dict/list/tuple tree (dict keys in
    sorted order, as JAX flattens them)."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key]) for key in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree):
    """Leaves of a dict/list/tuple tree, in ``tree_map`` order."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree)
                for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def as_tensor(x, device):
    """An array-like (numpy, list, tensor) as a tensor on ``device``; numpy
    float64 becomes float32, as JAX's default does."""
    t = torch.as_tensor(x, device=device)
    return t.float() if t.dtype == torch.float64 else t


def to_host(x):
    """A tensor (or array-like) as a host numpy array (bfloat16, which numpy
    has no type for, arrives as float32).  A DTensor is gathered whole first
    (``full_tensor``), over its mesh's process groups: a collective, so in
    a serving session on a mesh it runs on the rank's device thread, in
    the order every rank issues its collectives."""
    if isinstance(x, DTensor):
        x = x.full_tensor()
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _leaf_to_tensor(a, dev):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own: JAX's bf16 leaves arrive as
        # ml_dtypes.bfloat16, which torch.tensor cannot read.  Widen to
        # float32 and narrow on the torch side; both steps are exact.
        return torch.tensor(a.astype(np.float32), device=dev).to(
            torch.bfloat16)
    return torch.tensor(np.array(a), device=dev)


def params_from_numpy(tree, device="cuda"):
    """Tree of numpy leaves -> the same tree of tensors on ``device``
    (bfloat16 leaves stay bfloat16)."""
    dev = resolve_device(device)
    return tree_map(lambda a: _leaf_to_tensor(a, dev), tree)


def params_to_numpy(tree):
    """Tree of tensors -> the same tree of host numpy arrays."""
    return tree_map(to_host, tree)
