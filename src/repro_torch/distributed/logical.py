"""Logical activation-sharding rules (MaxText-style): the JAX package's
``distributed/logical.py`` over PyTorch's DTensor.

Model code annotates activations with *logical* axis names
(``constrain(x, ("batch", None, "heads", None))``); the launcher binds
logical names to mesh axes once per run (``logical_rules``).  A spec is a
plain tuple with one entry per tensor dimension: ``None``, a mesh-axis name,
or a tuple of names (the reference's ``PartitionSpec``).  ``logical_spec`` is
the reference's arithmetic: a dimension is sharded only when divisible by
the mesh-axis size, each mesh axis is used at most once per spec, and a
dimension stops taking axes at the first that does not divide it.

``constrain`` is the identity when no rules are active (the unit tests, one
card) and on a plain tensor; on a ``DTensor`` it redistributes to the spec's
placements, where the reference asks GSPMD with
``jax.lax.with_sharding_constraint``.  Unlike GSPMD, DTensor does not
reshard on its own before a reshape it cannot do on the local shards (a
width sharded 16 ways split into 14 heads), so the model constrains
*before* such a reshape, with ``shape`` giving the sizes the guard reads
(the head count, not the flattened width).
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

from torch.distributed.tensor import DTensor, Replicate, Shard


class _Rules(threading.local):
    # class defaults: a thread that never set rules reads None without the
    # exception a missing attribute costs (constrain runs ~200 times a step)
    rules = sizes = mesh = None


_STATE = _Rules()


DEFAULT_LOGICAL = {
    "batch": ("data",),
    "tokens": ("data",),          # flattened batch*seq
    "heads": ("model",),
    "kv_heads": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "capacity": ("data",),
    "ff": ("model",),
    "d_inner": ("model",),
    # cache sequence dim: takes whatever axes the batch dim left unused
    # (decode_32k -> model; long_500k B=1 -> model+data)
    "seq": ("model", "data"),
    "embed": (),
}


def set_rules(rules, axis_sizes, mesh=None):
    _STATE.rules = rules
    _STATE.sizes = axis_sizes
    _STATE.mesh = mesh


def clear_rules():
    _STATE.rules = None
    _STATE.sizes = None
    _STATE.mesh = None


def state():
    return _STATE.rules, _STATE.sizes, _STATE.mesh


@contextmanager
def logical_rules(rules, axis_sizes, mesh=None):
    old = state()
    set_rules(rules, axis_sizes, mesh)
    try:
        yield
    finally:
        _STATE.rules, _STATE.sizes, _STATE.mesh = old


def mesh_axis_sizes(mesh):
    """{axis name: size} of a ``DeviceMesh`` (or anything with
    ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def rules_for_mesh(mesh):
    rules = dict(DEFAULT_LOGICAL)
    if "pod" in mesh.mesh_dim_names:
        rules["batch"] = ("pod", "data")
        rules["tokens"] = ("pod", "data")
    return rules, mesh_axis_sizes(mesh)


def logical_spec(shape, axes, rules=None, sizes=None):
    """The spec the reference's ``constrain`` gives a tensor of ``shape``
    annotated with logical ``axes`` (default: the active rules)."""
    if rules is None:
        rules, sizes, _ = state()
    used = set()
    spec = []
    for dim, name in zip(shape, axes):
        entry = None
        mesh_axes = rules.get(name, ()) if name else ()
        chosen = []
        prod = 1
        for a in mesh_axes:
            if a in used or a not in sizes or sizes[a] <= 1:
                continue                       # axis taken elsewhere: skip it
            if dim % (prod * sizes[a]) == 0:
                prod *= sizes[a]
                chosen.append(a)
            else:
                break                          # indivisible: stop extending
        if chosen:
            used.update(chosen)
            entry = tuple(chosen) if len(chosen) > 1 else chosen[0]
        spec.append(entry)
    return tuple(spec)


def placements(spec, mesh, ndim=None):
    """DTensor placements of ``spec`` on ``mesh``: per mesh dimension,
    ``Shard(d)`` for the tensor dimension d whose entry names it, else
    ``Replicate()``.  A dimension sharded over two axes gets one ``Shard``
    on each, nested in mesh order (the reference nests in the entry's order;
    the two differ only for the cache's ("model", "data"), in which device
    holds which block, not in any device's bytes)."""
    owner = {}
    for d, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            owner[a] = d
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in mesh.mesh_dim_names)


def constrain_spec(x, spec, mesh=None):
    """``x`` redistributed to ``spec`` (a DTensor), else ``x`` itself."""
    if not isinstance(x, DTensor):
        return x
    mesh = mesh or x.device_mesh
    want = placements(spec, mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def constrain(x, axes, shape=None):
    """axes: tuple of logical names (or None) matching x.ndim; ``shape``,
    where given, is what the divisibility guard reads in place of
    ``x.shape`` (see the module's docstring)."""
    if not isinstance(x, DTensor):          # every call off a sharded mesh
        return x
    rules, sizes, mesh = state()
    if rules is None:
        return x
    return constrain_spec(x, logical_spec(
        x.shape if shape is None else shape, axes, rules, sizes), mesh)
