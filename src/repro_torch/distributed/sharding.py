"""Path-based sharding rules: FSDP x tensor x expert parallel, the JAX
package's ``distributed/sharding.py`` over a ``DeviceMesh``.

Mesh axes: ``model`` (tensor/expert parallel, 16-way per pod), ``data``
(FSDP + batch, 16-way), optionally ``pod`` (2-way across pods; batch shards
over ('pod','data')).

Rules are name-driven over the parameter tree's paths and
*divisibility-guarded*: a dim is sharded on an axis only if it divides evenly
(e.g. qwen2's kv=2 heads stay replicated on a 16-way model axis rather than
forcing an uneven partition).  Stacked superblock params carry a leading
layer-group dim that is never sharded.

A spec is a tuple with one entry per tensor dimension (``None``, an axis
name or a tuple of names), the reference's ``PartitionSpec``; paths are the
``/``-joined dict keys and sequence indices of a leaf, the reference's
``_path_str``.  ``ShardingRules.distribute`` places a tree on the mesh as
DTensors, and on a mesh of one device as plain tensors on its device (what
``jax.device_put`` with a replicated sharding does there), so the CUDA
kernels see the tensors they always see.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.logical import mesh_axis_sizes, placements


def tree_map_with_path(fn, tree, path=""):
    """``fn(path, leaf)`` over a dict/list/tuple tree (dict keys in sorted
    order), the path ``/``-joined as the reference's ``_path_str``."""
    def join(key):
        return f"{path}/{key}" if path else str(key)
    if isinstance(tree, dict):
        return {key: tree_map_with_path(fn, tree[key], join(key))
                for key in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, join(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


class ShardingRules:
    """``fsdp_params=False`` is the *inference* layout: weights replicate
    over the data axis (tensor-parallel only), eliminating the per-layer
    FSDP all-gathers that otherwise dominate serving collectives.  Only legal
    when params/tp_size fit device memory — the launcher decides per
    architecture."""

    def __init__(self, mesh, batch_axes=None, fsdp_params=True):
        self.mesh = mesh
        self.axis_sizes = mesh_axis_sizes(mesh)
        self.tp = "model" if "model" in self.axis_sizes else None
        self.fsdp = ("data" if ("data" in self.axis_sizes and fsdp_params)
                     else None)
        self.fsdp_params = fsdp_params
        if batch_axes is None:
            batch_axes = tuple(a for a in ("pod", "data")
                               if a in self.axis_sizes)
        self.batch_axes = batch_axes

    # ------------------------------------------------------------------
    def _ok(self, dim_size, axis):
        if axis is None:
            return False
        a = self.axis_sizes.get(axis, 1)
        return dim_size % a == 0 and a > 1

    def _axis(self, dim_size, axis):
        return axis if self._ok(dim_size, axis) else None

    def _batch_axis(self, dim_size):
        """Largest prefix of batch_axes that divides dim_size."""
        total = 1
        chosen = []
        for a in self.batch_axes:
            total *= self.axis_sizes[a]
            if dim_size % total == 0:
                chosen.append(a)
            else:
                break
        return tuple(chosen) if chosen else None

    # ------------------------------------------------------------------
    def param_spec(self, name, leaf):
        """Spec of the parameter at path ``name``."""
        shape = tuple(leaf.shape)
        stacked = name.startswith("blocks") or "/blocks/" in name
        lead = (None,) if stacked else ()
        core = shape[1:] if stacked else shape

        def spec(*axes):
            return lead + tuple(axes)

        last = name.rsplit("/", 1)[-1]
        if last in ("scale", "q_norm", "k_norm", "gate_norm", "conv_b",
                    "A_log", "D", "dt_bias"):
            return spec(*([None] * len(core)))
        if last == "embed":
            return (self._axis(shape[0], self.tp),
                    self._axis(shape[1], self.fsdp))
        if last == "lm_head":
            return (self._axis(shape[0], self.fsdp),
                    self._axis(shape[1], self.tp))
        if "moe" in name and last in ("w1", "w3") and len(core) == 3:
            return spec(self._axis(core[0], self.tp),      # [E, D, F]
                        self._axis(core[1], self.fsdp), None)
        if "moe" in name and last == "w2" and len(core) == 3:
            return spec(self._axis(core[0], self.tp), None,  # [E, F, D]
                        self._axis(core[2], self.fsdp))
        if last == "router":                            # [D, E]
            return spec(self._axis(core[0], self.fsdp), None)
        if last in ("wq", "wk", "wv", "w1", "w3", "in_proj"):
            return spec(self._axis(core[0], self.fsdp),
                        self._axis(core[1], self.tp))
        if last in ("wo", "w2", "out_proj"):
            return spec(self._axis(core[0], self.tp),
                        self._axis(core[1], self.fsdp))
        if last in ("bq", "bk", "bv"):
            return spec(self._axis(core[0], self.tp))
        if last == "conv_w":                            # [W, C]
            return spec(None, self._axis(core[1], self.tp))
        return spec(*([None] * len(core)))

    def params(self, params_shapes):
        return tree_map_with_path(self.param_spec, params_shapes)

    def opt_state(self, opt_shapes, param_specs):
        """Moments shard like params; step is replicated."""
        return {"mu": param_specs, "nu": param_specs, "step": ()}

    # ------------------------------------------------------------------
    def activations(self, batch):
        return (self._batch_axis(batch), None)

    def batch_specs(self, batch_shapes):
        """Specs for a batch dict of shapes: leading dim = batch (sharded
        over batch axes when divisible)."""
        def one(_, leaf):
            ba = self._batch_axis(leaf.shape[0])
            return (ba,) + (None,) * (leaf.ndim - 1)
        return tree_map_with_path(one, batch_shapes)

    def logits_spec(self, batch, vocab=None):
        V_axis = self._axis(vocab, self.tp) if vocab else self.tp
        return (self._batch_axis(batch), None, V_axis)

    def cache_specs(self, cache_shapes, whole_seq=False):
        """KV/SSM cache specs. Leaves are stacked [G, B, ...]:
        - attn k/v [G, B, S, KV, hd]: batch over batch-axes when divisible,
          else sequence over 'data' (long_500k B=1); kv-heads stay local.
          With ``whole_seq`` (the serving pool's layout) the sequence stays
          whole and the kv-heads shard over 'model' where it divides them.
        - ssm state [G, B, H, N, P]: batch, heads over 'model' when possible.
        - conv [G, B, W-1, C]: batch, channels over 'model'.
        - cross k/v [G, B, n_ctx, KV, hd]: like attn.
        """
        def one(name, leaf):
            s = tuple(leaf.shape)
            B = s[1]
            ba = self._batch_axis(B)
            used = set(ba or ())
            if whole_seq and (name.endswith("/k") or name.endswith("/v")):
                return (None, ba, None, self._axis(s[3], self.tp), None)
            if name.endswith("/k") or name.endswith("/v"):
                # sequence shards over whatever the batch left unused
                # (mirrors logical rule "seq": (model, data))
                seq = []
                prod = 1
                data = "data" if "data" in self.axis_sizes else None
                for a in (self.tp, data):
                    if a and a not in used and \
                            s[2] % (prod * self.axis_sizes[a]) == 0:
                        seq.append(a)
                        prod *= self.axis_sizes[a]
                seq_axis = tuple(seq) if len(seq) > 1 else \
                    (seq[0] if seq else None)
                return (None, ba, seq_axis, None, None)
            if name.endswith("ssm"):
                return (None, ba, self._axis(s[2], self.tp), None, None)
            if name.endswith("conv"):
                return (None, ba, None, self._axis(s[3], self.tp))
            return (None, ba) + (None,) * (len(s) - 2)
        return tree_map_with_path(one, cache_shapes)

    def replicated(self):
        return ()

    # ------------------------------------------------------------------
    def distribute(self, tree, specs):
        """``tree`` placed on the mesh by ``specs`` (a tree of the same
        structure): DTensors, or, on a mesh of one device, plain tensors on
        its device.  A non-tensor leaf (the optimizer's step) stays as it
        is."""
        from torch.distributed.tensor import distribute_tensor
        one = self.mesh.size() == 1
        dev = torch.device(self.mesh.device_type)

        def place(x, spec):
            if not isinstance(x, torch.Tensor):
                return x
            if one:
                return x if x.device.type in (dev.type, "meta") else x.to(dev)
            return distribute_tensor(x, self.mesh,
                                     placements(spec, self.mesh))
        return _zip_map(place, tree, specs)


def _zip_map(fn, tree, specs):
    if isinstance(tree, dict):
        return {key: _zip_map(fn, tree[key], specs[key])
                for key in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)
