"""Mesh construction: the JAX package's ``launch/mesh.py`` on PyTorch's
``DeviceMesh``.

The production meshes keep the reference's shapes, so a dry run here lines
up with the reference's pair for pair: one pod is (data=16, model=16), two
pods are (pod=2, data=16, model=16) = 512 devices with the batch sharded
over ('pod', 'data').  A ``DeviceMesh`` needs a process group of its size:

* ``fake_world(n)`` — a fake process group of n ranks seen from rank 0
  (PyTorch's test-only ``fake`` backend: collectives return at once and move
  nothing).  It is the dry run's stand-in for the reference's
  ``--xla_force_host_platform_device_count=512``: with parameters on the
  ``meta`` device, a step of a full-size model runs shard by shard on the
  host and allocates nothing.
* ``card_world()`` — one rank over NCCL on the card, from an in-process
  store (no environment variables, no network), for the one-device mesh
  the launch steps serve on.

Both are context managers that tear their group down on exit, and nothing
here creates a group when the module is imported.
"""
from __future__ import annotations

import math
from contextlib import contextmanager

import torch
import torch.distributed as dist


def _fake_store():
    # PyTorch's fake backend lives in its testing package, whose layout may
    # change between versions: fail loudly here, the one place it is named
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            f"torch {torch.__version__} has no fake process group "
            f"(torch.testing._internal.distributed.fake_pg): the dry run "
            f"needs it") from e
    return FakeStore()


@contextmanager
def _world(backend, store, world_size, **kw):
    if dist.is_initialized():
        raise RuntimeError("a default process group already exists; the "
                           "launch worlds create and destroy their own")
    dist.init_process_group(backend, store=store, rank=0,
                            world_size=world_size, **kw)
    try:
        yield
    finally:
        dist.destroy_process_group()


def fake_world(n):
    """Fake process group of ``n`` ranks, this process rank 0."""
    return _world("fake", _fake_store(), n)


def card_world():
    """One-rank NCCL process group on the card (raises without one)."""
    if not torch.cuda.is_available():
        raise RuntimeError("card_world needs a CUDA device")
    return _world("nccl", dist.HashStore(), 1,
                  device_id=torch.device("cuda", torch.cuda.current_device()))


def _mesh(shape, axes, device_type):
    from torch.distributed.device_mesh import init_device_mesh
    n = math.prod(shape)
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise RuntimeError(
            f"a {shape} mesh needs a process group of {n} ranks, have "
            f"{have}: run inside launch.mesh.fake_world({n}) (the dry run, "
            f"repro_torch.launch.dryrun) or a real group of that size")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type="cpu"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_test_mesh(shape=(2, 2), axes=("data", "model"), device_type="cpu"):
    """Small mesh for integration tests (a process group of its size)."""
    return _mesh(shape, axes, device_type)
