"""Logical activation rules and parameter sharding over a ``DeviceMesh``:
the JAX package's ``distributed/`` on PyTorch's DTensor."""
