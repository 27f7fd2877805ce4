"""ParM (parity models for coded-resilient inference) on PyTorch and CUDA.

A port of the JAX package ``repro`` that mirrors its layout file for file;
``repro`` stays the reference.  Entry points run on ``"cuda"`` unless the
caller passes ``device="cpu"``, and raise when no card is present.  The coded
hot path runs through hand-written CUDA kernels (``kernels/``, built from
``csrc/`` at first use) on CUDA tensors and through their plain PyTorch
versions on CPU tensors.
"""
