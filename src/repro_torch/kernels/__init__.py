"""Hand-written CUDA kernels for the coded hot path (``csrc/``), their thin
ctypes wrappers, the plain PyTorch versions (``ref.py``) and the
device-dispatching ops (``ops.py``)."""
