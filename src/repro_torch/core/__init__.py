"""The coded-resilience system itself: codes, schemes, parity models and
metrics, on PyTorch."""
