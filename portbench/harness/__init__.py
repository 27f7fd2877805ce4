"""The benchmark's yardstick: cell loading, traffic, windows, tracing,
work counts, the plain reference and the comparison that decides
``correct``."""
