"""Qwen3-4B — dense, qk-norm, GQA kv=8, head_dim=128. [hf:Qwen/Qwen3-8B]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=9728, vocab=151936, head_dim=128,
    qk_norm=True, rope_theta=1000000.0,
    source="hf:Qwen/Qwen3-8B",
)
