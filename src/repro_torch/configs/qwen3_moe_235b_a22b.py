"""Qwen3-MoE-235B-A22B — 128 routed experts, top-8, qk-norm, GQA kv=4.
[hf:Qwen/Qwen3-30B-A3B scaled per assignment]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
    d_ff=1536, vocab=151936, head_dim=128,
    n_experts=128, moe_top_k=8, moe_d_ff=1536,
    qk_norm=True, rope_theta=1000000.0,
    source="hf:Qwen/Qwen3-30B-A3B",
)
