"""Jamba-1.5-Large — hybrid Mamba+attention (1:7 interleave), MoE 16e top-2
every other layer. [arXiv:2403.19887]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab=65536,
    n_experts=16, moe_top_k=2, moe_d_ff=24576, moe_every=2,
    attn_every=8,                 # 1 attention layer per 8 (1:7 mamba)
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_groups=1,
    source="arXiv:2403.19887",
)
