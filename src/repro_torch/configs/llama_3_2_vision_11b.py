"""Llama-3.2-11B-Vision — text backbone with cross-attention image layers
every 5th layer; vision encoder is a stub providing patch embeddings.
[hf:meta-llama/Llama-3.2-11B-Vision]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=128256,
    cross_attn_every=5, n_modality_tokens=1600, rope_theta=500000.0,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)
