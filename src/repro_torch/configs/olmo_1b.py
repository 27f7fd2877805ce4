"""OLMo-1B — dense with non-parametric LayerNorm. [arXiv:2402.00838]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=50304,
    nonparametric_ln=True, tie_embeddings=True,
    source="arXiv:2402.00838",
)
