"""SeamlessM4T-medium — encoder-decoder multimodal translation backbone;
the speech frontend (mel + conv) is a stub providing frame embeddings.
[arXiv:2308.11596]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256206,
    enc_dec=True, n_enc_layers=12, n_modality_tokens=1024,
    act="relu",
    source="arXiv:2308.11596",
)
