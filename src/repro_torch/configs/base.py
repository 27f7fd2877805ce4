"""Architecture + input-shape configuration system (plain dataclasses).

Every assigned architecture gets one module in ``repro_torch/configs``
exposing a ``CONFIG`` (the exact full-size config from the assignment);
``ArchConfig.reduced()`` gives the CPU test size (<=2 superblock-periods of
layers, d_model<=256, <=4 experts, float32).  The fields, defaults and
``reduced()`` are the JAX package's, except ``attn_backend``, which takes the
port's names (see below).
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass

ATTN_BACKENDS = ("kernels", "torch")


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    source: str = ""                 # citation from the assignment pool

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_every: int = 1               # a MoE FFN every `moe_every` layers
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256
    attn_every: int = 0              # hybrid: one attention layer per period

    # --- flavour knobs ---
    qk_norm: bool = False
    qkv_bias: bool = False
    nonparametric_ln: bool = False   # OLMo: LayerNorm without learned params
    rope_theta: float = 10000.0
    act: str = "silu"
    tie_embeddings: bool = False

    # --- structure ---
    enc_dec: bool = False
    n_enc_layers: int = 0
    cross_attn_every: int = 0        # VLM: cross-attn layer each period
    n_modality_tokens: int = 0       # stubbed frontend: patches / audio frames
    sliding_window: int = 0          # 0 = full attention

    # --- execution backend ---
    # "kernels" (default): prefill/decode attention through
    # ``kernels.ops.flash_attention_op`` / ``decode_attention_op`` (the CUDA
    # kernels on CUDA tensors, their plain versions on CPU tensors), with
    # the online-softmax path where the kernel lacks a feature (q_offset
    # prefill); "torch": the online-softmax paths of ``models/layers.py``,
    # twins of the JAX package's "jnp" paths.
    attn_backend: str = "kernels"

    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.attn_backend not in ATTN_BACKENDS:
            raise ValueError(f"attn_backend must be one of {ATTN_BACKENDS}, "
                             f"got {self.attn_backend!r}")

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def period(self) -> int:
        """Length of the repeating superblock the layer stack scans over."""
        p = 1
        if self.attn_every:
            p = self.attn_every
        if self.cross_attn_every:
            p = max(p, self.cross_attn_every)
        if self.moe_every > 1:
            import math
            p = p * self.moe_every // math.gcd(p, self.moe_every)
        return p

    @property
    def n_groups(self) -> int:
        assert self.n_layers % self.period == 0, (self.name, self.n_layers, self.period)
        return self.n_layers // self.period

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """True if long-context decode is native (SSM/hybrid-lite caches)."""
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    def reduced(self) -> "ArchConfig":
        """<=2 periods of layers, d_model<=512, <=4 experts — CPU smoke size."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads, 2))
        # Shrink interleave periods so a 2-layer model still contains one full
        # superblock of the family (attn+mamba for hybrids, self+cross for VLM).
        attn_every = 2 if self.attn_every else 0
        cross_every = 2 if self.cross_attn_every else 0
        period = 2 if (attn_every or cross_every or self.moe_every > 1) else 1
        kw = dict(
            name=self.name + "-reduced",
            attn_every=attn_every,
            cross_attn_every=cross_every,
            n_layers=2 if period == 1 else period,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            head_dim=64 if self.head_dim else 0,
            n_modality_tokens=min(self.n_modality_tokens, 16),
            ssm_state=min(self.ssm_state, 32) if self.ssm_state else 0,
            ssm_chunk=32,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            dtype="float32",
        )
        if self.n_experts:
            kw.update(
                n_experts=min(self.n_experts, 4),
                moe_top_k=min(self.moe_top_k, 2),
                moe_d_ff=min(self.moe_d_ff, 256),
                n_shared_experts=min(self.n_shared_experts, 1),
            )
        if self.enc_dec:
            kw.update(n_enc_layers=2)
        return self.replace(**kw)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS = [
    "deepseek-moe-16b",
    "llama-3.2-vision-11b",
    "seamless-m4t-medium",
    "jamba-1.5-large-398b",
    "smollm-135m",
    "olmo-1b",
    "qwen3-moe-235b-a22b",
    "qwen3-4b",
    "qwen2-0.5b",
    "mamba2-780m",
]


def get_config(arch_id: str, reduced: bool = False) -> ArchConfig:
    mod = importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_"))
    cfg = mod.CONFIG
    return cfg.reduced() if reduced else cfg


def all_configs() -> dict:
    return {a: get_config(a) for a in ARCH_IDS}
