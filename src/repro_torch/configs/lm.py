"""Assigned LM-family architecture configs (exact, from public literature)."""

from __future__ import annotations

from ..models.mla import MLAConfig
from ..models.moe import MoEConfig
from ..models.transformer import TransformerConfig

from .registry import LM_SHAPES, Arch, register

_FULL_ATTN_SKIP = (
    "long_500k requires sub-quadratic attention; this arch is a pure "
    "full-attention stack (skip noted in DESIGN.md §Arch-applicability)."
)


# -- gemma2-2b [arXiv:2408.00118]: local+global alternating, logit softcaps --

def gemma2_2b() -> TransformerConfig:
    return TransformerConfig(
        name="gemma2-2b", n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4,
        head_dim=256, d_ff=9216, vocab=256000, rope_theta=10000.0,
        attn_softcap=50.0, final_softcap=30.0,
        window=4096, window_pattern="alternate", post_norms=True,
        embed_scale=True, tie_embeddings=True,
    )


def gemma2_smoke() -> TransformerConfig:
    return TransformerConfig(
        name="gemma2-smoke", n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab=512, attn_softcap=50.0, final_softcap=30.0,
        window=8, window_pattern="alternate", post_norms=True, embed_scale=True,
        tie_embeddings=True, dtype="float32",
    )


register(Arch(
    arch_id="gemma2-2b", family="lm", make_config=gemma2_2b,
    make_smoke=gemma2_smoke, shapes=LM_SHAPES,
    notes=("long_500k RUNS for this arch: 13/26 layers are 4k sliding-window "
           "(local+global hybrid); decode attends a sequence-sharded cache."),
))


# -- qwen1.5-0.5b [hf:Qwen/Qwen1.5-0.5B]: MHA with QKV bias ------------------

def qwen15_05b() -> TransformerConfig:
    return TransformerConfig(
        name="qwen1.5-0.5b", n_layers=24, d_model=1024, n_heads=16,
        n_kv_heads=16, head_dim=64, d_ff=2816, vocab=151936,
        rope_theta=1_000_000.0, qkv_bias=True, tie_embeddings=True,
    )


def qwen_smoke() -> TransformerConfig:
    return TransformerConfig(
        name="qwen-smoke", n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=160, vocab=512, qkv_bias=True, dtype="float32",
    )


register(Arch(
    arch_id="qwen1.5-0.5b", family="lm", make_config=qwen15_05b,
    make_smoke=qwen_smoke, shapes=LM_SHAPES,
    skips={"long_500k": _FULL_ATTN_SKIP},
))


# -- llama3.2-3b [hf:meta-llama]: GQA kv=8 ------------------------------------

def llama32_3b() -> TransformerConfig:
    return TransformerConfig(
        name="llama3.2-3b", n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8,
        head_dim=128, d_ff=8192, vocab=128256, rope_theta=500_000.0,
        tie_embeddings=True,
    )


def llama_smoke() -> TransformerConfig:
    return TransformerConfig(
        name="llama-smoke", n_layers=3, d_model=96, n_heads=6, n_kv_heads=2,
        head_dim=16, d_ff=256, vocab=512, dtype="float32",
    )


register(Arch(
    arch_id="llama3.2-3b", family="lm", make_config=llama32_3b,
    make_smoke=llama_smoke, shapes=LM_SHAPES,
    skips={"long_500k": _FULL_ATTN_SKIP},
))


# -- deepseek-v3-671b [arXiv:2412.19437]: MLA + 1 shared + 256 routed top-8 +
#    MTP; first 3 layers dense (d_ff 18432), aux-loss-free sigmoid router ----

def deepseek_v3() -> TransformerConfig:
    return TransformerConfig(
        name="deepseek-v3-671b", n_layers=61, d_model=7168, n_heads=128,
        n_kv_heads=128, head_dim=128, d_ff=18432, vocab=129280,
        rope_theta=10000.0, tie_embeddings=False,
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128,
                      qk_rope_dim=64, v_head_dim=128),
        moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048, n_shared=1,
                      router="sigmoid", capacity_factor=1.25,
                      first_dense_layers=3),
        mtp=True,
    )


def deepseek_smoke() -> TransformerConfig:
    return TransformerConfig(
        name="deepseek-smoke", n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab=512, tie_embeddings=False,
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                      qk_rope_dim=8, v_head_dim=16),
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, n_shared=1,
                      router="sigmoid", first_dense_layers=1),
        mtp=True, dtype="float32",
    )


register(Arch(
    arch_id="deepseek-v3-671b", family="lm", make_config=deepseek_v3,
    make_smoke=deepseek_smoke, shapes=LM_SHAPES,
    skips={"long_500k": _FULL_ATTN_SKIP},
    notes="optimizer state kept in bf16 for the dry-run memory budget "
          "(EXPERIMENTS.md §Dry-run).",
))


# -- olmoe-1b-7b [arXiv:2409.02060]: 64 experts top-8, all layers MoE --------

def olmoe() -> TransformerConfig:
    return TransformerConfig(
        name="olmoe-1b-7b", n_layers=16, d_model=2048, n_heads=16,
        n_kv_heads=16, head_dim=128, d_ff=1024, vocab=50304,
        rope_theta=10000.0, tie_embeddings=False,
        moe=MoEConfig(n_experts=64, top_k=8, d_ff_expert=1024,
                      router="softmax", capacity_factor=1.25),
    )


def olmoe_smoke() -> TransformerConfig:
    return TransformerConfig(
        name="olmoe-smoke", n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=64, vocab=512, tie_embeddings=False,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64, router="softmax"),
        dtype="float32",
    )


register(Arch(
    arch_id="olmoe-1b-7b", family="lm", make_config=olmoe,
    make_smoke=olmoe_smoke, shapes=LM_SHAPES,
    skips={"long_500k": _FULL_ATTN_SKIP},
))
