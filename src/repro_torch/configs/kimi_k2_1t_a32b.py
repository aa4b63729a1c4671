"""Kimi K2 1T-A32B [arXiv:2501.kimi2] — trillion-param MoE (paper-table):
384 experts top-8, one shared expert, per-expert FFN hidden 2048,
GQA 64q/8kv. (K2's MLA attention is replaced by the assignment's GQA
spec — the assignment fixes head counts explicitly.)"""
from .base import ModelConfig, MoESpec, register

KIMI_K2_1T_A32B = register(ModelConfig(
    arch_id="kimi-k2-1t-a32b",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,   # per-expert hidden (the assignment's d_ff for MoE archs)
    vocab=163840,
    layer_pattern=("attn",),
    moe=MoESpec(n_experts=384, top_k=8, d_expert=2048,
                n_shared_experts=1),
    rope="standard",
    rope_theta=5e4,
    act="silu",
    source="arXiv:2501.kimi2",
))
