"""kimi-k2-1t-a32b [arXiv:2501.kimi2; unverified, paper-table] —
trillion-parameter MoE: 384 routed experts top-8, per-expert d_ff=2048.
2.09 TB of bf16 weights: one card serves only its SMOKE widths."""
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

FAMILY = "lm"

CONFIG = TransformerConfig(
    name="kimi-k2-1t-a32b", n_layers=61, d_model=7168, n_heads=64,
    n_kv_heads=8, d_ff=0, vocab=163840, d_head=128, qk_norm=True,
    dtype="bfloat16",
    moe=MoEConfig(n_routed=384, top_k=8, d_ff=2048, n_shared=1,
                  capacity_factor=1.25))

SMOKE = TransformerConfig(
    name="kimi-k2-1t-a32b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=0, vocab=512, d_head=32, qk_norm=True,
    dtype="float32", attn_impl="naive", remat=False,
    moe=MoEConfig(n_routed=8, top_k=2, d_ff=32, n_shared=1,
                  capacity_factor=2.0))
