"""deepseek-moe-16b [arXiv:2401.06066; hf] — fine-grained MoE:
2 shared + 64 routed experts, top-6, per-expert d_ff=1408."""
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

FAMILY = "lm"

CONFIG = TransformerConfig(
    name="deepseek-moe-16b", n_layers=28, d_model=2048, n_heads=16,
    n_kv_heads=16, d_ff=0, vocab=102400, dtype="bfloat16",
    moe=MoEConfig(n_routed=64, top_k=6, d_ff=1408, n_shared=2,
                  capacity_factor=1.25))

SMOKE = TransformerConfig(
    name="deepseek-moe-16b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=0, vocab=512, dtype="float32", attn_impl="naive",
    remat=False,
    moe=MoEConfig(n_routed=8, top_k=2, d_ff=32, n_shared=2,
                  capacity_factor=2.0))
