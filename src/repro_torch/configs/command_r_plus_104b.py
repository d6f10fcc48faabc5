"""command-r-plus-104b [hf:CohereForAI/c4ai-command-r-v01; unverified] —
dense, GQA kv=8, no bias."""
from repro_torch.models.transformer import TransformerConfig

FAMILY = "lm"

CONFIG = TransformerConfig(
    name="command-r-plus-104b", n_layers=64, d_model=12288, n_heads=96,
    n_kv_heads=8, d_ff=33792, vocab=256000, qk_norm=False,
    rope_theta=75e4, dtype="bfloat16")

SMOKE = TransformerConfig(
    name="command-r-plus-104b-smoke", n_layers=2, d_model=96, n_heads=6,
    n_kv_heads=2, d_ff=256, vocab=512, dtype="float32",
    attn_impl="naive", remat=False)
