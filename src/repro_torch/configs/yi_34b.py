"""yi-34b [arXiv:2403.04652; hf] — llama-arch dense, GQA kv=8."""
from repro_torch.models.transformer import TransformerConfig

FAMILY = "lm"

CONFIG = TransformerConfig(
    name="yi-34b", n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab=64000, qk_norm=False, rope_theta=5e6,
    dtype="bfloat16")

SMOKE = TransformerConfig(
    name="yi-34b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=192, vocab=512, dtype="float32", attn_impl="naive", remat=False)
