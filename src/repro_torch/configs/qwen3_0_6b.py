"""qwen3-0.6b [hf:Qwen/Qwen3-8B family; hf] — dense, GQA kv=8, qk_norm."""
from repro_torch.models.transformer import TransformerConfig

FAMILY = "lm"

CONFIG = TransformerConfig(
    name="qwen3-0.6b", n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=3072, vocab=151936, d_head=128, qk_norm=True, rope_theta=1e6,
    dtype="bfloat16")

SMOKE = TransformerConfig(
    name="qwen3-0.6b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=512, d_head=32, qk_norm=True,
    dtype="float32", attn_impl="naive", remat=False)
