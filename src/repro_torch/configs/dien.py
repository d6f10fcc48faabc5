"""dien [arXiv:1809.03672; unverified] — embed 18, seq 100, AUGRU 108,
MLP 200-80. Production tables: 10M items / 10k categories."""
from repro_torch.models.recsys.dien import DIENConfig

FAMILY = "recsys"

CONFIG = DIENConfig(
    name="dien", embed_dim=18, seq_len=100, gru_dim=108, mlp=(200, 80),
    n_items=10_000_000, n_cats=10_000)

SMOKE = DIENConfig(
    name="dien-smoke", embed_dim=8, seq_len=10, gru_dim=16, mlp=(32, 16),
    n_items=1000, n_cats=50)
