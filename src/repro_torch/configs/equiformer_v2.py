"""equiformer-v2 [arXiv:2306.12059; unverified] — SO(2)-eSCN equivariant
graph attention, l_max=6, m_max=2."""
from repro_torch.models.gnn.equiformer_v2 import EquiformerV2Config

FAMILY = "gnn"

CONFIG = EquiformerV2Config(
    name="equiformer-v2", n_layers=12, d_hidden=128, l_max=6, m_max=2,
    n_heads=8, edge_chunk=2 ** 21)   # edge blocking for the 100M+ edge cells

SMOKE = EquiformerV2Config(
    name="equiformer-v2-smoke", n_layers=2, d_hidden=16, l_max=2, m_max=1,
    n_heads=4, n_rbf=4)
