"""gat-cora [arXiv:1710.10903; paper] — 2 layers, 8 heads, hidden 8."""
from repro_torch.models.gnn.gat import GATConfig

FAMILY = "gnn"

CONFIG = GATConfig(
    name="gat-cora", n_layers=2, d_in=1433, d_hidden=8, n_heads=8,
    n_classes=7)

SMOKE = GATConfig(
    name="gat-cora-smoke", n_layers=2, d_in=16, d_hidden=4, n_heads=4,
    n_classes=3)
