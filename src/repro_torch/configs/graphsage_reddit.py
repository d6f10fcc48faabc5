"""graphsage-reddit [arXiv:1706.02216; paper] — 2 layers, mean aggregator,
fanout 25-10."""
from repro_torch.models.gnn.graphsage import SAGEConfig

FAMILY = "gnn"

CONFIG = SAGEConfig(
    name="graphsage-reddit", n_layers=2, d_in=602, d_hidden=128,
    n_classes=41, sample_sizes=(25, 10))

SMOKE = SAGEConfig(
    name="graphsage-reddit-smoke", n_layers=2, d_in=16, d_hidden=16,
    n_classes=5, sample_sizes=(5, 3))
