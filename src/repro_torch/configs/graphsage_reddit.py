"""graphsage-reddit [arXiv:1706.02216].

2 layers, d_hidden=128, mean aggregator, fanout 25-10 (paper's S1·S2).
d_in/n_classes default to the reddit cell (232,965 nodes, 602 features,
41 classes); the other graph shapes (cora, ogbn-products, molecules) set
their own.
"""
from repro_torch.configs.base import GNNConfig

FULL = GNNConfig(
    name="graphsage-reddit",
    n_layers=2, d_hidden=128, d_in=602, n_classes=41,
    aggregator="mean", sample_sizes=(25, 10),
)

SMOKE = GNNConfig(
    name="graphsage-reddit-smoke",
    n_layers=2, d_hidden=16, d_in=8, n_classes=4,
    aggregator="mean", sample_sizes=(4, 3),
)
