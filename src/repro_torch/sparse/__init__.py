from repro_torch.sparse.ops import (
    segment_sum, segment_max, segment_mean, edge_softmax, embedding_bag,
    expand_ragged, compact_mask,
)
from repro_torch.sparse.intersect import (
    binary_contains, intersect_count_sorted, adj_contains,
)
