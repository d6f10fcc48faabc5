"""Per-family input-shape sets (the assigned 40 arch x shape cells)."""

LM_SHAPES = {
    "train_4k": {"kind": "train", "seq_len": 4096, "global_batch": 256},
    "prefill_32k": {"kind": "prefill", "seq_len": 32768, "global_batch": 32},
    "decode_32k": {"kind": "decode", "seq_len": 32768, "global_batch": 128},
    "long_500k": {"kind": "decode", "seq_len": 524288, "global_batch": 1},
}

GNN_SHAPES = {
    "full_graph_sm": {"kind": "train", "n_nodes": 2708, "n_edges": 10556,
                      "d_feat": 1433},
    "minibatch_lg": {"kind": "train", "n_nodes": 232965,
                     "n_edges": 114_615_892, "batch_nodes": 1024,
                     "fanout": (15, 10)},
    "ogb_products": {"kind": "train", "n_nodes": 2_449_029,
                     "n_edges": 61_859_140, "d_feat": 100},
    "molecule": {"kind": "train", "n_nodes": 30, "n_edges": 64,
                 "batch": 128},
}

RECSYS_SHAPES = {
    "train_batch": {"kind": "train", "batch": 65536},
    "serve_p99": {"kind": "serve", "batch": 512},
    "serve_bulk": {"kind": "serve", "batch": 262144},
    "retrieval_cand": {"kind": "retrieval", "batch": 1,
                       "n_candidates": 1_000_000},
}

FAMILY_SHAPES = {"lm": LM_SHAPES, "gnn": GNN_SHAPES, "recsys": RECSYS_SHAPES}
