"""GraphSAGE with the mean aggregator (counterpart of
``repro.models.gnn.graphsage``): the full-graph forward (a gather and
``segment_mean`` over an edge index, on the segment-sum kernel) and the
sampled-minibatch forward over fanout blocks from
``repro_torch.graph.sampler.sample_fanout`` (a mean over each block's
fanout axis; no segment op)."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import DeviceSpec, resolve_device
from repro_torch.models.layers import cross_entropy_loss, dense_init
from repro_torch.sparse.ops import segment_mean


@dataclasses.dataclass(frozen=True)
class SAGEConfig:
    name: str
    n_layers: int
    d_in: int
    d_hidden: int
    n_classes: int
    sample_sizes: tuple[int, ...] = (25, 10)
    dtype: str = "float32"


def init_params(cfg: SAGEConfig, generator: torch.Generator,
                device: DeviceSpec = None) -> dict:
    """Random weights as the JAX package draws them, from ``generator``,
    on ``device``: per layer ``w_self``, ``w_neigh`` and a zero ``b``."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    layers = []
    d_prev = cfg.d_in
    for i in range(cfg.n_layers):
        d_out = cfg.d_hidden if i < cfg.n_layers - 1 else cfg.n_classes
        layers.append({
            "w_self": dense_init(d_prev, d_out, dt, generator, dev),
            "w_neigh": dense_init(d_prev, d_out, dt, generator, dev),
            "b": torch.zeros((d_out,), dtype=dt, device=dev)})
        d_prev = d_out
    return {"layers": layers}


def forward_full(cfg: SAGEConfig, params, feats, edge_src, edge_dst,
                 n_nodes: int):
    """Full-graph forward: feats [N, d_in], edge arrays int[E]."""
    src = edge_src.long()
    h = feats
    for i, lp in enumerate(params["layers"]):
        agg = segment_mean(h[src], edge_dst, n_nodes)
        h = h @ lp["w_self"] + agg @ lp["w_neigh"] + lp["b"]
        if i < cfg.n_layers - 1:
            h = torch.relu(h)
    return h


def forward_sampled(cfg: SAGEConfig, params, feat_blocks):
    """Minibatch forward over fanout blocks.

    feat_blocks[k]: features of the k-hop frontier, [B * prod(fanout[:k]),
    d_in].  Layer i aggregates block i+1 (its sampled neighbors) into
    block i.
    """
    h = list(feat_blocks)
    n_layers = cfg.n_layers
    for i, lp in enumerate(params["layers"]):
        new_h = []
        for depth in range(n_layers - i):
            # block depth+1 was sampled from block depth with this fanout
            fan = cfg.sample_sizes[min(depth, len(cfg.sample_sizes) - 1)]
            cur = h[depth]
            agg = h[depth + 1].reshape(cur.shape[0], fan, -1).mean(dim=1)
            out = cur @ lp["w_self"] + agg @ lp["w_neigh"] + lp["b"]
            if i < n_layers - 1:
                out = torch.relu(out)
            new_h.append(out)
        h = new_h
    return h[0]


def loss_fn(cfg: SAGEConfig, params, batch) -> torch.Tensor:
    """CE over the seeds (sampled), or over ``label_idx``'s nodes where
    the full-graph batch names them, else over every node."""
    if "feat_blocks" in batch:
        logits = forward_sampled(cfg, params, batch["feat_blocks"])
    else:
        logits = forward_full(cfg, params, batch["feats"],
                              batch["edge_src"], batch["edge_dst"],
                              batch["feats"].shape[0])
        if "label_idx" in batch:
            logits = logits[batch["label_idx"].long()]
    return cross_entropy_loss(logits, batch["labels"])
