"""Graph attention network (counterpart of ``repro.models.gnn.gat``): SDDMM
edge scores -> edge softmax -> weighted scatter aggregation, over segment
ops.  The softmax's denominators and each layer's aggregation sum on the
segment-sum kernel."""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceSpec, resolve_device
from repro_torch.models.layers import cross_entropy_loss, dense_init
from repro_torch.sparse.ops import edge_softmax, segment_sum


@dataclasses.dataclass(frozen=True)
class GATConfig:
    name: str
    n_layers: int
    d_in: int
    d_hidden: int              # per head
    n_heads: int
    n_classes: int
    negative_slope: float = 0.2
    dtype: str = "float32"


def init_params(cfg: GATConfig, generator: torch.Generator,
                device: DeviceSpec = None) -> dict:
    """Random weights as the JAX package draws them, from ``generator``,
    on ``device``: per layer ``w`` [d_prev, heads * d_out] and the
    attention vectors ``a_src``, ``a_dst`` [heads, d_out]."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    layers = []
    d_prev = cfg.d_in
    for i in range(cfg.n_layers):
        last = i == cfg.n_layers - 1
        heads = 1 if last else cfg.n_heads
        d_out = cfg.n_classes if last else cfg.d_hidden
        lp = {"w": dense_init(d_prev, heads * d_out, dt, generator, dev)}
        for name in ("a_src", "a_dst"):
            a = torch.randn((heads, d_out), generator=generator,
                            device=generator.device)
            lp[name] = (a * d_out ** -0.5).to(device=dev, dtype=dt)
        layers.append(lp)
        d_prev = d_out * (1 if last else cfg.n_heads)
    return {"layers": layers}


def forward(cfg: GATConfig, params, feats, edge_src, edge_dst,
            n_nodes: int):
    """feats [N, d_in], edge arrays int[E] -> logits [N, n_classes]."""
    src, dst = edge_src.long(), edge_dst.long()
    h = feats
    for i, lp in enumerate(params["layers"]):
        last = i == cfg.n_layers - 1
        heads = 1 if last else cfg.n_heads
        d_out = lp["a_src"].shape[1]
        z = (h @ lp["w"]).reshape(n_nodes, heads, d_out)
        # SDDMM: per-edge score from source/destination projections
        s_src = torch.sum(z * lp["a_src"][None], dim=-1)     # [N, H]
        s_dst = torch.sum(z * lp["a_dst"][None], dim=-1)
        e = s_src[src] + s_dst[dst]                          # [E, H]
        e = F.leaky_relu(e, cfg.negative_slope)
        alpha = edge_softmax(e, edge_dst, n_nodes)           # [E, H]
        msgs = z[src] * alpha[..., None]                     # [E, H, D]
        agg = segment_sum(msgs, edge_dst, n_nodes)           # [N, H, D]
        h = agg.reshape(n_nodes, heads * d_out)
        if not last:
            h = F.elu(h)
    return h


def loss_fn(cfg: GATConfig, params, batch) -> torch.Tensor:
    """Node-classification CE, averaged over ``label_mask`` where the batch
    has one."""
    logits = forward(cfg, params, batch["feats"], batch["edge_src"],
                     batch["edge_dst"], batch["feats"].shape[0])
    return cross_entropy_loss(logits, batch["labels"],
                              batch.get("label_mask"))
