"""EquiformerV2, equivariant graph attention by eSCN SO(2) convolutions
(counterpart of ``repro.models.gnn.equiformer_v2``).

Rotating each edge's features into a frame where the edge lies on +z makes
the SO(3) tensor product block-diagonal in m: an O(L^3) SO(2) convolution
instead of the O(L^6) CG contraction.  For each edge:

  1. rotate the source irreps into the edge frame, x̃ = D(R_ij) x;
  2. SO(2) linear maps per |m| <= m_max with the complex-pair structure
        y_{+m} = W1_m x_{+m} - W2_m x_{-m}
        y_{-m} = W2_m x_{+m} + W1_m x_{-m}
     (m=0 a plain linear map), modulated by a radial MLP; components with
     |m| > m_max are dropped (the m_max truncation);
  3. attention: invariant (m=0) channels -> per-head logits -> edge
     softmax over incoming edges -> weighted messages rotated back with
     D(R_ij)^T, summed into each destination with ``segment_sum`` (the
     segment-sum kernel).

Features: [N, C, (l_max+1)^2] real-SH irreps.  ``edge_chunk`` (JAX's edge
blocking) builds the per-edge [e, C, S] tensors for ``edge_chunk`` edges
at a time, a Python loop over edge blocks with each block's sum added into
the accumulator; the attention softmax is global either way.  Layers are
stacked as in JAX; while grad is enabled each layer runs under
``torch.utils.checkpoint``, as JAX's scan remats it, which under the
forces' double backward still keeps less (PERF.md).
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceSpec, resolve_device
from repro_torch.models.gnn.equivariant import (apply_wigner,
                                                edge_align_rotation,
                                                wigner_d_matrices)
from repro_torch.models.gnn.nequip import bessel_rbf, energy_and_forces
from repro_torch.models.layers import dense_init
from repro_torch.sparse.ops import edge_softmax, segment_sum
from repro_torch.train.tree import tree_stack, tree_unstack


@dataclasses.dataclass(frozen=True)
class EquiformerV2Config:
    name: str
    n_layers: int = 12
    d_hidden: int = 128
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    n_rbf: int = 16
    cutoff: float = 5.0
    n_species: int = 8
    dtype: str = "float32"
    # edge blocking: per-edge [C, (l_max+1)^2] message tensors never exist
    # for more than `edge_chunk` edges at a time. 0 = unchunked.
    edge_chunk: int = 0

    @property
    def sph_dim(self) -> int:
        return (self.l_max + 1) ** 2


def _m_indices(l_max: int):
    """For each m in 0..l_max: list of flat SH indices of (l, +m), (l, -m)."""
    pos, neg = {}, {}
    for m in range(l_max + 1):
        pos[m] = [l * l + l + m for l in range(m, l_max + 1)]
        neg[m] = [l * l + l - m for l in range(m, l_max + 1)]
    return pos, neg


@functools.lru_cache(maxsize=None)
def _m_index_tensors(l_max: int, device: torch.device):
    """``_m_indices`` as index tensors on ``device``, made there once."""
    pos, neg = _m_indices(l_max)
    return ({m: torch.tensor(v, device=device) for m, v in pos.items()},
            {m: torch.tensor(v, device=device) for m, v in neg.items()})


def init_params(cfg: EquiformerV2Config, generator: torch.Generator,
                device: DeviceSpec = None) -> dict:
    """Random weights as the JAX package draws them, from ``generator``,
    on ``device``; the layers stacked leaf by leaf (``so2`` a list by m of
    ``{"w1"}`` (m = 0) or ``{"w1", "w2"}``, each ``[L, C n_l, C n_l]``)."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    C, H = cfg.d_hidden, cfg.n_heads
    pos, _ = _m_indices(cfg.l_max)

    def dense(d_in, d_out):
        return dense_init(d_in, d_out, dt, generator, dev)

    def square(d):
        return dense_init(d, d, dt, generator, dev)

    layers = []
    for _ in range(cfg.n_layers):
        lp = {
            "radial_w1": dense(cfg.n_rbf, 64),
            "radial_w2": dense(64, C),
            "attn_q": dense(C, H),
            "attn_k": dense(C, H),
            "out_mix": dense(C, C),
            "ffn_w1": dense(C, 2 * C),
            "ffn_w2": dense(2 * C, C),
            "ln_scale": torch.ones((C,), dtype=dt, device=dev),
            # SO(2) weights per m (0..m_max): mix channels AND l-components
            "so2": [],
        }
        for m in range(cfg.m_max + 1):
            d = C * len(pos[m])
            lp["so2"].append({"w1": square(d)} if m == 0 else
                             {"w1": square(d), "w2": square(d)})
        layers.append(lp)
    embed = torch.randn((cfg.n_species, C), generator=generator,
                        device=generator.device) * 0.5
    return {"embed": embed.to(device=dev, dtype=dt),
            "readout_w1": dense(C, C), "readout_w2": dense(C, 1),
            "layers": tree_stack(layers)}


def _equi_layernorm(x, scale):
    """Norm over irrep magnitude per channel (equivariant)."""
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) + 1e-12)
    mean_norm = torch.mean(norm, dim=-2, keepdim=True)
    return x / torch.clamp_min(mean_norm, 1e-6) * scale[None, :, None]


def _edge_messages(cfg: EquiformerV2Config, lp, xn, src, rel, alpha):
    """Messages for one edge block: rotate -> SO(2) conv -> rotate back.

    src: int[e]; rel: f[e, 3]; alpha: f[e, H].  Returns [e, C, S].
    """
    C, H = cfg.d_hidden, cfg.n_heads
    dt = xn.dtype
    pos_idx, neg_idx = _m_indices(cfg.l_max)
    pos_t, neg_t = _m_index_tensors(cfg.l_max, xn.device)
    r = torch.sqrt(torch.sum(rel * rel, dim=-1) + 1e-12)
    edge_ok = (r > 1e-6)[:, None].to(dt)     # degenerate/pad edges: no-op
    rbf = bessel_rbf(r, cfg.n_rbf, cfg.cutoff).to(dt) * edge_ok
    Ds = [d.to(dt) for d in wigner_d_matrices(edge_align_rotation(rel),
                                              cfg.l_max)]
    radial = F.silu(rbf @ lp["radial_w1"]) @ lp["radial_w2"]
    # 1. rotate source features into edge frames (per-l blocks)
    xe = apply_wigner(Ds, xn[src]) * radial[:, :, None]      # [e, C, S]
    # 2. SO(2) convolution per |m| <= m_max (others truncated); the output
    # columns are reassembled by a static stack
    e_n = xe.shape[0]
    cols: list = [None] * cfg.sph_dim
    for m in range(cfg.m_max + 1):
        pi = pos_idx[m]
        wm = lp["so2"][m]
        xp = xe[:, :, pos_t[m]].reshape(e_n, -1)             # [e, C*n_l]
        if m == 0:
            yp = (xp @ wm["w1"]).reshape(e_n, C, -1)
            for j, s_idx in enumerate(pi):
                cols[s_idx] = yp[:, :, j]
        else:
            ni = neg_idx[m]
            xm = xe[:, :, neg_t[m]].reshape(e_n, -1)
            yp = (xp @ wm["w1"] - xm @ wm["w2"]).reshape(e_n, C, -1)
            ym = (xp @ wm["w2"] + xm @ wm["w1"]).reshape(e_n, C, -1)
            for j, s_idx in enumerate(pi):
                cols[s_idx] = yp[:, :, j]
            for j, s_idx in enumerate(ni):
                cols[s_idx] = ym[:, :, j]
    zero = xe.new_zeros((e_n, C))
    ye = torch.stack([c if c is not None else zero for c in cols], dim=-1)
    # 3. rotate back, weight by attention (heads split channels)
    msg = apply_wigner(Ds, ye, transpose=True)               # D^T = D^-1
    msg = msg.reshape(e_n, H, C // H, cfg.sph_dim) * alpha[:, :, None, None]
    return msg.reshape(e_n, C, cfg.sph_dim)


def _layer(cfg: EquiformerV2Config, lp, x, positions, edge_src, edge_dst,
           chunk: int):
    n = x.shape[0]
    src, dst = edge_src.long(), edge_dst.long()
    xn = _equi_layernorm(x, lp["ln_scale"])
    # attention logits depend only on node invariants: computed for ALL
    # edges ([E, H]), so the softmax is exact and global when chunked
    inv = xn[:, :, 0]
    logits = inv[src] @ lp["attn_q"] + inv[dst] @ lp["attn_k"]
    alpha = edge_softmax(F.leaky_relu(logits, 0.2), edge_dst, n)
    if not chunk:
        rel = positions[dst] - positions[src]
        agg = segment_sum(_edge_messages(cfg, lp, xn, src, rel, alpha),
                          edge_dst, n)
    else:
        # padding edges are (0, 0) self loops -> rel = 0 -> masked no-ops,
        # and their attention is 0
        pad = -len(src) % chunk
        src_b = F.pad(src, (0, pad)).reshape(-1, chunk)
        dst_b = F.pad(dst, (0, pad)).reshape(-1, chunk)
        alpha_b = F.pad(alpha, (0, 0, 0, pad)).reshape(
            src_b.shape[0], chunk, -1)
        agg = x.new_zeros(x.shape)
        for s, d, a in zip(src_b, dst_b, alpha_b):
            rel = positions[d] - positions[s]
            agg = agg + segment_sum(_edge_messages(cfg, lp, xn, s, rel, a),
                                    d, n)
    x = x + torch.einsum("ncm,cd->ndm", agg, lp["out_mix"])
    # equivariant FFN: scalar-gated per-channel mix
    g = F.silu(x[:, :, 0] @ lp["ffn_w1"]) @ lp["ffn_w2"]
    return x + x * torch.sigmoid(g)[:, :, None]


def forward(cfg: EquiformerV2Config, params, species, positions,
            edge_src, edge_dst):
    """species: int[N]; positions: f[N, 3]; edges int[E].  Returns (total
    energy, a 0-d tensor; the node features [N, C, S])."""
    E = edge_src.shape[0]
    chunk = cfg.edge_chunk if 0 < cfg.edge_chunk < E else 0
    x = F.pad(params["embed"][species.long()][:, :, None],
              (0, cfg.sph_dim - 1))
    remat = torch.is_grad_enabled()
    for lp in tree_unstack(params["layers"]):
        args = (cfg, lp, x, positions, edge_src, edge_dst, chunk)
        x = checkpoint(_layer, *args, use_reentrant=False) if remat \
            else _layer(*args)
    e_atom = F.silu(x[:, :, 0] @ params["readout_w1"]) @ \
        params["readout_w2"]
    return torch.sum(e_atom), x


def loss_fn(cfg: EquiformerV2Config, params, batch) -> torch.Tensor:
    """Energy plus 10 x force matching, the forces by autograd."""
    e, forces = energy_and_forces(
        lambda pos: forward(cfg, params, batch["species"], pos,
                            batch["edge_src"], batch["edge_dst"]), batch)
    return (e - batch["energy"]) ** 2 + 10.0 * torch.mean(
        (forces - batch["forces"]) ** 2)
