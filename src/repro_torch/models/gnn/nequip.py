"""NequIP, an E(3)-equivariant interatomic potential in the tensor-product
regime (counterpart of ``repro.models.gnn.nequip``).

Node features are irrep channels ``[h_0, ..., h_lmax]``, ``h_l`` of shape
``[N, C, 2l+1]``.  Each interaction layer sends messages
    m^{l3}_ij = sum over paths (l1, l2) -> l3 of
                w_path(r_ij) * CG(h^{l1}_j (x) Y^{l2}(r̂_ij))
with radial weights from an MLP over a Bessel basis, sums them into each
destination with ``segment_sum`` (the segment-sum kernel, one launch an l
a layer), and mixes channels per l.  Gated nonlinearity: l=0 by SiLU, l>0
scaled by a sigmoid of dedicated scalars.  The summed per-atom energies
are the total energy; the forces are ``-dE/dpos`` by autograd with a
graph kept (``create_graph``), so the loss's parameter gradient is a
gradient of a gradient, whose sums also run on the kernel.

The layers' weights are stacked on a leading axis, as JAX stacks them for
its ``lax.scan``; the port loops over one ``unbind`` of them.  JAX's
scan checkpoints each layer; the port does not checkpoint NequIP's: under
the loss's backward of the forces, which keeps every recomputed
activation in its graph, that runs each layer twice more and saves
almost no memory (PERF.md).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceSpec, resolve_device
from repro_torch.models.gnn.equivariant import real_sph_harm, tensor_product
from repro_torch.models.layers import dense_init
from repro_torch.sparse.ops import segment_sum
from repro_torch.train.tree import tree_stack, tree_unstack


@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    name: str
    n_layers: int = 5
    d_hidden: int = 32          # channels per irrep
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 4
    dtype: str = "float32"

    @property
    def paths(self):
        out = []
        for l1 in range(self.l_max + 1):
            for l2 in range(self.l_max + 1):
                for l3 in range(abs(l1 - l2), min(l1 + l2, self.l_max) + 1):
                    out.append((l1, l2, l3))
        return out


def bessel_rbf(r: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """Bessel radial basis with a cosine cutoff envelope. r: [E] ->
    [E, n_rbf]."""
    rc = torch.clamp(r, 1e-6, cutoff)
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=r.device)
    basis = math.sqrt(2.0 / cutoff) * torch.sin(
        n[None, :] * math.pi * rc[:, None] / cutoff) / rc[:, None]
    envelope = 0.5 * (torch.cos(math.pi * rc / cutoff) + 1.0)
    return basis * envelope[:, None] * (r < cutoff)[:, None]


def init_params(cfg: NequIPConfig, generator: torch.Generator,
                device: DeviceSpec = None) -> dict:
    """Random weights as the JAX package draws them, from ``generator``,
    on ``device``; the layers stacked leaf by leaf (``mix`` a list of
    ``[L, C, C]``, one an l)."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    C = cfg.d_hidden

    def dense(d_in, d_out):
        return dense_init(d_in, d_out, dt, generator, dev)

    layers = [{
        # radial MLP: n_rbf -> C per path
        "radial_w1": dense(cfg.n_rbf, 32),
        "radial_w2": dense(32, len(cfg.paths) * C),
        # per-l channel mixing (self interaction)
        "mix": [dense(C, C) for _ in range(cfg.l_max + 1)],
        # gate scalars for l > 0
        "gate_w": dense(C, cfg.l_max * C),
    } for _ in range(cfg.n_layers)]
    embed = torch.randn((cfg.n_species, C), generator=generator,
                        device=generator.device) * 0.5
    return {"embed": embed.to(device=dev, dtype=dt),
            "readout_w1": dense(C, C), "readout_w2": dense(C, 1),
            "layers": tree_stack(layers)}


def _layer(cfg: NequIPConfig, lp, h, rbf, edge_ok, sh_blocks, src,
           edge_dst):
    n, C = h[0].shape[0], cfg.d_hidden
    radial = F.silu(rbf @ lp["radial_w1"]) @ lp["radial_w2"]
    radial = (radial * edge_ok).reshape(rbf.shape[0], len(cfg.paths), C)
    src_feat = [hl[src] for hl in h]                     # [E, C, 2l+1]
    msgs: list = [0.0] * (cfg.l_max + 1)
    for pi, (l1, l2, l3) in enumerate(cfg.paths):
        tp = tensor_product(src_feat[l1], sh_blocks[l2][:, None, :],
                            l1, l2, l3)                  # [E, C, 2l3+1]
        msgs[l3] = msgs[l3] + tp * radial[:, pi, :, None]
    new_h = []
    for l in range(cfg.l_max + 1):
        agg = segment_sum(msgs[l], edge_dst, n)          # [N, C, 2l+1]
        new_h.append(h[l] + torch.einsum("ncm,cd->ndm", agg, lp["mix"][l]))
    # gated nonlinearity
    scalars = new_h[0][:, :, 0]
    gates = torch.sigmoid(scalars @ lp["gate_w"]).reshape(n, cfg.l_max, C)
    return [F.silu(scalars)[:, :, None]] + [
        new_h[l] * gates[:, l - 1, :, None] for l in range(1, cfg.l_max + 1)]


def forward(cfg: NequIPConfig, params, species, positions, edge_src,
            edge_dst):
    """species: int[N]; positions: f[N, 3]; edges int[E] (directed both
    ways).  Returns (total energy, a 0-d tensor; the node features, a list
    by l)."""
    n = species.shape[0]
    C = cfg.d_hidden
    emb = params["embed"]
    h = [emb[species.long()][:, :, None]] + [
        emb.new_zeros((n, C, 2 * l + 1)) for l in range(1, cfg.l_max + 1)]
    src, dst = edge_src.long(), edge_dst.long()
    rel = positions[dst] - positions[src]                # [E, 3]
    r = torch.sqrt(torch.sum(rel * rel, dim=-1) + 1e-12)
    edge_ok = (r > 1e-6)[:, None]         # degenerate/padding edges: no-op
    sh = real_sph_harm(rel / r[:, None], cfg.l_max)      # [E, (L+1)^2]
    sh_blocks = [sh[:, l * l:(l + 1) * (l + 1)]
                 for l in range(cfg.l_max + 1)]
    rbf = bessel_rbf(r, cfg.n_rbf, cfg.cutoff) * edge_ok
    for lp in tree_unstack(params["layers"]):
        h = _layer(cfg, lp, h, rbf, edge_ok, sh_blocks, src, edge_dst)
    e_atom = F.silu(h[0][:, :, 0] @ params["readout_w1"]) @ \
        params["readout_w2"]
    return torch.sum(e_atom), h


def energy_and_forces(forward_fn, batch, create_graph: bool = True):
    """``(E, -dE/dpos)`` of ``forward_fn(positions) -> (E, features)`` at
    the batch's positions; with ``create_graph`` the forces keep their
    graph, so a loss of them differentiates again."""
    with torch.enable_grad():
        pos = batch["positions"].detach().requires_grad_()
        e, _ = forward_fn(pos)
        (grad,) = torch.autograd.grad(e, pos, create_graph=create_graph)
    return e, -grad


def loss_fn(cfg: NequIPConfig, params, batch) -> torch.Tensor:
    """Energy plus 10 x force matching, the forces by autograd."""
    e, forces = energy_and_forces(
        lambda pos: forward(cfg, params, batch["species"], pos,
                            batch["edge_src"], batch["edge_dst"]), batch)
    loss_e = (e - batch["energy"]) ** 2
    loss_f = torch.mean((forces - batch["forces"]) ** 2)
    return loss_e + 10.0 * loss_f
