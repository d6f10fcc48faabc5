"""Deterministic synthetic data (counterpart of ``repro.data.pipeline``).

A batch is a pure function of ``(seed, step, shard)``: a restarted or
resized job asking for step N gets the same batch.  The draws come from a
``torch.Generator`` seeded from that triple, so they follow the JAX
package's distributions and rules but not its bits (``lm_batch``,
``recsys_batch``, ``molecule_batch``).  ``node_classification_data`` is
numpy in both packages and returns the JAX package's arrays bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceSpec, resolve_device


def _generator(seed: int, step: int, shard: int,
               dev: torch.device) -> torch.Generator:
    """A generator on ``dev`` seeded from the three ints, mixed so that
    near triples give unrelated streams."""
    state = np.random.SeedSequence([seed, step, shard]).generate_state(
        2, np.uint32)
    mixed = (int(state[0]) << 31) ^ int(state[1])       # < 2^63
    return torch.Generator(dev).manual_seed(mixed)


def lm_batch(seed: int, step: int, batch: int, seq_len: int, vocab: int,
             shard: int = 0, n_shards: int = 1,
             device: DeviceSpec = None) -> dict:
    """One shard's ``batch // n_shards`` sequences with learnable
    structure: base ids drawn with logit 3.0 on the first ``min(vocab,
    256)`` ids and 0 elsewhere; where a fair coin says so, a token follows
    its left neighbour's base id plus 1 (mod ``vocab``); ``labels`` are the
    tokens shifted left by one (rolled).  int32 tensors on ``device``."""
    dev = resolve_device(device)
    g = _generator(seed, step, shard, dev)
    b = batch // n_shards
    logits = torch.zeros(vocab, device=dev)
    logits[:min(vocab, 256)] = 3.0
    base = torch.multinomial(torch.softmax(logits, 0), b * seq_len,
                             replacement=True, generator=g).view(b, seq_len)
    # deterministic next-token structure: half the positions follow t+1
    follow = torch.rand((b, seq_len), generator=g, device=dev) < 0.5
    shifted = torch.roll(base, 1, dims=1)
    tokens = torch.where(follow, (shifted + 1) % vocab, base)
    labels = torch.roll(tokens, -1, dims=1)
    return {"tokens": tokens.to(torch.int32),
            "labels": labels.to(torch.int32)}


def recsys_batch(seed: int, step: int, batch: int, seq_len: int,
                 n_items: int, n_cats: int, shard: int = 0,
                 n_shards: int = 1, device: DeviceSpec = None) -> dict:
    """One shard's ``batch // n_shards`` requests: uniform history and
    target items, ``cats = items % n_cats``, and a click label that is
    whether the target appears in the history mod 1000, XOR 10% noise.
    int32 tensors on ``device``."""
    dev = resolve_device(device)
    g = _generator(seed, step, shard, dev)
    b = batch // n_shards
    hist = torch.randint(0, n_items, (b, seq_len), generator=g, device=dev,
                         dtype=torch.int32)
    tgt = torch.randint(0, n_items, (b,), generator=g, device=dev,
                        dtype=torch.int32)
    # clicks correlate with the target appearing in the history
    appears = (hist % 1000 == (tgt % 1000)[:, None]).any(dim=1)
    noise = torch.rand((b,), generator=g, device=dev) < 0.1
    return {"hist_items": hist, "hist_cats": hist % n_cats,
            "target_item": tgt, "target_cat": tgt % n_cats,
            "label": (appears ^ noise).to(torch.int32)}


def _lj_energy(pos: torch.Tensor, es: torch.Tensor, ed: torch.Tensor
               ) -> torch.Tensor:
    """The pairwise Lennard-Jones-style target, summed over the directed
    pairs and halved."""
    rel = pos[ed] - pos[es]
    r = torch.sqrt(torch.sum(rel ** 2, -1) + 1e-9)
    return 0.5 * torch.sum(4.0 * ((0.8 / r) ** 8 - (0.8 / r) ** 4))


def molecule_batch(seed: int, step: int, n_atoms: int, n_species: int = 4,
                   shard: int = 0, device: DeviceSpec = None) -> dict:
    """A random molecular configuration with an analytic target: positions
    normal times 2, uniform species, every ordered pair of distinct atoms
    an edge (the JAX package's meshgrid order), the Lennard-Jones-style
    ``energy`` and ``forces = -dE/dpos`` by autograd in f32."""
    dev = resolve_device(device)
    g = _generator(seed, step, shard, dev)
    pos = torch.randn((n_atoms, 3), generator=g, device=dev) * 2.0
    species = torch.randint(0, n_species, (n_atoms,), generator=g,
                            device=dev, dtype=torch.int32)
    es, ed = np.meshgrid(np.arange(n_atoms), np.arange(n_atoms))
    m = es != ed
    es = torch.from_numpy(es[m].astype(np.int32)).to(dev)
    ed = torch.from_numpy(ed[m].astype(np.int32)).to(dev)
    with torch.enable_grad():
        p = pos.detach().requires_grad_()
        energy = _lj_energy(p, es.long(), ed.long())
        (grad,) = torch.autograd.grad(energy, p)
    return {"positions": pos, "species": species, "edge_src": es,
            "edge_dst": ed, "energy": energy.detach(), "forces": -grad}


def node_classification_data(seed: int, n_nodes: int, d_feat: int,
                             n_classes: int, avg_degree: int = 8,
                             device: DeviceSpec = None) -> dict:
    """A synthetic homophilous graph for SAGE and GAT training, the JAX
    package's arrays bit for bit: class centres plus noise as features;
    ``n_nodes * avg_degree // 2`` edges from uniform sources, 70% of them
    to a uniform node of the source's class, the rest to a uniform node;
    self loops dropped, both directions kept.  Tensors on ``device``
    (features f32, the rest int32).

    The draws are the JAX function's, in its order; its per-edge loop over
    ``rng.integers(0, class size)`` is one call with an array of bounds,
    which numpy's generator answers with the same numbers."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n_nodes)
    centers = rng.standard_normal((n_classes, d_feat))
    feats = centers[labels] + 0.5 * rng.standard_normal((n_nodes, d_feat))
    # homophilous edges: mostly within class
    m = n_nodes * avg_degree // 2
    src = rng.integers(0, n_nodes, m)
    same = rng.random(m) < 0.7
    dst = np.where(same,
                   rng.permutation(n_nodes)[labels[src] * 0
                                            + rng.integers(0, n_nodes, m)],
                   rng.integers(0, n_nodes, m))
    # project dst to a node of the source's class where requested: the
    # class members in ascending order, as np.nonzero lists them
    by_class = np.argsort(labels, kind="stable")
    sizes = np.bincount(labels, minlength=n_classes)
    starts = np.cumsum(sizes) - sizes
    pick = rng.integers(0, sizes[labels[src]])
    dst = np.where(same, by_class[starts[labels[src]] + pick], dst)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    es = np.concatenate([src, dst]).astype(np.int32)
    ed = np.concatenate([dst, src]).astype(np.int32)
    return {"feats": torch.from_numpy(feats.astype(np.float32)).to(dev),
            "edge_src": torch.from_numpy(es).to(dev),
            "edge_dst": torch.from_numpy(ed).to(dev),
            "labels": torch.from_numpy(labels.astype(np.int32)).to(dev)}
