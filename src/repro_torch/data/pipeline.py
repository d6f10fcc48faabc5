"""Deterministic synthetic data (counterpart of ``repro.data.pipeline``).

A batch is a pure function of ``(seed, step, shard)``: a restarted or
resized job asking for step N gets the same batch.  The draws come from a
``torch.Generator`` seeded from that triple, so they follow the JAX
package's distributions and rules but not its bits.

Not ported yet (ROADMAP.md queue 1): the GNN batches.
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
