"""DIEN — Deep Interest Evolution Network (arXiv:1809.03672), the serving
half of ``repro.models.recsys.dien``.

Interest extractor: a GRU over the user's behaviour sequence (item and
category embeddings).  Interest evolution: AUGRU, a GRU whose update gate
is scaled by the attention score of each extractor state against the
target item.  JAX's ``lax.scan`` over the sequence is a Python loop here;
f32 products follow torch's default (TF32 off).  ``user_state``,
``forward`` and ``loss_fn`` (the click BCE) carry gradients;
``score_candidates`` scores one user against N candidates with the first
MLP layer factored, as the JAX package does, under
``torch.inference_mode()``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import DeviceSpec, resolve_device
from repro_torch.models.layers import dense_init


@dataclasses.dataclass(frozen=True)
class DIENConfig:
    name: str
    embed_dim: int = 18
    seq_len: int = 100
    gru_dim: int = 108
    mlp: tuple[int, ...] = (200, 80)
    n_items: int = 200_000
    n_cats: int = 2_000
    dtype: str = "float32"

    @property
    def d_behavior(self) -> int:
        return 2 * self.embed_dim          # item ‖ category


def _gru_init(d_in, d_h, dt, generator, dev) -> dict:
    p = {name: dense_init(d_in + d_h, d_h, dt, generator, dev)
         for name in ("wz", "wr", "wh")}
    p.update({name: torch.zeros((d_h,), dtype=dt, device=dev)
              for name in ("bz", "br", "bh")})
    return p


def init_params(cfg: DIENConfig, generator: torch.Generator,
                device: DeviceSpec = None) -> dict:
    """Random weights as the JAX package draws them (normal times the same
    scales, zero biases), from ``generator``, on ``device``.  ``mlp`` is a
    list of ``{"w", "b"}`` layers, the last of width 1."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    d_b, d_h = cfg.d_behavior, cfg.gru_dim

    def table(rows):
        x = torch.randn((rows, cfg.embed_dim), generator=generator,
                        device=generator.device)
        return (x * 0.05).to(device=dev, dtype=dt)

    params = {"item_emb": table(cfg.n_items), "cat_emb": table(cfg.n_cats),
              "gru": _gru_init(d_b, d_h, dt, generator, dev),
              "augru": _gru_init(d_b, d_h, dt, generator, dev),
              "attn_w": dense_init(d_h, d_b, dt, generator, dev)}
    mlp, d_prev = [], d_h + d_b + d_b  # final state ‖ target ‖ sum-pooled
    for d in cfg.mlp + (1,):
        mlp.append({"w": dense_init(d_prev, d, dt, generator, dev),
                    "b": torch.zeros((d,), dtype=dt, device=dev)})
        d_prev = d
    params["mlp"] = mlp
    return params


def _gru_cell(p, x, h):
    xh = torch.cat([x, h], dim=-1)
    z = torch.sigmoid(xh @ p["wz"] + p["bz"])
    r = torch.sigmoid(xh @ p["wr"] + p["br"])
    xrh = torch.cat([x, r * h], dim=-1)
    hh = torch.tanh(xrh @ p["wh"] + p["bh"])
    return (1 - z) * h + z * hh


def _augru_cell(p, x, h, att):
    """AUGRU: the attention score scales the update gate."""
    xh = torch.cat([x, h], dim=-1)
    z = torch.sigmoid(xh @ p["wz"] + p["bz"]) * att[:, None]
    r = torch.sigmoid(xh @ p["wr"] + p["br"])
    xrh = torch.cat([x, r * h], dim=-1)
    hh = torch.tanh(xrh @ p["wh"] + p["bh"])
    return (1 - z) * h + z * hh


def _behavior_embed(params, items, cats):
    return torch.cat([params["item_emb"][items], params["cat_emb"][cats]],
                     dim=-1)


def _extract(params, eb, d_h: int, states: bool):
    """The extractor GRU over eb [B, T, d_b] from zeros: its last state
    [B, d_h] and, with ``states``, every state [B, T, d_h] (written in
    place, or stacked while grad is enabled)."""
    b, t, _ = eb.shape
    h = eb.new_zeros((b, d_h))
    grad = torch.is_grad_enabled()
    hs = eb.new_empty((b, t, d_h)) if states and not grad else None
    kept = []
    for i in range(t):
        h = _gru_cell(params["gru"], eb[:, i], h)
        if states and grad:
            kept.append(h)
        elif states:
            hs[:, i] = h
    if kept:
        hs = torch.stack(kept, dim=1)
    return h, hs


def user_state(cfg: DIENConfig, params, batch):
    """Extractor GRU then evolution AUGRU: ([B, d_h + d_b] state, the
    target's [B, d_b] embedding).

    batch: ``hist_items`` / ``hist_cats`` int [B, T], ``target_item`` /
    ``target_cat`` int [B].
    """
    eb = _behavior_embed(params, batch["hist_items"], batch["hist_cats"])
    tgt = _behavior_embed(params, batch["target_item"], batch["target_cat"])
    _, hs = _extract(params, eb, cfg.gru_dim, states=True)
    # attention of each interest state against the target item
    att_logits = torch.einsum("btd,bd->bt", hs @ params["attn_w"], tgt)
    att = torch.softmax(att_logits, dim=-1)
    del hs, att_logits      # 11.3 GB at 262,144 requests, before the AUGRU
    h = eb.new_zeros((eb.shape[0], cfg.gru_dim))
    for i in range(eb.shape[1]):
        h = _augru_cell(params["augru"], eb[:, i], h, att[:, i])
    return torch.cat([h, eb.mean(dim=1)], dim=-1), tgt


def _mlp(layers, x):
    for i, lp in enumerate(layers):
        x = x @ lp["w"] + lp["b"]
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x[:, 0]


def forward(cfg: DIENConfig, params, batch) -> torch.Tensor:
    """The CTR logit of each request: [B]."""
    state, tgt = user_state(cfg, params, batch)
    return _mlp(params["mlp"], torch.cat([state, tgt], dim=-1))


def loss_fn(cfg: DIENConfig, params, batch) -> torch.Tensor:
    """Mean BCE of the logits against ``batch["label"]``, in the stable
    form max(x, 0) - x y + log1p(exp(-|x|))."""
    logit = forward(cfg, params, batch)
    y = batch["label"].to(torch.float32)
    return torch.mean(torch.clamp_min(logit, 0) - logit * y
                      + torch.log1p(torch.exp(-torch.abs(logit))))


@torch.inference_mode()
def score_candidates(cfg: DIENConfig, params, batch) -> torch.Tensor:
    """retrieval_cand: one user against N candidates, [N] logits.

    batch: ``hist_items`` / ``hist_cats`` int [1, T]; ``cand_items`` /
    ``cand_cats`` int [N].  Retrieval has no target, so the user is the
    extractor's last state and the mean history (no AUGRU), and the first
    MLP layer is factored into the user's part, computed once, and one
    [N, d_b] product for the candidates.
    """
    eb = _behavior_embed(params, batch["hist_items"], batch["hist_cats"])
    h_last, _ = _extract(params, eb, cfg.gru_dim, states=False)
    user = torch.cat([h_last, eb.mean(dim=1)], dim=-1)[0]     # [d_h + d_b]
    cand = _behavior_embed(params, batch["cand_items"], batch["cand_cats"])
    w0, b0 = params["mlp"][0]["w"], params["mlp"][0]["b"]
    d_u = user.shape[0]
    x = torch.relu((user @ w0[:d_u])[None, :] + cand @ w0[d_u:] + b0)
    return _mlp(params["mlp"][1:], x)
