"""Cells (counterpart of ``repro.launch.steps``): one (arch, shape) pair's
step function, the optimizer and memory policy it runs under, and its
parameter initialiser.

The LM cells: train (a step of ``loss_fn`` with microbatch gradient
accumulation and ``apply_updates``), prefill and decode; the GNN cells
(GAT, GraphSAGE, NequIP, EquiformerV2 at every GNN shape): train; the
recsys cells: train, serve and retrieval.  The JAX package's cells also
carry abstract input specs and shardings for its dry-run; the port runs on
one device and has neither (``mesh`` must be None: ROADMAP.md queue 1
keeps the mesh, sharding and dry-run launchers for last).

A train cell's ``fn(params, opt_state, batch)`` returns ``(params,
opt_state, loss)``, new tensors for the first two.  Its gradients come from
``torch.autograd.grad``; with ``n_micro > 1`` the batch is laid out
``[n_micro, B / n_micro, S]`` and the microbatches' gradients accumulate in
``acc_dtype`` (f32 for Qwen3-0.6B, whatever the parameters' dtype), then
are divided by ``n_micro``, as the JAX package's ``lax.scan`` does.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable

import torch

from repro_torch.configs.registry import ArchSpec, get_arch
from repro_torch.train.optimizer import OptConfig, apply_updates
from repro_torch.train.tree import leaves, tree_map


def opt_config_for(arch_id: str) -> OptConfig:
    """Optimizer memory policy per arch (the JAX package's)."""
    # grad_clip=0 on the giant configs: the global-norm pass materializes
    # fp32 copies of every stacked weight tensor
    if arch_id == "kimi-k2-1t-a32b":
        return OptConfig(factored=True, beta1=0.0, m_dtype="bfloat16",
                         scan_update=True, grad_clip=0.0)
    if arch_id in ("command-r-plus-104b", "yi-34b"):
        return OptConfig(factored=True, m_dtype="bfloat16",
                         scan_update=True, grad_clip=0.0)
    if arch_id in ("qwen3-0.6b", "deepseek-moe-16b"):
        return OptConfig(scan_update=True)
    return OptConfig()


# Train memory policy: (n_microbatches, ce_chunk, grad_accum_dtype), the
# JAX package's: boundary activations force gradient accumulation on the
# deep and wide configs; chunked CE removes the [B, S, V] logits temporary.
_TRAIN_POLICY = {
    "qwen3-0.6b": (4, 512, "float32"),
    "command-r-plus-104b": (16, 512, "bfloat16"),
    "yi-34b": (8, 512, "bfloat16"),
    "deepseek-moe-16b": (4, 512, "float32"),
    "kimi-k2-1t-a32b": (16, 512, "bfloat16"),
}


def train_policy_for(arch_id: str, optimized: bool = True):
    if not optimized:
        return (1, 0, "float32")
    return _TRAIN_POLICY.get(arch_id, (1, 0, "float32"))


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape_name: str
    kind: str                     # "train" | "prefill" | "decode" | ...
    fn: Callable                  # the step
    param_init: Callable | None = None   # (generator, device) -> params
    opt_cfg: Any = None
    n_micro: int = 1              # a train batch's leading microbatch axis
    cfg: Any = None               # the model config the step runs


def loss_and_grads(loss_fn: Callable, params, batch):
    """``(loss, grads)`` of ``loss_fn(params, batch)``, the gradients a
    tree like ``params`` in its dtypes (zeros for a leaf the loss does not
    reach), through ``torch.autograd.grad``."""
    with torch.enable_grad():
        tracked = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss = loss_fn(tracked, batch)
        grads = iter(torch.autograd.grad(loss, leaves(tracked),
                                         allow_unused=True))

    def grad_of(p):
        g = next(grads)
        return torch.zeros_like(p) if g is None else g

    return loss.detach(), tree_map(grad_of, tracked)


def _train_step(loss_fn: Callable, opt_cfg: OptConfig, n_micro: int,
                acc_dtype: str):
    def step(params, opt_state, batch):
        if n_micro <= 1:
            loss, grads = loss_and_grads(loss_fn, params, batch)
        else:
            acc_dt = getattr(torch, acc_dtype)
            loss = torch.zeros((), device=leaves(params)[0].device)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dt,
                                                   device=p.device), params)
            for i in range(n_micro):
                mbatch = {k: v[i] for k, v in batch.items()}
                l, g = loss_and_grads(loss_fn, params, mbatch)
                loss = loss + l
                tree_map(lambda a, b: a.add_(b.to(a.dtype)), grads, g)
                del g
            loss = loss / n_micro
            grads = tree_map(lambda a: a.div_(n_micro), grads)
        params, opt_state = apply_updates(params, grads, opt_state, opt_cfg)
        return params, opt_state, loss
    return step


# ---------------------------------------------------------------------------
# family: LM


def _lm_train_cell(arch: ArchSpec, shape_name: str, smoke: bool,
                   optimized: bool) -> Cell:
    from repro_torch.models import transformer as T
    cfg = arch.smoke if smoke else arch.config
    opt_cfg = opt_config_for(arch.arch_id)
    n_micro, ce_chunk, acc_dtype = train_policy_for(
        arch.arch_id, optimized=optimized and not smoke)
    if ce_chunk and not smoke:
        cfg = dataclasses.replace(cfg, ce_chunk=ce_chunk)
    return Cell(arch.arch_id, shape_name, "train",
                _train_step(partial(T.loss_fn, cfg), opt_cfg, n_micro,
                            acc_dtype),
                param_init=partial(T.init_params, cfg), opt_cfg=opt_cfg,
                n_micro=n_micro, cfg=cfg)


def _lm_prefill_cell(arch: ArchSpec, shape_name: str, smoke: bool,
                     optimized: bool) -> Cell:
    from repro_torch.models import transformer as T
    cfg = arch.smoke if smoke else arch.config
    # MoE prefill: chunked (Sarathi-style), so the dispatch buffers scale
    # with the chunk, not the prompt
    chunked = optimized and not smoke and cfg.moe is not None

    def step(params, batch_):
        if chunked:
            return T.prefill_chunked(cfg, params, batch_["tokens"],
                                     chunk=2048)
        return T.prefill(cfg, params, batch_["tokens"])

    return Cell(arch.arch_id, shape_name, "prefill", step,
                param_init=partial(T.init_params, cfg), cfg=cfg)


def _lm_decode_cell(arch: ArchSpec, shape_name: str, smoke: bool
                    ) -> Cell:
    from repro_torch.models import transformer as T
    cfg = arch.smoke if smoke else arch.config

    def step(params, cache_, batch_):
        return T.decode_step(cfg, params, cache_, batch_["tokens"],
                             batch_["pos"])

    return Cell(arch.arch_id, shape_name, "decode", step,
                param_init=partial(T.init_params, cfg), cfg=cfg)


# ---------------------------------------------------------------------------
# family: GNN


def gnn_d_feat(shape_name: str, shp: dict) -> int:
    """A GNN shape's node features, the JAX package's (``_gnn_sizes``):
    minibatch_lg's 602 (Reddit's), the shape's ``d_feat``, else 64."""
    if shape_name == "minibatch_lg":
        return 602
    if shape_name == "molecule":
        return 64
    return shp.get("d_feat", 64)


def _gnn_train_cell(arch: ArchSpec, shape_name: str, smoke: bool) -> Cell:
    """A GNN train step under ``OptConfig()``, no microbatches.  GAT and
    GraphSAGE at full size take the shape's ``d_feat`` as ``d_in``;
    GraphSAGE's ``minibatch_lg`` runs the sampled forward at the shape's
    fanouts."""
    from repro_torch.models.gnn import equiformer_v2, gat, graphsage, nequip
    cfg = arch.smoke if smoke else arch.config
    shp = arch.shapes[shape_name]
    if arch.arch_id in ("nequip", "equiformer-v2"):
        mod = nequip if arch.arch_id == "nequip" else equiformer_v2
    else:
        mod = graphsage if arch.arch_id == "graphsage-reddit" else gat
        if not smoke:
            cfg = dataclasses.replace(cfg, d_in=gnn_d_feat(shape_name, shp))
            if mod is graphsage and shape_name == "minibatch_lg":
                # the sampled path runs the shape's fanouts, not the arch's
                cfg = dataclasses.replace(cfg,
                                          sample_sizes=tuple(shp["fanout"]))
    opt_cfg = OptConfig()
    return Cell(arch.arch_id, shape_name, "train",
                _train_step(partial(mod.loss_fn, cfg), opt_cfg, 1, "float32"),
                param_init=partial(mod.init_params, cfg), opt_cfg=opt_cfg,
                cfg=cfg)


# ---------------------------------------------------------------------------
# family: recsys


def _recsys_cell(arch: ArchSpec, shape_name: str, kind: str, smoke: bool
                 ) -> Cell:
    from repro_torch.models.recsys import dien as DN
    cfg = arch.smoke if smoke else arch.config
    init = partial(DN.init_params, cfg)
    if kind == "retrieval":
        return Cell(arch.arch_id, shape_name, kind,
                    partial(DN.score_candidates, cfg), param_init=init,
                    cfg=cfg)
    if kind == "serve":
        def serve(params, batch_):
            with torch.inference_mode():
                return DN.forward(cfg, params, batch_)

        return Cell(arch.arch_id, shape_name, kind, serve, param_init=init,
                    cfg=cfg)
    opt_cfg = OptConfig()
    return Cell(arch.arch_id, shape_name, kind,
                _train_step(partial(DN.loss_fn, cfg), opt_cfg, 1, "float32"),
                param_init=init, opt_cfg=opt_cfg, cfg=cfg)


# ---------------------------------------------------------------------------


def build_cell(arch_id: str, shape_name: str, mesh=None,
               smoke: bool = False, optimized: bool = True) -> Cell:
    """The cell of ``arch_id`` at ``shape_name``, on the registry's
    config (SMOKE's with ``smoke``)."""
    if mesh is not None:
        raise NotImplementedError(
            "the port's cells run on one device; meshes and shardings are "
            "not ported yet (ROADMAP.md queue 1)")
    arch = get_arch(arch_id)
    kind = arch.shapes[shape_name]["kind"]
    if arch.family == "gnn":
        return _gnn_train_cell(arch, shape_name, smoke)
    if arch.family == "lm":
        if kind == "train":
            return _lm_train_cell(arch, shape_name, smoke, optimized)
        if kind == "prefill":
            return _lm_prefill_cell(arch, shape_name, smoke, optimized)
        return _lm_decode_cell(arch, shape_name, smoke)
    return _recsys_cell(arch, shape_name, kind, smoke)

