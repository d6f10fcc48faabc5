"""PyTorch port on the card: the MoE and DIEN serving paths, attention's
gradient and the training launcher against the same code on the CPU, on
the same weights and inputs.

Every test here is marked ``gpu`` and skips without a CUDA device.  The
file imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest --noconftest -m gpu \
        tests/test_torch_gpu_models.py
"""
import dataclasses

import pytest
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.kernels.flash_attention import grad as flash_grad
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import train
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.recsys import dien as D

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


@pytest.mark.parametrize("cf", [2.0, 0.5])
def test_apply_moe_on_the_card_equals_the_cpu_without_a_sync(cuda, cf):
    """f32: the dispatch integers equal, y within 1e-5, and no device
    sync in the whole call."""
    cfg = M.MoEConfig(n_routed=8, top_k=2, d_ff=32, n_shared=2,
                      capacity_factor=cf)
    g = torch.Generator().manual_seed(0)
    params = M.init_moe(64, cfg, torch.float32, g, torch.device("cpu"))
    x = torch.randn(96, 64, generator=g)
    want, want_aux = M.apply_moe(params, x, cfg)
    r_cpu = M.route(params, x, cfg)
    p, xc = _to(params, cuda), x.to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, aux = M.apply_moe(p, xc, cfg)
        r = M.route(p, xc, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for name in ("expert", "order", "slot", "keep"):
        assert torch.equal(getattr(r, name).cpu(), getattr(r_cpu, name)), name
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=0)
    torch.testing.assert_close(aux.cpu(), want_aux, atol=1e-6, rtol=0)


@pytest.mark.parametrize("arch_id", ["deepseek-moe-16b", "kimi-k2-1t-a32b"])
def test_moe_smoke_prefill_on_the_card_runs_k8(cuda, arch_id):
    """The SMOKE model's prefill on the card (head dim 16 padded to 32 for
    DeepSeek) launches the kernel once a layer and equals the CPU's on the
    same weights within 1e-4."""
    cfg = get_arch(arch_id).smoke
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 64),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32)
    want, _ = T.prefill(cfg, params, tokens)
    flash_ops.reset_counts()
    got, _ = T.prefill(cfg, _to(params, cuda), tokens.to(cuda))
    assert flash_ops.LAUNCHES["flash_attention"] == cfg.n_layers
    assert flash_ops.ref.attention_ref.calls == 0
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)


def test_dien_on_the_card_equals_the_cpu(cuda):
    cfg = dataclasses.replace(get_arch("dien").smoke, seq_len=20)
    params = D.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    g = torch.Generator().manual_seed(1)
    items = torch.randint(0, cfg.n_items, (33, cfg.seq_len + 1),
                          generator=g, dtype=torch.int32)
    batch = {"hist_items": items[:, 1:], "hist_cats": items[:, 1:] %
             cfg.n_cats, "target_item": items[:, 0],
             "target_cat": items[:, 0] % cfg.n_cats}
    cand = {"hist_items": items[:1, 1:], "hist_cats": items[:1, 1:] %
            cfg.n_cats, "cand_items": items[:, 0],
            "cand_cats": items[:, 0] % cfg.n_cats}
    p = _to(params, cuda)
    for fn, b in ((D.forward, batch), (D.score_candidates, cand)):
        want = fn(cfg, params, b)
        got = fn(cfg, p, _to(b, cuda))
        torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_function_on_the_card_equals_the_cpu(cuda, dtype, causal):
    """Forward on the kernel (once, no plain call), backward by
    ``attention_grad``, against the same Function on the CPU (its plain
    version): f32 within 1e-4, bf16 within bf16 rounding of the inputs'
    f32 grads."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g)
               for shape in ((2, 8, 96, 64), (2, 4, 128, 64),
                             (2, 4, 128, 64)))
    dout = torch.randn(q.shape, generator=g)

    def run(dev, dt):
        ts = [t.to(dev, dt).requires_grad_() for t in (q, k, v)]
        out = flash_grad.flash_attention(*ts, causal=causal)
        return (out, *torch.autograd.grad(out, ts, dout.to(dev, dt)))

    want = run("cpu", torch.float32)
    flash_ops.reset_counts()
    got = run(cuda, dtype)
    assert flash_ops.LAUNCHES["flash_attention"] == 1
    assert flash_ops.ref.attention_ref.calls == 0
    tol = (dict(atol=1e-4, rtol=1e-4) if dtype == torch.float32
           else dict(atol=5e-2, rtol=2e-2))
    for x, y in zip(got, want):
        assert x.dtype == dtype
        torch.testing.assert_close(x.float().cpu(), y, **tol)


def test_train_smoke_on_the_card(cuda):
    """``launch.train --smoke`` on the card (weights and batches from CUDA
    generators, so not the CPU run's): finite losses, the first near
    ln(vocab), the kernel once a layer a forward and no plain call, and a
    second run's losses within 1e-5 of the first."""
    import math
    args = ["--arch", "qwen3-0.6b", "--smoke", "--steps", "4", "--batch",
            "4", "--seq", "64"]
    flash_ops.reset_counts()
    stats: list = []
    got = train.main(args, stats=stats)
    cfg = get_arch("qwen3-0.6b").smoke
    assert flash_ops.LAUNCHES["flash_attention"] == 4 * cfg.n_layers
    assert flash_ops.ref.attention_ref.calls == 0
    assert all(math.isfinite(x) for x in got)
    assert abs(got[0] - math.log(cfg.vocab)) < 0.5
    assert all(s["peak_bytes"] > 0 for s in stats)
    again = train.main(args)
    torch.testing.assert_close(torch.tensor(again), torch.tensor(got),
                               atol=1e-5, rtol=0)


def test_segment_sum_on_the_card_runs_k7_with_its_derivatives(cuda):
    """``segment_sum`` on CUDA tensors launches the segment-sum kernel, in
    the forward and in the gradient of the gradient (the gradient itself
    is a gather), and gives the CPU's values, ids out of range dropped,
    with no plain call."""
    from repro_torch.kernels.segsum import ops as segsum_ops
    from repro_torch.sparse.ops import segment_sum
    g = torch.Generator().manual_seed(0)
    data = torch.randn(300, 3, 5, generator=g)
    ids = torch.randint(-2, 40, (300,), generator=g, dtype=torch.int32)
    w = torch.randn(37, 3, 5, generator=g)
    out = {}
    for dev in (torch.device("cpu"), cuda):
        segsum_ops.reset_counts()
        x = data.to(dev).requires_grad_()
        y = segment_sum(x, ids.to(dev), 37)
        loss = torch.sum(torch.sin(y) * w.to(dev))
        (gx,) = torch.autograd.grad(loss, x, create_graph=True)
        (ggx,) = torch.autograd.grad(torch.sum(gx ** 2), x)
        out[dev.type] = [t.detach().cpu() for t in (y, gx, ggx)]
        if dev.type == "cuda":
            assert segsum_ops.LAUNCHES["sorted_segment_sum"] == 2
            assert segsum_ops.ref.sorted_segment_sum_ref.calls == 0
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch_id,shape", [
    ("gat-cora", "full_graph_sm"), ("graphsage-reddit", "full_graph_sm"),
    ("nequip", "molecule"), ("equiformer-v2", "molecule")])
def test_gnn_smoke_step_on_the_card_equals_the_cpu(cuda, arch_id, shape):
    """One SMOKE train step through ``build_cell(...).fn`` on the card and
    on the CPU from the same weights and batch: the loss within 1e-5
    (relative), the parameters within 1e-5, as many kernel launches on the
    card as plain calls on the CPU, and none of those on the card."""
    from repro_torch.data.pipeline import (molecule_batch,
                                           node_classification_data)
    from repro_torch.kernels.segsum import ops as segsum_ops
    from repro_torch.launch import steps as S
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.tree import leaves
    cell = S.build_cell(arch_id, shape, smoke=True)
    cpu = torch.device("cpu")
    params = cell.param_init(torch.Generator().manual_seed(0), device=cpu)
    if shape == "molecule":
        batch = molecule_batch(0, 0, 10, device=cpu)
    else:
        batch = node_classification_data(0, 80, cell.cfg.d_in,
                                          cell.cfg.n_classes, device=cpu)
    out = {}
    for dev in (cpu, cuda):
        segsum_ops.reset_counts()
        p = _to(params, dev)
        new_p, _, loss = cell.fn(p, init_opt_state(p, cell.opt_cfg),
                                 _to(batch, dev))
        out[dev.type] = (float(loss), [t.cpu() for t in leaves(new_p)],
                         segsum_ops.LAUNCHES["sorted_segment_sum"],
                         segsum_ops.ref.sorted_segment_sum_ref.calls)
    (l_cpu, p_cpu, _, calls), (l_gpu, p_gpu, launches, plain) = \
        out["cpu"], out["cuda"]
    assert abs(l_gpu - l_cpu) <= 1e-5 * max(1.0, abs(l_cpu))
    for a, b in zip(p_gpu, p_cpu):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    assert launches == calls > 0 and plain == 0
