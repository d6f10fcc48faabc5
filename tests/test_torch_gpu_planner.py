"""PyTorch port on the card: the block queue's pinned, side-stream staging,
blocked and estimated runs on the ``cuda`` and ``cuda-1p`` backends against
the unblocked inspect run, and the estimator's probe launches against their
plain versions.

Every test here is marked ``gpu`` and skips without a CUDA device.  The
file imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest --noconftest -m gpu \
        tests/test_torch_gpu_planner.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (Miner, estimate_plan, make_cf_app,
                              make_fsm_app, make_mc_app, make_tc_app)
from repro_torch.core.blocks import BlockQueue, make_blocks
from repro_torch.core.plan import SAMPLE_CAND_CAP, bucket_pow2
from repro_torch.graph import generators as TG
from repro_torch.kernels.extend_fused import ops, ref

pytestmark = pytest.mark.gpu

APPS = {"tc": make_tc_app, "4-cf": lambda: make_cf_app(4),
        "3-mc": lambda: make_mc_app(3)}
PLAIN = {"extend_count": ref.extend_count_ref,
         "extend_scatter": ref.extend_scatter_ref,
         "extend_pruned_1p": ref.extend_pruned_1p_ref,
         "extend_edge": ref.extend_edge_ref}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _want(cols, blk, cap0):
    out = []
    for c in cols:
        w = np.zeros(cap0, dtype=c.dtype)
        w[:blk.n] = c[blk.lo:blk.lo + blk.n]
        out.append(w)
    return out


@pytest.mark.parametrize("delay", [0, 20_000_000])
def test_block_queue_stages_host_slices_and_zeros(cuda, delay):
    """Each staged column equals its host slice and zeros past it, read on
    the consumer's stream after a delay (so a buffer reused while the
    consumer still reads it would show) or at once on large blocks (so a
    read that did not wait on the copy would show)."""
    m, block, cap0 = 3_000_000, 700_000, 1 << 20
    if delay:
        m, block, cap0 = 100_000, 7_000, 8192
    rng = np.random.default_rng(0)
    cols = (rng.integers(1, 1 << 30, m).astype(np.int32),
            rng.integers(1, 1 << 30, m).astype(np.int32))
    blocks = make_blocks(m, block)
    q = BlockQueue(cols, blocks, cap0, device=cuda)
    assert all(c.is_pinned() for c in q.columns)
    got = []
    for blk, staged in q:
        if delay:
            torch.cuda._sleep(delay)
        got.append(tuple(c.clone() for c in staged))
        del staged
    torch.cuda.synchronize()
    assert len(got) == len(blocks)
    for blk, cols_got in zip(blocks, got):
        for g, w in zip(cols_got, _want(cols, blk, cap0)):
            assert np.array_equal(g.cpu().numpy(), w)
    assert q.stage_s > 0 and q.mine_s > 0


@pytest.mark.parametrize("backend", ["cuda", "cuda-1p"])
@pytest.mark.parametrize("aname", sorted(APPS))
def test_blocked_and_estimated_runs_equal_the_inspect_run(cuda, aname,
                                                          backend):
    g = TG.rmat(10, 16, seed=0, device=cuda)
    want = Miner(g, APPS[aname](), backend=backend).run()
    m0 = int(Miner(g, APPS[aname](), backend=backend,
                   device=cuda).init_edges()[0].shape[0])
    runs = ({"plan_source": "estimate"}, {"block_size": m0 // 5},
            {"block_size": m0 // 5, "plan_source": "estimate"},
            {"block_bytes": 1 << 20, "plan_source": "estimate"})
    for relabel in (False, True):
        for kw in runs:
            m = Miner(g, APPS[aname](), backend=backend, relabel=relabel)
            for _ in ("cold", "warm"):
                r = m.run(**kw)
                assert r.count == want.count, (relabel, kw)
                if want.p_map is not None:
                    assert np.array_equal(r.p_map, want.p_map), (relabel, kw)


def _record(monkeypatch, names):
    """Every call of the wrappers ``names`` in ``ops``: (name, args,
    kwargs, outputs cloned)."""
    calls = []
    for name in names:
        fn = getattr(ops, name)

        def run(*a, _fn=fn, _name=name, **kw):
            out = _fn(*a, **kw)
            outs = out if isinstance(out, tuple) else (out,)
            calls.append((_name, a, kw, tuple(o.clone() for o in outs)))
            return out
        monkeypatch.setattr(ops, name, run)
    return calls


@pytest.mark.parametrize("backend", ["cuda", "cuda-1p"])
@pytest.mark.parametrize("aname", ["tc", "4-cf", "3-mc", "3-fsm"])
def test_probe_launches_equal_their_plain_versions(cuda, monkeypatch,
                                                   aname, backend):
    if aname == "3-fsm":
        g = TG.rmat(12, 8, seed=0, labels=4, device=cuda)
        m = Miner(g, make_fsm_app(3, 500, max_patterns=64), backend=backend)
        cap0 = bucket_pow2(m.ctx.n_uedges)
        names = ("extend_edge",)
    else:
        g = TG.rmat(12, 16, seed=0, device=cuda)
        m = Miner(g, APPS[aname](), backend=backend)
        cap0 = bucket_pow2(int(m.init_edges()[0].shape[0]))
        names = (("extend_pruned_1p",) if backend == "cuda-1p"
                 else ("extend_count", "extend_scatter"))
    before = dict(ops.LAUNCHES)
    calls = _record(monkeypatch, names)
    caps, _ = estimate_plan(m, cap0)
    monkeypatch.undo()
    assert calls and {c[0] for c in calls} == set(names)
    assert all(kw["cand_cap"] == SAMPLE_CAND_CAP for _, _, kw, _ in calls)
    assert sum(ops.LAUNCHES[n] - before[n] for n in names) == len(calls)
    for name, a, kw, got in calls:
        want = PLAIN[name](*a, **kw)
        want = want if isinstance(want, tuple) else (want,)
        for x, y in zip(got, want):
            assert torch.equal(x.long(), y.long()), (name, kw["cand_cap"])
    assert len(caps) == (1 if aname in ("tc", "3-mc", "3-fsm") else 2)
