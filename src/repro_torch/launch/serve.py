"""Serving launcher: prefill + batched greedy decode with a KV cache
(counterpart of ``repro.launch.serve``).

``python -m repro_torch.launch.serve --arch qwen3-0.6b --smoke --tokens 32
--device cpu`` runs prompt prefill then autoregressive decode, reporting
tokens/s.  Without ``--device`` it runs on the CUDA device, and raises
where there is none.  The recsys models are not ported yet (ROADMAP.md
queue 1).

Mining-as-a-service: ``python -m repro_torch.launch.serve --mine --graph
rmat:10 --queries tc,diamond,3-mc`` answers each query on the resident
graph, timing the first (cold) response and warm repeats.  ``--plan
estimate`` (the default in this mode) plans capacities from one small
sampled probe instead of the per-level inspection, and ``--plan cache``
first seeds a new graph from the profile-nearest cached plan (plan
transfer).  ``--trace`` and ``--metrics`` write :mod:`repro_torch.obs`'s
exports, as the mining CLI's do.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.registry import get_arch
from repro_torch.device import DeviceSpec, resolve_device
from repro_torch.obs import metrics, report, trace


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_lm(arch, smoke: bool, batch: int, prompt_len: int,
             gen_tokens: int, seed: int, device: DeviceSpec = None,
             prompt=None, stats: dict | None = None) -> torch.Tensor:
    """Prefill a prompt into a cache of ``prompt_len + gen_tokens``, then
    decode greedily; returns the ``[batch, gen_tokens]`` new tokens.

    The weights are ``init_params(cfg, torch.Generator(device)
    .manual_seed(seed))``; the prompt is drawn from that generator next,
    unless ``prompt`` (int ``[batch, prompt_len]``, a tensor or numpy
    array) is given.  ``stats``, when given, receives the prefill and
    decode wall times (each ending in a device sync) and the decoded token
    count.
    """
    from repro_torch.models import transformer as T
    cfg = arch.smoke if smoke else arch.config
    dev = resolve_device(device)
    if gen_tokens < 1:
        raise ValueError(f"gen_tokens={gen_tokens}; decode at least one")
    gen = torch.Generator(dev).manual_seed(seed)
    params = T.init_params(cfg, gen, device=dev)
    if prompt is None:
        prompt = torch.randint(0, cfg.vocab, (batch, prompt_len),
                               generator=gen, device=dev, dtype=torch.int32)
    else:
        prompt = torch.as_tensor(prompt, dtype=torch.int32, device=dev)
        if tuple(prompt.shape) != (batch, prompt_len):
            raise ValueError(f"prompt {tuple(prompt.shape)} is not "
                             f"{(batch, prompt_len)}")
    total = prompt_len + gen_tokens
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = T.prefill(cfg, params, prompt, cache_len=total)
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    out = [tok]
    t0 = time.perf_counter()
    for i in range(gen_tokens - 1):
        logits, cache = T.decode_step(cfg, params, cache, tok,
                                      prompt_len + i)
        tok = torch.argmax(logits[:, 0], -1)[:, None].to(torch.int32)
        out.append(tok)
    _sync(dev)
    dt = time.perf_counter() - t0
    toks = batch * (gen_tokens - 1)
    print(f"[serve] {arch.arch_id}: batch {batch}, prompt {prompt_len}, "
          f"decoded {toks} tokens in {dt:.2f}s "
          f"({toks / max(dt, 1e-9):.1f} tok/s)")
    if stats is not None:
        stats.update(prefill_s=prefill_s, decode_s=dt, decode_tokens=toks)
    return torch.cat(out, dim=1)


def serve_mine(args):
    """Answer mining queries on a resident graph; returns per-query dicts.

    Each query runs once cold (its plan) and ``--query-repeats`` warm
    repeats; the latencies feed the ``serve.first_ms`` and
    ``serve.warm_ms`` histograms, so the summary reports p50 and p99 over
    the whole query stream, and each response carries the executor's plan
    provenance (``plan_reports()``).  A query that is not an app name is
    compiled as a library pattern, its matching order picked from the
    resident graph's statistics.
    """
    from repro_torch.core import Miner, Pattern, graph_stats, pattern_app
    from repro_torch.launch.mine import load_graph, make_app

    dev = resolve_device(args.device)
    g = load_graph(args.graph, labels=args.labels, device=dev)
    stats = graph_stats(g)
    print(f"[serve] mining graph {args.graph}: {g.n_vertices} vertices, "
          f"{g.n_edges // 2} edges, plan={args.plan}")
    results = []
    first_h = metrics.histogram("serve.first_ms")
    warm_h = metrics.histogram("serve.warm_ms")
    for query in [q.strip() for q in args.queries.split(",") if q.strip()]:
        try:
            app = make_app(query, args.minsup)
        except SystemExit:
            app = pattern_app(Pattern.named(query), stats=stats)
        miner = Miner(g, app, device=dev)
        with trace.span("serve.query", cat="serve", query=query):
            t0 = time.time()
            r = miner.run(plan_source=args.plan,
                          plan_cache=args.plan_cache,
                          safety_factor=args.safety_factor)
            cold_ms = (time.time() - t0) * 1e3
            first_h.observe(cold_ms)
            warm_ms = []
            for _ in range(max(args.query_repeats, 1)):
                t0 = time.time()
                miner.run(plan_source=args.plan,
                          plan_cache=args.plan_cache,
                          safety_factor=args.safety_factor)
                w = (time.time() - t0) * 1e3
                warm_ms.append(w)
                warm_h.observe(w)
        rep = miner.plan_reports()
        source = rep[0]["source"] if rep else "?"
        replans = sum(x["replans"] for x in rep)
        print(f"[serve] query {query!r}: count={r.count} "
              f"first={cold_ms:.0f}ms "
              f"warm={min(warm_ms):.1f}ms x{len(warm_ms)} "
              f"plan={source} replans={replans}")
        results.append({"query": query, "result": r,
                        "first_ms": cold_ms, "warm_ms": warm_ms,
                        "plan_reports": rep})
    print("[serve] " + report.latency_summary("first", first_h))
    print("[serve] " + report.latency_summary("warm", warm_h))
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="model arch to serve (required unless --mine)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--mine", action="store_true",
                    help="serve mining queries on a resident graph "
                         "instead of a model")
    ap.add_argument("--graph", default="rmat:10",
                    help="mining mode: resident graph spec")
    ap.add_argument("--queries", default="tc",
                    help="mining mode: comma-separated app or pattern "
                         "names (tc, 3-mc, 4-cf, k-fsm, diamond, ...)")
    ap.add_argument("--plan", default="estimate",
                    choices=("inspect", "estimate", "cache"),
                    help="mining mode: cold-query planning strategy")
    ap.add_argument("--plan-cache", default=None, metavar="DIR",
                    help="mining mode: persistent plan cache (enables "
                         "plan transfer across graphs with --plan cache)")
    ap.add_argument("--safety-factor", type=float, default=2.0)
    ap.add_argument("--minsup", type=int, default=100)
    ap.add_argument("--labels", type=int, default=None)
    ap.add_argument("--query-repeats", type=int, default=1,
                    help="mining mode: warm repeats per query (feeds the "
                         "serve.warm_ms latency histogram)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record host spans + plan events; write Chrome "
                         "trace-event JSON (open in ui.perfetto.dev)")
    ap.add_argument("--trace-sync", action="store_true",
                    help="with --trace: exact device attribution "
                         "(serialises the launches)")
    ap.add_argument("--metrics", nargs="?", const="-", default=None,
                    metavar="OUT",
                    help="dump the metrics registry after serving "
                         "('-'/no arg = text to stdout, *.json = JSON "
                         "snapshot) — the /metrics endpoint shape")
    args = ap.parse_args(argv)
    if args.trace:
        trace.enable(sync=args.trace_sync)
    if args.mine:
        results = serve_mine(args)
        if args.trace:
            print(f"[serve] trace: {trace.save(args.trace)}")
        if args.metrics is not None:
            out = metrics.dump(args.metrics)
            print("[serve] metrics:" + ("\n" + out if args.metrics == "-"
                                        else " " + out))
        return results
    if args.arch is None:
        raise SystemExit("--arch is required (or pass --mine)")
    arch = get_arch(args.arch)
    if arch.family == "lm":
        return serve_lm(arch, args.smoke, args.batch, args.prompt_len,
                        args.tokens, args.seed, device=args.device)
    if arch.family == "recsys":
        raise NotImplementedError("recsys serving is not ported yet "
                                  "(ROADMAP.md queue 1, the ML stack)")
    raise SystemExit("serving applies to lm/recsys archs")


if __name__ == "__main__":
    main()
