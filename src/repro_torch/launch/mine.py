"""Mining launcher — the paper's workload as a CLI (counterpart of
``repro.launch.mine``, with every one of its flags).

``python -m repro_torch.launch.mine --app 4-mc --graph rmat:10 [--block-size N |
--blocks K] [--plan-cache DIR] [--repeat R]`` runs TC / k-CF / k-MC /
k-FSM on a generated or named graph.  ``--plan-cache`` persists the
capacity plan so later invocations skip the inspection pass entirely
(plan-once / execute-many); ``--repeat`` reruns the mining to show the
warm plan replay (one device read a run); ``--blocks`` splits the level-0 worklist
into K edge blocks served by one compiled executor (``--blocks auto`` /
``--block-bytes`` sizes the blocks to a device-byte budget and streams
them through the double-buffered block scheduler); ``--relabel`` mines
the degree-ordered relabeling (same results, hot adjacency core packed).

Arbitrary patterns go through the pattern compiler: ``--pattern diamond``
(any library name; ``--pattern list`` prints them) or ``--pattern-edges
"0-1,1-2,0-2"`` compiles a matching order + symmetry-breaking kernel
predicates at plan time and mines the pattern with zero runtime
isomorphism tests.

Whole pattern *sets* go through the multi-pattern trie compiler:
``--patterns diamond,4-cycle,4-clique`` (comma-separated library names)
or ``--pattern-set motifs4`` (named sets; ``--pattern-set list`` prints
them) merges the matching orders into one common-prefix plan and counts
every pattern in a single fused traversal.

It mines on the CUDA device, and raises where there is none;
``--device cpu`` runs the kernels' plain PyTorch versions on the host.
``--trace`` / ``--metrics`` write :mod:`repro_torch.obs`'s Chrome trace
and metrics snapshot, in the JAX package's schema
(``python -m repro_torch.obs.validate TRACE.json METRICS.json`` checks
them).  :func:`main` returns the last run's ``MineResult``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

import torch

from repro_torch.core import (Miner, MineResult, Pattern, graph_stats,
                              make_cf_app, make_fsm_app, make_mc_app,
                              make_tc_app, pattern_app, pattern_set_app,
                              triangle_count_fused)
from repro_torch.core.patterns import (named_pattern_set, pattern_names,
                                       pattern_set_names)
from repro_torch.device import DeviceSpec, resolve_device
from repro_torch.graph import generators as G
from repro_torch.obs import metrics, report, trace


def load_graph(spec: str, labels: int | None = None,
               device: DeviceSpec = None):
    """The graph of a spec (``rmat:SCALE`` at edge factor 8, ``er:N,P``,
    ``clique:N``, ``fig2``), the JAX package's, on ``device``."""
    kind, _, arg = spec.partition(":")
    if kind == "rmat":
        return G.rmat(int(arg or 10), edge_factor=8, labels=labels,
                      device=device)
    if kind == "er":
        n, _, p = (arg or "200,0.1").partition(",")
        return G.erdos_renyi(int(n), float(p or 0.1), labels=labels,
                             device=device)
    if kind == "clique":
        return G.clique(int(arg or 8), device=device)
    if kind == "fig2":
        return G.paper_fig2_graph(device=device)
    raise SystemExit(f"unknown graph spec {spec}")


def make_app(name: str, minsup: int):
    kind, _, k = name.partition("-")
    if name == "tc":
        return make_tc_app()
    k_int = int(kind) if kind.isdigit() else 3
    family = k if kind.isdigit() else kind
    if family in ("cf", "clique"):
        return make_cf_app(k_int)
    if family in ("mc", "motif"):
        return make_mc_app(k_int)
    if family == "fsm":
        return make_fsm_app(k_int, min_support=minsup, max_patterns=256)
    raise SystemExit(f"unknown app {name} (tc, k-cf, k-mc, k-fsm)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--app", default="tc", help="tc | k-cf | k-mc | k-fsm")
    ap.add_argument("--pattern", default=None, metavar="NAME",
                    help="mine a compiled pattern from the library "
                         "(e.g. diamond, 5-clique; 'list' to print all); "
                         "overrides --app")
    ap.add_argument("--pattern-edges", default=None, metavar="EDGES",
                    help='mine a custom compiled pattern, e.g. '
                         '"0-1,1-2,0-2"; overrides --app')
    ap.add_argument("--patterns", default=None, metavar="A,B,C",
                    help="mine a whole pattern SET in one fused traversal "
                         "(comma-separated library names, e.g. "
                         "diamond,4-cycle); overrides --app")
    ap.add_argument("--pattern-set", default=None, metavar="NAME",
                    help="mine a named pattern set (e.g. motifs4; 'list' "
                         "to print all) via the multi-pattern trie; "
                         "overrides --app")
    ap.add_argument("--non-induced", action="store_true",
                    help="compiled patterns: count subgraph occurrences "
                         "(extra edges allowed) instead of vertex-induced "
                         "matches")
    ap.add_argument("--graph", default="rmat:10")
    ap.add_argument("--labels", type=int, default=None)
    ap.add_argument("--minsup", type=int, default=100)
    ap.add_argument("--block-size", type=int, default=None)
    ap.add_argument("--blocks", default=None, metavar="K|auto",
                    help="split the level-0 worklist into this many edge "
                         "blocks (alternative to --block-size); 'auto' "
                         "derives the block size from --block-bytes")
    ap.add_argument("--block-bytes", type=int, default=None, metavar="B",
                    help="device-byte budget for the streaming block "
                         "scheduler: the sampled estimator prices the "
                         "full-worklist plan and the largest block size "
                         "whose scaled plan fits is used (implies "
                         "--blocks auto)")
    ap.add_argument("--relabel", nargs="?", const="degree", default=None,
                    metavar="ORDER",
                    help="relabel the graph before mining (default order: "
                         "degree — hubs first, so the packed adjacency "
                         "core covers the hot rows and contiguous edge "
                         "blocks are locality-coherent); results are "
                         "bitwise identical to the unrelabeled run")
    ap.add_argument("--plan-cache", default=None, metavar="DIR",
                    help="persist/load capacity plans; a warm cache skips "
                         "the per-level inspection pass")
    ap.add_argument("--plan-cache-max", type=int, default=None, metavar="N",
                    help="cap the plan-cache directory at N entries "
                         "(LRU-by-mtime eviction)")
    ap.add_argument("--plan", default="inspect",
                    choices=("inspect", "estimate", "cache"),
                    help="cold-run planning: exact per-level inspection "
                         "(paper), sampled cardinality estimation, or "
                         "cache = profile-nearest cached plan with "
                         "estimation fallback")
    ap.add_argument("--safety-factor", type=float, default=2.0,
                    help="multiply estimated/transferred capacities by "
                         "this (higher = fewer overflow retries, more "
                         "memory)")
    ap.add_argument("--sample-size", type=int, default=256,
                    help="level-0 worklist sample drawn by --plan "
                         "estimate")
    ap.add_argument("--cost-model", action="store_true",
                    help="compiled patterns/sets: pick matching orders by "
                         "the input-aware cost model (degree/label "
                         "statistics of --graph) instead of structure "
                         "alone")
    ap.add_argument("--repeat", type=int, default=1,
                    help="run the mining N times (later runs reuse the "
                         "compiled plan executor)")
    ap.add_argument("--backend", default=None,
                    help="phase backend: cuda | cuda-1p | torch-ref | any "
                         "registered (default: the app's preference, "
                         "else cuda)")
    ap.add_argument("--fused-tc", action="store_true",
                    help="DAG+intersection fused triangle count")
    ap.add_argument("--stats", action="store_true",
                    help="collect per-level stats and print the "
                         "structured reporter table (level, candidates, "
                         "survivors, cap, utilization, time)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record host spans + plan-provenance events and "
                         "write Chrome trace-event JSON (open in "
                         "https://ui.perfetto.dev)")
    ap.add_argument("--trace-sync", action="store_true",
                    help="with --trace: wait for the card inside each "
                         "instrumented span so device phases are "
                         "attributed exactly (serialises the launches)")
    ap.add_argument("--metrics", nargs="?", const="-", default=None,
                    metavar="OUT",
                    help="dump the metrics registry after the run: no "
                         "argument / '-' prints the plain-text form, "
                         "OUT.json writes the JSON snapshot, any other "
                         "path the text form")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.trace:
        trace.enable(sync=args.trace_sync)

    if args.pattern == "list":
        print("[mine] pattern library:", ", ".join(pattern_names()))
        return
    if args.pattern_set == "list":
        print("[mine] pattern sets:", ", ".join(pattern_set_names()))
        return
    labels = args.labels or (3 if "fsm" in args.app else None)
    g = load_graph(args.graph, labels=labels, device=device)
    print(f"[mine] graph: {g.n_vertices} vertices, {g.n_edges // 2} edges")
    if args.fused_tc:
        t0 = time.time()
        n = triangle_count_fused(g)
        print(f"[mine] fused TC: {n} triangles in {time.time()-t0:.3f}s")
        return MineResult(count=n)
    set_names = None
    stats = graph_stats(g) if args.cost_model else None
    if args.patterns is not None or args.pattern_set is not None:
        pats = (named_pattern_set(args.pattern_set)
                if args.pattern_set is not None else
                tuple(Pattern.named(n) for n in args.patterns.split(",")
                      if n.strip()))
        app = pattern_set_app(pats, induced=not args.non_induced,
                              stats=stats)
        set_names = [p.name for p in pats]
        print(f"[mine] compiled pattern set ({len(pats)} patterns, "
              f"k={pats[0].k}, "
              f"{'induced' if not args.non_induced else 'non-induced'}): "
              f"one shared multi-pattern plan")
    elif args.pattern is not None or args.pattern_edges is not None:
        pat = (Pattern.named(args.pattern) if args.pattern is not None
               else Pattern.from_string(args.pattern_edges))
        app = pattern_app(pat, induced=not args.non_induced, stats=stats)
        print(f"[mine] compiled pattern {pat.name!r}: k={pat.k}, "
              f"{pat.n_edges} edges, "
              f"{'induced' if not args.non_induced else 'non-induced'}")
    else:
        app = make_app(args.app, args.minsup)
    from repro_torch.core import available_backends
    if args.backend is not None and args.backend not in available_backends():
        raise SystemExit(f"unknown backend {args.backend!r} "
                         f"(available: {', '.join(available_backends())})")
    miner = Miner(g, app, backend=args.backend,
                  relabel=args.relabel or False, device=device)
    if miner.relabeling is not None:
        hit = miner.pack_hit_rate()
        print(f"[mine] relabeled ({args.relabel} order)"
              + (f", pack hit-rate {hit:.4f}" if hit is not None else ""))
    block_size = args.block_size
    block_bytes = args.block_bytes
    if args.blocks and args.blocks != "auto":
        if app.kind == "edge":
            raise SystemExit("--blocks: FSM blocking is disabled "
                             "(global support sync); use mine_sharded")
        m = int(miner.init_edges()[0].shape[0])
        block_size = -(-m // int(args.blocks))
    if (args.blocks == "auto" or block_bytes) and app.kind == "edge":
        raise SystemExit("--block-bytes: FSM blocking is disabled "
                         "(global support sync); use mine_sharded")
    if args.blocks == "auto" and not block_bytes:
        block_bytes = 64 << 20
    plan_cache = args.plan_cache
    if plan_cache is not None and args.plan_cache_max is not None:
        from repro_torch.core import PlanCache
        plan_cache = PlanCache(plan_cache, max_entries=args.plan_cache_max)
    r = None
    for i in range(max(args.repeat, 1)):
        t0 = time.time()
        r = miner.run(block_size=block_size, block_bytes=block_bytes,
                      collect_stats=args.stats,
                      plan_cache=plan_cache, plan_source=args.plan,
                      safety_factor=args.safety_factor,
                      sample_size=args.sample_size)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.time() - t0
        if args.repeat > 1:
            print(f"[mine] run {i}: {dt:.3f}s")
    for line in report.plan_table(miner.plan_reports()).splitlines():
        print(f"[mine] {line}")
    peak = miner.peak_live_bytes()
    if peak is not None and (block_size or block_bytes):
        print(f"[mine] peak live bytes (analytic): {peak}")
    if app.kind == "edge":
        found = [(int(c), int(s)) for c, s in zip(r.codes, r.supports)
                 if c != np.iinfo(np.int32).max and s >= app.min_support]
        print(f"[mine] {app.name}: {len(found)} frequent patterns "
              f"(minsup {app.min_support}) in {dt:.3f}s")
        for code, sup in sorted(found, key=lambda t: -t[1])[:10]:
            print(f"        pattern {code:#010x}: support {sup}")
    elif r.p_map is not None:
        print(f"[mine] {app.name} pattern map in {dt:.3f}s:")
        if set_names is not None:
            names = set_names
        else:
            from repro_torch.core.pattern import MOTIF_NAMES
            names = MOTIF_NAMES.get(app.max_size,
                                    [str(i) for i in range(len(r.p_map))])
        for name, cnt in zip(names, r.p_map):
            print(f"        {name}: {int(cnt)}")
    else:
        print(f"[mine] {app.name}: count = {r.count} in {dt:.3f}s")
    if args.stats:
        print(report.level_table(r.stats))
    if args.trace:
        path = trace.save(args.trace)
        print(f"[mine] trace: {path} ({len(trace.get().events)} events; "
              f"open in https://ui.perfetto.dev)")
    if args.metrics is not None:
        out = metrics.dump(args.metrics)
        if args.metrics == "-":
            print("[mine] metrics:")
            print(out)
        else:
            print(f"[mine] metrics: {out}")
    return r


if __name__ == "__main__":
    main()
