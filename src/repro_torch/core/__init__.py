"""Pangolin core on PyTorch: the extend-reduce-filter engine."""
from repro_torch.core.api import (BranchSetSpec, CanonicalSpec, GraphCtx,
                                  MiningApp, PredicateSpec, make_ctx)
from repro_torch.core.engine import (Miner, MineResult, bounded_mine_edge,
                                     bounded_mine_vertex, mine_sharded,
                                     run_level_loop)
from repro_torch.core.plan import (HostCapPolicy, MiningExecutor, MiningPlan,
                                   PlanCache, PlanCapPolicy, estimate_plan,
                                   plan_signature, profile_distance,
                                   transfer_caps)
from repro_torch.core.phases import (PhaseBackend, available_backends,
                                     get_backend, register_backend)
from repro_torch.core.patterns import (GraphStats, Pattern, compile_pattern,
                                       compile_pattern_set, graph_stats,
                                       motif_patterns, n_connected_patterns,
                                       named_pattern_set, pattern_names,
                                       pattern_set_names)
from repro_torch.core.apps import (make_cf_app, make_cf_app_compiled,
                                   make_fsm_app, make_mc_app,
                                   make_mc_set_app, make_tc_app,
                                   pattern_app, pattern_set_app,
                                   triangle_count_fused)
