# Pattern-query subsystem: specs, the host compiler, and enumeration (a
# copy of repro.core.patterns; the port imports nothing of the JAX package).
from repro_torch.core.patterns.spec import (MAX_PATTERN_SIZE,
                                            PATTERN_LIBRARY, PATTERN_SETS,
                                            Pattern,
                                            enumerate_connected_codes,
                                            motif_patterns,
                                            n_connected_patterns,
                                            named_pattern_set,
                                            pattern_names,
                                            pattern_set_names)
from repro_torch.core.patterns.compile import (MAX_SET_BRANCHES, GraphStats,
                                               LevelPlan, MatchingPlan,
                                               PatternSetPlan, SetBranch,
                                               compile_pattern,
                                               compile_pattern_set,
                                               graph_stats, matching_order,
                                               symmetry_break)
