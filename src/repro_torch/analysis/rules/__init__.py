"""Built-in contract rules.  Importing this package registers them."""
from repro_torch.analysis.rules import (grid_contract, host_sync, obs_purity,
                                        plan_signature, predicate_purity)

__all__ = ["grid_contract", "host_sync", "obs_purity", "plan_signature",
           "predicate_purity"]
