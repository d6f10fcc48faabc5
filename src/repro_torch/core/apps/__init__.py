from repro_torch.core.apps.cf import make_cf_app, make_cf_app_compiled
from repro_torch.core.apps.fsm import make_fsm_app
from repro_torch.core.apps.mc import make_mc_app, make_mc_set_app
from repro_torch.core.apps.psm import pattern_app, pattern_set_app
from repro_torch.core.apps.tc import make_tc_app, triangle_count_fused
