"""OSDP core: the planner (descriptions, cost model, search) without jax."""
from repro_torch.core.api import (  # noqa: F401
    dp_baseline, evaluate_plan, fsdp_baseline, osdp, search_hybrid,
    search_serve)
from repro_torch.core.cost_model import (  # noqa: F401
    DP, ZDP, ZDP_POD, CostEnv, Decision, OpCost, PlanCost, PlanEvaluator,
    op_cost, plan_cost, uniform_plan, zdp_extra_time, zdp_saving)
from repro_torch.core.descriptions import (  # noqa: F401
    ModelDescription, OperatorDesc, describe, sanity_check)
from repro_torch.core.hybrid import (  # noqa: F401
    Factorization, HybridPlan, factorizations, hybrid_step_time,
    pp_bubble_fraction, slice_description, stage_bounds,
    tp_activation_time)
from repro_torch.core.ilp import (  # noqa: F401
    HAVE_SCIPY_MILP, ILPSolve, solve_ilp)
from repro_torch.core.plan import Plan, make_plan  # noqa: F401
from repro_torch.core.search import (  # noqa: F401
    SearchResult, schedule, search_plan)
