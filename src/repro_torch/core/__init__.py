"""D-Rex core: reliability model (§3.1), D-Rex SC and static EC (§4.4,
§5.2.1), scheduler registry, and the placement engine."""

from .reliability import (
    meets_target,
    min_parity_for_target,
    parity_frontier,
    ParityFrontier,
    poisson_binomial_cdf,
    pr_avail,
    pr_failure,
)
from .types import (
    ClusterView,
    DataItem,
    Decision,
    ECTimeModel,
    Placement,
    PlacementConstraints,
    StorageNode,
)
from .registry import (
    SchedulerCapabilities,
    SchedulerSpec,
    create_scheduler,
    find,
    get_spec,
    register_scheduler,
    register_scheduler_family,
    scheduler_capabilities,
    scheduler_names,
)
from .algorithms import (
    DRexSC,
    SCHEDULER_NAMES,
    Scheduler,
    StaticEC,
    saturation_score,
)
from .engine import BatchContext, PlacementEngine, PlacementRecord, batch_stats
from .repair import RepairPlan, RepairPlanner
from .shapes import compile_cache_stats

__all__ = [
    "pr_failure",
    "pr_avail",
    "poisson_binomial_cdf",
    "meets_target",
    "min_parity_for_target",
    "parity_frontier",
    "ParityFrontier",
    "StorageNode",
    "DataItem",
    "Placement",
    "PlacementConstraints",
    "ClusterView",
    "ECTimeModel",
    "Decision",
    "Scheduler",
    "DRexSC",
    "StaticEC",
    "saturation_score",
    "SCHEDULER_NAMES",
    "SchedulerCapabilities",
    "SchedulerSpec",
    "register_scheduler",
    "register_scheduler_family",
    "create_scheduler",
    "find",
    "get_spec",
    "scheduler_names",
    "scheduler_capabilities",
    "BatchContext",
    "PlacementEngine",
    "PlacementRecord",
    "RepairPlan",
    "RepairPlanner",
    "batch_stats",
    "compile_cache_stats",
]
