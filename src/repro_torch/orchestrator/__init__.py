from repro_torch.orchestrator.registry import ClientInfo, ResourceProfile, make_hybrid_fleet  # noqa: F401
from repro_torch.orchestrator.selection import AdaptiveSelection, RandomSelection, get_selection  # noqa: F401
from repro_torch.orchestrator.straggler import StragglerPolicy, apply_mitigation, simulate_round_times  # noqa: F401
from repro_torch.orchestrator.fault import FaultConfig, FaultInjector, equivalent_preempt_rate_per_min  # noqa: F401
from repro_torch.orchestrator.server import Orchestrator, RoundLog  # noqa: F401
from repro_torch.orchestrator.async_server import AsyncOrchestrator, CommitLog, PendingUpdate  # noqa: F401
from repro_torch.orchestrator.hierarchy import (  # noqa: F401
    Facility, FacilityResult, FacilityUpdate, HierarchicalOrchestrator,
    make_facilities, split_fleet,
)
from repro_torch.orchestrator.megafleet import (  # noqa: F401
    BatchedAsyncOrchestrator, CohortFleet, CohortSpec, make_mega_fleet,
)
from repro_torch.orchestrator.eventwindow import (  # noqa: F401
    BlockedGenerator, EventWindowOrchestrator, PendingStore,
)
