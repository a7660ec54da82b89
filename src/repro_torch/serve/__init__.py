"""The serving runtime of the port.

One engine protocol (``serve.runtime.EngineProtocol``) serves the four
reasoners: the staged NSAI ``ReasonEngine`` (``serve.reason``), data-parallel
``ReplicaPool``\\ s of them (``serve.replica``), the deadline-batched
``FrontDoor`` admission layer over any set of them (``serve.frontdoor``),
``deploy()``, the DSE-driven generator -> architecture entry point, which
records the device's kernel ``LoweringPlan`` (``serve.deploy``),
golden-trace record/replay (``serve.trace``), the overload control plane
(``serve.control`` / ``serve.slo``) and the simulated engine of the
control-plane soak (``serve.sim``).  Exported under the reference's names.
The slot-pool LM ``Engine`` (``serve.engine``) serves on its own and
behind the front door, as its ``lm`` traffic class
(``serve.runtime.TRAFFIC_CLASSES``).
"""

from repro_torch.serve.control import (ClassQueues, ControlConfig,
                                       ControlDecision, OverloadController,
                                       SHED_POLICIES, ShedRecord)
from repro_torch.serve.deploy import Budget, Deployment, Traffic, deploy
from repro_torch.serve.replica import ReplicaPool
from repro_torch.serve.runtime import (EngineProtocol, GroupRecord,
                                       TRAFFIC_CLASSES, TrafficClass,
                                       resolve_models, work_units)
from repro_torch.serve.slo import (PRIORITIES, SLOEstimator, SLOTarget,
                                   slo_targets)
from repro_torch.serve.trace import (GoldenTrace, ReplayReport, TraceDiff,
                                     record)

__all__ = [
    "Budget", "ClassQueues", "ControlConfig", "ControlDecision",
    "Deployment", "EngineProtocol", "GoldenTrace", "GroupRecord",
    "OverloadController", "PRIORITIES", "ReplayReport", "ReplicaPool",
    "SHED_POLICIES", "SLOEstimator", "SLOTarget", "ShedRecord",
    "TRAFFIC_CLASSES", "TraceDiff", "Traffic", "TrafficClass", "deploy",
    "record", "resolve_models", "slo_targets", "work_units",
]
