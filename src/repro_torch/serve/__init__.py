"""The serving runtime of the port.

One engine protocol (``serve.runtime.EngineProtocol``) serves the four
reasoners: the staged NSAI ``ReasonEngine`` (``serve.reason``), the
deadline-batched ``FrontDoor`` admission layer over any set of them
(``serve.frontdoor``), ``deploy()``, the DSE-driven generator ->
architecture entry point (``serve.deploy``), and the overload control
plane (``serve.control`` / ``serve.slo``).  Exported under the
reference's names; ``ReplicaPool``, golden traces and the LM ``Engine``
are not ported yet (ROADMAP Queue 1).
"""

from repro_torch.serve.control import (ClassQueues, ControlConfig,
                                       ControlDecision, OverloadController,
                                       SHED_POLICIES, ShedRecord)
from repro_torch.serve.deploy import Budget, Deployment, Traffic, deploy
from repro_torch.serve.runtime import (EngineProtocol, GroupRecord,
                                       TRAFFIC_CLASSES, TrafficClass,
                                       resolve_models)
from repro_torch.serve.slo import (PRIORITIES, SLOEstimator, SLOTarget,
                                   slo_targets)

__all__ = [
    "Budget", "ClassQueues", "ControlConfig", "ControlDecision",
    "Deployment", "EngineProtocol", "GroupRecord", "OverloadController",
    "PRIORITIES", "SHED_POLICIES", "SLOEstimator", "SLOTarget",
    "ShedRecord", "TRAFFIC_CLASSES", "Traffic", "TrafficClass", "deploy",
    "resolve_models", "slo_targets",
]
