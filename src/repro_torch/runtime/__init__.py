"""Runtime services of the port: wire compression, fault tolerance,
step monitoring and elastic scaling."""

from .compression import ErrorFeedback, dequantize, quantize
from .elastic import (
    choose_mesh_shape,
    make_elastic_mesh,
    reshard_state,
    scale_down_plan,
)
from .failure import (
    FaultInjector,
    LoopResult,
    SimulatedNodeFailure,
    SourceFailedError,
    resilient_loop,
)
from .monitor import Heartbeat, StepMonitor, StragglerEvent

__all__ = [
    "ErrorFeedback",
    "FaultInjector",
    "Heartbeat",
    "LoopResult",
    "SimulatedNodeFailure",
    "SourceFailedError",
    "StepMonitor",
    "StragglerEvent",
    "choose_mesh_shape",
    "dequantize",
    "make_elastic_mesh",
    "quantize",
    "reshard_state",
    "resilient_loop",
    "scale_down_plan",
]
