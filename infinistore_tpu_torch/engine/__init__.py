from .connector import StoreConnector
from .engine import InferenceEngine, PartialPrefill, SequenceState
from .scheduler import Request, Scheduler
from .speculative import SpeculativeDecoder
from .stepprof import StepProfiler

__all__ = [
    "InferenceEngine", "PartialPrefill", "SequenceState", "Request",
    "Scheduler", "SpeculativeDecoder", "StepProfiler", "StoreConnector",
]
