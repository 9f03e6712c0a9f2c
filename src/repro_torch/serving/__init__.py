from .api import build
from .engine import CollaborativeEngine, EngineConfig, PrefillTicket
from .sampling import GREEDY, SamplingParams
from .scheduler import ContinuousBatchingScheduler, QueueFull, Request
from .stats import EngineStats, RunStats

__all__ = ["build", "CollaborativeEngine", "EngineConfig", "PrefillTicket",
           "ContinuousBatchingScheduler", "QueueFull", "Request",
           "SamplingParams", "GREEDY", "EngineStats", "RunStats"]
