from .fault_tolerance import (FailureDetector, StragglerMonitor, TrainSupervisor)
from .elastic import ElasticPlan, plan_reshard

__all__ = ["FailureDetector", "StragglerMonitor", "TrainSupervisor",
           "ElasticPlan", "plan_reshard"]
