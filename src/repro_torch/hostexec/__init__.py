"""The CPU miss lane: compute cache-miss experts on the host (the port's
counterpart of the reference's ``hostexec`` package).

  * :mod:`executor` — thread-pool SwiGLU FFN over the pinned host tier;
  * :mod:`policy`   — the paper's cost-model split (CPU compute against
    fetch + cache insert), compiled to a per-group-size decision table;
  * :mod:`dispatch` — the dispatcher stage of probe -> execute -> commit:
    partitions each step's groups into the card's lane and the CPU lane
    and merges their outputs.

Enabled by ``EngineConfig(host_compute=True, host_threads=...)``; counted
in ``EngineStats.cpu_expert_calls`` / ``cpu_tokens``.
"""
from .dispatch import dispatch_execute, dispatch_plan
from .executor import HostExpertExecutor, host_expert_ffn
from .policy import HostDispatchPolicy, timings_for

__all__ = ["dispatch_execute", "dispatch_plan", "HostExpertExecutor",
           "host_expert_ffn", "HostDispatchPolicy", "timings_for"]
