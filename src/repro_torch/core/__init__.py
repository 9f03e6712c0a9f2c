"""The paper's contribution on one GPU: the host-side set-associative
expert cache and two-tier grouped execution with post-fetch and
speculative prefetch on a copy stream; the numpy cache twin, the router
traces and the simulator of the paper's offline analysis."""
from .cache import CacheState, access, access_ex, access_scan_reference, \
    init_cache_state, land, lookup, reserve, slot_id
from .collaborative import CopyStream, ExpertTiers, ProbeResult, \
    collaborative_moe, collaborative_moe_offloaded, \
    collaborative_moe_reference, commit, execute, init_tiers, prefetch, \
    probe
from .policies import FLAG_DEMAND, FLAG_PENDING, FLAG_SPEC, NumpyCache, \
    PolicySpec, policy_spec, random_policy_hit_probs
from .router_trace import TraceConfig, synthetic_trace, trace_stats

__all__ = ["CacheState", "access", "access_ex", "access_scan_reference",
           "init_cache_state", "land", "lookup", "reserve", "slot_id",
           "CopyStream", "ExpertTiers", "ProbeResult", "collaborative_moe",
           "collaborative_moe_offloaded", "collaborative_moe_reference",
           "commit", "execute", "init_tiers", "prefetch", "probe",
           "FLAG_DEMAND", "FLAG_PENDING", "FLAG_SPEC", "NumpyCache",
           "PolicySpec", "policy_spec", "random_policy_hit_probs",
           "TraceConfig", "synthetic_trace", "trace_stats"]
