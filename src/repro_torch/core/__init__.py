"""The paper's contribution on one GPU: the host-side set-associative
expert cache and two-tier grouped execution with post-fetch and
speculative prefetch on a copy stream."""
from .cache import CacheState, access_ex, init_cache_state, land, lookup, \
    reserve, slot_id
from .collaborative import CopyStream, ExpertTiers, ProbeResult, \
    collaborative_moe, collaborative_moe_offloaded, commit, execute, \
    init_tiers, prefetch, probe
from .policies import FLAG_DEMAND, FLAG_PENDING, FLAG_SPEC, PolicySpec, \
    policy_spec

__all__ = ["CacheState", "access_ex", "init_cache_state", "land", "lookup",
           "reserve", "slot_id", "CopyStream", "ExpertTiers", "ProbeResult",
           "collaborative_moe", "collaborative_moe_offloaded", "commit",
           "execute", "init_tiers", "prefetch", "probe", "FLAG_DEMAND",
           "FLAG_PENDING", "FLAG_SPEC", "PolicySpec", "policy_spec"]
