"""The paper's contribution on one GPU: the host-side set-associative
expert cache and two-tier grouped execution with post-fetch."""
from .cache import CacheState, access_ex, init_cache_state, land, lookup, \
    slot_id
from .collaborative import ExpertTiers, ProbeResult, collaborative_moe, \
    commit, execute, init_tiers, probe
from .policies import FLAG_DEMAND, FLAG_PENDING, FLAG_SPEC, PolicySpec, \
    policy_spec

__all__ = ["CacheState", "access_ex", "init_cache_state", "land", "lookup",
           "slot_id", "ExpertTiers", "ProbeResult", "collaborative_moe",
           "commit", "execute", "init_tiers", "probe", "FLAG_DEMAND",
           "FLAG_PENDING", "FLAG_SPEC", "PolicySpec", "policy_spec"]
