"""Cache manager: experts copied into the slot buffer a decoded token
(``EngineStats.fetched_experts`` / ``tokens`` over the window)."""


def read(r):
    tok = r.delta("tokens")
    return r.delta("fetched_experts") / tok if tok > 0 else None
