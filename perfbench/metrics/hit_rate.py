"""Cache manager: decode accesses that hit, as a share of all decode
accesses of the window (``EngineStats.hits`` / ``accesses``)."""


def read(r):
    acc = r.delta("accesses")
    return 100.0 * r.delta("hits") / acc if acc > 0 else None
