"""What the engine's per-layer phase readers share. A decode step is the
engine's ``dispatch`` span; inside it each layer's host phases
(``attn_route``, ``picks``, ``probe``, ``execute``, ``post_fetch`` and,
with prefetch, ``prefetch``) tile the layer, one span a phase a layer.

The readers split a card's time and copies between the host and the
device, so each reads only a run with a device trace. On the CPU the
phases time the compute itself and no copy crosses a bus: there each
returns None and its metric is left out, as the device's own readers'
are."""


def inside(steps, spans):
    """The sorted ``spans`` that lie inside one of the sorted, disjoint
    ``steps``."""
    out, i = [], 0
    for a, b in spans:
        while i < len(steps) and steps[i][1] < a:
            i += 1
        if i < len(steps) and steps[i][0] <= a and b <= steps[i][1]:
            out.append((a, b))
    return out


def overlap_ns(xs, ys):
    """The time two sorted lists of disjoint intervals share."""
    total, i, j = 0, 0, 0
    while i < len(xs) and j < len(ys):
        total += max(0, min(xs[i][1], ys[j][1]) - max(xs[i][0], ys[j][0]))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def step_ms(r, name):
    """The ``name`` spans' summed length a decode step, mean over the
    window's steps; None without a device trace or where no step holds
    one."""
    if r.device is None:
        return None
    steps = r.spans("engine", "dispatch")
    spans = inside(steps, r.spans("engine", name))
    return sum(b - a for a, b in spans) / len(steps) / 1e6 if spans \
        else None


def bytes_per_token_mb(r, counters):
    """The window's change in the summed ``EngineStats`` counters, in MB a
    decoded token; None without a device trace or where the program has
    no such counters."""
    if r.device is None:
        return None
    tok = r.delta("tokens")
    if tok <= 0 or not all(hasattr(r.stats1, k) for k in counters):
        return None
    return sum(r.delta(k) for k in counters) / 1e6 / tok
