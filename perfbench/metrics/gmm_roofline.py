"""Kernels: the bound time of the window's ``swiglu_gmm`` and ``gmm`` calls
(from each call's shapes, ``perfbench.roofline``) over the device time of
their kernels in the profiler's trace, over the pairs of a call and its
kernel. Each kind's calls (the wrappers' records, with the host time of
the call) and kernels (``SWIGLU`` true or false in the kernel's template
arguments) are paired in launch order; a kernel that starts before the
call it would pair with was made belongs to no recorded call and is
skipped, and a call left without a kernel (the profiler may drop a
record) adds nothing. ``unmatched`` counts both."""
import re

from perfbench import roofline

KERNELS = ("gmm_tma_kernel", "gmm_scalar_kernel")
SWIGLU_ARG = re.compile(r"<\s*\d+\s*,\s*(true|false)\b")
KIND = {"true": "swiglu_gmm", "false": "gmm"}


def _shape(x, *ws):
    """(G, C, K, N) of x [G, C, K] and the first weight [G, K, N]."""
    G, C, K = x.shape
    return G, C, K, ws[0].shape[2]


# the calls the harness records for this reader: (kernel, G, C, K, N, ns)
ENTRY_POINTS = {"repro_torch.kernels.moe_gmm.ops": {"swiglu_gmm": _shape,
                                                    "gmm": _shape}}


def kind(kernel_name: str):
    m = SWIGLU_ARG.search(kernel_name)
    return KIND[m.group(1)] if m else None


def pairs(calls, kernels):
    """([(call, kernel)], unmatched): per kind, in launch order; a call's
    host time is its last item."""
    out, unmatched = [], 0
    for k in KIND.values():
        cs = sorted((c for c in calls if c[0] == k), key=lambda c: c[-1])
        ks = sorted((o for o in kernels if kind(o.name) == k),
                    key=lambda o: o.t0)
        i = j = 0
        while i < len(cs) and j < len(ks):
            if ks[j].t0 < cs[i][-1]:
                unmatched += 1
                j += 1
                continue
            out.append((cs[i], ks[j]))
            i += 1
            j += 1
        unmatched += (len(cs) - i) + (len(ks) - j)
    return out, unmatched


def read(r):
    calls = r.calls(*KIND.values())
    if r.device is None or not calls:
        return None
    ops = [o for o in r.device.within(r.t0_ns, r.t1_ns)
           if o.cat == "kernel" and any(k in o.name for k in KERNELS)]
    matched, _ = pairs(calls, ops)
    if not matched:
        return None
    bound = sum(roofline.bound_s(*roofline.WORK[c[0]](*c[1:5]))[0]
                for c, _ in matched)
    device = sum(o.t1 - o.t0 for _, o in matched) / 1e9
    return 100.0 * bound / device if device > 0 else None
