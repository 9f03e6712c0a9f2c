"""Mamba2 SSD chunked scan: the wrapper over the Hopper kernel and its plain
PyTorch version.

``ssd_scan`` replaces the JAX package's Pallas TPU kernel
(``src/repro/kernels/ssd_scan/ssd_scan.py``: ``ssd_scan`` /
``_ssd_kernel``) with the hand-written CUDA kernels in
``csrc/ssd_scan.cu``; that file's header gives the bound (bytes: x and y
dominate) and what the design does about it. The contract is the model
function's, ``src/repro/models/ssm.py::ssd_chunked``, in the model layout:
``a = -exp(A_log) * dt`` and ``xd = x * dt`` are formed in fp32 inside, the
chunk is ``Q = min(chunk, S)``, and the ragged tail behaves as the
reference's ``dt = 0`` padding.

The kernels are chunk-parallel: every chunk's own state and decay at once,
then a pass over the chunk states in chunk order (elementwise per state
cell), then every chunk's output from its incoming state. The products run
on bf16 tensor cores, an fp32 operand split into bf16 hi + lo.
``ssd_scan_chunked_plain`` is that algorithm in plain PyTorch, with the
same split, for the tests: no path calls it.

The wrapper runs the plain version only for tensors that lie on the CPU.
For a CUDA tensor it launches the kernels or raises: it never falls back. On
every device it refuses an input that requires grad
(:func:`repro_torch.kernels.guard.refuse_autograd`).
It counts one launch per call in ``ssd_scan.launches``, however many CUDA
kernels the call runs (three), and allocates y, h and one fp32 workspace
for the chunk states and decays.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.guard import refuse_autograd

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"

MAX_CHUNK = 256                       # the kernel's longest chunk
# (hp, ds) built: mamba2-370m's, its reduced config's, jamba's Mamba layers'
WIDTHS = ((64, 128), (32, 32), (64, 16))


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import build
    lib = build.load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_bf16.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i,
                                  i, p]
    lib.ssd_scan_bf16.restype = i
    return lib


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor,
                   h0: Optional[torch.Tensor] = None, chunk: int = 256
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A transcription of the reference's ``ssd_chunked``: pad the tail
    with dt = 0 steps, then one chunk at a time with its einsums, in fp32.

    x [B, S, nh, hp]; dt [B, S, nh] (post-softplus); A_log [nh];
    Bm/Cm [B, S, ds]; h0 [B, nh, ds, hp] or None.
    Returns (y [B, S, nh, hp] in x's dtype, h [B, nh, ds, hp] fp32)."""
    Bb, S, nh, hp = x.shape
    ds = Bm.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    a = -torch.exp(A_log.float()) * dt.float()            # [B, S', nh]
    xd = x.float() * dt.float()[..., None]                # [B, S', nh, hp]
    Bf, Cf = Bm.float(), Cm.float()
    h = (torch.zeros((Bb, nh, ds, hp), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    neg_inf = torch.tensor(float("-inf"), device=x.device)
    ys = []
    for c0 in range(0, S + pad, Q):
        sl = slice(c0, c0 + Q)
        a_c, x_c, B_c, C_c = a[:, sl], xd[:, sl], Bf[:, sl], Cf[:, sl]
        acs = torch.cumsum(a_c, dim=1)                     # [B, Q, nh]
        scores = torch.einsum("bqn,bkn->bqk", C_c, B_c)
        diff = acs[:, :, None, :] - acs[:, None, :, :]     # [B, Q, Q, nh]
        L = torch.exp(torch.where(mask[None, :, :, None], diff, neg_inf))
        y = torch.einsum("bqk,bqkh,bkhp->bqhp", scores, L, x_c)
        y = y + torch.einsum("bqn,bqh,bhnp->bqhp", C_c, torch.exp(acs), h)
        decay_end = torch.exp(acs[:, -1:, :] - acs)        # [B, Q, nh]
        s_c = torch.einsum("bkn,bkh,bkhp->bhnp", B_c, decay_end, x_c)
        h = torch.exp(acs[:, -1, :])[..., None, None] * h + s_c
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :S]
    return y.to(x.dtype), h


def _split(v: torch.Tensor) -> torch.Tensor:
    """v (fp32) as the kernels multiply it: bf16 hi + bf16 lo, summed back
    in fp32 (exact: lo holds the 8 bits after hi's)."""
    hi = v.to(torch.bfloat16).float()
    return hi + (v - hi).to(torch.bfloat16).float()


def ssd_scan_chunked_plain(x: torch.Tensor, dt: torch.Tensor,
                           A_log: torch.Tensor, Bm: torch.Tensor,
                           Cm: torch.Tensor,
                           h0: Optional[torch.Tensor] = None,
                           chunk: int = 256
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernels' chunk-parallel algorithm in plain PyTorch, with
    their precision scheme, for the tests (no path calls it):

    1. per chunk at once: acs (the chunk's own cumulative sum), the decay
       exp(acs_end) and the chunk's own state s_c = (B o w)^T x with w_k =
       exp(acs_end - acs_k) dt_k, the fp32 B o w split into bf16 hi + lo;
    2. in chunk order: h_c = exp(acs_end) h_{c-1} + s_c;
    3. per chunk at once: y = (C B^T o L o dt) x + exp(acs) C h_{c-1}, the
       fp32 operands (C B^T o L o dt, h_{c-1}) split into hi + lo; C B^T
       and x, C are exact in bf16.
    Same arguments and results as ``ssd_scan_plain``."""
    Bb, S, nh, hp = x.shape
    ds = Bm.shape[-1]
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    f = torch.float32

    def chunks(t):                     # [Bb, S, ...] -> [Bb, nc, Q, ...]
        t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape((Bb, nc, Q) + tuple(t.shape[2:]))
    xc, dtc = chunks(x.float()), chunks(dt.float())
    Bc, Cc = chunks(Bm.float()), chunks(Cm.float())
    acs = torch.cumsum(-torch.exp(A_log.float()) * dtc, dim=2)  # [b,c,Q,nh]
    end = acs[:, :, -1:]                                       # [b,c,1,nh]
    w = torch.exp(end - acs) * dtc                             # [b,c,Q,nh]
    bw = _split(Bc[..., None, :] * w[..., None])               # [b,c,Q,nh,ds]
    s = torch.einsum("bcknd,bcknp->bcndp", bw, xc)             # [b,c,nh,ds,hp]
    decay = torch.exp(end[:, :, 0])                            # [b,c,nh]
    h = (torch.zeros((Bb, nh, ds, hp), dtype=f, device=x.device)
         if h0 is None else h0.float())
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = decay[:, c, :, None, None] * h + s[:, c]
    h_in = torch.stack(h_in, dim=1)                            # [b,c,nh,ds,hp]
    cb = torch.einsum("bcqd,bckd->bcqk", Cc, Bc)               # exact products
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    diff = acs[:, :, :, None, :] - acs[:, :, None, :, :]       # [b,c,q,k,nh]
    g = cb[..., None] * torch.exp(diff) * dtc[:, :, None, :, :]
    g = _split(torch.where(mask[None, None, :, :, None], g, 0.0))
    y = torch.einsum("bcqkn,bcknp->bcqnp", g, xc)
    ch = torch.einsum("bcqd,bcndp->bcqnp", Cc, _split(h_in))
    y = y + torch.exp(acs)[..., None] * ch
    y = y.reshape(Bb, nc * Q, nh, hp)[:, :S]
    return y.to(x.dtype), h


def _check_cuda(x, dt, A_log, Bm, Cm, h0) -> None:
    """What the CUDA kernel takes: bf16 x/B/C, fp32 dt/A_log/h0, all
    contiguous on one CUDA device, x/B/C/h0 on 16-byte boundaries."""
    for t, want in ((x, torch.bfloat16), (Bm, torch.bfloat16),
                    (Cm, torch.bfloat16), (dt, torch.float32),
                    (A_log, torch.float32), (h0, torch.float32)):
        if t is None:
            continue
        if t.dtype != want:
            raise TypeError(f"ssd_scan: the CUDA kernel takes {want}, got "
                            f"{t.dtype}")
        if t.device != x.device:
            raise ValueError("ssd_scan: all tensors must be on one device")
        if not t.is_contiguous():
            raise ValueError("ssd_scan: the CUDA kernel takes contiguous "
                             "tensors")
    for t in (x, Bm, Cm, h0):
        if t is not None and t.data_ptr() % 16:
            raise ValueError("ssd_scan: tensor not on a 16-byte boundary")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor,
             h0: Optional[torch.Tensor] = None, chunk: int = 256
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, nh, hp] bf16; dt [B, S, nh] fp32; A_log [nh] fp32;
    Bm/Cm [B, S, ds] bf16; h0 [B, nh, ds, hp] fp32 or None
    -> (y [B, S, nh, hp] bf16, h [B, nh, ds, hp] fp32)."""
    refuse_autograd("ssd_scan", x, dt, A_log, Bm, Cm, h0)
    Bb, S, nh, hp = x.shape
    ds = Bm.shape[-1]
    if tuple(dt.shape) != (Bb, S, nh) or tuple(A_log.shape) != (nh,) \
            or tuple(Bm.shape) != (Bb, S, ds) or Cm.shape != Bm.shape \
            or (h0 is not None and tuple(h0.shape) != (Bb, nh, ds, hp)):
        raise ValueError(f"ssd_scan: shapes do not agree: x {tuple(x.shape)}"
                         f" dt {tuple(dt.shape)} A_log {tuple(A_log.shape)} "
                         f"B {tuple(Bm.shape)} C {tuple(Cm.shape)}")
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A_log, Bm, Cm, h0, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    _check_cuda(x, dt, A_log, Bm, Cm, h0)
    Q = min(chunk, S)
    if (hp, ds) not in WIDTHS or not 0 < Q <= MAX_CHUNK or Bb * nh == 0:
        raise ValueError(f"ssd_scan: the kernel is built for (hp, ds) in "
                         f"{WIDTHS}, chunks of 1 to {MAX_CHUNK} steps and a "
                         f"non-empty batch, got ({hp}, {ds}), {Q} and "
                         f"{Bb} x {nh} heads")
    y = torch.empty_like(x)
    h = torch.empty((Bb, nh, ds, hp), dtype=torch.float32, device=x.device)
    nc = -(-S // Q)
    # the chunk states [Bb, nc, nh, ds, hp], then the decays [Bb, nc, nh]
    ws = torch.empty(Bb * nc * nh * (ds * hp + 1), dtype=torch.float32,
                     device=x.device)
    err = _lib().ssd_scan_bf16(
        x.data_ptr(), dt.data_ptr(), A_log.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
        h.data_ptr(), ws.data_ptr(), Bb, S, nh, hp, ds, Q,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan: kernel launch failed with CUDA error "
                           f"{err}")
    ssd_scan.launches += 1
    return y, h


ssd_scan.launches = 0
