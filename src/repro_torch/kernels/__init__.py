"""Hand-written Hopper kernels of the port, each beside its plain version.

``ALL`` names every kernel wrapper with its source and the TPU kernel it
replaces, for the launch counters and the on-card checks, and carries what
those checks need (:mod:`repro_torch.kernels.cases`): the shapes, an input
maker, the work the inputs need and an optional library yardstick.
"""
from . import cases
from .decode_attention import ops as _dec_ops
from .moe_gmm import ops as _moe_ops
from .prefill_attention import ops as _pre_ops
from .ssd_scan import ops as _ssd_ops

ALL = (
    dict(name="swiglu_gmm", wrapper=_moe_ops.swiglu_gmm,
         plain=_moe_ops.swiglu_gmm_plain, source=_moe_ops.SOURCE,
         replaces="src/repro/kernels/moe_gmm/moe_gmm.py:82",
         cases=cases.MOE_CASES, inputs=cases.swiglu_inputs,
         work=cases.swiglu_work, library=None),
    dict(name="gmm", wrapper=_moe_ops.gmm, plain=_moe_ops.gmm_plain,
         source=_moe_ops.SOURCE,
         replaces="src/repro/kernels/moe_gmm/moe_gmm.py:41",
         cases=cases.GMM_CASES, inputs=cases.gmm_inputs,
         work=cases.gmm_work, library=cases.gmm_library),
    dict(name="flash_decode", wrapper=_dec_ops.flash_decode,
         plain=_dec_ops.flash_decode_plain, source=_dec_ops.SOURCE,
         replaces="src/repro/kernels/decode_attention/decode_attention.py:69",
         cases=cases.FLASH_DECODE_CASES, inputs=cases.flash_decode_inputs,
         work=cases.flash_decode_work, library=cases.flash_decode_library),
    dict(name="paged_flash_decode", wrapper=_dec_ops.paged_flash_decode,
         plain=_dec_ops.paged_flash_decode_plain, source=_dec_ops.SOURCE,
         replaces="src/repro/kernels/decode_attention/paged.py:85",
         cases=cases.PAGED_DECODE_CASES,
         inputs=cases.paged_flash_decode_inputs,
         work=cases.paged_flash_decode_work, library=None),
    dict(name="paged_flash_prefill", wrapper=_pre_ops.paged_flash_prefill,
         plain=_pre_ops.paged_flash_prefill_plain, source=_pre_ops.SOURCE,
         replaces="src/repro/kernels/prefill_attention/paged.py:92",
         cases=cases.PAGED_PREFILL_CASES,
         inputs=cases.paged_flash_prefill_inputs,
         work=cases.paged_flash_prefill_work, library=None),
    dict(name="ssd_scan", wrapper=_ssd_ops.ssd_scan,
         plain=_ssd_ops.ssd_scan_plain, source=_ssd_ops.SOURCE,
         replaces="src/repro/kernels/ssd_scan/ssd_scan.py:66",
         cases=cases.SSD_CASES, inputs=cases.ssd_inputs,
         work=cases.ssd_work, library=None),
)


def reset_launches() -> None:
    for k in ALL:
        k["wrapper"].launches = 0


def launches() -> dict:
    return {k["name"]: k["wrapper"].launches for k in ALL}
