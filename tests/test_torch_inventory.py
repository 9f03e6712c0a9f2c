"""The port does all that the JAX package does: an inventory.

For every module of the reference package ``src/repro`` outside
``analysis/``, every public top-level name it defines (functions,
classes, constants) and every public method of its classes must have a
counterpart in ``src/repro_torch``: by default the same name in the
module of the same path; otherwise the counterpart named in
``COUNTERPART``; or an entry in ``NO_COUNTERPART`` with the reason. A
name the reference adds later fails here until the port answers for it,
and a table entry that names nothing of the reference fails too.
"""
import ast
import importlib
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
REF = SRC / "repro"

_JAX_KEYS = "derives jax.random keys, which torch cannot reproduce; the " \
    "port's per-request seeds go through serving/sampling.py::step_seed"
_INTERPRET = "the Pallas interpret-mode switch; the port's wrappers run " \
    "their plain versions for CPU tensors instead"
_TPU = "a TPU v5e roofline constant; the port's card numbers come from " \
    "chip_smoke.py's runs, and no TPU number goes into the port"

# whole reference modules with no counterpart
NO_COUNTERPART_MODULES = {
    "analysis": "reprolint, the repo's static analyzer of the JAX package "
                "(it scans src/repro, tests, benchmarks and tools)",
    "launch.dryrun": "lowers and compiles JAX programs for TPU meshes",
    "launch.hlo_analysis": "parses XLA's HLO text",
    "launch.specs": "builds JAX ShapeDtypeStructs for the dry run",
}

# reference "module::name" -> reason
NO_COUNTERPART = {
    "core.collaborative::memory_kinds":
        "places the host tier through JAX memory kinds; the port's "
        "pinned host memory is that tier",
    "core.collaborative::host_offload_supported":
        "asks the JAX backend for a host memory space (see memory_kinds)",
    "core.collaborative::offload_host_tier":
        "moves the tier into a JAX host memory space (see memory_kinds)",
    "core.costmodel::TPU_PEAK_FLOPS_BF16": _TPU,
    "core.costmodel::TPU_HBM_BW": _TPU,
    "core.costmodel::TPU_ICI_BW_PER_LINK": _TPU,
    "core.costmodel::TPU_HBM_BYTES": _TPU,
    "core.costmodel::TPU_PCIE_HOST_BW": _TPU,
    "kernels.decode_attention.ops::INTERPRET": _INTERPRET,
    "kernels.moe_gmm.ops::INTERPRET": _INTERPRET,
    "kernels.prefill_attention.ops::INTERPRET": _INTERPRET,
    "kernels.ssd_scan.ops::INTERPRET": _INTERPRET,
    "serving.sampling::fold_keys": _JAX_KEYS,
    "serving.sampling::request_key": _JAX_KEYS,
    "sharding.partition::abstractify":
        "builds JAX ShapeDtypeStructs with a NamedSharding; the port "
        "places nothing on a mesh of more than one device",
}

_DEC = "kernels.decode_attention.ops"
_PRE = "kernels.prefill_attention.ops"
_GMM = "kernels.moe_gmm.ops"
_SSD = "kernels.ssd_scan.ops"
# reference "module::name" -> port "module::name", where they differ
COUNTERPART = {
    # the Pallas kernels and their pure-JAX twins: the CUDA wrappers and
    # their plain versions
    "kernels.decode_attention.decode_attention::flash_decode":
        f"{_DEC}::flash_decode",
    "kernels.decode_attention.decode_attention::NEG_INF": f"{_DEC}::NEG_INF",
    "kernels.decode_attention.paged::paged_flash_decode":
        f"{_DEC}::paged_flash_decode",
    "kernels.decode_attention.paged::NEG_INF": f"{_DEC}::NEG_INF",
    "kernels.decode_attention.ops::decode_attention": f"{_DEC}::flash_decode",
    "kernels.decode_attention.ops::paged_decode_attention":
        f"{_DEC}::paged_flash_decode",
    "kernels.decode_attention.ref::decode_attention_ref":
        f"{_DEC}::flash_decode_plain",
    "kernels.decode_attention.ref::paged_gather": f"{_DEC}::paged_gather",
    # paged_gather returns each row's last valid position with its KV
    "kernels.decode_attention.ref::paged_lengths": f"{_DEC}::paged_gather",
    "kernels.decode_attention.ref::paged_decode_ref":
        f"{_DEC}::paged_flash_decode_plain",
    "kernels.moe_gmm.moe_gmm::gmm": f"{_GMM}::gmm",
    "kernels.moe_gmm.moe_gmm::swiglu_gmm": f"{_GMM}::swiglu_gmm",
    "kernels.moe_gmm.ref::gmm_ref": f"{_GMM}::gmm_plain",
    "kernels.moe_gmm.ref::swiglu_gmm_ref": f"{_GMM}::swiglu_gmm_plain",
    # moe_ffn runs the plain versions for CPU tensors
    "kernels.moe_gmm.ref::moe_ffn_ref": f"{_GMM}::moe_ffn",
    "kernels.prefill_attention.paged::paged_flash_prefill":
        f"{_PRE}::paged_flash_prefill",
    "kernels.prefill_attention.paged::NEG_INF": f"{_DEC}::NEG_INF",
    "kernels.prefill_attention.ops::paged_prefill_attention":
        f"{_PRE}::paged_flash_prefill",
    "kernels.prefill_attention.ref::prefill_attention_ref":
        f"{_PRE}::flash_scan",
    "kernels.prefill_attention.ref::paged_prefill_ref":
        f"{_PRE}::paged_flash_prefill_plain",
    "kernels.ssd_scan.ssd_scan::ssd_scan": f"{_SSD}::ssd_scan",
    "kernels.ssd_scan.ops::ssd_chunked_kernel": f"{_SSD}::ssd_scan",
    "kernels.ssd_scan.ref::ssd_chunk_ref": f"{_SSD}::ssd_scan_plain",
    "kernels.ssd_scan.ref::ssd_multi_chunk_ref": f"{_SSD}::ssd_scan_plain",
    # the per-module initializers: one init_params draws the whole tree
    "models.attention::attn_params": "models.transformer::attn_params",
    "models.attention::self_attention": "models.attention::prefill_attention",
    "models.layers::rmsnorm_params": "models.transformer::init_params",
    "models.layers::ffn_params": "models.transformer::ffn_params",
    "models.layers::embed_params": "models.transformer::init_params",
    "models.moe::moe_params": "models.transformer::init_params",
    # type aliases: declared where the port's modules use them
    "models.layers::Params": "models.attention::Params",
    "core.collaborative::Params": "serving.engine::Params",
}


def _reference_names():
    """[(module, name)] for every public top-level definition and public
    method of the reference package outside the excluded modules."""
    out = []
    for path in sorted(REF.rglob("*.py")):
        parts = path.relative_to(REF).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mod = ".".join(parts)
        if not mod or any(mod == m or mod.startswith(m + ".")
                          for m in NO_COUNTERPART_MODULES):
            continue
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                if node.name.startswith("_"):
                    continue
                out.append((mod, node.name))
                if isinstance(node, ast.ClassDef):
                    out += [(mod, f"{node.name}.{sub.name}")
                            for sub in node.body
                            if isinstance(sub, ast.FunctionDef)
                            and not sub.name.startswith("_")]
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                out += [(mod, t.id) for t in targets
                        if isinstance(t, ast.Name)
                        and not t.id.startswith("_")]
    return out


NAMES = _reference_names()


def _resolve(target: str):
    mod, name = target.split("::")
    obj = importlib.import_module(
        "repro_torch" + ("." + mod if mod else ""))
    for attr in name.split("."):
        obj = getattr(obj, attr)
    return obj


def test_inventory_covers_the_reference():
    assert len(NAMES) > 300
    assert {m for m, _ in NAMES} >= {"serving.engine", "core.simulator",
                                     "sharding.partition", "launch.mesh"}


MODULES = sorted({m for m, _ in NAMES})


@pytest.mark.parametrize("mod", MODULES)
def test_every_reference_name_has_a_counterpart(mod):
    missing = []
    for name in (n for m, n in NAMES if m == mod):
        key = f"{mod}::{name}"
        if key in NO_COUNTERPART:
            assert NO_COUNTERPART[key]
            continue
        target = COUNTERPART.get(key, key)
        try:
            _resolve(target)
        except (ImportError, AttributeError) as e:
            missing.append(f"{key} -> repro_torch {target} ({e})")
    assert not missing, (
        "no counterpart for: " + "; ".join(missing) + " (port it, or name "
        "its counterpart or its reason in this file's tables)")


def test_tables_name_only_reference_names():
    """Stale entries fail: every table key is a name of the reference."""
    keys = {f"{m}::{n}" for m, n in NAMES}
    assert set(COUNTERPART) <= keys, set(COUNTERPART) - keys
    assert set(NO_COUNTERPART) <= keys, set(NO_COUNTERPART) - keys
    for mod in NO_COUNTERPART_MODULES:
        assert (REF / mod.replace(".", "/")).with_suffix(".py").exists() \
            or (REF / mod.replace(".", "/")).is_dir(), mod
