"""Sharding at world size 1: the port's partition rules against the
reference's, its mesh context, ``reshard_tree`` and the train step's mesh
branches.

The rules are pure functions of a leaf's path, its shape and a mesh's
axis names and sizes, so the specs are compared EXACTLY (the port's plain
tuples against ``tuple(PartitionSpec)``) for every leaf of the 12
configs' full-size parameter trees on the host mesh (1, 1) and the
production meshes (16, 16) and (2, 16, 16). Neither side allocates a full
tree: the reference's comes from ``jax.eval_shape(init_params)``, the
port's from its own ``init_params`` on ``torch.device("meta")`` (the
expert tables with the other leaves: the same shapes, no storage). On one
device every constraint is the identity; a larger mesh raises. A train
step under the host mesh is bitwise the step without a mesh.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from jax.tree_util import DictKey  # noqa: E402

import repro.config as jconfig  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.sharding import partition as jpart  # noqa: E402
from repro_torch import models  # noqa: E402
from repro_torch.checkpoint import reshard_tree  # noqa: E402
from repro_torch.config import (OptimizerConfig, ShapeConfig,  # noqa: E402
                                get_config, reduced)
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.launch.mesh import (make_host_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.optim import (AdamWState, init_opt_state,  # noqa: E402
                               make_train_step)
from repro_torch.sharding import (Mesh, batch_axes, constrain,  # noqa: E402
                                  constrain_sp, current_mesh, named,
                                  set_current_mesh, use_mesh)
from repro_torch.sharding.partition import (opt_state_spec,  # noqa: E402
                                            param_specs_for, spec_for)
from repro_torch.tree import leaves  # noqa: E402

torch.set_num_threads(2)


class _FakeMesh:
    """The reference's side of a mesh: its rules read only these."""

    def __init__(self, names, sizes):
        self.axis_names = names
        self.shape = dict(zip(names, sizes))


MESHES = {"1x1": (("data", "model"), (1, 1)),
          "16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}
PROD = _FakeMesh(*MESHES["16x16"])


def _spec(path_names, shape):
    return spec_for(path_names, shape, make_production_mesh())


# -- the rule cases of tests/test_sharding.py:26-58 ---------------------------

@pytest.mark.parametrize("names,shape,want", [
    (("scan", "s0", "attn", "wq"), (1, 512, 1024), P(None, None, "model")),
    (("scan", "s0", "attn", "wo"), (1, 1024, 512), P(None, "model", None)),
    (("scan", "s0", "ffn", "w1"), (1, 512, 2048), P(None, None, "model")),
    (("scan", "s0", "ffn", "w2"), (1, 2048, 512), P(None, "model", None)),
    (("scan", "s0", "moe", "w1"), (1, 128, 512, 768),
     P(None, "model", None, None)),
    (("scan", "s0", "moe", "w2"), (1, 128, 768, 512),
     P(None, "model", None, None)),
    (("scan", "s0", "moe", "router"), (1, 512, 128), P()),
    (("scan", "s0", "attn", "wq"), (1, 960, 1000), P()),
    (("embed",), (49152, 960), P("model", None)),
    (("scan", "s0", "mamba", "conv_w"), (1, 1024, 4), P(None, "model", None)),
    (("scan", "s0", "attn", "wk"), (1, 960, 320), P(None, None, "model")),
    (("scan", "s0", "ln1"), (1, 960), P())],
    ids=["wq", "wo", "ffn_w1", "ffn_w2", "moe_w1", "moe_w2", "router",
         "indivisible", "vocab", "conv", "kv", "norm"])
def test_spec_for_rule_cases(names, shape, want):
    got = _spec(names, shape)
    assert isinstance(got, tuple) and got == tuple(want)
    assert got == tuple(jpart.spec_for(tuple(DictKey(n) for n in names),
                                       shape, PROD))


def test_opt_state_spec_zero1_cases():
    mesh = make_production_mesh()
    sp = _spec(("embed",), (49152, 960))
    assert opt_state_spec(sp, (49152, 960), mesh) == ("model", "data")
    # nothing free and divisible -> unchanged
    assert opt_state_spec(("model", None), (49152, 15), mesh) == \
        ("model", None)
    # no data axis to add -> the spec itself
    assert opt_state_spec((), (64, 64), make_host_mesh("cpu")) == ()


# -- every leaf of every config's full-size tree ------------------------------

@pytest.fixture(scope="module")
def trees():
    """{arch: (reference leaf path -> shape, port params on meta)}."""
    out = {}
    for arch in jconfig.list_archs():
        shapes = jax.eval_shape(
            lambda k: jax_init_params(jconfig.get_config(arch), k),
            jax.random.PRNGKey(0))
        flat = {tuple(str(k.key) for k in path): leaf.shape
                for path, leaf in
                jax.tree_util.tree_flatten_with_path(shapes)[0]}
        out[arch] = (flat, models.init_params(
            get_config(arch), torch.Generator(), device="meta",
            host_experts=False))
    return out


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in _flat(sub, prefix + (k,)).items()}
    return {prefix: tree}


@pytest.mark.parametrize("mesh_id", list(MESHES))
def test_param_and_opt_state_specs_equal_reference(trees, mesh_id):
    names, sizes = MESHES[mesh_id]
    mesh, fake = Mesh(names, sizes), _FakeMesh(names, sizes)
    sharded = 0
    for arch, (jflat, tparams) in trees.items():
        tflat = _flat(param_specs_for(tparams, mesh))
        tshapes = {p: tuple(t.shape) for p, t in _flat(tparams).items()}
        assert set(tflat) == set(jflat), arch
        for path, shape in jflat.items():
            assert tshapes[path] == tuple(shape), (arch, path)
            want = jpart.spec_for(tuple(DictKey(n) for n in path), shape,
                                  fake)
            got = tflat[path]
            assert got == tuple(want), (arch, path)
            assert opt_state_spec(got, shape, mesh) == tuple(
                jpart.opt_state_spec(want, shape, fake)), (arch, path)
            sharded += got != ()
    print(f"\n{mesh_id}: {sharded} sharded leaves over "
          f"{sum(len(f) for f, _ in trees.values())}")
    assert (sharded == 0) == (mesh_id == "1x1")


# -- the context at size 1 and above ------------------------------------------

def test_meshes_describe_the_reference_meshes():
    host = make_host_mesh("cpu")
    assert (host.axis_names, host.axis_sizes, host.size) == \
        (("data", "model"), (1, 1), 1)
    prod = make_production_mesh()
    assert prod.shape == {"data": 16, "model": 16} and prod.size == 256
    pods = make_production_mesh(multi_pod=True)
    assert pods.axis_names == ("pod", "data", "model") and pods.size == 512
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_host_mesh()


def test_constraints_are_identities_at_size_one():
    x = torch.randn(2, 8, 4)
    assert current_mesh() is None
    assert constrain(x, "data", None, None) is x
    with use_mesh(make_host_mesh("cpu")) as mesh:
        assert current_mesh() is mesh
        assert constrain(x, ("pod", "data"), None, None) is x
        assert constrain_sp(x) is x
        assert batch_axes() == ("data",)
    assert current_mesh() is None
    with use_mesh(make_production_mesh(multi_pod=True)):
        assert batch_axes() == ("pod", "data")
        with pytest.raises(NotImplementedError, match="512 devices"):
            constrain(x, "data", None, None)
        with pytest.raises(NotImplementedError):
            constrain_sp(x)
    # axes the mesh lacks drop out, as in the reference's _filter_spec
    assert named(make_production_mesh(), ("pod", "data"), "model").spec == \
        (("data",), "model")
    set_current_mesh(None)


def test_reshard_tree_places_on_one_device_and_refuses_more(tmp_path):
    params = models.init_params(reduced(get_config("smollm-360m")),
                                torch.Generator().manual_seed(0), "cpu")
    opt = init_opt_state(params)
    mesh = make_host_mesh("cpu")
    specs = param_specs_for(params, mesh)
    tree = {"params": params, "opt": opt}
    host = {"params": {k: v for k, v in params.items()}, "opt": opt}
    ospecs = AdamWState((), specs, specs, specs)
    placed = reshard_tree(host, {"params": specs, "opt": ospecs}, mesh)
    assert isinstance(placed["opt"], AdamWState)
    for a, b in zip(leaves(placed), leaves(tree)):
        assert a.device == torch.device("cpu") and a.dtype == b.dtype
        assert torch.equal(a, b)
    arrays = reshard_tree({"w": np.arange(6.0).reshape(2, 3)},
                          {"w": ()}, mesh)
    assert torch.equal(arrays["w"], torch.arange(6.0,
                                                 dtype=torch.float64
                                                 ).reshape(2, 3))
    with pytest.raises(NotImplementedError, match="reshard_tree"):
        reshard_tree(host, {"params": specs, "opt": ospecs},
                     make_production_mesh())


# -- the train step's mesh branches -------------------------------------------

@pytest.mark.parametrize("arch", ["smollm-360m", "mixtral-8x7b"])
def test_train_step_under_host_mesh_is_bitwise_plain(arch):
    cfg = reduced(get_config(arch))
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    batch = {k: torch.as_tensor(v) for k, v in SyntheticLM(
        cfg, ShapeConfig("t", 64, 2, "train"), seed=0).batch(0).items()}
    outs = []
    for mesh in (None, make_host_mesh("cpu")):
        params = models.init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
        opt = init_opt_state(params)
        step = make_train_step(cfg, ocfg)
        if mesh is None:
            p, o, m = step(params, opt, batch)
        else:
            with use_mesh(mesh):
                p, o, m = step(params, opt, batch)
        outs.append((leaves(p), leaves(o), m))
    (p0, o0, m0), (p1, o1, m1) = outs
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for a, b in zip(p0 + o0, p1 + o1):
        assert torch.equal(a, b)
    params = models.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with use_mesh(make_production_mesh()):
        with pytest.raises(NotImplementedError, match="train_step"):
            make_train_step(cfg, ocfg)(params, init_opt_state(params), batch)
