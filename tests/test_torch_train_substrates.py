"""The port's training substrates against the reference's, case by case
as ``tests/test_substrates.py``: the optimizer (one AdamW step, the
clip, the schedule, int8 compression), checkpoints (round trip,
atomicity, retention, the on-disk layout, and a checkpoint either package
writes restored by the other), the synthetic data pipeline (bit for bit,
sharded), fault tolerance and elastic planning, and the configs
(``param_count`` of every arch, full and reduced; the shape, optimizer
and runtime configs field for field).

Tolerances: the optimizer's fp32 state within 2^-20 of its largest value
(the two frameworks' ``cos``, ``pow`` and ``sqrt`` may differ in the last
place, and XLA may contract a product and a sum), its bf16 parameters
within one bf16 rounding of it; everything else exactly equal.
"""
import dataclasses
import json
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro import config as jconfig  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro import runtime as jruntime  # noqa: E402
from repro.config.registry import list_archs  # noqa: E402
from repro.data import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch import config as tconfig  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch import runtime as truntime  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

STATE_REL = 2 ** -20


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


# --- optimizer -----------------------------------------------------------

def test_adamw_decreases_quadratic():
    ocfg = tconfig.OptimizerConfig(lr=0.1, warmup_steps=0, total_steps=100,
                                   weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    opt = toptim.init_opt_state(params)
    for _ in range(60):
        g = {"w": 2 * params["w"]}
        params, opt = toptim.adamw_update(g, opt, params, ocfg)
    assert float(params["w"].abs().max()) < 0.3


def _tree(rng):
    """A small parameter tree with bf16 and fp32 leaves, as numpy."""
    bf16 = jnp.bfloat16
    return {"w": np.asarray(jnp.asarray(rng.standard_normal((8, 6)), bf16)),
            "ln": rng.standard_normal(6).astype(np.float32),
            "sub": {"b": np.asarray(jnp.asarray(
                rng.standard_normal((3, 4, 5)), bf16))}}


@pytest.mark.parametrize("compress", [False, True])
def test_adamw_steps_match_reference(compress):
    """Three steps on the same gradients (the clip, the optional int8
    round trip, the update): the step counter equal, moments and master
    within fp32 rounding, parameters within one bf16 rounding."""
    rng = np.random.default_rng(0)
    tree = _tree(rng)
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=0.5,
                compress_pod_grads=compress)
    jo = joptim.init_opt_state(jax.tree.map(jnp.asarray, tree))
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_numpy(tree, "cpu")
    to = toptim.init_opt_state(tp)
    for _ in range(3):
        g = jax.tree.map(lambda a: np.asarray(jnp.asarray(
            rng.standard_normal(a.shape), a.dtype)), tree)
        jg, jn = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                            ocfg["grad_clip"])
        jg = joptim.maybe_compress_grads(jg, jconfig.OptimizerConfig(**ocfg))
        jp, jo = joptim.adamw_update(jg, jo, jp,
                                     jconfig.OptimizerConfig(**ocfg))
        tg, tn = toptim.clip_by_global_norm(params_from_numpy(g, "cpu"),
                                            ocfg["grad_clip"])
        tg = toptim.maybe_compress_grads(tg, tconfig.OptimizerConfig(**ocfg))
        tp, to = toptim.adamw_update(tg, to, tp,
                                     tconfig.OptimizerConfig(**ocfg))
        assert abs(float(tn) - float(jn)) <= STATE_REL * float(jn)
    assert int(to.step) == int(jo.step) == 3
    for name, jt_, tt_ in (("mu", jo.mu, to.mu), ("nu", jo.nu, to.nu),
                           ("master", jo.master, to.master)):
        for k in ("w", "ln"):
            want, got = _np(jt_[k]), _np(tt_[k])
            err = np.abs(got - want).max() / np.abs(want).max()
            assert err <= STATE_REL, (name, k, err)
    for k in ("w", "ln"):
        want, got = _np(jp[k]), _np(tp[k])
        assert tp[k].dtype == params_from_numpy(tree, "cpu")[k].dtype
        assert np.abs(got - want).max() <= 2 ** -7 * np.abs(want).max()


def test_grad_clip_and_global_norm():
    g = {"a": torch.ones(10) * 3.0, "b": torch.ones(5) * 4.0}
    n = float(toptim.global_norm(g))
    assert n == pytest.approx(np.sqrt(10 * 9 + 5 * 16))
    clipped, _ = toptim.clip_by_global_norm(g, 1.0)
    assert float(toptim.global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)
    # a bf16 gradient stays bf16, its scale cast to bf16 first
    gb = {"a": torch.ones(4, dtype=torch.bfloat16) * 3.0}
    cb, _ = toptim.clip_by_global_norm(gb, 1.0)
    assert cb["a"].dtype == torch.bfloat16


def test_lr_schedule_warmup_and_decay():
    ocfg = tconfig.OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    lr = toptim.lr_schedule
    assert float(lr(ocfg, torch.tensor(0, dtype=torch.int32))) == 0.0
    assert float(lr(ocfg, torch.tensor(10))) == pytest.approx(1e-3)
    assert float(lr(ocfg, torch.tensor(100))) == pytest.approx(1e-4,
                                                               rel=0.01)
    steps = np.arange(0, 121, dtype=np.int32)
    got = lr(ocfg, torch.from_numpy(steps))
    want = joptim.lr_schedule(jconfig.OptimizerConfig(
        lr=1e-3, warmup_steps=10, total_steps=100), jnp.asarray(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=STATE_REL, atol=0)


def test_int8_compression_roundtrip_error_bounded():
    g = torch.randn((256, 64), generator=torch.Generator().manual_seed(0)) \
        * 0.01
    q, s = toptim.compress_int8(g)
    assert q.dtype == torch.int8
    back = toptim.decompress_int8(q, s)
    assert float((back - g).abs().max()) <= float(s) * 0.51 + 1e-9
    jq, js = joptim.compress_int8(jnp.asarray(g.numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)


# --- checkpoint ----------------------------------------------------------

def test_checkpoint_roundtrip_bf16(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
            "m": {"v": torch.ones(3) * 0.5},
            "step": torch.tensor(7, dtype=torch.int32)}
    tckpt.save_checkpoint(tmp_path, 7, tree)
    restored, step = tckpt.load_checkpoint(tmp_path, tree)
    assert step == 7
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"], tree["w"])
    assert int(restored["step"]) == 7


def test_checkpoint_manager_async_retention(tmp_path):
    mgr = tckpt.CheckpointManager(tmp_path, keep=2)
    tree = {"x": torch.zeros(4)}
    for s in (1, 2, 3):
        mgr.save(s, {"x": torch.full((4,), float(s))})
    mgr.wait()
    restored, step = mgr.restore(tree)
    assert step == 3 and float(restored["x"][0]) == 3.0
    kept = sorted(p.name for p in tmp_path.glob("step_*"))
    assert len(kept) == 2                      # retention enforced


def test_checkpoint_restore_waits_for_the_outstanding_save(tmp_path):
    """A restore right after an async save reads that save (the
    reference's restore does not wait, and may read an older one)."""
    mgr = tckpt.CheckpointManager(tmp_path, keep=3)
    mgr.save(0, {"x": torch.zeros(1 << 16)})
    mgr.save(5, {"x": torch.ones(1 << 16)})
    restored, step = mgr.restore({"x": torch.zeros(1 << 16)})
    assert step == 5 and float(restored["x"].min()) == 1.0


def test_checkpoint_atomic_no_partial_dirs(tmp_path):
    tckpt.save_checkpoint(tmp_path, 1, {"x": torch.zeros(2)})
    assert not list(tmp_path.glob("*.tmp"))


def _train_state(rng, tree):
    """A {params, opt} pair on both sides with the same values."""
    jp = jax.tree.map(jnp.asarray, tree)
    jo = joptim.init_opt_state(jp)
    jo = joptim.AdamWState(
        step=jnp.int32(4),
        mu=jax.tree.map(lambda a: jnp.asarray(
            rng.standard_normal(a.shape), jnp.float32), jo.mu),
        nu=jax.tree.map(lambda a: jnp.asarray(
            rng.random(a.shape), jnp.float32), jo.nu),
        master=jo.master)
    jstate = {"params": jp, "opt": jo}
    tp = params_from_numpy(tree, "cpu")
    tstate = {"params": tp, "opt": toptim.AdamWState(
        step=torch.tensor(4, dtype=torch.int32),
        mu=params_from_numpy(jax.tree.map(np.asarray, jo.mu), "cpu"),
        nu=params_from_numpy(jax.tree.map(np.asarray, jo.nu), "cpu"),
        master=params_from_numpy(jax.tree.map(np.asarray, jo.master),
                                 "cpu"))}
    return jstate, tstate


def _flat_np(tree):
    return [_np(x) for x in jax.tree_util.tree_leaves(tree)]


def test_checkpoint_layout_matches_reference(tmp_path):
    """The same state saved by both packages: the same files, the same
    ``leaf_i`` arrays in the same order (JAX's flatten order: dict keys
    sorted, AdamWState in field order), the same manifest leaves."""
    jstate, tstate = _train_state(np.random.default_rng(0),
                                  _tree(np.random.default_rng(1)))
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jckpt.save_checkpoint(jdir, 4, jstate)
    tckpt.save_checkpoint(tdir, 4, tstate)
    for d in (jdir, tdir):
        assert sorted(p.name for p in d.iterdir()) == ["step_00000004"]
        assert sorted(p.name for p in (d / "step_00000004").iterdir()) == \
            ["manifest.json", "shard_0.npz"]
    jz = np.load(jdir / "step_00000004" / "shard_0.npz")
    tz = np.load(tdir / "step_00000004" / "shard_0.npz")
    assert sorted(jz.files) == sorted(tz.files)
    for k in jz.files:
        assert jz[k].dtype == tz[k].dtype, k
        np.testing.assert_array_equal(jz[k], tz[k])
    jm = json.loads((jdir / "step_00000004" / "manifest.json").read_text())
    tm = json.loads((tdir / "step_00000004" / "manifest.json").read_text())
    assert jm["leaves"] == tm["leaves"]
    assert (jm["step"], jm["num_processes"]) == (tm["step"],
                                                tm["num_processes"])


def test_checkpoint_cross_load(tmp_path):
    """The reference writes and the port restores, and the other way
    round: every leaf equal, with the template's dtype."""
    rng = np.random.default_rng(2)
    jstate, tstate = _train_state(rng, _tree(rng))
    jckpt.save_checkpoint(tmp_path / "j", 4, jstate)
    tckpt.save_checkpoint(tmp_path / "t", 4, tstate)
    got, step = tckpt.load_checkpoint(tmp_path / "j", tstate)
    assert step == 4 and isinstance(got["opt"], toptim.AdamWState)
    for a, b in zip(leaves(got), leaves(tstate)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    back, step = jckpt.load_checkpoint(tmp_path / "t", jstate)
    assert step == 4
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jstate)):
        assert jnp.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(_np(a), _np(b))


# --- data pipeline -------------------------------------------------------

def test_data_deterministic_and_sharded():
    cfg = tconfig.reduced(tconfig.get_config("smollm-360m"))
    shape = tconfig.ShapeConfig("t", 64, 8, "train")
    a = SyntheticLM(cfg, shape, seed=1).batch(5)
    b = SyntheticLM(cfg, shape, seed=1).batch(5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = SyntheticLM(cfg, shape, seed=1).batch(6)
    assert not np.array_equal(a["tokens"], c["tokens"])
    s0 = SyntheticLM(cfg, shape, seed=1, num_shards=2, shard=0).batch(5)
    s1 = SyntheticLM(cfg, shape, seed=1, num_shards=2, shard=1).batch(5)
    assert s0["tokens"].shape[0] == 4
    assert not np.array_equal(s0["tokens"], s1["tokens"])
    assert (a["tokens"] >= 0).all() and (a["tokens"] < cfg.vocab_size).all()


@pytest.mark.parametrize("arch", ["smollm-360m", "seamless-m4t-large-v2",
                                  "qwen2-vl-7b"])
@pytest.mark.parametrize("shards", [(1, 0), (2, 1)])
def test_data_batches_equal_reference_bitwise(arch, shards):
    """Tokens and labels, the audio family's frames, the vlm family's
    patches and [3, B, S] positions: the same bits, dtypes and shapes."""
    n, k = shards
    shape = tconfig.ShapeConfig("t", 96, 4, "train")
    tcfg = tconfig.reduced(tconfig.get_config(arch))
    jcfg = jconfig.reduced(jconfig.get_config(arch))
    for seed, step in ((0, 0), (3, 17)):
        got = SyntheticLM(tcfg, shape, seed, n, k).batch(step)
        want = JaxSyntheticLM(jcfg, jconfig.ShapeConfig("t", 96, 4, "train"),
                              seed, n, k).batch(step)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key])


# --- configs -------------------------------------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_param_count_matches_reference(arch):
    full = tconfig.get_config(arch)
    jfull = jconfig.get_config(arch)
    for t, j in ((full, jfull),
                 (tconfig.reduced(full), jconfig.reduced(jfull))):
        for active in (False, True):
            assert t.param_count(active) == j.param_count(active)


def test_shape_optimizer_runtime_configs_match_reference():
    for name in ("ShapeConfig", "OptimizerConfig", "RuntimeConfig"):
        tf = [(f.name, f.default) for f in
              dataclasses.fields(getattr(tconfig, name))]
        jf = [(f.name, f.default) for f in
              dataclasses.fields(getattr(jconfig, name))]
        assert tf == jf, name
    assert {k: dataclasses.astuple(v) for k, v in tconfig.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in jconfig.SHAPES.items()}


# --- fault tolerance -----------------------------------------------------

def test_failure_detector():
    fd = truntime.FailureDetector(timeout_s=10)
    fd.beat(0, now=100.0)
    fd.beat(1, now=105.0)
    assert fd.dead_workers(now=112.0) == [0]
    assert fd.alive_workers(now=112.0) == [1]


def test_straggler_monitor_flags_outlier():
    sm = truntime.StragglerMonitor(k=3.0)
    for w in range(4):
        for _ in range(10):
            sm.record(w, 1.0 + 0.01 * w)
    for _ in range(10):
        sm.record(4, 5.0)
    assert sm.stragglers() == [4]


def _supervise(runtime, failure_at):
    log, saved = [], {}

    def step(state, i):
        log.append(i)
        return state + 1

    def save(i, state):
        saved["ckpt"] = (state, i)

    sup = runtime.TrainSupervisor(step, save, lambda: saved["ckpt"],
                                  ckpt_every=4, max_restarts=2)
    save(0, 0)
    state, end = sup.run(0, 0, 10, failure_at=failure_at)
    return state, end, sup.restarts, log


def test_supervisor_recovers_and_replays_exactly():
    state, end, restarts, log = _supervise(truntime, 6)
    assert state == 10 and end == 10 and restarts == 1
    # steps 4,5 replayed after the failure at 6, as the reference's
    assert log == [0, 1, 2, 3, 4, 5, 4, 5, 6, 7, 8, 9]
    for failure_at in (None, 0, 3, 9):
        assert _supervise(truntime, failure_at) == \
            _supervise(jruntime, failure_at)


def test_elastic_plan():
    p = truntime.plan_reshard(alive_chips=255, model=16, global_batch=256)
    assert p is not None and p.model == 16 and p.data == 8
    p2 = truntime.plan_reshard(alive_chips=255, model=16, global_batch=240)
    assert p2 is not None and p2.data == 15 and p2.chips <= 255
    assert truntime.plan_reshard(alive_chips=8, model=16) is None
    for chips, model, batch in ((255, 16, 256), (64, 8, 96), (7, 2, 6)):
        assert truntime.plan_reshard(chips, model, global_batch=batch) == \
            _same(jruntime.plan_reshard(chips, model, global_batch=batch))


def _same(plan):
    return None if plan is None else truntime.ElasticPlan(
        **dataclasses.asdict(plan))

