"""The port's schedule and optimizer against the JAX package's.

Parameters are conv, dense (one with a single output), depthwise, deconv
and bias leaves, made in flax layouts with numpy and carried to torch
layouts by the weight bridge, so gradient centralization is checked on
every layout.  Bars: the schedule to rtol 1e-6 (both f32); Ranger against
the numpy reference of ``tests/test_train.py`` at its own bar (rtol 1e-4,
atol 1e-6); the wrapped optimizer (clip, finite guard, accumulation,
schedule) against JAX's ``make_optimizer`` to atol 1e-6 on parameters of
unit scale (f32 against f32; the RAdam scalars may differ by an ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from givepose_tpu.core.config import Config as JaxConfig
from givepose_tpu.core.config import TrainConfig as JaxTrainConfig
from givepose_tpu.train.ranger import ranger as jax_ranger
from givepose_tpu.train.schedule import flat_and_anneal as jax_schedule
from givepose_tpu.train.step import make_optimizer as jax_make_optimizer

from givepose_torch.core.config import Config, TrainConfig
from givepose_torch.models.convert_from_flax import _convert_leaf
from givepose_torch.train import Ranger, flat_and_anneal, make_optimizer
from givepose_torch.train.ranger import radam_scalars

from test_train import numpy_ranger_reference

torch.set_num_threads(2)

# flax-layout shapes: conv (kh,kw,in,out), dense (in,out), depthwise
# (kh,kw,1,C), deconv (kh,kw,out,in), bias
SHAPES = {"conv": (3, 3, 4, 5), "dense": (6, 3), "fc_z": (6, 1),
          "dw": (3, 3, 1, 4), "deconv": (3, 3, 5, 4), "bias": (5,)}


def to_torch_layout(tree):
    return {k: torch.from_numpy(np.ascontiguousarray(
        _convert_leaf("kernel", v), dtype=np.float32)) for k, v in tree.items()}


def to_flax_layout(tree):
    out = {}
    for k, t in tree.items():
        v = t.detach().numpy()
        out[k] = (v.transpose(2, 3, 1, 0) if v.ndim == 4
                  else v.T if v.ndim == 2 else v)
    return out


def make_params(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def test_flat_and_anneal_matches_jax():
    kw = dict(warmup_iters=100, warmup_factor=1e-3, anneal_point=0.72)
    ref, got = jax_schedule(1e-3, 1000, **kw), flat_and_anneal(1e-3, 1000,
                                                               **kw)
    for step in (0, 99, 100, 500, 719, 720, 860, 999, 1000):
        np.testing.assert_allclose(float(got(step)), float(ref(step)),
                                   rtol=1e-6, err_msg=str(step))


def test_radam_switches_to_adaptive_at_step_6():
    assert not radam_scalars(5, 0.95, 0.999, 5.0)[1]
    step_size, adaptive = radam_scalars(6, 0.95, 0.999, 5.0)
    assert adaptive
    # f32 rectifier at step 6 (f64 would give ~2.0e-3 * bias1)
    assert abs(step_size / (1 / (1 - 0.95 ** 6)) - 1.9862e-3) < 2e-6


def run_ranger(params, grads_seq, lr=0.01, wd=0.01):
    p = to_torch_layout(params)
    opt = Ranger(p, lambda count: torch.tensor(lr, dtype=torch.float32),
                 weight_decay=wd)
    for grads in grads_seq:
        for k, u in opt.updates(to_torch_layout(grads), p).items():
            p[k] = p[k] + u
    return to_flax_layout(p)


def test_ranger_matches_numpy_reference():
    """13 steps: the adaptive switch at step 6, lookahead syncs at 6, 12.
    At the default lr 1e-3: the reference takes the RAdam scalars in f64,
    ~0.6 % off the f32 ones that the port and JAX share, which at lr 1e-2
    moves these parameters by up to 4e-6 (JAX's own too)."""
    params = make_params(0)
    grads_seq = [make_params(100 + i) for i in range(13)]
    want = numpy_ranger_reference(
        {k: v.astype(np.float64) for k, v in params.items()},
        [{k: v.astype(np.float64) for k, v in g.items()} for g in grads_seq],
        lr=1e-3, wd=0.01)
    got = run_ranger(params, grads_seq, lr=1e-3)
    for k in params:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_ranger_matches_jax():
    params = make_params(1)
    grads_seq = [make_params(200 + i) for i in range(13)]
    opt = jax_ranger(0.01, weight_decay=0.01)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(p)
    update = jax.jit(opt.update)
    for grads in grads_seq:
        u, state = update({k: jnp.asarray(v) for k, v in grads.items()},
                          state, p)
        p = optax.apply_updates(p, u)
    got = run_ranger(params, grads_seq)
    for k in params:
        np.testing.assert_allclose(got[k], np.asarray(p[k]), atol=1e-6,
                                   err_msg=k)


def configs(**train):
    kw = dict(batch_size=8, warmup_iters=2, total_epoch=1, train_size=64)
    kw.update(train)
    return (JaxConfig(train=JaxTrainConfig(**kw)),
            Config(train=TrainConfig(**kw)))


def run_both(grads_seq, **train):
    """The same gradients through JAX's make_optimizer and the port's;
    returns (JAX params, JAX state, port params, port optimizer)."""
    jcfg, tcfg = configs(**train)
    params = make_params(7)
    jopt = jax_make_optimizer(jcfg, steps_per_epoch=8)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jp)
    jupdate = jax.jit(jopt.update)
    tp = {k: torch.nn.Parameter(v) for k, v in
          to_torch_layout(params).items()}
    topt = make_optimizer(tp, tcfg, steps_per_epoch=8)
    for grads in grads_seq:
        u, jstate = jupdate({k: jnp.asarray(v) for k, v in grads.items()},
                            jstate, jp)
        jp = optax.apply_updates(jp, u)
        topt.step(to_torch_layout(grads))
    return jp, jstate, to_flax_layout(tp), topt


def assert_params_close(jp, tp):
    for k in jp:
        np.testing.assert_allclose(tp[k], np.asarray(jp[k]), atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("scale,clipped", [(0.1, False), (10.0, True)])
def test_clip_matches_jax(scale, clipped):
    grads_seq = [make_params(300 + i, scale) for i in range(3)]
    norms = [np.sqrt(sum((g ** 2).sum() for g in gs.values()))
             for gs in grads_seq]
    assert all((n > 5.0) == clipped for n in norms)
    jp, _, tp, _ = run_both(grads_seq)
    assert_params_close(jp, tp)


def test_nonfinite_step_is_skipped():
    good = [make_params(400 + i) for i in range(3)]
    bad = make_params(403)
    bad["dense"][0, 0] = np.nan
    jp, jstate, tp, topt = run_both([good[0], bad, good[1], good[2]])
    assert_params_close(jp, tp)
    assert topt.total_notfinite == int(jstate.total_notfinite) == 1
    assert topt.notfinite_count == int(jstate.notfinite_count) == 0
    # the skipped step left RAdam, the schedule and lookahead alone
    assert topt.ranger.step == 3


def test_51st_consecutive_nonfinite_step_is_applied():
    params = make_params(7)
    jcfg, tcfg = configs()
    tp = {k: torch.nn.Parameter(v) for k, v in
          to_torch_layout(params).items()}
    topt = make_optimizer(tp, tcfg, steps_per_epoch=8)
    bad = to_torch_layout(make_params(500))
    bad["conv"][0, 0, 0, 0] = float("inf")
    for _ in range(50):
        topt.step(bad)
    assert topt.notfinite_count == topt.total_notfinite == 50
    assert topt.ranger.step == 0
    for k, v in to_torch_layout(params).items():
        torch.testing.assert_close(tp[k].detach(), v, rtol=0, atol=0)
    topt.step(bad)
    assert topt.ranger.step == 1
    assert not torch.isfinite(tp["conv"]).all()

    # JAX: the same count of skips, then the update goes through
    jopt = jax_make_optimizer(jcfg, steps_per_epoch=8)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jp)
    jbad = {k: jnp.asarray(v) for k, v in to_flax_layout(bad).items()}
    jupdate = jax.jit(jopt.update)
    for i in range(51):
        u, jstate = jupdate(jbad, jstate, jp)
        assert bool(jnp.all(u["conv"] == 0)) == (i < 50)
    assert int(jstate.total_notfinite) == 51


def test_accumulate_2_matches_jax():
    grads_seq = [make_params(600 + i) for i in range(6)]
    jp, jstate, tp, topt = run_both(grads_seq, accumulate=2)
    assert_params_close(jp, tp)
    inner = jstate.inner_state
    assert topt.mini_step == int(inner.mini_step) == 0
    # RAdam, the schedule and lookahead counted the 3 emitted steps only
    assert topt.ranger.step == int(inner.gradient_step) == 3


def test_other_optimizers_raise():
    _, tcfg = configs(optimizer_type="adam")
    with pytest.raises(NotImplementedError, match="item 10"):
        make_optimizer({"w": torch.nn.Parameter(torch.ones(2))}, tcfg)
