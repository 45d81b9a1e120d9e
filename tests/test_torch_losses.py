"""The port's pose losses against the JAX package's.

Same numpy inputs through ``givepose_tpu.losses`` and
``givepose_torch.losses`` in f32 on the CPU: the loss dict (keys in
order) to 2e-5 (the repo's loss parity bar), its gradients with respect
to the predictions to 1e-5·max|JAX|, the closest symmetric rotation to
1e-6 (bank entries 1° apart differ by ≥ 1.7e-2, so this pins the argmax
index), the small helpers to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from givepose_tpu.core.config import LossConfig as JaxLossConfig
from givepose_tpu.geometry import closest_sym_rot as jax_closest_sym_rot
from givepose_tpu.losses import pose_loss as jax_losses

from givepose_torch.core.config import LossConfig
from givepose_torch.geometry.symmetry import (
    closest_sym_rot,
    sym_info,
    sym_info_table,
    symmetry_rotation_bank_y,
)
from givepose_torch.losses import pose_loss as losses

torch.set_num_threads(2)

B, RES = 6, 8
KEYS = ["Rot1", "Tran", "Size", "Point_matching", "nocs_coor", "sp2d_coor"]


def make_case(seed):
    """Predictions near the ground truth and a batch whose first half is
    symmetric about y."""
    rng = np.random.default_rng(seed)
    gt = Rotation.random(B, random_state=seed).as_matrix()
    noise = Rotation.from_rotvec(rng.normal(0, 0.3, (B, 3))).as_matrix()
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    pred = {
        "rot": f32(gt @ noise),
        "trans": f32(rng.normal(size=(B, 3))),
        "size": f32(rng.uniform(0.2, 1.5, (B, 3))),
        "nocs_coor": f32(rng.uniform(-0.5, 0.5, (B, RES, RES, 3))),
        "ivfc_coor": f32(rng.uniform(-0.5, 0.5, (B, RES, RES, 3))),
    }
    sym = np.tile([[0, 1, 0, 0]], (B, 1))
    sym[: B // 2] = [1, 1, 0, 1]
    data = {
        "rotation": f32(gt),
        "translation": f32(rng.normal(size=(B, 3)) * 0.2 + [0, 0, 1.0]),
        "real_size": f32(rng.uniform(0.05, 0.3, (B, 3))),
        "nocs_scale": f32(rng.uniform(0.1, 0.4, (B,))),
        "sym_info": f32(sym),
        "nocs_coord": f32(rng.uniform(-0.5, 0.5, (B, RES, RES, 3))),
        "ivfc_coord": f32(rng.uniform(-0.5, 0.5, (B, RES, RES, 3))),
        "roi_mask_output": f32(rng.uniform(size=(B, RES, RES, 1)) > 0.4),
        "roi_ivfc_mask_output": f32(rng.uniform(size=(B, RES, RES, 1))
                                    > 0.4),
        "model_point": f32(rng.uniform(-0.5, 0.5, (B, 64, 3))),
    }
    return pred, data


def to_torch(d, grad=False):
    return {k: torch.from_numpy(v).requires_grad_(grad) for k, v in d.items()}


def to_jax(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


@pytest.mark.parametrize("r_loss", ["l1", "angle"])
@pytest.mark.parametrize("pose_loss_type", ["l1", "smoothl1"])
def test_loss_dict_and_grads_match_jax(r_loss, pose_loss_type):
    pred, data = make_case(3 if r_loss == "l1" else 4)
    jfn = jax_losses.PoseLossFn(JaxLossConfig(r_loss=r_loss,
                                              pose_loss_type=pose_loss_type))
    tfn = losses.PoseLossFn(LossConfig(r_loss=r_loss,
                                       pose_loss_type=pose_loss_type))
    jd = to_jax(data)
    ref = jfn(to_jax(pred), jd)
    tp = to_torch(pred, grad=True)
    got = tfn(tp, to_torch(data))
    assert list(got) == KEYS == list(ref)
    for k in KEYS:
        np.testing.assert_allclose(got[k].item(), float(ref[k]), atol=2e-5,
                                   err_msg=k)

    jgrads = jax.grad(lambda p: sum(jfn(p, jd).values()))(to_jax(pred))
    sum(got.values()).backward()
    for k in pred:
        want = np.asarray(jgrads[k])
        np.testing.assert_allclose(tp[k].grad.numpy(), want,
                                   atol=1e-5 * np.abs(want).max(), err_msg=k)



@pytest.mark.parametrize("sign", [1, -1], ids=["plus", "minus"])
def test_angle_loss_tie_grads_match_jax(sign):
    """The 'angle' loss with (trace - 1) / 2 exactly on the clip's bound
    +-0.99999, where jnp.clip's gradient is 0.5 (torch.clamp's is 1): the
    last sample is not symmetric, its ground truth the identity and its
    prediction diag(t, 0, 0), so its trace is t, exactly."""
    pred, data = make_case(4)
    c = np.float32(0.99999) * sign
    t = np.float32(1) + 2 * c
    assert (t - np.float32(1)) / np.float32(2) == c
    pred["rot"][-1] = np.diag([t, 0, 0])
    data["rotation"][-1] = np.eye(3)
    data["sym_info"][-1] = [0, 1, 0, 0]
    cfg = dict(r_loss="angle", pose_loss_type="l1")
    jfn = jax_losses.PoseLossFn(JaxLossConfig(**cfg))
    tfn = losses.PoseLossFn(LossConfig(**cfg))
    jd = to_jax(data)
    jgrads = jax.grad(lambda p: jfn(p, jd)["Rot1"])(to_jax(pred))
    tp = to_torch(pred, grad=True)
    tfn(tp, to_torch(data))["Rot1"].backward()
    want = np.asarray(jgrads["rot"])
    np.testing.assert_allclose(tp["rot"].grad.numpy(), want,
                               atol=1e-5 * np.abs(want).max())

def test_closest_sym_rot_picks_jax_index():
    pred, data = make_case(5)
    flags = (data["sym_info"][:, 0] == 1).astype(np.float32)
    bank = symmetry_rotation_bank_y(360)
    ref = np.asarray(jax_closest_sym_rot(
        jnp.asarray(pred["rot"]), jnp.asarray(data["rotation"]),
        jnp.asarray(flags), jnp.asarray(bank, jnp.float32)))
    got = closest_sym_rot(torch.from_numpy(pred["rot"]),
                          torch.from_numpy(data["rotation"]),
                          torch.from_numpy(flags),
                          torch.from_numpy(bank.astype(np.float32))).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    # symmetric samples moved, the others kept their ground truth
    assert np.abs(got[: B // 2] - data["rotation"][: B // 2]).max() > 1e-2
    np.testing.assert_array_equal(got[B // 2:], data["rotation"][B // 2:])


def test_symmetry_tables_match_jax():
    from givepose_tpu.geometry import symmetry as jsym
    np.testing.assert_array_equal(symmetry_rotation_bank_y(30),
                                  jsym.symmetry_rotation_bank_y(30))
    np.testing.assert_array_equal(sym_info_table(), jsym.sym_info_table())
    for cat in range(1, 7):
        for handle in (0, 1):
            np.testing.assert_array_equal(sym_info(cat, handle),
                                          jsym.sym_info(cat, handle))


@pytest.mark.parametrize("pose_loss_type", ["l1", "smoothl1"])
def test_small_helpers_match_jax(pose_loss_type):
    rng = np.random.default_rng(9)
    a = rng.normal(size=(4, 5)).astype(np.float32)
    b = rng.normal(size=(4, 5)).astype(np.float32)
    logv = rng.normal(size=(4, 1)).astype(np.float32)
    mask = (rng.uniform(size=(4, 1)) > 0.5).astype(np.float32)
    target = rng.uniform(0, 1, (4, 5)).astype(np.float32)
    target[0, 0] = 0.0
    jcfg = JaxLossConfig(pose_loss_type=pose_loss_type)
    tcfg = LossConfig(pose_loss_type=pose_loss_type)
    ja, jb, jl, jm, jt = map(jnp.asarray, (a, b, logv, mask, target))
    ta, tb, tl, tm, tt = map(torch.from_numpy, (a, b, logv, mask, target))
    pairs = [
        (jax_losses.scale_loss(jcfg, ja, jb), losses.scale_loss(tcfg, ta, tb)),
        (jax_losses.soft_label_cross_entropy(ja, jt),
         losses.soft_label_cross_entropy(ta, tt)),
        (jax_losses.laplacian_aleatoric_loss(ja, jb, jl, jm),
         losses.laplacian_aleatoric_loss(ta, tb, tl, tm)),
        (jax_losses.laplacian_aleatoric_loss(ja, jb, jl, sum_last_dim=False),
         losses.laplacian_aleatoric_loss(ta, tb, tl, sum_last_dim=False)),
        (jax_losses.gaussian_aleatoric_loss(ja, jb, jl),
         losses.gaussian_aleatoric_loss(ta, tb, tl)),
        (jax_losses.backbone_mask_loss(ja, (jb > 0).astype(jnp.float32)),
         losses.backbone_mask_loss(ta, (tb > 0).float())),
    ]
    for i, (want, got) in enumerate(pairs):
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6,
                                   atol=1e-6, err_msg=str(i))

    pred, data = make_case(6)
    bank = symmetry_rotation_bank_y(360)
    ref = jax_losses.pnp_loss(jcfg, to_jax(pred), to_jax(data),
                              jnp.asarray(bank, jnp.float32))
    got = losses.pnp_loss(tcfg, to_torch(pred), to_torch(data),
                          torch.from_numpy(bank.astype(np.float32)))
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].item(), float(ref[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
