"""The port's pose geometry against the JAX package's, f32, atol 1e-6
(the same closed forms; only rounding order may differ)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import givepose_tpu.geometry.allo_ego as jax_ae
import givepose_tpu.geometry.pose_assembly as jax_pa
import givepose_tpu.geometry.rotations as jax_rot

import givepose_torch.geometry.allo_ego as ae
import givepose_torch.geometry.pose_assembly as pa
import givepose_torch.geometry.rotations as rot

torch.set_num_threads(2)

R_TYPES = ["ego_quat", "allo_quat", "ego_log_quat", "allo_log_quat",
           "ego_lie_vec", "allo_lie_vec", "ego_rot6d", "allo_rot6d",
           "allo_rot6d_sym", "allo_rot6d_sym_y", "allo_rot6d_y",
           "allo_rot6d_z", "allo_rot6d_x", "euler"]
DIMS = {"quat": 4, "lie_vec": 3, "euler": 3}


def close(out, ref, atol=1e-6):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=atol)


@pytest.mark.parametrize("r_type", R_TYPES)
def test_get_rot_mat(r_type):
    d = next((v for k, v in DIMS.items() if k in r_type), 6)
    x = np.random.default_rng(len(r_type)).normal(size=(16, d))
    x = x.astype(np.float32)
    close(rot.get_rot_mat(torch.from_numpy(x), r_type),
          jax_rot.get_rot_mat(jnp.asarray(x), r_type))


def test_get_rot_mat_unknown():
    with pytest.raises(ValueError):
        rot.get_rot_mat(torch.zeros(1, 6), "nope")



def test_allo_ego():
    rng = np.random.default_rng(6)
    t = rng.normal(size=(16, 3)).astype(np.float32)
    t[:, 2] = np.abs(t[:, 2]) + 0.5
    t[0] = [0.0, 0.0, 1.0]                      # on the optical axis
    q = rng.normal(size=(16, 4)).astype(np.float32)
    r = np.array(jax_rot.quat_to_mat(jnp.asarray(q)))
    tt, tq, tr = (torch.from_numpy(a) for a in (t, q, r))
    jt, jq, jr = (jnp.asarray(a) for a in (t, q, r))
    close(ae.quat_mul(tq, tq.flip(0)), jax_ae.quat_mul(jq, jq[::-1]))
    close(ae.allo_to_ego_quat(tt, tq), jax_ae.allo_to_ego_quat(jt, jq))
    close(ae.allo_to_ego_mat(tt, tr), jax_ae.allo_to_ego_mat(jt, jr))
    close(ae.ego_to_allo_mat(tt, tr), jax_ae.ego_to_allo_mat(jt, jr))


@pytest.mark.parametrize("z_type,is_wild6d,rep,is_allo", [
    ("REL", False, "mat", True), ("ABS", False, "mat", True),
    ("REL", True, "mat", True), ("REL", False, "quat", True),
    ("ABS", False, "quat", False), ("REL", False, "mat", False)])
def test_pose_from_pred_centroid_z(z_type, is_wild6d, rep, is_allo):
    rng = np.random.default_rng(7)
    b = 8
    k = np.tile(np.array([[591.0, 0, 322.5], [0, 590.2, 244.1], [0, 0, 1]],
                         np.float32), (b, 1, 1))
    k[:, 0, 0] += rng.uniform(-20, 20, b).astype(np.float32)
    if rep == "quat":
        rots = rng.normal(size=(b, 4))
    else:
        rots = np.asarray(jax_rot.rot6d_to_mat(
            jnp.asarray(rng.normal(size=(b, 6)), jnp.float32)))
    args = [np.array(a, np.float32) for a in (
        rots, rng.uniform(-0.3, 0.3, (b, 2)), rng.uniform(0.5, 2.0, (b, 1)),
        k, rng.uniform(100, 400, (b, 2)), rng.uniform(0.2, 0.5, (b,)),
        rng.uniform(50, 150, (b, 2)))]
    kw = dict(is_allo=is_allo, z_type=z_type, is_wild6d=is_wild6d)
    r, t = pa.pose_from_pred_centroid_z(*map(torch.from_numpy, args), **kw)
    jr, jt = jax_pa.pose_from_pred_centroid_z(*map(jnp.asarray, args), **kw)
    close(r, jr)
    close(t, jt)



# inputs whose normalized part (slice) has a norm of exactly the function's
# eps, where jnp.maximum's gradient splits (0.5) and torch.clamp's does not
# (1).  At the lie_vec tie both give the same gradient, because the axis
# is normalized again, which removes the radial part that the tie scales.
EPS12, EPS8 = float(np.float32(1e-12)), float(np.float32(1e-8))
TIE_CASES = [("ego_rot6d", [EPS12, 0, 0, 0, 1, 0], slice(0, 3), EPS12),
             ("ego_quat", [EPS12 / 2] * 4, slice(0, 4), EPS12),
             ("ego_lie_vec", [EPS8, 0, 0], slice(0, 3), EPS8),
             ("ego_log_quat", [0.3, EPS8, 0, 0], slice(1, 4), EPS8)]


@pytest.mark.parametrize("r_type,vec,part,eps", TIE_CASES,
                         ids=[c[0] for c in TIE_CASES])
def test_norm_tie_grads_match_jax(r_type, vec, part, eps):
    """At a norm of exactly eps the gradient of ``get_rot_mat`` is
    jax.grad's, to 1e-5 of its largest entry."""
    import jax

    x = np.asarray([vec, vec], np.float32)
    assert torch.linalg.vector_norm(torch.from_numpy(x[0, part])) == eps
    assert float(jnp.linalg.norm(jnp.asarray(x[0, part]))) == eps
    w = np.random.default_rng(7).normal(size=(2, 3, 3)).astype(np.float32)
    want = np.asarray(jax.grad(lambda v: jnp.sum(
        jax_rot.get_rot_mat(v, r_type) * w))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    (rot.get_rot_mat(xt, r_type) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want,
                               atol=1e-5 * np.abs(want).max())
