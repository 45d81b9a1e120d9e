"""The port's public surfaces against the JAX package's.

Every name that an ``__init__`` of ``givepose_tpu`` exports imports from
the port's package of the same name, except the names listed here against
their open ROADMAP queue item, which must still be missing (a name that
gets ported leaves the list).  The resample functions that ``ops``
exports match the JAX ones (nearest bitwise, bilinear within 1e-6), and
``train.ranger`` builds the port's Ranger from the JAX factory's
hyper-parameters.
"""

from __future__ import annotations

import ast
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from givepose_tpu.ops import resample as jax_resample

from givepose_torch.ops import resample

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PACKAGES = ("geometry", "models", "ops", "losses", "train", "data", "eval",
            "parallel", "prep")

# names the port does not export yet, with the queue item that ports them
NOT_YET = {
    "models": {
        "MAPTransformerEncoder": "A10", "AttentionPnPNet": "A10",
        "CrossAttentionPnPNet": "A10", "ResNet": "A10", "resnet18": "A10",
        "resnet34": "A10", "resnet50": "A10", "resnet101": "A10",
        "CoordAtt": "A10", "AttentionMaskHead": "A10"},
    "ops": {"chamfer_distances": "A10", "nn_distance": "A10"},
    "parallel": "A7",
    "prep": "A11",
}


def jax_exports(package: str) -> list[str]:
    """The names a JAX ``__init__`` imports from its modules."""
    path = os.path.join(REPO, "givepose_tpu", package, "__init__.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    return [alias.asname or alias.name for node in tree.body
            if isinstance(node, ast.ImportFrom) for alias in node.names]


@pytest.mark.parametrize("package", PACKAGES)
def test_every_jax_export_imports_from_the_port(package):
    names = jax_exports(package)
    assert names, package
    exempt = NOT_YET.get(package, {})
    if isinstance(exempt, str):
        exempt = dict.fromkeys(names, exempt)
    assert set(exempt) <= set(names), set(exempt) - set(names)
    try:
        port = importlib.import_module(f"givepose_torch.{package}")
    except ModuleNotFoundError:
        assert len(exempt) == len(names), package
        return
    missing = [n for n in names if n not in exempt
               and not hasattr(port, n)]
    assert not missing, f"givepose_torch.{package} lacks {missing}"
    ported = [n for n in exempt if hasattr(port, n)]
    assert not ported, f"{ported} are ported: take them off NOT_YET"


def test_geometry_exports_all_27():
    import givepose_torch.geometry as geo
    names = jax_exports("geometry")
    assert len(names) == 27
    for n in names:
        assert callable(getattr(geo, n)), n


def crop_cases():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (37, 53, 3)).astype(np.float32)
    # inside, across the left/top border, beyond the bottom/right, tiny
    return img, [((20.3, 15.7), 30.0), ((2.0, 3.5), 41.0),
                 ((50.2, 33.9), 25.5), ((26.0, 18.0), 3.0)]


@pytest.mark.parametrize("method", ["nearest", "bilinear"])
def test_crop_resize_affine_equals_jax(method):
    img, cases = crop_cases()
    for center, scale in cases:
        for x in (img, img[..., 1]):
            for out in (16, 24):
                got = resample.crop_resize_affine(
                    torch.from_numpy(x), torch.tensor(center), scale, out,
                    method)
                ref = jax_resample.crop_resize_affine(
                    jnp.asarray(x), jnp.asarray(center, jnp.float32),
                    jnp.float32(scale), out, method)
                assert got.shape == ref.shape and got.dtype == torch.float32
                if method == "nearest":
                    np.testing.assert_array_equal(got.numpy(),
                                                  np.asarray(ref))
                else:
                    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("method", ["nearest", "bilinear"])
def test_resize_matrix_and_params_equal_jax(method):
    centers = np.array([[20.3, 15.7], [2.0, 3.5], [50.2, 33.9]], np.float32)
    scales = np.array([30.0, 41.0, 25.5], np.float32)
    a, bx, by = resample.affine_crop_params(torch.from_numpy(centers),
                                            torch.from_numpy(scales), 16)
    ra, rbx, rby = jax_resample.affine_crop_params(
        jnp.asarray(centers), jnp.asarray(scales), 16)
    for g, r in ((a, ra), (bx, rbx), (by, rby)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    got = resample.resize_matrix(53, 16, a, bx, method)
    ref = jax_resample.resize_matrix(53, 16, ra, rbx, method)
    assert got.shape == ref.shape == (3, 16, 53)
    if method == "nearest":
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="unknown method"):
        resample.resize_matrix(53, 16, a, bx, "cubic")


def test_coord_grid_equals_jax():
    for w, h, norm in ((64, 48, True), (7, 5, False)):
        got = resample.get_2d_coord_grid(w, h, norm)
        ref = jax_resample.get_2d_coord_grid(w, h, norm)
        assert got.shape == ref.shape == (2, h, w)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_ranger_factory_equals_jax():
    """``train.ranger(params, lr, ...)``: seven updates (one lookahead
    sync at k 6) equal to the JAX factory's within 1e-6, on a dense
    kernel (flax (in, out), torch (out, in): gradient centralization
    averages over the inputs in both) and a bias."""
    from givepose_tpu.train import ranger as jax_ranger
    from givepose_torch.train import Ranger, ranger

    def torch_layout(tree):
        return {"w": torch.from_numpy(np.ascontiguousarray(tree["w"].T)),
                "b": torch.from_numpy(tree["b"].copy())}

    rng = np.random.default_rng(1)
    params = {"w": rng.normal(size=(4, 3)).astype(np.float32),
              "b": rng.normal(size=(3,)).astype(np.float32)}
    tp = torch_layout(params)
    opt = ranger(tp, 1e-2, weight_decay=1e-4)
    assert isinstance(opt, Ranger)
    tx = jax_ranger(1e-2, weight_decay=1e-4)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    for step in range(7):
        grads = {k: rng.normal(size=v.shape).astype(np.float32)
                 for k, v in params.items()}
        upd, state = tx.update({k: jnp.asarray(g) for k, g in grads.items()},
                               state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
        tu = opt.updates(torch_layout(grads), tp)
        tp = {k: tp[k] + tu[k] for k in tp}
        got = {"w": tp["w"].numpy().T, "b": tp["b"].numpy()}
        for k in params:
            np.testing.assert_allclose(got[k], np.asarray(jp[k]), rtol=0,
                                       atol=1e-6, err_msg=(step, k))
