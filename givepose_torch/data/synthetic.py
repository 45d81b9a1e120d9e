"""Synthetic NOCS-format dataset for tests and end-to-end smoke runs.

Writes a miniature on-disk tree matching the reference's expected layout
(SURVEY.md §2.3: *_color.png, *_mask.png, *_coord.png, *_label.pkl,
obj_models/*.pkl, train/test list files, IVFC pngs) so the real reader
and eval entry points can run without the NOCS download.  Objects are
textured boxes rendered by projecting their NOCS cube through a known
pose — poses are exact, so train/eval smoke can verify geometry end to
end.

Port of ``givepose_tpu/data/synthetic.py``, with PNGs written by
``data/png.py``: for the same seed the files decode to the same arrays
(the bytes differ, the encoders do) and the pickles load equal, so a
machine without OpenCV or JAX writes the same fixture.  The box is
rasterized with a vectorized z-buffer that picks, for each pixel, the
first point of least depth, as the JAX package's point loop does.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from givepose_torch.data import png
from givepose_torch.data.records import CAMERA_K, REAL_K


def _render_box(rng, im_h, im_w, K, rot, trans, size):
    """Project a box and rasterize color/mask/NOCS maps (nearest-face)."""
    # dense surface sampling of the box in NOCS space
    n = 48
    u = np.linspace(-0.5, 0.5, n)
    faces = []
    for axis in range(3):
        for sgn in (-0.5, 0.5):
            g1, g2 = np.meshgrid(u, u)
            pts = np.zeros((n * n, 3))
            others = [a for a in range(3) if a != axis]
            pts[:, others[0]] = g1.ravel()
            pts[:, others[1]] = g2.ravel()
            pts[:, axis] = sgn
            faces.append(pts)
    unit = np.concatenate(faces)                     # (M, 3) in [-0.5,0.5]
    obj = unit * size[None, :]                       # metric points
    # NOCS convention: coords = metric / bbox-diagonal (uniform scale),
    # so a non-cubic box does NOT fill [-0.5,0.5] on all axes
    nocs = obj / np.linalg.norm(size)
    cam = obj @ rot.T + trans[None, :]
    proj = cam @ K.T
    px = proj[:, 0] / proj[:, 2]
    py = proj[:, 1] / proj[:, 2]

    color = np.zeros((im_h, im_w, 3), np.uint8)
    mask = np.zeros((im_h, im_w), np.uint8)
    coord = np.zeros((im_h, im_w, 3), np.float32)
    depth = np.full((im_h, im_w), np.inf)

    xi = np.round(px).astype(int)
    yi = np.round(py).astype(int)
    ok = (xi >= 0) & (xi < im_w) & (yi >= 0) & (yi < im_h) & (cam[:, 2] > 0)
    # z-buffer: per pixel, the first point (in order) of least depth
    pix = (yi * im_w + xi)[ok]
    z = cam[ok, 2]
    order = np.lexsort((np.arange(len(pix)), z, pix))
    first = np.ones(len(order), bool)
    first[1:] = pix[order][1:] != pix[order][:-1]
    win = order[first]
    ys, xs = yi[ok][win], xi[ok][win]
    nc = nocs[ok][win]
    depth[ys, xs] = z[win]
    coord[ys, xs] = nc
    mask[ys, xs] = 1
    color[ys, xs] = ((nc + 0.5) * 255).astype(np.uint8)
    depth_mm = np.where(np.isfinite(depth), depth * 1000.0, 0.0)
    return color, mask, coord, depth_mm.astype(np.uint16)


def make_synthetic_nocs(root: str, n_images: int = 4, seed: int = 0,
                        im_h: int = 480, im_w: int = 640,
                        split: str = "train", source: str = "Real"):
    """Write a synthetic dataset; returns the data_dir."""
    rng = np.random.default_rng(seed)
    data_dir = os.path.join(root, "NOCS")
    ivfc_dir = os.path.join(root, "IVFC")
    scene_rel = os.path.join(source, f"{split}", "scene_1")
    scene = os.path.join(data_dir, scene_rel)
    os.makedirs(scene, exist_ok=True)
    os.makedirs(os.path.join(data_dir, "obj_models"), exist_ok=True)
    os.makedirs(os.path.join(ivfc_dir, scene_rel), exist_ok=True)

    # native NOCS resolution so the reader's hardcoded intrinsics match
    assert (im_h, im_w) == (480, 640), "reader intrinsics assume 640x480"
    K = (REAL_K if source == "Real" else CAMERA_K).copy()

    models = {}
    entries = []
    for i in range(n_images):
        name = f"{i:04d}"
        cat_id = int(rng.integers(1, 7))
        model_name = f"syn_model_{i}"
        size = rng.uniform(0.08, 0.2, size=3).astype(np.float32)
        nocs_scale = float(np.linalg.norm(size))
        # random pose in front of the camera
        angle = rng.uniform(-0.6, 0.6, size=3)
        cx, sx = np.cos(angle), np.sin(angle)
        rz = np.array([[cx[2], -sx[2], 0], [sx[2], cx[2], 0], [0, 0, 1]])
        ry = np.array([[cx[1], 0, sx[1]], [0, 1, 0], [-sx[1], 0, cx[1]]])
        rx = np.array([[1, 0, 0], [0, cx[0], -sx[0]], [0, sx[0], cx[0]]])
        rot = (rz @ ry @ rx).astype(np.float32)
        trans = np.array([rng.uniform(-0.1, 0.1), rng.uniform(-0.1, 0.1),
                          rng.uniform(0.8, 1.3)], np.float32)

        color, mask, coord, depth_png = _render_box(rng, im_h, im_w, K,
                                                    rot, trans, size)
        ys, xs = np.where(mask > 0)
        if len(ys) == 0:
            continue
        bbox = np.array([ys.min(), xs.min(), ys.max() + 1, xs.max() + 1])

        png.imwrite(os.path.join(scene, name + "_color.png"),
                    color[:, :, ::-1])                 # RGB -> BGR
        mask_png = np.zeros((im_h, im_w, 3), np.uint8)
        mask_png[:, :, 2] = mask * 1                   # instance id 1
        png.imwrite(os.path.join(scene, name + "_mask.png"), mask_png)
        # metric depth in mm (uint16 variant of the NOCS encodings)
        png.imwrite(os.path.join(scene, name + "_depth.png"), depth_png)
        # encode NOCS like the dataset: rgb = coord + 0.5, z stored flipped
        enc = coord + 0.5
        enc[:, :, 2] = 1.0 - enc[:, :, 2]
        enc_png = (enc * 255).astype(np.uint8)[:, :, ::-1]   # RGB->BGR
        enc_png[mask == 0] = 0
        png.imwrite(os.path.join(scene, name + "_coord.png"), enc_png)
        # IVFC: reuse the NOCS map (consensus == instance for boxes)
        png.imwrite(os.path.join(ivfc_dir, scene_rel,
                                 name + f"_coor_0.png"), enc_png)

        # model points must be the actual box surface in NOCS space:
        # fs_net_sizes derives real_size from these extents (random
        # points would make ||real_size|| = sqrt(3)*nocs_scale and feed
        # the scale/size heads targets 1.7x off the GT sRT convention)
        face = rng.integers(0, 3, 256)
        sgn = rng.choice([-0.5, 0.5], 256)
        pts = rng.uniform(-0.5, 0.5, size=(256, 3))
        pts[np.arange(256), face] = sgn
        model_pts = (pts * size[None, :] / nocs_scale).astype(np.float32)
        models[model_name] = model_pts

        gts = {
            "class_ids": np.array([cat_id]),
            "instance_ids": np.array([1]),
            "model_list": [model_name],
            "bboxes": np.array([bbox]),
            "scales": np.array([nocs_scale], np.float32),
            "rotations": np.array([rot]),
            "translations": np.array([trans]),
            "poses": np.array([np.hstack([rot, trans[:, None]])]),
            # synthetic-only extra: normalized box extents (= metric size
            # / diagonal), used by the eval fixture for gt_scales
            "sizes_normed": np.array([size / nocs_scale]),
        }
        with open(os.path.join(scene, name + "_label.pkl"), "wb") as f:
            pickle.dump(gts, f)
        entries.append(os.path.join(*scene_rel.split(os.sep)[1:], name))

    list_name = {"train": "train_list.txt",
                 "test": "test_list.txt" if source == "Real"
                 else "val_list.txt"}[split]
    os.makedirs(os.path.join(data_dir, source), exist_ok=True)
    with open(os.path.join(data_dir, source, list_name), "w") as f:
        f.write("\n".join(entries) + "\n")

    model_file = {
        ("Real", "train"): "obj_models/real_train.pkl",
        ("Real", "test"): "obj_models/real_test.pkl",
        ("CAMERA", "train"): "obj_models/camera_train.pkl",
        ("CAMERA", "test"): "obj_models/camera_val.pkl",
    }[(source, split)]
    with open(os.path.join(data_dir, model_file), "wb") as f:
        pickle.dump(models, f)
    with open(os.path.join(data_dir, "obj_models/mug_meta.pkl"),
              "wb") as f:
        pickle.dump({m: (np.zeros(3, np.float32), 1.0) for m in models}, f)
    return data_dir, ivfc_dir


def make_synthetic_eval(root: str, n_images: int = 3, seed: int = 1):
    """Test split + DualPoseNet-style detection pkls using GT as
    detections (detection format: evaluation/load_data_eval.py:194-201,
    result-dict keys: evaluate.py:128-133)."""
    data_dir, ivfc_dir = make_synthetic_nocs(root, n_images=n_images,
                                             seed=seed, split="test",
                                             source="Real")
    det_root = os.path.join(data_dir,
                            "detection_dualposenet/data/"
                            "segmentation_results_refine_for_mug/REAL275")
    os.makedirs(det_root, exist_ok=True)
    with open(os.path.join(data_dir, "Real/test_list.txt")) as f:
        entries = [line.strip() for line in f if line.strip()]
    for sub in entries:
        img_path = os.path.join(data_dir, "Real", sub)
        with open(img_path + "_label.pkl", "rb") as f:
            gts = pickle.load(f)
        mask_png = png.imread(img_path + "_mask.png")
        inst_mask = (mask_png[:, :, 2] == 1).astype(np.uint8)
        y1, x1, y2, x2 = gts["bboxes"][0]
        scene = sub.split("/")[-2]
        img_id = sub.split("/")[-1]
        rot = gts["rotations"][0]
        trans = gts["translations"][0]
        rt = np.eye(4)
        rt[:3, :3] = rot * gts["scales"][0]
        rt[:3, 3] = trans
        det = {
            "pred_class_ids": np.array(gts["class_ids"]),
            "pred_bboxes": np.array([[y1, x1, y2, x2]]),
            "pred_scores": np.array([0.97]),
            "pred_masks": inst_mask[:, :, None],
            "gt_class_ids": np.array(gts["class_ids"]),
            "gt_bboxes": np.array([[y1, x1, y2, x2]]),
            "gt_RTs": np.array([rt]),
            "gt_scales": np.array(gts["sizes_normed"]),
            "gt_handle_visibility": np.ones(1),
        }
        with open(os.path.join(
                det_root, f"results_test_{scene}_{img_id}.pkl"),
                "wb") as f:
            pickle.dump(det, f)
    return data_dir, ivfc_dir
