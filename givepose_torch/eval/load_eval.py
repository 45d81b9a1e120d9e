"""Evaluation data loading (NOCS REAL275/CAMERA25 + Wild6D).

Reference: evaluation/load_data_eval.py — per test image, read the
DualPoseNet segmentation pkl (``results_test_{scene}_{img}.pkl``,
:194-201), build one crop per detected instance (square bbox * 1.5 pad, no
jitter, :258-270), and carry the detection dict through to the mAP stage.
Wild6D (evaluation/load_data_eval_wild.py): mask-derived bboxes,
per-category test lists, GT from pkl_annotations, pred_scores=[1].

TPU-first batching: instances are padded to ``max_instances`` with a
validity mask so every image evaluates with static shapes under jit; the
reference instead runs ragged per-image batches (eval_batch_size=1 +
identity collate, evaluate.py:84-90).

Port of ``givepose_tpu/eval/load_eval.py``.  Images are read by
``data/png.py`` (what ``cv2.imread`` returns, without OpenCV): the colour
image as BGR, flipped to RGB; depth with ``unchanged=True``, so a 16-bit
PNG stays uint16 and a 3-channel composite keeps its channels.  Crops go
through the same ``ops/resample.py`` host mirrors, so a batch equals the
JAX reader's bitwise.  Wild6D's frames are JPEG files, which the port
cannot decode yet (no OpenCV, PIL or torchvision on the GPU machine): a
frame whose bytes are JPEG raises ``NotImplementedError``.
"""

from __future__ import annotations

import glob
import os
import pickle

import numpy as np

from givepose_torch.data import png
from givepose_torch.data.records import (
    CAMERA_K,
    REAL_K,
    IMG_MEAN,
    IMG_STD,
    CAT_NAMES,
    ID2CAT_CAMERA,
    _FSNET_UNITS,
)
from givepose_torch.geometry.symmetry import sym_info
from givepose_torch.ops.resample import (
    crop_coord_2d_np,
    crop_resize_affine_np,
    resize_image_np,
)


_JPEG_SOI = b"\xff\xd8\xff"


def imread(path: str, unchanged: bool = False) -> np.ndarray | None:
    """``cv2.imread(path)`` (``-1`` with ``unchanged``) for PNG files; a
    JPEG file raises, since the port has no JPEG decoder."""
    try:
        with open(path, "rb") as f:
            head = f.read(3)
    except OSError:
        return None
    if head == _JPEG_SOI:
        raise NotImplementedError(
            f"{path} is a JPEG file: the port reads PNG only (Wild6D's JPEG "
            "frames need a decoder; ROADMAP queue A, item 8)")
    return png.imread(path, unchanged=unchanged)


def load_depth(depth_path: str) -> np.ndarray | None:
    """NOCS depth decode (reference tools/eval_utils.py:141-155).

    3-channel pngs are composite-encoded: depth16 = G*256 + B with the
    32001 sentinel zeroed; plain uint16 pngs pass through.  Returns mm.
    """
    depth = imread(depth_path, unchanged=True)
    if depth is None:
        return None
    if depth.ndim == 3:
        depth16 = (depth[:, :, 1].astype(np.int32) * 256
                   + depth[:, :, 2].astype(np.int32))
        depth16 = np.where(depth16 == 32001, 0, depth16)
        return depth16.astype(np.uint16)
    if depth.ndim == 2 and depth.dtype == np.uint16:
        return depth
    return None


def mean_shape_of(cat_id: int, source: str = "Real") -> np.ndarray:
    name = (ID2CAT_CAMERA[cat_id] if source == "CAMERA"
            else CAT_NAMES[cat_id - 1])
    return np.array(_FSNET_UNITS[name], np.float32) / 1000.0


class NocsEvalReader:
    """Per-image eval samples from the NOCS layout + detection pkls."""

    def __init__(self, source: str, data_dir: str,
                 detection_dir: str | None = None,
                 refine_mug: bool = True, per_obj: str = "all"):
        assert source in ("CAMERA", "Real", "CAMERA+Real")
        self.source = "CAMERA" if source == "CAMERA" else "Real"
        self.data_dir = data_dir
        self.per_obj = per_obj
        if detection_dir is None:
            sub = ("segmentation_results_refine_for_mug" if refine_mug
                   else "segmentation_results")
            detection_dir = os.path.join(
                data_dir, "detection_dualposenet/data", sub)
        self.detection_dir = detection_dir

        list_file = ("CAMERA/val_list.txt" if self.source == "CAMERA"
                     else "Real/test_list.txt")
        with open(os.path.join(data_dir, list_file)) as f:
            self.img_list = [
                os.path.join(list_file.split("/")[0], line.strip())
                for line in f if line.strip()]

    def __len__(self):
        return len(self.img_list)

    def detection_path(self, img_path: str) -> str:
        scene = img_path.split("/")[-2]
        img_id = img_path.split("/")[-1]
        if self.source == "CAMERA":
            return os.path.join(self.detection_dir, "CAMERA25",
                                f"results_val_{scene}_{img_id}.pkl")
        return os.path.join(self.detection_dir, "REAL275",
                            f"results_test_{scene}_{img_id}.pkl")

    def read(self, index: int):
        """Returns (image_rgb, detection_dict, cam_K) or None."""
        sub = self.img_list[index]
        img_path = os.path.join(self.data_dir, sub)
        det_path = self.detection_path(sub)
        try:
            with open(det_path, "rb") as f:
                det = pickle.load(f)
        except Exception:
            return None
        image = imread(img_path + "_color.png")
        if image is None:
            return None
        image = np.ascontiguousarray(image[:, :, 2::-1])     # BGR -> RGB
        cam_k = CAMERA_K if self.source == "CAMERA" else REAL_K
        return image, det, cam_k

    def read_depth(self, index: int) -> np.ndarray | None:
        """Metric depth (mm) for the depth-assisted Umeyama eval path
        (reference load_data_eval.py:214-218)."""
        img_path = os.path.join(self.data_dir, self.img_list[index])
        return load_depth(img_path + "_depth.png")


def build_instance_batch(image: np.ndarray, det: dict, cam_k: np.ndarray,
                         source: str, img_size: int = 256,
                         out_res: int = 64, pad_scale: float = 1.5,
                         max_instances: int = 24, resize_full: bool = True,
                         per_obj_id: int | None = None,
                         depth: np.ndarray | None = None):
    """Host-side crop batch for one image's detections.

    Keeps reference crop math (bbox y1x1y2x2 -> square * pad, NEAREST
    interp, load_data_eval.py:258-283) but pads the instance axis to
    ``max_instances`` and returns a ``valid`` mask for static-shape jit.
    Returns (batch dict, kept_indices) or None if no instance.

    All crops go through ops.resample's host mirrors of the device
    matmul resampler, so eval inputs are numerically identical to the
    training preprocess graph (the reference uses one
    crop_resize_by_warp_affine on both paths,
    tools/dataset_utils.py:101-114).  The raw image is cropped FIRST and
    normalized after, matching training (out-of-image border pixels then
    normalize to -mean/std on both sides).
    """
    im_h, im_w = image.shape[:2]
    cls_ids = np.asarray(det["pred_class_ids"])
    keep = np.arange(len(cls_ids))
    if per_obj_id is not None:
        keep = keep[cls_ids == per_obj_id]
    keep = keep[:max_instances]
    n = len(keep)
    if n == 0:
        return None

    img_f = image.astype(np.float32)

    def crop(arr, center, scale, out, nearest=True):
        return crop_resize_affine_np(arr, center, scale, out,
                                     "nearest" if nearest else "bilinear")

    b = {
        "roi_img": np.zeros((max_instances, img_size, img_size, 3),
                            np.float32),
        "roi_mask": np.zeros((max_instances, img_size, img_size, 1),
                             np.float32),
        "roi_coord_2d": np.zeros((max_instances, out_res, out_res, 2),
                                 np.float32),
        "bbox_center": np.zeros((max_instances, 2), np.float32),
        "resize_ratio": np.ones((max_instances,), np.float32),
        "roi_wh": np.ones((max_instances, 2), np.float32),
        "img_scale": np.ones((max_instances,), np.float32),
        "mean_size": np.ones((max_instances, 3), np.float32),
        "sym_info": np.zeros((max_instances, 4), np.float32),
        "cat_id_0base": np.zeros((max_instances,), np.int32),
        "one_hot": np.zeros((max_instances, 6), np.float32),
        "cam_K": np.tile(cam_k[None], (max_instances, 1, 1)),
        "valid": np.zeros((max_instances,), np.float32),
    }
    if depth is not None:
        # depth-assisted Umeyama path: per-instance out_res depth crop in
        # METERS + out_res mask (the reference's resize_func_out mask) +
        # image dims for denormalizing roi_coord_2d to absolute pixels.
        # (The reference backprojects NORMALIZED pixels through absolute
        # intrinsics, tools/umeyama.py:55-60 — broken; we use absolute.)
        b["roi_depth"] = np.zeros((max_instances, out_res, out_res),
                                  np.float32)
        b["roi_mask_out"] = np.zeros((max_instances, out_res, out_res),
                                     np.float32)
        b["im_hw"] = np.tile(np.array([[im_h, im_w]], np.float32),
                             (max_instances, 1))
        depth_m = depth.astype(np.float32) / 1000.0

    for slot, j in enumerate(keep):
        cat_id = int(cls_ids[j])
        y1, x1, y2, x2 = det["pred_bboxes"][j]
        bw = min(im_w, x2) - max(0, x1)
        bh = min(im_h, y2) - max(0, y1)
        cx, cy = 0.5 * (x1 + x2), 0.5 * (y1 + y2)
        scale = min(max(y2 - y1, x2 - x1) * pad_scale,
                    max(im_h, im_w)) * 1.0
        center = np.array([cx, cy], np.float32)

        roi = crop(img_f, center, scale, img_size)
        b["roi_img"][slot] = (roi / 255.0 - IMG_MEAN) / IMG_STD
        mask = det["pred_masks"][:, :, j].astype(np.float32)
        b["roi_mask"][slot, :, :, 0] = crop(mask, center, scale, img_size)
        b["roi_coord_2d"][slot] = crop_coord_2d_np(center, scale, out_res,
                                                   im_w, im_h)
        b["bbox_center"][slot] = center
        b["img_scale"][slot] = scale
        b["resize_ratio"][slot] = out_res / scale
        b["roi_wh"][slot] = (bw, bh)
        b["mean_size"][slot] = mean_shape_of(cat_id, source)
        b["sym_info"][slot] = sym_info(cat_id)
        b["cat_id_0base"][slot] = cat_id - 1
        b["one_hot"][slot, cat_id - 1] = 1.0
        b["valid"][slot] = 1.0
        if depth is not None:
            b["roi_depth"][slot] = crop(depth_m, center, scale, out_res)
            b["roi_mask_out"][slot] = crop(mask, center, scale, out_res)

    if resize_full:
        full = resize_image_np(img_f, img_size)
    else:
        full = img_f
    full = (full / 255.0 - IMG_MEAN) / IMG_STD
    # one shared copy; ScaleNet broadcasts the tower feature on device
    b["full_img"] = full[None]
    return b, keep


class WildEvalReader:
    """Wild6D test loader (evaluation/load_data_eval_wild.py:20-246).

    Layout: <root>/test_set/<category>/<video>/<frame>/ images + masks,
    GT from <root>/pkl_annotations/<category>/<category>-<video>-<frame>.pkl;
    detections are mask-derived with pred_scores=[1] (:150-190).
    """

    CATEGORIES = ["bottle", "bowl", "camera", "laptop", "mug"]

    def __init__(self, data_dir: str, per_obj: str = "all"):
        self.data_dir = data_dir
        cats = [per_obj] if per_obj in self.CATEGORIES else self.CATEGORIES
        self.samples = []
        for cat in cats:
            ann_dir = os.path.join(data_dir, "pkl_annotations", cat)
            for pkl_path in sorted(glob.glob(os.path.join(ann_dir,
                                                          "*.pkl"))):
                self.samples.append((cat, pkl_path))

    def __len__(self):
        return len(self.samples)

    def read_depth(self, index: int) -> np.ndarray | None:
        """Wild6D ships uint16 depth next to images; None when absent."""
        cat, pkl_path = self.samples[index]
        name = os.path.basename(pkl_path)[:-4]
        parts = name.split("-")
        frame, video = parts[-1], "/".join(parts[1:-1])
        path = os.path.join(self.data_dir, "test_set", cat, video,
                            "images", f"{frame}-depth.png")
        return load_depth(path) if os.path.exists(path) else None

    def read(self, index: int):
        cat, pkl_path = self.samples[index]
        try:
            with open(pkl_path, "rb") as f:
                ann = pickle.load(f)
        except Exception:
            return None
        name = os.path.basename(pkl_path)[:-4]
        parts = name.split("-")
        frame = parts[-1]
        video = "/".join(parts[1:-1])
        base = os.path.join(self.data_dir, "test_set", cat, video,
                            "images")
        img_file = os.path.join(base, f"{frame}.jpg")
        image = imread(img_file)
        if image is None:
            return None
        image = np.ascontiguousarray(image[:, :, ::-1])      # BGR -> RGB
        mask_file = os.path.join(self.data_dir, "test_set", cat, video,
                                 "masks", f"{frame}.png")
        mask_png = imread(mask_file)
        if mask_png is None:
            return None
        mask = (mask_png[:, :, 2] > 0).astype(np.uint8)
        ys, xs = np.where(mask > 0)
        if len(ys) == 0:
            return None
        bbox = np.array([ys.min(), xs.min(), ys.max(), xs.max()])

        if "K" not in ann:
            return None      # no intrinsics: skip like other bad files
        k = np.asarray(ann["K"], np.float32).reshape(3, 3)
        cat_id = self.CATEGORIES.index(cat) + 1
        cat_id = {1: 1, 2: 2, 3: 3, 4: 5, 5: 6}[cat_id]  # skip 'can'
        det = {
            "pred_class_ids": np.array([cat_id]),
            "pred_bboxes": np.array([bbox]),
            "pred_scores": np.array([1.0]),
            "pred_masks": mask[:, :, None],
            "gt_class_ids": np.array([cat_id]),
            "gt_RTs": np.asarray(ann.get("gt_RTs",
                                         np.eye(4)[None])),
            "gt_scales": np.asarray(ann.get("gt_scales",
                                            np.ones((1, 3)))),
            "gt_handle_visibility": np.ones(1),
            "gt_bboxes": np.array([bbox]),
        }
        return image, det, k
