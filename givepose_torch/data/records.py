"""Host-side NOCS record reading (thin decode only).

Port of ``givepose_tpu/data/records.py``: the same records, every PNG
read through ``data/png.py`` (``cv2.imread``'s results without OpenCV).

The reference does its entire preprocessing inside DataLoader worker
processes (datasets/load_data_nocs.py:180-386: cv2 decode + 7 warpAffine
crops + imgaug per sample).  Here the host does only what must touch the
filesystem — decode PNGs/pickles and pick an instance — and hands full-
resolution numpy arrays plus scalar metadata to the device; the crop/
zoom/augment graph runs on the device (givepose_torch.data.preprocess).

Decode semantics preserved:
  * color: BGR PNG -> RGB (load_data_nocs.py:222-228)
  * nocs coord png: BGR->RGB, /255, z-flip (ch2 = 1 - v), -0.5 (:251-260)
  * mug re-centering with mug_meta (T0, s0) (:263-266)
  * IVFC map: same decode; its mask is ivfc[...,0] != 0 BEFORE the z-flip
    (:307-324); loaded from <ivfc_dir>/<sub_path>_coor_<idx>.png
  * instance mask: mask png channel 2 == instance id (:241-246,289-292)
  * FS-Net per-category sizes and sym infos (:403-489)
  * invalid-sample cache + bad-file skipping (:153-167,185-255)
"""

from __future__ import annotations

import os
import pickle
import random
from dataclasses import dataclass, field

import numpy as np

from givepose_torch.data import png
from givepose_torch.geometry.symmetry import sym_info

CAT_NAMES = ["bottle", "bowl", "camera", "can", "laptop", "mug"]
CAT_NAME2ID = {n: i + 1 for i, n in enumerate(CAT_NAMES)}
ID2CAT_CAMERA = {1: "02876657", 2: "02880940", 3: "02942699",
                 4: "02946921", 5: "03642806", 6: "03797390"}

CAMERA_K = np.array([[577.5, 0, 319.5], [0, 577.5, 239.5], [0, 0, 1]],
                    np.float32)
REAL_K = np.array([[591.0125, 0, 322.525], [0, 590.16775, 244.11084],
                   [0, 0, 1]], np.float32)

IMG_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMG_STD = np.array([0.229, 0.224, 0.225], np.float32)

# FS-Net per-category mean sizes in mm (reference load_data_nocs.py:414-463)
_FSNET_UNITS = {
    "bottle": (87, 220, 89), "bowl": (165, 80, 165),
    "camera": (88, 128, 156), "can": (68, 146, 72),
    "laptop": (346, 200, 335), "mug": (146, 83, 114),
    "02876657": (324 / 4, 874 / 4, 321 / 4),
    "02880940": (675 / 4, 271 / 4, 675 / 4),
    "02942699": (464 / 4, 487 / 4, 702 / 4),
    "02946921": (450 / 4, 753 / 4, 460 / 4),
    "03642806": (581 / 4, 445 / 4, 672 / 4),
    "03797390": (670 / 4, 540 / 4, 497 / 4),
}


def fs_net_sizes(cat_name: str, model: np.ndarray, nocs_scale: float):
    """(real_size_m, mean_size_m) — reference get_fs_net_scale (:403-470)."""
    lx = 2 * max(model[:, 0].max(), -model[:, 0].min())
    ly = model[:, 1].max() - model[:, 1].min()
    lz = model[:, 2].max() - model[:, 2].min()
    real = np.array([lx, ly, lz], np.float32) * nocs_scale * 1000.0
    mean = np.array(_FSNET_UNITS[cat_name], np.float32)
    return real / 1000.0, mean / 1000.0


def decode_nocs_coord(path: str, mug_meta=None, model_name=None,
                      cat_id0=None):
    """Decode a *_coord.png to [-0.5, 0.5] NOCS (reference :251-266)."""
    raw = png.imread(path)
    if raw is None:
        return None
    coord = raw[:, :, (2, 1, 0)].astype(np.float32) / 255.0
    coord[:, :, 2] = 1.0 - coord[:, :, 2]
    coord = coord - 0.5
    if cat_id0 == 5 and mug_meta is not None:
        t0, s0 = mug_meta[model_name]
        coord = s0 * (coord + t0)
    return coord


@dataclass
class Record:
    """One training sample at full image resolution (host numpy)."""

    image: np.ndarray          # (H, W, 3) uint8 RGB
    mask: np.ndarray           # (H, W) f32 instance mask {0,1}
    nocs_coord: np.ndarray     # (H, W, 3) f32, zeroed outside mask
    ivfc_coord: np.ndarray     # (H, W, 3) f32
    ivfc_mask: np.ndarray      # (H, W) f32
    cam_k: np.ndarray          # (3, 3)
    bbox: np.ndarray           # (4,) x1, y1, x2, y2
    cat_id0: int
    rotation: np.ndarray       # (3, 3)
    translation: np.ndarray    # (3,)
    nocs_scale: float
    real_size: np.ndarray      # (3,)
    mean_size: np.ndarray      # (3,)
    sym: np.ndarray            # (4,)
    model_points: np.ndarray   # (P, 3)
    is_syn: bool
    img_path: str = ""
    inst_id: int = -1


class NocsRecordReader:
    """Index + decode NOCS-format data (reference NocsDataset.__init__,
    load_data_nocs.py:24-175, minus on-the-fly preprocessing)."""

    def __init__(self, source: str, mode: str, data_dir: str,
                 ivfc_dir: str | None = None, per_obj: str = "all",
                 ban_mug: bool = False):
        assert source in ("CAMERA", "Real", "CAMERA+Real")
        assert mode in ("train", "test")
        self.source = source
        self.mode = mode
        self.data_dir = data_dir
        self.ivfc_dir = ivfc_dir
        self.per_obj = per_obj
        self.ban_mug = ban_mug

        lists = {
            ("CAMERA", "train"): ["CAMERA/train_list.txt"],
            ("Real", "train"): ["Real/train_list.txt"],
            ("CAMERA+Real", "train"): ["CAMERA/train_list.txt",
                                       "Real/train_list.txt"],
            ("CAMERA", "test"): ["CAMERA/val_list.txt"],
            ("Real", "test"): ["Real/test_list.txt"],
            ("CAMERA+Real", "test"): ["Real/test_list.txt"],
        }[(source, mode)]
        models = {
            ("CAMERA", "train"): ["obj_models/camera_train.pkl"],
            ("Real", "train"): ["obj_models/real_train.pkl"],
            ("CAMERA+Real", "train"): ["obj_models/camera_train.pkl",
                                       "obj_models/real_train.pkl"],
            ("CAMERA", "test"): ["obj_models/camera_val.pkl"],
            ("Real", "test"): ["obj_models/real_test.pkl"],
            ("CAMERA+Real", "test"): ["obj_models/real_test.pkl"],
        }[(source, mode)]

        self.img_list: list[str] = []
        self.subset_len: list[int] = []
        for lp in lists:
            with open(os.path.join(data_dir, lp)) as f:
                entries = [os.path.join(lp.split("/")[0], line.strip())
                           for line in f if line.strip()]
            self.img_list += entries
            self.subset_len.append(len(entries))
        if len(self.subset_len) == 2:
            self.subset_len = [self.subset_len[0],
                               self.subset_len[1]]

        self.models: dict = {}
        for mp in models:
            with open(os.path.join(data_dir, mp), "rb") as f:
                self.models.update(pickle.load(f))

        mug_meta_path = os.path.join(data_dir, "obj_models/mug_meta.pkl")
        self.mug_meta = None
        if os.path.exists(mug_meta_path):
            with open(mug_meta_path, "rb") as f:
                self.mug_meta = pickle.load(f)

        handle_path = os.path.join(data_dir, "Real/mug_handle.pkl")
        self.mug_sym = None
        if os.path.exists(handle_path):
            with open(handle_path, "rb") as f:
                self.mug_sym = pickle.load(f)

        # persisted invalid-sample cache (reference :153-167)
        self.invalid_path = os.path.join(
            data_dir, f"invalid_list_cache_dict_{source}_.txt")
        self.invalid: dict[str, list[int]] = {}
        if os.path.exists(self.invalid_path):
            with open(self.invalid_path) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) == 2:
                        self.invalid.setdefault(parts[0], []).append(
                            int(parts[1]))

    def __len__(self):
        return len(self.img_list)

    def add_invalid(self, img_path: str, inst_id: int):
        """Reference add_invalid_path (:619-627)."""
        self.invalid.setdefault(img_path, []).append(inst_id)
        with open(self.invalid_path, "a") as f:
            f.write(f"{img_path} {inst_id}\n")

    def read(self, index: int, rng: random.Random | None = None
             ) -> Record | None:
        """Decode one sample; None on any bad file (caller retries with the
        next index, reference :185-255)."""
        rng = rng or random
        sub_path = self.img_list[index]
        img_path = os.path.join(self.data_dir, sub_path)
        try:
            with open(img_path + "_label.pkl", "rb") as f:
                gts = pickle.load(f)
        except Exception:
            return None
        is_syn = "CAMERA" in sub_path.split("/")
        cam_k = CAMERA_K if is_syn else REAL_K

        # instance selection (reference :199-220)
        n_inst = len(gts["instance_ids"])
        if n_inst == 0:
            # a label pkl that unpickles fine but holds zero instances
            # must hit the bad-sample-skip path, not raise out of the
            # prefetch worker
            return None
        if self.per_obj in CAT_NAMES:
            cands = [i for i, c in enumerate(gts["class_ids"])
                     if c == CAT_NAME2ID[self.per_obj]]
            if not cands:
                return None
            idx = rng.choice(cands)
        else:
            idx = rng.randint(0, n_inst - 1)
            if self.ban_mug:
                tries = 0
                while gts["class_ids"][idx] == 6 and tries < 20:
                    idx = rng.randint(0, n_inst - 1)
                    tries += 1
        inst_id = gts["instance_ids"][idx]
        if inst_id in self.invalid.get(img_path, []):
            return None
        cat_id0 = gts["class_ids"][idx] - 1
        model_name = gts["model_list"][idx]

        mug_handle = 1
        if (cat_id0 == 5 and not is_syn and self.mode == "train"
                and self.mug_sym is not None):
            parts = img_path.split("/")
            scene = parts[-2] + "_res"
            mug_handle = self.mug_sym.get(scene, {}).get(int(parts[-1]), 1)

        image = png.imread(img_path + "_color.png")
        if image is None:
            return None
        image = np.ascontiguousarray(image[:, :, 2::-1])    # BGR -> RGB

        mask_png = png.imread(img_path + "_mask.png")
        if mask_png is None:
            return None
        inst_mask = (mask_png[:, :, 2] == inst_id).astype(np.float32)

        nocs = decode_nocs_coord(img_path + "_coord.png", self.mug_meta,
                                 model_name, cat_id0)
        if nocs is None:
            return None
        nocs[inst_mask == 0] = 0

        # IVFC map (reference :307-331)
        ivfc = np.zeros_like(nocs)
        ivfc_mask = np.zeros_like(inst_mask)
        if self.ivfc_dir is not None:
            ipath = os.path.join(self.ivfc_dir,
                                 sub_path + f"_coor_{idx}.png")
            raw = png.imread(ipath)
            if raw is not None:
                iv = raw[:, :, (2, 1, 0)].astype(np.float32) / 255.0
                ivfc_mask = (iv[:, :, 0] != 0).astype(np.float32)
                iv[:, :, 2] = 1.0 - iv[:, :, 2]
                iv = iv - 0.5
                if cat_id0 == 5 and self.mug_meta is not None:
                    t0, s0 = self.mug_meta[model_name]
                    iv = s0 * (iv + t0)
                iv[ivfc_mask == 0] = 0
                ivfc = iv

        if model_name not in self.models:
            return None      # stale model list vs obj_models pkl
        model = self.models[model_name].astype(np.float32)
        nocs_scale = float(gts["scales"][idx])
        cat_name = (ID2CAT_CAMERA[cat_id0 + 1] if self.source == "CAMERA"
                    else CAT_NAMES[cat_id0])
        real_size, mean_size = fs_net_sizes(cat_name, model, nocs_scale)

        y1, x1, y2, x2 = gts["bboxes"][idx]
        return Record(
            image=image,
            mask=inst_mask,
            nocs_coord=nocs,
            ivfc_coord=ivfc,
            ivfc_mask=ivfc_mask,
            cam_k=cam_k,
            bbox=np.array([x1, y1, x2, y2], np.float32),
            cat_id0=int(cat_id0),
            rotation=np.asarray(gts["rotations"][idx], np.float32),
            translation=np.asarray(gts["translations"][idx], np.float32),
            nocs_scale=nocs_scale,
            real_size=real_size,
            mean_size=mean_size,
            sym=sym_info(cat_id0 + 1, mug_handle).astype(np.float32),
            model_points=model,
            is_syn=is_syn,
            img_path=img_path,
            inst_id=int(inst_id),
        )
