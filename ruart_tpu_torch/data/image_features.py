"""Image region-feature loading (conf-gated ``img_feature`` paths) — copy
of ``ruart_tpu/data/image_features.py``.

Two sources, mirroring the reference:

* bottom-up-attention HDF5 packs (36 regions x 2048 + spatial boxes),
  keyed by image id (`SDNetTrainer.load_image_features:178-207`);
* per-image ``<name>.npy`` + ``<name>_info.npy`` files with pixel boxes
  normalized by image size (`VQA_Dataset.get_image_feature:154-207`).

Both emit (features [R, D], spatials [R, 8]) with the 4-corner-from-xyxy
spatial layout the position attention expects (`VQA_Dataset.py:160-168`).
The HDF5 provider imports ``h5py`` when it is built; without it, it raises
ImportError naming ``h5py`` (``img_fea_folder`` selects the npy provider,
which needs only numpy).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional, Tuple

import numpy as np


def xyxy_to_quad8(bbox: np.ndarray) -> np.ndarray:
    """[R, 4] (x0, y0, x1, y1) -> [R, 8] corner quad in the reference's
    order (`VQA_Dataset.py:160-168`)."""
    x0, y0, x1, y1 = bbox[:, 0], bbox[:, 1], bbox[:, 2], bbox[:, 3]
    return np.stack([x0, y0, x1, y0, x1, y1, x0, y1], axis=1).astype(np.float32)


class HDF5ImageFeatures:
    """train36/val36 bottom-up packs merged into one id->row table."""

    def __init__(self, folder: str):
        try:
            import h5py
        except ImportError as e:
            raise ImportError(
                "img_feature: the HDF5 image-feature provider needs h5py, "
                "which is not installed (img_fea_folder selects the npy "
                "provider)"
            ) from e

        with open(os.path.join(folder, "train36_imgid2idx.pkl"), "rb") as f:
            train_idx: Dict = pickle.load(f)
        with open(os.path.join(folder, "val36_imgid2idx.pkl"), "rb") as f:
            val_idx: Dict = pickle.load(f)
        with h5py.File(os.path.join(folder, "train36.hdf5"), "r") as hf:
            train_feat = np.asarray(hf["image_features"])
            train_spa = np.asarray(hf["spatial_features"])
        with h5py.File(os.path.join(folder, "val36.hdf5"), "r") as hf:
            val_feat = np.asarray(hf["image_features"])
            val_spa = np.asarray(hf["spatial_features"])
        n_train = train_feat.shape[0]
        self.id2idx = dict(train_idx)
        for k, v in val_idx.items():
            assert k not in self.id2idx
            self.id2idx[k] = v + n_train
        self.features = np.concatenate([train_feat, val_feat], axis=0)
        self.spatials = np.concatenate([train_spa, val_spa], axis=0)

    def get(self, image_id) -> Tuple[np.ndarray, np.ndarray]:
        idx = self.id2idx[image_id]
        feat = self.features[idx].astype(np.float32)
        bbox = self.spatials[idx][:, :4].astype(np.float32)
        return feat, xyxy_to_quad8(bbox)


class NpyImageFeatures:
    """Per-image <img>.npy / <img>_info.npy features with box
    normalization by image dimensions; small LRU-ish cache."""

    def __init__(self, folder: str, split_subdir: bool = True):
        self.folder = folder
        self.split_subdir = split_subdir
        self._cache: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}

    def get(self, image_path: str, mode: str = "train"):
        if image_path in self._cache:
            return self._cache[image_path]
        stem = "".join(image_path.split(".")[:-1]) or image_path
        folder = self.folder
        if self.split_subdir:
            folder = os.path.join(folder, "test" if mode == "test" else "train")
        feat = np.load(os.path.join(folder, stem + ".npy")).astype(np.float32)
        info = np.load(
            os.path.join(folder, stem + "_info.npy"), allow_pickle=True
        ).item()
        bbox = np.asarray(info["bbox"], dtype=np.float32)
        bbox[:, 0] /= info["image_width"]
        bbox[:, 2] /= info["image_width"]
        bbox[:, 1] /= info["image_height"]
        bbox[:, 3] /= info["image_height"]
        out = (feat, xyxy_to_quad8(bbox))
        if len(self._cache) < 512:
            self._cache[image_path] = out
        return out


def load_image_features(opt) -> Optional[object]:
    """Trainer hook (`SDNetTrainer.load_image_features:178-207`): returns a
    provider with .get(...) or None when img_feature is off."""
    if "img_feature" not in opt:
        return None
    if "img_fea_folder" in opt:
        return NpyImageFeatures(str(opt["img_fea_folder"]))
    folder = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(opt["FEATURE_FOLDER"]))),
        "image_features",
    )
    return HDF5ImageFeatures(folder)
