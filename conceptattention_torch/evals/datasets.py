"""Segmentation eval datasets: ImageNet-Segmentation and PascalVOC.

Counterpart of the JAX package's `evals/datasets.py`. Neither dataset is in
the repository; each loader is gated on its files being present
(`available()`), and `h5py` and PIL are imported only where a loader reads
files.
"""

from __future__ import annotations

import csv
import os
from typing import List, Optional, Tuple

import numpy as np

from conceptattention_torch.utils.plotting import upsample_nearest

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


class ImagenetSegmentation:
    """gtsegs_ijcv.mat -> (image [H, W, 3] uint8, binary mask [H, W], name).

    The first use converts the .mat (HDF5 object references) into a PNG and
    CSV cache directory beside it, which later uses read."""

    def __init__(self, mat_path: str, cache_dir: Optional[str] = None):
        self.mat_path = mat_path
        self.cache_dir = cache_dir or os.path.join(
            os.path.dirname(mat_path) or ".", "imagenet_seg_cache"
        )
        self.index_csv = os.path.join(self.cache_dir, "index.csv")
        if not os.path.exists(self.index_csv):
            self._preprocess()
        with open(self.index_csv) as f:
            self.rows = list(csv.DictReader(f))

    @staticmethod
    def available(mat_path: str) -> bool:
        return os.path.exists(mat_path)

    def _preprocess(self) -> None:
        import h5py
        import PIL.Image

        os.makedirs(self.cache_dir, exist_ok=True)
        rows = []
        with h5py.File(self.mat_path, "r") as f:
            images_refs = f["value"]["img"]
            gts_refs = f["value"]["gt"]
            names_refs = f["value"]["name"]
            flat = images_refs.ndim == 1
            n = images_refs.shape[0] if flat else images_refs.shape[1]
            for i in range(n):
                img_ref = images_refs[i] if flat else images_refs[0, i]
                gt_ref = gts_refs[i] if gts_refs.ndim == 1 else gts_refs[0, i]
                name_ref = names_refs[i] if names_refs.ndim == 1 else names_refs[0, i]
                img = np.asarray(f[img_ref]).transpose(2, 1, 0)  # -> HWC
                gt = np.asarray(f[f[gt_ref][0, 0]]).T
                name = "".join(chr(c) for c in np.asarray(f[name_ref]).ravel())
                img_path = os.path.join(self.cache_dir, f"{i:05d}.png")
                mask_path = os.path.join(self.cache_dir, f"{i:05d}_mask.png")
                PIL.Image.fromarray(img.astype(np.uint8)).save(img_path)
                PIL.Image.fromarray((gt > 0).astype(np.uint8) * 255).save(mask_path)
                rows.append({"image": img_path, "mask": mask_path, "name": name})
        with open(self.index_csv, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=["image", "mask", "name"])
            writer.writeheader()
            writer.writerows(rows)

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray, str]:
        import PIL.Image

        row = self.rows[idx]
        img = np.asarray(PIL.Image.open(row["image"]).convert("RGB"))
        mask = (np.asarray(PIL.Image.open(row["mask"])) > 0).astype(np.int64)
        return img, mask, row["name"]


def _voc_split_ids(voc_root: str, split: str) -> List[str]:
    with open(os.path.join(voc_root, "ImageSets", "Segmentation", f"{split}.txt")) as f:
        return [line.strip() for line in f if line.strip()]


def _voc_mask(voc_root: str, image_id: str) -> np.ndarray:
    import PIL.Image

    return np.asarray(PIL.Image.open(os.path.join(voc_root, "SegmentationClass", f"{image_id}.png")))


def _voc_image(voc_root: str, image_id: str) -> np.ndarray:
    import PIL.Image

    path = os.path.join(voc_root, "JPEGImages", f"{image_id}.jpg")
    return np.asarray(PIL.Image.open(path).convert("RGB"))


def _voc_foreground(mask: np.ndarray) -> np.ndarray:
    """The VOC class ids present in a mask, without background (0) and the
    border / ignore label (255)."""
    classes = np.unique(mask)
    return classes[(classes > 0) & (classes < 255)]


def _voc_available(voc_root: str) -> bool:
    return os.path.exists(os.path.join(voc_root, "ImageSets", "Segmentation"))


class VOCSingleClassSegmentation:
    """PascalVOC split images that hold exactly one foreground class ->
    (image, class mask, class name)."""

    available = staticmethod(_voc_available)

    def __init__(self, voc_root: str, split: str = "val"):
        self.voc_root = voc_root
        self.items: List[Tuple[str, int]] = []
        for image_id in _voc_split_ids(voc_root, split):
            fg = _voc_foreground(_voc_mask(voc_root, image_id))
            if len(fg) == 1:
                self.items.append((image_id, int(fg[0])))

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray, str]:
        image_id, class_idx = self.items[idx]
        return (_voc_image(self.voc_root, image_id), _voc_mask(self.voc_root, image_id),
                VOC_CLASSES[class_idx - 1])


class VOCMultiClassSegmentation:
    """Every PascalVOC split image -> (image, class mask, names of the
    foreground classes present)."""

    available = staticmethod(_voc_available)

    def __init__(self, voc_root: str, split: str = "val"):
        self.voc_root = voc_root
        self.ids = _voc_split_ids(voc_root, split)

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray, List[str]]:
        image_id = self.ids[idx]
        mask = _voc_mask(self.voc_root, image_id)
        present = [VOC_CLASSES[c - 1] for c in _voc_foreground(mask)]
        return _voc_image(self.voc_root, image_id), mask, present


def resize_mask_nearest(mask: np.ndarray, height: int, width: int) -> np.ndarray:
    """Nearest-neighbour resize of a [h, w] label map (row i reads row
    i * h // height), keeping its dtype."""
    return upsample_nearest(mask, height, width)
