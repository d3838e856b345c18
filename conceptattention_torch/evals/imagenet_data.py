"""ImageNet classification data for the perturbation test.

Counterpart of the JAX package's `evals/imagenet_data.py`: a folder dataset
in the ImageFolder layout `root/<class_dir>/<image>` yielding (uint8 HWC
image, class index) pairs. The class directories in sorted order define the
indices unless a `class_to_idx` mapping is given; for an ImageNet
validation split the sorted WNIDs are the ILSVRC-2012 index order, so
`imagenet_class_name(idx)` names each class. PIL is imported only when an
image is read.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from conceptattention_torch.evals.imagenet_classes import IMAGENET_CLASSES

_IMAGE_EXTS = (".jpeg", ".jpg", ".png", ".bmp", ".webp")


def imagenet_class_name(idx: int) -> str:
    return IMAGENET_CLASSES[idx]


class ImageNetFolder:
    """`root/<class_dir>/<image>` -> (np.uint8 HWC image, class index)."""

    def __init__(self, root: str, class_to_idx: Optional[Dict[str, int]] = None,
                 loader: Optional[Callable] = None):
        if not os.path.isdir(root):
            raise FileNotFoundError(f"ImageNet folder not found: {root}")
        dirs = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        if not dirs:
            raise FileNotFoundError(f"no class directories under {root}")
        self.class_to_idx = (dict(class_to_idx) if class_to_idx is not None
                             else {d: i for i, d in enumerate(dirs)})
        self.samples: List[Tuple[str, int]] = []
        for d in dirs:
            if d not in self.class_to_idx:
                continue
            cdir = os.path.join(root, d)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(_IMAGE_EXTS):
                    self.samples.append((os.path.join(cdir, fname), self.class_to_idx[d]))
        if not self.samples:
            raise FileNotFoundError(f"no images under {root}")
        self._loader = loader or self._default_loader

    @staticmethod
    def _default_loader(path: str) -> np.ndarray:
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, int]:
        path, idx = self.samples[i]
        return self._loader(path), idx

    @staticmethod
    def available(root: str) -> bool:
        try:
            ImageNetFolder(root)
            return True
        except FileNotFoundError:
            return False
