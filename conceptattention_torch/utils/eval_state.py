"""Resumable running sums of the binary-segmentation eval harnesses.

Counterpart of the JAX package's `utils/eval_state.py`: pixAcc / mIoU / mAP
sums and the next image's index, saved as JSON after every image so that a
killed run continues from the next image. The save is atomic (a temporary
file, then `os.replace`), so a kill mid-write leaves the previous state.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np


class SegEvalState:
    """Running {correct, labeled, inter, union, ap_scores, next_index}."""

    def __init__(self, nclass: int = 2):
        self.correct = 0
        self.labeled = 0
        self.inter = np.zeros(nclass, np.float64)
        self.union = np.zeros(nclass, np.float64)
        self.ap_scores: list = []
        self.next_index = 0

    @classmethod
    def load(cls, state_path: Optional[str], nclass: int = 2) -> "SegEvalState":
        """A fresh state, resumed from `state_path` when that file exists."""
        st = cls(nclass)
        if state_path and os.path.exists(state_path):
            with open(state_path) as f:
                d = json.load(f)
            st.next_index = d["next_index"]
            st.correct, st.labeled = d["correct"], d["labeled"]
            st.inter = np.asarray(d["inter"], np.float64)
            st.union = np.asarray(d["union"], np.float64)
            st.ap_scores = list(d["ap_scores"])
            print(f"resuming from image {st.next_index} ({state_path})", flush=True)
        return st

    def update(self, correct, labeled, inter, union, ap_scores: Sequence[float],
               next_index: int) -> None:
        self.correct += correct
        self.labeled += labeled
        self.inter = self.inter + np.asarray(inter, np.float64)
        self.union = self.union + np.asarray(union, np.float64)
        self.ap_scores.extend(ap_scores)
        self.next_index = next_index

    @property
    def pix_acc(self) -> float:
        return self.correct / max(self.labeled, 1)

    @property
    def miou(self) -> float:
        return float(np.mean(self.inter / np.maximum(self.union, 1)))

    @property
    def mean_ap(self) -> float:
        return float(np.mean(self.ap_scores)) if self.ap_scores else float("nan")

    def summary(self) -> str:
        return f"pixAcc {self.pix_acc:.4f} mIoU {self.miou:.4f} mAP {self.mean_ap:.4f}"

    def save(self, state_path: Optional[str]) -> None:
        if not state_path:
            return
        tmp = state_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({
                "next_index": self.next_index,
                "correct": int(self.correct),
                "labeled": int(self.labeled),
                "inter": self.inter.tolist(),
                "union": self.union.tolist(),
                "ap_scores": [float(a) for a in self.ap_scores],
            }, f)
        os.replace(tmp, state_path)
