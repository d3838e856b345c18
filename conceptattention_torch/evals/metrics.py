"""Zero-shot segmentation metrics: pixel accuracy, histogram IoU, AP.

Counterpart of the JAX package's `evals/metrics.py`:
  - pixel accuracy counts predictions over labelled (target >= 0) pixels;
  - IoU is histogram-based over class bins 1..nclass after a +1 shift;
  - AP is the average precision of the flattened soft prediction against the
    one-hot target, with the step-wise interpolation sklearn uses, NaNs
    mapped to 0.
Pixel accuracy and IoU run in the host library of `native.py`, which raises
where it cannot be built; AP is numpy. All of it runs on the host over small
mask arrays.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from conceptattention_torch import native


def batch_pix_accuracy(predict: np.ndarray, target: np.ndarray) -> Tuple[int, int]:
    """(correct, labelled) pixel counts of integer class maps."""
    return native.pix_acc(predict, target)


def batch_intersection_union(
    predict: np.ndarray, target: np.ndarray, nclass: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-class (intersection, union) histograms over bins 1..nclass."""
    return native.hist_iou(predict, target, nclass)


def average_precision(target: np.ndarray, predict: np.ndarray) -> float:
    """Binary average precision: the area under the precision-recall curve
    with one point per distinct score."""
    target = np.asarray(target).reshape(-1).astype(np.float64)
    predict = np.nan_to_num(np.asarray(predict).reshape(-1).astype(np.float64))
    n_pos = target.sum()
    if n_pos == 0:
        return 0.0
    order = np.argsort(-predict, kind="stable")
    target = target[order]
    scores = predict[order]
    tp = np.cumsum(target)
    fp = np.cumsum(1.0 - target)
    precision = tp / np.maximum(tp + fp, 1e-12)
    recall = tp / n_pos
    idx = np.concatenate([np.where(np.diff(scores))[0], [len(scores) - 1]])
    precision, recall = precision[idx], recall[idx]
    recall_prev = np.concatenate([[0.0], recall[:-1]])
    return float(np.sum((recall - recall_prev) * precision))


def get_ap_scores(predict: np.ndarray, target: np.ndarray, ignore_index: int = -1) -> List[float]:
    """Per-sample AP: predict [B, K, H, W] soft maps, target [B, H, W] class
    indices, scored against the K-channel one-hot over the pixels whose
    target is not `ignore_index`."""
    out = []
    for pred, tgt in zip(np.asarray(predict), np.asarray(target)):
        one_hot = np.zeros_like(pred)
        np.put_along_axis(one_hot, np.clip(tgt, 0, None).astype(np.int64)[None], 1.0, axis=0)
        valid = np.broadcast_to(tgt[None], pred.shape).reshape(-1) != ignore_index
        p = np.nan_to_num(pred.reshape(-1)[valid])
        out.append(float(np.nan_to_num(average_precision(one_hot.reshape(-1)[valid], p))))
    return out
