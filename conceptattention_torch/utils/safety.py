"""NSFW screening of generated images.

Counterpart of the JAX package's `utils/safety.py`: the
`Falconsai/nsfw_image_detection` HF image-classification pipeline, scored
against NSFW_THRESHOLD = 0.85 before an image is saved. The classifier is
gated on availability: `transformers` (and the hub's cache) are imported
only in `_load`, and where the checkpoint cannot be loaded `nsfw_score`
returns 0.0 and `unavailable_reason()` says why, so callers keep the same
control flow either way.
"""

from __future__ import annotations

from typing import Optional

NSFW_THRESHOLD = 0.85

_classifier = None
_unavailable_reason: Optional[str] = None


def classifier_available() -> bool:
    """True when the HF image-classification pipeline could be built."""
    return _load() is not None


def _load():
    global _classifier, _unavailable_reason
    if _classifier is not None or _unavailable_reason is not None:
        return _classifier
    try:
        import os

        from huggingface_hub import constants as hf_constants

        cached = os.path.isdir(os.path.join(
            hf_constants.HF_HUB_CACHE, "models--Falconsai--nsfw_image_detection"))
        # huggingface_hub's truthiness: only 1 / ON / YES / TRUE mean offline
        offline = os.environ.get("HF_HUB_OFFLINE", "").upper() in ("1", "ON", "YES", "TRUE")
        if not cached and offline:
            # Offline and not cached: skip the hub's retry loop.
            raise FileNotFoundError("Falconsai/nsfw_image_detection not in the local HF cache "
                                    "and HF_HUB_OFFLINE is set")
        from transformers import pipeline

        _classifier = pipeline("image-classification", model="Falconsai/nsfw_image_detection")
    except Exception as e:  # offline, or the package or the weights missing
        _unavailable_reason = f"{type(e).__name__}: {e}"
        _classifier = None
    return _classifier


def nsfw_score(image) -> float:
    """NSFW probability of a PIL image in [0, 1]; 0.0 (with the reason in
    `unavailable_reason()`) when the classifier is unavailable."""
    clf = _load()
    if clf is None:
        return 0.0
    for entry in clf(image):
        if entry.get("label") == "nsfw":
            return float(entry["score"])
    return 0.0


def unavailable_reason() -> Optional[str]:
    _load()
    return _unavailable_reason


def is_safe(image, threshold: float = NSFW_THRESHOLD) -> bool:
    return nsfw_score(image) < threshold
