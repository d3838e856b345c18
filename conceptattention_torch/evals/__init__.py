"""Zero-shot segmentation evals of the port: `metrics`, `datasets`,
`segmentation` (the Flux tap-point models)."""

from conceptattention_torch.evals.metrics import (
    average_precision,
    batch_intersection_union,
    batch_pix_accuracy,
    get_ap_scores,
)

__all__ = [
    "batch_pix_accuracy",
    "batch_intersection_union",
    "average_precision",
    "get_ap_scores",
]
