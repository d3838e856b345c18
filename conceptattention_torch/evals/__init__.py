"""The evals of the port: `metrics`, `datasets`, `segmentation` (the Flux
tap-point models and DAAM over Flux and the SD UNets), the ViT baseline zoo
(`baselines`, `lrp`, `textspan`), `model_zoo`, which builds every baseline
by its harness name, and the perturbation test (`perturbation`, over
`imagenet_data` and `imagenet_classes`). The package exports the metrics,
as the JAX package's does."""

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
