"""ConceptAttention in PyTorch for one NVIDIA H100.

A port of the repository's JAX package, kept beside it as the
reference: Flux DiT generation and real-image encoding, and CogVideoX video
generation, that return per-concept saliency heatmaps. Plain tensor code is
PyTorch; the TPU's Pallas kernels are hand-written CUDA kernels for Hopper
under `csrc/`, each with a plain PyTorch version in `kernels/` that runs for
CPU tensors. Module names mirror the JAX package's.
"""

from conceptattention_torch.pipeline.concept_pipeline import (
    ConceptAttentionFluxPipeline,
    ConceptAttentionPipelineOutput,
)
from conceptattention_torch.pipeline.video_pipeline import (
    VideoConceptAttentionPipeline,
    VideoConceptPipelineOutput,
)

__all__ = [
    "ConceptAttentionFluxPipeline",
    "ConceptAttentionPipelineOutput",
    "VideoConceptAttentionPipeline",
    "VideoConceptPipelineOutput",
]
