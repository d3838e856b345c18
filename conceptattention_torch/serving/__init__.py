"""Serving: the micro-batched HTTP generation daemon.

`MicroBatcher` coalesces concurrent requests into batched pipeline calls on
one worker thread; `ConceptAttentionServer` is the stdlib HTTP front end.

Run a server: ``python -m conceptattention_torch.serving --model flux-schnell``.
"""

from conceptattention_torch.serving.batcher import (
    BatcherStats,
    MicroBatcher,
    QueueFullError,
    next_bucket,
)
from conceptattention_torch.serving.server import (
    ConceptAttentionServer,
    EncodeRequest,
    GenerateRequest,
    LoraSwapRequest,
    RequestError,
    VideoGenerateRequest,
)

__all__ = [
    "BatcherStats",
    "MicroBatcher",
    "QueueFullError",
    "next_bucket",
    "ConceptAttentionServer",
    "EncodeRequest",
    "GenerateRequest",
    "LoraSwapRequest",
    "RequestError",
    "VideoGenerateRequest",
]
