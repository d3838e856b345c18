"""The kernels' refusal of autograd.

Every kernel wrapper writes its result into a fresh buffer that has no
`grad_fn`, so a forward through a kernel under autograd would drop every
gradient that passes through it without an error. No kernel has a backward
(the JAX package's Pallas kernels have no `custom_vjp` either): training runs
the plain, differentiable attention (`backend="sdpa"`). So each entry refuses
such inputs, on the CPU as on the card, rather than switch to its plain
version and hide the kernel.
"""

from __future__ import annotations

import torch


def _tensors(items):
    for x in items:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from _tensors(x)


def refuse_autograd(kernel: str, *inputs) -> None:
    """Raise when autograd is on and any tensor among `inputs` (or in a list
    or tuple of them, such as the ring's shards) requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in _tensors(inputs)):
        raise RuntimeError(
            f"{kernel} has no backward: its output would carry no gradient. Run the forward "
            "under torch.no_grad() or torch.inference_mode(), or train on the plain "
            "differentiable path, backend=\"sdpa\" (ConceptAttentionSpec(backend=\"sdpa\"))"
        )
