"""Hand-written Hopper kernels of the port, each beside its plain PyTorch version.

No kernel has a backward: every entry refuses an input that requires grad
while autograd is on (`_autograd.refuse_autograd`), on the CPU as on the
card."""


def _counters():
    """(name, holder, attribute, index or None) of every launch count."""
    from conceptattention_torch.kernels.conv3x3 import (
        conv3x3_same,
        conv3x3_same_generic,
        conv3x3_same_hopper,
    )
    from conceptattention_torch.kernels.flash_saliency import (
        FLASH_D128_INSTANCES,
        fused_concept_flash_attention,
        fused_concept_flash_attention_hopper,
        fused_concept_flash_attention_int8,
        fused_concept_flash_attention_int8_hopper,
        fused_concept_flash_attention_paired,
    )
    from conceptattention_torch.kernels.layer_norm import layer_norm, qk_layer_norm
    from conceptattention_torch.kernels.ring_rdma import ring_attention_rdma

    return [
        ("flash_saliency", fused_concept_flash_attention, "launches", None),
        ("flash_saliency_int8", fused_concept_flash_attention_int8, "launches", None),
        ("flash_saliency_paired", fused_concept_flash_attention_paired, "launches", None),
        ("conv3x3", conv3x3_same, "launches", None),
        ("ring_attention", ring_attention_rdma, "launches", None),
        ("flash_saliency (Hopper instance)", fused_concept_flash_attention_hopper, "launches",
         None),
        ("conv3x3 (Hopper instance)", conv3x3_same_hopper, "launches", None),
        *((f"flash_saliency (Hopper D=128 instance {i} {name})",
           fused_concept_flash_attention_hopper, "instance_launches", i)
          for i, name in enumerate(FLASH_D128_INSTANCES)),
        ("flash_saliency_int8 (Hopper instance)", fused_concept_flash_attention_int8_hopper,
         "launches", None),
        ("conv3x3 (generic instance)", conv3x3_same_generic, "launches", None),
        ("ring_attention (steps)", ring_attention_rdma, "step_launches", None),
        ("ring_attention (Hopper steps)", ring_attention_rdma, "hopper_step_launches", None),
        ("layer_norm", layer_norm, "launches", None),
        ("layer_norm (q/k)", qk_layer_norm, "launches", None),
    ]


def launch_counts() -> dict:
    """{kernel: launches so far in this process} of every kernel wrapper,
    and of the instances among them: K1's and K1b's Hopper instances (K1's
    at head dim 128 one by one), K2's Hopper and generic ones, K4's step
    launches, and the video block's LayerNorm and q/k LayerNorm (each counts
    the calls that launch its kernel on a card; the plain versions on the
    CPU count nothing)."""
    return {name: getattr(holder, attr) if i is None else getattr(holder, attr)[i]
            for name, holder, attr, i in _counters()}


def add_launches(delta: dict) -> None:
    """Add {kernel: launches} (keys of `launch_counts`) to the counts: what
    a replayed CUDA graph launched, which no wrapper's Python counted."""
    for name, holder, attr, i in _counters():
        n = delta.get(name, 0)
        if not n:
            continue
        if i is None:
            setattr(holder, attr, getattr(holder, attr) + n)
        else:
            getattr(holder, attr)[i] += n
