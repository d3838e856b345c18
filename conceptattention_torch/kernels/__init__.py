"""Hand-written Hopper kernels of the port, each beside its plain PyTorch version.

No kernel has a backward: every entry refuses an input that requires grad
while autograd is on (`_autograd.refuse_autograd`), on the CPU as on the
card."""


def launch_counts() -> dict:
    """{kernel: launches so far in this process} of every kernel wrapper,
    and of the Hopper instances of K1 and K2 among them (each counts the
    calls that launch its kernel on a card; the plain versions on the CPU
    count nothing)."""
    from conceptattention_torch.kernels.conv3x3 import conv3x3_same, conv3x3_same_hopper
    from conceptattention_torch.kernels.flash_saliency import (
        fused_concept_flash_attention,
        fused_concept_flash_attention_hopper,
        fused_concept_flash_attention_int8,
        fused_concept_flash_attention_paired,
    )
    from conceptattention_torch.kernels.ring_rdma import ring_attention_rdma

    return {
        "flash_saliency": fused_concept_flash_attention.launches,
        "flash_saliency_int8": fused_concept_flash_attention_int8.launches,
        "flash_saliency_paired": fused_concept_flash_attention_paired.launches,
        "conv3x3": conv3x3_same.launches,
        "ring_attention": ring_attention_rdma.launches,
        "flash_saliency (Hopper instance)": fused_concept_flash_attention_hopper.launches,
        "conv3x3 (Hopper instance)": conv3x3_same_hopper.launches,
    }
