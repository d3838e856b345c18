"""attn_roofline.<cell>: the attention kernels' share of their roofline in
a cell: the attention bound of every call completed in the traced window
(each launch's unmasked (q, k) pairs at 989 TFLOP/s, or its q, k, v and
output bytes at 3.35 TB/s, whichever is larger; `perfbench/roofline.py`)
over the device time of the attention class below. Moves the cell's
end-to-end metric."""

from perfbench.trace import class_time

# The port's fused concept-attention kernels (K1 and its D=64 RoPE
# pre-pass, K3) whatever instance runs.
ATTENTION = r"flash_saliency|rope_rows"


def read(summary):
    bound = summary["work"].get("attn_bound_s")
    busy = class_time(summary, ATTENTION)
    if not bound or not busy:
        return None
    return 100.0 * bound / busy
