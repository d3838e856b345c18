"""conv_roofline.encode: the VAE encoder's convolutions' share of their
roofline in the encode cell.

The program encodes in float32 with TF32 off through `F.conv2d` (cuDNN),
so the bound of every encoder conv of every image completed in the traced
window is its operations at 67 TFLOP/s (float32 outside the tensor cores)
or its float32 input, weight and output bytes at 3.35 TB/s, whichever is
larger (`perfbench/roofline.py`), over the device time of the conv class
below. Moves encoded_images_per_s."""

from perfbench.trace import class_time

# cuDNN's float32 forward convolutions.
CONV = r"(?i)conv|fprop|winograd"


def read(summary):
    bound = summary["work"].get("conv_bound_s")
    busy = class_time(summary, CONV)
    if not bound or not busy:
        return None
    return 100.0 * bound / busy
