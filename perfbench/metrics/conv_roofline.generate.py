"""conv_roofline.generate: the VAE decoder's 3x3 convolution kernel's share
of its roofline in the generate cell.

The bound of every decoder conv that the program routes to its 3x3 kernel
(K2), for every image completed in the traced window, over the device time
of that kernel: each conv's operations at 989 TFLOP/s bf16 or its input,
weight and output bytes at 3.35 TB/s, whichever is larger
(`perfbench/roofline.py`). Moves images_per_s."""

from perfbench.trace import class_time

# K2, its Hopper and its generic instance.
CONV = r"conv3x3"


def read(summary):
    bound = summary["work"].get("conv_bound_s")
    busy = class_time(summary, CONV)
    if not bound or not busy:
        return None
    return 100.0 * bound / busy
