"""conv_roofline.<cell>: the float32 convolutions' share of their roofline,
for a cell whose own reader is not there (conv_roofline.video_decode: the
CogVideoX 3D VAE decoder's).

The program runs these convolutions in float32 with TF32 off on cuDNN
(`F.conv3d`, `F.conv2d`), so the bound of every conv of every call
completed in the traced window is its operations at 67 TFLOP/s (float32
outside the tensor cores) or its float32 input, weight and output bytes
at 3.35 TB/s, whichever is larger (the driver's `conv_bound_s`), over the
device time of the conv class below. Moves the cell's throughput."""

from perfbench.trace import class_time

# cuDNN's float32 forward convolutions.
CONV = r"(?i)conv|fprop|winograd"


def read(summary):
    bound = summary["work"].get("conv_bound_s")
    busy = class_time(summary, CONV)
    if not bound or not busy:
        return None
    return 100.0 * bound / busy
