"""mfu.<cell>: the whole step's share of one H100's bf16 peak in a cell:
the model operations of every call completed in the traced window, counted
from shapes (`perfbench/roofline.py`), over the window, at 989 TFLOP/s.
Moves the cell's end-to-end metric."""

from perfbench.roofline import PEAK_BF16


def read(summary):
    flops = summary["work"].get("flops")
    if not flops:
        return None
    return 100.0 * flops / summary["window_s"] / PEAK_BF16
