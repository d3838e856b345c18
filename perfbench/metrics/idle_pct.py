"""idle_pct.<cell>: the share of the traced window in which no operation
ran on the card (the window less the union of the device's intervals).
Moves the cell's end-to-end metric."""


def read(summary):
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
