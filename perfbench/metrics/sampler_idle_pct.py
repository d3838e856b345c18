"""sampler_idle_pct.<cell>: the share of the traced window in which the
card was idle while a sampler loop was open on the host between its DiT
forwards: the step's update and, for video, the per-step map reduction.
From the program's spans (`perfbench/spans.py`); None where the program
opens none. Moves the cell's end-to-end metric."""

from perfbench.spans import idle_pct


def read(summary):
    return idle_pct(summary, "sampler")
