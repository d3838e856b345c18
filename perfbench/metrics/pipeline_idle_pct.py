"""pipeline_idle_pct.<cell>: the share of the traced window in which the
card was idle while a pipeline call was open on the host but no sampler
loop, DiT forward or VAE pass was: the call's own phases (text states,
noise, uploads, map reductions, copies back). From the program's spans
(`perfbench/spans.py`); None where the program opens none. Moves the
cell's end-to-end metric."""

from perfbench.spans import idle_pct


def read(summary):
    return idle_pct(summary, "pipeline")
