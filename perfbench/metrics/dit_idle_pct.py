"""dit_idle_pct.<cell>: the share of the traced window in which the card
was idle while a DiT forward was open on the host: the forward's own
launches did not keep it fed. From the program's spans
(`perfbench/spans.py`); None where the program opens none. Moves the
cell's end-to-end metric."""

from perfbench.spans import idle_pct


def read(summary):
    return idle_pct(summary, "dit")
