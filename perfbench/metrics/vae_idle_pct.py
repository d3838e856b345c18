"""vae_idle_pct.<cell>: the share of the traced window in which the card
was idle while a VAE encode or decode was open on the host. From the
program's spans (`perfbench/spans.py`); None where the program opens none.
Moves the cell's end-to-end metric."""

from perfbench.spans import idle_pct


def read(summary):
    return idle_pct(summary, "vae")
