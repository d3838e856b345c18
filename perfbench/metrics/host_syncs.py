"""host_syncs.<cell>: the host's waits on the card (`cudaStreamSynchronize`,
`cudaDeviceSynchronize`, `cudaEventSynchronize`; every blocking copy and
`.item()` ends in one) that start inside a pipeline call, per call whole in
the traced window. From the program's call spans (`perfbench/spans.py`);
None where the program opens none. Moves the cell's end-to-end metric."""

from perfbench.spans import host_syncs


def read(summary):
    return host_syncs(summary)
