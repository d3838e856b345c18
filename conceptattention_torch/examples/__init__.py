"""Quickstarts of the port, one script each, counterparts of the JAX
package's `examples/`: run them as `python -m
conceptattention_torch.examples.<name>` or as plain scripts. Each runs on the
card by default; `--device cpu` (with `--tiny` where the model is
flux-schnell) runs it on the CPU."""
