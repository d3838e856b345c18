"""The eval harnesses, run as modules:
`python -m conceptattention_torch.experiments.imagenet_segmentation`,
`... .voc_single_class`, `... .voc_multi_class`."""
