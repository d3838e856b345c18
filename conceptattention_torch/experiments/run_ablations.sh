#!/usr/bin/env bash
# Ablation sweeps over the port's ImageNet-Segmentation harness: the
# representation space, the softmax normalisation, the blur, the layer range,
# the concept cross / self attention and the 14x14 downscale are flags of
# `python -m conceptattention_torch.experiments.imagenet_segmentation`.
# Run from the repository root; ARGS adds flags to every run (on the CPU:
# ARGS="--device cpu --dtype float32").
set -euo pipefail

MAT_PATH=${MAT_PATH:-/data/gtsegs_ijcv.mat}
N=${N:-100}
ARGS=${ARGS:-}
RUN="python -m conceptattention_torch.experiments.imagenet_segmentation --mat_path $MAT_PATH --num_images $N $ARGS"

# Representation-space ablation (raw output / cross-attention / value space)
$RUN --tap output
$RUN --tap cross_attention
$RUN --tap value

# Softmax-normalization ablation
$RUN --tap output --softmax

# Blur ablation
$RUN --tap output --apply_blur

# Layer-range ablation
$RUN --tap output --layers 0 1 2 3
$RUN --tap output --layers 14 15 16 17

# Cross/self concept-attention ablation
$RUN --tap output --no-concept_self_attention
$RUN --tap output --no-concept_cross_attention --concept_self_attention

# The 14x14 downscale test (the ViT baselines' map granularity)
$RUN --tap output --downscale 14
