#!/usr/bin/env bash
# The baseline zoo over the port's ImageNet-Segmentation harness. Checkpoints
# load from environment variables (CHEFER_VITB16, DINO_VITB16,
# OPENCLIP_VITH14; see conceptattention_torch/evals/model_zoo.py); ARGS can
# add --random_weights for a smoke run without them. Run from the
# repository root.
set -euo pipefail

MAT_PATH=${MAT_PATH:-/data/gtsegs_ijcv.mat}
N=${N:-100}
ARGS=${ARGS:-}
RUN="python -m conceptattention_torch.experiments.imagenet_segmentation --mat_path $MAT_PATH --num_images $N $ARGS --segmentation_model"

for m in CheferLRP CheferRollout CheferLastLayerAttention \
         CheferAttentionGradCAM CheferTransformerAttribution \
         CheferFullLRP CheferLastLayerLRP; do
  $RUN "$m"
done
$RUN DINO
# DAAMSD2 and DAAMSDXL wait for the Stable Diffusion UNet (ROADMAP.md Queue 1
# item 7b); the harness refuses them until then.
$RUN TextSpan
