#!/usr/bin/env bash
# The baseline zoo over the port's ImageNet-Segmentation harness. Checkpoints
# load from environment variables (CHEFER_VITB16, DINO_VITB16, SD2_UNET,
# SDXL_UNET, OPENCLIP_VITH14; see conceptattention_torch/evals/model_zoo.py);
# ARGS can add --random_weights for a smoke run without them. Run from the
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
$RUN DAAMSD2
$RUN DAAMSDXL
$RUN TextSpan
