"""The CLIP TextSpan segmentation baselines.

Counterpart of the JAX package's `evals/textspan.py`: decompose the CLS
representation into per-token contributions, project each into the shared
image-text space and score it against per-concept text embeddings, each the
renormalised mean of 80 normalised prompt-template embeddings.
  - `CLIPTextSpanSegmentationModel`: the last attention layer of a ViT
    (`models/vit.py`), heads summed after each head's value and output
    projection, scored against any `TextEncoders`' CLIP vectors;
  - `OpenCLIPTextSpanSegmentationModel`: the full PRS decomposition of an
    open_clip tower (`models/clip_vit.prs_decomposition`) against its own
    text tower, on raw [0, 1] pixels (no mean / std normalisation).
Without a BPE vocabulary the text tower reads `_hash_tokenize`'s ids, the
same as the JAX package's (crc32 of each word).
"""

from __future__ import annotations

import zlib
from typing import List, Sequence

import numpy as np
import torch

from conceptattention_torch.evals.baselines import _preprocess, resize_bilinear
from conceptattention_torch.evals.segmentation import SegmentationModel
from conceptattention_torch.models import clip_vit
from conceptattention_torch.models.flux.params import layer
from conceptattention_torch.models.vit import ViTConfig, _linear, _ln, embed, vit_block
from conceptattention_torch.pipeline.concept_pipeline import _full_f32
from conceptattention_torch.utils.images import as_float01_chw

# OpenAI's 80 ImageNet prompt templates (public data from the CLIP repo).
PROMPT_TEMPLATES = (
    "a bad photo of a {}.",
    "a photo of many {}.",
    "a sculpture of a {}.",
    "a photo of the hard to see {}.",
    "a low resolution photo of the {}.",
    "a rendering of a {}.",
    "graffiti of a {}.",
    "a bad photo of the {}.",
    "a cropped photo of the {}.",
    "a tattoo of a {}.",
    "the embroidered {}.",
    "a photo of a hard to see {}.",
    "a bright photo of a {}.",
    "a photo of a clean {}.",
    "a photo of a dirty {}.",
    "a dark photo of the {}.",
    "a drawing of a {}.",
    "a photo of my {}.",
    "the plastic {}.",
    "a photo of the cool {}.",
    "a close-up photo of a {}.",
    "a black and white photo of the {}.",
    "a painting of the {}.",
    "a painting of a {}.",
    "a pixelated photo of the {}.",
    "a sculpture of the {}.",
    "a bright photo of the {}.",
    "a cropped photo of a {}.",
    "a plastic {}.",
    "a photo of the dirty {}.",
    "a jpeg corrupted photo of a {}.",
    "a blurry photo of the {}.",
    "a photo of the {}.",
    "a good photo of the {}.",
    "a rendering of the {}.",
    "a {} in a video game.",
    "a photo of one {}.",
    "a doodle of a {}.",
    "a close-up photo of the {}.",
    "a photo of a {}.",
    "the origami {}.",
    "the {} in a video game.",
    "a sketch of a {}.",
    "a doodle of the {}.",
    "a origami {}.",
    "a low resolution photo of a {}.",
    "the toy {}.",
    "a rendition of the {}.",
    "a photo of the clean {}.",
    "a photo of a large {}.",
    "a rendition of a {}.",
    "a photo of a nice {}.",
    "a photo of a weird {}.",
    "a blurry photo of a {}.",
    "a cartoon {}.",
    "art of a {}.",
    "a sketch of the {}.",
    "a embroidered {}.",
    "a pixelated photo of a {}.",
    "itap of the {}.",
    "a jpeg corrupted photo of the {}.",
    "a good photo of a {}.",
    "a plushie {}.",
    "a photo of the nice {}.",
    "a photo of the small {}.",
    "a photo of the weird {}.",
    "the cartoon {}.",
    "art of the {}.",
    "a drawing of the {}.",
    "a photo of the large {}.",
    "a black and white photo of a {}.",
    "the plushie {}.",
    "a dark photo of a {}.",
    "itap of a {}.",
    "graffiti of the {}.",
    "a toy {}.",
    "itap of my {}.",
    "a photo of a cool {}.",
    "a photo of a small {}.",
    "a tattoo of the {}.",
)


def _normalized_mean(embs: np.ndarray) -> np.ndarray:
    """Each row normalised, the mean, renormalised."""
    embs = embs / (np.linalg.norm(embs, axis=-1, keepdims=True) + 1e-8)
    e = embs.mean(axis=0)
    return e / (np.linalg.norm(e) + 1e-8)


def head_token_decomposition(params, cfg: ViTConfig, images: torch.Tensor) -> torch.Tensor:
    """[B, tokens, D]: each token's contribution (CLS included) to the CLS
    residual through the last attention layer, heads summed after each
    head's value and output projection."""
    x = embed(params, cfg, images)
    for i in range(cfg.depth - 1):
        x, _ = vit_block(layer(params["blocks"], i), x, cfg.num_heads)
    last = layer(params["blocks"], cfg.depth - 1)
    h_in = _ln(x, last["norm1"])
    b, n, d = h_in.shape
    hd = d // cfg.num_heads
    qkv = _linear(h_in, last["attn"]["qkv"]).reshape(b, n, 3, cfg.num_heads, hd)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    probs = torch.softmax(logits / (hd**0.5), dim=-1)
    # token t via head h: A_h[cls, t] * (v_h[t] @ W_O[h])
    vproj = torch.einsum("bhtd,hde->bhte", v, last["attn"]["proj"]["w"].reshape(
        cfg.num_heads, hd, d))
    return torch.einsum("bht,bhte->bte", probs[:, :, 0, :], vproj)


class CLIPTextSpanSegmentationModel(SegmentationModel):
    """Saliency from the text-projected last-layer token decomposition of a
    ViT, against a `TextEncoders`' CLIP vectors."""

    def __init__(self, params, cfg: ViTConfig, text_encoders, embed_proj=None):
        """embed_proj: an optional [D, embed_dim] image-to-shared-space
        projection (identity when the text vectors have the ViT's width)."""
        self.params = params
        self.cfg = cfg
        self.text_encoders = text_encoders
        self.embed_proj = embed_proj
        self.device = params["cls_token"].device
        self._text_cache = {}

    def _text_embedding(self, concept: str) -> np.ndarray:
        if concept not in self._text_cache:
            embs = self.text_encoders.encode_clip([t.format(concept) for t in PROMPT_TEMPLATES])
            self._text_cache[concept] = _normalized_mean(np.asarray(embs, np.float32))
        return self._text_cache[concept]

    @_full_f32()
    def decomposition(self, x: torch.Tensor) -> np.ndarray:
        """Preprocessed image [1, 3, S, S] -> the patch tokens' contributions
        [P, D] (projected when `embed_proj` is set), on the host in f32."""
        contrib = head_token_decomposition(self.params, self.cfg, x)[0, 1:]
        if self.embed_proj is not None:
            contrib = contrib @ self.embed_proj
        return contrib.float().cpu().numpy()

    def segment_individual_image(self, image, concepts: List[str], caption: str, **kw):
        contrib = self.decomposition(_preprocess(image, self.cfg.image_size, self.device))
        g = self.cfg.grid
        maps = [(contrib @ self._text_embedding(c)[: contrib.shape[-1]]).reshape(g, g)
                for c in concepts]
        return np.stack(maps), None


class OpenCLIPTextSpanSegmentationModel(SegmentationModel):
    """The TextSpan baseline on an open_clip tower: the full PRS
    decomposition scored against 80-template concept embeddings of its own
    text tower.

    `params` = {"visual": ..., "text": ...} from `clip_vit.convert_open_clip_
    visual` / `_text` or `clip_vit.init_open_clip_params`, on the model's
    device. `tokenize(texts) -> [B, context] int array` defaults to
    `_hash_tokenize`."""

    def __init__(self, params, vis_cfg, txt_cfg, tokenize=None):
        self.params = params
        self.vis_cfg = vis_cfg
        self.txt_cfg = txt_cfg
        self.tokenize = tokenize or _hash_tokenize(txt_cfg)
        self.device = params["visual"]["cls_token"].device
        self._concept_cache = {}

    @torch.inference_mode()
    @_full_f32()
    def concept_vectors(self, concepts: List[str]) -> np.ndarray:
        """[embed_dim, C]: each concept's normalised template mean, cached
        per concept (the eval loop reuses one vocabulary)."""
        for concept in concepts:
            if concept not in self._concept_cache:
                ids = self.tokenize([t.format(concept) for t in PROMPT_TEMPLATES])
                ids = torch.as_tensor(np.asarray(ids), dtype=torch.long, device=self.device)
                emb = clip_vit.text_encode(self.params["text"], self.txt_cfg, ids)
                self._concept_cache[concept] = _normalized_mean(emb.float().cpu().numpy())
        return np.stack([self._concept_cache[c] for c in concepts], axis=1)

    @torch.inference_mode()
    @_full_f32()
    def collapsed(self, image) -> np.ndarray:
        """The patch tokens' PRS contributions [P, embed_dim] on the host:
        the image resized to the tower's size (raw [0, 1] pixels, the
        reference's Resize + ToTensor)."""
        x = torch.from_numpy(as_float01_chw(image))[None].to(self.device)
        x = resize_bilinear(x, self.vis_cfg.image_size)
        _, collapsed = clip_vit.prs_decomposition(self.params["visual"], self.vis_cfg, x)
        return collapsed[0, 1:].float().cpu().numpy()

    def segment_individual_image(self, image, concepts: List[str], caption: str, **kw):
        heat = self.collapsed(image) @ self.concept_vectors(concepts)  # [P, C]
        g = self.vis_cfg.grid
        return heat.T.reshape(len(concepts), g, g), None


def _hash_tokenize(txt_cfg):
    """A deterministic tokenizer: crc32 word ids below the two top ids,
    which are BOS and EOS (open_clip's convention: EOT is the argmax id).
    A real BPE `tokenize` replaces it for checkpoints."""

    def tokenize(texts: Sequence[str]) -> np.ndarray:
        bos, eos = txt_cfg.vocab_size - 2, txt_cfg.vocab_size - 1
        out = np.zeros((len(texts), txt_cfg.context_length), np.int32)
        for i, t in enumerate(texts):
            ids = [bos] + [
                zlib.crc32(w.encode()) % (txt_cfg.vocab_size - 2) for w in t.lower().split()
            ][: txt_cfg.context_length - 2] + [eos]
            out[i, : len(ids)] = ids
        return out

    return tokenize
