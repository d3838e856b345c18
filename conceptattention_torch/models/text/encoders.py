"""Text conditioning: T5 sequence embeddings, the CLIP pooled vector, and
concept embedding.

Counterpart of the JAX package's `models/text/encoders.py`, two
implementations behind one protocol:
  - `TorchTextEncoders`: the port's T5 and CLIP towers (`t5.py`, `clip.py`)
    on converted checkpoints, on the device their parameters live on; the
    tokenizers (any object with the HF call signature, such as
    `WordTokenizer`) run on the host. `HFTextEncoders` builds one from HF
    files on disk (`transformers` is imported only when one is built);
  - `StubTextEncoders`: each prompt's embeddings drawn from numpy's
    generator seeded by a sha256 of the prompt, bit-identical to the JAX
    package's stub, for runs without checkpoints.
T5 pads to `t5_max_length` and CLIP to 77 tokens, with no attention mask, as
the reference conditioner does. Outputs are f32 CPU tensors; the pipeline
moves them to its device.
"""

from __future__ import annotations

import hashlib
from typing import List, Protocol, Tuple, Union

import numpy as np
import torch


class TextEncoders(Protocol):
    t5_dim: int
    clip_dim: int
    t5_max_length: int

    def encode_t5(self, prompts: List[str]) -> torch.Tensor:
        """-> [B, t5_max_length, t5_dim]"""
        ...

    def encode_clip(self, prompts: List[str]) -> torch.Tensor:
        """-> [B, clip_dim]"""
        ...

    # HunyuanVideo's pipeline takes, besides encode_clip:
    #   encode_llm(prompts) -> ([B, t5_max_length, t5_dim], [valid length] * B)
    # (the language model's states, padded, and how many slots are valid).


class StubTextEncoders:
    """Deterministic, checkpoint-free text encoders for tests and benches."""

    def __init__(self, t5_dim: int = 4096, clip_dim: int = 768, t5_max_length: int = 256):
        self.t5_dim = t5_dim
        self.clip_dim = clip_dim
        self.t5_max_length = t5_max_length

    def _seed(self, text: str, salt: str) -> int:
        digest = hashlib.sha256((salt + "\x00" + text).encode()).digest()
        return int.from_bytes(digest[:4], "little")

    def encode_t5(self, prompts: List[str]) -> torch.Tensor:
        rows = [
            np.random.default_rng(self._seed(p, "t5"))
            .standard_normal((self.t5_max_length, self.t5_dim))
            .astype(np.float32)
            for p in prompts
        ]
        return torch.from_numpy(np.stack(rows))

    def encode_clip(self, prompts: List[str]) -> torch.Tensor:
        rows = [
            np.random.default_rng(self._seed(p, "clip")).standard_normal(self.clip_dim).astype(np.float32)
            for p in prompts
        ]
        return torch.from_numpy(np.stack(rows))

    def encode_llm(self, prompts: List[str]) -> Tuple[torch.Tensor, List[int]]:
        """HunyuanVideo's text states: [B, t5_max_length, t5_dim] drawn like
        `encode_t5`'s (padded slots hold states too, as a language model's
        do), and each prompt's valid length, its word count clipped to
        [1, t5_max_length]."""
        states = torch.from_numpy(np.stack([
            np.random.default_rng(self._seed(p, "llm"))
            .standard_normal((self.t5_max_length, self.t5_dim)).astype(np.float32)
            for p in prompts]))
        return states, [min(self.t5_max_length, max(1, len(p.split()))) for p in prompts]


class TorchTextEncoders:
    """The port's T5 encoder and CLIP text tower on converted parameter
    trees (`convert_t5_state_dict`, `convert_clip_text_state_dict`), run on
    the device and in the dtype of their parameters."""

    def __init__(self, t5_params, t5_cfg, t5_tokenizer, clip_params, clip_cfg, clip_tokenizer,
                 t5_max_length: int = 256):
        self.t5_params, self.t5_cfg, self.t5_tokenizer = t5_params, t5_cfg, t5_tokenizer
        self.clip_params, self.clip_cfg, self.clip_tokenizer = clip_params, clip_cfg, clip_tokenizer
        self.t5_max_length = t5_max_length
        self.t5_dim = t5_cfg.d_model
        self.clip_dim = clip_cfg.hidden_size

    @staticmethod
    def _ids(tokenizer, prompts: List[str], max_length: int, device) -> torch.Tensor:
        tok = tokenizer(prompts, truncation=True, max_length=max_length, padding="max_length",
                        return_tensors="np")
        return torch.as_tensor(np.asarray(tok["input_ids"]), dtype=torch.long, device=device)

    @torch.inference_mode()
    def encode_t5(self, prompts: List[str]) -> torch.Tensor:
        from conceptattention_torch.models.text.t5 import t5_encode

        ids = self._ids(self.t5_tokenizer, prompts, self.t5_max_length,
                        self.t5_params["embed"].device)
        return t5_encode(self.t5_params, self.t5_cfg, ids).float().cpu()

    @torch.inference_mode()
    def encode_clip(self, prompts: List[str]) -> torch.Tensor:
        from conceptattention_torch.models.text.clip import clip_text_encode

        ids = self._ids(self.clip_tokenizer, prompts, 77, self.clip_params["token_embed"].device)
        return clip_text_encode(self.clip_params, self.clip_cfg, ids)["pooler_output"].float().cpu()


class HFTextEncoders(TorchTextEncoders):
    """`TorchTextEncoders` on an HF T5 encoder and CLIP text model from local
    files only (names or directories): `transformers` (imported only here)
    loads the tokenizers and the state dicts, the port's converters build the
    trees on `device` in `dtype`, and the port's towers run them there."""

    def __init__(self, t5_name: str = "google/t5-v1_1-xxl",
                 clip_name: str = "openai/clip-vit-large-patch14", t5_max_length: int = 256,
                 device: Union[str, torch.device] = "cuda",
                 dtype: torch.dtype = torch.bfloat16):
        from transformers import AutoTokenizer, CLIPTextModel, T5EncoderModel

        from conceptattention_torch.models.text.clip import (
            CLIPTextConfig,
            convert_clip_text_state_dict,
        )
        from conceptattention_torch.models.text.t5 import T5Config, convert_t5_state_dict

        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("HFTextEncoders runs the towers on a CUDA device by default and "
                               "none is available; pass device='cpu' to run on the CPU")
        t5_tok = AutoTokenizer.from_pretrained(t5_name, local_files_only=True)
        hf = T5EncoderModel.from_pretrained(t5_name, local_files_only=True)
        c = hf.config
        if c.feed_forward_proj != "gated-gelu":
            raise ValueError(f"the port's T5 is v1.1's gated tanh-GELU FFN, {t5_name} has "
                             f"{c.feed_forward_proj!r}")
        t5_cfg = T5Config(c.vocab_size, c.d_model, c.d_kv, c.d_ff, c.num_heads, c.num_layers,
                          c.relative_attention_num_buckets, c.relative_attention_max_distance)
        t5 = convert_t5_state_dict(hf.state_dict(), t5_cfg, dtype, device)
        del hf
        clip_tok = AutoTokenizer.from_pretrained(clip_name, local_files_only=True)
        hf = CLIPTextModel.from_pretrained(clip_name, local_files_only=True)
        c = hf.config
        if c.hidden_act != "quick_gelu":
            raise ValueError(f"the port's CLIP uses quick-GELU, {clip_name} has {c.hidden_act!r}")
        # An eos_token_id of 2 is HF's legacy config, which pools at the
        # largest id: the tokenizer's end-of-text token, first occurrence.
        eos = clip_tok.eos_token_id if c.eos_token_id == 2 else c.eos_token_id
        clip_cfg = CLIPTextConfig(c.vocab_size, c.hidden_size, c.num_attention_heads,
                                  c.num_hidden_layers, c.max_position_embeddings, eos)
        clip = convert_clip_text_state_dict(hf.state_dict(), clip_cfg, dtype, device)
        del hf
        super().__init__(t5, t5_cfg, t5_tok, clip, clip_cfg, clip_tok, t5_max_length)


class WordTokenizer:
    """A stand-in tokenizer with the HF call signature, for runs without
    tokenizer files: each word hashed to an id in [first_id, vocab_size)
    that is not a special id, then `eos_id`, then `pad_id` up to
    `max_length` (CLIP's tokenizer pads with its EOS id, T5's with 0), cut
    to `max_length` with the EOS kept last."""

    def __init__(self, vocab_size: int, eos_id: int, pad_id: int, first_id: int = 2):
        self.vocab_size, self.eos_id, self.pad_id, self.first_id = vocab_size, eos_id, pad_id, first_id

    def _word_id(self, word: str) -> int:
        n = self.vocab_size - self.first_id
        i = self.first_id + int.from_bytes(hashlib.sha256(word.encode()).digest()[:4], "little") % n
        return i if i not in (self.eos_id, self.pad_id) else self.first_id

    def __call__(self, texts, truncation=True, max_length=77, padding="max_length",
                 return_tensors="np"):
        rows = []
        for text in texts:
            ids = [self._word_id(w) for w in text.lower().split()][: max_length - 1] + [self.eos_id]
            rows.append(ids + [self.pad_id] * (max_length - len(ids)))
        return {"input_ids": np.asarray(rows, dtype=np.int64)}


def embed_concepts(
    encoders: TextEncoders, concepts: List[str], batch_size: int = 1
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each concept embedded alone through T5 with its first token kept;
    zero position ids; a zeroed pooled vector.

    Returns (concept_embeddings [B, C, t5_dim], concept_ids [B, C, 3],
    concept_vec [B, clip_dim] zeros).
    """
    tokens = torch.stack([encoders.encode_t5([c])[0, 0] for c in concepts])
    concept_embeddings = tokens[None].expand(batch_size, -1, -1)
    concept_ids = torch.zeros((batch_size, len(concepts), 3), dtype=torch.float32)
    concept_vec = torch.zeros((batch_size, encoders.clip_dim), dtype=torch.float32)
    return concept_embeddings, concept_ids, concept_vec
