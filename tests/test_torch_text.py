"""The port's text towers against the JAX package's, on the CPU in f32.

Weights come from tiny random HF models (`T5EncoderModel`, `CLIPTextModel`)
through both packages' converters. Tolerance rtol = atol = 1e-4: the same
f32 arithmetic in another reduction order. The buckets are exact. The
stand-in tokenizer is the port's `WordTokenizer` (words hashed to ids, EOS
after the words, then padding; CLIP's pads with EOS, so pooling anywhere but
at the first EOS shows).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conceptattention_torch.models.text import clip as t_clip
from conceptattention_torch.models.text import encoders as t_enc
from conceptattention_torch.models.text import t5 as t_t5
from conceptattention_torch.models.text.encoders import WordTokenizer
from conceptattention_tpu.models.text import clip as j_clip
from conceptattention_tpu.models.text import encoders as j_enc
from conceptattention_tpu.models.text import t5 as j_t5

torch.set_num_threads(2)  # six test workers share the host's cores

TOL = dict(rtol=1e-4, atol=1e-4)
T5_TINY = dict(vocab_size=100, d_model=32, d_kv=8, d_ff=64, num_heads=4, num_layers=2,
               relative_attention_num_buckets=8, relative_attention_max_distance=16)
CLIP_TINY = dict(vocab_size=100, hidden_size=32, num_heads=4, num_layers=2,
                 max_position_embeddings=77, eos_token_id=99)


def hf_t5():
    from transformers import T5Config, T5EncoderModel

    torch.manual_seed(0)
    return T5EncoderModel(T5Config(
        vocab_size=100, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4,
        relative_attention_num_buckets=8, relative_attention_max_distance=16,
        feed_forward_proj="gated-gelu", dropout_rate=0.0)).eval()


def hf_clip(eos_token_id: int = 99):
    """A tiny CLIP text model; `eos_token_id=2` is HF's legacy config, which
    pools at the largest id (the tokenizer's end-of-text, 99, is the largest)."""
    from transformers import CLIPTextConfig, CLIPTextModel

    torch.manual_seed(1)
    return CLIPTextModel(CLIPTextConfig(
        vocab_size=100, hidden_size=32, intermediate_size=128, num_attention_heads=4,
        num_hidden_layers=2, max_position_embeddings=77, eos_token_id=eos_token_id,
        bos_token_id=98, pad_token_id=99, hidden_act="quick_gelu", attention_dropout=0.0)).eval()


@pytest.fixture(scope="module")
def towers():
    t5_sd, clip_sd = hf_t5().state_dict(), hf_clip().state_dict()
    t_cfg5, j_cfg5 = t_t5.T5Config(**T5_TINY), j_t5.T5Config(**T5_TINY)
    t_cfgc, j_cfgc = t_clip.CLIPTextConfig(**CLIP_TINY), j_clip.CLIPTextConfig(**CLIP_TINY)
    return dict(
        t5=(t_t5.convert_t5_state_dict(t5_sd, t_cfg5, torch.float32), t_cfg5,
            j_t5.convert_t5_state_dict(t5_sd, j_cfg5, jnp.float32), j_cfg5),
        clip=(t_clip.convert_clip_text_state_dict(clip_sd, t_cfgc, torch.float32), t_cfgc,
              j_clip.convert_clip_text_state_dict(clip_sd, j_cfgc, jnp.float32), j_cfgc),
    )


def close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **TOL)


def test_relative_position_bucket_exact():
    rel = np.arange(-300, 301)[None, :] - np.arange(0, 40)[:, None]
    for buckets, distance in ((8, 16), (32, 128)):
        got = t_t5.relative_position_bucket(torch.as_tensor(rel), buckets, distance)
        want = j_t5.relative_position_bucket(jnp.asarray(rel), buckets, distance)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
def test_t5_encode_matches_jax(towers, masked):
    tp, tc, jp, jc = towers["t5"]
    ids = np.random.default_rng(0).integers(0, 100, size=(2, 9))
    mask = np.array([[1] * 9, [1] * 5 + [0] * 4]) if masked else None
    got = t_t5.t5_encode(tp, tc, torch.as_tensor(ids), None if mask is None else torch.as_tensor(mask))
    want = j_t5.t5_encode(jp, jc, jnp.asarray(ids), None if mask is None else jnp.asarray(mask))
    assert got.shape == (2, 9, 32)
    close(got, want)


def test_t5_gelu_is_tanh(towers):
    """The gated FFN's GELU is the tanh one: the exact GELU moves the output
    beyond the tolerance on these inputs."""
    tp, tc, jp, jc = towers["t5"]
    ids = torch.as_tensor(np.random.default_rng(3).integers(0, 100, size=(1, 9)))
    want = np.asarray(j_t5.t5_encode(jp, jc, jnp.asarray(ids.numpy())))
    close(t_t5.t5_encode(tp, tc, ids), want)
    orig = t_t5._gelu
    try:
        t_t5._gelu = torch.nn.functional.gelu
        assert not np.allclose(t_t5.t5_encode(tp, tc, ids).numpy(), want, **TOL)
    finally:
        t_t5._gelu = orig


def test_clip_text_encode_matches_jax_and_pools_at_first_eos(towers):
    tp, tc, jp, jc = towers["clip"]
    ids = WordTokenizer(100, eos_id=99, pad_id=99)(["a dragon on a rock", "sky"], max_length=12)
    ids = ids["input_ids"]
    assert (ids[:, -1] == 99).all() and ids[0, 5] == 99 and ids[1, 1] == 99
    got = t_clip.clip_text_encode(tp, tc, torch.as_tensor(ids))
    want = j_clip.clip_text_encode(jp, jc, jnp.asarray(ids))
    close(got["last_hidden_state"], want["last_hidden_state"])
    close(got["pooler_output"], want["pooler_output"])
    hidden = got["last_hidden_state"]
    torch.testing.assert_close(got["pooler_output"], hidden[[0, 1], [5, 1]], rtol=0, atol=0)
    assert not torch.allclose(got["pooler_output"], hidden[:, -1], atol=1e-3)


def test_hf_and_init_agree_with_port(towers):
    """The converted towers reproduce HF's own forward, and the random init
    builds a tree the encoder runs."""
    tp, tc, _, _ = towers["t5"]
    ids = torch.as_tensor(np.random.default_rng(4).integers(0, 100, size=(2, 7)))
    with torch.no_grad():
        want = hf_t5()(input_ids=ids).last_hidden_state
    torch.testing.assert_close(t_t5.t5_encode(tp, tc, ids), want, rtol=2e-3, atol=2e-4)
    params = t_t5.init_t5_params(torch.Generator().manual_seed(0), tc, torch.float32)
    assert params["rel_bias"].dtype == torch.float32
    assert params["blocks"]["wi0"].shape == (tc.num_layers, tc.d_model, tc.d_ff)
    assert torch.isfinite(t_t5.t5_encode(params, tc, ids)).all()


def test_torch_text_encoders_match_jax(towers):
    tp5, tc5, jp5, jc5 = towers["t5"]
    tpc, tcc, jpc, jcc = towers["clip"]
    t5_tok, clip_tok = WordTokenizer(100, eos_id=1, pad_id=0), WordTokenizer(100, 99, 99)
    t = t_enc.TorchTextEncoders(tp5, tc5, t5_tok, tpc, tcc, clip_tok, t5_max_length=16)
    j = j_enc.JAXTextEncoders(jp5, jc5, t5_tok, jpc, jcc, clip_tok, t5_max_length=16)
    prompts = ["a dragon on a rock", "sky"]
    got_t5, got_clip = t.encode_t5(prompts), t.encode_clip(prompts)
    assert got_t5.dtype == got_clip.dtype == torch.float32 and got_t5.device.type == "cpu"
    assert got_t5.shape == (2, 16, 32) and got_clip.shape == (2, 32)
    close(got_t5, j.encode_t5(prompts))
    close(got_clip, j.encode_clip(prompts))
    for got, want in zip(t_enc.embed_concepts(t, ["dragon", "rock"], 2),
                         j_enc.embed_concepts(j, ["dragon", "rock"], 2)):
        close(got, want)


def _save_hf_tokenizer(path, special: dict, eos: str, pad: str):
    """A word-level HF fast tokenizer (EOS after the words) saved to `path`."""
    from tokenizers import Tokenizer, models, pre_tokenizers, processors
    from transformers import PreTrainedTokenizerFast

    words = "a dragon on rock sky the of".split()
    vocab = {**{w: 10 + i for i, w in enumerate(words)}, "<unk>": 3, **special}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.post_processor = processors.TemplateProcessing(
        single=f"$A {eos}", special_tokens=[(eos, vocab[eos])])
    PreTrainedTokenizerFast(tokenizer_object=tok, eos_token=eos, pad_token=pad,
                            unk_token="<unk>").save_pretrained(path)


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """Tiny HF T5 and CLIP models with tokenizers saved to disk: the T5
    directory, the CLIP one, and a CLIP one with the legacy EOS config."""
    root = tmp_path_factory.mktemp("hf")
    t5_dir, clip_dir, legacy_dir = str(root / "t5"), str(root / "clip"), str(root / "legacy")
    hf_t5().save_pretrained(t5_dir)
    _save_hf_tokenizer(t5_dir, {"<pad>": 0, "</s>": 1}, eos="</s>", pad="<pad>")
    for eos_token_id, path in ((99, clip_dir), (2, legacy_dir)):
        hf_clip(eos_token_id).save_pretrained(path)
        _save_hf_tokenizer(path, {"<|endoftext|>": 99}, eos="<|endoftext|>",
                           pad="<|endoftext|>")
    return t5_dir, clip_dir, legacy_dir


@pytest.mark.parametrize("legacy_eos", [False, True], ids=["eos-99", "legacy-eos-2"])
def test_hf_text_encoders_match_jax_and_port(towers, hf_dirs, legacy_eos):
    """`HFTextEncoders` from local files (the port's towers on the converted
    HF state dicts) agrees with the JAX package's (HF's own forward) at the
    file's tolerance, and equals `TorchTextEncoders` on the same converted
    weights and tokenizers bit for bit. With the legacy CLIP config it pools
    at the tokenizer's end-of-text token, as HF does."""
    t5_dir, clip_dir, legacy_dir = hf_dirs
    clip_dir = legacy_dir if legacy_eos else clip_dir
    t = t_enc.HFTextEncoders(t5_dir, clip_dir, t5_max_length=12, device="cpu",
                             dtype=torch.float32)
    j = j_enc.HFTextEncoders(t5_dir, clip_dir, t5_max_length=12)
    assert isinstance(t, t_enc.TorchTextEncoders) and t.clip_cfg.eos_token_id == 99
    prompts = ["a dragon on a rock", "sky"]
    got_t5, got_clip = t.encode_t5(prompts), t.encode_clip(prompts)
    assert (t.t5_dim, t.clip_dim) == (32, 32) and got_t5.shape == (2, 12, 32)
    assert got_t5.dtype == got_clip.dtype == torch.float32 and got_clip.device.type == "cpu"
    close(got_t5, j.encode_t5(prompts))
    close(got_clip, j.encode_clip(prompts))
    tp5, tc5, _, _ = towers["t5"]
    tpc, tcc, _, _ = towers["clip"]
    port = t_enc.TorchTextEncoders(tp5, tc5, t.t5_tokenizer, tpc, tcc, t.clip_tokenizer,
                                   t5_max_length=12)
    np.testing.assert_array_equal(port.encode_t5(prompts).numpy(), got_t5.numpy())
    np.testing.assert_array_equal(port.encode_clip(prompts).numpy(), got_clip.numpy())


def test_hf_text_encoders_default_to_cuda(hf_dirs):
    """The towers run on the card unless the caller asks for the CPU, and
    without a card the default raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable here")
    t5_dir, clip_dir, _ = hf_dirs
    with pytest.raises(RuntimeError, match="CUDA"):
        t_enc.HFTextEncoders(t5_dir, clip_dir)


def test_hf_text_encoders_need_local_files(tmp_path):
    """Without local files both packages' constructors fail, in the same way."""
    errors = []
    for cls in (functools.partial(t_enc.HFTextEncoders, device="cpu"), j_enc.HFTextEncoders):
        with pytest.raises((OSError, ValueError)) as err:
            cls(str(tmp_path / "missing-t5"), str(tmp_path / "missing-clip"))
        errors.append(type(err.value))
    assert errors[0] is errors[1]
